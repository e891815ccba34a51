"""The port's Inception V3 held to the JAX package on the CPU, in a
file of its own (299x299 input, ~40 s): classes=10, b=1, the JAX net's
Xavier weights carried to the port by name.  Its ``AvgPool2D(3, 1, 1)``
branches count the padding on both sides.  Tolerance: 1e-5 of the
reference's max."""
import numpy as np

from _zoo_parity import assert_close_of_max, forward_pair


def test_inception_v3_forward_matches_jax():
    x = np.random.RandomState(1).rand(1, 3, 299, 299).astype(np.float32)
    jy, ty, _, _, (jnet, tnet) = forward_pair("inceptionv3", "inception30_",
                                              x)
    assert ty.shape == jy.shape == (1, 10)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert_close_of_max(ty, jy, 1e-5, "inceptionv3")
