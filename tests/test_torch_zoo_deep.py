"""The port's deeper zoo models, DenseNet-121, Inception-BN and
Inception V3, held to the JAX package on the CPU (the lighter families
are in ``test_torch_zoo.py``; one file each keeps either under a
minute).  classes=10, b=1; DenseNet and Inception-BN at 32x32 (their
global pool takes any size), Inception V3 at 299x299 (its closing
``AvgPool2D(8)`` needs the 8x8 map).  The JAX net's Xavier weights go
to the port by name.  Tolerance: 1e-5 of the reference's max."""
import numpy as np
import pytest

from _zoo_parity import assert_close_of_max, forward_pair


@pytest.mark.parametrize("name,size,prefix", [
    ("densenet121", 32, "densenet0_"), ("inceptionbn", 32, "inceptionbn0_")])
def test_deep_zoo_forward_matches_jax(name, size, prefix):
    x = np.random.RandomState(1).rand(1, 3, size, size).astype(np.float32)
    jy, ty, _, _, (jnet, tnet) = forward_pair(name, prefix, x)
    assert ty.shape == jy.shape == (1, 10)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert_close_of_max(ty, jy, 1e-5, name)
