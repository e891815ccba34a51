"""The slice as a whole: the imperative training loop that
``chip_smoke.py`` drives on the card (phase ``nd_imperative``: nd
arrays, ``attach_grad``, ``autograd.record``, FullyConnected ->
log_softmax -> pick -> mean, ``backward``, SGD), here at 64 -> 10 with
a batch of 32 for 5 steps, with the nd update ``w[:] = w - lr * w.grad``,
run by the same code through the JAX package and through the port on
the CPU.  Parameters match to 1e-5 of each tensor's max and losses to
1e-6 relative (fp32, the same math in other orders)."""
import numpy as np

import chip_smoke
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

STEPS, BATCH, FEATURES, CLASSES = 5, 32, 64, 10
PARAM_RTOL, LOSS_RTOL = 1e-5, 1e-6


def _run(mx, ctx, data):
    arrays = chip_smoke.imperative_setup(mx, ctx, data)
    losses = chip_smoke.imperative_steps(mx, arrays, STEPS,
                                         chip_smoke.nd_update)
    return arrays[2], arrays[3], [float(v.asscalar()) for v in losses]


def test_imperative_loop_matches_jax():
    data = chip_smoke.imperative_data(0, BATCH, FEATURES, CLASSES)
    w_j, b_j, loss_j = _run(jmx, jmx.cpu(), data)
    with tmx.cpu():
        w_t, b_t, loss_t = _run(tmx, tmx.cpu(), data)
    np.testing.assert_allclose(loss_t, loss_j, rtol=LOSS_RTOL)
    assert loss_t[-1] < loss_t[0]
    for got, want in ((w_t, w_j), (b_t, b_j)):
        got, want = got.asnumpy(), want.asnumpy()
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= PARAM_RTOL * np.abs(want).max()


def test_sgd_update_op_matches_the_loop_update():
    """nd.sgd_update(w, g, lr, out=w) (over the port's
    optimizer.sgd_update) gives the loop's update, as in the JAX
    package."""
    data = chip_smoke.imperative_data(1, BATCH, FEATURES, CLASSES)

    def op_update(p, lr):
        tmx.nd.sgd_update(p, p.grad, lr=lr, out=p)

    with tmx.cpu():
        arrays = chip_smoke.imperative_setup(tmx, tmx.cpu(), data)
        chip_smoke.imperative_steps(tmx, arrays, 3, op_update)
        ref = chip_smoke.imperative_setup(tmx, tmx.cpu(), data)
        chip_smoke.imperative_steps(tmx, ref, 3, chip_smoke.nd_update)
    for got, want in zip(arrays[2:], ref[2:]):
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
