"""examples/train_ssd.py's detector in both packages on the CPU, and the
SSD-300 builder the smoke trains on the card.

* The compact SSD (``chip_smoke.ssd_compact``: the example's code,
  callable with either package) at 64x64, b=4, 3 classes: the JAX
  net's Xavier weights go to the port by name, then 2 ``gluon.Trainer``
  steps (SGD 0.1, momentum 0.9, wd 1e-4) of the example's loss in each
  package.  Losses and loc targets 1e-5 of max, masks and class
  targets exactly, the updated parameters and BatchNorm statistics
  1e-5 of each tensor's max (the conv biases that feed a BatchNorm,
  whose gradient is rounding noise, within 1e-6 absolute), the
  detections' kept rows exactly and their values 1e-5 of max.
* ``MultiBoxTarget`` with padding rows: MXNet's rule (a padding row
  never forces a match), which the JAX op's scatter breaks when the
  padding row follows the box (``ROADMAP.md``, reference caveats), so
  the case holds the port alone to MXNet's values.
* SSD-300 (``chip_smoke.ssd300``) on the port at b=1: 8732 anchors, the
  six map sizes, 21 classes, one Trainer step with finite loss.
"""
import re

import numpy as np
import pytest

import chip_smoke
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

EDGE, BATCH, CLASSES, STEPS = 64, 4, 3, 2


def _close(got, want, tol, what, atol=0.0):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, what
    assert err <= tol * scale + atol, \
        f"{what}: {err / scale:.3g} of max > {tol} (+ {atol})"


# the conv biases that feed a BatchNorm: their gradient is 0 in exact
# arithmetic, so their values after a step are rounding noise on both
# sides, compared with an absolute floor
BN_FED = re.compile(r"ssd_(body|stage\d)_conv2d\d+_bias$")


def _train(m, net, batches, ctx):
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              dict(chip_smoke.SSD_OPT))
    losses, targets = [], []
    with ctx:
        for x, y in batches:
            loss, tg = chip_smoke.ssd_step(m, net, trainer, m.nd.array(x),
                                           m.nd.array(y))
            losses.append(loss.asnumpy())
            targets.append([t.asnumpy() for t in tg])
        dets = chip_smoke.ssd_detect(m, net, m.nd.array(batches[0][0]))
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    return losses, targets, params, dets.asnumpy()


@pytest.fixture(scope="module")
def runs():
    rs = np.random.RandomState(11)
    batches = [chip_smoke.scenes(rs, BATCH, EDGE, CLASSES)
               for _ in range(STEPS)]
    batches = [(x, y[:, :1]) for x, y in batches]
    jmx.random.seed(0)
    jnet = chip_smoke.ssd_compact(jmx, CLASSES)
    jnet.initialize(init=jmx.init.Xavier(rnd_type="gaussian", magnitude=2))
    jnet(jmx.nd.array(batches[0][0]))          # the deferred shapes
    init = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    want = _train(jmx, jnet, batches, jmx.cpu())
    with tmx.cpu():
        tnet = chip_smoke.ssd_compact(tmx, CLASSES)
        convert.gluon_params_from_numpy(tnet, init)
    got = _train(tmx, tnet, batches, tmx.cpu())
    return got, want, init


def test_ssd_losses_and_targets_match_jax(runs):
    (gl, gt, _, _), (wl, wt, _, _), _ = runs
    for step, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, 1e-5, f"loss {step}")
    for step, (g, w) in enumerate(zip(gt, wt)):
        _close(g[0], w[0], 1e-5, f"loc target {step}")
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert (g[2] > 0).any()


def test_ssd_updated_parameters_match_jax(runs):
    (_, _, gp, _), (_, _, wp, _), init = runs
    assert sorted(gp) == sorted(wp)
    for k in wp:
        if BN_FED.match(k):
            _close(gp[k], wp[k], 0.0, k, atol=1e-6)
            continue
        _close(gp[k], wp[k], 1e-5, k)
        assert not np.array_equal(wp[k], init[k]), k


def test_ssd_detections_match_jax(runs):
    (_, _, _, gd), (_, _, _, wd), _ = runs
    np.testing.assert_array_equal(gd[..., 0] >= 0, wd[..., 0] >= 0)
    assert (gd[..., 0] >= 0).any()
    _close(gd, wd, 1e-5, "detections")


ANCHORS = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]],
                   np.float32)
BOX = [1, 0, 0, .45, .45]
PAD = [-1, 0, 0, 0, 0]


@pytest.mark.parametrize("rows", [[BOX, PAD], [PAD, BOX], [PAD, BOX, PAD]])
def test_multibox_target_padding_never_forces_a_match(rows):
    """MXNet's rule: the box's best anchor (IoU 0.81 < 0.9) is forced to
    it, whatever padding rows come before or after it."""
    label = np.array([rows], np.float32)
    with tmx.cpu():
        loc_t, loc_m, cls_t = tmx.nd.contrib.MultiBoxTarget(
            tmx.nd.array(ANCHORS), tmx.nd.array(label),
            tmx.nd.zeros((1, 3, 3)), overlap_threshold=0.9)
    np.testing.assert_array_equal(cls_t.asnumpy(), [[2, 0, 0]])
    np.testing.assert_array_equal(loc_m.asnumpy()[0, :4], [1, 1, 1, 1])
    assert not loc_m.asnumpy()[0, 4:].any()


def test_multibox_target_last_valid_box_wins_a_shared_anchor():
    """Two valid boxes with the same best anchor: the later one takes
    it, as in the JAX op (whose scatter agrees here)."""
    label = np.array([[[0, 0, 0, .45, .45], [2, .05, .05, .4, .4]]],
                     np.float32)
    outs = []
    for m in (jmx, tmx):
        with (tmx.cpu() if m is tmx else jmx.cpu()):
            outs.append(m.nd.contrib.MultiBoxTarget(
                m.nd.array(ANCHORS), m.nd.array(label), m.nd.zeros((1, 4, 3)),
                overlap_threshold=0.9)[2].asnumpy())
    np.testing.assert_array_equal(outs[1], [[3, 0, 0]])
    np.testing.assert_array_equal(outs[1], outs[0])


def test_ssd300_has_the_published_geometry():
    rs = np.random.RandomState(3)
    x, y = chip_smoke.scenes(rs, 1, chip_smoke.SSD_EDGE,
                             chip_smoke.SSD_CLASSES, chip_smoke.SSD_MAX_BOXES)
    with tmx.cpu():
        net = chip_smoke.ssd300(tmx)
        net.initialize(init=tmx.init.Xavier(rnd_type="gaussian",
                                            magnitude=2))
        sizes = []
        net.stage4.register_forward_hook(
            lambda b, a, out: sizes.append(out.shape[2]))
        net.stage5.register_forward_hook(
            lambda b, a, out: sizes.append(out.shape[2]))
        for e in net.extras:
            e.register_forward_hook(lambda b, a, out: sizes.append(
                out.shape[2]))
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    dict(chip_smoke.SSD_OPT))
        loss, (loc_t, loc_m, cls_t) = chip_smoke.ssd_step(
            tmx, net, trainer, tmx.nd.array(x), tmx.nd.array(y))
        cls_pred, box_pred, anchor = net(tmx.nd.array(x))
    assert sizes[:6] == [38, 19, 10, 5, 3, 1]
    assert anchor.shape == (1, chip_smoke.SSD_ANCHORS, 4)
    assert cls_pred.shape == (1, chip_smoke.SSD_ANCHORS, 21)
    assert box_pred.shape == (1, 4 * chip_smoke.SSD_ANCHORS)
    assert np.isfinite(loss.asnumpy()).all()
    assert (cls_t.asnumpy() > 0).any()
    scale = net.collect_params()["ssd300_norm4_scale"].data().asnumpy()
    assert scale.shape == (1, 512, 1, 1)
    assert np.abs(scale - 20).max() < 1.0 and (scale != 20).any()
