"""The port's contrib ops (``ops/contrib.py``) held to the JAX package's
on the CPU, forward and, where the JAX op has one, gradient: CTC (both
blank conventions, lengths, padding; ``gluon.loss.CTCLoss``), the
MultiBox family, box IoU / NMS, Proposal, PSROIPooling and its
deformable form, deformable convolution, fft / ifft, quantize,
count sketch, krprod and bipartite matching.  Inputs are numpy draws
from fixed seeds.

Tolerances: integer-valued results (NMS keep masks, matchings,
quantised values, class targets) exactly; anchors and IoUs 1e-6
absolute (the same float32 operations); losses, outputs and gradients
1e-5 of the reference's max (other summation orders; CTC's logaddexp
chains).  The fast NMS is held to the port's own plain scan exactly,
ties, ``topk``, the class-aware offset and N = 2000 included; the
``MultiBoxTarget`` label sets keep padding rows off every valid box's
best anchor (where the JAX op's scatter differs from MXNet, a case
``test_torch_ssd.py`` holds to MXNet's rule).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import contrib as tcontrib

TOL = 1e-5


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= tol, f"{what}: {err:.3g} of max > {tol}"


def _run(m, fn, arrays, attrs, grad_idx=(), head_seed=None, out_idx=0):
    """``fn(m)(*arrays, **attrs)`` in package ``m``; with ``grad_idx``
    recorded, and ``sum(out[out_idx] * head)`` differentiated.  Returns
    (outputs, grads) as numpy."""
    xs = [None if a is None else m.nd.array(a, dtype=a.dtype)
          for a in arrays]
    for i in grad_idx:
        xs[i].attach_grad()
    if grad_idx:
        with m.autograd.record():
            out = fn(m)(*xs, **attrs)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            o = outs[out_idx]
            head = np.random.RandomState(head_seed).randn(
                *o.shape).astype(np.float32)
            loss = (o * m.nd.array(head)).sum()
        loss.backward()
    else:
        out = fn(m)(*xs, **attrs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs], [xs[i].grad.asnumpy()
                                         for i in grad_idx]


def both(fn, arrays, attrs=None, grad_idx=(), head_seed=0, out_idx=0):
    attrs = attrs or {}
    want = _run(jmx, fn, arrays, attrs, grad_idx, head_seed, out_idx)
    with tmx.cpu():
        got = _run(tmx, fn, arrays, attrs, grad_idx, head_seed, out_idx)
    return got, want


def contrib(name):
    return lambda m: getattr(m.nd.contrib, name)


# --------------------------------------------------------------------- CTC
def _ctc_inputs(seed, T=12, B=4, A=6, L=3, blank="first"):
    rs = np.random.RandomState(seed)
    data = rs.randn(T, B, A).astype(np.float32)
    if blank == "first":
        label = rs.randint(1, A, (B, L)).astype(np.float32)
        label[1, 2:] = 0          # padding: 0 ends a sequence
        label[2, 1] = label[2, 0]  # a repeat needs a blank between
    else:
        label = rs.randint(0, A - 1, (B, L)).astype(np.float32)
        label[1, 2:] = -1
        label[2, 1] = label[2, 0]
    return data, label


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_and_gradient(blank, lengths):
    data, label = _ctc_inputs(1, blank=blank)
    dl = np.array([12, 9, 7, 12], np.float32)
    ll = np.array([3, 2, 2, 1], np.float32)
    arrays = [data, label, dl if lengths else None, ll if lengths else None]
    attrs = dict(blank_label=blank, use_data_lengths=lengths,
                 use_label_lengths=lengths)
    (got, gg), (want, wg) = both(contrib("ctc_loss"), arrays, attrs,
                                 grad_idx=(0,))
    _close(got[0], want[0], TOL, "ctc loss")
    _close(gg[0], wg[0], TOL, "ctc grad")


def test_ctc_infeasible_alignment_is_large_and_finite():
    """Three labels with repeats need five frames: four cannot hold them;
    the JAX op's finite -1e30 gives ~1e30, the plain route the same."""
    data = np.random.RandomState(2).randn(4, 1, 5).astype(np.float32)
    label = np.array([[2, 2, 2]], np.float32)
    (got, _), (want, _) = both(contrib("ctc_loss"), [data, label])
    assert np.isfinite(got[0]).all() and got[0][0] > 1e29
    _close(got[0], want[0], TOL, "infeasible")


def test_ctc_library_route_matches_the_plain_one_on_the_cpu():
    """The card's route (``F.ctc_loss``) computed here on the CPU
    tensors: the same loss and gradient as the plain recursion for
    feasible inputs."""
    data, label = _ctc_inputs(3, blank="last")
    x = torch.tensor(data, requires_grad=True)
    lp = torch.log_softmax(x, -1)
    lab = torch.tensor(label).long()
    t_lens = torch.full((4,), 12, dtype=torch.long)
    l_lens = (lab >= 0).sum(1)
    calls = tcontrib.library_ctc_calls[0]
    lib = tcontrib._ctc_library(lp, lab, t_lens, l_lens, 5)
    assert tcontrib.library_ctc_calls[0] == calls + 1
    g_lib, = torch.autograd.grad(lib.sum(), x)
    plain = tcontrib.ctc_loss_plain(torch.log_softmax(x, -1), lab, t_lens,
                                    l_lens, 5)
    g_plain, = torch.autograd.grad(plain.sum(), x)
    _close(lib.detach(), plain.detach(), TOL, "library loss")
    _close(g_lib, g_plain, TOL, "library grad")


@pytest.mark.parametrize("layout,label_layout", [("TNC", "NT"),
                                                 ("NTC", "TN")])
def test_gluon_ctc_loss(layout, label_layout):
    data, label = _ctc_inputs(4, blank="last")
    if layout == "NTC":
        data = data.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()

    def fn(m):
        return m.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout)
    (got, gg), (want, wg) = both(fn, [data, label], grad_idx=(0,))
    _close(got[0], want[0], TOL, "gluon ctc")
    _close(gg[0], wg[0], TOL, "gluon ctc grad")


# --------------------------------------------------------------- MultiBox
@pytest.mark.parametrize("attrs", [
    dict(sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.1, 0.141), ratios=(1.0, 2.0, 0.5, 3.0, 1.0 / 3),
         steps=(8 / 300, 8 / 300), offsets=(0.5, 0.5), clip=True),
    dict(sizes=(0.88, 0.961), ratios=(1.0, 2.0, 0.5), steps=(1.0, 1.0),
         clip=False)])
def test_multibox_prior(attrs):
    feat = np.zeros((1, 2, 5, 7), np.float32)
    (got, _), (want, _) = both(contrib("MultiBoxPrior"), [feat], attrs)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(5)
    a = rs.rand(2, 6, 4).astype(np.float32)
    b = rs.rand(5, 4).astype(np.float32)
    if fmt == "corner":
        a[..., 2:] += a[..., :2]
        b[..., 2:] += b[..., :2]
    (got, _), (want, _) = both(contrib("box_iou"), [a, b], dict(format=fmt))
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)


def _anchors(h=6, w=6):
    feat = np.zeros((1, 1, h, w), np.float32)
    with tmx.cpu():
        return tmx.nd.contrib.MultiBoxPrior(
            tmx.nd.array(feat), sizes=(0.3, 0.45),
            ratios=(1.0, 2.0, 0.5)).asnumpy()


def _labels(seed, B=3, G=4):
    rs = np.random.RandomState(seed)
    lab = np.full((B, G, 5), -1.0, np.float32)
    for b in range(B):
        for g in range(rs.randint(1, G + 1)):
            w, h = rs.uniform(0.2, 0.6, 2)
            x, y = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            lab[b, g] = [rs.randint(3), x, y, x + w, y + h]
    return lab


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_multibox_target(seed, threshold):
    anchor, label = _anchors(), _labels(seed)
    cls_pred = np.zeros((3, 4, anchor.shape[1]), np.float32)
    # precondition: no padding row can clear a forced match (a padding
    # row's best anchor is 0; no valid box may have it)
    with tmx.cpu():
        iou = tmx.nd.contrib.box_iou(tmx.nd.array(anchor[0]),
                                     tmx.nd.array(label[..., 1:])).asnumpy()
    best = iou.argmax(1)
    assert not (best[label[..., 0] >= 0] == 0).any()
    (got, _), (want, _) = both(contrib("MultiBoxTarget"),
                               [anchor, label, cls_pred],
                               dict(overlap_threshold=threshold))
    np.testing.assert_array_equal(got[2], want[2])     # class targets
    np.testing.assert_array_equal(got[1], want[1])     # masks
    _close(got[0], want[0], 1e-6, "loc targets")


def _nms_rows(seed, n, classes=3, ties=False):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2).astype(np.float32) * 0.8
    wh = rs.uniform(0.05, 0.3, (n, 2)).astype(np.float32)
    score = rs.rand(n).astype(np.float32)
    if ties:
        score = np.round(score * 4) / 4
    cls = rs.randint(classes, size=n).astype(np.float32)
    return np.concatenate([cls[:, None], score[:, None], xy, xy + wh], 1)


@pytest.mark.parametrize("n,ties,topk,thresh", [
    (64, False, -1, 0.5), (64, True, -1, 0.3), (200, True, 10, 0.45),
    (2000, True, -1, 0.45), (2000, False, 50, 0.3)])
@pytest.mark.parametrize("class_aware", [False, True])
def test_fast_nms_equals_the_plain_scan(n, ties, topk, thresh, class_aware):
    rows = torch.tensor(_nms_rows(n + int(ties), n, ties=ties))
    boxes = rows[:, 2:6]
    if class_aware:
        boxes = boxes + rows[:, :1] * 1e3
    scores = torch.where(rows[:, 1] > 0.1, rows[:, 1],
                         torch.full_like(rows[:, 1], float("-inf")))
    fast = tcontrib.nms_mark(boxes, scores, thresh, topk, block=512)
    plain = tcontrib.nms_mark_plain(boxes, scores, thresh, topk)
    assert torch.equal(fast, plain)
    assert 0 < int(fast.sum()) < n


def test_fast_nms_all_equal_scores_take_the_lower_index():
    box = torch.tensor([[0.1, 0.1, 0.5, 0.5]]).repeat(5, 1)
    scores = torch.full((5,), 0.7)
    keep = tcontrib.nms_mark(box, scores, 0.5, -1)
    assert keep.tolist() == [True, False, False, False, False]
    assert torch.equal(keep, tcontrib.nms_mark_plain(box, scores, 0.5, -1))


@pytest.mark.parametrize("attrs", [
    dict(overlap_thresh=0.5, coord_start=2, score_index=1, id_index=0),
    dict(overlap_thresh=0.3, coord_start=2, score_index=1, id_index=0,
         force_suppress=True, topk=12),
    dict(overlap_thresh=0.45, valid_thresh=0.3, coord_start=2,
         score_index=1)])
def test_box_nms(attrs):
    data = np.stack([_nms_rows(7, 96, ties=True), _nms_rows(8, 96)])
    (got, _), (want, _) = both(contrib("box_nms"), [data], attrs)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("attrs", [
    dict(nms_threshold=0.45), dict(nms_threshold=0.5, nms_topk=20,
                                   threshold=0.2),
    dict(nms_threshold=0.45, force_suppress=True, clip=False)])
def test_multibox_detection(attrs):
    anchor = _anchors()
    A = anchor.shape[1]
    rs = np.random.RandomState(9)
    logits = rs.randn(2, 4, A).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, A * 4) * 0.5).astype(np.float32)
    (got, _), (want, _) = both(contrib("MultiBoxDetection"),
                               [prob, loc, anchor], attrs)
    kept_g, kept_w = got[0][..., 0] >= 0, want[0][..., 0] >= 0
    np.testing.assert_array_equal(kept_g, kept_w)
    _close(got[0], want[0], 1e-6, "detections")


# ------------------------------------------------------------------- RCNN
def _rpn(seed, B=2, H=5, W=6, K=12):
    rs = np.random.RandomState(seed)
    cls = rs.rand(B, 2 * K, H, W).astype(np.float32)
    cls[:, K:K + 2, 1, 1] = 0.5           # ties among the scores
    bbox = (rs.randn(B, 4 * K, H, W) * 0.2).astype(np.float32)
    info = np.array([[80, 96, 1.0], [70, 90, 0.8]], np.float32)[:B]
    return cls, bbox, info


@pytest.mark.parametrize("name", ["Proposal", "MultiProposal"])
@pytest.mark.parametrize("attrs", [
    dict(rpn_pre_nms_top_n=100, rpn_post_nms_top_n=20, threshold=0.7,
         rpn_min_size=4),
    dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40, threshold=0.5,
         rpn_min_size=16, output_score=True)])
def test_proposal(name, attrs):
    (got, _), (want, _) = both(contrib(name), list(_rpn(10)), attrs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, name)


def _rois(seed, R, B, size):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, size * 0.6, (R, 2))
    wh = rs.uniform(4, size * 0.4, (R, 2))
    return np.concatenate([rs.randint(B, size=(R, 1)), xy, xy + wh],
                          1).astype(np.float32)


def test_psroi_pooling_and_gradient():
    rs = np.random.RandomState(11)
    data = rs.randn(2, 3 * 3 * 3, 8, 10).astype(np.float32)
    rois = _rois(12, 20, 2, 128)
    attrs = dict(spatial_scale=1 / 16, output_dim=3, pooled_size=3)
    (got, gg), (want, wg) = both(contrib("PSROIPooling"), [data, rois],
                                 attrs, grad_idx=(0,))
    _close(got[0], want[0], TOL, "psroi")
    _close(gg[0], wg[0], TOL, "psroi grad")


def test_psroi_pooling_bin_edges_divide_truly():
    """A roi whose last bin edge lands on an integer (x 15.5 .. 30 on the
    map, 7 bins): MXNet divides the roi's size by the bin count, so the
    edge stays 30 and ceil keeps it.  The JAX op's compiled form
    multiplies by 1/7 and moves it to 31 (``ROADMAP.md``, reference
    caveats), so the port is held to numpy's loops of MXNet's rule."""
    rs = np.random.RandomState(23)
    data = rs.randn(1, 49, 38, 50).astype(np.float32)
    roi = np.array([[0, 247.5, 202.8, 478.8, 498.5]], np.float32)
    with tmx.cpu():
        got = tmx.nd.contrib.PSROIPooling(
            tmx.nd.array(data), tmx.nd.array(roi), spatial_scale=1 / 16,
            output_dim=1, pooled_size=7).asnumpy()[0, 0]
    x1, y1, x2, y2 = 15.5, 203 / 16, 30.0, 31.25
    want = np.zeros((7, 7))
    for i in range(7):
        for j in range(7):
            hs = int(np.floor(y1 + i * np.float32((y2 - y1) / 7)))
            he = int(np.ceil(y1 + (i + 1) * np.float32((y2 - y1) / 7)))
            ws = int(np.floor(x1 + j * (x2 - x1) / 7))
            we = int(np.ceil(x1 + (j + 1) * (x2 - x1) / 7))
            want[i, j] = data[0, i * 7 + j, hs:he, ws:we].mean()
    assert int(np.ceil(x1 + 7 * np.float32((x2 - x1) / 7))) == 30
    _close(got, want, TOL, "psroi bin edges")


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling_and_gradients(no_trans):
    rs = np.random.RandomState(13)
    data = rs.randn(2, 2 * 3 * 3, 8, 10).astype(np.float32)
    rois = _rois(14, 18, 2, 128)
    trans = (rs.randn(18, 2, 3, 3) * 0.3).astype(np.float32)
    attrs = dict(spatial_scale=1 / 16, output_dim=2, pooled_size=3,
                 sample_per_part=2, trans_std=0.1, no_trans=no_trans)
    grad_idx = (0,) if no_trans else (0, 2)
    (got, gg), (want, wg) = both(contrib("DeformablePSROIPooling"),
                                 [data, rois, trans], attrs,
                                 grad_idx=grad_idx)
    _close(got[0], want[0], TOL, "deformable psroi")
    for g, w, what in zip(gg, wg, ("data", "trans")):
        _close(g, w, TOL, f"deformable psroi grad {what}")


@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), pad=(1, 1), num_filter=5),
    dict(kernel=(3, 3), stride=(2, 2), dilate=(2, 2), pad=(2, 2),
         num_filter=4, num_deformable_group=2)])
def test_deformable_convolution_and_gradients(attrs):
    rs = np.random.RandomState(15)
    data = rs.randn(2, 4, 9, 11).astype(np.float32)
    kh, kw = attrs["kernel"]
    sh, sw = attrs.get("stride", (1, 1))
    dh, dw = attrs.get("dilate", (1, 1))
    ph, pw = attrs["pad"]
    Ho = (9 + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    Wo = (11 + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    dg = attrs.get("num_deformable_group", 1)
    offset = (rs.randn(2, 2 * dg * kh * kw, Ho, Wo) * 1.5).astype(
        np.float32)
    weight = (rs.randn(attrs["num_filter"], 4, kh, kw) * 0.3).astype(
        np.float32)
    bias = rs.randn(attrs["num_filter"]).astype(np.float32)
    (got, gg), (want, wg) = both(contrib("DeformableConvolution"),
                                 [data, offset, weight, bias], attrs,
                                 grad_idx=(0, 1, 2, 3))
    _close(got[0], want[0], TOL, "deformable conv")
    for g, w, what in zip(gg, wg, ("data", "offset", "weight", "bias")):
        _close(g, w, TOL, f"deformable conv grad {what}")


def test_deformable_convolution_refuses_groups():
    with tmx.cpu():
        x = tmx.nd.zeros((1, 4, 5, 5))
        with pytest.raises(tmx.MXNetError):
            tmx.nd.contrib.DeformableConvolution(
                x, tmx.nd.zeros((1, 18, 5, 5)), tmx.nd.zeros((4, 2, 3, 3)),
                kernel=(3, 3), pad=(1, 1), num_filter=4, num_group=2)


# ---------------------------------------------------------------- the rest
def test_fft_ifft_and_gradients():
    x = np.random.RandomState(16).randn(3, 8).astype(np.float32)
    (got, gg), (want, wg) = both(contrib("fft"), [x], grad_idx=(0,))
    _close(got[0], want[0], TOL, "fft")
    _close(gg[0], wg[0], TOL, "fft grad")
    y = np.random.RandomState(17).randn(3, 16).astype(np.float32)
    (got, gg), (want, wg) = both(contrib("ifft"), [y], grad_idx=(0,))
    _close(got[0], want[0], TOL, "ifft")
    _close(gg[0], wg[0], TOL, "ifft grad")
    with tmx.cpu():   # ifft is fft's unnormalised inverse
        back = tmx.nd.contrib.ifft(tmx.nd.contrib.fft(tmx.nd.array(x)))
    _close(back.asnumpy() / 8, x, TOL, "round trip")


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_quantize_dequantize(out_type):
    x = np.random.RandomState(18).uniform(-2, 3, (4, 9)).astype(np.float32)
    lo, hi = np.array([-2.0], np.float32), np.array([3.0], np.float32)
    (got, _), (want, _) = both(contrib("quantize"), [x, lo, hi],
                               dict(out_type=out_type))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    (got, _), (want, _) = both(contrib("dequantize"), [want[0], lo, hi])
    _close(got[0], want[0], 1e-6, "dequantize")


def test_count_sketch_and_gradient():
    rs = np.random.RandomState(19)
    x = rs.randn(5, 12).astype(np.float32)
    h = rs.randint(0, 7, 12).astype(np.float32)
    s = rs.choice([-1.0, 1.0], 12).astype(np.float32)
    (got, gg), (want, wg) = both(contrib("count_sketch"), [x, h, s],
                                 dict(out_dim=7), grad_idx=(0,))
    _close(got[0], want[0], TOL, "count_sketch")
    _close(gg[0], wg[0], TOL, "count_sketch grad")


def test_krprod():
    rs = np.random.RandomState(20)
    a, b = rs.randn(3, 4).astype(np.float32), rs.randn(2, 4).astype(
        np.float32)
    (got, gg), (want, wg) = both(contrib("krprod"), [a, b], grad_idx=(0, 1))
    _close(got[0], want[0], TOL, "krprod")
    for g, w in zip(gg, wg):
        _close(g, w, TOL, "krprod grad")


@pytest.mark.parametrize("attrs", [
    dict(threshold=0.3), dict(threshold=0.2, is_ascend=True),
    dict(threshold=0.1, topk=2)])
def test_bipartite_matching(attrs):
    rs = np.random.RandomState(21)
    data = np.round(rs.rand(2, 5, 4) * 8).astype(np.float32) / 8   # ties
    (got, _), (want, _) = both(contrib("bipartite_matching"), [data], attrs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_contrib_namespaces_expose_the_ops():
    names = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
             "box_nms", "box_iou", "bipartite_matching", "ctc_loss",
             "Proposal", "MultiProposal", "PSROIPooling",
             "DeformablePSROIPooling", "DeformableConvolution", "fft",
             "ifft", "quantize", "dequantize", "count_sketch", "krprod")
    for n in names:
        assert callable(getattr(tmx.nd.contrib, n)), n
        assert callable(getattr(tmx.sym.contrib, n)), n
