"""The port's spatial ops (``ops/spatial.py``) and image ops
(``ops/image_ops.py``, ``nd.image``) held to the JAX package's on the
CPU, each under every registered name.

Spatial: ``GridGenerator`` (affine, warp), ``BilinearSampler``,
``SpatialTransformer``, ``ROIPooling`` and ``Correlation``, forward and
gradient, within 1e-5 of the reference's max (other summation orders;
``F.grid_sample`` against JAX's four-corner gather).  ROIPooling's
gradient splits ties evenly, as ``jnp.max`` does, which the test checks
on quantised inputs; its bin edges follow MXNet's true division, so the
roi sizes at which the JAX op's reciprocal product moves an edge are
held to MXNet's rule in numpy instead (reference caveat, ROADMAP §C).

Image: the deterministic ops bit for bit against the JAX ops, except
the flips, which follow MXNet's axes and are held to numpy (the JAX
flips reverse the channels of an HWC image; reference caveat).  The
random ops' bits differ from JAX's: each is held to the JAX formula at
the factor the port drew (the first draws of a generator seeded as
``mx.random.seed`` seeds the device's), one factor for the whole batch,
and its draws to their range.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TOL = 1e-5


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err / scale)


def _run(m, name, arrays, attrs, grad_idx=(), head_seed=3):
    xs = [m.nd.array(a, dtype=a.dtype) for a in arrays]
    for i in grad_idx:
        xs[i].attach_grad()
    with m.autograd.record():
        out = getattr(m.nd, name)(*xs, **attrs)
        head = np.random.RandomState(head_seed).randn(
            *out.shape).astype(np.float32)
        loss = (out * m.nd.array(head)).sum()
    if grad_idx:
        loss.backward()
    return out.asnumpy(), [xs[i].grad.asnumpy() for i in grad_idx]


def both(name, arrays, attrs=None, grad_idx=()):
    attrs = attrs or {}
    want = _run(jmx, name, arrays, attrs, grad_idx)
    with tmx.cpu():
        got = _run(tmx, name, arrays, attrs, grad_idx)
    return got, want


def _check(name, arrays, attrs=None, grad_idx=(), tol=TOL):
    (got, gg), (want, wg) = both(name, arrays, attrs, grad_idx)
    _close(got, want, tol, name)
    for i, a, b in zip(grad_idx, gg, wg):
        _close(a, b, tol, f"{name} grad {i}")
    return got


# ------------------------------------------------------------ grid + sampler
@pytest.mark.parametrize("name", ["GridGenerator", "grid_generator"])
def test_grid_generator_affine_and_warp(name):
    rs = np.random.RandomState(0)
    theta = (np.array([1, 0, 0, 0, 1, 0], np.float32) +
             0.2 * rs.randn(3, 6)).astype(np.float32)
    _check(name, [theta], dict(transform_type="affine",
                               target_shape=(5, 7)), grad_idx=(0,))
    flow = (2 * rs.randn(2, 2, 6, 9)).astype(np.float32)
    _check(name, [flow], dict(transform_type="warp"), grad_idx=(0,))


def _grid(rs, b, h, w):
    """Sampling points in and around the map, none on a pixel edge."""
    return rs.uniform(-1.2, 1.2, (b, 2, h, w)).astype(np.float32)


@pytest.mark.parametrize("name", ["BilinearSampler", "bilinear_sampler"])
def test_bilinear_sampler(name):
    rs = np.random.RandomState(1)
    data = rs.randn(2, 3, 6, 8).astype(np.float32)
    _check(name, [data, _grid(rs, 2, 5, 7)], grad_idx=(0, 1))


@pytest.mark.parametrize("name", ["SpatialTransformer",
                                  "spatial_transformer"])
def test_spatial_transformer(name):
    rs = np.random.RandomState(2)
    data = rs.randn(2, 3, 9, 10).astype(np.float32)
    loc = (np.array([0.9, 0.1, 0.05, -0.1, 1.1, -0.05], np.float32) +
           0.1 * rs.randn(2, 6)).astype(np.float32)
    _check(name, [data, loc], dict(target_shape=(6, 7)), grad_idx=(0, 1))
    _check(name, [data, loc], {}, grad_idx=(0, 1))


def test_warp_through_the_sampler():
    """GridGenerator("warp") into BilinearSampler, FlowNet2's warping
    layer, with the flow's gradient."""
    rs = np.random.RandomState(3)
    img = rs.randn(2, 3, 7, 9).astype(np.float32)
    flow = (1.5 * rs.randn(2, 2, 7, 9)).astype(np.float32)
    outs = []
    for m in (jmx, tmx):
        with (tmx.cpu() if m is tmx else jmx.cpu()):
            x, f = m.nd.array(img), m.nd.array(flow)
            f.attach_grad()
            with m.autograd.record():
                y = m.nd.BilinearSampler(
                    x, m.nd.GridGenerator(f, transform_type="warp"))
                loss = (y * y).sum()
            loss.backward()
            outs.append((y.asnumpy(), f.grad.asnumpy()))
    _close(outs[1][0], outs[0][0], TOL, "warp")
    _close(outs[1][1], outs[0][1], 1e-4, "warp flow grad")


# ----------------------------------------------------------------- ROIPooling
def _rois(rs, r, b, h, w, scale):
    """rois [batch, x1, y1, x2, y2] in image coordinates: random boxes,
    one past the map's edge and one of a single pixel."""
    x1 = rs.uniform(0, w / scale * 0.7, r)
    y1 = rs.uniform(0, h / scale * 0.7, r)
    x2 = x1 + rs.uniform(1, w / scale * 0.6, r)
    y2 = y1 + rs.uniform(1, h / scale * 0.6, r)
    rois = np.stack([rs.randint(0, b, r), x1, y1, x2, y2], 1)
    rois[0, 3:] = [w / scale * 1.5, h / scale * 1.4]
    rois[1, 1:] = [3 / scale, 2 / scale, 3 / scale, 2 / scale]
    return rois.astype(np.float32)


def _edge_free(rois, pooled, scale):
    """Whether every bin edge of ``rois`` is the same under a true
    division and under the JAX op's product with the reciprocal, which
    moves an edge that falls on an integer (see the bin-edge test)."""
    f32 = np.float32
    for r in rois:
        x1, y1, x2, y2 = np.round(r[1:].astype(f32) * f32(scale))
        for lo, ext, p in ((y1, y2 - y1 + 1, pooled[0]),
                           (x1, x2 - x1 + 1, pooled[1])):
            ext = f32(max(ext, 1.0))

            def edges(size):
                return [(np.floor(lo + f32(i) * size),
                         np.ceil(lo + f32(i + 1) * size)) for i in range(p)]

            if edges(ext / f32(p)) != edges(ext * f32(1.0 / p)):
                return False
    return True


@pytest.mark.parametrize("name", ["ROIPooling", "roi_pooling"])
def test_roi_pooling_forward_and_gradient(name):
    rs = np.random.RandomState(4)
    data = rs.randn(2, 5, 12, 14).astype(np.float32)
    rois = _rois(rs, 40, 2, 12, 14, 0.5)
    rois = rois[[i for i in range(len(rois))
                 if _edge_free(rois[i:i + 1], (3, 4), 0.5)]]
    assert len(rois) >= 10
    _check(name, [data, rois], dict(pooled_size=(3, 4), spatial_scale=0.5),
           grad_idx=(0,))


def test_roi_pooling_splits_tied_maxima_evenly():
    """Data quantised to four levels: many bins hold their max more than
    once, and each tied position gets an equal share, as ``jnp.max`` over
    the bin's window gives it (a max over rows then columns would not)."""
    rs = np.random.RandomState(5)
    data = rs.randint(0, 4, (1, 3, 10, 10)).astype(np.float32)
    rois = np.array([[0, 0, 0, 9, 9], [0, 2, 1, 8, 9], [0, 1, 1, 5, 6],
                     [0, 0, 3, 4, 4]], np.float32)
    rois = rois[[i for i in range(4) if _edge_free(rois[i:i + 1], (2, 2),
                                                    1.0)]]
    (got, gg), (want, wg) = both("ROIPooling", [data, rois],
                                 dict(pooled_size=(2, 2)), grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    _close(gg[0], wg[0], 1e-6, "tied grad")
    frac = gg[0][gg[0] != 0]
    assert len(np.unique(np.round(np.abs(frac), 6))) > len(rois) * 3


def _mxnet_bins(roi_extent, pooled):
    """MXNet's roi_pooling.cc bin rows for a roi starting at 0: [floor(p *
    e / P), ceil((p + 1) * e / P)), in float32 with a true division."""
    size = np.float32(roi_extent) / np.float32(pooled)
    return [(int(np.floor(np.float32(p) * size)),
             int(np.ceil(np.float32(p + 1) * size))) for p in range(pooled)]


def test_roi_pooling_bin_edges_divide_truly():
    """Square rois of side 7 .. 59 at scale 1 and pooled 7: each bin's
    rows, read off the gradient of a one-hot head, are MXNet's true
    division's (the JAX op gives e.g. side 49's bin 0 an eighth row)."""
    side = np.arange(7, 60)
    data = torch.arange(64 * 64, dtype=torch.float32).reshape(1, 1, 64, 64)
    data = tmx.nd.array(data.numpy(), ctx=tmx.cpu())
    moved = 0
    for s in side:
        rois = np.array([[0, 0, 0, s - 1, s - 1]], np.float32)
        with tmx.cpu():
            d = data.copy()
            d.attach_grad()
            with tmx.autograd.record():
                out = tmx.nd.ROIPooling(d, tmx.nd.array(rois),
                                        pooled_size=(7, 7))
            out.backward(tmx.nd.ones(out.shape))
        # the data grow along rows and columns: bin (p, q)'s max is its
        # last row and column, which the gradient marks
        g = d.grad.asnumpy()[0, 0]
        rows = sorted(set(np.nonzero(g)[0]))
        want = _mxnet_bins(s, 7)
        assert rows == [hi - 1 for _, hi in want], s
        vals = out.asnumpy()[0, 0]
        for p, (_, hi) in enumerate(want):
            assert vals[p, 0] == (hi - 1) * 64 + want[0][1] - 1, (s, p)
        j = jmx.nd.ROIPooling(jmx.nd.array(data.asnumpy()),
                              jmx.nd.array(rois), pooled_size=(7, 7))
        moved += not np.array_equal(j.asnumpy(), vals)
    assert moved > 0     # the caveat is real on this JAX build


def test_roi_pooling_empty_bins_give_zero():
    data = np.random.RandomState(6).randn(1, 2, 6, 6).astype(np.float32)
    rois = np.array([[0, 20, 20, 30, 30], [0, -9, -9, -4, -4]], np.float32)
    (got, gg), (want, wg) = both("ROIPooling", [data, rois],
                                 dict(pooled_size=(2, 3)), grad_idx=(0,))
    np.testing.assert_array_equal(got, np.zeros_like(got))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gg[0], wg[0])


# ---------------------------------------------------------------- Correlation
_CORR = [dict(kernel_size=1, max_displacement=2, stride2=1, pad_size=2),
         dict(kernel_size=1, max_displacement=3, stride2=2, pad_size=3,
              stride1=2),
         dict(kernel_size=3, max_displacement=2, stride2=1, pad_size=1,
              is_multiply=False),
         dict(kernel_size=2, max_displacement=1, pad_size=0)]


@pytest.mark.parametrize("name", ["Correlation", "correlation"])
@pytest.mark.parametrize("case", range(len(_CORR)))
def test_correlation(name, case):
    """Displacements wider than the padding roll around, as in JAX."""
    rs = np.random.RandomState(7 + case)
    a = rs.randn(2, 4, 7, 8).astype(np.float32)
    b = rs.randn(2, 4, 7, 8).astype(np.float32)
    out = _check(name, [a, b], _CORR[case], grad_idx=(0, 1))
    d, s2 = _CORR[case]["max_displacement"], _CORR[case].get("stride2", 1)
    assert out.shape[1] == len(range(-d, d + 1, s2)) ** 2


# ------------------------------------------------------------ image: fixed
def _img(seed, shape=(5, 6, 3)):
    return np.random.RandomState(seed).randint(
        0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("name", ["_image_to_tensor", "to_tensor"])
def test_to_tensor(name):
    for shape in [(5, 6, 3), (2, 5, 6, 3)]:
        (got, _), (want, _) = both(name, [_img(0, shape)])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert hasattr(tmx.nd.image, "to_tensor")


@pytest.mark.parametrize("name", ["_image_normalize", "image_normalize"])
def test_normalize(name):
    x = np.random.RandomState(1).rand(2, 3, 4, 5).astype(np.float32)
    attrs = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    (got, gg), (want, wg) = both(name, [x], attrs, grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gg[0], wg[0])
    (got, _), (want, _) = both(name, [x[0]], dict(mean=(0.5,), std=(2.0,)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,axis", [
    ("_image_flip_left_right", -2), ("flip_left_right", -2),
    ("_image_flip_top_bottom", -3), ("flip_top_bottom", -3)])
def test_flips_follow_mxnet_axes(name, axis):
    """MXNet flips the width (left-right) or the height (top-bottom) of
    an HWC image or an NHWC batch; the JAX op reverses other axes."""
    for shape in [(5, 6, 3), (2, 5, 6, 3)]:
        x = _img(2, shape)
        with tmx.cpu():
            got = getattr(tmx.nd, name)(tmx.nd.array(x, dtype="uint8"))
        np.testing.assert_array_equal(got.asnumpy(), np.flip(x, axis))
    # the JAX ops reverse the channels of an image (left-right) and the
    # width of a batch (top-bottom)
    x = _img(3, (5, 6, 3) if axis == -2 else (2, 5, 6, 3))
    j = getattr(jmx.nd, name)(jmx.nd.array(x, dtype="uint8")).asnumpy()
    assert not np.array_equal(j, np.flip(x, axis))


# ----------------------------------------------------------- image: random
def _port_draws(seed, n, kind="rand"):
    """The first ``n`` draws the port's CPU generator gives after
    ``mx.random.seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    fn = torch.rand if kind == "rand" else torch.randn
    return [fn((), generator=gen).item() for _ in range(n)]


def _port_op(name, x, seed, **attrs):
    with tmx.cpu():
        tmx.random.seed(seed)
        return getattr(tmx.nd, name)(
            tmx.nd.array(x, dtype=x.dtype), **attrs).asnumpy()


def _gray(x):
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return (x * w).sum(-1, keepdims=True)


def _hue_matrix(f):
    theta = np.float32((f - 1.0) * np.pi)
    u, w = np.cos(theta), np.sin(theta)
    yiq = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                    [0.211, -0.523, 0.311]], np.float32)
    rgb = np.array([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647],
                    [1.0, -1.107, 1.705]], np.float32)
    rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
    return rgb @ rot @ yiq


def _factor(u, lo, hi):
    return np.float32(u) * np.float32(hi - lo) + np.float32(lo)


@pytest.mark.parametrize("name", ["_image_random_flip_left_right",
                                  "random_flip_left_right",
                                  "_image_random_flip_top_bottom",
                                  "random_flip_top_bottom"])
def test_random_flips(name):
    axis = -2 if "left" in name else -3
    x = _img(4, (2, 5, 6, 3))
    seen = set()
    for seed in range(12):
        got = _port_op(name, x, seed)
        flipped = _port_draws(seed, 1)[0] < 0.5
        np.testing.assert_array_equal(
            got, np.flip(x, axis) if flipped else x)
        seen.add(flipped)
    assert seen == {True, False}
    assert _port_op(name, x, 3).shape == getattr(jmx.nd, name)(
        jmx.nd.array(x, dtype="uint8")).shape


_FACTOR_OPS = [
    ("_image_random_brightness", dict(min_factor=0.6, max_factor=1.4),
     lambda x, f: x * f),
    ("random_brightness", {}, lambda x, f: x * f),
    ("_image_random_contrast", dict(min_factor=0.3, max_factor=1.7),
     lambda x, f: x * f + _gray(x).mean() * (1 - f)),
    ("random_contrast", {}, lambda x, f: x * f + _gray(x).mean() * (1 - f)),
    ("_image_random_saturation", dict(min_factor=0.2, max_factor=1.2),
     lambda x, f: x * f + _gray(x) * (1 - f)),
    ("random_saturation", {}, lambda x, f: x * f + _gray(x) * (1 - f)),
    ("_image_random_hue", dict(min_factor=0.7, max_factor=1.3),
     lambda x, f: np.einsum("...c,dc->...d", x, _hue_matrix(f))),
    ("random_hue", {}, lambda x, f: np.einsum("...c,dc->...d", x,
                                               _hue_matrix(f))),
]


@pytest.mark.parametrize("name,attrs,formula", _FACTOR_OPS,
                         ids=[f[0] for f in _FACTOR_OPS])
def test_random_factor_ops(name, attrs, formula):
    """One factor for the whole batch, drawn in its range: the output is
    the JAX op's formula at that factor, and the JAX op agrees on the
    shape and dtype."""
    x = np.random.RandomState(5).rand(3, 5, 6, 3).astype(np.float32) * 255
    defaults = (0.9, 1.1) if "hue" in name else (0.5, 1.5)
    lo = attrs.get("min_factor", defaults[0])
    hi = attrs.get("max_factor", defaults[1])
    for seed in (0, 1, 2):
        f = _factor(_port_draws(seed, 1)[0], lo, hi)
        assert lo <= f < hi
        got = _port_op(name, x, seed, **attrs)
        _close(got, formula(x, f), 1e-6, name)
    want = getattr(jmx.nd, name)(jmx.nd.array(x), **attrs).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("name", ["_image_random_color_jitter",
                                  "random_color_jitter"])
def test_random_color_jitter(name):
    x = np.random.RandomState(6).rand(2, 4, 5, 3).astype(np.float32) * 255
    attrs = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)
    got = _port_op(name, x, 9, **attrs)
    u = _port_draws(9, 4)
    b, c, s, h = (_factor(v, 1 - a, 1 + a) for v, a in
                  zip(u, (0.4, 0.4, 0.4, 0.1)))
    want = x * b
    want = want * c + _gray(want).mean() * (1 - c)
    want = want * s + _gray(want) * (1 - s)
    want = np.einsum("...c,dc->...d", want, _hue_matrix(h))
    _close(got, want, 1e-6, name)
    only = _port_op(name, x, 9, brightness=0.4)
    _close(only, x * b, 1e-7, "brightness alone")
    j = getattr(jmx.nd, name)(jmx.nd.array(x), **attrs).asnumpy()
    assert j.shape == got.shape and j.dtype == got.dtype


@pytest.mark.parametrize("name", ["_image_random_lighting",
                                  "random_lighting"])
def test_random_lighting(name):
    x = np.random.RandomState(7).rand(2, 4, 5, 3).astype(np.float32) * 255
    got = _port_op(name, x, 4, alpha_std=0.1)
    gen = torch.Generator().manual_seed(4)
    alpha = (torch.randn(3, generator=gen) * 0.1).numpy()
    eigval = np.array([55.46, 4.794, 1.148], np.float32)
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]], np.float32)
    delta = (eigvec * alpha * eigval).sum(1)
    _close(got, x + delta, 1e-7, name)
    j = getattr(jmx.nd, name)(jmx.nd.array(x), alpha_std=0.1).asnumpy()
    d = (j - x).reshape(-1, 3)
    assert np.allclose(d, d[0], atol=1e-4)       # one offset per call
    assert j.shape == got.shape and j.dtype == got.dtype


def test_uint8_batch_through_the_augmentation_chain():
    """The smoke's image chain on a uint8 NHWC batch: flip, jitter,
    lighting, to_tensor, normalize: float32 NCHW, finite, and the same
    under the same seed."""
    x = _img(8, (4, 8, 8, 3))
    runs = []
    for _ in range(2):
        with tmx.cpu():
            tmx.random.seed(11)
            y = tmx.nd.array(x, dtype="uint8")
            y = tmx.nd.image.random_flip_left_right(y)
            y = tmx.nd.image.random_color_jitter(y, brightness=0.4,
                                                 contrast=0.4,
                                                 saturation=0.4, hue=0.1)
            y = tmx.nd.image.random_lighting(y, alpha_std=0.1)
            y = tmx.nd.image.to_tensor(y)
            y = tmx.nd.image.normalize(y, mean=(0.485, 0.456, 0.406),
                                       std=(0.229, 0.224, 0.225))
            runs.append(y.asnumpy())
    assert runs[0].shape == (4, 3, 8, 8) and runs[0].dtype == np.float32
    assert np.isfinite(runs[0]).all()
    np.testing.assert_array_equal(runs[0], runs[1])
