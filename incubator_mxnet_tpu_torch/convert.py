"""Weight transfer from the JAX package's parameter names to the port.

``resnet_params_from_numpy`` does the same for the ResNet V1 and V2
model zoo (its docstring gives the structures it maps), and
``resnet_params_to_numpy`` maps the port's ResNet ``state_dict`` back
to the JAX names, bit for bit (``resnet_param_names``, which the zoo's
``collect_params`` names its Parameters by).

``params_from_numpy`` takes ``{jax_param_name: np.ndarray}`` — what
``TransformerDecoder.collect_params()`` of the JAX package gives, each
value turned into numpy by the caller — and returns the port's
``state_dict`` of ``gluon.decoder.TransformerDecoder``.  The port never
sees a JAX object.  The JAX names are structural
(``<prefix>pos``, ``<prefix>embedding0_weight``,
``<prefix>sequential0_decoderlayer<i>_<layer><n>_<param>``,
``<prefix>layernorm0_*``, ``<prefix>dense0_*``), so the mapping is by
position within that structure, whatever the model's prefix.

A model-parallel block's arrays cross as its global arrays (a
``PipelineStack``'s stacked ``s{i}_`` parameters among them): on a
parameter a step has cut, ``gluon_params_from_numpy`` keeps this rank's
block, and ``gluon_params_to_numpy`` gathers the global array (a
collective every rank calls).

``gluon_params_from_numpy(net, named_arrays)`` loads the arrays into a
Gluon block of the port (the zoo's VGG, AlexNet, DenseNet, SqueezeNet,
Inception and MobileNet, a user's ``HybridBlock`` such as an SSD): a
Gluon block's Parameters carry the JAX package's full names
(``densenet0_conv0_weight`` ...), so the mapping is the identity, and
``gluon_params_to_numpy(net)`` gives the same dictionary back.

Sparse arrays cross as their numpy components: the JAX package keeps a
``CSRNDArray`` as host ``_data`` / ``_indices`` / ``_indptr`` and a
``RowSparseNDArray`` as ``_data`` / ``_indices``;
``sparse_from_numpy({"stype": ..., "shape": ..., "data": ...,
"indices": ..., ["indptr": ...]}, ctx)`` builds the port's array of the
same storage on ``ctx`` (its components torch tensors there), and
``sparse_to_numpy(arr)`` gives the dictionary back.

Arrays of the imperative path (``mx.nd``) cross between the packages
as files instead: ``ndarray.save`` / ``ndarray.load`` write MXNet's
binary ``.params`` format and read it and the JAX package's ``.npz``
(``ndarray/utils.py``, ``ndarray/mxnet_format.py``).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["gluon_params_from_numpy", "gluon_params_to_numpy",
           "params_from_numpy", "resnet_param_names",
           "resnet_params_from_numpy", "resnet_params_to_numpy",
           "sparse_from_numpy", "sparse_to_numpy"]

# child blocks of a JAX DecoderLayer in creation order -> port names
_LAYER_CHILDREN = {"layernorm0": "ln1", "dense0": "qkv", "dense1": "proj",
                   "layernorm1": "ln2", "dense2": "fc1", "dense3": "fc2"}
_TOP = {"embedding0_weight": "embed.weight", "layernorm0_gamma":
        "ln_f.gamma", "layernorm0_beta": "ln_f.beta",
        "dense0_weight": "head.weight", "dense0_bias": "head.bias"}
_LAYER_RE = re.compile(r"sequential\d+_decoderlayer(\d+)_([a-z]+\d+)_"
                       r"(weight|bias|gamma|beta)$")


def params_from_numpy(named_arrays):
    """``{jax_param_name: np.ndarray}`` -> the port's ``state_dict``
    (CPU float tensors; ``load_state_dict`` moves them to the module's
    device).  Raises MXNetError on a name it cannot place."""
    pos = [n for n in named_arrays if n.endswith("pos")]
    if len(pos) != 1:
        raise MXNetError(f"expected one position table '<prefix>pos', "
                         f"found {pos}")
    prefix = pos[0][:-len("pos")]
    layers = sorted({int(m.group(1)) for n in named_arrays
                     if (m := _LAYER_RE.search(n))})
    index = {j: i for i, j in enumerate(layers)}   # JAX counter -> depth
    out = {}
    for name, arr in named_arrays.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the prefix "
                             f"{prefix!r}")
        rest = name[len(prefix):]
        m = _LAYER_RE.fullmatch(rest)
        if rest == "pos":
            key = "pos"
        elif m and m.group(2) in _LAYER_CHILDREN:
            key = (f"layers.{index[int(m.group(1))]}."
                   f"{_LAYER_CHILDREN[m.group(2)]}.{m.group(3)}")
        elif rest in _TOP:
            key = _TOP[rest]
        else:
            raise MXNetError(f"cannot place JAX parameter {name!r}")
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def gluon_params_from_numpy(net, named_arrays, ctx=None):
    """Set every Parameter of the Gluon block ``net`` from
    ``{jax_param_name: np.ndarray}`` (deferred shapes included), on
    ``ctx`` or where each Parameter was to be initialised.  Raises
    MXNetError on a name the block lacks or a Parameter left without a
    value."""
    params = net.collect_params()
    missing = set(params.keys()) - set(named_arrays)
    extra = set(named_arrays) - set(params.keys())
    if missing or extra:
        raise MXNetError(f"names differ: the block lacks {sorted(extra)}, "
                         f"the arrays lack {sorted(missing)}")
    for name, arr in named_arrays.items():
        params[name]._load_init(np.asarray(arr), ctx)
    return net


def gluon_params_to_numpy(net):
    """``{full_name: np.ndarray}`` of the Gluon block ``net``'s
    Parameters, the names the JAX package's twin has."""
    return {name: p.data().asnumpy()
            for name, p in net.collect_params().items()}


def sparse_from_numpy(parts, ctx=None):
    """The port's ``CSRNDArray`` or ``RowSparseNDArray`` from numpy
    components: ``parts`` holds ``stype`` (``"csr"`` or
    ``"row_sparse"``), ``shape``, ``data``, ``indices`` and, for csr,
    ``indptr``."""
    from .ndarray import sparse
    stype = parts["stype"]
    data = np.asarray(parts["data"])
    if stype == "csr":
        return sparse.CSRNDArray(data, parts["indices"], parts["indptr"],
                                 parts["shape"], dtype=data.dtype, ctx=ctx)
    if stype == "row_sparse":
        return sparse.RowSparseNDArray(data, parts["indices"],
                                       parts["shape"], dtype=data.dtype,
                                       ctx=ctx)
    raise MXNetError(f"unknown stype {stype!r}")


def sparse_to_numpy(arr):
    """The numpy components of a port sparse array (the dictionary
    ``sparse_from_numpy`` takes)."""
    parts = {"stype": arr.stype, "shape": arr.shape,
             "data": arr._data.cpu().numpy(),
             "indices": arr._indices.cpu().numpy()}
    if arr.stype == "csr":
        parts["indptr"] = arr._indptr.cpu().numpy()
    return parts


_RESNET_RE = re.compile(r"(?:stage(\d+)_)?(conv2d|batchnorm|dense)(\d+)_"
                        r"(weight|bias|gamma|beta|running_mean|running_var)")
_BN_PARAMS = ("gamma", "beta", "running_mean", "running_var")
# the port's keys, within a block, of its convs and of the BatchNorm
# each conv's output goes through, in the JAX package's creation order
_BOTTLENECK = (("body.0", "body.1.conv", "body.2.conv"),
               ("body.1.bn", "body.2.bn", "body.3"))
_BASIC = (("body.0", "body.1.conv"), ("body.1.bn", "body.2"))
_DOWNSAMPLE = ("downsample.0", "downsample.1")
# ResNet V2 (pre-activation): within a block, the port's convs and the
# BatchNorm each conv's INPUT goes through (bn1 feeds conv1 and the
# downsample conv, which has no BatchNorm of its own), in the JAX
# package's creation order: bn1, conv1, [bn, conv] of fused2 (and of
# fused3 in a bottleneck), then the downsample conv
_BOTTLENECK_V2 = (("conv1", "fused2.conv", "fused3.conv"),
                  ("bn1", "fused2.bn", "fused3.bn"))
_BASIC_V2 = (("conv1", "fused2.conv"), ("bn1", "fused2.bn"))
_DOWNSAMPLE_V2 = "downsample"


def resnet_params_from_numpy(named_arrays):
    """``{jax_param_name: np.ndarray}`` of a JAX ResNet V1 (any depth,
    any ``fuse_block`` and ``fuse_bn_relu``, thumbnail or not) -> the
    state_dict of the port's ``gluon.model_zoo.vision.ResNetV1``; of a
    JAX ResNet V2 (told apart by its top-level BatchNorms: the stem's
    on the images, one after the stem conv unless thumbnail, and the
    closing one) -> that of the port's ``ResNetV2``.

    The JAX names are structural: ``<prefix>conv2d0_weight`` and
    ``<prefix>batchnorm0_*`` (the stem; no BN on a thumbnail stem),
    ``<prefix>stage<s>_conv2d<i>_*`` and ``<prefix>stage<s>_batchnorm<j>_*``
    numbered in creation order within a stage, ``<prefix>dense0_*``.
    Within a block the k-th BatchNorm normalises the k-th conv's output:
    a bottleneck creates conv1 (with bias), the fused 3x3 (its BN, its
    conv), the fused 1x1 (its BN, its conv with bias), the closing BN,
    then the downsample (conv, BN); a basic block has one fewer conv and
    BN in its body.  Every mode creates them in that order (a ``BNReLU``
    is named ``batchnorm``, a chain creates BN1, conv2, BN2, conv3).
    A V2 block creates bn1, conv1, then the BN and conv of each further
    unit (one in a basic block, two in a bottleneck), then the
    downsample conv (no BN, no conv bias anywhere); there the k-th
    BatchNorm normalises the k-th conv's input.
    Each name is placed by that position, whatever the prefix.  Raises
    MXNetError on a name it cannot place and on a shape that does not
    fit the structure (a BN whose length is not its conv's output
    channels, V2: input channels, a bias or Dense of the wrong
    length)."""
    dense = [n for n in named_arrays if n.endswith("dense0_weight")]
    if len(dense) != 1:
        raise MXNetError(f"expected one '<prefix>dense0_weight', found "
                         f"{dense}")
    prefix = dense[0][:-len("dense0_weight")]
    # scope (0 = top, s = stage s) -> kind -> index -> {param: array}
    scopes = {}
    for name, arr in named_arrays.items():
        m = _RESNET_RE.fullmatch(name[len(prefix):]) \
            if name.startswith(prefix) else None
        if m is None:
            raise MXNetError(f"cannot place JAX parameter {name!r}")
        stage, kind, idx, param = m.groups()
        group = scopes.setdefault(int(stage or 0), {}).setdefault(
            kind, {}).setdefault(int(idx), {})
        group[param] = np.array(arr, copy=True)
    top = scopes.pop(0)
    stages = sorted(scopes)
    if stages != list(range(1, len(stages) + 1)):
        raise MXNetError(f"stages must be numbered 1..n, got {stages}")
    out = {}
    v2 = len(top.get("batchnorm", {})) >= 2

    def put(key, arr, shape=None):
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise MXNetError(f"{key}: shape {tuple(arr.shape)} does not "
                             f"fit the structure, expected {tuple(shape)}")
        out[key] = torch.from_numpy(arr)

    def place_conv(key, params, allowed):
        if set(params) - allowed or "weight" not in params:
            raise MXNetError(f"{key}: unexpected conv parameters "
                             f"{sorted(params)}")
        w = params["weight"]
        if w.ndim != 4:
            raise MXNetError(f"{key}.weight must be 4-D, got {w.shape}")
        put(f"{key}.weight", w)
        if "bias" in params:
            put(f"{key}.bias", params["bias"], (w.shape[0],))
        return w.shape[0]

    def place_bn(key, params, channels):
        if sorted(params) != sorted(_BN_PARAMS):
            raise MXNetError(f"{key}: expected BatchNorm parameters "
                             f"{_BN_PARAMS}, got {sorted(params)}")
        for p in _BN_PARAMS:
            put(f"{key}.{p}", params[p], (channels,))

    def indexed(group, kind):
        got = group.get(kind, {})
        if sorted(got) != list(range(len(got))):
            raise MXNetError(f"{kind} indices must run 0..n-1, got "
                             f"{sorted(got)}")
        return [got[i] for i in range(len(got))]

    if v2:
        last = _v2_from_scopes(top, stages, scopes, indexed, place_conv,
                               place_bn)
    else:
        top_convs, top_bns = indexed(top, "conv2d"), indexed(top, "batchnorm")
        if len(top_convs) != 1 or len(top_bns) > 1 or \
                sorted(top.get("dense", {})) != [0]:
            raise MXNetError("expected the stem conv2d0, at most one stem "
                             "batchnorm0 and dense0 at the top level")
        ch = place_conv("features.0", top_convs[0], {"weight"})
        if top_bns:
            place_bn("features.1", top_bns[0], ch)
        base = 4 if top_bns else 1            # stem layers before stage 1
        for s in stages:
            convs = indexed(scopes[s], "conv2d")
            bns = indexed(scopes[s], "batchnorm")
            if not convs or len(convs) != len(bns):
                raise MXNetError(f"stage {s}: {len(convs)} convs and "
                                 f"{len(bns)} batchnorms do not pair up")
            bottleneck = convs[0]["weight"].shape[2:] == (1, 1)
            body, body_bn = _BOTTLENECK if bottleneck else _BASIC
            per = len(body)
            if len(convs) % per not in (0, 1):
                raise MXNetError(f"stage {s}: {len(convs)} convs do not make "
                                 f"whole blocks of {per}")
            has_ds = len(convs) % per == 1
            keys, bn_keys = [], []
            for blk in range(len(convs) // per):
                pre = f"features.{base + s - 1}.{blk}."
                keys += [pre + k for k in body]
                bn_keys += [pre + k for k in body_bn]
                if blk == 0 and has_ds:
                    keys.append(pre + _DOWNSAMPLE[0])
                    bn_keys.append(pre + _DOWNSAMPLE[1])
            for key, bn_key, conv, bn in zip(keys, bn_keys, convs, bns):
                allowed = {"weight", "bias"} if key.endswith(
                    ("body.0", "body.2.conv")) and bottleneck else {"weight"}
                place_bn(bn_key, bn, place_conv(key, conv, allowed))
        last = None
    dense = top["dense"][0]
    w = dense.get("weight")
    if set(dense) != {"weight", "bias"} or w.ndim != 2:
        raise MXNetError(f"dense0: expected a 2-D weight and a bias, got "
                         f"{sorted(dense)}")
    if last is not None and w.shape[1] != last:
        raise MXNetError(f"dense0: {w.shape[1]} inputs do not fit the "
                         f"closing BatchNorm's {last} channels")
    put("output.weight", w)
    put("output.bias", dense["bias"], (w.shape[0],))
    return out


def _v2_from_scopes(top, stages, scopes, indexed, place_conv, place_bn):
    """Place a JAX ResNet V2's arrays (``resnet_params_from_numpy``'s
    helpers); returns the closing BatchNorm's channels."""
    top_convs, top_bns = indexed(top, "conv2d"), indexed(top, "batchnorm")
    if len(top_convs) != 1 or len(top_bns) not in (2, 3) or \
            sorted(top.get("dense", {})) != [0]:
        raise MXNetError("expected the stem batchnorm0, conv2d0, one or no "
                         "stem batchnorm after it, the closing batchnorm "
                         "and dense0 at the top level")
    stem = top_convs[0]["weight"]
    place_bn("features.0", top_bns[0], stem.shape[1])
    ch = place_conv("features.1", top_convs[0], {"weight"})
    thumbnail = len(top_bns) == 2
    if not thumbnail:
        place_bn("features.2", top_bns[1], ch)
    base = 2 if thumbnail else 5          # stem layers before stage 1
    for s in stages:
        convs = indexed(scopes[s], "conv2d")
        bns = indexed(scopes[s], "batchnorm")
        if not convs or not bns:
            raise MXNetError(f"stage {s}: no convs or no batchnorms")
        bottleneck = convs[0]["weight"].shape[2:] == (1, 1)
        body, body_bn = _BOTTLENECK_V2 if bottleneck else _BASIC_V2
        per = len(body)
        blocks = len(bns) // per
        has_ds = len(convs) - per * blocks
        if len(bns) % per or has_ds not in (0, 1):
            raise MXNetError(f"stage {s}: {len(convs)} convs and "
                             f"{len(bns)} batchnorms do not make whole "
                             f"blocks of {per}")
        ci = bi = 0
        for blk in range(blocks):
            pre = f"features.{base + s - 1}.{blk}."
            for key, bn_key in zip(body, body_bn):
                conv, bn = convs[ci], bns[bi]
                ci, bi = ci + 1, bi + 1
                place_conv(pre + key, conv, {"weight"})
                place_bn(pre + bn_key, bn, conv["weight"].shape[1])
            if blk == 0 and has_ds:
                place_conv(pre + _DOWNSAMPLE_V2, convs[ci], {"weight"})
                ci += 1
        ch = convs[ci - 1]["weight"].shape[0]
    place_bn(f"features.{base + len(stages)}", top_bns[-1], ch)
    return ch


def resnet_param_names(keys, prefix="resnetv10_"):
    """``{jax_param_name: key}`` for the keys of the port's ResNet V1 or
    V2 ``state_dict`` (any mode): the JAX package's full name of each
    parameter and moving statistic under ``prefix``, the naming
    ``resnet_params_from_numpy`` reads.  Raises MXNetError on a key it
    does not place."""
    keys = set(keys)
    out, placed = {}, set()

    def take(key, name):
        out[prefix + name] = key
        placed.add(key)

    if "features.0.weight" not in keys and "features.0.gamma" in keys:
        _v2_names(keys, take)
        if placed != keys:
            raise MXNetError(f"cannot place the port's keys "
                             f"{sorted(keys - placed)}")
        return out
    take("features.0.weight", "conv2d0_weight")
    stem_bn = "features.1.gamma" in keys
    if stem_bn:
        for p in _BN_PARAMS:
            take(f"features.1.{p}", f"batchnorm0_{p}")
    base = 4 if stem_bn else 1
    stage = 1
    while f"features.{base + stage - 1}.0.body.0.weight" in keys:
        scope = f"features.{base + stage - 1}."
        body, body_bn = _BOTTLENECK if f"{scope}0.body.3.gamma" in keys \
            else _BASIC
        n_conv = n_bn = 0
        blk = 0
        while f"{scope}{blk}.body.0.weight" in keys:
            pre = f"{scope}{blk}."
            ds = f"{pre}{_DOWNSAMPLE[0]}.weight" in keys
            for key in body + (_DOWNSAMPLE[:1] if ds else ()):
                for p in ("weight", "bias"):
                    if f"{pre}{key}.{p}" in keys:
                        take(f"{pre}{key}.{p}",
                             f"stage{stage}_conv2d{n_conv}_{p}")
                n_conv += 1
            for key in body_bn + (_DOWNSAMPLE[1:] if ds else ()):
                for p in _BN_PARAMS:
                    take(f"{pre}{key}.{p}",
                         f"stage{stage}_batchnorm{n_bn}_{p}")
                n_bn += 1
            blk += 1
        stage += 1
    take("output.weight", "dense0_weight")
    take("output.bias", "dense0_bias")
    if placed != keys:
        raise MXNetError(f"cannot place the port's keys "
                         f"{sorted(keys - placed)}")
    return out


def _v2_names(keys, take):
    """``resnet_param_names`` of a port ResNet V2's keys."""
    for p in _BN_PARAMS:
        take(f"features.0.{p}", f"batchnorm0_{p}")
    take("features.1.weight", "conv2d0_weight")
    stem_bn = "features.2.gamma" in keys
    n_top_bn = 1
    if stem_bn:
        for p in _BN_PARAMS:
            take(f"features.2.{p}", f"batchnorm1_{p}")
        n_top_bn = 2
    base = 5 if stem_bn else 2
    stage = 1
    while f"features.{base + stage - 1}.0.conv1.weight" in keys:
        scope = f"features.{base + stage - 1}."
        body, body_bn = _BOTTLENECK_V2 \
            if f"{scope}0.fused3.conv.weight" in keys else _BASIC_V2
        n_conv = n_bn = 0
        blk = 0
        while f"{scope}{blk}.conv1.weight" in keys:
            pre = f"{scope}{blk}."
            for key, bn_key in zip(body, body_bn):
                for p in _BN_PARAMS:
                    take(f"{pre}{bn_key}.{p}",
                         f"stage{stage}_batchnorm{n_bn}_{p}")
                n_bn += 1
                take(f"{pre}{key}.weight",
                     f"stage{stage}_conv2d{n_conv}_weight")
                n_conv += 1
            if f"{pre}{_DOWNSAMPLE_V2}.weight" in keys:
                take(f"{pre}{_DOWNSAMPLE_V2}.weight",
                     f"stage{stage}_conv2d{n_conv}_weight")
                n_conv += 1
            blk += 1
        stage += 1
    for p in _BN_PARAMS:
        take(f"features.{base + stage - 1}.{p}", f"batchnorm{n_top_bn}_{p}")
    take("output.weight", "dense0_weight")
    take("output.bias", "dense0_bias")


def resnet_params_to_numpy(state_dict, prefix="resnetv10_"):
    """The port's ResNet V1 or V2 ``state_dict`` (any mode) ->
    ``{jax_param_name: np.ndarray}`` under ``prefix``
    (``resnet_param_names``): the inverse
    of ``resnet_params_from_numpy``, which maps the result back to the
    same tensors bit for bit.  The JAX package's ``set_data`` of each
    name loads it into a JAX net of the same structure."""
    return {name: state_dict[key].detach().cpu().numpy()
            for name, key in resnet_param_names(state_dict, prefix).items()}
