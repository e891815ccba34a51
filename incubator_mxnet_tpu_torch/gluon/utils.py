"""Gluon utilities of the port (counterpart of
``incubator_mxnet_tpu/gluon/utils.py``; reference
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1``.  ``download`` fetches nothing:
it returns a file that is already in place (and matches ``sha1_hash``)
and raises ``MXNetError`` otherwise."""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np

from .. import ndarray as nd_mod
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` into ``num_slice`` pieces,
    the last taking the remainder without ``even_split`` (reference
    utils.py:split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into"
            f" {num_slice} slices along axis {batch_axis}. Use a batch size"
            f" that's a multiple of {num_slice} or set even_split=False.")
    step = size // num_slice
    return [nd_mod.slice_axis(data, axis=batch_axis, begin=i * step,
                              end=size if i == num_slice - 1 and
                              not even_split else (i + 1) * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` and place one piece on each context (reference
    utils.py:split_and_load)."""
    if not isinstance(data, NDArray):
        data = nd_mod.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (reference
    utils.py:clip_global_norm)."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    total_norm = float(np.sqrt(sum(float((a * a).sum().asscalar())
                                   for a in arrays)))
    if check_isfinite and not np.isfinite(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1048576), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The local file for ``url`` when it is already in place (reference
    utils.py:download); the port fetches nothing, so anything else
    raises ``MXNetError``."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(f"download of {url} requested: the port fetches "
                     f"nothing; place the file at {fname}")
