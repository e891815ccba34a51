"""Device mesh of the port (counterpart of
``incubator_mxnet_tpu/parallel/mesh.py``).

The JAX mesh names the axes of a grid of devices in one process, and
GSPMD inserts the collectives.  The port runs one process per rank
(``parallel.dist.init_process_group``, or any ``torch.distributed``
world), and a mesh is ``torch.distributed.device_mesh.
init_device_mesh`` over the world's ranks with one ``mesh_dim_name``
per axis, so each axis has its own process group
(``DeviceMesh.group("dp")``).  Axis names and order are the JAX
package's: ``make_mesh`` keeps ``(pp, dp, sp, ep, tp)`` and drops the
size-1 axes.

* A mesh covers the world: a shape whose size is not the world size
  raises ``MXNetError`` (the JAX mesh must cover its devices).  A mesh
  of size 1 in a process with no process group is a local mesh: its
  groups are None and nothing is reduced.
* ``mesh.sharding("dp")`` is a ``Sharding``: the batch axis split over
  the ``dp`` group, with ``local(t)`` this rank's slice; ``mesh.
  replicated()`` is the unsplit one.  ``TrainStep(mesh=...)`` and
  ``DevicePrefetchIter(sharding=...)`` read them.
* ``with mesh:`` makes it the default that ``TrainStep``, ``EvalStep``
  and the ``"tpu"`` kvstore consult (``current_mesh()``).
* A parameter's ``sharding`` (``gluon.Parameter.sharding``, one axis
  name or None per dim) is a ``Sharding`` too: ``cut(t)`` is this
  rank's block of the global array (a dim the axis does not divide is
  cut into blocks of ``ceil(n / size)``, as GSPMD pads), ``gather(t,
  shape)`` joins the ranks' blocks back into the global array, and
  ``group(dim)`` is the process group a layer's collectives over that
  dim run on.  A spec naming an axis the mesh lacks replicates over it.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ops.collective import _gather_dim, block_range
from .dist import _initialized, world

__all__ = ["DeviceMesh", "Sharding", "current_mesh", "make_mesh",
           "replicated", "shard_spec", "DP", "TP", "PP", "SP", "EP"]

DP, TP, PP, SP, EP = "dp", "tp", "pp", "sp", "ep"

_state = threading.local()


class DeviceMesh:
    """A named mesh over the world's ranks: ``axes`` (names), ``shape``
    (sizes; default all ranks on the first axis).  ``devices`` is the
    list of ranks (default ``range(world)``) and must cover the world;
    this process's card is ``device`` (``resolve_device(None)``: the
    rank's card, or pass ``device="cpu"``)."""

    #: axis names layers may declare portably: a spec naming one the mesh
    #: lacks replicates over it; any other unknown name raises
    PORTABLE_AXES = frozenset({"dp", "tp", "pp", "sp", "ep"})

    def __init__(self, axes, devices=None, shape=None, device=None):
        if isinstance(axes, str):
            axes = (axes,)
        self.axis_names = tuple(axes)
        size = world()[0]
        ranks = list(range(size)) if devices is None else list(devices)
        n = len(ranks)
        if shape is None:
            shape = (n,) + (1,) * (len(self.axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.axis_names):
            raise MXNetError(f"mesh shape {shape} does not match its axes "
                             f"{self.axis_names}")
        if int(np.prod(shape)) != n:
            raise MXNetError(f"mesh shape {shape} does not cover {n} "
                             f"devices")
        if n != size or sorted(ranks) != list(range(size)):
            raise MXNetError(
                f"a mesh covers the world's ranks: {n} devices given, the "
                f"world has {size} process(es) (start one process per "
                "rank: tools/launch.py -n N, then parallel.dist."
                "init_process_group)")
        self.shape = dict(zip(self.axis_names, shape))
        self.device = resolve_device(device)
        self.torch_mesh = None
        if _initialized():
            from torch.distributed.device_mesh import init_device_mesh
            self.torch_mesh = init_device_mesh(
                self.device.type, shape, mesh_dim_names=self.axis_names)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    def axis_size(self, name):
        return self.shape.get(name, 1)

    def group(self, name):
        """The process group of axis ``name`` (None on a local mesh, or
        for an axis the mesh lacks)."""
        if self.torch_mesh is None or name not in self.axis_names:
            return None
        return self.torch_mesh.get_group(name)

    def axis_rank(self, name):
        """This rank's coordinate along axis ``name`` (0 for an axis the
        mesh lacks)."""
        if self.torch_mesh is None or name not in self.axis_names:
            return 0
        return self.torch_mesh.get_local_rank(name)

    def _axis(self, a, spec):
        if a in self.axis_names:
            return a
        if a in self.PORTABLE_AXES:
            return None     # portable declaration on a mesh without it
        raise MXNetError(f"unknown mesh axis {a!r} in sharding spec {spec} "
                         f"(mesh axes: {self.axis_names})")

    def sharding(self, *spec):
        """The ``Sharding`` of a PartitionSpec-style tuple: entry i names
        the axis (or tuple of axes) dim i is split over, None for an
        unsplit dim."""
        fixed = []
        for e in spec:
            if isinstance(e, (tuple, list)):
                kept = tuple(a for a in e if self._axis(a, spec) is not None)
                fixed.append(kept or None)
            else:
                fixed.append(None if e is None else self._axis(e, spec))
        return Sharding(self, tuple(fixed))

    def replicated(self):
        return Sharding(self, ())

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False

    def __repr__(self):
        return f"DeviceMesh({self.shape})"


class Sharding:
    """How an array lies on a mesh: ``spec`` entry i names the axes dim i
    is split over (None: unsplit).  Each rank holds the block of its
    coordinates; ``local(t)`` cuts it out of the global tensor ``t``.
    With ``microbatches`` k > 1 dim 0 is first cut into k microbatches
    and each of those split over the ranks: a rank's block is its slice
    of microbatch 0, then of microbatch 1, ..., so that the j-th of k
    chunks of it is its slice of the global batch's j-th microbatch
    (``TrainStep(grad_accum=k)``)."""

    __slots__ = ("mesh", "spec", "microbatches")

    def __init__(self, mesh, spec, microbatches=1):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.microbatches = int(microbatches)
        while self.spec and self.spec[-1] is None:
            self.spec = self.spec[:-1]

    @property
    def device(self):
        return self.mesh.device

    def microbatched(self, k):
        """This sharding with dim 0 cut into ``k`` microbatches first."""
        return Sharding(self.mesh, self.spec, k)

    def parts(self, dim):
        """How many blocks dim ``dim`` is cut into, and this rank's
        index among them."""
        axes = self.spec[dim] if dim < len(self.spec) else None
        if axes is None:
            return 1, 0
        axes = (axes,) if isinstance(axes, str) else axes
        count, index = 1, 0
        for a in axes:
            size = self.mesh.axis_size(a)
            index = index * size + self.mesh.axis_rank(a)
            count *= size
        return count, index

    def local(self, t):
        """This rank's block of the global ``t``; a dim that the split
        does not divide raises."""
        for dim in range(min(len(self.spec), t.dim())):
            count, index = self.parts(dim)
            if count == 1:
                continue
            size = t.shape[dim]
            k = self.microbatches if dim == 0 else 1
            if size % (count * k):
                raise MXNetError(
                    f"dim {dim} of size {size} does not split over "
                    f"{count} ranks ({self.spec[dim]})" +
                    (f" in {k} microbatches" if k > 1 else ""))
            step = size // (count * k)
            if k == 1:
                t = t.narrow(dim, index * step, step)
            else:
                rest = tuple(t.shape[1:])
                t = t.reshape((k, count, step) + rest).select(1, index) \
                    .reshape((k * step,) + rest)
        return t

    # -- a parameter's layout ------------------------------------------
    def _axis_of(self, dim):
        """The one axis dim ``dim`` is split over, or None (a dim split
        over several axes raises: no layer of the port declares one)."""
        axes = self.spec[dim] if dim < len(self.spec) else None
        if isinstance(axes, (tuple, list)):
            if len(axes) > 1:
                raise MXNetError(f"a parameter dim split over several axes "
                                 f"{axes} is not supported")
            axes = axes[0] if axes else None
        if axes is None or self.mesh.axis_size(axes) == 1:
            return None
        return axes

    @property
    def is_split(self):
        """Whether any dim is split over an axis larger than 1."""
        return any(self._axis_of(d) is not None
                   for d in range(len(self.spec)))

    def group(self, dim):
        """The process group dim ``dim`` is split over (None: unsplit)."""
        axis = self._axis_of(dim)
        return None if axis is None else self.mesh.group(axis)

    def cut(self, t):
        """This rank's block of the global parameter ``t`` (blocks of
        ``ceil(n / size)`` along each split dim)."""
        for dim in range(min(len(self.spec), t.dim())):
            axis = self._axis_of(dim)
            if axis is None:
                continue
            start, stop = block_range(t.shape[dim], self.mesh.axis_size(
                axis), self.mesh.axis_rank(axis))
            t = t.narrow(dim, start, stop - start)
        return t

    def gather(self, t, shape):
        """The global array of ``shape`` from each rank's block ``t``
        (the inverse of ``cut``; a collective every rank of the split
        axes must call)."""
        with torch.no_grad():
            for dim in range(min(len(self.spec), t.dim())):
                if self._axis_of(dim) is not None:
                    t = _gather_dim(t, self.group(dim), dim, shape[dim])
        return t

    def __eq__(self, other):
        return isinstance(other, Sharding) and other.mesh is self.mesh \
            and other.spec == self.spec \
            and other.microbatches == self.microbatches

    def __hash__(self):
        return hash((id(self.mesh), self.spec, self.microbatches))

    def __repr__(self):
        k = f", microbatches={self.microbatches}" \
            if self.microbatches > 1 else ""
        return f"Sharding({self.mesh!r}, {self.spec}{k})"


def current_mesh():
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def mesh_layout(dp=1, tp=1, pp=1, sp=1, ep=1):
    """``(axis names, shape)`` of ``make_mesh``: the order (pp, dp, sp,
    ep, tp), size-1 axes dropped (a lone ``dp`` of 1 when all are)."""
    sizes = [("pp", pp), ("dp", dp), ("sp", sp), ("ep", ep), ("tp", tp)]
    kept = [(n, s) for n, s in sizes if s != 1] or [("dp", 1)]
    return tuple(n for n, _ in kept), tuple(s for _, s in kept)


def make_mesh(dp=1, tp=1, pp=1, sp=1, ep=1, devices=None, device=None):
    """A mesh with the standard axes, size-1 axes dropped (JAX
    ``make_mesh``): ``make_mesh(dp=2)`` is a 1-axis data-parallel mesh
    over a world of 2, ``make_mesh(dp=2, tp=4)`` a 2x4 one over 8."""
    names, shape = mesh_layout(dp, tp, pp, sp, ep)
    return DeviceMesh(names, devices=devices, shape=shape, device=device)


def replicated(mesh=None):
    mesh = mesh or current_mesh()
    return mesh.replicated()


def shard_spec(mesh, *spec):
    return mesh.sharding(*spec)
