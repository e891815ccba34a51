"""Epoch checkpoints of a training step (counterpart of
``incubator_mxnet_tpu/parallel/checkpoint.py``, which writes the JAX
step's carry through orbax).

``TrainCheckpoint(directory, max_to_keep, async_save)`` keeps one
directory per epoch, ``<directory>/<epoch>/``, holding ``state.pt``
(``torch.save`` of the tree) and ``metadata.json`` (written last; the
user's JSON ``extra`` rides in it).  Rank 0 writes into a temporary
directory beside it and renames that into place, so an epoch directory
is whole or absent; in a process group every rank waits for the write
(a barrier) and every rank reads.  A ``TrainStep``'s state is its
parameters, its buffers (the moving statistics), its optimizer states
and loss-scaler state, and the step's own ``extra``: the optimizer's
update counts and the random generators' states, so a restored step
continues bit for bit.  The format is the port's own: it does not read
orbax checkpoints.

A corrupt or partial epoch raises ``MXNetError`` naming the epoch and
its path; ``latest_epoch()`` skips epochs that fail the structural check
(metadata parses, state present).  With ``async_save`` the state is
copied to host memory at ``save`` and written by a thread; ``wait()``
blocks until it is on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import torch

from ..base import MXNetError
from .dist import barrier, world

__all__ = ["TrainCheckpoint"]

_STATE, _META = "state.pt", "metadata.json"


def _to_host(tree):
    """A copy of ``tree`` with every tensor on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _copy_into(dst, src):
    """Write the saved tree ``src`` into the live tensors of ``dst``."""
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(src)
        return
    if isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _states(step):
    return [list(s) if isinstance(s, tuple) else s for s in step._states]


class TrainCheckpoint:
    """Epoch-numbered checkpoints of a ``parallel.TrainStep``'s state."""

    def __init__(self, directory, max_to_keep=None, async_save=False):
        self._dir = os.path.abspath(str(directory))
        if world()[1] == 0:
            os.makedirs(self._dir, exist_ok=True)
        barrier()
        self._max = max_to_keep
        self._async = bool(async_save)
        self._pending = None

    def _epoch_path(self, epoch):
        return os.path.join(self._dir, str(int(epoch)))

    def _corrupt(self, epoch, exc, what="restore"):
        return MXNetError(
            f"checkpoint epoch {int(epoch)} at {self._epoch_path(epoch)!r} "
            f"is corrupt or unreadable ({what} failed with "
            f"{type(exc).__name__}: {exc}): a partial write or damaged "
            "files; restore an earlier epoch, or delete the epoch "
            "directory by hand")

    # -- save -------------------------------------------------------------
    def save(self, step, epoch, extra=None):
        """Write ``step``'s state at ``epoch`` (``extra``: a JSON-able
        value kept beside it, read back by ``restore_extra``)."""
        opt = step._optimizer
        gens = {"cpu": torch.random.get_rng_state()}
        if step.device.type == "cuda":
            gens["cuda"] = torch.cuda.get_rng_state(step.device)
        tree = {"params": list(step._params),
                "buffers": dict(step._block.named_buffers()),
                "opt_states": _states(step),
                "scaler": step._scaler_state,
                "step_extra": {
                    "num_update": opt.num_update,
                    "index_update_count": dict(opt._index_update_count),
                    "rng": gens}}
        self.save_tree(epoch, tree, extra=extra)

    def save_carry(self, epoch, carry, extra=None):
        """Write an explicit ``(params, opt_states)`` pair."""
        params, states = carry
        self.save_tree(epoch, {"params": list(params),
                               "opt_states": list(states)}, extra=extra)

    def save_tree(self, epoch, tree, extra=None):
        """Write a tree (dicts, lists, tensors, numbers) at ``epoch``."""
        self.wait()
        if world()[1] == 0:
            host = _to_host(tree)
            if self._async:
                self._pending = threading.Thread(
                    target=self._write, args=(int(epoch), host, extra),
                    name="checkpoint-save", daemon=True)
                self._pending.start()
            else:
                self._write(int(epoch), host, extra)
        if not self._async:
            barrier()

    def _write(self, epoch, tree, extra):
        final = self._epoch_path(epoch)
        tmp = os.path.join(self._dir, f".tmp-{epoch}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"epoch": epoch, "extra": extra}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self._max is not None:
            for old in self.all_epochs()[:-int(self._max)]:
                shutil.rmtree(self._epoch_path(old), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def _load(self, epoch):
        try:
            return torch.load(os.path.join(self._epoch_path(epoch), _STATE),
                              map_location="cpu", weights_only=False)
        except Exception as e:
            raise self._corrupt(epoch, e) from e

    def restore(self, step, epoch=None):
        """Restore ``epoch`` (default: the latest valid one) into
        ``step``; returns the epoch, or -1 when the directory holds
        none.  A corrupt epoch raises ``MXNetError``."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None or epoch < 0:
            return -1
        tree = self._load(epoch)
        try:
            _copy_into(list(step._params), tree["params"])
            buffers = dict(step._block.named_buffers())
            if buffers.keys() != tree["buffers"].keys():
                raise MXNetError("the step's buffers are not the saved ones")
            for name, buf in buffers.items():
                _copy_into(buf, tree["buffers"][name])
            _copy_into(_states(step), tree["opt_states"])
            if tree["scaler"] is not None:
                _copy_into(step._scaler_state, tree["scaler"])
            extra = tree["step_extra"]
        except (KeyError, RuntimeError, TypeError, ValueError) as e:
            raise self._corrupt(epoch, e) from e
        opt = step._optimizer
        opt.num_update = extra["num_update"]
        opt._index_update_count = dict(extra["index_update_count"])
        torch.random.set_rng_state(extra["rng"]["cpu"])
        if "cuda" in extra["rng"] and step.device.type == "cuda":
            torch.cuda.set_rng_state(extra["rng"]["cuda"], step.device)
        return int(epoch)

    def restore_tree(self, epoch=None):
        """The tree ``save_tree`` wrote at ``epoch`` (tensors on the
        host), or None when the directory holds none."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None or epoch < 0:
            return None
        return self._load(epoch)

    def restore_extra(self, epoch=None):
        """The ``extra`` saved at ``epoch`` (None when absent)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None or epoch < 0:
            return None
        try:
            with open(os.path.join(self._epoch_path(epoch), _META)) as f:
                return json.load(f).get("extra")
        except (OSError, ValueError):
            return None

    # -- bookkeeping ------------------------------------------------------
    def _looks_valid(self, epoch):
        """The structural check: the metadata parses (written last) and
        the state file is there and not empty."""
        path = self._epoch_path(epoch)
        try:
            with open(os.path.join(path, _META)) as f:
                json.load(f)
            return os.path.getsize(os.path.join(path, _STATE)) > 0
        except (OSError, ValueError):
            return False

    def latest_epoch(self, validate=True):
        """The newest epoch on disk (with ``validate``, the newest that
        passes the structural check); -1 when none."""
        epochs = self.all_epochs()
        if validate:
            epochs = [e for e in epochs if self._looks_valid(e)]
        return epochs[-1] if epochs else -1

    def valid_epochs(self):
        """Epochs passing the structural check, oldest first."""
        return [e for e in self.all_epochs() if self._looks_valid(e)]

    def all_epochs(self):
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def wait(self):
        """Block until an asynchronous write is on disk (every rank
        returns after it)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._async:
            barrier()

    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
