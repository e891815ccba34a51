"""Optimizers of the port (counterpart of ``incubator_mxnet_tpu/optimizer.py``
and the update ops of ``ops/optimizer_ops.py``): the ``Optimizer`` base
(``register``, ``create``, the per-index update counts that drive an
``lr_scheduler``, ``lr_mult`` / ``wd_mult`` through ``param_dict`` or
by name, ``Updater`` / ``get_updater`` with pickled states) and ``SGD``
with momentum, with fp32 master weights for bf16 / fp16 ones
(``multi_precision``).  The other optimizers of the JAX file are
ROADMAP A8.

``update(index, weight, grad, state)`` takes the weight, gradient and
state as NDArrays (``gluon.Trainer`` through its ``Updater``) or as
torch tensors (``parallel.TrainStep``) and updates them in place; an
NDArray that a live recorded graph has saved is rebound instead
(``NDArray._write``), as the JAX package rebinds every update.

The update order is the reference's ``sgd_mom_update`` exactly::

    g = clip(rescale_grad * grad)          (clip only when clip_gradient > 0)
    mom = momentum * mom - lr * (g + wd * w)
    w = w + mom

and without momentum ``w = w - lr * (g + wd * w)`` (``sgd_update``).  The
multi-precision forms (``mp_sgd_mom_update``, ``mp_sgd_update``) run the
same steps on the fp32 master ``w32`` with the fp32 gradient, then round
the weight from it.  The port updates the weight, the momentum and the
master in place.
"""
from __future__ import annotations

import pickle

import torch

from .base import registry

__all__ = ["Optimizer", "SGD", "Updater", "create", "get_updater",
           "mp_sgd_mom_update", "mp_sgd_update", "register",
           "sgd_mom_update", "sgd_update"]

_REG = registry("optimizer")

_HALF = (torch.float16, torch.bfloat16)


def _rescale(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """One SGD-with-momentum step of ``weight`` and ``mom``, in place."""
    g = _rescale(grad, rescale_grad, clip_gradient).to(weight.dtype)
    mom.copy_(momentum * mom - lr * (g + wd * weight))
    weight.add_(mom)


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """One plain SGD step of ``weight``, in place."""
    g = _rescale(grad, rescale_grad, clip_gradient).to(weight.dtype)
    weight.copy_(weight - lr * (g + wd * weight))


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=None):
    """One SGD-with-momentum step of the fp32 master ``weight32`` and
    ``mom`` from the fp32 gradient, then ``weight`` rounded from the
    master; all three in place."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight32))
    weight32.add_(mom)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None):
    """One plain SGD step of the fp32 master ``weight32`` from the fp32
    gradient, then ``weight`` rounded from it; both in place."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    weight32.copy_(weight32 - lr * (g + wd * weight32))
    weight.copy_(weight32)


def register(klass):
    """Register an optimizer class under its lowercased name (reference
    Optimizer.register)."""
    _REG.register(klass.__name__.lower(), klass)
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (or the instance itself)."""
    if isinstance(name, Optimizer):
        return name
    return _REG.get(name)(**kwargs)


_ND = []


def _nd_class():
    """The NDArray class (imported at first use: ``ndarray`` imports the
    op registry, which imports this module)."""
    if not _ND:
        from .ndarray.ndarray import NDArray
        _ND.append(NDArray)
    return _ND[0]


def _dtype(weight):
    t = getattr(weight, "_data", weight)
    return t.dtype


def _update_in_place(fn, arrays, *args, **kwargs):
    """Run the in-place update ``fn`` (one of the ``@torch.no_grad``
    functions above) over ``arrays``: tensors as they are, NDArrays by
    their tensors.  When a live recorded graph has saved the tensor of
    one of the NDArrays, ``fn`` runs on copies, which are then written
    back by ``NDArray._write`` (a rebind)."""
    nd = _nd_class()
    if not any(isinstance(a, nd) for a in arrays):
        fn(*arrays, *args, **kwargs)
        return
    from . import autograd
    saved = any(isinstance(a, nd) and autograd.is_saved(a._data)
                for a in arrays)
    tensors = []
    for a in arrays:
        if isinstance(a, nd):
            a = a._data.detach().clone() if saved else a._data
        tensors.append(a)
    fn(*tensors, *args, **kwargs)
    if saved:
        for a, t in zip(arrays, tensors):
            if isinstance(a, nd):
                a._write(t)


class Optimizer:
    """Base optimizer (reference optimizer.py:Optimizer): the learning
    rate (or an ``lr_scheduler`` over the update count, whose
    ``base_lr`` becomes ``learning_rate``), weight decay,
    ``rescale_grad``, ``clip_gradient``, and per-index ``lr_mult`` /
    ``wd_mult`` from ``param_dict`` (index -> an object with those
    attributes: a gluon Parameter, or a tensor that has them), else
    from ``set_lr_mult`` / ``set_wd_mult`` by index or by name
    (``param_idx2name``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(create)

    def __getstate__(self):
        # param_dict holds the live parameters: the owner sets it again
        # after loading (gluon.Trainer.load_states does)
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

    def create_state(self, index, weight):
        """Per-weight optimizer state (None: stateless)."""
        return None

    def _mixed(self, weight):
        return self.multi_precision and _dtype(weight) in _HALF

    def create_state_multi_precision(self, index, weight):
        """``(fp32 master copy, its state)`` for a bf16 / fp16 weight
        under ``multi_precision``, else ``create_state``."""
        if self._mixed(weight):
            w32 = _as_fp32(weight)
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if not self._mixed(weight):
            return self.update(index, weight, grad, state)
        w32, inner = state
        self.update(index, w32, _as_fp32(grad), inner)
        _update_in_place(torch.no_grad()(lambda w, m: w.copy_(m)),
                         [weight, w32])

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by index or name."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers by index or name; a named parameter
        that is not a weight or a gamma gets 0 (reference set_wd_mult)."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or
                                n.endswith("_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, table, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        return self.learning_rate * self._mult(index, self.lr_mult,
                                               "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    @property
    def learning_rate(self):
        """The current learning rate: the scheduler's at ``num_update``,
        else the base one."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def _common(self):
        return {"rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient}


def _as_fp32(x):
    """An fp32 copy of an NDArray or a tensor (detached)."""
    if isinstance(x, _nd_class()):
        return x.astype("float32")
    return x.detach().float()


@register
class SGD(Optimizer):
    """SGD with momentum (reference optimizer.py:434), over
    ``sgd_update`` / ``sgd_mom_update``; with ``multi_precision`` a bf16
    or fp16 weight keeps an fp32 master in its state, ``(momentum or
    None, master)`` as the JAX ``SGD`` keeps it, and is updated by
    ``mp_sgd_update`` / ``mp_sgd_mom_update``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        """The momentum buffer (zeros like the weight), or None."""
        if self.momentum == 0.0:
            return None
        if isinstance(weight, _nd_class()):
            from .ndarray.ndarray import zeros
            return zeros(weight.shape, ctx=weight.context,
                         dtype=weight.dtype)
        return torch.zeros_like(weight, requires_grad=False)

    def create_state_multi_precision(self, index, weight):
        if self._mixed(weight):
            w32 = _as_fp32(weight)
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _update_in_place(sgd_update, [weight, grad], lr, wd,
                             **self._common())
        else:
            _update_in_place(sgd_mom_update, [weight, grad, state], lr,
                             self.momentum, wd, **self._common())

    def update_multi_precision(self, index, weight, grad, state):
        if not self._mixed(weight):
            return self.update(index, weight, grad, state)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, w32 = state
        if mom is None:
            _update_in_place(mp_sgd_update, [weight, grad, w32], lr, wd,
                             **self._common())
        else:
            _update_in_place(mp_sgd_mom_update, [weight, grad, mom, w32],
                             lr, self.momentum, wd, **self._common())


class Updater:
    """Applies an optimizer to ``(index, grad, weight)`` with its states
    made at first use (reference optimizer.py:Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        """Load pickled states (and the optimizer, when they hold it)."""
        states = pickle.loads(states) if isinstance(states, bytes) \
            else states
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def get_updater(optimizer):
    return Updater(optimizer)
