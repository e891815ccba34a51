"""Optimizers of the port (counterpart of ``incubator_mxnet_tpu/optimizer.py``
and the update ops of ``ops/optimizer_ops.py``): the ``Optimizer`` base
(``register``, ``create``, the per-index update counts that drive an
``lr_scheduler``, ``lr_mult`` / ``wd_mult`` through ``param_dict`` or
by name, ``Updater`` / ``get_updater`` with pickled states) and the
JAX file's 15 optimizers, registered by their lowercased names (and
``ccsgd`` for ``SGD``): ``SGD`` with momentum and fp32 master weights
for bf16 / fp16 ones (``multi_precision``, which the base class offers
every optimizer), ``Signum``, ``NAG``, ``SGLD``, ``DCASGD``, ``Adam``,
``AdaGrad``, ``RMSProp``, ``Ftrl``, ``Adamax``, ``Nadam``, ``LBSGD``,
``Test``, ``AdaDelta`` and ``FTML``.

``update(index, weight, grad, state)`` takes the weight, gradient and
state as NDArrays (``gluon.Trainer`` and ``Module`` through their
``Updater``) or as torch tensors (``parallel.TrainStep``) and updates
them in place; an NDArray that a live recorded graph has saved is
rebound instead (``NDArray._write``), as the JAX package rebinds every
update.  A ``row_sparse`` gradient (``ndarray.sparse.RowSparseNDArray``)
takes the lazy update of ``SGD`` (with or without momentum), ``Adam``
and ``AdaGrad`` (JAX ``optimizer.py:31-47``, ``:239-252``, ``:406-418``,
``:439-447``; reference SGDUpdateRspImpl and friends): only the
gradient's stored rows touch the weight and its states, so the other
rows, their momentum and their Adam moments stay exactly as they were
(no weight decay, no decay of the moments); Adam's bias correction
still uses the index's update count.  Any other sparse gradient, or a
row_sparse one for another optimizer or a multi-precision weight,
raises ``MXNetError``.

The arithmetic of each update op is written once, here, as an in-place
function of the op's name (``sgd_mom_update``, ``adam_update`` ...) in
the JAX op's order of operations; ``ops/optimizer_ops`` registers the
ops over copies of the inputs.  ``sgd_mom_update`` for instance is::

    g = clip(rescale_grad * grad)          (clip only when clip_gradient > 0)
    mom = momentum * mom - lr * (g + wd * w)
    w = w + mom

The multi-precision forms (``mp_sgd_mom_update``, ``mp_sgd_update``) run
the same steps on the fp32 master ``w32`` with the fp32 gradient, then
round the weight from it.  ``NAG``, ``SGLD``, ``DCASGD``, ``Adamax``,
``Nadam`` and ``Test`` have no op in the JAX package either: their
arithmetic is the JAX class's NDArray arithmetic on tensors.  SGLD's
noise comes from the port's generator of the weight's device, so its
bits differ from the JAX package's.
"""
from __future__ import annotations

import math
import pickle

import torch

from .base import MXNetError, registry

__all__ = ["AdaDelta", "AdaGrad", "Adam", "Adamax", "DCASGD", "FTML", "Ftrl",
           "LBSGD", "NAG", "Nadam", "Optimizer", "RMSProp", "SGD", "SGLD",
           "Signum", "Test", "Updater", "adadelta_update", "adagrad_update",
           "adam_update", "create", "ftml_update", "ftrl_update",
           "get_updater", "mp_sgd_mom_update", "mp_sgd_update", "register",
           "rmsprop_update", "rmspropalex_update", "sgd_mom_update",
           "sgd_update", "signsgd_update", "signum_update"]

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


def _grad(grad, weight, rescale_grad, clip_gradient):
    """The rescaled, clipped gradient in the weight's dtype."""
    return _rescale(grad, rescale_grad, clip_gradient).to(weight.dtype)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """One Adam step of ``weight``, ``mean`` and ``var`` (the caller
    folds the bias correction into ``lr``)."""
    g = _grad(grad, weight, rescale_grad, clip_gradient) + wd * weight
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * g.square())
    weight.copy_(weight - lr * mean / (var.sqrt() + epsilon))


def _clip_weights(weight, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None, clip_weights=None):
    """One RMSProp step (Tieleman & Hinton) of ``weight`` and ``n``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient) + wd * weight
    n.copy_(gamma1 * n + (1 - gamma1) * g.square())
    weight.copy_(weight - lr * g / (n + epsilon).sqrt())
    _clip_weights(weight, clip_weights)


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_state, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=None, clip_weights=None):
    """One centred RMSProp step (Graves) of ``weight``, ``n``, ``g_state``
    and ``delta``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient) + wd * weight
    n.copy_(gamma1 * n + (1 - gamma1) * g.square())
    g_state.copy_(gamma1 * g_state + (1 - gamma1) * g)
    delta.copy_(gamma2 * delta - lr * g / (n - g_state.square()
                                           + epsilon).sqrt())
    weight.add_(delta)
    _clip_weights(weight, clip_weights)


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=None):
    """One FTRL-proximal step of ``weight``, ``z`` and ``n``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient)
    new_n = n + g.square()
    sigma = (new_n.sqrt() - n.sqrt()) / lr
    z.copy_(z + g - sigma * weight)
    n.copy_(new_n)
    w = -(z - z.sign() * lamda1) / ((beta + new_n.sqrt()) / lr + wd)
    weight.copy_(torch.where(z.abs() > lamda1, w, torch.zeros_like(w)))


@torch.no_grad()
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """One signSGD step of ``weight``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient)
    weight.copy_(weight - lr * (g.sign() + wd * weight))


@torch.no_grad()
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=None, wd_lh=0.0):
    """One Signum step of ``weight`` and ``mom``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1 - momentum) * (g + wd * weight))
    weight.copy_((1 - lr * wd_lh) * weight + lr * mom.sign())


@torch.no_grad()
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """One AdaGrad step of ``weight`` and ``history``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient)
    history.copy_(history + g.square())
    weight.copy_(weight - lr * (g / (history + epsilon).sqrt()
                                + wd * weight))


@torch.no_grad()
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """One AdaDelta step of ``weight``, ``acc_g`` and ``acc_delta``."""
    g = _grad(grad, weight, rescale_grad, clip_gradient)
    acc_g.copy_(rho * acc_g + (1 - rho) * g.square())
    delta = (acc_delta + epsilon).sqrt() / (acc_g + epsilon).sqrt() * g
    acc_delta.copy_(rho * acc_delta + (1 - rho) * delta.square())
    weight.copy_(weight - delta - wd * weight)


@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=None):
    """One FTML step (Follow the Moving Leader) of ``weight``, ``d``,
    ``v`` and ``z`` at update count ``t``.  As in the reference, ``wd``
    goes inside the clipped gradient and the clip is named
    ``clip_grad`` (clipping at any value >= 0)."""
    g = grad.float() * rescale_grad + wd * weight
    if clip_grad is not None and clip_grad >= 0:
        g = g.clamp(-clip_grad, clip_grad)
    g = g.to(weight.dtype)
    tf = torch.as_tensor(t, dtype=torch.float32, device=weight.device)
    v.copy_(beta2 * v + (1.0 - beta2) * g * g)
    d_t = (1.0 - beta1 ** tf) / lr * ((v / (1.0 - beta2 ** tf)).sqrt()
                                      + epsilon)
    sigma = d_t - beta1 * d
    z.copy_(beta1 * z + (1.0 - beta1) * g - sigma * weight)
    d.copy_(d_t)
    weight.copy_(-z / d_t)


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
    #: the skipped updates a ``TrainStep``'s loss scaler counted on the
    #: device that the host has not rewound yet (None: no scaler)
    _unrewound = None

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

    def rewind_updates(self, n=1):
        """Roll the update counters back by ``n`` skipped updates (JAX
        ``Optimizer.rewind_updates``): a loss scaler's overflowed step
        applies no update, so lr schedules and the bias corrections count
        only applied ones.  ``num_update`` never goes below
        ``begin_num_update``; each index's own count (which the port's
        per-index updates advance) goes back by ``n`` too."""
        n = int(n)
        self.num_update = max(self.begin_num_update, self.num_update - n)
        for i, c in self._index_update_count.items():
            self._index_update_count[i] = max(self.begin_num_update, c - n)

    def _bias_count(self, index):
        """The update count of ``index`` for a bias correction: the host
        count less the skipped updates not rewound yet, a device tensor
        under a ``TrainStep``'s loss scaler (so no host sync), else an
        int."""
        t = self._index_update_count[index]
        return t if self._unrewound is None else t - self._unrewound

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


def _sqrt(x):
    """sqrt of a Python number or of a (device) tensor, without a host
    read of the tensor."""
    return x.sqrt() if isinstance(x, torch.Tensor) else math.sqrt(x)


def _as_fp32(x):
    """An fp32 copy of an NDArray or a tensor (detached)."""
    if isinstance(x, _nd_class()):
        return x.astype("float32")
    return x.detach().float()


def _zeros(weight):
    """Zeros like ``weight`` (an NDArray or a tensor), of its kind."""
    if isinstance(weight, _nd_class()):
        from .ndarray.ndarray import zeros
        return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)
    return torch.zeros_like(weight, requires_grad=False)


def _copy(weight):
    if isinstance(weight, _nd_class()):
        return weight.copy()
    return weight.detach().clone()


def _dense(grad):
    """Raise on a sparse gradient where no lazy update exists."""
    stype = getattr(grad, "stype", "default")
    if stype != "default":
        raise MXNetError(f"optimizer: a {stype} gradient has a lazy update "
                         "only in SGD, Adam and AdaGrad (on a weight that "
                         "is not multi-precision)")


def _lazy_update(grad):
    """True for a row_sparse gradient, which takes the lazy update; False
    for a dense one; another sparse kind raises."""
    if getattr(grad, "stype", "default") == "row_sparse":
        return True
    _dense(grad)
    return False


def _lazy(fn, weight, grad, states, *args, rescale_grad=1.0,
          clip_gradient=None):
    """Run the lazy row update ``fn(weight, *states, idx, g, rows,
    *args)`` over the stored rows of the row_sparse ``grad``: ``idx``
    its row ids, ``g`` its rescaled, clipped rows in the weight's dtype
    and ``rows`` the weight's rows there (JAX ``_sparse_rows``)."""
    wt = getattr(weight, "_data", weight)
    idx = grad._indices.to(wt.device)
    g = _rescale(grad._data.to(wt.device), rescale_grad,
                 clip_gradient).to(wt.dtype)

    @torch.no_grad()
    def run(w, *st):
        fn(w, *st, idx, g, w[idx], *args)

    _update_in_place(run, [weight, *states])


def _lazy_sgd(weight, idx, g, rows, lr, wd):
    weight.index_put_((idx,), -lr * (g + wd * rows), accumulate=True)


def _lazy_sgd_mom(weight, mom, idx, g, rows, lr, momentum, wd):
    new_m = momentum * mom[idx] - lr * (g + wd * rows)
    weight.index_put_((idx,), new_m, accumulate=True)
    mom[idx] = new_m


def _lazy_adam(weight, mean, var, idx, g, rows, lr, beta1, beta2,
               epsilon, wd):
    g = g + wd * rows
    m_r = beta1 * mean[idx] + (1 - beta1) * g
    v_r = beta2 * var[idx] + (1 - beta2) * g.square()
    weight[idx] = rows - lr * m_r / (v_r.sqrt() + epsilon)
    mean[idx] = m_r
    var[idx] = v_r


def _lazy_adagrad(weight, history, idx, g, rows, lr, epsilon, wd):
    g = g + wd * rows
    h_r = history[idx] + g.square()
    weight.index_put_((idx,), -lr * g / (h_r.sqrt() + epsilon),
                      accumulate=True)
    history[idx] = h_r


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
        return _zeros(weight)

    def create_state_multi_precision(self, index, weight):
        if self._mixed(weight):
            w32 = _as_fp32(weight)
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        sparse = _lazy_update(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if sparse:
            if state is None:
                _lazy(_lazy_sgd, weight, grad, [], lr, wd,
                      **self._common())
            else:
                _lazy(_lazy_sgd_mom, weight, grad, [state], lr,
                      self.momentum, wd, **self._common())
            return
        if state is None:
            _update_in_place(sgd_update, [weight, grad], lr, wd,
                             **self._common())
        else:
            _update_in_place(sgd_mom_update, [weight, grad, state], lr,
                             self.momentum, wd, **self._common())

    def update_multi_precision(self, index, weight, grad, state):
        if not self._mixed(weight):
            return self.update(index, weight, grad, state)
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, w32 = state
        if mom is None:
            _update_in_place(mp_sgd_update, [weight, grad, w32], lr, wd,
                             **self._common())
        else:
            _update_in_place(mp_sgd_mom_update, [weight, grad, mom, w32],
                             lr, self.momentum, wd, **self._common())


@register
class Signum(Optimizer):
    """Sign-momentum SGD (reference optimizer.py:Signum), over
    ``signum_update``, or ``signsgd_update`` without momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _update_in_place(signsgd_update, [weight, grad], lr, wd,
                             **self._common())
        else:
            _update_in_place(signum_update, [weight, grad, state], lr,
                             self.momentum, wd, wd_lh=self.wd_lh,
                             **self._common())


def _scaled(grad, rescale_grad, clip_gradient):
    """``grad * rescale_grad``, clipped when ``clip_gradient`` is set (at
    any value, as the JAX classes without an update op clip)."""
    g = grad * rescale_grad
    if clip_gradient is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def _nag_update(weight, grad, mom, lr, momentum, wd, rescale_grad,
                clip_gradient):
    g = _scaled(grad, rescale_grad, clip_gradient)
    if mom is None:
        weight.add_(-lr * (g + wd * weight))
        return
    mom.mul_(momentum)
    g = g + wd * weight
    mom.add_(g)
    g = g + momentum * mom
    weight.add_(-lr * g)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference optimizer.py:NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        _update_in_place(_nag_update, [weight, grad, state], lr,
                         self.momentum, wd, self.rescale_grad,
                         self.clip_gradient)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference
    optimizer.py:SGLD): half an SGD step plus N(0, lr) noise drawn from
    the port's generator of the weight's device."""

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        rescale, clip = self.rescale_grad, self.clip_gradient

        @torch.no_grad()
        def step(w, g):
            from . import random as _random
            g = _scaled(g, rescale, clip)
            noise = torch.normal(0.0, math.sqrt(lr), w.shape,
                                 generator=_random.generator(w.device),
                                 device=w.device, dtype=w.dtype)
            w.add_(-lr / 2 * (g + wd * w) + noise)
        _update_in_place(step, [weight, grad])


@torch.no_grad()
def _dcasgd_update(weight, grad, mom, previous, lr, momentum, lamda, wd,
                   rescale_grad, clip_gradient):
    g = _scaled(grad, rescale_grad, clip_gradient)
    delta = -lr * (g + wd * weight + lamda * g * g * (weight - previous))
    if mom is not None:
        mom.mul_(momentum)
        mom.add_(delta)
        delta = mom
    previous.copy_(weight)
    weight.add_(delta)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference
    optimizer.py:DCASGD); its state is (momentum or None, the previous
    weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros(weight)
        return (mom, _copy(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, previous = state
        _update_in_place(_dcasgd_update, [weight, grad, mom, previous], lr,
                         self.momentum, self.lamda, wd, self.rescale_grad,
                         self.clip_gradient)


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py:984), over ``adam_update`` with the
    bias correction folded into the learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        sparse = _lazy_update(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._bias_count(index)
        lr *= _sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        if sparse:
            _lazy(_lazy_adam, weight, grad, [mean, var], lr, self.beta1,
                  self.beta2, self.epsilon, wd, **self._common())
            return
        _update_in_place(adam_update, [weight, grad, mean, var], lr,
                         self.beta1, self.beta2, self.epsilon, wd,
                         **self._common())


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py:AdaGrad), over ``adagrad_update``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        sparse = _lazy_update(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if sparse:
            _lazy(_lazy_adagrad, weight, grad, [state], lr,
                  self.float_stable_eps, wd, **self._common())
            return
        _update_in_place(adagrad_update, [weight, grad, state], lr,
                         self.float_stable_eps, wd, **self._common())


@register
class RMSProp(Optimizer):
    """RMSProp, plain (Tieleman & Hinton, ``rmsprop_update``) or centred
    (Graves, ``rmspropalex_update``) (reference optimizer.py:RMSProp)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(self._common(), clip_weights=self.clip_weights)
        if not self.centered:
            _update_in_place(rmsprop_update, [weight, grad, *state], lr,
                             self.gamma1, self.epsilon, wd, **kw)
        else:
            _update_in_place(rmspropalex_update, [weight, grad, *state], lr,
                             self.gamma1, self.gamma2, self.epsilon, wd,
                             **kw)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference optimizer.py:Ftrl), over ``ftrl_update``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        _update_in_place(ftrl_update, [weight, grad, z, n], lr, self.lamda1,
                         self.beta, wd, **self._common())


@torch.no_grad()
def _adamax_update(weight, grad, m, u, lr, beta1, beta2, wd, rescale_grad,
                   clip_gradient):
    g = grad * rescale_grad + wd * weight
    if clip_gradient is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    u.copy_(torch.maximum(beta2 * u, g.abs()))
    weight.add_(-lr * m / (u + 1e-8))


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm (reference
    optimizer.py:Adamax)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._bias_count(index)
        lr /= (1.0 - self.beta1 ** t)
        m, u = state
        _update_in_place(_adamax_update, [weight, grad, m, u], lr,
                         self.beta1, self.beta2, wd, self.rescale_grad,
                         self.clip_gradient)


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference optimizer.py:Nadam); its momentum
    schedule's product ``m_schedule`` is one for all weights, as in the
    reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        beta1, beta2 = self.beta1, self.beta2
        momentum_t = beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                     * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule, m_schedule_next = self.m_schedule,             self.m_schedule * momentum_t_1
        rescale, clip, eps = self.rescale_grad, self.clip_gradient,             self.epsilon

        @torch.no_grad()
        def step(w, grad, m, v):
            g = grad * rescale + wd * w
            if clip is not None:
                g = g.clamp(-clip, clip)
            m.copy_(beta1 * m + (1.0 - beta1) * g)
            v.copy_(beta2 * v + (1.0 - beta2) * g * g)
            g_prime = g / (1.0 - m_schedule)
            m_prime = m / (1.0 - m_schedule_next)
            v_prime = v / (1.0 - beta2 ** t)
            m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
            w.add_(-lr * m_bar / (v_prime ** 0.5 + eps))
        _update_in_place(step, [weight, grad, *state])


@register
class LBSGD(Optimizer):
    """Large-batch SGD with a warm-up multiplier of the learning rate
    (reference optimizer.py:650), over ``sgd_update`` /
    ``sgd_mom_update``."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        self.lbmult = self._get_lbmult(self.num_update + self.init_updates)
        lr = lr * self.lbmult
        if state is None:
            _update_in_place(sgd_update, [weight, grad], lr, wd,
                             **self._common())
        else:
            _update_in_place(sgd_mom_update, [weight, grad, state], lr,
                             self.momentum, wd, **self._common())


@register
class Test(Optimizer):
    """``weight += rescale_grad * grad``, the state a copy of the new
    weight (reference optimizer.py:Test); counts no update."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        rescale = self.rescale_grad

        @torch.no_grad()
        def step(w, g, s):
            w.add_(g * rescale)
            s.copy_(w)
        _update_in_place(step, [weight, grad, state])


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference optimizer.py:AdaDelta), over
    ``adadelta_update``; it takes no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        _update_in_place(adadelta_update, [weight, grad, acc_g, acc_delta],
                         self.rho, self.epsilon, wd, **self._common())


@register
class FTML(Optimizer):
    """FTML, Follow the Moving Leader (reference optimizer.py:602), over
    ``ftml_update``; its state is (d, v, z)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._bias_count(index)
        _update_in_place(ftml_update, [weight, grad, *state], lr, t,
                         self.beta1, self.beta2, self.epsilon, wd,
                         self.rescale_grad, self.clip_gradient)


# ccSGD: the reference's deprecated alias of SGD
_REG.register("ccsgd", SGD)


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
