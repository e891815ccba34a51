"""gluon.Trainer of the port (counterpart of
``incubator_mxnet_tpu/gluon/trainer.py``; reference
python/mxnet/gluon/trainer.py).

Applies an ``Optimizer`` to a list of Parameters after ``backward``:
``step(batch_size)`` sets ``rescale_grad = 1 / batch_size`` and updates
each trainable Parameter whose gradient is fresh, one at a time, through
the optimizer's ``Updater`` (eagerly, on the Parameter's device).  A
Parameter with ``grad_stype="row_sparse"`` (``Embedding(sparse_grad=
True)``) hands the optimizer its gradient as a ``RowSparseNDArray`` of
the rows with a nonzero element, the lazy update's row set, as the JAX
``Trainer`` casts it: a row the batch touched whose gradient is exactly
0 is not updated.  On
one device a kvstore has no role: ``"device"``, ``"local"`` or None
mean no store, as the JAX ``Trainer`` drops single-replica stores.
Stores across devices or processes (``"nccl"``, ``"tpu"``, ``"dist_*"``,
a store object) and ``update_on_kvstore=True`` raise ``MXNetError``
until A6.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from ..ndarray import cast_storage
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = ("device", "local", None)


class Trainer:
    """Updates ``params`` (a list or dict of Parameters, or a
    ``ParameterDict``) with ``optimizer`` (a registered name with
    ``optimizer_params``, or an ``Optimizer``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
        if kvstore not in _LOCAL_STORES or compression_params:
            raise MXNetError(f"kvstore={kvstore!r}: stores across devices "
                             "or processes are not ported yet (ROADMAP A6)")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore=True needs a kvstore, "
                             "which is not ported yet (ROADMAP A6)")
        self._params = list(params)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = opt.get_updater(self._optimizer)
        self._kvstore = None
        self._update_on_kvstore = False

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every trainable Parameter from its gradient,
        scaled by ``1 / batch_size`` (reference trainer.py:step).  A
        gradient that no ``backward`` wrote since the last step raises,
        or with ``ignore_stale_grad`` leaves its Parameter alone."""
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not param._fresh_grad:
                if not ignore_stale_grad:
                    raise UserWarning(
                        f"Gradient of Parameter `{param.name}` on context "
                        f"{param.list_ctx()[0]} has not been updated by "
                        "backward since last `step`. This could mean a bug "
                        "in your model that made it only use a subset of "
                        "the Parameters (Blocks) for this iteration. If you "
                        "are intentionally only using a subset, call step "
                        "with ignore_stale_grad=True to suppress this "
                        "warning and skip updating of Parameters with "
                        "stale gradient")
                continue
            grad = param.grad()
            if param._grad_stype == "row_sparse":
                # the lazy update over the rows whose gradient has a
                # nonzero (JAX trainer.py:113-120: the dense gradient cast
                # to row_sparse; one nonzero, a sync on the card)
                grad = cast_storage(grad, "row_sparse")
            self._updaters(i, grad, param.data())
            param._fresh_grad = False

    def allreduce_grads(self):
        """Gradient reduction across devices: nothing to reduce on one
        device (reference trainer.py:allreduce_grads)."""

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def save_states(self, fname):
        """Save the optimizer and its states (reference
        trainer.py:save_states)."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load what ``save_states`` wrote (reference
        trainer.py:load_states)."""
        with open(fname, "rb") as fin:
            self._updaters.set_states(fin.read())
        self._optimizer = self._updaters.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
