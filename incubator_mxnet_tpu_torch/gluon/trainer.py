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
0 is not updated.

``kvstore`` is a type name (``kvstore.create``) or a store object,
created at the first ``step``.  ``update_on_kvstore`` defaults, as in
the JAX ``Trainer``, to False for the single-replica stores
(``"local"``, ``"device"``, ``"nccl"``), which then take no part (a
single-replica store with local updates has no role), and to True for
the others: each gradient is pushed (``"dist_*"``, and ``"tpu"`` on a
mesh whose ``dp`` group spans processes: the mean over the ranks, then
the optimizer on the store) and the weight pulled back.
With ``update_on_kvstore=False`` a cross-replica store (``"tpu"``,
``"dist_*"``) is kept for ``allreduce_grads``.  ``compression_params``
sets the store's gradient compression.  The optimizer states live on
the store when it updates, and ``save_states`` / ``load_states`` go
through it.
"""
from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from ..ndarray import cast_storage
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

# the single-replica stores (the JAX Trainer's rule for
# update_on_kvstore's default)
_LOCAL_STORES = ("local", "device", "nccl")


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
        self._params = list(params)
        self._compression_params = compression_params
        self._kvstore_type = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
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

    def _init_kvstore(self):
        """Create the store at first use (JAX ``trainer.py:57-81``)."""
        self._kv_initialized = True
        if self._kvstore_type is None:
            self._update_on_kvstore = False
            return
        kv = kvs.create(self._kvstore_type) \
            if isinstance(self._kvstore_type, str) else self._kvstore_type
        self._kvstore = kv
        if self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        if self._update_on_kvstore is None:
            # single-replica stores gain nothing from updating on the store
            self._update_on_kvstore = kv.type not in _LOCAL_STORES
        if self._update_on_kvstore:
            kv.set_optimizer(self._optimizer)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    # every rank starts from the store's (rank 0's) value
                    kv.init(i, param.data())
                    kv.pull(i, out=param.data())
        elif kv.type in _LOCAL_STORES:
            self._kvstore = None

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
        if not self._kv_initialized:
            self._init_kvstore()
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
            if self._kvstore is not None and self._update_on_kvstore:
                self._kvstore.push(i, grad)
                self._kvstore.pull(i, out=param.data())
            else:
                self._updaters(i, grad, param.data())
            param._fresh_grad = False

    def allreduce_grads(self):
        """Average the gradients over the replicas without updating
        (reference trainer.py:allreduce_grads): the ``"tpu"`` store's
        ``allreduce``; nothing on one device."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and hasattr(self._kvstore, "allreduce"):
            self._kvstore.allreduce([p.grad() for p in self._params
                                     if p.grad_req != "null"])

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def save_states(self, fname):
        """Save the optimizer and its states (reference
        trainer.py:save_states), from the store when it updates."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load what ``save_states`` wrote (reference
        trainer.py:load_states), into the store when it updates."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as fin:
                self._updaters.set_states(fin.read())
            self._optimizer = self._updaters.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
