"""Gluon activation layers of the port (counterpart of
``incubator_mxnet_tpu/gluon/nn/activations.py``; reference
python/mxnet/gluon/nn/activations.py): ``Activation``, ``LeakyReLU``,
``PReLU``, ``ELU``, ``SELU`` and ``Swish`` over the ``Activation`` and
``LeakyReLU`` ops (the Gluon family of ``gluon.nn``; the tensor-level
``Activation`` is ``gluon.nn._modules.Activation``)."""
from __future__ import annotations

from ... import initializer
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish"]


class Activation(HybridBlock):
    """relu/sigmoid/tanh/softrelu/softsign (reference activations.py:Activation)."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    """max(x, alpha*x) (reference activations.py:LeakyReLU)."""

    def __init__(self, alpha, prefix=None, params=None):
        if not (alpha >= 0):
            raise ValueError("Slope coefficient for LeakyReLU must be >= 0.")
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """Learnable-slope leaky relu (reference activations.py:PReLU; op
    LeakyReLU act_type='prelu', src/operator/leaky_relu-inl.h)."""

    def __init__(self, alpha_initializer="constant", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if alpha_initializer == "constant":
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """x if x>0 else alpha*(exp(x)-1) (reference activations.py:ELU)."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Self-normalizing ELU (reference activations.py:SELU)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """x * sigmoid(beta x) (reference activations.py:Swish)."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
