"""Gluon convolution and pooling layers of the port (counterpart of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``; reference
python/mxnet/gluon/nn/conv_layers.py): ``Conv1D``/``2D``/``3D`` and
their transposes, ``Max``/``AvgPool1D``/``2D``/``3D``, the global pools,
``ReflectionPad2D``, ``MXUStemConv2D``, and ``FusedBNReLUConv2D`` /
``FusedBottleneckChain`` over ``nd._FusedBNReluConv`` /
``nd._FusedBottleneckChain`` (the hand-written kernels on the card,
inside their envelope), whose parameters sit on child BatchNorm and
Conv2D blocks named as the unfused twin's.

Layouts are the JAX layers': the reference's NCHW family, or
channels-last (``NHWC`` ...) data with the weight still ``(O, I,
*kernel)``.  The tensor-level layers are in ``gluon.nn._modules``.
"""
from __future__ import annotations

from types import SimpleNamespace

from ..block import HybridBlock
from ..parameter import DeferredInitializationError
from .activations import Activation
from .basic_layers import BatchNorm

__all__ = ["Conv1D", "Conv2D", "MXUStemConv2D", "FusedBNReLUConv2D",
           "FusedBottleneckChain",
           "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        if not (len(v) == n):
            raise ValueError('expected len(v) == n')
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    """Shared conv implementation (reference conv_layers.py:_Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        n = len(kernel_size)
        self._layout = layout
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._channel_axis = layout.find("C")
        with self.name_scope():
            if op_name == "Convolution":
                wshape = self._weight_shape_conv(n, groups)
            else:
                wshape = self._weight_shape_deconv(n, groups)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _weight_shape_conv(self, n, groups):
        return (self._channels, self._in_channels // groups
                if self._in_channels else 0) + self._kwargs["kernel"]

    def _weight_shape_deconv(self, n, groups):
        return (self._in_channels, self._channels // groups) + \
            self._kwargs["kernel"]

    def infer_shape(self, x, *args):
        in_channels = x.shape[self._channel_axis]
        self._in_channels = in_channels
        groups = self._kwargs["num_group"]
        if self._op_name == "Convolution":
            self.weight.shape = (self._channels, in_channels // groups) + \
                self._kwargs["kernel"]
        else:
            self.weight.shape = (in_channels, self._channels // groups) + \
                self._kwargs["kernel"]

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        s += ")"
        shape = self.weight.shape
        return s.format(
            name=self.__class__.__name__,
            mapping=f"{shape[1] if shape and len(shape) > 1 else None} -> "
                    f"{self._channels}",
            **self._kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        super().__init__(
            channels, kernel_size, _tup(strides, 1), _tup(padding, 1),
            _tup(dilation, 1), groups, layout, in_channels, activation,
            use_bias, weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(
            channels, kernel_size, _tup(strides, 2), _tup(padding, 2),
            _tup(dilation, 2), groups, layout, in_channels, activation,
            use_bias, weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        super().__init__(
            channels, kernel_size, _tup(strides, 3), _tup(padding, 3),
            _tup(dilation, 3), groups, layout, in_channels, activation,
            use_bias, weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        super().__init__(
            channels, kernel_size, _tup(strides, 1), _tup(padding, 1),
            _tup(dilation, 1), groups, layout, in_channels, activation,
            use_bias, weight_initializer, bias_initializer,
            op_name="Deconvolution", adj=_tup(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(
            channels, kernel_size, _tup(strides, 2), _tup(padding, 2),
            _tup(dilation, 2), groups, layout, in_channels, activation,
            use_bias, weight_initializer, bias_initializer,
            op_name="Deconvolution", adj=_tup(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        super().__init__(
            channels, kernel_size, _tup(strides, 3), _tup(padding, 3),
            _tup(dilation, 3), groups, layout, in_channels, activation,
            use_bias, weight_initializer, bias_initializer,
            op_name="Deconvolution", adj=_tup(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """Shared pooling implementation (reference conv_layers.py:_Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad
        if layout is not None:
            self._kwargs["layout"] = layout

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad}, " \
               "ceil_mode={ceil_mode})".format(
                   name=self.__class__.__name__,
                   ceil_mode=self._kwargs["pooling_convention"] == "full",
                   **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        if not (layout in ("NCW", "NWC")):
            raise ValueError(f"layout must be NCW or NWC, got {layout}")
        super().__init__(_tup(pool_size, 1),
                         _tup(strides, 1) if strides is not None else None,
                         _tup(padding, 1), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        if not (layout in ("NCHW", "NHWC")):
            raise ValueError(f"layout must be NCHW or NHWC, got {layout}")
        super().__init__(_tup(pool_size, 2),
                         _tup(strides, 2) if strides is not None else None,
                         _tup(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        if not (layout in ("NCDHW", "NDHWC")):
            raise ValueError(f"layout must be NCDHW or NDHWC, got {layout}")
        super().__init__(_tup(pool_size, 3),
                         _tup(strides, 3) if strides is not None else None,
                         _tup(padding, 3), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        if not (layout in ("NCW", "NWC")):
            raise ValueError(f"layout must be NCW or NWC, got {layout}")
        super().__init__(_tup(pool_size, 1),
                         _tup(strides, 1) if strides is not None else None,
                         _tup(padding, 1), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        if not (layout in ("NCHW", "NHWC")):
            raise ValueError(f"layout must be NCHW or NHWC, got {layout}")
        super().__init__(_tup(pool_size, 2),
                         _tup(strides, 2) if strides is not None else None,
                         _tup(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        if not (layout in ("NCDHW", "NDHWC")):
            raise ValueError(f"layout must be NCDHW or NDHWC, got {layout}")
        super().__init__(_tup(pool_size, 3),
                         _tup(strides, 3) if strides is not None else None,
                         _tup(padding, 3), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max",
                         layout=layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding on H/W of NCHW input (reference
    conv_layers.py:ReflectionPad2D; op Pad mode='reflect')."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if not (len(padding) == 8):
            raise ValueError('expected len(padding) == 8')
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)


class MXUStemConv2D(Conv2D):
    """The JAX package's space-to-depth stem convolution, which reshapes a
    strided conv for the TPU's 128-lane matrix unit with the same math
    and parameters.  On the card a strided conv has no such shape to
    fix, so it runs as the plain Conv2D; it shares that layer's name, so
    checkpoints interchange."""

    def _alias(self):
        return "conv2d"


class FusedBNReLUConv2D(HybridBlock):
    """BatchNorm -> ReLU -> Conv2D as ONE op (`_FusedBNReluConv`).

    With NHWC data, stride 1, one group and a 1x1 pad-0 or 3x3 pad-1
    kernel the BN affine, ReLU and convolution run as one hand-written
    kernel on the card (``ops/fused_conv.py``: B1 ``sbr_matmul``, B2
    ``sbr_conv3x3``), the activated tensor never written to device
    memory; anything else runs the plain composition.

    Parameters live on child BatchNorm / Conv2D blocks whose prefixes are
    caller-controllable (``bn_prefix`` / ``conv_prefix``), so a fused model
    keeps the exact parameter names of its unfused twin and checkpoints
    interchange both ways.
    """

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 groups=1, layout="NCHW", in_channels=0, use_bias=False,
                 epsilon=1e-5, momentum=0.9, weight_initializer=None,
                 bn_prefix=None, conv_prefix=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layout = layout
        with self.name_scope():
            self.bn = BatchNorm(axis=layout.find("C"), momentum=momentum,
                                epsilon=epsilon, in_channels=in_channels,
                                prefix=bn_prefix)
            self.conv = Conv2D(channels, kernel_size, strides, padding,
                               groups=groups, layout=layout,
                               use_bias=use_bias,
                               weight_initializer=weight_initializer,
                               in_channels=in_channels, prefix=conv_prefix)

    def infer_shape(self, x, *args):
        self.bn.infer_shape(x)
        self.conv.infer_shape(x)  # BN+ReLU preserve the input shape

    def _child_params(self, x):
        bn, conv = self.bn, self.conv
        plist = [bn.gamma, bn.beta, bn.running_mean, bn.running_var,
                 conv.weight] + ([conv.bias] if conv.bias is not None else [])
        try:
            return [p.data() for p in plist]
        except DeferredInitializationError:
            self.infer_shape(x)
            for p in plist:
                p._finish_deferred_init()
            return [p.data() for p in plist]

    def hybrid_forward(self, F, x):
        gamma, beta, rmean, rvar, weight, *maybe_bias = self._child_params(x)
        ck = self.conv._kwargs
        bk = self.bn._kwargs
        return F._FusedBNReluConv(
            x, gamma, beta, rmean, rvar, weight,
            maybe_bias[0] if maybe_bias else None,
            kernel=ck["kernel"], stride=ck["stride"], pad=ck["pad"],
            num_filter=ck["num_filter"], num_group=ck["num_group"],
            layout=ck["layout"], eps=bk["eps"], momentum=bk["momentum"],
            fix_gamma=bk["fix_gamma"],
            use_global_stats=bk["use_global_stats"])

    def __repr__(self):
        shape = self.conv.weight.shape
        return (f"FusedBNReLUConv2D({shape[1] if shape and len(shape) > 1 else None}"
                f" -> {self.conv._channels}, "
                f"kernel_size={self.conv._kwargs['kernel']}, "
                f"stride={self.conv._kwargs['stride']})")


class FusedBottleneckChain(HybridBlock):
    """[BN -> ReLU -> Conv3x3 -> BN -> ReLU -> Conv1x1] as ONE op
    (`_FusedBottleneckChain`), the ResNet bottleneck interior
    (``ops/fused_chain.py``): with NHWC data on the card two
    hand-written kernels (B3 ``chain_stats``, B4 ``chain_emit``) that
    recompute the 3x3 and write only the block output; elsewhere the
    plain composition.  Parameters live on child BatchNorm/Conv2D blocks so a
    fused model keeps the exact parameter names of its unfused twin and
    checkpoints interchange both ways (the FusedBNReLUConv2D contract).
    """

    def __init__(self, mid_channels, channels, layout="NCHW",
                 in_channels=0, epsilon=1e-5, momentum=0.9,
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layout = layout
        ax = layout.find("C")
        with self.name_scope():
            self.bn1 = BatchNorm(axis=ax, momentum=momentum,
                                 epsilon=epsilon, in_channels=in_channels)
            self.conv2 = Conv2D(mid_channels, 3, 1, 1, layout=layout,
                                use_bias=False,
                                weight_initializer=weight_initializer,
                                in_channels=in_channels)
            self.bn2 = BatchNorm(axis=ax, momentum=momentum,
                                 epsilon=epsilon, in_channels=mid_channels)
            self.conv3 = Conv2D(channels, 1, 1, 0, layout=layout,
                                use_bias=True,
                                weight_initializer=weight_initializer,
                                in_channels=mid_channels)

    def infer_shape(self, x, *args):
        self.bn1.infer_shape(x)
        self.conv2.infer_shape(x)
        mid = list(x.shape)
        mid[self._layout.find("C")] = self.conv2._channels
        probe = SimpleNamespace(shape=tuple(mid))   # only its shape is read
        self.bn2.infer_shape(probe)
        self.conv3.infer_shape(probe)

    def _child_params(self, x):
        plist = [self.bn1.gamma, self.bn1.beta, self.bn1.running_mean,
                 self.bn1.running_var, self.conv2.weight, self.bn2.gamma,
                 self.bn2.beta, self.bn2.running_mean,
                 self.bn2.running_var, self.conv3.weight, self.conv3.bias]
        try:
            return [p.data() for p in plist]
        except DeferredInitializationError:
            self.infer_shape(x)
            for p in plist:
                p._finish_deferred_init()
            return [p.data() for p in plist]

    def hybrid_forward(self, F, x):
        (g1, b1, rm1, rv1, w2, g2, b2, rm2, rv2, w3,
         bias3) = self._child_params(x)
        bk = self.bn1._kwargs
        return F._FusedBottleneckChain(
            x, g1, b1, rm1, rv1, w2, g2, b2, rm2, rv2, w3, bias3,
            layout=self._layout, eps=bk["eps"], momentum=bk["momentum"],
            fix_gamma=bk["fix_gamma"],
            use_global_stats=bk["use_global_stats"])

    def __repr__(self):
        return (f"FusedBottleneckChain(-> {self.conv2._channels} -> "
                f"{self.conv3._channels}, layout={self._layout})")
