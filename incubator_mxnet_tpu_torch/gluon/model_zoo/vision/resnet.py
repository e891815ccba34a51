"""ResNet V1 and V2 of the port (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``): the same
blocks, stages and widths, for inference and training.

* ``fuse_bn_relu=True`` runs the stem's and every block body's inner
  [BN -> ReLU] pairs as one ``BNReLU`` each (the lean backward of
  ``ops.nn.fused_batch_norm_relu``), where ``fuse_block`` does not fuse
  them into a conv; the pair that closes a block stays BatchNorm, as
  the residual add comes before its ReLU.
* ``fuse_block=True`` runs the [BN -> ReLU -> conv] boundaries inside
  each block as ``FusedBNReLUConv2D`` layers, which on the card and with
  ``layout="NHWC"`` are the hand-written kernels: in ``BottleneckV1``
  the 3x3 (``sbr_conv3x3``) and the 1x1 with bias (``sbr_matmul``), in
  ``BasicBlockV1`` the second 3x3.  ``fuse_block=False`` builds the same
  layers, with the same parameter names, running the plain composition.
  As in the JAX package, the stride of a V1 bottleneck sits on its 1x1
  ``conv1``, so every fused boundary is stride 1.
* ``fuse_block="1x1"`` fuses only a bottleneck's 1x1 boundary
  (``sbr_matmul``); its 3x3 boundary runs as ``BNReLU`` then the conv.
* ``fuse_block="chain"`` runs a bottleneck's whole interior [BN -> ReLU
  -> conv 3x3 -> BN -> ReLU -> conv 1x1] as one ``FusedBottleneckChain``
  over the same two layers (same parameter names again): on the card the
  chain kernels, ``chain_stats`` then ``chain_emit`` in train mode and
  ``chain_emit`` alone in eval.  ``"chain34"`` does so only where the
  3x3 has at least 256 channels (stages 3 and 4 of ResNet-50) and runs
  the other bottlenecks with ``fuse_bn_relu=True``.
* A basic block has no bottleneck interior: with ``"1x1"``, ``"chain"``
  or ``"chain34"`` it runs as ``fuse_block=False, fuse_bn_relu=True``,
  as in the JAX package.
* Every mode keeps the parameter names of the unfused net, so a net's
  ``state_dict`` loads into every other mode.
* ``layout="NHWC"``: the model takes ``(N, H, W, 3)`` images, as the
  JAX model does, and runs channels-last inside (``gluon.nn``'s module
  note); ``"NCHW"`` takes ``(N, 3, H, W)``.  Either way it returns
  ``(N, classes)`` logits.
* Train mode (``net.train()``) takes every BatchNorm's batch statistics
  and moves its running ones towards them; ``parallel.TrainStep`` trains.
* ``mxu_stem=True`` builds the stem the JAX package computes by
  space-to-depth (``MXUStemConv2D``, the same convolution reshaped for
  the TPU's 128-lane matrix unit, with the parameters and names of the
  plain conv) as that plain 7x7 stride-2 conv: on the card a strided
  conv has no such shape to fix, and checkpoints interchange either way.
* The Gluon surface, beside the tensor one: ``collect_params()``
  returns Gluon Parameters that view the module's own tensors (no copy)
  under the JAX package's full names (``convert.resnet_param_names``,
  ``prefix`` ``resnetv10_`` by default; the moving statistics
  ``grad_req="null"``), so a ``gluon.Trainer`` over them updates the
  net in place; ``save_params`` / ``load_params`` use those full names,
  the form the JAX package's ``load_params`` accepts; called on an
  ``NDArray`` the net returns an ``NDArray``, recorded under
  ``autograd.record()``, with the BatchNorm mode following
  ``autograd.is_training()`` as in JAX (the module's own mode is put
  back after the call).  A tensor in still gives a tensor out.
  ``initialize(seed)`` draws the seeded weights below for an int; for an
  ``Initializer`` or its name it fills every Parameter the Gluon way
  (by name suffix), whatever they held.
* ResNet V2 (pre-activation; ``BasicBlockV2``, ``BottleneckV2``,
  ``ResNetV2``, ``get_resnet(2, ...)``): a stem ``BatchNorm(scale=False,
  center=False)`` on the images, the stem conv (BN + ReLU and max pool
  unless ``thumbnail``), the stages, a closing BN + ReLU, pool and
  ``output``.  A V2 block is ``bn1`` (+ ReLU), its downsample conv on
  that activation, ``conv1``, then ``fused2`` and ``fused3`` (a basic
  block: ``fused2`` only), each a ``FusedBNReLUConv2D`` [BN -> ReLU ->
  conv], and the residual add without a ReLU.  The stride sits on the
  3x3 ``fused2`` of a bottleneck and on ``conv1`` of a basic block.  The
  modes are the JAX package's: ``fuse_block=True`` makes ``bn1`` a
  ``BNReLU`` and fuses ``fused2`` and ``fused3`` (a strided ``fused2``
  runs its plain composition, as JAX gives it its exact XLA form, so B2
  runs only in the bottlenecks of stride 1); ``"1x1"`` fuses only
  ``fused3`` (``fused2`` as ``BNReLU`` then the conv); ``"chain"`` and
  ``"chain34"`` become ``"1x1"`` in a bottleneck and, as for V1,
  ``fuse_bn_relu=True`` in a basic block.  The Gluon names use the
  prefix ``resnetv20_``.
* Not ported, and raising ``MXNetError``: ``pretrained=True``.
"""
from __future__ import annotations

import math
import re

import torch
from torch import nn

from .... import autograd
from ....base import MXNetError
from ....context import cpu, resolve_device
from ....convert import resnet_param_names
from ....ndarray import utils as nd_utils
from ....ndarray.ndarray import NDArray
from ...parameter import Parameter, ParameterDict
from ...nn._modules import (BatchNorm, BNReLU, Conv2D, Dense, Flatten,
                            FusedBNReLUConv2D, FusedBottleneckChain,
                            GlobalAvgPool2D, MaxPool2D)
from ._common import add_bn_relu

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "BasicBlockV2",
           "BottleneckV2", "ResNetV2", "resnet_spec", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, layout, device):
    return Conv2D(channels, 3, stride, 1, use_bias=False,
                  in_channels=in_channels, layout=layout, device=device)


def _downsample(channels, stride, in_channels, layout, device):
    return nn.Sequential(
        Conv2D(channels, 1, stride, use_bias=False, in_channels=in_channels,
               layout=layout, device=device),
        BatchNorm(channels, device=device))


def _unknown_mode(fuse_block):
    return MXNetError(f"unknown fuse_block={fuse_block!r}: False, True, "
                      "'chain', '1x1' or 'chain34'")


class _BlockV1(nn.Module):
    """``relu(body(x) + residual)``; the residual is ``x`` or its
    downsample.  The add and ReLU run in place on the body's output.
    A block with a ``chain`` runs its body as ``body[0]``, the chain
    (over ``body[1]`` and ``body[2]``), then ``body[3]``."""

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        if self.chain is None:
            out = self.body(x)
        else:
            body = self.body
            out = body[3](self.chain(body[0](x)))
        return out.add_(residual).relu_()


class BasicBlockV1(_BlockV1):
    """3x3 + 3x3 block (reference resnet.py:BasicBlockV1); with
    ``fuse_block=True`` its [BN -> ReLU -> conv2] boundary is one
    kernel, with ``fuse_bn_relu=True`` (and in the bottleneck-only modes
    ``"1x1"``, ``"chain"`` and ``"chain34"``) its BN + ReLU is one
    ``BNReLU``."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fuse_bn_relu=False, fuse_block=False,
                 device=None):
        super().__init__()
        if fuse_block in ("1x1", "chain", "chain34"):
            fuse_block, fuse_bn_relu = False, True
        if fuse_block not in (False, True):
            raise _unknown_mode(fuse_block)
        self.body = nn.Sequential(
            _conv3x3(channels, stride, in_channels, layout, device),
            FusedBNReLUConv2D(channels, 3, 1, 1, layout=layout,
                              in_channels=channels, fuse=fuse_block,
                              bn_relu=fuse_bn_relu and not fuse_block,
                              device=device),
            BatchNorm(channels, device=device))
        self.chain = None
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      device) if downsample else None


class BottleneckV1(_BlockV1):
    """1x1 - 3x3 - 1x1 bottleneck (reference resnet.py:BottleneckV1),
    the stride on ``conv1``; with ``fuse_block=True`` both [BN -> ReLU ->
    conv] boundaries of the body are one kernel each, with ``"1x1"``
    only the second (the first a ``BNReLU``), with ``"chain"`` the two
    together are one ``FusedBottleneckChain``; ``"chain34"`` is
    ``"chain"`` where the 3x3 has at least 256 channels and
    ``fuse_bn_relu=True`` elsewhere (reference ``resnet.py:96-102``).
    ``fuse_bn_relu=True`` makes every BN + ReLU that no kernel fuses a
    ``BNReLU``."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fuse_bn_relu=False, fuse_block=False,
                 device=None):
        super().__init__()
        mid = channels // 4
        if fuse_block == "chain34":
            fuse_block, fuse_bn_relu = ("chain", fuse_bn_relu) \
                if mid >= 256 else (False, True)
        if fuse_block not in (False, True, "chain", "1x1"):
            raise _unknown_mode(fuse_block)
        bn_relu = fuse_bn_relu and fuse_block is False
        self.body = nn.Sequential(
            Conv2D(mid, 1, stride, in_channels=in_channels, layout=layout,
                   device=device),
            FusedBNReLUConv2D(mid, 3, 1, 1, layout=layout, in_channels=mid,
                              fuse=fuse_block is True,
                              bn_relu=bn_relu or fuse_block == "1x1",
                              device=device),
            FusedBNReLUConv2D(channels, 1, 1, 0, layout=layout,
                              in_channels=mid, use_bias=True,
                              fuse=fuse_block in (True, "1x1"),
                              bn_relu=bn_relu, device=device),
            BatchNorm(channels, device=device))
        self.chain = FusedBottleneckChain(self.body[1], self.body[2]) \
            if fuse_block == "chain" else None
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      device) if downsample else None


class _BlockV2(nn.Module):
    """``body(x) + residual`` of a pre-activation block: ``bn1`` (a
    ``BNReLU``, or a ``BatchNorm`` followed by a ReLU), the downsample
    conv on that activation when there is one, ``conv1``, then each
    [BN -> ReLU -> conv] unit of ``units``."""

    def _pre(self, channels, stride, downsample, in_channels, layout,
             fused, device):
        self.bn1 = (BNReLU if fused else BatchNorm)(in_channels,
                                                   device=device)
        self._relu1 = not fused
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, layout=layout,
                                 device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = self.bn1(x)
        if self._relu1:
            x = torch.relu(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        for unit in self.units:
            x = unit(x)
        return x + residual


class BasicBlockV2(_BlockV2):
    """Pre-activation 3x3 + 3x3 block (reference resnet.py:BasicBlockV2):
    ``bn1``, ``conv1`` (the stride), ``fused2``; ``fuse_block=True`` fuses
    ``fused2`` into one kernel and makes ``bn1`` a ``BNReLU``; ``"1x1"``,
    ``"chain"`` and ``"chain34"`` run as ``fuse_bn_relu=True``."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fuse_bn_relu=False, fuse_block=False,
                 device=None):
        super().__init__()
        if fuse_block in ("1x1", "chain", "chain34"):
            fuse_block, fuse_bn_relu = False, True
        if fuse_block not in (False, True):
            raise _unknown_mode(fuse_block)
        fused = bool(fuse_bn_relu or fuse_block)
        self._pre(channels, stride, downsample, in_channels, layout, fused,
                  device)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, device)
        self.fused2 = FusedBNReLUConv2D(channels, 3, 1, 1, layout=layout,
                                        in_channels=channels,
                                        fuse=fuse_block,
                                        bn_relu=fused and not fuse_block,
                                        device=device)
        self.units = (self.fused2,)


class BottleneckV2(_BlockV2):
    """Pre-activation 1x1 - 3x3 - 1x1 bottleneck (reference
    resnet.py:BottleneckV2), the stride on the 3x3 ``fused2``.
    ``fuse_block=True`` fuses ``fused2`` (inside the kernels' envelope,
    so not when strided) and ``fused3``; ``"1x1"`` fuses ``fused3``
    only; ``"chain"`` and ``"chain34"`` are ``"1x1"`` here (JAX
    ``resnet.py:220-223``).  Any fused mode, or ``fuse_bn_relu``, makes
    every BN + ReLU that no kernel fuses a ``BNReLU``."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fuse_bn_relu=False, fuse_block=False,
                 device=None):
        super().__init__()
        if fuse_block in ("chain", "chain34"):
            fuse_block = "1x1"
        if fuse_block not in (False, True, "1x1"):
            raise _unknown_mode(fuse_block)
        fused = bool(fuse_bn_relu or fuse_block)
        mid = channels // 4
        self._pre(channels, stride, downsample, in_channels, layout, fused,
                  device)
        self.conv1 = Conv2D(mid, 1, 1, use_bias=False,
                            in_channels=in_channels, layout=layout,
                            device=device)
        self.fused2 = FusedBNReLUConv2D(mid, 3, stride, 1, layout=layout,
                                        in_channels=mid,
                                        fuse=fuse_block is True,
                                        bn_relu=fused and
                                        fuse_block is not True,
                                        device=device)
        self.fused3 = FusedBNReLUConv2D(channels, 1, 1, 0, layout=layout,
                                        in_channels=mid,
                                        fuse=bool(fuse_block),
                                        bn_relu=fused and not fuse_block,
                                        device=device)
        self.units = (self.fused2, self.fused3)


class _ResNet(nn.Module):
    """What ResNet V1 and V2 share: the seeded initialisation, the
    forward (an NHWC model takes ``(N, H, W, 3)`` images), and the Gluon
    surface (``collect_params`` and the rest) under ``prefix``."""

    def __init__(self, layers, channels, layout, fuse_block, prefix):
        super().__init__()
        self.prefix = prefix
        self._gluon_params = None
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need {len(layers) + 1} "
                             f"widths, got {channels}")
        if fuse_block not in (False, True, "chain", "1x1", "chain34"):
            raise _unknown_mode(fuse_block)
        self.layout = layout

    def initialize(self, init=0, ctx=None, verbose=False,
                   force_reinit=True, seed=None):
        """An int (``init`` or ``seed``): the seeded draw of
        ``_seeded_init``.  An ``Initializer`` or its name: every Gluon
        Parameter (``collect_params``) filled by it, in place, as
        ``Block.initialize`` fills a fresh net (``ctx`` must be the
        net's device, where the Parameters live)."""
        if seed is not None or isinstance(init, int):
            self._seeded_init(init if seed is None else seed)
            return
        self.collect_params().initialize(init, ctx, verbose,
                                         force_reinit=True)

    @torch.no_grad()
    def _seeded_init(self, seed=0):
        """Fill every parameter and BN statistic from ``seed``, drawn on
        the CPU in module order and copied to the device:

        * conv weights Kaiming-normal, N(0, 2 / fan_in); conv biases 0;
        * every BatchNorm: gamma ~ U(0.5, 1), beta ~ N(0, 0.1^2),
          running_mean ~ N(0, 0.1^2), running_var ~ U(0.5, 1.5); in
          V1 the BatchNorm that closes a block's body (its residual
          branch) has gamma scaled by 0.25, so the residual stream grows
          by only a few percent a block and activations stay O(1)
          through all stages; a BatchNorm built ``scale=False`` keeps
          gamma 1 and one built ``center=False`` beta 0 (V2's stem);
        * the output Dense: weight N(0, 1 / in_units), bias 0.
        """
        gen = torch.Generator().manual_seed(int(seed))

        def draw(t, fill):
            t.copy_(fill(torch.empty(t.shape)).to(t.device))

        closing = self._closing_norms()
        for mod in self.modules():
            if isinstance(mod, Conv2D):
                fan_in = mod.weight[0].numel()
                draw(mod.weight, lambda t: t.normal_(
                    0, math.sqrt(2.0 / fan_in), generator=gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                scale = 0.25 if id(mod) in closing else 1.0
                draw(mod.gamma, lambda t: t.uniform_(
                    0.5, 1.0, generator=gen).mul_(scale))
                draw(mod.beta, lambda t: t.normal_(0, 0.1, generator=gen))
                draw(mod.running_mean, lambda t: t.normal_(
                    0, 0.1, generator=gen))
                draw(mod.running_var, lambda t: t.uniform_(
                    0.5, 1.5, generator=gen))
                if mod.fix_gamma:               # scale=False: gamma is 1
                    mod.gamma.fill_(1.0)
                if not mod.beta.requires_grad:  # center=False: beta is 0
                    mod.beta.zero_()
            elif isinstance(mod, Dense):
                draw(mod.weight, lambda t: t.normal_(
                    0, 1.0 / math.sqrt(mod.weight.shape[1]), generator=gen))
                mod.bias.zero_()

    def forward(self, x):
        if x.dim() != 4:
            raise MXNetError(f"{type(self).__name__} takes 4-D images, got "
                             f"{tuple(x.shape)}")
        if self.layout == "NHWC":
            # (N, H, W, C) -> NCHW-indexed channels-last: a view of
            # contiguous input, a copy of anything else
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        return self.output(torch.flatten(self.features(x), 1))

    # ------------------------------------------------------------ Gluon
    def __call__(self, *args, **kwargs):
        if args and isinstance(args[0], NDArray):
            return self._call_nd(args[0])
        return super().__call__(*args, **kwargs)

    def _call_nd(self, x):
        """The forward of an NDArray: recorded under ``autograd.record()``,
        BatchNorm in train mode when ``autograd.is_training()``."""
        was_training = self.training
        self.train(autograd.is_training())
        try:
            with torch.set_grad_enabled(autograd.is_recording()):
                out = super().__call__(x._data)
        finally:
            self.train(was_training)
        return NDArray(out, x.context)

    def _tensors(self):
        tensors = dict(self.named_parameters())
        buffers = dict(self.named_buffers())
        tensors.update(buffers)
        return tensors, buffers

    def collect_params(self, select=None):
        """Gluon Parameters viewing this net's tensors, by their JAX full
        names; ``select`` is a regex the names must match.  The same
        Parameter objects on every call while the tensors stay the same
        (a ``.to()`` of the net makes new ones)."""
        tensors, buffers = self._tensors()
        params = self._gluon_params
        if params is None or any(
                p._data._data is not tensors[k] for k, p in params.values()):
            params = {}
            for name, key in resnet_param_names(tensors,
                                                self.prefix).items():
                t = tensors[key]
                req = "null" if key in buffers or not t.requires_grad \
                    else "write"
                p = Parameter.view(name, t, grad_req=req)
                p._is_aux = key in buffers
                params[name] = (key, p)
            self._gluon_params = params
        pattern = re.compile(select) if select is not None else None
        out = ParameterDict(self.prefix)
        out.update({n: p for n, (_, p) in params.items()
                    if pattern is None or pattern.match(n)})
        return out

    def save_params(self, filename):
        """Save every parameter and moving statistic under its full name
        (``collect_params``), the form the JAX package's ``load_params``
        reads."""
        nd_utils.save(filename, {n: p.data() for n, p in
                                 self.collect_params().items()})

    save_parameters = save_params

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Load a file of full names (``save_params``, ``ParameterDict.
        save``, the JAX ``export``'s ``arg:``/``aux:`` keys) into the
        net's tensors, in place."""
        with cpu():
            loaded = nd_utils.load(filename)
        by_name = {k.split(":", 1)[-1]: v for k, v in loaded.items()}
        params = self.collect_params()
        for name, p in params.items():
            if name in by_name:
                p._load_init(by_name[name], ctx)
            elif not allow_missing:
                raise IOError(f"Parameter {name} missing in {filename}")
        extra = sorted(set(by_name) - set(params.keys()))
        if extra and not ignore_extra:
            raise IOError(f"Parameters {extra[:5]} in file {filename} are "
                          "not present in this net")

    load_parameters = load_params


class ResNetV1(_ResNet):
    """ResNet V1 (reference resnet.py:ResNetV1): ``features`` (stem,
    four stages, global average pool) then the ``output`` Dense.  The
    weights are drawn from ``seed`` (``initialize``); ``prefix`` names
    the Gluon Parameters (``collect_params``)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, mxu_stem=False, layout="NCHW",
                 fuse_bn_relu=False, fuse_block=False, device=None, seed=0,
                 prefix="resnetv10_"):
        super().__init__(layers, channels, layout, fuse_block, prefix)
        device = resolve_device(device)
        if thumbnail:
            feats = [_conv3x3(channels[0], 1, IMAGE_CHANNELS, layout,
                              device)]
        else:
            feats = [Conv2D(channels[0], 7, 2, 3, use_bias=False,
                            in_channels=IMAGE_CHANNELS, layout=layout,
                            device=device)]
            add_bn_relu(feats, fuse_bn_relu, channels[0], device=device)
            feats.append(MaxPool2D(3, 2, 1))
        opts = dict(layout=layout, fuse_bn_relu=fuse_bn_relu,
                    fuse_block=fuse_block, device=device)
        for i, num in enumerate(layers):
            stride = 1 if i == 0 else 2
            out_ch, in_ch = channels[i + 1], channels[i]
            stage = [block(out_ch, stride, out_ch != in_ch,
                           in_channels=in_ch, **opts)]
            stage += [block(out_ch, 1, False, in_channels=out_ch, **opts)
                      for _ in range(num - 1)]
            feats.append(nn.Sequential(*stage))
        feats.append(GlobalAvgPool2D())
        self.features = nn.Sequential(*feats)
        self.output = Dense(classes, channels[-1], device=device)
        self.initialize(seed)

    def _closing_norms(self):
        """The BatchNorm that closes each block's body (its residual
        branch), whose gamma the seeded draw scales by 0.25."""
        return {id(blk.body[-1]) for stage in self.features
                if isinstance(stage, nn.Sequential) for blk in stage}


class ResNetV2(_ResNet):
    """ResNet V2 (reference resnet.py:ResNetV2): ``features`` (the stem
    ``BatchNorm(scale=False, center=False)`` on the images, the stem
    conv, BN + ReLU and max pool unless ``thumbnail``, the stages, a
    closing BN + ReLU, global average pool, flatten) then the ``output``
    Dense.  The weights are drawn from ``seed``; ``prefix`` names the
    Gluon Parameters."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, mxu_stem=False, layout="NCHW",
                 fuse_bn_relu=False, fuse_block=False, device=None, seed=0,
                 prefix="resnetv20_"):
        super().__init__(layers, channels, layout, fuse_block, prefix)
        device = resolve_device(device)
        feats = [BatchNorm(IMAGE_CHANNELS, scale=False, center=False,
                           device=device)]
        if thumbnail:
            feats.append(_conv3x3(channels[0], 1, IMAGE_CHANNELS, layout,
                                  device))
        else:
            feats.append(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                in_channels=IMAGE_CHANNELS, layout=layout,
                                device=device))
            add_bn_relu(feats, fuse_bn_relu, channels[0], device=device)
            feats.append(MaxPool2D(3, 2, 1))
        opts = dict(layout=layout, fuse_bn_relu=fuse_bn_relu,
                    fuse_block=fuse_block, device=device)
        in_ch = channels[0]
        for i, num in enumerate(layers):
            stride = 1 if i == 0 else 2
            out_ch = channels[i + 1]
            stage = [block(out_ch, stride, out_ch != in_ch,
                           in_channels=in_ch, **opts)]
            stage += [block(out_ch, 1, False, in_channels=out_ch, **opts)
                      for _ in range(num - 1)]
            feats.append(nn.Sequential(*stage))
            in_ch = out_ch
        add_bn_relu(feats, fuse_bn_relu, in_ch, device=device)
        feats += [GlobalAvgPool2D(), Flatten()]
        self.features = nn.Sequential(*feats)
        self.output = Dense(classes, in_ch, device=device)
        self.initialize(seed)

    def _closing_norms(self):
        """None: a pre-activation block's residual branch ends in a
        conv."""
        return set()


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

_NETS = {1: ResNetV1, 2: ResNetV2}
_BLOCKS = {1: {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
           2: {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}}


def get_resnet(version, num_layers, pretrained=False, device=None, seed=0,
               **kwargs):
    """Factory (reference resnet.py:get_resnet).  ``device=None`` means
    ``cuda:0`` (raises without a GPU); weights come from ``seed``."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in _NETS:
        raise MXNetError(f"Invalid resnet version: {version}. Options are "
                         "1 and 2.")
    if pretrained:
        raise MXNetError("pretrained weights are unavailable offline; "
                         "load a state_dict instead")
    block_type, layers, channels = resnet_spec[num_layers]
    return _NETS[version](_BLOCKS[version][block_type], layers, channels,
                          device=device, seed=seed, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
