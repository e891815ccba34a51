"""PyTorch/CUDA port of incubator_mxnet_tpu for one NVIDIA H100.

A second package beside the JAX one, with the same module layout and
names; the JAX package stays the reference it is tested against.  It
imports torch and numpy, never jax and nothing of incubator_mxnet_tpu.
Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; every hand-written kernel (``csrc/``) is built with
nvcc at first use, and on a CPU tensor its wrapper runs the kernel's
plain PyTorch version instead.

Ported so far: the generation server (``gluon.TransformerDecoder``,
``serving.GenerationEngine``, the flash-attention forward kernel),
ResNet V1 inference (``gluon.model_zoo.vision``, ``predict.
BlockPredictor``, ``serving.ModelServer``, the fused BN -> ReLU -> conv
kernels of ``ops.fused_conv``), ResNet V1 training
(``parallel.TrainStep`` with bf16 compute, gradient accumulation and
the ``numerics.LossScaler``, ``parallel.EvalStep``, the tensor-level
layers of ``gluon.nn._modules``, ``optimizer.SGD``, the bottleneck-chain
kernels of ``ops.fused_chain``), the imperative front end: ``nd``
(``NDArray`` over ``torch.Tensor`` and the op registry), ``autograd``
(over ``torch.autograd``), ``random``, and ``rtc.CudaModule`` (user
CUDA C compiled at run time with NVRTC), and Gluon over ``NDArray``
(``gluon.Block`` / ``HybridBlock``, ``Parameter``, ``Trainer``, the
``gluon.nn`` layers and ``gluon.loss``, ``initializer`` as ``init``,
``lr_scheduler``, ``metric``; the model zoo's ResNet also takes
NDArrays and offers ``collect_params``), the data pipeline
(``recordio``, ``io`` with ``ImageRecordIter``, ``image``,
``gluon.data`` with its vision datasets and transforms,
``gluon.contrib.data``, and ``pipeline_io.DevicePrefetchIter`` /
``MetricDrain``), ResNet V2, the serving remainder
(``ServingConfig``'s ``full_policy``/``watchdog_s``, bf16
``BlockPredictor``), and the symbolic API (``symbol`` as ``sym`` with
its graph passes, ``executor.Executor``, ``operator.CustomOp``,
``module`` as ``mod``, ``model`` with ``FeedForward``, ``callback``,
``monitor``, ``attribute.AttrScope``, the symbol ``predict.Predictor``
and its ``ModelServer`` backend, ``gluon.SymbolBlock``), and the
recurrent family (the fused ``RNN`` op, cuDNN's on the card,
``gluon.rnn``, ``gluon.contrib.rnn``, the legacy ``rnn`` cells with
``BucketSentenceIter``) with every optimizer of the JAX package, and
the detection stack: the whole vision zoo (VGG, AlexNet, DenseNet,
SqueezeNet, Inception V3 and BN, MobileNet) with ``get_model`` and
``gluon.contrib.nn``, the contrib ops (the MultiBox family and box NMS,
CTC with ``gluon.loss.CTCLoss``, Proposal, PSROIPooling, deformable
convolution, fft, quantize) as ``nd.contrib`` / ``sym.contrib``, and
the linalg ops as ``nd.linalg`` / ``sym.linalg``, and data
parallelism: ``kvstore`` as ``kv`` (the local, mesh ``"tpu"`` and
``"dist_*"`` stores over ``torch.distributed``, with gradient
compression), ``parallel.DeviceMesh`` / ``make_mesh``, ``TrainStep`` /
``EvalStep(mesh=...)`` with the BatchNorm statistics summed over the
``dp`` group, ``parallel.TrainCheckpoint``, and the Gluon ``Trainer``,
``Module`` and ``DevicePrefetchIter`` over them; and model parallelism
on the same steps and ``predict.BlockPredictor(mesh=)``: the
tensor-parallel layers, ``MoELayer`` and the MoE functions over ``ep``,
``PipelineStack`` (GPipe over ``pp``) and Ulysses and ring attention
over ``sp``, their collectives written out in ``ops.collective``.  So
``import incubator_mxnet_tpu_torch as mx; mx.nd.ones((2,))`` reads as
it does against the JAX package, except that the default context is
``mx.gpu(0)``.
"""
from . import (base, context, convert, gluon, numerics, ops, optimizer,
               parallel, predict, serving)
from . import contrib, image, io, pipeline_io, recordio
from . import ndarray
from . import ndarray as nd
from . import autograd, initializer, lr_scheduler, metric, name, random, rtc
from . import initializer as init
from . import attribute, callback, executor, model, monitor, operator
from . import kvstore
from . import kvstore as kv
from . import telemetry
from . import symbol
from . import symbol as sym
from . import module
from . import module as mod
from . import rnn
from .attribute import AttrScope
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_devices, num_gpus, num_tpus, tpu)
from .executor import Executor

__version__ = "0.1.0"

__all__ = ["AttrScope", "Context", "Executor", "MXNetError", "attribute",
           "autograd", "base", "callback", "context", "contrib", "convert",
           "cpu", "cpu_pinned", "current_context", "executor", "gluon",
           "gpu", "image", "init", "initializer", "io", "kv", "kvstore",
           "lr_scheduler", "metric", "mod", "model", "module", "monitor",
           "name", "nd", "ndarray", "num_devices", "num_gpus", "num_tpus",
           "numerics", "operator", "ops", "optimizer", "parallel",
           "pipeline_io", "predict", "random", "recordio", "rnn", "rtc",
           "serving", "sym", "symbol", "telemetry", "tpu"]
