"""On-card smoke test of the PyTorch port (incubator_mxnet_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

It builds every hand-written kernel from ``incubator_mxnet_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version
on the card, then drives the port's main paths, each with the kernels'
launch counts set to 0 just before it and read just after:

* the continuous-batching generation server at GPT-2-small widths
  (vocab 50257, dim 768, 12 heads, 12 layers, max_len 1024), checked
  against the same weights on the CPU, then the same traffic under
  torch.profiler; then its paged stages (phase ``generation_stages``):
  the prefix cache, on by default, with speculative decoding (K=4, a
  2-layer self-draft) over 8 prompts that share a 512-token lead, then
  the same 8 again (terminal prefix hits, no prefill) and one sampled
  prompt twice, held token for token against the plain engine; and
  chunked prefill (256-token chunks, with spec) of one 1000-token prompt
  with 7 short ones submitted after it, whose first tokens must come
  first, held against the chunk-only engine and, for the two shortest,
  the CPU;
* ResNet-50 v1 inference (He et al. 2016, 224x224, 1000 classes;
  ``fuse_block=True``, channels-last) through ``ModelServer`` over
  ``BlockPredictor`` at ``max_batch=32``: a burst of 224 images from 8
  client threads and 4 batch requests, every result held against a
  direct forward, the logits against the same weights on the CPU, then
  the same burst under torch.profiler;
* ResNet-50 v1 training (the same widths, ``fuse_block="chain"``)
  through ``parallel.TrainStep`` with softmax cross-entropy and SGD
  (lr 0.1, momentum 0.9, wd 1e-4) on one resident batch of 128 images:
  ``run_steps`` windows, one step held against the same step on the CPU
  (b=2), the trained net's eval logits against the CPU's, one window
  under torch.profiler; then a few steps of ``fuse_block=True``
  training at b=32, which go through the fused conv kernels;
* ResNet-50 v1 training in ``bench.py:main``'s accelerator
  configuration: ``mxu_stem=True``, ``fuse_bn_relu=True`` (``BNReLU``),
  channels-last, ``TrainStep(bf16_compute=True)`` at b=128, in
  ``run_steps`` windows taken in turns with the same net built
  ``fuse_bn_relu=False``, one window under torch.profiler, and one b=2
  bf16 step held against the CPU; then the same with
  ``BENCH_FUSE_BLOCK=chain`` (``fuse_block="chain"``: the bf16 forms of
  the chain kernels, 16 launches each a step), in windows taken in turns
  with the bench net, profiled, and one b=2 bf16 step held against the
  CPU's plain versions; bf16 ``fuse_block=True``, ``"1x1"`` and
  ``"chain34"`` at b=32 (the bf16 forms of B1-B4); fp32
  ``fuse_block="chain34"`` at b=128 (the chain kernels on stages 3 and
  4), fp32 ``fuse_block="1x1"`` at b=32 (the 1x1 kernel in train form),
  ``TrainStep(bf16_compute=True, grad_accum=2, loss_scaler=...)`` at
  b=64 with one overflowed step that must change nothing, and
  ``EvalStep`` in fp32 (the chain net) and bf16 (the bench net, and the
  bf16 chain net against its direct forward);
* the imperative ``mx.nd`` / ``mx.autograd`` path at the width of
  ResNet-50 v1's classifier (2048 -> 1000, a batch of 1024 feature
  rows): 20 steps of FullyConnected -> log_softmax -> pick -> mean
  under ``autograd.record()``, ``backward()``, and the SGD update
  ``w += -lr * w.grad`` by the reference's rtc example kernel ``axpy``,
  compiled at run time through ``mx.rtc.CudaModule`` (NVRTC), one
  launch per parameter; held against the same loop with the ``nd``
  update on the card and on the CPU, then ``nd.save`` on the card and
  ``nd.load`` on the CPU, and 5 steps under torch.profiler;
* Gluon over NDArray: B1-B4 through ``nd._FusedBNReluConv`` and
  ``nd._FusedBottleneckChain`` at ResNet-50 stage-2 widths (phase
  ``kernels_gluon``: launches, plain versions, the moving-statistic
  fold); ResNet-50's stage-2 bottleneck with a classifier head written
  as JAX Gluon code (a HybridBlock over ``FusedBNReLUConv2D`` and a
  deferred ``Dense``, Xavier, ``gluon.Trainer`` with a FactorScheduler,
  metrics), 3 steps at b=32 held against the CPU (``gluon_layers``); and
  ResNet-50 v1 (``fuse_block=True``) trained through
  ``gluon.Trainer(net.collect_params(), "sgd", ...)`` at b=32, its first
  step held against ``TrainStep`` (``gluon_train``).  The kernel line
  gives each kernel's launches on these two paths
  (``launches_gluon``);
* the data pipeline (phase ``data_train``): 1536 seeded 256x256 images
  written as JPEG records with an ``.idx`` into a temporary directory,
  read by ``io.ImageRecordIter`` (224x224 random crops and mirrors,
  uint8 NHWC, 8 decode threads; OpenCV, else PIL, else the same images
  through ``io.NDArrayIter``, the choice printed), staged on the card by
  ``DevicePrefetchIter`` (depth 2, or 0 in the epochs taken without it),
  cast and normalised on the card by ``uint8_input_prep``, training
  bench.py's net with ``BENCH_FUSE_BLOCK=chain`` in bf16 at b=128 through
  ``run_steps(drain=MetricDrain())``: four epochs (prefetch on, off, off,
  on), the resident step beside them, the decode time of a batch, one
  profiled fed window; B3/B4's bf16 forms 16 times a step;
* ResNet-50 v2 (``fuse_block=True``) served in bf16 (phase
  ``resnet_v2_serving``): ``BlockPredictor`` (bf16 by default on the
  card) under ``ModelServer(ServingConfig(max_batch=32, queue_depth=64,
  full_policy="block", watchdog_s=2.0))``, the same burst with
  ``queue_depth()`` sampled, held against direct forwards, the fp32
  predictor and the CPU; B1/B2's bf16 forms as many times a forward as
  the net has fused layers inside their envelope (16 and 13); and a
  blocking server of queue depth 1.  The kernel line gives each
  kernel's launches on these two paths (``launches_data``);
* the symbolic API: examples/train_imagenet.py's ResNet-50 v2 symbol
  (NCHW, fp32, SoftmaxOutput; its builder copied below) trained through
  ``mx.mod.Module(net, context=mx.gpu(0)).fit`` with the example's
  settings for one epoch of data_train's records read by
  ``ImageRecordIter`` (phase ``symbolic_train``: then resident steps,
  one profiled, and one b=2 step held against the CPU); its checkpoint
  served by ``load_checkpoint_predictor`` under ``ModelServer``
  (``symbolic_serving``: V1 serving's burst, served vs direct, Predictor
  vs Module); and the same weights in the NHWC graph whose BN -> ReLU ->
  conv nodes are ``_FusedBNReluConv`` (``symbolic_fused``: B1 33 and B2
  13 times a b=32 forward, the logits against the unfused graph's, each
  kernel at the path's shapes against its plain version).  The kernel
  line gives each kernel's launches on these three paths
  (``launches_symbolic``);
* the recurrent family: the ``RNN`` op (cuDNN against its plain
  composition), examples/word_language_model.py's tied 650-wide LSTM
  LM through ``gluon.Trainer("adam")``, and lstm_bucketing.py's
  bucketed LSTMs through ``BucketingModule`` (``launches_recurrent``);
* the rest of the model zoo and the detection stack
  (``launches_detection``): the 21 zoo models beyond ResNet by
  ``get_model`` at full width, a b=8 forward each, the first of each
  family against the CPU, Inception V3 behind ``ModelServer``
  (``zoo_models``); SSD-300 on VGG16-reduced (8732 anchors, 21
  classes, 300x300, b=32) trained with examples/train_ssd.py's recipe
  on seeded scenes, one b=2 step against the CPU, ``MultiBoxDetection``
  on the card against the CPU and its fast NMS against the plain scan,
  then the example's compact SSD with its own asserts (``ssd_train``);
  and the contrib and linalg ops at their users' geometry (CTC behind
  ctc_ocr.py's OCRNet, Faster R-CNN's Proposal, R-FCN's PSROIPooling, a
  512-channel deformable conv, fft, quantize, linalg) against the CPU,
  forward and gradient (``contrib_ops``).  No kernel lies on these
  paths: their counts are 0;
* sparse storage, the spatial, image, indexing and random ops
  (``launches_sparse_image``): examples/matrix_factorization.py's
  MFBlock at ml-10m's id ranges (71,569 x 65,135, factor 128) trained
  with the example's recipe through ``gluon.Trainer``'s lazy row_sparse
  updates (Adam, then SGD with momentum and AdaGrad), the rows no batch
  touched checked bit for bit, one step against the CPU
  (``sparse_mf``); examples/linear_classification.py's loop over
  ``LibSVMIter`` CSR batches at the avazu setting (1,000,001 features,
  b=8192), both dots on the card (``sparse_linear``);
  examples/wide_deep.py through ``TrainStep`` with its asserts
  (``wide_deep``); Fast R-CNN's ROI head on VGG-16 at 2 x 600x1000 with
  128 rois each, ROIPooling against the CPU, then
  examples/fast_rcnn_roi.py with its asserts (``fast_rcnn``); FlowNetC's
  Correlation, FlowNet2's warp and a SpatialTransformer against the CPU
  (``spatial_ops``); a b=32 uint8 batch through the ``nd.image``
  augmentations into one ResNet-50 v1 forward, B1 and B2 16 times each
  (``image_ops``); and gather/scatter_nd and the samplers
  (``indexing_random_ops``).  B1/B2 launch only in ``image_ops``;
* data parallelism (``launches_dist``): an NCCL world of one rank in
  this process (phase ``dist_world1``): ``kv.create("dist_sync")`` push
  and pull over ResNet-50's parameter-sized gradients, and one bf16
  ``TrainStep(mesh=make_mesh(dp=1))`` step equal bit for bit to the same
  step with no mesh; then two ranks on the one card over ``gloo``
  (``tools/launch.py -n 2`` running ``tools/port_dist_worker.py``):
  ResNet-50 v1 in bench.py's protocol split over the ranks (b=64 a rank,
  global 128, bf16, ``fuse_bn_relu=True`` with ``fuse_block=True``, then
  ``fuse_block="chain"``) through ``TrainStep(mesh=make_mesh(dp=2))``
  for 5 steps, the ranks bit-equal after every step, the result held
  against one process on the global batch within the bf16 gate of
  ``phase_bf16_reference``, each rank's B1-B4 launches equal to one
  process's (``dist_two_ranks``); ``gluon.Trainer(kvstore="dist_sync")``
  with 2-bit compression (its wire bytes 1/16 of the fp32 bytes plus
  the padding), ``Module.fit(kvstore="dist_sync")`` and a
  ``TrainCheckpoint`` resume equal bit for bit to an uninterrupted run
  (``dist_trainer``).  Two ranks time-share one card: their times are
  not scaling numbers;
* model parallelism (``launches_model_parallel``): B5 through
  ``flash_attention``'s autograd Function (``flash_grad``: the output
  and dq/dk/dv against the plain route at b=2, 12 heads, T=1024, d=64,
  causal); the decoder-only LM of examples/transformer_lm.py at GPT-2
  small width (vocab 50257, d 768, 12 heads, FFN 3072, T=1024; Adam lr
  0.003, softmax cross-entropy, its Markov batches) in one process with
  no mesh at depth 12, b=4, 3 steps, and at depth 2 one forward and
  backward on the card against the CPU (``lm_train``); then worlds of
  two ranks on the one card over gloo (``tools/port_mp_worker.py``),
  one per axis, the LM at depth 2, b=4, 3 steps: ``tp=2`` (qkv, fc1
  and head column parallel, proj and fc2 row parallel, the embedding
  vocab-split) with ``BlockPredictor(mesh=)`` after, ``sp=2`` with
  Ulysses through B5 and with ring attention, ``ep=2`` (the MoE form,
  4 experts, top 2), ``pp=2`` (embedding and head split over pp around
  a 2-stage ``PipelineStack``, 4 microbatches) (``mp_two_ranks``), and
  four ranks on ``tp=2 x pp=2`` (``mp_four_ranks``); each held to one
  process on the card on the same batch and weights, the ranks bit-equal
  on the replicated parameters, each sharded one holding its block,
  the flash launches a rank as expected, each collective's route
  printed;
* telemetry (``mx.telemetry``): the registry is reset with the kernel
  counts, and each path's counts are held against its own bookkeeping
  (``telemetry`` keys: generation and its stages, the four serving
  bursts, ``resnet_train_bench``, ``data_train``, ``dist_world1``);
  ``telemetry_cost`` times the imperative step and the GPT-2-small
  decode iteration with telemetry on and off in turns and prints each
  median and their ratio; ``moe_zero_gate`` holds ``moe_ffn``'s tie
  rule (a zero gate) card vs CPU, and ``group2ctx`` a bind with one
  group's arrays on the CPU and one on the card against the one-device
  bind.

The rtc user kernels (``axpy``, a per-row sum that stages its row in
more than 48 KB of dynamic shared memory, and a ``scale_add`` template
exported as ``scale_add<float>`` and ``scale_add<double>``) are
defined below with their plain ``mx.nd`` versions beside them; they
compile with ``--fmad=false``, so each multiply and add rounds once,
as the plain versions' separate ops do.

Weights are random from ``--seed``.  Each phase prints one JSON line;
any failed check exits non-zero.  The last three lines are the card's
name and power limit as nvidia-smi reports them, the kernel table, and
``{"ok": true, "device": {...}}``.

The conv and chain kernels B1-B4 have two forms, fp32 and bf16 (bf16
data, weights and output; fp32 affines, bias and sums), each held
against its plain version in its own dtype and listed apart in the
kernel line (``sbr_matmul`` and ``sbr_matmul_bf16``, ...).

Timings: CUDA events around many back-to-back launches divided by the
count (flash inputs warm in L2, as a prefill finds them right after its
QKV projection; the conv and chain kernels' stage-1 tensors exceed L2).
``bound_ms`` is the larger of the bytes the function must move (each
input read once, each output written once) over 3.35 TB/s and the
operations it needs on these inputs over the card's least time for
them: fp32-accurate products at 495 / 3 TFLOP/s (3xTF32 on the tensor
cores), bf16 products at 989 TFLOP/s (dense bf16; NVIDIA H100 SXM data
sheet).  TF32 is off throughout for PyTorch's own calls; the kernels'
3xTF32 keeps fp32's accuracy.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
# the card's least time for fp32-accurate products: 3xTF32 on the
# tensor cores (three TF32 products per fp32 one, 495 TFLOP/s dense),
# above the 67 TFLOP/s of fp32 on the CUDA cores.  A bound is a property
# of the work, so every GEMM-shaped kernel is held to this one.
FP32_ACCURATE_FLOPS_PER_S = 495e12 / 3
# dense bf16 on the tensor cores (NVIDIA H100 SXM data sheet): the bound
# of the kernels' bf16 forms
BF16_FLOPS_PER_S = 989e12
# the kernels B1-B4's two forms, by the suffix of their names in the
# kernel line
FORMS = {torch.float32: "", torch.bfloat16: "_bf16"}
# bf16 kernel vs plain, in bf16 ulps of max |out|: both round the same
# activations to bf16 and their fp32 sums, which differ in order only,
# to the bf16 output, so an element may land one ulp apart (B4: a y2
# element too)
BF16_KERNEL_ULPS = 2
KERNEL_ATOL = 1e-4      # kernel vs plain, both fp32, other summation order
LOGITS_ATOL = 1e-3      # card vs CPU logits through 12 fp32 layers
# conv kernels vs plain (cuBLAS / cuDNN fp32), relative to max |out|:
# sums of up to 9*512 products in another order (~1e-6 expected)
CONV_RTOL = 1e-4
# ResNet-50 logits, relative to max |logit|: served vs direct forward
# (other batch sizes, so other cuDNN algorithms) and card vs CPU
# (cuDNN and the kernels vs oneDNN, 53 fp32 layers)
RESNET_RTOL = 1e-4
RESNET50 = dict(classes=1000, layout="NHWC", fuse_block=True)
IMAGE = (224, 224, 3)
MAX_BATCH = 32
CLIENTS, PER_CLIENT, BATCH_REQS, BATCH_SIZE = 8, 24, 4, 8
BURST_REQUESTS = CLIENTS * PER_CLIENT + BATCH_REQS     # one _burst's
# ResNet-50 v1's fused boundaries at batch 32: (N, H, W, C, Cout), and
# how many bottlenecks of one forward run each shape
CONV1X1_SHAPES = [(32, 56, 56, 64, 256), (32, 28, 28, 128, 512),
                  (32, 14, 14, 256, 1024), (32, 7, 7, 512, 2048)]
CONV3X3_SHAPES = [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
                  (32, 14, 14, 256, 256), (32, 7, 7, 512, 512)]
BLOCKS_PER_STAGE = (3, 4, 6, 3)
# H != W, W = 7, few channels, Cout not a multiple of the tiles, and C
# = 6 or 7: rows of x not 16-byte aligned (element copies; C = 20 too in
# bf16)
RAGGED_SHAPES = [(2, 9, 10, 16, 24), (3, 7, 7, 16, 40), (1, 5, 13, 8, 130),
                 (2, 7, 7, 20, 70), (2, 6, 9, 6, 36), (2, 5, 6, 7, 9)]
# ResNet-50 v1's chain blocks at the training batch of 128: (N, H, W, C,
# Cm, Co), C = Cm the conv1 output; BLOCKS_PER_STAGE of them per step
TRAIN_BATCH = 128
CHAIN_SHAPES = [(128, 56, 56, 64, 64, 256), (128, 28, 28, 128, 128, 512),
                (128, 14, 14, 256, 256, 1024), (128, 7, 7, 512, 512, 2048)]
# H != W, W = 7, channels that are not tile multiples, rows not 16-byte
# aligned (C = 6 for c1 and w2, Cm = 130, 70 for chain_emit's w3), M
# not a multiple of the row tiles, Cm at the envelope's edge; with
# CHAIN_SHAPES, every tile choice of each kernel
CHAIN_RAGGED = [(2, 9, 10, 16, 24, 40), (3, 7, 7, 16, 40, 70),
                (1, 5, 13, 8, 130, 33), (2, 7, 7, 20, 70, 130),
                (3, 57, 55, 20, 72, 130), (1, 7, 7, 16, 768, 64),
                (2, 68, 68, 8, 768, 40), (2, 6, 9, 6, 36, 20)]
# bf16 only: Cm past the fp32 form's envelope, up to the bf16 one's edge
# (chain_emit's 48-row tile), and C = 7, Cm = 9, Co = 11 (odd widths:
# element copies, scalar stores)
CHAIN_RAGGED_BF16 = [(1, 7, 7, 16, 1536, 64), (2, 5, 6, 7, 9, 11)]
# chain_stats vs plain: sums of up to 401408 terms in other orders,
# relative to the sum of the terms' magnitudes
CHAIN_STATS_RTOL = 1e-5
STRESS_VAR_RTOL = 2e-2  # shifted var2 vs fp64 at mean/std ~4e3
TRAIN_WINDOWS, TRAIN_WINDOW_STEPS = 2, 5
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
# one training step, card vs CPU (b=2 at 224x224).  The loss and the
# moving statistics come from the forward, which fp32 reproduces to a
# few ulps: within STEP_RTOL (relative; of each tensor's largest
# magnitude, plus STEP_ATOL).  The parameters' updates come from a
# gradient through 53 BatchNorms of a randomly initialised net at b=2,
# which amplifies rounding chaotically: two fp32 formulations of the
# same math on one CPU (the chain's plain kernels and the unfused
# layers) already differ by ~3x the STEP_RTOL bound on some tensors.  So
# the card's worst parameter (in units of that bound) must lie within
# SPREAD_FACTOR of the worst of that CPU-vs-CPU spread (and passes
# outright within the bound).
STEP_LOSS_RTOL, STEP_RTOL, STEP_ATOL, SPREAD_FACTOR = 1e-4, 1e-4, 1e-6, 3.0
FUSED_TRAIN_BATCH, FUSED_TRAIN_STEPS = 32, 3
# bench.py:main's accelerator configuration (bench.py:238-249):
# resnet50_v1(mxu_stem=True, fuse_bn_relu=True, fuse_block=False) under
# TrainStep(bf16_compute=True), channels-last (the port's mxu_stem is
# the plain strided stem conv)
BENCH_NET = dict(RESNET50, fuse_block=False, fuse_bn_relu=True,
                 mxu_stem=True)
# the same with BENCH_FUSE_BLOCK=chain: the chain kernels' bf16 forms on
# all 16 bottlenecks
BENCH_CHAIN_NET = dict(BENCH_NET, fuse_block="chain")
# bench.py's other BENCH_FUSE_BLOCK modes in bf16, a few steps each at
# b=32, with the launches a step of each bf16 kernel form
BF16_MODES_BATCH, BF16_MODES_STEPS = 32, 3
BF16_MODES = {True: dict(sbr_matmul_bf16=16, sbr_conv3x3_bf16=16),
              "1x1": dict(sbr_matmul_bf16=16),
              "chain34": dict(chain_stats_bf16=9, chain_emit_bf16=9)}
# one bf16 step, card vs CPU (b=2 at 224x224).  bf16's 8-bit significand
# through 53 BatchNorms at b=2 sets how far two computations of the step
# agree, so the step is held per leaf on what it moved: each parameter's
# change against the CPU's change of it, |d_card - d_cpu| / |d_cpu| (L2
# norms), within BF16_STEP_FACTOR of the median over the leaves of the
# same measure between two bf16 formulations on the CPU (BNReLU against
# BatchNorm then ReLU).  On an NVIDIA H100 80GB HBM3 at 700 W that
# median is 0.49 (at most 0.61) and the card's worst leaf 0.50, 1.02x
# the median; a leaf left unmoved is 1.0 off and a step on half the
# batch 0.90 to 1.38, so the factor is 1.5 (0.74) and the phase checks
# that both of those planted faults fail.  Leaves whose gradient is 0 to
# within rounding carry bf16 noise only and are left out, by a rule on
# the CPU's gradient: the gradient part of the change (d + lr * wd * w)
# of an fp32 step at most BF16_NOISE_GRAD of the bf16 step's (5e-4 for
# the biases of the bottlenecks' first and last convs, which feed a
# BatchNorm; >= 0.88 for every other leaf).  The moving statistics' worst
# leaf (in units of its largest magnitude) must lie within
# BF16_SPREAD_FACTOR of that spread's worst (1.31x measured), the loss
# within BF16_LOSS_RTOL (four bf16 steps at the loss's magnitude).
BF16_STEP_FACTOR, BF16_NOISE_GRAD = 1.5, 2.0 ** -8
BF16_SPREAD_FACTOR, BF16_LOSS_RTOL = 3.0, 2.0 ** -5
BF16_FROZEN = "features.6.0.body.1.conv.weight"
# "chain34": the chain where the 3x3 has >= 256 channels, ResNet-50's
# stages 3 and 4 (6 + 3 bottlenecks); BNReLU bottlenecks elsewhere
CHAIN34_BLOCKS, CHAIN34_STEPS = 9, 3
ONE_BY_ONE_BATCH, ONE_BY_ONE_STEPS = 32, 3
OPTIONS_BATCH, OPTIONS_STEPS, OPTIONS_ACCUM = 64, 3, 2
# EvalStep against the same forward called directly: the same kernels on
# the same inputs (fp32); bf16 EvalStep against fp32 EvalStep of one
# net, relative to max |logit| (bf16's rounding through 53 layers:
# 4.0e-3 of max on an NVIDIA H100 80GB HBM3 at 700 W)
EVAL_RTOL, BF16_EVAL_RTOL = 1e-6, 2e-2
# steps of a training profile's windows (reading a window's events back
# is the costly part of a profile phase, seconds a step)
PROFILE_STEPS = 1
EVAL_BATCH = 32
GPT2_SMALL = dict(vocab=50257, dim=768, heads=12, depth=12, max_len=1024)
PROMPT_LENGTHS = (9, 16, 33, 100, 250, 511, 700, 1000)
SAMPLED_LEN, SAMPLED_TWICE = 40, 2  # one sampled prompt, submitted twice
MAX_NEW = 16
# generation_stages: 8 greedy prompts sharing a 512-token lead (32 full
# blocks) with distinct tails, each tail leaving a partial block; the
# prefix engine runs spec with a 2-layer self-draft
STAGES_LEAD, STAGES_NEW = 512, 32
STAGES_TAILS = (40, 75, 110, 150, 190, 230, 265, 300)
STAGES_SPEC_K, STAGES_DRAFT = 4, 2
# the chunked engine: one long prompt, then 7 short ones just after it
CHUNK, CHUNK_LONG, CHUNK_NEW = 256, 1000, 16
CHUNK_SHORTS = (20, 35, 50, 70, 90, 110, 130)

# ---- rtc user kernels (compiled through mx.rtc.CudaModule) and their
# plain mx.nd versions.  --fmad=false: no multiply-add contraction, so a
# kernel rounds as its plain version's separate ops do (1 ulp bounds).
RTC_OPTIONS = ("--fmad=false",)
RTC_BLOCK = 256
AXPY_SRC = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += alpha * x[i];
}
"""
AXPY_SIG = "const float *x, float *y, float alpha, int n"


def axpy_plain(x, y, alpha):
    """The value axpy leaves in y: y + alpha * x."""
    return y + alpha * x


# one block of RTC_BLOCK threads per row: the row is staged in dynamic
# shared memory (cols floats), then RTC_BLOCK partial sums after it
ROW_SUM_SRC = r"""
extern "C" __global__ void row_sum(const float *x, float *out, int cols) {
  extern __shared__ float buf[];
  float *part = buf + cols;
  const float *row = x + (size_t)blockIdx.x * cols;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) buf[j] = row[j];
  __syncthreads();
  float s = 0.f;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) s += buf[j];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}
"""
ROW_SUM_SIG = "const float *x, float *out, int cols"


def row_sum_plain(x):
    """The per-row sums row_sum writes: x.sum(axis=1)."""
    return x.sum(axis=1)


def row_sum_shared_bytes(cols):
    return (cols + RTC_BLOCK) * 4


SCALE_ADD_SRC = r"""
template <typename T>
__global__ void scale_add(const T *x, const T *y, T *o, T alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = alpha * x[i] + y[i];
}
"""
SCALE_ADD_EXPORTS = ("scale_add<float>", "scale_add<double>")


def scale_add_plain(x, y, alpha):
    """The value scale_add writes to o: alpha * x + y."""
    return alpha * x + y


# (rows, cols) of the row sums: the second stages 66.5 KB of shared
# memory, above the 48 KB a launch gets without cuFuncSetAttribute
ROW_SUM_SHAPES = ((1024, 2048), (512, 16384))
SCALE_ADD_N = (1 << 20) + 7
RTC_RTOL = {"float32": 1e-6, "float64": 1e-15}  # 1 ulp, relative
ROW_SUM_RTOL = 1e-5     # of the row's mass sum|x|: other summation order
# the imperative path: ResNet-50 v1's classifier (Dense 2048 -> 1000)
FEATURES, CLASSES = 2048, 1000
IMPERATIVE_BATCH, IMPERATIVE_STEPS, IMPERATIVE_PROFILE_STEPS = 1024, 20, 5
IMPERATIVE_LR = 0.5
# rtc update vs nd update, both on the card: bit-identical arithmetic,
# so any difference is far below 1e-6 of each tensor's max
RTC_VS_ND_RTOL = 1e-6
# card vs CPU after 20 steps: cuBLAS vs oneDNN sum orders in fp32
CARD_VS_CPU_RTOL = 1e-4


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since start."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _T0, 3))
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Device time of one call of fn: the CUDA kernel time torch.profiler
    records over iters calls, over iters.  Unlike time_ms it leaves out
    the host's time between launches, which sets time_ms for small
    launches.  Raises when the profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail("torch.profiler recorded no CUDA kernel")
    return sum(e.self_device_time_total for e in kernels) / iters / 1e3


def flash_bound_ms(b, h, t, d, causal):
    """Least time for attention forward on these shapes: q, k, v read
    and o written once (fp32); QK^T and PV at 2 flops per multiply-add
    over the (i, j) pairs the mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * b * h * pairs * d
    nbytes = 4.0 * b * h * t * d * 4
    t_ops = flops / FP32_ACCURATE_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    smi = None
    if shutil.which("nvidia-smi"):
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        smi = proc.stdout.strip().splitlines()[0] if proc.stdout else None
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(names):
    from incubator_mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build(names, verbose=True)
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3),
          "built": sorted(logs), "ptxas": ptxas})


def prefill_buckets():
    """{T: prefills} of one smoke generation run: the bucket each prompt
    of ``_serve``'s traffic prefills at, as the engine of ``_engine``
    picks it."""
    from collections import Counter
    from incubator_mxnet_tpu_torch.serving.generation import \
        GenerationConfig
    cfg = GenerationConfig(slots=8, max_len=GPT2_SMALL["max_len"],
                           block_size=16)
    lengths = list(PROMPT_LENGTHS) + [SAMPLED_LEN] * SAMPLED_TWICE
    return dict(sorted(Counter(cfg.bucket_for(n) for n in lengths).items()))


def phase_kernels():
    """Flash-attention forward: kernel vs its plain version at every
    prefill bucket of the generation path (B=1, H=12, D=64, T in the
    buckets; timed with SDPA and the bound, causal as the prefill runs
    it, and full), plus small D=32/128 and ragged-tile cases.  The
    path's total sums the causal times over one smoke generation run:
    12 layers x the prefills at each bucket.  At each bucket the kernel's
    and SDPA's device time are read from torch.profiler too: the small
    buckets' launches are bound by host time."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.parallel.flash_attention import (
        _flash_plain, flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(0)
    buckets = prefill_buckets()
    heads, depth = GPT2_SMALL["heads"], GPT2_SMALL["depth"]
    head_dim = GPT2_SMALL["dim"] // heads
    shapes = [(1, 12, 16, 64), (1, 12, 128, 64), (1, 12, 1024, 64),
              (2, 4, 64, 32), (1, 2, 96, 128), (3, 2, 80, 16)]
    shapes += [(1, heads, t, head_dim) for t in buckets
               if (1, heads, t, head_dim) not in shapes]
    # ragged against the kernel's 64-row q tiles and 32/64-key tiles
    shapes += [(2, 3, 48, 64), (1, 2, 208, 128), (1, 2, 144, 32),
               (2, 2, 16, 16)]
    rows, worst = [], 0.0
    for b, h, t, d in shapes:
        q, k, v = (torch.randn((b, h, t, d), device="cuda", generator=gen)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        blk = min(32, t) if t % 32 == 0 else 16
        for causal in (True, False):
            out = flash_attention(q, k, v, causal=causal, block_q=blk,
                                  block_k=blk)
            ref = _flash_plain(q, k, v, causal, scale)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"flash kernel gave non-finite values at "
                     f"{(b, h, t, d)} causal={causal}")
            err = (out - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            worst = max(worst, err)
            row = {"shape": [b, h, t, d], "causal": causal,
                   "max_abs_err": err, "max_rel_err": rel}
            if d == 64:
                row["kernel_ms"] = time_ms(lambda: flash_attention(
                    q, k, v, causal=causal, block_q=blk, block_k=blk))
                row["plain_ms"] = time_ms(
                    lambda: _flash_plain(q, k, v, causal, scale))
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, scale=scale))
                row["bound_ms"], row["bound_by"] = flash_bound_ms(
                    b, h, t, d, causal)
            rows.append(row)
            if err > KERNEL_ATOL:
                fail(f"flash kernel disagrees with its plain version at "
                     f"{(b, h, t, d)} causal={causal}: {err} > "
                     f"{KERNEL_ATOL}")
    prefill = {t: next(r for r in rows
                       if r["shape"] == [1, heads, t, head_dim]
                       and r["causal"]) for t in buckets}
    for t, row in prefill.items():
        q, k, v = (torch.randn((1, heads, t, head_dim), device="cuda",
                               generator=gen) for _ in range(3))
        row["kernel_device_ms"] = device_ms(
            lambda: flash_attention(q, k, v, causal=True))
        row["library_device_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    per_run = {key: depth * sum(n * prefill[t][key]
                                for t, n in buckets.items())
               for key in ("kernel_ms", "plain_ms", "library_ms",
                           "bound_ms", "kernel_device_ms",
                           "library_device_ms")}
    emit({"phase": "kernels", "kernel": "flash_attention_fwd",
          "atol": KERNEL_ATOL, "rows": rows,
          "prefill_buckets": buckets, "per_run": per_run})
    ref = prefill[1024]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "incubator_mxnet_tpu/parallel/flash_attention.py:27",
            "max_abs_err": worst, "ms": ref["kernel_ms"],
            "plain_ms": ref["plain_ms"], "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"], "library_ms": ref["library_ms"],
            "per": "one launch at B1 H12 T1024 D64 causal",
            "per_run_ms": per_run,
            "per_run": f"{depth} layers x the prefills of one smoke "
                       f"generation run, by bucket {buckets}"}


def _bound(flops, nbytes, dtype):
    """(least ms, what bounds it) for ``flops`` of products in ``dtype``
    (fp32: 3xTF32, bf16: dense bf16) and ``nbytes`` moved."""
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else \
        FP32_ACCURATE_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def conv_bound_ms(n, h, w, c, cout, taps, dtype=torch.float32):
    """Least time for relu(x*a + b) through a stride-1 conv with
    ``taps`` taps plus bias: x, a, b, the weight and the bias read and
    the output written once (x, the weight and the output in ``dtype``,
    a, b and the bias fp32); 2 flops per multiply-add."""
    size = torch.finfo(dtype).bits // 8
    flops = 2.0 * n * h * w * cout * c * taps
    nbytes = size * (n * h * w * (c + cout) + cout * c * taps) + \
        4.0 * (2 * c + cout)
    return _bound(flops, nbytes, dtype)


def bf16_ulp(v):
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def _gate(name, dtype, err, scale, where):
    """The kernel-vs-plain gate of an output: fp32 CONV_RTOL of max
    |out|, bf16 BF16_KERNEL_ULPS ulps of max |out|; returns the limit."""
    limit = BF16_KERNEL_ULPS * bf16_ulp(scale) if dtype == torch.bfloat16 \
        else CONV_RTOL * scale
    if err > limit:
        fail(f"{name} ({dtype}) disagrees with its plain version at "
             f"{where}: {err} > {limit} (max |out| {scale})")
    return limit


def _conv_case(gen, n, h, w, c, cout, taps):
    cl = torch.channels_last
    k = 3 if taps == 9 else 1
    x = torch.randn((n, c, h, w), device="cuda", generator=gen).contiguous(
        memory_format=cl)
    a = torch.rand((c,), device="cuda", generator=gen) + 0.5
    b = torch.randn((c,), device="cuda", generator=gen) * 0.1
    wt = (torch.randn((cout, c, k, k), device="cuda", generator=gen)
          * math.sqrt(2.0 / (c * taps))).contiguous(memory_format=cl)
    bias = torch.randn((cout,), device="cuda", generator=gen) * 0.1
    return x, a, b, wt, bias


def phase_kernels_conv():
    """The fused BN -> ReLU -> conv kernels, in both forms, against their
    plain versions at ResNet-50 v1's eight fused shapes at batch 32
    (timed, with the unfused cuDNN composition in the same dtype as
    yardstick) and at ragged shapes (H != W, W = 7, few channels, Cout
    not a multiple of the tiles, rows that are not 16-byte aligned)."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels = {}
    for name, taps, shapes, plain in (
            ("sbr_matmul", 1, CONV1X1_SHAPES, fc._sbr_matmul_plain),
            ("sbr_conv3x3", 9, CONV3X3_SHAPES, fc._sbr_conv3x3_plain)):
        kern = getattr(fc, name)
        rows = {dt: [] for dt in FORMS}
        for shape in shapes + RAGGED_SHAPES:
            case = _conv_case(gen, *shape, taps)
            for dt in FORMS:
                x, a, b, wt, bias = case
                x, wt = x.to(dt), wt.to(dt)
                out = kern(x, a, b, wt, bias)
                ref = plain(x, a, b, wt, bias)
                torch.cuda.synchronize()
                if not out.is_contiguous(memory_format=torch.channels_last) \
                        or out.dtype != dt:
                    fail(f"{name} output is not channels-last {dt} at "
                         f"{shape}")
                if not torch.isfinite(out).all():
                    fail(f"{name} ({dt}) gave non-finite values at {shape}")
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                row = {"shape": list(shape), "max_abs_err": err,
                       "ref_abs_max": scale,
                       "limit": _gate(name, dt, err, scale, shape)}
                if shape in shapes:
                    pad = 1 if taps == 9 else 0
                    a16, b16, bias16 = (v.to(dt) for v in (a, b, bias))

                    def unfused():
                        y = torch.relu(x * a16.view(1, -1, 1, 1)
                                       + b16.view(1, -1, 1, 1))
                        return F.conv2d(y, wt, bias16, padding=pad)

                    row["kernel_ms"] = time_ms(
                        lambda: kern(x, a, b, wt, bias))
                    row["plain_ms"] = time_ms(
                        lambda: plain(x, a, b, wt, bias))
                    row["library_ms"] = time_ms(unfused)
                    row["bound_ms"], row["bound_by"] = conv_bound_ms(
                        *shape, taps, dt)
                rows[dt].append(row)
        for dt in FORMS:
            key = name + FORMS[dt]
            emit({"phase": "kernels_conv", "kernel": key,
                  "dtype": str(dt), "gate": "1e-4 of max |out|"
                  if dt == torch.float32 else
                  f"{BF16_KERNEL_ULPS} bf16 ulps of max |out|",
                  "library": "F.conv2d(relu(x*a+b), w, bias): unfused "
                             f"cuDNN, {dt}", "rows": rows[dt]})
            # one b=32 forward runs each path shape once per bottleneck
            timed = rows[dt][:len(shapes)]
            per_fwd = {k: sum(n * r[k] for n, r in
                              zip(BLOCKS_PER_STAGE, timed))
                       for k in ("kernel_ms", "plain_ms", "library_ms",
                                 "bound_ms")}
            source = "3x3" if taps == 9 else "1x1"
            line = 58 if taps == 9 else 49
            kernels[key] = {
                "name": key, "route": "cuda",
                "source": f"incubator_mxnet_tpu_torch/csrc/{name}.cu",
                "replaces": f"incubator_mxnet_tpu/ops/fused_conv.py:{line}",
                "max_abs_err": max(r["max_abs_err"] for r in rows[dt]),
                "ms": per_fwd["kernel_ms"], "plain_ms": per_fwd["plain_ms"],
                "bound_ms": per_fwd["bound_ms"],
                "bound_by": timed[0]["bound_by"],
                "library_ms": per_fwd["library_ms"],
                "per": f"the 16 fused {source} boundaries of one b=32 "
                       f"ResNet-50 forward, {dt}"}
        torch.cuda.empty_cache()
    return kernels


def _burst(server, images):
    """The ResNet traffic: CLIENTS threads of PER_CLIENT single-image
    submits and BATCH_REQS submit_batch calls of BATCH_SIZE, all at
    once.  Returns (outputs in image order, end-to-end ms per request,
    wall seconds)."""
    import threading
    singles = CLIENTS * PER_CLIENT
    futs, lat = [None] * (CLIENTS + BATCH_REQS), []
    lock = threading.Lock()

    def watch(submit, *args):
        t_sub = time.perf_counter()
        fut = submit(*args)

        def done(_):
            with lock:
                lat.append((time.perf_counter() - t_sub) * 1e3)
        fut.add_done_callback(done)
        return fut

    def client(i):
        futs[i] = [watch(server.submit, images[i * PER_CLIENT + j])
                   for j in range(PER_CLIENT)]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for k in range(BATCH_REQS):
        lo = singles + k * BATCH_SIZE
        futs[CLIENTS + k] = [watch(server.submit_batch,
                                   images[lo:lo + BATCH_SIZE])]
    for t in threads:
        t.join()
    outs = [f.result(timeout=600) for group in futs for f in group]
    wall = time.perf_counter() - t0
    got = np.concatenate([np.stack(outs[:singles])] + outs[singles:])
    return got, lat, wall


def phase_resnet_serving(seed):
    """ResNet-50 v1 at full width and depth through ModelServer: warmup
    over every bucket, then the burst with the kernel counts set to 0
    just before it and read just after."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.ops import sbr_conv3x3, sbr_matmul
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    from incubator_mxnet_tpu_torch.predict import BlockPredictor
    from incubator_mxnet_tpu_torch.serving import ModelServer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **RESNET50)
    # fp32, as this phase has always measured it (BlockPredictor's default
    # on the card is bf16; phase resnet_v2_serving runs that)
    pred = BlockPredictor(net, bf16_compute=False)
    server = ModelServer(pred, max_batch=MAX_BATCH, input_shapes=[IMAGE])
    server.warmup()
    setup_s = time.perf_counter() - t0
    n_images = CLIENTS * PER_CLIENT + BATCH_REQS * BATCH_SIZE
    images = np.random.RandomState(seed).rand(n_images, *IMAGE).astype(
        np.float32)
    flash_before = flash_attention.launches
    before = server._counters()
    sbr_matmul.launches = sbr_conv3x3.launches = 0
    _telemetry().reset()
    got, lat, wall = _burst(server, images)
    launches = {"sbr_matmul": sbr_matmul.launches,
                "sbr_conv3x3": sbr_conv3x3.launches}
    tel, own = _serving_held("resnet_serving", server, before, BURST_REQUESTS)
    forwards = tel["serving.batch.count"]
    if forwards < 1 or any(v != 16 * forwards for v in launches.values()):
        fail(f"ResNet path launched {launches} over {forwards} forwards; "
             f"expected 16 x forwards of each kernel")
    if flash_attention.launches != flash_before:
        fail("the ResNet path launched the flash kernel")
    if got.shape != (n_images, 1000) or not np.isfinite(got).all():
        fail(f"bad served logits: shape {got.shape}")
    direct = pred.predict(images, batch_size=MAX_BATCH).cpu().numpy()
    err = float(np.abs(got - direct).max())
    scale = float(np.abs(direct).max())
    if err > RESNET_RTOL * scale:
        fail(f"served logits differ from direct forwards by {err} > "
             f"{RESNET_RTOL} x {scale}")
    # per-bucket costs: host-to-device copy of a padded batch, and the
    # forward on device-resident input
    fwd_ms, h2d_ms = {}, {}
    with torch.inference_mode():
        for bsz in (1, MAX_BATCH):
            host = images[:bsz].copy()
            dev = torch.from_numpy(host).cuda()
            h2d_ms[bsz] = _host_ms(lambda: torch.from_numpy(host).cuda())
            fwd_ms[bsz] = time_ms(lambda: net(dev), iters=10, warmup=2)
    lat.sort()
    emit({"phase": "resnet_serving", "images": n_images,
          "requests": len(lat), "wall_s": wall,
          "images_per_s": n_images / wall, "batches": forwards,
          "mean_fill": own["examples"] / own["padded"],
          "e2e_p50_ms": lat[len(lat) // 2],
          "e2e_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
          "exec_s": own["exec_s"], "telemetry": tel,
          "forward_ms": fwd_ms, "h2d_copy_ms": h2d_ms,
          "launches": launches, "served_vs_direct_max_abs_err": err,
          "logits_abs_max": scale, "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, net, server, images


def _host_ms(fn, iters=10):
    """Host clock around ``fn`` ending in a synchronise (a copy from
    pageable memory returns only when it is done)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_resnet_reference(net, images, seed):
    """The same weights on the CPU (the plain path), 2 images at 224x224:
    logits within RESNET_RTOL of max |logit|."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    cpu = get_resnet(1, 50, device="cpu", seed=seed, **RESNET50).eval()
    cpu.load_state_dict(net.state_dict())
    x = images[:2]
    with torch.inference_mode():
        lg_gpu = net(torch.from_numpy(x).cuda()).cpu()
        lg_cpu = cpu(torch.from_numpy(x))
    if not torch.isfinite(lg_gpu).all():
        fail("non-finite ResNet logits on the card")
    err = (lg_gpu - lg_cpu).abs().max().item()
    scale = lg_cpu.abs().max().item()
    emit({"phase": "resnet_reference", "logits_max_abs_err": err,
          "logits_abs_max": scale, "rtol": RESNET_RTOL,
          "argmax_equal": bool(torch.equal(lg_gpu.argmax(1),
                                           lg_cpu.argmax(1)))})
    if err > RESNET_RTOL * scale:
        fail(f"card vs CPU ResNet logits differ by {err} > {RESNET_RTOL} "
             f"x {scale}")


# kernel kinds of a profile, by the first pattern in a kernel's name
KERNEL_KINDS = (("conv_gemm", ("conv", "cudnn", "xmma", "gemm", "cutlass",
                               "sm90_", "sm80_", "tc::", "chain")),
                ("reduction", ("reduce_kernel",)),
                ("copy_cast", ("copy", "Memcpy", "Memset")),
                ("elementwise", ("elementwise",)))


def _kind(name):
    for kind, patterns in KERNEL_KINDS:
        if any(p in name for p in patterns):
            return kind
    return "other"


def _profile_summary(prof, wall):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    by_kind = {}
    for e in kernels:
        kind = _kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0) + e.self_device_time_total / 1e3
    return {"wall_s": wall,
            "device_busy_s": busy_s if kernels else "not measured",
            "device_idle_share": 1 - busy_s / wall if kernels
            else "not measured",
            "device_ms_by_kind": by_kind,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def phase_resnet_profile(server, images):
    """The same burst again under torch.profiler: the device's busy and
    idle share of the wall, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = _burst(server, images)
    emit(dict({"phase": "resnet_profile"}, **_profile_summary(prof, wall)))


def chain_bound_ms(n, h, w, c, cm, co, emit, dtype=torch.float32):
    """Least time for a chain pass on these shapes: c1, the affines, the
    weights read and the output (``out`` for emit, the two sums for
    stats) written once (c1, the weights and ``out`` in ``dtype``, the
    affines, b3 and the sums fp32); conv2 (and conv3 for emit) at 2
    flops per multiply-add."""
    size = torch.finfo(dtype).bits // 8
    m = n * h * w
    flops = 2.0 * m * cm * (9 * c + (co if emit else 0))
    if emit:
        nbytes = size * (m * (c + co) + 9 * c * cm + cm * co) + \
            4.0 * (2 * c + 2 * cm + co)
    else:
        nbytes = size * (m * c + 9 * c * cm) + 4.0 * (2 * c + 3 * cm)
    return _bound(flops, nbytes, dtype)


def _chain_case(gen, n, h, w, c, cm, co):
    cl = torch.channels_last

    def vec(k, lo, hi):
        return torch.rand((k,), device="cuda", generator=gen) * (hi - lo) + lo
    x = torch.randn((n, c, h, w), device="cuda", generator=gen).contiguous(
        memory_format=cl)
    w2 = (torch.randn((cm, c, 3, 3), device="cuda", generator=gen)
          * math.sqrt(2.0 / (9 * c))).contiguous(memory_format=cl)
    w3 = (torch.randn((co, cm, 1, 1), device="cuda", generator=gen)
          * math.sqrt(2.0 / cm)).contiguous(memory_format=cl)
    return dict(x=x, a1=vec(c, 0.5, 1.5), b1=vec(c, -0.1, 0.1), w2=w2,
                shift=vec(cm, -0.5, 0.5), a2=vec(cm, 0.5, 1.5),
                b2=vec(cm, -0.1, 0.1), w3=w3, b3=vec(co, -0.1, 0.1))


def _stress_var2():
    """The JAX package's shifted-variance stress case (its
    tests/test_fused_chain.py) through chain_stats on the card: BN2's
    batch mean ~4e3 standard deviations from 0.  Returns var2's largest
    relative error against fp64, shifted by the moving mean (must be
    within STRESS_VAR_RTOL) and unshifted (the raw form, which fails)."""
    from incubator_mxnet_tpu_torch.ops.fused_chain import chain_stats
    rs = np.random.RandomState(7)
    n, h, w, c, cm = 4, 16, 16, 16, 8

    def fp32(a):            # the values the kernel sees, kept in fp64
        return np.asarray(a, np.float32).astype(np.float64)
    c1 = fp32(rs.randn(n, h, w, c))
    mean1, var1 = c1.mean((0, 1, 2)), c1.var((0, 1, 2))
    a1 = fp32(1.0 / np.sqrt(var1 + 1e-5))
    b1 = fp32(1000.0 - mean1 * a1)
    w2 = np.zeros((cm, c, 3, 3))
    w2[:, :, 1, 1] = fp32(0.1 + 0.001 * rs.randn(cm, c))
    c2 = np.einsum("nhwc,mc->nhwm", np.maximum(c1 * a1 + b1, 0),
                   w2[:, :, 1, 1])
    mean_ref, var_ref = c2.mean((0, 1, 2)), c2.var((0, 1, 2))
    x = torch.from_numpy(c1.astype(np.float32)).cuda().permute(0, 3, 1, 2)
    args = [torch.from_numpy(v.astype(np.float32)).cuda()
            for v in (a1, b1)]
    w2t = torch.from_numpy(w2.astype(np.float32)).cuda().contiguous(
        memory_format=torch.channels_last)
    errs = []
    for shift in (mean_ref * 1.003, np.zeros(cm)):
        s = torch.from_numpy(shift.astype(np.float32)).cuda()
        sums, sqs = chain_stats(x, *args, w2t, s)
        count = n * h * w
        mean_d = sums.double() / count
        var2 = torch.clamp(sqs.double() / count - mean_d.square(), min=0)
        errs.append(float(np.max(np.abs(var2.cpu().numpy() - var_ref)
                                 / var_ref)))
    return errs


def phase_kernels_chain():
    """The chain kernels, in both forms, against their plain versions at
    ResNet-50 v1's four chain shapes at batch 128 (timed, with the
    unfused cuDNN composition in the same dtype as yardstick), at
    ragged shapes, and (chain_stats, fp32) at the shifted-variance
    stress case; chain_stats run twice must be bit-identical."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import fused_chain as fc
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = [n + f for f in FORMS.values()
             for n in ("chain_stats", "chain_emit")]
    rows = {n: [] for n in names}
    for shape in CHAIN_SHAPES + CHAIN_RAGGED + CHAIN_RAGGED_BF16:
        t = _chain_case(gen, *shape)
        timed = shape in CHAIN_SHAPES
        for dt, suffix in FORMS.items():
            if shape in CHAIN_RAGGED_BF16 and dt != torch.bfloat16:
                continue
            x, w2, w3 = t["x"].to(dt), t["w2"].to(dt), t["w3"].to(dt)
            a1, b1, s = t["a1"], t["b1"], t["shift"]
            a2, b2, b3 = t["a2"], t["b2"], t["b3"]
            lib = {k: t[k].to(dt).view(1, -1, 1, 1)
                   for k in ("a1", "b1", "shift", "a2", "b2")}
            # pass 1
            sums, sqs = fc.chain_stats(x, a1, b1, w2, s)
            again = fc.chain_stats(x, a1, b1, w2, s)
            ref_sum, ref_sq = fc._chain_stats_plain(x, a1, b1, w2, s)
            d = fc._conv2_sums(x, a1, b1, w2) - s.view(1, -1, 1, 1)
            mass = d.abs().sum((0, 2, 3))
            del d
            torch.cuda.synchronize()
            same = bool(torch.equal(sums, again[0]) and
                        torch.equal(sqs, again[1]))
            err = max((sums - ref_sum).abs().max().item(),
                      (sqs - ref_sq).abs().max().item())
            rel = max(((sums - ref_sum).abs() / mass).max().item(),
                      ((sqs - ref_sq).abs() / ref_sq).max().item())
            row = {"shape": list(shape), "max_abs_err": err,
                   "max_rel_err": rel, "bit_identical": same}
            if not (torch.isfinite(sums).all() and
                    torch.isfinite(sqs).all()):
                fail(f"chain_stats ({dt}) gave non-finite sums at {shape}")
            if not same:
                fail(f"chain_stats ({dt}) is not deterministic at {shape}")
            if rel > CHAIN_STATS_RTOL:
                fail(f"chain_stats ({dt}) disagrees with its plain version "
                     f"at {shape}: {rel} > {CHAIN_STATS_RTOL} of the sums' "
                     f"mass")
            if timed:
                def unfused_stats():
                    dd = F.conv2d(torch.relu(x * lib["a1"] + lib["b1"]), w2,
                                  padding=1) - lib["shift"]
                    return dd.sum((0, 2, 3)), dd.square().sum((0, 2, 3))
                row["kernel_ms"] = time_ms(
                    lambda: fc.chain_stats(x, a1, b1, w2, s))
                row["plain_ms"] = time_ms(
                    lambda: fc._chain_stats_plain(x, a1, b1, w2, s))
                row["library_ms"] = time_ms(unfused_stats)
                row["bound_ms"], row["bound_by"] = chain_bound_ms(
                    *shape, emit=False, dtype=dt)
            rows["chain_stats" + suffix].append(row)
            # pass 2
            out = fc.chain_emit(x, a1, b1, w2, a2, b2, w3, b3)
            ref = fc._chain_emit_plain(x, a1, b1, w2, a2, b2, w3, b3)
            torch.cuda.synchronize()
            if not out.is_contiguous(memory_format=torch.channels_last) or \
                    out.dtype != dt:
                fail(f"chain_emit output is not channels-last {dt} at "
                     f"{shape}")
            if not torch.isfinite(out).all():
                fail(f"chain_emit ({dt}) gave non-finite values at {shape}")
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            row = {"shape": list(shape), "max_abs_err": err,
                   "ref_abs_max": scale,
                   "limit": _gate("chain_emit", dt, err, scale, shape)}
            if timed:
                b316 = b3.to(dt)

                def unfused_emit():
                    c2 = F.conv2d(torch.relu(x * lib["a1"] + lib["b1"]), w2,
                                  padding=1)
                    return F.conv2d(torch.relu(c2 * lib["a2"] + lib["b2"]),
                                    w3, b316)
                row["kernel_ms"] = time_ms(lambda: fc.chain_emit(
                    x, a1, b1, w2, a2, b2, w3, b3))
                row["plain_ms"] = time_ms(lambda: fc._chain_emit_plain(
                    x, a1, b1, w2, a2, b2, w3, b3))
                row["library_ms"] = time_ms(unfused_emit)
                row["bound_ms"], row["bound_by"] = chain_bound_ms(
                    *shape, emit=True, dtype=dt)
            rows["chain_emit" + suffix].append(row)
            del x, w2, w3, out, ref
        del t
        torch.cuda.empty_cache()
    shifted, raw = _stress_var2()
    if shifted > STRESS_VAR_RTOL:
        fail(f"chain_stats' shifted var2 is {shifted} off fp64 at the "
             f"stress case (> {STRESS_VAR_RTOL})")
    if raw <= 0.05:
        fail(f"the stress case does not stress: the unshifted var2 is "
             f"only {raw} off fp64")
    kernels = {}
    for dt, suffix in FORMS.items():
        for name, line in (("chain_stats", "emit=False"),
                           ("chain_emit", "emit=True")):
            key = name + suffix
            gate = (f"{CHAIN_STATS_RTOL} of the sums' mass, bit-identical"
                    if name == "chain_stats" else "1e-4 of max |out|"
                    if dt == torch.float32 else
                    f"{BF16_KERNEL_ULPS} bf16 ulps of max |out|")
            emit({"phase": "kernels_chain", "kernel": key, "dtype": str(dt),
                  "gate": gate,
                  "library": f"unfused cuDNN {dt}: F.conv2d(relu(x*a1+b1), "
                             "w2) " + ("then the two sums of (c2 - s)"
                                       if name == "chain_stats" else
                                       "then F.conv2d(relu(c2*a2+b2), w3, "
                                       "b3)"),
                  "stress_var2_rel_err": {"shifted": shifted,
                                          "unshifted": raw}
                  if key == "chain_stats" else None,
                  "rows": rows[key]})
            timed = rows[key][:len(CHAIN_SHAPES)]
            per_step = {k: sum(n * r[k] for n, r in
                               zip(BLOCKS_PER_STAGE, timed))
                        for k in ("kernel_ms", "plain_ms", "library_ms",
                                  "bound_ms")}
            kernels[key] = {
                "name": key, "route": "cuda",
                "source": f"incubator_mxnet_tpu_torch/csrc/{name}.cu",
                "replaces": "incubator_mxnet_tpu/ops/fused_chain.py:56",
                "max_abs_err": max(r["max_abs_err"] for r in rows[key]),
                "ms": per_step["kernel_ms"],
                "plain_ms": per_step["plain_ms"],
                "bound_ms": per_step["bound_ms"],
                "bound_by": timed[0]["bound_by"],
                "library_ms": per_step["library_ms"],
                "per": f"the 16 chain blocks of one b={TRAIN_BATCH} "
                       f"ResNet-50 training step ({line}), {dt}"}
    return kernels


def _wrappers():
    """Every kernel wrapper, by the kernel's name in the kernel line
    (rtc counts the launches of all its kernels in one module-level
    count)."""
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.ops import (chain_emit, chain_stats,
                                               sbr_conv3x3, sbr_matmul)
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    return {"flash_attention_fwd": flash_attention,
            "sbr_matmul": sbr_matmul, "sbr_conv3x3": sbr_conv3x3,
            "chain_stats": chain_stats, "chain_emit": chain_emit,
            "rtc_axpy": rtc}


def _counts():
    """Launches by kernel name: B1-B4's fp32 and bf16 forms apart (their
    wrappers count both forms in ``launches``, the bf16 one in
    ``launches_bf16``)."""
    counts = {}
    for name, fn in _wrappers().items():
        bf16 = getattr(fn, "launches_bf16", None)
        counts[name] = fn.launches - (bf16 or 0)
        if bf16 is not None:
            counts[name + FORMS[torch.bfloat16]] = bf16
    return counts


def _zero_counts():
    """Every kernel launch count, and the port's telemetry registry, to
    0."""
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
    _telemetry().reset()


def _telemetry():
    from incubator_mxnet_tpu_torch import telemetry
    return telemetry


def _held(phase, got, want):
    """Each telemetry reading ``got[name]`` equals the path's own count
    ``want[name]``; returns the readings."""
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        fail(f"{phase}: telemetry differs from the path's own counts "
             f"(telemetry, own): {bad}")
    return {k: got[k] for k in want}


def _serving_held(phase, server, before, requests):
    """A burst's ``serving.*`` telemetry (the registry reset just before
    it) against the server's own counts since ``before`` (its
    ``_counters()``): the batches, the ``requests`` sent, one e2e
    latency each, no error, rejection or expiry.  Returns (the telemetry
    readings, the server's own counts since ``before``)."""
    stats, own = server.stats(), server._counters()
    delta = {k: own[k] - before[k] for k in
             ("batches", "examples", "padded", "errors", "exec_s")}
    tel = _held(phase, dict(stats, e2e=stats["serving.e2e.us"]["count"]), {
        "serving.batch.count": delta["batches"],
        "serving.request.count": requests, "e2e": requests,
        "serving.error.count": delta["errors"],
        "serving.reject.count": 0, "serving.expire.count": 0})
    return tel, delta


def _train_step(net, **kw):
    from incubator_mxnet_tpu_torch.gluon.nn._modules import (
        SoftmaxCrossEntropyLoss)
    from incubator_mxnet_tpu_torch.optimizer import SGD
    from incubator_mxnet_tpu_torch.parallel import TrainStep
    return TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                     device=next(net.parameters()).device, **kw)


def _train_batch(seed, n):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, *IMAGE).astype(np.float32),
            rs.randint(0, 1000, n).astype(np.float32))


def _resident(seed, n):
    x, y = _train_batch(seed, n)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _finite(losses, what):
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite {what} losses: {losses}")


def _expect(launches, want, what):
    if launches != want:
        fail(f"{what} launched {launches}, expected {want}")


def phase_resnet_train(seed):
    """ResNet-50 v1 training, fuse_block="chain", through TrainStep on a
    resident batch of TRAIN_BATCH at 224x224: one warm-up step, then
    TRAIN_WINDOWS run_steps windows of TRAIN_WINDOW_STEPS, with the
    kernel counts set to 0 just before the windows and read just
    after."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = get_resnet(1, 50, device="cuda:0", seed=seed,
                     **dict(RESNET50, fuse_block="chain"))
    step = _train_step(net)
    xd, yd = _resident(seed, TRAIN_BATCH)
    first = step(xd, yd).item()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _zero_counts()
    losses, window_s = [], []
    for _ in range(TRAIN_WINDOWS):
        t1 = time.perf_counter()
        out = step.run_steps(xd, yd, num_steps=TRAIN_WINDOW_STEPS)
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t1)
        losses += out.tolist()
    launches = _counts()
    steps = TRAIN_WINDOWS * TRAIN_WINDOW_STEPS
    want = dict.fromkeys(launches, 0)
    want.update(chain_stats=16 * steps, chain_emit=16 * steps)
    _expect(launches, want, f"the training path ({steps} steps)")
    _finite([first] + losses, "training")
    best = min(window_s)
    emit({"phase": "resnet_train", "batch": TRAIN_BATCH, "steps": steps,
          "window_steps": TRAIN_WINDOW_STEPS, "window_s": window_s,
          "images_per_s": TRAIN_BATCH * TRAIN_WINDOW_STEPS / best,
          "ms_per_step": best / TRAIN_WINDOW_STEPS * 1e3,
          "warmup_loss": first, "losses": losses, "launches": launches,
          "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, net, step, xd, yd


def _worst(got, ref, keys, rtol=STEP_RTOL):
    """The largest ``|got - ref|`` over ``keys`` in units of ``rtol`` of
    the tensor's largest magnitude plus STEP_ATOL, and its key."""
    worst, worst_key = 0.0, None
    for key in keys:
        r, g = ref[key], got[key].cpu()
        err = (g - r).abs().max().item()
        ratio = err / (rtol * r.abs().max().item() + STEP_ATOL)
        if ratio > worst:
            worst, worst_key = ratio, key
    return worst, worst_key


def phase_resnet_train_reference(seed):
    """One step of the same initial weights on one b=2 batch at 224x224,
    on the card and on the CPU (the plain path), and on the CPU once
    more through the unfused layers (fuse_block=False) for the spread of
    fp32 itself: the loss, every moving statistic and every updated
    parameter must agree (tolerances at STEP_LOSS_RTOL)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    gpu = get_resnet(1, 50, device="cuda:0", seed=seed + 1,
                     **dict(RESNET50, fuse_block="chain"))
    init = gpu.state_dict()
    cpus = {}
    for mode in ("chain", False):
        cpus[mode] = get_resnet(1, 50, device="cpu", seed=seed + 1,
                                **dict(RESNET50, fuse_block=mode))
        cpus[mode].load_state_dict(init)
    x, y = _train_batch(seed + 1, 2)
    t0 = time.perf_counter()
    loss_gpu = _train_step(gpu)(x, y).item()
    loss_cpu = _train_step(cpus["chain"])(x, y).item()
    _train_step(cpus[False])(x, y)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    got, ref, alt = (gpu.state_dict(), cpus["chain"].state_dict(),
                     cpus[False].state_dict())
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    params = [k for k in ref if k not in stats]
    stats_worst, stats_key = _worst(got, ref, stats)
    params_worst, params_key = _worst(got, ref, params)
    spread, spread_key = _worst(alt, ref, params)
    emit({"phase": "resnet_train_reference", "loss_card": loss_gpu,
          "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
          "loss_rtol": STEP_LOSS_RTOL, "rtol": STEP_RTOL, "atol": STEP_ATOL,
          "stats_worst_over_bound": stats_worst, "stats_worst": stats_key,
          "params_worst_over_bound": params_worst,
          "params_worst": params_key,
          "cpu_spread_worst_over_bound": spread, "cpu_spread_worst":
          spread_key, "spread_factor": SPREAD_FACTOR,
          "tensors": len(ref), "seconds": cpu_s})
    if not math.isfinite(loss_gpu) or loss_rel > STEP_LOSS_RTOL:
        fail(f"card vs CPU training loss {loss_gpu} vs {loss_cpu}")
    if stats_worst > 1.0:
        fail(f"card vs CPU moving statistics after one step: {stats_key} "
             f"is {stats_worst} x its bound off")
    if params_worst > max(1.0, SPREAD_FACTOR * spread):
        fail(f"card vs CPU parameters after one step: {params_key} is "
             f"{params_worst} x its bound off, the CPU's own spread "
             f"{spread}")


def phase_resnet_train_eval(net, seed):
    """The trained chain net in eval mode: card vs CPU logits on 2 images;
    one forward launches chain_emit 16 times and chain_stats never."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    net.eval()
    cpu = get_resnet(1, 50, device="cpu", seed=seed,
                     **dict(RESNET50, fuse_block="chain")).eval()
    cpu.load_state_dict(net.state_dict())
    x = torch.from_numpy(_train_batch(seed + 2, 2)[0])
    with torch.inference_mode():
        _zero_counts()
        lg_gpu = net(x.cuda())
        torch.cuda.synchronize()
        launches = _counts()
        lg_cpu = cpu(x)
    want = dict.fromkeys(launches, 0)
    want.update(chain_emit=16)
    _expect(launches, want, "one eval forward of the chain net")
    lg_gpu = lg_gpu.cpu()
    if not torch.isfinite(lg_gpu).all():
        fail("non-finite eval logits of the trained net on the card")
    err = (lg_gpu - lg_cpu).abs().max().item()
    scale = lg_cpu.abs().max().item()
    emit({"phase": "resnet_train_eval", "logits_max_abs_err": err,
          "logits_abs_max": scale, "rtol": RESNET_RTOL,
          "launches": launches,
          "argmax_equal": bool(torch.equal(lg_gpu.argmax(1),
                                           lg_cpu.argmax(1)))})
    if err > RESNET_RTOL * scale:
        fail(f"card vs CPU eval logits of the trained net differ by {err} "
             f"> {RESNET_RTOL} x {scale}")
    net.train()


RANGE = "smoke: "
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "


def _innermost(event, test):
    node = event
    while node is not None and not test(node.name):
        node = node.cpu_parent
    return node


@contextlib.contextmanager
def _source_ranges(step):
    """Profiler ranges, for ``_device_ms_by_source``, around every module
    call of ``step``'s block (named by the module's class) and around its
    optimizer's updates, removed on exit."""
    from torch.autograd.profiler import record_function
    open_ranges, handles = [], []

    def enter(module, _args):
        rf = record_function(RANGE + type(module).__name__)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(_module, _args, _out):
        open_ranges.pop().__exit__(None, None, None)

    for module in step._block.modules():
        handles += [module.register_forward_pre_hook(enter),
                    module.register_forward_hook(leave)]
    opt = step._optimizer
    update = opt.update

    def ranged_update(*args, **kw):
        with record_function(RANGE + "optimizer update"):
            return update(*args, **kw)

    opt.update = ranged_update
    try:
        yield
    finally:
        del opt.update
        for h in handles:
            h.remove()


def _device_ms_by_source(prof, top=20):
    """Device time of the kernels each op launched itself, by source: the
    innermost ``_source_ranges`` range (a module class, the optimizer's
    update), else the op's name (the step's own work: the bf16 casts,
    the loss scaler); for an op of the backward, ``backward:`` and the
    source of the forward op whose autograd node ran it (matched by
    sequence number), else the node's name."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]

    def source(e):
        rng = _innermost(e, lambda n: n.startswith(RANGE))
        return rng.name[len(RANGE):] if rng is not None else e.name

    def is_node(name):
        return name.startswith(AUTOGRAD_NODE)

    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and _innermost(e, is_node) is None:
            forward.setdefault(e.sequence_nr, source(e))
    by = {}
    for e in events:
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        node = _innermost(e, is_node)
        if node is None:
            key = source(e)
        else:
            key = "backward: " + forward.get(
                node.sequence_nr, node.name[len(AUTOGRAD_NODE):])
        by[key] = by.get(key, 0.0) + ms
    return dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])


def phase_resnet_train_profile(step, xd, yd, phase="resnet_train_profile",
                               by_source=False):
    """One short window of PROFILE_STEPS steps of a training path under
    torch.profiler: the device's busy and idle share, and the top
    kernels.  With ``by_source`` a second window, under
    ``_source_ranges`` (which slow the host, so the first window alone
    gives the idle share), splits the device time by where each kernel
    was launched from."""
    from torch.profiler import ProfilerActivity, profile
    steps = PROFILE_STEPS
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step.run_steps(xd, yd, num_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = dict({"phase": phase, "steps": steps},
               **_profile_summary(prof, wall))
    if by_source:
        with _source_ranges(step), profile(activities=activities) as prof:
            step.run_steps(xd, yd, num_steps=steps)
            torch.cuda.synchronize()
        row["device_ms_by_source"] = _device_ms_by_source(prof)
    emit(row)


def phase_fused_train(seed):
    """fuse_block=True training at FUSED_TRAIN_BATCH: the fused conv
    kernels in their train form, 16 launches each per step."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **RESNET50)
    step = _train_step(net)
    xd, yd = _resident(seed + 3, FUSED_TRAIN_BATCH)
    step(xd, yd)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = step.run_steps(xd, yd, num_steps=FUSED_TRAIN_STEPS).tolist()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(sbr_matmul=16 * FUSED_TRAIN_STEPS,
                sbr_conv3x3=16 * FUSED_TRAIN_STEPS)
    _expect(launches, want, "fuse_block=True training")
    _finite(losses, "fuse_block=True training")
    emit({"phase": "fused_train", "batch": FUSED_TRAIN_BATCH,
          "steps": FUSED_TRAIN_STEPS, "losses": losses,
          "ms_per_step": wall / FUSED_TRAIN_STEPS * 1e3,
          "launches": launches})
    return wall / FUSED_TRAIN_STEPS * 1e3


def phase_resnet_train_bench(seed):
    """bench.py:main's accelerator configuration: ResNet-50 v1 with
    fuse_bn_relu=True under TrainStep(bf16_compute=True), on a resident
    batch of TRAIN_BATCH at 224x224; beside it the same net with
    fuse_bn_relu=False (BatchNorm then ReLU) and the same weights.  One
    warm-up step each, then run_steps windows of TRAIN_WINDOW_STEPS in
    turns (BNReLU, plain, plain, BNReLU), each with its peak memory; the
    kernel counts set to 0 just before the windows, and no kernel of
    csrc/ or rtc on this path."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    nets, steps, warm = {}, {}, {}
    t0 = time.perf_counter()
    for fused in (True, False):
        nets[fused] = get_resnet(1, 50, device="cuda:0", seed=seed,
                                 **dict(BENCH_NET, fuse_bn_relu=fused))
        steps[fused] = _train_step(nets[fused], bf16_compute=True)
    xd, yd = _resident(seed + 4, TRAIN_BATCH)
    for fused in (True, False):
        warm[fused] = steps[fused](xd, yd).item()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    windows = {True: [], False: []}
    losses = {True: [], False: []}
    peak = {True: 0, False: 0}
    _zero_counts()
    for fused in (True, False, False, True):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = steps[fused].run_steps(xd, yd, num_steps=TRAIN_WINDOW_STEPS)
        torch.cuda.synchronize()
        windows[fused].append(time.perf_counter() - t1)
        peak[fused] = max(peak[fused], torch.cuda.max_memory_allocated())
        losses[fused] += out.tolist()
    launches = _counts()
    _expect(launches, dict.fromkeys(launches, 0),
            "the bf16 training path (BNReLU and plain)")
    # the resident batch is on the card: no byte crosses per step
    tel = _held("resnet_train_bench", _telemetry().report(as_dict=True),
                {"step.count": 4 * TRAIN_WINDOW_STEPS,
                 "transfer.h2d.bytes": 0})
    for fused in (True, False):
        _finite([warm[fused]] + losses[fused], "bf16 training")

    def row(fused):
        best = min(windows[fused])
        return {"window_s": windows[fused],
                "images_per_s": TRAIN_BATCH * TRAIN_WINDOW_STEPS / best,
                "ms_per_step": best / TRAIN_WINDOW_STEPS * 1e3,
                "warmup_loss": warm[fused], "losses": losses[fused],
                "peak_mem_gb": peak[fused] / 1e9}

    emit(dict({"phase": "resnet_train_bench", "batch": TRAIN_BATCH,
               "dtype": "bfloat16", "window_steps": TRAIN_WINDOW_STEPS,
               "setup_s": setup_s, "launches": launches,
               "telemetry": tel, "fuse_bn_relu_false": row(False)},
              **row(True)))
    return nets[True], steps[True], xd, yd


def _change_errs(got, ref, init, keys):
    """Per key, how far ``got`` moved from ``init`` other than ``ref``
    did: ``|d_got - d_ref| / |d_ref|`` over the changes ``d`` (L2)."""
    errs = {}
    for k in keys:
        d_got, d_ref = got[k].cpu() - init[k], ref[k] - init[k]
        errs[k] = ((d_got - d_ref).double().norm() /
                   d_ref.double().norm()).item()
    return errs


def phase_bf16_reference(seed, phase, net_kw, alt_kw):
    """One bf16 step of the net ``net_kw`` on one b=2 batch at 224x224,
    on the card and on the CPU (the kernels' plain versions), on the CPU
    once more as ``alt_kw`` says (another formulation of the same math)
    for the spread of bf16 itself, and once in fp32 for the rule that
    finds the leaves of zero gradient: the loss, the moving statistics
    and each parameter's change as set out at BF16_STEP_FACTOR; then two
    planted faults on the card (BF16_FROZEN left unmoved, a step on half
    the batch) must fail that check."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    gpu = get_resnet(1, 50, device="cuda:0", seed=seed, **net_kw)
    init = {k: v.detach().cpu().clone() for k, v in gpu.state_dict().items()}
    x, y = _train_batch(seed, 2)

    def stepped(device, frozen=None, n=2, bf16=True, **kw):
        net = get_resnet(1, 50, device=device, seed=seed,
                         **dict(net_kw, **kw))
        net.load_state_dict(init)
        if frozen:
            net.get_parameter(frozen).requires_grad_(False)
        loss = _train_step(net, bf16_compute=bf16)(x[:n], y[:n]).item()
        return loss, net.state_dict()

    t0 = time.perf_counter()
    loss_cpu, ref = stepped("cpu")
    alt = stepped("cpu", **alt_kw)[1]
    ref32 = stepped("cpu", bf16=False)[1]
    cpu_s = time.perf_counter() - t0
    loss_gpu, got = stepped("cuda:0")
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    params = [k for k in ref if k not in stats]
    lr_wd = SGD_KW["learning_rate"] * SGD_KW["wd"]
    noise = sorted(k for k in params if
                   (ref32[k] - init[k] + lr_wd * init[k]).norm() <=
                   BF16_NOISE_GRAD *
                   (ref[k] - init[k] + lr_wd * init[k]).norm())
    kept = [k for k in params if k not in noise]
    spread = _change_errs(alt, ref, init, kept)
    bound = BF16_STEP_FACTOR * float(np.median(list(spread.values())))
    errs = _change_errs(got, ref, init, kept)
    worst_key = max(errs, key=errs.get)
    faults = {"frozen": _change_errs(stepped("cuda:0", BF16_FROZEN)[1],
                                     ref, init, kept)[BF16_FROZEN],
              "half_batch": float(np.median(list(_change_errs(
                  stepped("cuda:0", n=1)[1], ref, init, kept).values())))}
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    stats_worst = _worst(got, ref, stats, rtol=1.0)
    stats_spread = _worst(alt, ref, stats, rtol=1.0)
    emit({"phase": phase, "dtype": "bfloat16", "alt": alt_kw,
          "loss_card": loss_gpu, "loss_cpu": loss_cpu,
          "loss_rel_err": loss_rel, "loss_rtol": BF16_LOSS_RTOL,
          "stats_worst_of_max": stats_worst,
          "stats_cpu_spread_of_max": stats_spread,
          "spread_factor": BF16_SPREAD_FACTOR,
          "leaves": len(params), "zero_gradient_leaves": len(noise),
          "change_err_worst": [errs[worst_key], worst_key],
          "change_err_median": float(np.median(list(errs.values()))),
          "cpu_spread_median": float(np.median(list(spread.values()))),
          "cpu_spread_max": max(spread.values()),
          "step_factor": BF16_STEP_FACTOR, "step_bound": bound,
          "planted_faults": faults, "cpu_seconds": cpu_s})
    if not math.isfinite(loss_gpu) or loss_rel > BF16_LOSS_RTOL:
        fail(f"card vs CPU bf16 training loss {loss_gpu} vs {loss_cpu}")
    if stats_worst[0] > BF16_SPREAD_FACTOR * stats_spread[0]:
        fail(f"card vs CPU bf16 moving statistics after one step: "
             f"{stats_worst} of max, the CPU's own spread {stats_spread}")
    if any(not k.endswith(("body.0.bias", "body.2.conv.bias"))
           for k in noise):
        fail(f"the zero-gradient rule left out other leaves than the "
             f"biases that feed a BatchNorm: {noise}")
    if errs[worst_key] > bound:
        fail(f"card vs CPU bf16 step: {worst_key} moved {errs[worst_key]} "
             f"of its change off, the bound {bound}")
    # the frozen leaf's own error, the half batch's median leaf
    for what, err in faults.items():
        if err <= bound:
            fail(f"the bf16 step check passes a planted fault ({what}: "
                 f"{err} <= {bound})")


def phase_resnet_train_bench_chain(seed, bench_step, xd, yd):
    """bench.py:main with BENCH_FUSE_BLOCK=chain: ResNet-50 v1 with
    fuse_block="chain" under TrainStep(bf16_compute=True) on the bench
    phase's resident batch of TRAIN_BATCH, beside the bench net
    (fuse_block=False): one warm-up step, then run_steps windows of
    TRAIN_WINDOW_STEPS in turns (chain, bench, bench, chain), each with
    its peak memory.  The kernel counts are set to 0 just before the
    windows: B3 and B4 launch their bf16 form 16 times a chain step, and
    nothing else of csrc/ or rtc runs."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    t0 = time.perf_counter()
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **BENCH_CHAIN_NET)
    steps = {"chain": _train_step(net, bf16_compute=True),
             "bench": bench_step}
    warm = steps["chain"](xd, yd).item()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    windows = {k: [] for k in steps}
    losses = {k: [] for k in steps}
    peak = dict.fromkeys(steps, 0)
    _zero_counts()
    for which in ("chain", "bench", "bench", "chain"):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = steps[which].run_steps(xd, yd, num_steps=TRAIN_WINDOW_STEPS)
        torch.cuda.synchronize()
        windows[which].append(time.perf_counter() - t1)
        peak[which] = max(peak[which], torch.cuda.max_memory_allocated())
        losses[which] += out.tolist()
    launches = _counts()
    n = 2 * TRAIN_WINDOW_STEPS
    want = dict.fromkeys(launches, 0)
    want.update(chain_stats_bf16=16 * n, chain_emit_bf16=16 * n)
    _expect(launches, want, f"the bf16 chain training path ({n} steps)")
    _finite([warm] + losses["chain"], "bf16 chain training")

    def row(which):
        best = min(windows[which])
        return {"window_s": windows[which],
                "images_per_s": TRAIN_BATCH * TRAIN_WINDOW_STEPS / best,
                "ms_per_step": best / TRAIN_WINDOW_STEPS * 1e3,
                "losses": losses[which], "peak_mem_gb": peak[which] / 1e9}

    emit(dict({"phase": "resnet_train_bench_chain", "batch": TRAIN_BATCH,
               "dtype": "bfloat16", "window_steps": TRAIN_WINDOW_STEPS,
               "setup_s": setup_s, "warmup_loss": warm,
               "launches": launches, "bench_fuse_block_false": row("bench")},
              **row("chain")))
    return net, steps["chain"], launches


def phase_resnet_train_bf16_modes(seed):
    """bench.py's other BENCH_FUSE_BLOCK modes (True, "1x1", "chain34")
    in bf16 at BF16_MODES_BATCH: per mode one warm-up step, then
    BF16_MODES_STEPS steps with the kernel counts set to 0 just before
    them, which must launch each bf16 kernel form as BF16_MODES says and
    nothing else.  Returns the fuse_block=True run's counts (B1 and B2's
    bf16 forms)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    xd, yd = _resident(seed + 10, BF16_MODES_BATCH)
    runs = {}
    for mode, per_step in BF16_MODES.items():
        net = get_resnet(1, 50, device="cuda:0", seed=seed,
                         **dict(BENCH_NET, fuse_block=mode))
        step = _train_step(net, bf16_compute=True)
        step(xd, yd)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        losses = step.run_steps(xd, yd, num_steps=BF16_MODES_STEPS).tolist()
        wall = time.perf_counter() - t0
        launches = _counts()
        want = dict.fromkeys(launches, 0)
        want.update({k: v * BF16_MODES_STEPS for k, v in per_step.items()})
        _expect(launches, want, f"bf16 fuse_block={mode!r} training")
        _finite(losses, f"bf16 fuse_block={mode!r} training")
        emit({"phase": "resnet_train_bf16_modes", "fuse_block": mode,
              "dtype": "bfloat16", "batch": BF16_MODES_BATCH,
              "steps": BF16_MODES_STEPS, "losses": losses,
              "ms_per_step": wall / BF16_MODES_STEPS * 1e3,
              "launches": launches})
        runs[mode] = launches
        del net, step
        torch.cuda.empty_cache()
    return runs[True]


def phase_resnet_train_chain34(seed):
    """fuse_block="chain34" training in fp32 at TRAIN_BATCH: the chain
    kernels on stages 3 and 4 (CHAIN34_BLOCKS launches of each a step),
    BNReLU on the bottlenecks before them."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    net = get_resnet(1, 50, device="cuda:0", seed=seed,
                     **dict(RESNET50, fuse_block="chain34"))
    step = _train_step(net)
    xd, yd = _resident(seed + 6, TRAIN_BATCH)
    step(xd, yd)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = step.run_steps(xd, yd, num_steps=CHAIN34_STEPS).tolist()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(chain_stats=CHAIN34_BLOCKS * CHAIN34_STEPS,
                chain_emit=CHAIN34_BLOCKS * CHAIN34_STEPS)
    _expect(launches, want, f"chain34 training ({CHAIN34_STEPS} steps)")
    _finite(losses, "chain34 training")
    emit({"phase": "resnet_train_chain34", "batch": TRAIN_BATCH,
          "steps": CHAIN34_STEPS, "losses": losses,
          "ms_per_step": wall / CHAIN34_STEPS * 1e3, "launches": launches})


def phase_resnet_train_1x1(seed):
    """fuse_block="1x1" training in fp32 at ONE_BY_ONE_BATCH: B1 in train
    form, one launch per bottleneck per forward (16), its 3x3 boundary
    a BNReLU; nothing else of csrc/ or rtc."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    net = get_resnet(1, 50, device="cuda:0", seed=seed,
                     **dict(RESNET50, fuse_block="1x1"))
    step = _train_step(net)
    xd, yd = _resident(seed + 7, ONE_BY_ONE_BATCH)
    step(xd, yd)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = step.run_steps(xd, yd, num_steps=ONE_BY_ONE_STEPS).tolist()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(sbr_matmul=16 * ONE_BY_ONE_STEPS)
    _expect(launches, want, f"1x1 training ({ONE_BY_ONE_STEPS} steps)")
    _finite(losses, "1x1 training")
    emit({"phase": "resnet_train_1x1", "batch": ONE_BY_ONE_BATCH,
          "steps": ONE_BY_ONE_STEPS, "losses": losses,
          "ms_per_step": wall / ONE_BY_ONE_STEPS * 1e3,
          "launches": launches})


def phase_train_step_options(seed):
    """TrainStep(bf16_compute=True, grad_accum=OPTIONS_ACCUM,
    loss_scaler=LossScaler()) on the bench net at OPTIONS_BATCH:
    OPTIONS_STEPS clean steps with finite losses and the scale
    unchanged, then one step on the batch with an inf in it, which must
    leave every parameter, momentum and moving statistic bit-identical
    and halve the scale."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.numerics import LossScaler
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **BENCH_NET)
    scaler = LossScaler()
    step = _train_step(net, bf16_compute=True, grad_accum=OPTIONS_ACCUM,
                       loss_scaler=scaler)
    xd, yd = _resident(seed + 8, OPTIONS_BATCH)
    losses = [step(xd, yd).item()]
    _zero_counts()
    t0 = time.perf_counter()
    losses += step.run_steps(xd, yd, num_steps=OPTIONS_STEPS).tolist()
    wall = time.perf_counter() - t0
    scale = step.loss_scale()
    _finite(losses, "bf16 grad_accum loss-scaled training")
    if scale != scaler.init_scale:
        fail(f"the loss scale moved to {scale} on clean steps")
    poisoned = xd.clone()
    poisoned[0, 0, 0, 0] = float("inf")
    before = [t.clone() for t in step._carry()]
    overflow_loss = step(poisoned, yd).item()
    after = step._carry()
    changed = sum(not torch.equal(a, b) for a, b in zip(after, before))
    launches = _counts()
    emit({"phase": "train_step_options", "batch": OPTIONS_BATCH,
          "grad_accum": OPTIONS_ACCUM, "steps": OPTIONS_STEPS,
          "losses": losses, "ms_per_step": wall / OPTIONS_STEPS * 1e3,
          "scale": scale, "overflow_loss": str(overflow_loss),
          "scale_after_overflow": step.loss_scale(),
          "carry_tensors": len(after), "carry_changed": changed,
          "launches": launches})
    _expect(launches, dict.fromkeys(launches, 0), "the options path")
    if changed:
        fail(f"the overflowed step changed {changed} of {len(after)} "
             "parameters, momenta and moving statistics")
    if step.loss_scale() != scale * scaler.backoff_factor:
        fail(f"the overflowed step left the scale at {step.loss_scale()}, "
             f"not {scale * scaler.backoff_factor}")
    phase_resnet_train_profile(step, xd, yd, "train_step_options_profile")


def phase_eval_step(chain_net, bench_net, bench_chain_net, seed):
    """EvalStep on the trained chain net (fp32): chain_emit 16 launches a
    call and nothing else, against net.eval()(x) within EVAL_RTOL of max
    |logit|; then EvalStep(bf16_compute=True) on the bench net against
    its fp32 EvalStep within BF16_EVAL_RTOL; then
    EvalStep(bf16_compute=True) on the trained bf16 chain net: chain_emit's
    bf16 form 16 launches a call and nothing else, against the forward
    of a bf16 copy of the net called directly, within EVAL_RTOL."""
    from incubator_mxnet_tpu_torch.parallel import EvalStep
    xd = torch.from_numpy(_train_batch(seed + 9, EVAL_BATCH)[0]).cuda()
    evaluate = EvalStep(chain_net)
    _zero_counts()
    got = evaluate(xd)
    torch.cuda.synchronize()
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(chain_emit=16)
    _expect(launches, want, "one chain-net EvalStep call")
    with torch.inference_mode():
        ref = chain_net.eval()(xd)
    chain_net.train()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    lg32 = EvalStep(bench_net)(xd)
    lg16 = EvalStep(bench_net, bf16_compute=True)(xd)
    err16 = (lg16.float() - lg32).abs().max().item()
    scale32 = lg32.abs().max().item()
    emit({"phase": "eval_step", "batch": EVAL_BATCH, "launches": launches,
          "max_abs_err": err, "logits_abs_max": scale, "rtol": EVAL_RTOL,
          "bf16_dtype": str(lg16.dtype), "bf16_max_abs_err": err16,
          "bf16_logits_abs_max": scale32, "bf16_rtol": BF16_EVAL_RTOL,
          "bf16_argmax_agree": (lg16.float().argmax(1) == lg32.argmax(1))
          .float().mean().item()})
    if not torch.isfinite(got).all() or err > EVAL_RTOL * scale:
        fail(f"EvalStep vs net.eval()(x): {err} > {EVAL_RTOL} x {scale}")
    if lg16.dtype != torch.bfloat16 or not torch.isfinite(lg16).all() or \
            err16 > BF16_EVAL_RTOL * scale32:
        fail(f"bf16 EvalStep vs fp32: {err16} > {BF16_EVAL_RTOL} x "
             f"{scale32} ({lg16.dtype})")
    _zero_counts()
    lgc = EvalStep(bench_chain_net, bf16_compute=True)(xd)
    torch.cuda.synchronize()
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(chain_emit_bf16=16)
    _expect(launches, want, "one bf16 chain-net EvalStep call")
    twin = copy.deepcopy(bench_chain_net).to(torch.bfloat16).eval()
    with torch.inference_mode():
        refc = twin(xd.to(torch.bfloat16))
    del twin
    errc = (lgc.float() - refc.float()).abs().max().item()
    scalec = refc.float().abs().max().item()
    emit({"phase": "eval_step_bf16_chain", "batch": EVAL_BATCH,
          "launches": launches, "dtype": str(lgc.dtype),
          "max_abs_err": errc, "logits_abs_max": scalec, "rtol": EVAL_RTOL})
    if lgc.dtype != torch.bfloat16 or not torch.isfinite(lgc).all() or \
            errc > EVAL_RTOL * scalec:
        fail(f"bf16 chain EvalStep vs the bf16 net's direct forward: "
             f"{errc} > {EVAL_RTOL} x {scalec} ({lgc.dtype})")


def rtc_bound_ms(nbytes):
    """Least time for work that moves ``nbytes`` at a few flops per
    element: bytes over the HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def _ulp_check(name, got, ref, rtol):
    """Elementwise |got - ref| <= rtol * |ref| (1 ulp); returns the
    worst relative error and the worst absolute error."""
    diff = (got - ref).abs()
    bad = diff > rtol * ref.abs()
    rel = (diff / ref.abs().clamp_min(torch.finfo(ref.dtype).tiny)).max()
    if bool(bad.any()):
        fail(f"{name} disagrees with its plain version beyond 1 ulp "
             f"({rtol}): worst relative error {rel.item()}")
    return rel.item(), diff.max().item()


def _compile_rtc(mx, source, **kw):
    """A CudaModule, with its NVRTC compile time in ms."""
    t0 = time.perf_counter()
    mod = mx.rtc.CudaModule(source, options=RTC_OPTIONS, **kw)
    return mod, (time.perf_counter() - t0) * 1e3


def _get_rtc_kernel(mod, name, sig):
    """A kernel of ``mod``, with the module load + lookup time in ms."""
    t0 = time.perf_counter()
    k = mod.get_kernel(name, sig)
    return k, (time.perf_counter() - t0) * 1e3


def _blocks(n):
    return ((n + RTC_BLOCK - 1) // RTC_BLOCK,)


def resnet50_param_count(seed):
    """The parameter count of the port's resnet50_v1 (weights, biases,
    BN gamma and beta; the moving statistics are not parameters)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1(device="cuda:0", seed=seed)
    n = sum(p.numel() for p in net.parameters())
    del net
    torch.cuda.empty_cache()
    return n


def _fresh_thread_axpy(nd, ctx, axpy, rs):
    """axpy launched from a thread that has not used CUDA (no current
    driver context there until rtc makes the primary one current), held
    against its plain version."""
    import threading
    m = 4099
    x = nd.array(rs.randn(m).astype(np.float32), ctx=ctx)
    y0 = nd.array(rs.randn(m).astype(np.float32), ctx=ctx)
    y = y0.copy()
    torch.cuda.synchronize()
    errors = []

    def run():
        try:
            axpy.launch([x, y, 0.25, m], ctx, _blocks(m), (RTC_BLOCK,))
            torch.cuda.synchronize()
        except Exception as e:      # reported below, in the main thread
            errors.append(repr(e))

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    if t.is_alive() or errors:
        fail(f"axpy from a fresh thread failed: {errors or 'timeout'}")
    _ulp_check("axpy (fresh thread)", y._data,
               axpy_plain(x, y0, 0.25)._data, RTC_RTOL["float32"])
    return True


def phase_kernels_rtc(seed):
    """The rtc user kernels compiled through mx.rtc.CudaModule, each
    against its plain mx.nd version on the card: axpy at n = the
    parameter count of resnet50_v1 (timed), the row sums at a small and
    a >48 KB shared-memory shape, scale_add in fp32 and fp64."""
    import incubator_mxnet_tpu_torch as mx
    nd, ctx = mx.nd, mx.gpu(0)
    rs = np.random.RandomState(seed + 11)
    out = {}
    # (a) axpy
    mod, compile_ms = _compile_rtc(mx, AXPY_SRC)
    axpy, load_ms = _get_rtc_kernel(mod, "axpy", AXPY_SIG)
    n = resnet50_param_count(seed)
    x = nd.array(rs.randn(n).astype(np.float32), ctx=ctx)
    y0 = nd.array(rs.randn(n).astype(np.float32), ctx=ctx)
    alpha = -0.1
    y = y0.copy()
    axpy.launch([x, y, alpha, n], ctx, _blocks(n), (RTC_BLOCK,))
    ref = axpy_plain(x, y0, alpha)
    torch.cuda.synchronize()
    rel, err = _ulp_check("axpy", y._data, ref._data, RTC_RTOL["float32"])
    xt, yt = x._data, y._data
    row = {"kernel": "axpy", "n": n, "compile_ms": compile_ms,
           "load_ms": load_ms, "max_rel_err": rel, "max_abs_err": err,
           "rtol": RTC_RTOL["float32"],
           "kernel_ms": time_ms(lambda: axpy.launch(
               [x, y, alpha, n], ctx, _blocks(n), (RTC_BLOCK,))),
           "plain_ms": time_ms(lambda: axpy_plain(x, y, alpha)),
           "library_ms": time_ms(lambda: yt.add_(xt, alpha=alpha))}
    row["bound_ms"], row["bound_by"] = rtc_bound_ms(3 * 4 * n)
    row["fresh_thread_ok"] = _fresh_thread_axpy(nd, ctx, axpy, rs)
    emit(dict({"phase": "kernels_rtc"}, **row))
    out["axpy"] = (row, axpy)
    del x, y, y0, ref, xt, yt
    # (b) row sums, one launch above 48 KB of dynamic shared memory
    mod, compile_ms = _compile_rtc(mx, ROW_SUM_SRC)
    row_sum, load_ms = _get_rtc_kernel(mod, "row_sum", ROW_SUM_SIG)
    rows = []
    for r, c in ROW_SUM_SHAPES:
        xs = nd.array(rs.randn(r, c).astype(np.float32), ctx=ctx)
        sums = nd.zeros((r,), ctx=ctx)
        smem = row_sum_shared_bytes(c)
        row_sum.launch([xs, sums, c], ctx, (r,), (RTC_BLOCK,), smem)
        ref = row_sum_plain(xs)
        mass = xs.abs().sum(axis=1)
        torch.cuda.synchronize()
        worst = ((sums - ref).abs() / mass).max().asscalar()
        if not worst <= ROW_SUM_RTOL:
            fail(f"row_sum at {(r, c)} ({smem} B shared) disagrees with "
                 f"its plain version: {worst} > {ROW_SUM_RTOL} of the "
                 f"row's mass")
        rows.append({"shape": [r, c], "shared_mem": smem,
                     "max_err_of_mass": float(worst),
                     "kernel_ms": time_ms(lambda: row_sum.launch(
                         [xs, sums, c], ctx, (r,), (RTC_BLOCK,), smem)),
                     "plain_ms": time_ms(lambda: row_sum_plain(xs))})
    emit({"phase": "kernels_rtc", "kernel": "row_sum",
          "compile_ms": compile_ms, "load_ms": load_ms,
          "rtol_of_mass": ROW_SUM_RTOL, "rows": rows})
    # (c) a template exported at two types
    mod, compile_ms = _compile_rtc(mx, SCALE_ADD_SRC,
                                   exports=SCALE_ADD_EXPORTS)
    rows = []
    for dtype, ctype in (("float32", "float"), ("float64", "double")):
        k, load_ms = _get_rtc_kernel(
            mod, f"scale_add<{ctype}>",
            f"const {ctype} *x, const {ctype} *y, {ctype} *o, "
            f"{ctype} alpha, int n")
        n = SCALE_ADD_N
        xs = nd.array(rs.randn(n), ctx=ctx, dtype=dtype)
        ys = nd.array(rs.randn(n), ctx=ctx, dtype=dtype)
        o = nd.zeros((n,), ctx=ctx, dtype=dtype)
        k.launch([xs, ys, o, 2.5, n], ctx, _blocks(n), (RTC_BLOCK,))
        ref = scale_add_plain(xs, ys, 2.5)
        torch.cuda.synchronize()
        rel, err = _ulp_check(f"scale_add<{ctype}>", o._data, ref._data,
                              RTC_RTOL[dtype])
        rows.append({"export": f"scale_add<{ctype}>", "n": n,
                     "load_ms": load_ms, "max_rel_err": rel,
                     "max_abs_err": err, "rtol": RTC_RTOL[dtype]})
    emit({"phase": "kernels_rtc", "kernel": "scale_add",
          "compile_ms": compile_ms, "rows": rows})
    torch.cuda.empty_cache()
    return out["axpy"]


def imperative_data(seed, batch=IMPERATIVE_BATCH, features=FEATURES,
                    classes=CLASSES):
    """The classifier's inputs and initial parameters, from ``seed``:
    non-negative feature rows (as after ReLU and average pooling),
    labels in [0, classes), W ~ N(0, 0.01^2), b = 0."""
    rs = np.random.RandomState(seed + 17)
    feats = rs.rand(batch, features).astype(np.float32)
    labels = rs.randint(0, classes, batch).astype(np.int32)
    w0 = (0.01 * rs.randn(classes, features)).astype(np.float32)
    b0 = np.zeros(classes, np.float32)
    return feats, labels, w0, b0


def imperative_setup(mx, ctx, data):
    """The classifier's data and parameters as NDArrays on ``ctx``, W
    and b with gradient buffers."""
    nd = mx.nd
    feats, labels, w0, b0 = data
    x, y = nd.array(feats, ctx=ctx), nd.array(labels, ctx=ctx)
    w, b = nd.array(w0, ctx=ctx), nd.array(b0, ctx=ctx)
    w.attach_grad()
    b.attach_grad()
    return x, y, w, b


def imperative_steps(mx, arrays, steps, update, lr=IMPERATIVE_LR):
    """``steps`` imperative SGD steps of the classifier: FullyConnected
    -> log_softmax -> -pick -> mean under record(), backward(), then
    ``update(param, lr)`` for W and b.  Returns the loss NDArrays.
    ``mx`` is the port, or the JAX package in the CPU tests."""
    nd = mx.nd
    x, y, w, b = arrays
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            out = nd.FullyConnected(x, w, b, num_hidden=w.shape[0])
            loss = (-nd.pick(nd.log_softmax(out), y)).mean()
        loss.backward()
        update(w, lr)
        update(b, lr)
        losses.append(loss)
    return losses


def imperative_loop(mx, ctx, data, steps, update, lr=IMPERATIVE_LR):
    """Setup and ``steps`` steps on ``ctx``: (W, b, the loss NDArrays)."""
    arrays = imperative_setup(mx, ctx, data)
    losses = imperative_steps(mx, arrays, steps, update, lr)
    return arrays[2], arrays[3], losses


def nd_update(p, lr):
    """The plain SGD update: p[:] = p - lr * p.grad."""
    p[:] = p - lr * p.grad


def _worst_of_max(got, ref):
    """max |got - ref| / max |ref| over the NDArrays (or tensors)."""
    def host(a):
        return a.asnumpy() if hasattr(a, "asnumpy") else \
            a.detach().cpu().numpy()
    return max(float(np.abs(host(g) - host(r)).max()
                     / max(np.abs(host(r)).max(), 1e-30))
               for g, r in zip(got, ref))


def phase_nd_imperative(seed, axpy):
    """The slice's path at full width: the imperative loop with the rtc
    axpy update on the card (kernel counts set to 0 just before it and
    read just after: 2 launches a step), held against the nd update on
    the card and on the CPU; nd.save on the card, nd.load on the CPU;
    5 steps under torch.profiler."""
    import incubator_mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    ctx = mx.gpu(0)
    data = imperative_data(seed)

    def rtc_update(p, lr):
        axpy.launch([p.grad, p, -lr, p.size], ctx, _blocks(p.size),
                    (RTC_BLOCK,))

    w_nd, b_nd, _ = imperative_loop(mx, ctx, data, IMPERATIVE_STEPS,
                                    nd_update)
    torch.cuda.synchronize()
    arrays = imperative_setup(mx, ctx, data)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = imperative_steps(mx, arrays, IMPERATIVE_STEPS, rtc_update)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w, b = arrays[2], arrays[3]
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(rtc_axpy=2 * IMPERATIVE_STEPS)
    _expect(launches, want, f"the imperative path ({IMPERATIVE_STEPS} "
                            "steps)")
    loss_vals = [float(v.asscalar()) for v in losses]
    if not all(math.isfinite(v) for v in loss_vals) or \
            not loss_vals[-1] < loss_vals[0]:
        fail(f"imperative losses not finite and falling: {loss_vals}")
    err_nd = _worst_of_max([w, b], [w_nd, b_nd])
    if not err_nd <= RTC_VS_ND_RTOL:
        fail(f"rtc-updated parameters differ from the nd update by "
             f"{err_nd} > {RTC_VS_ND_RTOL} of each tensor's max")
    with mx.cpu():
        w_cpu, b_cpu, losses_cpu = imperative_loop(
            mx, mx.cpu(), data, IMPERATIVE_STEPS, nd_update)
    err_cpu = _worst_of_max([w, b], [w_cpu, b_cpu])
    if not err_cpu <= CARD_VS_CPU_RTOL:
        fail(f"card parameters differ from the CPU's by {err_cpu} > "
             f"{CARD_VS_CPU_RTOL} of each tensor's max")
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        path = os.path.join(tmp, "classifier.params")
        mx.nd.save(path, {"weight": w, "bias": b})
        with mx.cpu():
            back = mx.nd.load(path)
    same = all(np.array_equal(back[k].asnumpy(), v.asnumpy())
               and back[k].context == mx.cpu() and back[k].dtype == v.dtype
               for k, v in (("weight", w), ("bias", b)))
    if not same:
        fail("nd.save on the card then nd.load on the CPU is not "
             "bit-identical")
    arrays = imperative_setup(mx, ctx, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        imperative_steps(mx, arrays, IMPERATIVE_PROFILE_STEPS, rtc_update)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    emit({"phase": "nd_imperative", "batch": IMPERATIVE_BATCH,
          "features": FEATURES, "classes": CLASSES,
          "steps": IMPERATIVE_STEPS, "lr": IMPERATIVE_LR,
          "losses": loss_vals,
          "losses_cpu": [float(v.asscalar()) for v in losses_cpu],
          "ms_per_step": wall / IMPERATIVE_STEPS * 1e3,
          "launches": launches, "rtc_vs_nd_err_of_max": err_nd,
          "rtc_vs_nd_rtol": RTC_VS_ND_RTOL,
          "card_vs_cpu_err_of_max": err_cpu,
          "card_vs_cpu_rtol": CARD_VS_CPU_RTOL,
          "save_load_bit_identical": same})
    emit(dict({"phase": "nd_imperative_profile",
               "steps": IMPERATIVE_PROFILE_STEPS,
               "ms_per_step": pwall / IMPERATIVE_PROFILE_STEPS * 1e3},
              **_profile_summary(prof, pwall)))
    return launches["rtc_axpy"]


# telemetry on vs off, in turns (on, off, on, off, ...): TEL_TURNS each,
# the imperative step (TEL_IMPERATIVE_STEPS a turn) and the GPT-2-small
# engine's decode iteration (TEL_DECODE_PROMPTS short prompts of
# TEL_DECODE_PROMPT tokens, TEL_DECODE_NEW new tokens each, a turn)
TEL_TURNS, TEL_IMPERATIVE_STEPS = 5, 20
TEL_DECODE_PROMPTS, TEL_DECODE_PROMPT, TEL_DECODE_NEW = 8, 16, 48


def phase_telemetry_cost(seed, axpy, net):
    """What the telemetry hooks cost on two host-bound paths, measured
    in turns with ``MXNET_TELEMETRY``'s switch (``telemetry.enable`` /
    ``disable``): the imperative step of phase nd_imperative (rtc axpy
    update; ms a step over a turn, synchronised) and the generation
    engine's decode iteration at GPT-2-small width (8 slots; the turn's
    wall and the engine's decode seconds over its decode iterations).
    Prints each turn's ms and the ratio of the medians, on over off."""
    import incubator_mxnet_tpu_torch as mx
    tel = _telemetry()
    ctx = mx.gpu(0)
    arrays = imperative_setup(mx, ctx, imperative_data(seed))

    def rtc_update(p, lr):
        axpy.launch([p.grad, p, -lr, p.size], ctx, _blocks(p.size),
                    (RTC_BLOCK,))

    def imperative():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imperative_steps(mx, arrays, TEL_IMPERATIVE_STEPS, rtc_update)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TEL_IMPERATIVE_STEPS * 1e3

    rs = np.random.RandomState(seed + 21)
    prompts = [rs.randint(0, GPT2_SMALL["vocab"], TEL_DECODE_PROMPT).tolist()
               for _ in range(TEL_DECODE_PROMPTS)]
    eng = _engine(net)

    def decode():
        before = eng._counters()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=TEL_DECODE_NEW)
                for p in prompts]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
        own = eng._counters()
        n = own["decodes"] - before["decodes"]
        return {"wall_ms": wall / n * 1e3,
                "decode_ms": (own["decode_s"] - before["decode_s"]) / n * 1e3}

    imperative()                # warm: allocator, rtc module
    decode()
    turns = {"on": [], "off": []}
    try:
        for i in range(2 * TEL_TURNS):
            mode = "on" if i % 2 == 0 else "off"
            (tel.enable if mode == "on" else tel.disable)()
            turns[mode].append({"imperative_ms": imperative(),
                                "decode": decode()})
    finally:
        tel.enable()
        eng.close()
    med = lambda v: float(np.median(v))   # noqa: E731
    out = {}
    for what, get in (("imperative_ms_per_step",
                       lambda t: t["imperative_ms"]),
                      ("decode_wall_ms_per_iteration",
                       lambda t: t["decode"]["wall_ms"]),
                      ("decode_ms_per_iteration",
                       lambda t: t["decode"]["decode_ms"])):
        on = [get(t) for t in turns["on"]]
        off = [get(t) for t in turns["off"]]
        out[what] = {"on": on, "off": off, "on_over_off":
                     med(on) / med(off)}
        print(f"telemetry cost: {what} on {med(on):.4f} ms, off "
              f"{med(off):.4f} ms, ratio {med(on) / med(off):.4f}",
              flush=True)
    emit(dict({"phase": "telemetry_cost", "turns": TEL_TURNS,
               "imperative_steps_a_turn": TEL_IMPERATIVE_STEPS,
               "decode_prompts": TEL_DECODE_PROMPTS,
               "decode_new_tokens": TEL_DECODE_NEW}, **out))


def _engine(net):
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(net, slots=8, max_len=1024, kv_layout="paged",
                           block_size=16, prefix_cache=False)
    eng.warmup()
    return eng


def _gen_held(phase, eng, tokens):
    """The engine's ``gen.*`` telemetry (the registry reset before its
    traffic) against its own bookkeeping: every counter of its slices
    equals the engine's count, and ``gen.token.count`` the ``tokens``
    its futures returned.  Returns (the readings, the engine's own
    counts)."""
    from incubator_mxnet_tpu_torch.serving.generation import _COUNTERS
    stats, own = eng.stats(), eng._counters()
    if own["tokens"] != tokens:
        fail(f"{phase}: the engine counted {own['tokens']} tokens, its "
             f"futures returned {tokens}")
    want = {name: own[key] for key, (_, name) in _COUNTERS.items()
            if name in stats}
    return _held(phase, stats, want), own


def _serve(eng, greedy, sampled):
    """The smoke's traffic: every greedy prompt plus the sampled one
    twice, all submitted at once.  Returns (outputs, wall seconds)."""
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in greedy]
    futs += [eng.submit(sampled, max_new_tokens=MAX_NEW, temperature=0.8,
                        seed=123) for _ in range(SAMPLED_TWICE)]
    outs = [f.result(timeout=600) for f in futs]
    return outs, time.perf_counter() - t0


def phase_generation(seed):
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    t0 = time.perf_counter()
    net = TransformerDecoder(device="cuda:0", seed=seed, **GPT2_SMALL)
    eng = _engine(net)
    setup_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed)
    vocab = GPT2_SMALL["vocab"]
    greedy = [rs.randint(0, vocab, size=L).tolist() for L in PROMPT_LENGTHS]
    sampled = rs.randint(0, vocab, size=SAMPLED_LEN).tolist()
    try:
        flash_attention.launches = 0
        _telemetry().reset()
        outs, wall = _serve(eng, greedy, sampled)
        launches = flash_attention.launches
        tokens = int(sum(o.size for o in outs))
        stats, own = _gen_held("generation", eng, tokens)
    finally:
        eng.close()
    prefills = stats["gen.prefill.count"]
    if prefills != len(outs):
        fail(f"{prefills} prefills for {len(outs)} requests")
    if launches != GPT2_SMALL["depth"] * prefills:
        fail(f"flash kernel launched {launches} times on the main path, "
             f"expected {GPT2_SMALL['depth']} x {prefills} prefills")
    for o in outs:
        if o.shape != (MAX_NEW,) or o.min() < 0 or o.max() >= vocab:
            fail(f"bad generated tokens {o!r}")
    if not np.array_equal(outs[-1], outs[-2]):
        fail(f"sampled request (seed 123) differed between submissions: "
             f"{outs[-2].tolist()} vs {outs[-1].tolist()}")
    if stats["gen.request.count"] != len(outs):
        fail(f"gen.request.count {stats['gen.request.count']} for "
             f"{len(outs)} requests")
    emit({"phase": "generation", "requests": len(outs),
          "generated_tokens": tokens, "wall_s": wall,
          "tokens_per_s": tokens / wall, "prefill_s": own["prefill_s"],
          "decode_s": own["decode_s"], "prefills": prefills,
          "decodes": stats["gen.decode.count"], "setup_s": setup_s,
          "telemetry": stats,
          "flash_launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    phase_reference(net, greedy, outs)
    return launches, net, greedy, sampled


def phase_profile(net, greedy, sampled):
    """The same traffic again under torch.profiler —
    device time by kernel, and the device's busy share of the wall (the
    profiler's own host cost inflates the wall, so the busy share is a
    lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(net)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _serve(eng, greedy, sampled)
        own = eng._counters()
    finally:
        eng.close()
    emit(dict({"phase": "profile", "prefill_s": own["prefill_s"],
               "decode_s": own["decode_s"], "decodes": own["decodes"]},
              **_profile_summary(prof, wall)))


def phase_reference(net, greedy, outs):
    """The same weights on the CPU (plain path): last-position prefill
    logits within LOGITS_ATOL, and the greedy tokens of the two
    shortest requests identical."""
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    cpu = TransformerDecoder(device="cpu", **GPT2_SMALL)
    cpu.load_state_dict(net.state_dict())
    prompt = greedy[3]                      # 100 tokens, bucket 128
    toks = np.zeros((1, 128), np.int64)
    toks[0, :len(prompt)] = prompt
    with torch.inference_mode():
        lg_gpu = net.prefill(torch.from_numpy(toks).cuda(), len(prompt))[0]
        lg_cpu = cpu.prefill(torch.from_numpy(toks), len(prompt))[0]
    lg_gpu = lg_gpu.cpu()
    if not torch.isfinite(lg_gpu).all():
        fail("non-finite prefill logits on the card")
    err = (lg_gpu - lg_cpu).abs().max().item()
    with GenerationEngine(cpu, device="cpu", slots=2, max_len=1024,
                          block_size=16) as ceng:
        futs = [ceng.submit(greedy[i], max_new_tokens=MAX_NEW)
                for i in (0, 1)]
        ref = [f.result(timeout=600) for f in futs]
    same = [bool(np.array_equal(r, outs[i])) for i, r in enumerate(ref)]
    emit({"phase": "reference", "logits_max_abs_err": err,
          "logits_atol": LOGITS_ATOL, "logits_abs_max":
          lg_cpu.abs().max().item(), "greedy_equal": same})
    if err > LOGITS_ATOL:
        fail(f"card vs CPU prefill logits differ by {err} > {LOGITS_ATOL}")
    if not all(same):
        fail(f"greedy tokens differ between card and CPU: "
             f"{[r.tolist() for r in ref]} vs "
             f"{[o.tolist() for o in outs[:2]]}")


def _stage_engine(net, device="cuda:0", **knobs):
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(net, device=device, slots=8,
                           max_len=GPT2_SMALL["max_len"], kv_layout="paged",
                           block_size=16, **knobs)
    eng.warmup()
    return eng


def _timed(eng, prompts, **kw):
    """Submit every prompt at once.  Returns (outputs, the futures,
    wall seconds)."""
    t0 = time.perf_counter()
    futs = [eng.submit(p, **kw) for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    return outs, futs, time.perf_counter() - t0


def _ttft(futs):
    """Each request's time to first token, in seconds."""
    return [f.first_token_at - f.submitted_at for f in futs]


def _same(got, want, what):
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not np.array_equal(g, w)]
    if bad or len(got) != len(want):
        fail(f"{what}: requests {bad} differ: "
             f"{[got[i].tolist() for i in bad]} vs "
             f"{[want[i].tolist() for i in bad]}")


def phase_generation_stages(net, seed):
    """The generation engine's paged stages at GPT-2-small width on the
    card: (1) the prefix cache (on by default) with spec decoding (K=4,
    a 2-layer draft) over 8 prompts sharing a 512-token lead, submitted
    at once, then the same 8 again (terminal hits), then one sampled
    prompt twice; (2) chunked prefill (256) with spec, one 1000-token
    prompt and 7 short ones just after it.  Greedy outputs are held
    against the plain / chunk-only engine on the card, the two shortest
    chunked requests against the port's CPU chunked engine."""
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    rs = np.random.RandomState(seed + 11)
    vocab, depth = GPT2_SMALL["vocab"], GPT2_SMALL["depth"]
    lead = rs.randint(0, vocab, STAGES_LEAD).tolist()
    greedy = [lead + rs.randint(0, vocab, n).tolist() for n in STAGES_TAILS]
    sampled = rs.randint(0, vocab, SAMPLED_LEN).tolist()
    new = dict(max_new_tokens=STAGES_NEW)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = _stage_engine(net, prefix_cache=False, spec_k=0)
    try:
        ref, _, plain_wall = _timed(plain, greedy, **new)
    finally:
        plain.close()
    eng = _stage_engine(net, spec_k=STAGES_SPEC_K,
                        spec_draft_layers=STAGES_DRAFT)
    try:
        _zero_counts()
        cold, futs, wall_cold = _timed(eng, greedy, **new)
        ttft_cold = _ttft(futs)
        st1, fl1 = eng.stats(), flash_attention.launches
        warm, futs, wall_warm = _timed(eng, greedy, **new)
        ttft_warm = _ttft(futs)
        st2, fl2 = eng.stats(), flash_attention.launches
        pair = [eng.submit(sampled, temperature=0.8, seed=123, **new)
                .result(timeout=600) for _ in range(2)]
        launches = flash_attention.launches
        st, own = _gen_held("generation_stages prefix+spec", eng, int(sum(
            o.size for o in cold + warm + pair)))
        live, free, info = eng.live_blocks(), eng.free_blocks(), \
            eng.kv_info()
    finally:
        eng.close()
    _same(cold, ref, "prefix+spec engine vs the plain engine (cold)")
    _same(warm, ref, "prefix+spec engine vs the plain engine (hits)")
    for o in cold + pair:
        if o.shape != (STAGES_NEW,) or o.min() < 0 or o.max() >= vocab:
            fail(f"bad generated tokens {o!r}")
    hit, pre = "gen.prefix.hit", "gen.prefill.count"
    if st2[hit] - st1[hit] != len(greedy) or fl2 != fl1 or \
            st2[pre] != st1[pre]:
        fail(f"the {len(greedy)} repeats made {st2[hit] - st1[hit]} "
             f"prefix hits, {st2[pre] - st1[pre]} prefills and "
             f"{fl2 - fl1} flash launches")
    if launches != depth * st[pre]:
        fail(f"flash launched {launches} times for {st[pre]} "
             f"prefills of {depth} layers")
    if st["gen.request.count"] != 2 * len(greedy) + 2:
        fail(f"gen.request.count {st['gen.request.count']} for "
             f"{2 * len(greedy) + 2} requests")
    prop, acc, back = (st[f"gen.spec.{k}.count"] for k in
                       ("proposed", "accepted", "rollback"))
    if prop <= 0 or prop != acc + back:
        fail(f"spec counters inconsistent: {st}")
    if not np.array_equal(pair[0], pair[1]):
        fail(f"sampled request (seed 123) differed between submissions: "
             f"{pair[0].tolist()} vs {pair[1].tolist()}")
    held = info["prefix"]["blocks"] + info["prefix"]["terminals"]
    if live != held or live + free != info["num_blocks"] - 1 or \
            info["reserved"]:
        fail(f"pool not back to the cache's holdings ({held} blocks): "
             f"{info}")
    peak_prefix = torch.cuda.max_memory_allocated() / 1e9

    # (2) chunked prefill with spec: the long prompt first
    long = rs.randint(0, vocab, CHUNK_LONG).tolist()
    shorts = [rs.randint(0, vocab, n).tolist() for n in CHUNK_SHORTS]
    chunk_new = dict(max_new_tokens=CHUNK_NEW)
    torch.cuda.reset_peak_memory_stats()
    ck = _stage_engine(net, prefill_chunk=CHUNK, spec_k=STAGES_SPEC_K,
                       spec_draft_layers=STAGES_DRAFT)
    try:
        _zero_counts()
        outs, futs, wall_chunk = _timed(ck, [long] + shorts, **chunk_new)
        ck_flash = flash_attention.launches
        ck_stats, ck_own = _gen_held("generation_stages chunk+spec", ck,
                                     int(sum(o.size for o in outs)))
    finally:
        ck.close()
    if ck_stats["gen.prefill.chunk.count"] <= 0 or \
            ck_stats["gen.prefill.count"] != 1 + len(shorts):
        fail(f"chunked engine: {ck_stats}")
    peak_chunk = torch.cuda.max_memory_allocated() / 1e9
    ttft_chunk = _ttft(futs)
    last_short = max(f.first_token_at for f in futs[1:])
    if last_short >= futs[0].first_token_at:
        fail(f"chunked prefill did not interleave: the long prompt's "
             f"first token came {futs[0].first_token_at - last_short} s "
             f"before the last short one's")
    only = _stage_engine(net, prefill_chunk=CHUNK, spec_k=0)
    try:
        want, _, _ = _timed(only, [long] + shorts, **chunk_new)
    finally:
        only.close()
    _same(outs, want, "chunk+spec engine vs the chunk-only engine")
    cpu = TransformerDecoder(device="cpu", **GPT2_SMALL)
    cpu.load_state_dict(net.state_dict())
    two = sorted(range(len(shorts)), key=lambda i: len(shorts[i]))[:2]
    with GenerationEngine(cpu, device="cpu", slots=2,
                          max_len=GPT2_SMALL["max_len"], block_size=16,
                          prefill_chunk=CHUNK) as ceng:
        cref = [ceng.submit(shorts[i], **chunk_new).result(timeout=600)
                for i in two]
    _same([outs[1 + i] for i in two], cref,
          "chunked engine, card vs CPU (two shortest requests)")
    med = lambda v: float(np.median(v))   # noqa: E731
    tokens = lambda o: int(sum(x.size for x in o))   # noqa: E731
    emit({"phase": "generation_stages",
          "prefix_spec": {
              "requests": len(greedy), "lead_tokens": STAGES_LEAD,
              "tails": list(STAGES_TAILS), "new_tokens": STAGES_NEW,
              "spec_k": STAGES_SPEC_K, "draft_layers": STAGES_DRAFT,
              "cold_partial_tokens_per_s": tokens(cold) / wall_cold,
              "terminal_tokens_per_s": tokens(warm) / wall_warm,
              "plain_tokens_per_s": tokens(ref) / plain_wall,
              "ttft_cold_s": ttft_cold[0],
              "ttft_partial_s_median": med(ttft_cold[1:]),
              "ttft_terminal_s_median": med(ttft_warm),
              "ttft_cold_burst_s": ttft_cold, "ttft_terminal_s": ttft_warm,
              "prefills": st[pre], "flash_launches": launches,
              "prefix_hit": st[hit],
              "prefix_miss": st["gen.prefix.miss"],
              "prefix_saved_tokens": st["gen.prefix.saved_tokens"],
              "kv_cow": st["gen.kv.cow.count"],
              "spec_proposed": prop, "spec_accepted": acc,
              "spec_rollback": back, "spec_accept_rate": acc / prop,
              "decodes": st["gen.decode.count"],
              "prefill_s": own["prefill_s"], "decode_s": own["decode_s"],
              "telemetry": st, "live_blocks": live,
              "cache_holds": info["prefix"], "peak_mem_gb": peak_prefix},
          "chunked_spec": {
              "long_tokens": CHUNK_LONG, "shorts": list(CHUNK_SHORTS),
              "chunk": CHUNK, "new_tokens": CHUNK_NEW,
              "tokens_per_s": tokens(outs) / wall_chunk,
              "ttft_long_s": ttft_chunk[0], "ttft_short_s": ttft_chunk[1:],
              "prefill_chunks": ck_stats["gen.prefill.chunk.count"],
              "prefills": ck_stats["gen.prefill.count"],
              "flash_launches": ck_flash,
              "spec_accept_rate": ck_stats["gen.spec.accepted.count"]
              / max(ck_stats["gen.spec.proposed.count"], 1),
              "decodes": ck_stats["gen.decode.count"],
              "prefill_s": ck_own["prefill_s"],
              "decode_s": ck_own["decode_s"], "telemetry": ck_stats,
              "cpu_equal_requests": [len(shorts[i]) for i in two],
              "peak_mem_gb": peak_chunk}})


# ---------------------------------------------------------------- Gluon
GLUON_WIDTHS = dict(cin=512, mid=128, classes=1000)  # ResNet-50 stage 2
GLUON_SHAPE = (32, 28, 28, 512)                     # b=32, NHWC
GLUON_STEPS = 3
GLUON_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
# card vs CPU after 3 Gluon steps: of each tensor's largest magnitude,
# plus STEP_ATOL (the conv biases before a BatchNorm get a gradient that
# is 0 in exact arithmetic: their values are rounding noise)
GLUON_RTOL = 1e-4
GLUON_METRIC_RTOL = 1e-5
GLUON_TRAIN_BATCH, GLUON_TRAIN_STEPS = 32, 5
# one Trainer step vs one TrainStep step on the same weights and batch:
# the loss's sum with rescale_grad 1/32 and its mean differ by a power
# of two, so the two agree bit for bit on the CPU; on the card cuDNN's
# backward sums in an order that varies from call to call
GLUON_STEP_RTOL = 1e-6
GLUON_ZERO_GRAD_LEAVES = ("body.0.bias", "body.2.conv.bias")
GLUON_KERNEL_SHAPE = (32, 28, 28, 128)   # stage 2's conv1 output


def gluon_bottleneck(mx, cin=512, mid=128, classes=1000, fused=True):
    """ResNet-50 v1's stage-2 bottleneck (cin -> mid -> cin channels,
    NHWC) with a classifier head, written as a user writes JAX Gluon
    code: a HybridBlock with hybrid_forward over ``mx``'s layers (the
    JAX package or the port; only the package differs).  Its [BN -> ReLU
    -> conv] boundaries are ``FusedBNReLUConv2D`` layers; ``fused=False``
    runs them as BatchNorm, ReLU and Conv2D over the same parameters
    (the unfused formulation).  The head's Dense infers its input width
    at the first forward."""
    nn = mx.gluon.nn

    class Bottleneck(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.conv1 = nn.Conv2D(mid, 1, layout="NHWC",
                                       in_channels=cin)
                self.fused2 = nn.FusedBNReLUConv2D(
                    mid, 3, 1, 1, layout="NHWC", in_channels=mid)
                self.fused3 = nn.FusedBNReLUConv2D(
                    cin, 1, layout="NHWC", in_channels=mid, use_bias=True)
                self.bn3 = nn.BatchNorm(axis=3, in_channels=cin)
                self.act = nn.Activation("relu")
                self.pool = nn.GlobalAvgPool2D(layout="NHWC")
                self.flat = nn.Flatten()
                self.fc = nn.Dense(classes)

        def _boundary(self, F, layer, x):
            if fused:
                return layer(x)
            return layer.conv(F.relu(layer.bn(x)))

        def hybrid_forward(self, F, x):
            out = self._boundary(F, self.fused2, self.conv1(x))
            out = self.bn3(self._boundary(F, self.fused3, out))
            out = self.act(out + x)
            return self.fc(self.flat(self.pool(out)))

    return Bottleneck(prefix="bottleneck_")


def gluon_loop(mx, net, x, y, ctx, steps):
    """The JAX Gluon training loop as written for JAX: ``steps`` of
    record, softmax cross-entropy, backward and ``Trainer.step`` (SGD
    with momentum, weight decay and a FactorScheduler), with
    ``metric.Accuracy`` and ``metric.CrossEntropy``.  Returns the losses,
    the metrics and each step's logits."""
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(
        GLUON_OPT, lr_scheduler=mx.lr_scheduler.FactorScheduler(
            step=1, factor=0.5)))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    acc, ce = mx.metric.Accuracy(), mx.metric.CrossEntropy()
    losses, logits = [], []
    with ctx:
        xx, yy = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        for _ in range(steps):
            with mx.autograd.record():
                out = net(xx)
                loss = loss_fn(out, yy)
            loss.backward()
            trainer.step(x.shape[0])
            acc.update([yy], [out])
            ce.update([yy], [mx.nd.softmax(out)])
            losses.append(float(loss.mean().asscalar()))
            logits.append(out.asnumpy())
    return {"losses": losses, "metrics": [(name, float(value)) for name, value
                                          in (acc.get(), ce.get())],
            "logits": logits}


def _numpy_metrics(logits, y):
    """Accuracy and cross-entropy of each step's logits, in numpy."""
    hits = ce = count = 0.0
    for z in logits:
        z = z.astype(np.float64)
        p = np.exp(z - z.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        hits += float((z.argmax(1) == y).sum())
        ce += float(-np.log(p[np.arange(len(y)), y.astype(np.int64)]
                            + 1e-12).sum())
        count += len(y)
    return hits / count, ce / count


def _stat_key(name):
    return name.endswith(("running_mean", "running_var"))


def _tensor_dict(net):
    return {n: p.data()._data.detach().float().cpu()
            for n, p in net.collect_params().items()}


def _launch_delta(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _fold(moving, batch, momentum):
    """The moving-statistic fold by hand, in the statistics' dtype."""
    m = torch.tensor(momentum, dtype=moving.dtype).item()
    rest = torch.tensor(1 - momentum, dtype=moving.dtype).item()
    return m * moving + rest * batch.to(moving.dtype)


def _nd_case_conv(gen, kern, cout, dt):
    n, h, w, c = GLUON_KERNEL_SHAPE
    taps = kern[0] * kern[1]
    x = torch.randn((n, h, w, c), device="cuda", generator=gen).to(dt)
    vec = [torch.rand((c,), device="cuda", generator=gen) + 0.5,
           torch.randn((c,), device="cuda", generator=gen) * 0.1,
           torch.randn((c,), device="cuda", generator=gen) * 0.1,
           torch.rand((c,), device="cuda", generator=gen) + 0.5]
    wt = (torch.randn((cout, c) + kern, device="cuda", generator=gen)
          * math.sqrt(2.0 / (c * taps))).to(dt)
    bias = torch.randn((cout,), device="cuda", generator=gen) * 0.1
    return [x] + vec + [wt, bias]


def _nd_case_chain(gen, dt):
    n, h, w, c = GLUON_KERNEL_SHAPE
    cm, co = 128, 512

    def bn(k):
        return [torch.rand((k,), device="cuda", generator=gen) + 0.5,
                torch.randn((k,), device="cuda", generator=gen) * 0.1,
                torch.randn((k,), device="cuda", generator=gen) * 0.1,
                torch.rand((k,), device="cuda", generator=gen) + 0.5]
    c1 = torch.randn((n, h, w, c), device="cuda", generator=gen).to(dt)
    w2 = (torch.randn((cm, c, 3, 3), device="cuda", generator=gen)
          * math.sqrt(2.0 / (c * 9))).to(dt)
    w3 = (torch.randn((co, cm, 1, 1), device="cuda", generator=gen)
          * math.sqrt(2.0 / cm)).to(dt)
    b3 = torch.randn((co,), device="cuda", generator=gen) * 0.1
    return [c1] + bn(c) + [w2] + bn(cm) + [w3, b3]


def phase_kernels_gluon(seed):
    """B1-B4 through the ``nd`` front end: ``nd._FusedBNReluConv`` (1x1
    -> 512 and 3x3 -> 128 channels) and ``nd._FusedBottleneckChain``
    (128 -> 128 -> 512) on CUDA NDArrays at ResNet-50 stage-2 widths,
    b=32, in fp32 and bf16, under ``autograd.record()``.  Each call must
    launch its kernels once (the counters read around it), agree with
    the kernels' plain versions on the same inputs (B1, B2, B4 fp32 1e-4
    of max |out|, bf16 2 ulps; B3 fp32 1e-5 of its sums' mass, bf16 one
    bf16 ulp of its statistics), and leave the moving statistics at the
    fold computed by hand from the batch statistics it returned.  The
    fp32 cases also time the ``nd`` call against the direct wrapper."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ndarray.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import fused_chain as fch
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    eps, momentum = 1e-5, 0.9
    rows = []
    for name, kern, cout in (("sbr_matmul", (1, 1), 512),
                             ("sbr_conv3x3", (3, 3), 128)):
        for dt in FORMS:
            args = _nd_case_conv(gen, kern, cout, dt)
            before_stats = [t.clone() for t in args[3:5]]
            arrays = [NDArray(t) for t in args]
            attrs = dict(kernel=kern, pad=(kern[0] // 2,) * 2,
                         layout="NHWC", eps=eps, momentum=momentum)
            before = _counts()
            with mx.autograd.record():
                out, mean, var = mx.nd._FusedBNReluConv(
                    *arrays, output_mean_var=True, **attrs)
            torch.cuda.synchronize()
            key = name + FORMS[dt]
            _expect(_launch_delta(before), {key: 1}, f"nd {key}")
            xv = args[0].permute(0, 3, 1, 2)
            a, b, _, _ = fc.bn_coefficients(xv, args[1], args[2],
                                            *before_stats, eps, False, True)
            plain = (fc._sbr_matmul_plain if kern == (1, 1)
                     else fc._sbr_conv3x3_plain)(xv, a, b, args[5], args[6])
            ref = plain.permute(0, 2, 3, 1).float()
            err = (out._data.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            limit = _gate(f"nd {key}", dt, err, scale, GLUON_KERNEL_SHAPE)
            for i, stat in ((3, mean), (4, var)):
                if not torch.equal(arrays[i]._data, _fold(
                        before_stats[i - 3], stat._data, momentum)):
                    fail(f"nd {key}: moving statistic {i} is not the fold "
                         "of the batch statistics")
            row = {"op": "_FusedBNReluConv", "kernel": key,
                   "shape": list(GLUON_KERNEL_SHAPE), "cout": cout,
                   "max_abs_err": err, "ref_abs_max": scale,
                   "limit": limit, "fold": "exact"}
            if dt == torch.float32:
                x, g, bt, rm, rv, wt, bias = args
                wcl = wt.contiguous(memory_format=torch.channels_last)
                row["nd_ms"] = time_ms(lambda: mx.nd._FusedBNReluConv(
                    *arrays, **attrs))
                row["direct_ms"] = time_ms(lambda: fc.fused_bn_relu_conv(
                    xv, g, bt, rm, rv, wcl, bias, kern, eps))
            rows.append(row)
    for dt in FORMS:
        args = _nd_case_chain(gen, dt)
        before_stats = [args[i].clone() for i in (3, 4, 8, 9)]
        arrays = [NDArray(t) for t in args]
        before = _counts()
        with mx.autograd.record():
            out = mx.nd._FusedBottleneckChain(
                *arrays, layout="NHWC", eps=eps, momentum=momentum,
                output_mean_var=True)
        torch.cuda.synchronize()
        suffix = FORMS[dt]
        _expect(_launch_delta(before), {"chain_stats" + suffix: 1,
                                        "chain_emit" + suffix: 1},
                f"nd _FusedBottleneckChain ({dt})")
        x = args[0].permute(0, 3, 1, 2)
        a1, b1, _, _ = fc.bn_coefficients(x, args[1], args[2],
                                          *before_stats[:2], eps, False,
                                          True)
        shift = before_stats[2].float()
        sums, sqs = fch._chain_stats_plain(x, a1, b1, args[5], shift)
        count = x.shape[0] * x.shape[2] * x.shape[3]
        mean_d = sums / count
        var2 = torch.clamp(sqs / count - mean_d.square(), min=0.0)
        mean2 = mean_d + shift
        a2, b2 = fc.bn_affine(args[6], args[7], mean2, var2, eps)
        ref = fch._chain_emit_plain(x, a1, b1, args[5], a2, b2, args[10],
                                    args[11]).permute(0, 2, 3, 1).float()
        err = (out[0]._data.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        limit = _gate(f"nd chain_emit{suffix}", dt, err, scale,
                      GLUON_KERNEL_SHAPE)
        got_m, got_v = out[3]._data.float(), out[4]._data.float()
        if dt == torch.float32:
            # 1e-5 of the sums' mass, per channel: (sum of |c2 - s|) /
            # count <= sqrt(E[(c2 - s)^2]), and the var adds 2|mean_d|
            mass = var2 + mean_d.square()
            lim_m = CHAIN_STATS_RTOL * mass.sqrt()
            lim_v = 3 * CHAIN_STATS_RTOL * mass
        else:
            lim_m, lim_v = (torch.tensor(
                [bf16_ulp(v) for v in t.abs().tolist()], device="cuda")
                for t in (mean2, var2))
        lim_m, lim_v = lim_m.clamp(min=1e-30), lim_v.clamp(min=1e-30)
        stats_err = max(((got_m - mean2).abs() / lim_m).max().item(),
                        ((got_v - var2).abs() / lim_v).max().item())
        if stats_err > 1.0:
            fail(f"nd chain_stats{suffix} statistics off their plain "
                 f"version: {stats_err} x the bound")
        for i, b, stat in zip((3, 4, 8, 9), before_stats, out[1:]):
            if not torch.equal(arrays[i]._data,
                               _fold(b, stat._data, momentum)):
                fail(f"nd chain ({dt}): moving statistic {i} is not the "
                     "fold of the batch statistics")
        rows.append({"op": "_FusedBottleneckChain",
                     "kernel": f"chain_stats{suffix}+chain_emit{suffix}",
                     "shape": list(GLUON_KERNEL_SHAPE), "cm": 128,
                     "co": 512, "max_abs_err": err, "ref_abs_max": scale,
                     "limit": limit, "stats_err_over_bound": stats_err,
                     "fold": "exact"})
    emit({"phase": "kernels_gluon", "rows": rows})


def phase_gluon_layers(seed):
    """JAX Gluon code as a user writes it (``gluon_bottleneck``,
    ``gluon_loop``) on the card: Xavier initialisation on gpu(0), one
    paused forward that materialises the deferred Dense, the parameters
    to the CPU by ``save_params`` / ``load_params``, then 3 Trainer steps
    on the card with the launch counts read around them (B1 and B2 once
    per forward each) and on the CPU, twice there (fused layers, and
    BatchNorm / ReLU / Conv2D over the same parameters) for the spread
    of fp32 itself.  Every parameter and moving statistic of the card
    within GLUON_RTOL of its max (+ STEP_ATOL) of the CPU's, or within
    SPREAD_FACTOR x the CPU spread where that is larger (the line says
    which); the metrics finite and equal to numpy's on the logits."""
    import tempfile
    import incubator_mxnet_tpu_torch as mx
    rs = np.random.RandomState(seed + 40)
    x = rs.randn(*GLUON_SHAPE).astype(np.float32)
    y = rs.randint(0, GLUON_WIDTHS["classes"],
                   GLUON_SHAPE[0]).astype(np.float32)
    gpu = mx.gpu(0)
    net = gluon_bottleneck(mx, **GLUON_WIDTHS)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    with mx.autograd.pause():
        net(mx.nd.array(x, ctx=gpu))
    cpu_nets = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bottleneck.params"
        net.save_params(path)
        for fused in (True, False):
            cpu_nets[fused] = gluon_bottleneck(mx, fused=fused,
                                               **GLUON_WIDTHS)
            with mx.cpu():
                cpu_nets[fused].load_params(path, ctx=mx.cpu())
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    card = gluon_loop(mx, net, x, y, gpu, GLUON_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(sbr_matmul=GLUON_STEPS, sbr_conv3x3=GLUON_STEPS)
    _expect(launches, want, "gluon_layers")
    t0 = time.perf_counter()
    cpu = {f: gluon_loop(mx, n, x, y, mx.cpu(), GLUON_STEPS)
           for f, n in cpu_nets.items()}
    cpu_s = time.perf_counter() - t0
    got, ref, alt = (_tensor_dict(net), _tensor_dict(cpu_nets[True]),
                     _tensor_dict(cpu_nets[False]))
    stats = [k for k in ref if _stat_key(k)]
    params = [k for k in ref if k not in stats]
    stats_worst, stats_key = _worst(got, ref, stats, GLUON_RTOL)
    params_worst, params_key = _worst(got, ref, params, GLUON_RTOL)
    spread, spread_key = _worst(alt, ref, params, GLUON_RTOL)
    bound = max(1.0, SPREAD_FACTOR * spread)
    metrics = card["metrics"]
    want_acc, want_ce = _numpy_metrics(card["logits"], y)
    emit({"phase": "gluon_layers", "shape": list(GLUON_SHAPE),
          "widths": GLUON_WIDTHS, "steps": GLUON_STEPS,
          "losses_card": card["losses"], "losses_cpu": cpu[True]["losses"],
          "launches": launches, "ms_per_step": wall / GLUON_STEPS * 1e3,
          "metrics": metrics, "numpy_metrics": [want_acc, want_ce],
          "rtol": GLUON_RTOL, "atol": STEP_ATOL,
          "params_worst_over_bound": params_worst,
          "params_worst": params_key,
          "stats_worst_over_bound": stats_worst, "stats_worst": stats_key,
          "cpu_spread_worst_over_bound": spread,
          "cpu_spread_worst": spread_key,
          "bound_used": "1e-4 of max" if bound == 1.0 else
          f"{SPREAD_FACTOR} x the CPU spread",
          "tensors": len(ref), "cpu_seconds": cpu_s})
    if params_worst > bound or stats_worst > bound:
        fail(f"gluon_layers card vs CPU after {GLUON_STEPS} steps: "
             f"{params_key} {params_worst}, {stats_key} {stats_worst} x "
             f"the bound (CPU spread {spread})")
    acc, ce = metrics[0][1], metrics[1][1]
    if not (math.isfinite(acc) and math.isfinite(ce)) or \
            abs(acc - want_acc) > GLUON_METRIC_RTOL * max(want_acc, 1e-12) \
            or abs(ce - want_ce) > GLUON_METRIC_RTOL * want_ce:
        fail(f"gluon_layers metrics {metrics} vs numpy "
             f"{(want_acc, want_ce)}")
    return launches


def phase_gluon_train(seed, fused_train_ms):
    """ResNet-50 v1 (fuse_block=True, NHWC, 224x224, fp32) trained by the
    JAX Gluon loop: ``gluon.Trainer(net.collect_params(), "sgd", ...)``
    with a FactorScheduler, ``gluon.loss.SoftmaxCrossEntropyLoss`` and
    ``metric.Accuracy``, GLUON_TRAIN_STEPS steps at b=32, with the
    launch counts read around them (16 B1 and 16 B2 launches a step).
    The parameters and moving statistics after the first step are held
    against one ``TrainStep`` step of the same seeded net on the same
    batch (GLUON_STEP_RTOL of each tensor's max).  Reports ms a step,
    the host ms inside ``trainer.step`` and the device idle share of one
    profiled step, beside ``fused_train``'s TrainStep at the same
    batch."""
    import incubator_mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    gpu = mx.gpu(0)
    net = get_resnet(1, 50, device="cuda:0", seed=seed + 41, **RESNET50)
    x, y = _train_batch(seed + 42, GLUON_TRAIN_BATCH)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(
        GLUON_OPT, lr_scheduler=mx.lr_scheduler.FactorScheduler(
            step=1, factor=0.5)))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    acc = mx.metric.Accuracy()
    xx, yy = mx.nd.array(x, ctx=gpu), mx.nd.array(y, ctx=gpu)
    host_ms, losses = [], []

    def one_step():
        with mx.autograd.record():
            out = net(xx)
            loss = loss_fn(out, yy)
        loss.backward()
        t = time.perf_counter()
        trainer.step(GLUON_TRAIN_BATCH)
        host_ms.append((time.perf_counter() - t) * 1e3)
        acc.update([yy], [out])
        losses.append(float(loss.mean().asscalar()))

    torch.cuda.synchronize()
    _zero_counts()
    one_step()
    torch.cuda.synchronize()
    after_one = {k: v.detach().clone() for k, v in net.state_dict().items()}
    t0 = time.perf_counter()
    for _ in range(GLUON_TRAIN_STEPS - 1):
        one_step()
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / (GLUON_TRAIN_STEPS - 1) * 1e3
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(sbr_matmul=16 * GLUON_TRAIN_STEPS,
                sbr_conv3x3=16 * GLUON_TRAIN_STEPS)
    _expect(launches, want, "gluon_train")
    _finite(losses, "gluon_train")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profiled = _profile_summary(prof, wall)
    twin = get_resnet(1, 50, device="cuda:0", seed=seed + 41, **RESNET50)
    xd, yd = (torch.from_numpy(v).cuda() for v in (x, y))
    _train_step(twin)(xd, yd)
    ref = twin.state_dict()
    # the conv biases that feed a BatchNorm (a bottleneck's conv1 and
    # its 1x1 conv3) have a gradient that is 0 in exact arithmetic: after
    # one step they hold rounding noise, held to STEP_ATOL absolute;
    # every other leaf to GLUON_STEP_RTOL of its max
    zero_grad = [k for k in ref if k.endswith(GLUON_ZERO_GRAD_LEAVES)]
    worst, worst_key, noise, equal = 0.0, None, 0.0, 0
    for k, r in ref.items():
        err = (after_one[k] - r).abs().max().item()
        equal += err == 0.0
        if k in zero_grad:
            noise = max(noise, err)
            continue
        ratio = err / max(r.abs().max().item(), 1e-30)
        if ratio > worst:
            worst, worst_key = ratio, k
    emit({"phase": "gluon_train", "batch": GLUON_TRAIN_BATCH,
          "steps": GLUON_TRAIN_STEPS, "losses": losses,
          "accuracy": float(acc.get()[1]), "launches": launches,
          "ms_per_step": ms_per_step,
          "trainer_step_host_ms": sorted(host_ms)[len(host_ms) // 2],
          "trainable": sum(p.grad_req != "null"
                           for p in net.collect_params().values()),
          "fused_train_ms_per_step": fused_train_ms,
          "vs_train_step_worst_rel": worst, "vs_train_step_worst": worst_key,
          "vs_train_step_zero_grad_leaves": len(zero_grad),
          "vs_train_step_zero_grad_worst_abs": noise,
          "vs_train_step_bit_equal": f"{equal} of {len(ref)}",
          "rtol": GLUON_STEP_RTOL, "atol_zero_grad": STEP_ATOL,
          "profiled_step": {k: profiled[k] for k in (
              "wall_s", "device_busy_s", "device_idle_share",
              "device_ms_by_kind")}})
    if worst > GLUON_STEP_RTOL or noise > STEP_ATOL:
        fail(f"gluon_train: one Trainer step vs one TrainStep step, "
             f"{worst_key} is {worst} of its max off (zero-gradient "
             f"leaves {noise} absolute)")
    return launches


# data_train: ResNet-50 v1 training fed by the port's data pipeline.
# DATA_IMAGES seeded DATA_SIZE^2 RGB images as JPEG records (12 batches
# of TRAIN_BATCH), read by io.ImageRecordIter at DATA_CROP^2 in uint8 NHWC
# with random crops and mirrors on DATA_THREADS decode threads, staged on
# the card by DevicePrefetchIter (depth DATA_DEPTH) or not (depth 0), in
# epochs taken in turns; cast and normalised on the card by
# uint8_input_prep (the ImageNet mean and std)
DATA_IMAGES, DATA_SIZE, DATA_CROP = 1536, 256, 224
DATA_THREADS, DATA_DEPTH = 8, 2
DATA_EPOCHS = (DATA_DEPTH, 0, 0, DATA_DEPTH)
DATA_MEAN = (123.68, 116.28, 103.53)
DATA_STD = (58.395, 57.12, 57.375)
DATA_JPEG_QUALITY = 90
DATA_RESIDENT_STEPS, DATA_PROFILE_STEPS, DATA_DECODE_BATCHES = 5, 3, 4
# resnet_v2_serving: ResNet-50 v2, fuse_block=True, bf16, served with
# backpressure (a queue of 64, full_policy="block") and the watchdog on
V2_QUEUE_DEPTH, V2_WATCHDOG_S = 64, 2.0


def _decoders():
    """Which JPEG decoders this machine has: {"cv2": bool, "PIL": bool}."""
    found = {}
    for name in ("cv2", "PIL"):
        try:
            __import__(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def _synthetic_image(rs):
    """A seeded DATA_SIZE^2 RGB uint8 image: a smooth random field (an
    8x8 grid of colours, bilinearly enlarged) plus pixel noise, so a JPEG
    of it is ~20 KB, as a photograph's would be."""
    coarse = torch.from_numpy(rs.rand(1, 3, 8, 8).astype(np.float32))
    smooth = torch.nn.functional.interpolate(
        coarse, size=(DATA_SIZE, DATA_SIZE), mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0).numpy()
    noise = rs.rand(DATA_SIZE, DATA_SIZE, 3).astype(np.float32)
    return np.clip(smooth * 230 + noise * 25, 0, 255).astype(np.uint8)


def _write_records(prefix, seed, decoders):
    """DATA_IMAGES seeded images as JPEG records with an .idx (labels i
    mod 1000): OpenCV's encoder through recordio.pack_img when cv2 is
    there, else PIL's through recordio.pack.  Returns the .rec bytes."""
    from incubator_mxnet_tpu_torch import recordio
    rs = np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(DATA_IMAGES):
        img = _synthetic_image(rs)
        header = recordio.IRHeader(0, float(i % 1000), i, 0)
        if decoders["cv2"]:
            rec.write_idx(i, recordio.pack_img(header, img,
                                               quality=DATA_JPEG_QUALITY))
        else:
            import io as _stdio
            from PIL import Image
            buf = _stdio.BytesIO()
            Image.fromarray(img[:, :, ::-1]).save(
                buf, format="JPEG", quality=DATA_JPEG_QUALITY)
            rec.write_idx(i, recordio.pack(header, buf.getvalue()))
    rec.close()
    import os
    return os.path.getsize(prefix + ".rec")


class _KeepDrain:
    """A MetricDrain that also keeps every tensor pushed, so the drained
    values can be held against the same tensors read eagerly."""

    def __init__(self):
        from incubator_mxnet_tpu_torch.pipeline_io import MetricDrain
        self.drain = MetricDrain()
        self.kept = []

    def push(self, value):
        self.kept.append(value)
        return self.drain.push(value)

    def flush(self):
        return self.drain.flush()


def phase_data_train(seed, tmpdir):
    """ResNet-50 v1 training (bench.py's net with BENCH_FUSE_BLOCK=chain,
    TrainStep(bf16_compute=True)) fed by io.ImageRecordIter ->
    DevicePrefetchIter -> run_steps(drain=MetricDrain()), the images cast
    and normalised on the card by uint8_input_prep.  Four epochs of the
    same records in turns, prefetch on (depth 2), off (depth 0), off, on,
    with the kernel counts set to 0 just before them and read just after:
    B3 and B4 in their bf16 forms 16 times a step, nothing else.  Gates:
    a prefetched batch copied back equals its host batch byte for byte;
    the first batch's step on the prefetched batch has a loss within the
    spread of the same step fed from host memory twice (each on a fresh
    copy of the net); the drained losses equal the same tensors read
    eagerly, bit for bit; every loss is finite."""
    import os
    from incubator_mxnet_tpu_torch import io as mio
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.parallel import uint8_input_prep
    from incubator_mxnet_tpu_torch.pipeline_io import DevicePrefetchIter
    torch.cuda.empty_cache()
    decoders = _decoders()
    decoder = "cv2" if decoders["cv2"] else \
        "python" if decoders["PIL"] else None
    t0 = time.perf_counter()
    prefix = os.path.join(tmpdir, "train")
    rng = np.random.RandomState(seed + 20)
    if decoder is not None:
        rec_bytes = _write_records(prefix, seed + 20, decoders)
    else:
        # no decoder on this machine: the same seeded images, cropped to
        # 224 on the host, through NDArrayIter (ROADMAP: the record
        # reader's decode on the card waits for a decoder there)
        lo = (DATA_SIZE - DATA_CROP) // 2
        pixels = np.stack([_synthetic_image(rng)[lo:lo + DATA_CROP,
                                                 lo:lo + DATA_CROP]
                           for _ in range(DATA_IMAGES)])
        labels = (np.arange(DATA_IMAGES) % 1000).astype(np.float32)
        rec_bytes = 0
    records_s = time.perf_counter() - t0

    def reader(epoch):
        if decoder is None:
            return mio.NDArrayIter(pixels, labels, batch_size=TRAIN_BATCH,
                                   shuffle=True)
        return mio.ImageRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=(3, DATA_CROP, DATA_CROP), batch_size=TRAIN_BATCH,
            dtype="uint8", layout="NHWC", rand_crop=True, rand_mirror=True,
            shuffle=True, preprocess_threads=DATA_THREADS, decoder=decoder,
            seed=seed + epoch)

    # host decode of a batch with no step running, in the steady state
    # (the first batch, which pays the reader's set-up, left out)
    it = reader(100)
    host = [next(it)]
    t1 = time.perf_counter()
    host += [next(it) for _ in range(DATA_DECODE_BATCHES)]
    decode_ms = (time.perf_counter() - t1) / DATA_DECODE_BATCHES * 1e3
    it.close()
    hx, hy = host[0].data[0].asnumpy(), host[0].label[0].asnumpy()
    if hx.shape != (TRAIN_BATCH, DATA_CROP, DATA_CROP, 3) or \
            hx.dtype != np.uint8:
        fail(f"data_train: the reader gave {hx.shape} {hx.dtype}")

    def one_batch(depth):
        """The first host batch, through the prefetcher at depth."""
        src = mio.NDArrayIter(hx, hy, batch_size=TRAIN_BATCH)
        pf = DevicePrefetchIter(src, depth=depth)
        b = next(pf)
        pf.close()
        return b

    staged = one_batch(DATA_DEPTH)
    if staged.data[0]._data.device.type != "cuda" or \
            not np.array_equal(staged.data[0].asnumpy(), hx) or \
            not np.array_equal(staged.label[0].asnumpy(), hy):
        fail("data_train: a prefetched batch copied back differs from its "
             "host batch")
    prep = uint8_input_prep(DATA_MEAN, 1.0 / np.asarray(DATA_STD), "NHWC")
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **BENCH_CHAIN_NET)
    first = []
    for fed in ("host", "host", "prefetched"):
        twin = copy.deepcopy(net)
        step = _train_step(twin, bf16_compute=True, input_prep=prep)
        b = one_batch(0) if fed == "host" else staged
        first.append(step.run_steps(b.data[0], b.label[0],
                                    num_steps=1)[0].item())
        del step, twin
    lo, hi = min(first[:2]), max(first[:2])
    if not lo <= first[2] <= hi:
        fail(f"data_train: the first step's loss on the prefetched batch, "
             f"{first[2]!r}, lies outside the host-fed spread {first[:2]}")
    step = _train_step(net, bf16_compute=True, input_prep=prep)
    step.run_steps(staged.data[0], staged.label[0], num_steps=1)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    epochs, hits, stalls = [], 0, 0
    drained, kept = [], []
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step.resident_fastpath = 0
    for e, depth in enumerate(DATA_EPOCHS):
        pf = DevicePrefetchIter(reader(e), depth=depth)
        drain = _KeepDrain()
        t1 = time.perf_counter()
        n = 0
        out = []
        for b in pf:
            out += step.run_steps(b.data[0], b.label[0], num_steps=1,
                                  drain=drain)
            n += 1
        out += drain.flush()
        wall = time.perf_counter() - t1
        hits, stalls = hits + pf.hits, stalls + pf.stalls
        pf.close()
        epochs.append({"prefetch_depth": depth, "steps": n, "wall_s": wall,
                       "ms_per_step": wall / n * 1e3,
                       "images_per_s": n * TRAIN_BATCH / wall})
        drained += out
        kept += drain.kept
    launches = _counts()
    tel_snap = _telemetry().report(as_dict=True)
    peak = torch.cuda.max_memory_allocated()
    fastpath = step.resident_fastpath
    steps = sum(e["steps"] for e in epochs)
    # every batch passes two iterators, each counting it (the reader's
    # __next__ and the prefetcher's, as in the JAX package)
    tel = _held("data_train", tel_snap, {
        "io.batch.count": 2 * steps, "step.count": steps,
        "io.h2d_prefetch.hit": hits, "step.resident_fastpath.count":
        fastpath})
    if tel_snap.get("io.h2d_prefetch.stall", 0) != stalls:
        fail(f"data_train: io.h2d_prefetch.stall "
             f"{tel_snap.get('io.h2d_prefetch.stall')} vs {stalls}")
    want = dict.fromkeys(launches, 0)
    want.update(chain_stats_bf16=16 * steps, chain_emit_bf16=16 * steps)
    _expect(launches, want, f"the data-fed bf16 chain training path "
                            f"({steps} steps)")
    eager = [t.cpu().numpy() for t in kept]
    if len(drained) != steps or any(
            not np.array_equal(d, e) for d, e in zip(drained, eager)):
        fail("data_train: the drained losses differ from the same tensors "
             "read eagerly")
    losses = [float(v[0]) for v in drained]
    _finite(first + losses, "data-fed training")
    want_fast = sum(e["steps"] for e in epochs if e["prefetch_depth"])
    if fastpath != want_fast:
        fail(f"data_train: {fastpath} steps took the prefetched batch as it "
             f"was, expected {want_fast}")

    # the resident-batch step of the same net, and one profiled fed window
    t1 = time.perf_counter()
    step.run_steps(staged.data[0], staged.label[0],
                   num_steps=DATA_RESIDENT_STEPS)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t1) / DATA_RESIDENT_STEPS * 1e3
    from torch.profiler import ProfilerActivity, profile
    pf = DevicePrefetchIter(reader(99), depth=DATA_DEPTH)
    batches = [next(pf) for _ in range(DATA_PROFILE_STEPS + 1)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in batches[1:]:
            step.run_steps(b.data[0], b.label[0], num_steps=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    pf.close()
    on = [e["ms_per_step"] for e in epochs if e["prefetch_depth"]]
    off = [e["ms_per_step"] for e in epochs if not e["prefetch_depth"]]
    emit({"phase": "data_train",
          "reader": "ImageRecordIter" if decoder else "NDArrayIter",
          "decoder": decoder, "decoders": decoders,
          "records": DATA_IMAGES, "record_bytes": rec_bytes,
          "records_s": records_s, "batch": TRAIN_BATCH,
          "preprocess_threads": DATA_THREADS, "dtype": "bfloat16",
          "epochs": epochs, "ms_per_step_prefetch_on": on,
          "ms_per_step_prefetch_off": off,
          "resident_ms_per_step": resident_ms,
          "host_decode_ms_per_batch": decode_ms,
          "prefetch_hits": hits, "prefetch_stalls": stalls,
          "resident_fastpath": fastpath, "launches": launches,
          "telemetry": tel, "first_step_losses": {"host": first[:2], "prefetched": first[2]},
          "losses_first_last": [losses[0], losses[-1]],
          "peak_mem_gb": peak / 1e9, "setup_s": setup_s,
          "profiled_fed_window": dict({"steps": DATA_PROFILE_STEPS},
                                      **_profile_summary(prof, wall))})
    del step, net
    torch.cuda.empty_cache()
    return launches


def _fused_count(net, kernel):
    """The FusedBNReLUConv2D layers of ``net`` that run their kernel
    (inside its envelope) with this kernel size: each launches it once a
    forward in eval mode."""
    from incubator_mxnet_tpu_torch.gluon.nn._modules import \
        FusedBNReLUConv2D
    return sum(m.fused for m in net.modules()
               if isinstance(m, FusedBNReLUConv2D)
               and m.conv.kernel_size == kernel)


def phase_resnet_v2_serving(seed):
    """ResNet-50 v2 (fuse_block=True, NHWC) through BlockPredictor, bf16 on
    the card by default, under ModelServer(ServingConfig(max_batch=32,
    queue_depth=64, full_policy="block", watchdog_s=2.0)): warmup, then
    the burst with the kernel counts set to 0 just before it and read
    just after, queue_depth() sampled during it.  B1 and B2 run in their
    bf16 forms: B1 in every bottleneck's fused 1x1, B2 in the fused 3x3s
    of stride 1, counted from the net.  Gates: served vs direct
    pred.predict within RESNET_RTOL of max; the bf16 logits within
    BF16_EVAL_RTOL of max of the same net's fp32 predictor; the card's
    fp32 logits of 2 images within RESNET_RTOL of max of the port on the
    CPU; no watchdog stall; a full_policy="block" server of queue depth 1
    blocks a third submitter instead of raising, and its batcher is
    closed after close()."""
    import threading
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.predict import BlockPredictor
    from incubator_mxnet_tpu_torch.serving import ModelServer, ServingConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v2 = dict(RESNET50, layout="NHWC", fuse_block=True)
    net = get_resnet(2, 50, device="cuda:0", seed=seed, **v2)
    pred = BlockPredictor(net)
    if not pred.bf16_compute:
        fail("BlockPredictor's default on the card is not bf16")
    per_fwd = {"sbr_matmul_bf16": _fused_count(net, (1, 1)),
               "sbr_conv3x3_bf16": _fused_count(net, (3, 3))}
    cfg = ServingConfig(max_batch=MAX_BATCH, queue_depth=V2_QUEUE_DEPTH,
                        full_policy="block", watchdog_s=V2_WATCHDOG_S)
    server = ModelServer(pred, config=cfg, input_shapes=[IMAGE],
                         input_dtypes=["float32"])
    server.warmup()
    setup_s = time.perf_counter() - t0
    n_images = CLIENTS * PER_CLIENT + BATCH_REQS * BATCH_SIZE
    images = np.random.RandomState(seed + 30).rand(n_images, *IMAGE).astype(
        np.float32)
    depths, done = [], threading.Event()

    def sample():
        while not done.is_set():
            depths.append(server.queue_depth())
            time.sleep(0.001)
    sampler = threading.Thread(target=sample)
    before = server._counters()
    _zero_counts()
    sampler.start()
    got, lat, wall = _burst(server, images)
    done.set()
    sampler.join()
    launches = _counts()
    tel, own = _serving_held("resnet_v2_serving", server, before, BURST_REQUESTS)
    stats = server.stats()
    forwards = tel["serving.batch.count"]
    want = dict.fromkeys(launches, 0)
    want.update({k: v * forwards for k, v in per_fwd.items()})
    _expect(launches, want, f"ResNet-50 v2 bf16 serving ({forwards} "
                            f"forwards of {per_fwd})")
    stalls = stats["serving.watchdog.stall"]
    if stalls:
        fail(f"the serving watchdog counted {stalls} stalls in the burst")
    if got.shape != (n_images, 1000) or not np.isfinite(got).all():
        fail(f"bad served v2 logits: shape {got.shape}")
    direct = pred.predict(images, batch_size=MAX_BATCH).float().cpu().numpy()
    err = float(np.abs(got - direct).max())
    scale = float(np.abs(direct).max())
    if err > RESNET_RTOL * scale:
        fail(f"served v2 logits differ from direct forwards by {err} > "
             f"{RESNET_RTOL} x {scale}")
    fp32 = BlockPredictor(net, bf16_compute=False)
    ref = fp32.predict(images[:MAX_BATCH], batch_size=MAX_BATCH).cpu().numpy()
    bf16_err = float(np.abs(direct[:MAX_BATCH] - ref).max())
    bf16_scale = float(np.abs(ref).max())
    if bf16_err > BF16_EVAL_RTOL * bf16_scale:
        fail(f"v2 bf16 logits differ from fp32 by {bf16_err} > "
             f"{BF16_EVAL_RTOL} x {bf16_scale}")
    cpu = get_resnet(2, 50, device="cpu", seed=seed, **v2).eval()
    cpu.load_state_dict(net.state_dict())
    with torch.inference_mode():
        lg_cpu = cpu(torch.from_numpy(images[:2])).numpy()
    cpu_err = float(np.abs(ref[:2] - lg_cpu).max())
    cpu_scale = float(np.abs(lg_cpu).max())
    if cpu_err > RESNET_RTOL * cpu_scale:
        fail(f"card vs CPU v2 fp32 logits differ by {cpu_err} > "
             f"{RESNET_RTOL} x {cpu_scale}")
    peak = torch.cuda.max_memory_allocated()
    server.close()
    block = _blocking_check(pred, images[0])
    lat.sort()
    emit({"phase": "resnet_v2_serving", "images": n_images,
          "requests": len(lat), "wall_s": wall,
          "images_per_s": n_images / wall, "batches": forwards,
          "mean_fill": own["examples"] / own["padded"], "telemetry": tel,
          "e2e_p50_ms": lat[len(lat) // 2],
          "e2e_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
          "queue_depth_max": max(depths) if depths else 0,
          "queue_depth_samples": len(depths), "watchdog_stalls": stalls,
          "launches": launches, "launches_per_forward": per_fwd,
          "served_vs_direct_max_abs_err": err, "logits_abs_max": scale,
          "bf16_vs_fp32_max_abs_err": bf16_err,
          "fp32_logits_abs_max": bf16_scale,
          "card_vs_cpu_fp32_max_abs_err": cpu_err,
          "blocking_server": block, "setup_s": setup_s,
          "peak_mem_gb": peak / 1e9})
    del server, pred, fp32, net, cpu
    torch.cuda.empty_cache()
    return launches


def _blocking_check(pred, image):
    """A full_policy="block" server of queue depth 1 over ``pred`` behind
    a gate: one request in the predictor, one queued, a third submitter
    must block (not raise) until the gate opens, and the batcher is
    closed after close()."""
    import threading
    from incubator_mxnet_tpu_torch.serving import ModelServer, ServingConfig
    gate = threading.Event()

    def gated(x):
        if not gate.wait(60):
            fail("blocking check: the gate never opened")
        return pred(x)
    gated.device = pred.device
    server = ModelServer(gated, config=ServingConfig(
        max_batch=1, linger_us=0, queue_depth=1, full_policy="block"),
        input_shapes=[IMAGE])
    futs = [server.submit(image)]
    deadline = time.perf_counter() + 10
    while server.queue_depth() and time.perf_counter() < deadline:
        time.sleep(0.001)
    futs.append(server.submit(image))
    errors = []

    def third():
        try:
            futs.append(server.submit(image))
        except Exception as e:  # recorded: the gate below fails on it
            errors.append(repr(e))
    t = threading.Thread(target=third)
    t.start()
    t.join(0.5)
    blocked = t.is_alive()
    gate.set()
    t.join(60)
    outs = [f.result(timeout=60) for f in futs]
    server.close()
    closed = server._batcher.closed
    if not blocked or errors or len(outs) != 3 or not closed:
        fail(f"blocking check: blocked={blocked} errors={errors} "
             f"results={len(outs)} closed={closed}")
    return {"third_submitter_blocked": blocked, "results": len(outs),
            "closed_after_close": closed}


# ----------------------------------------------------------------- symbolic
# examples/train_imagenet.py's symbolic ResNet v2 (reference
# example/image-classification/symbols/resnet.py), copied here because
# examples/ imports the JAX package.  ``mx`` is the package that builds
# it (the port here; the tests also build it with the JAX package).
def sym_residual_unit(mx, data, num_filter, stride, dim_match, name,
                      bottle_neck=True):
    """The v2 pre-activation unit (train_imagenet.py:37-84)."""
    sym = mx.sym
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    if bottle_neck:
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        body = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                               stride=(1, 1), pad=(0, 0), no_bias=True,
                               name=name + "_conv3")
    else:
        conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        body = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
    return body + shortcut


def sym_resnet(mx, units, filter_list, num_classes, image_shape,
               bottle_neck=True):
    """The v2 network (train_imagenet.py:87-121), ending in
    SoftmaxOutput."""
    sym = mx.sym
    data = sym.var("data")
    (nchannel, height, _) = image_shape
    body = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=0.9,
                         name="bn_data")
    if height <= 32:  # CIFAR-style stem
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    for i, num_stage_units in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        body = sym_residual_unit(mx, body, filter_list[i + 1], stride, False,
                                 name=f"stage{i+1}_unit1",
                                 bottle_neck=bottle_neck)
        for j in range(num_stage_units - 1):
            body = sym_residual_unit(mx, body, filter_list[i + 1], (1, 1),
                                     True, name=f"stage{i+1}_unit{j+2}",
                                     bottle_neck=bottle_neck)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def sym_get_resnet(mx, num_layers, num_classes, image_shape):
    """Depth -> unit config (train_imagenet.py:124-140)."""
    if image_shape[1] <= 32:
        assert (num_layers - 2) % 9 == 0
        n = (num_layers - 2) // 9
        return sym_resnet(mx, [n, n, n], [16, 64, 128, 256], num_classes,
                          image_shape)
    configs = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
               50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
               152: ([3, 8, 36, 3], True)}
    units, bottle = configs[num_layers]
    filters = ([64, 64, 128, 256, 512] if not bottle
               else [64, 256, 512, 1024, 2048])
    return sym_resnet(mx, units, filters, num_classes, image_shape,
                      bottle_neck=bottle)


def _sym_bn_vars(mx, name):
    return {k: mx.sym.var(f"{name}_{k}")
            for k in ("gamma", "beta", "moving_mean", "moving_var")}


def _fusable(kernel, stride, pad):
    """Inside the fused kernels' envelope: stride 1 and a 1x1 pad-0 or
    3x3 pad-1 kernel."""
    return stride == (1, 1) and (kernel, pad) in (((1, 1), (0, 0)),
                                                  ((3, 3), (1, 1)))


def _sym_bn_relu_conv(mx, data, bn, bn_vars, conv, num_filter, kernel,
                      stride, pad, impl, fuse=True):
    """NHWC BatchNorm ``bn`` -> ReLU -> Convolution ``conv``: one
    ``_FusedBNReluConv`` node (its first output) inside the kernels'
    envelope when ``fuse``, else the three ops; either way under the
    checkpoint's parameter names."""
    sym = mx.sym
    if fuse and _fusable(kernel, stride, pad):
        kw = {} if impl is None else {"impl": impl}
        return sym._FusedBNReluConv(
            data, weight=sym.var(conv + "_weight"), kernel=kernel,
            stride=stride, pad=pad, num_filter=num_filter, no_bias=True,
            layout="NHWC", eps=2e-5, momentum=0.9, name=conv, **bn_vars,
            **kw)[0]
    act = sym.Activation(sym.BatchNorm(
        data, fix_gamma=False, eps=2e-5, momentum=0.9, axis=3, name=bn,
        **bn_vars), act_type="relu", name=bn + "_relu")
    return sym.Convolution(act, weight=sym.var(conv + "_weight"),
                           num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           layout="NHWC", name=conv)


def sym_resnet_fused(mx, units, filter_list, num_classes, image_shape,
                     impl=None, fuse=True):
    """``sym_resnet``'s bottleneck network (the same stem for
    ``image_shape``) rebuilt in NHWC with every
    pre-activation BN -> ReLU -> conv of a stride-1 1x1 or 3x3 conv as a
    ``_FusedBNReluConv`` node (B1 and B2 on the card), the same parameter
    names, ending in the logits (``fc1``).  ``impl`` is the fused nodes'
    attribute (the JAX op's ``pallas_interpret`` / ``xla`` in the
    tests).  With ``fuse=False`` the same NHWC graph has no fused node
    (BatchNorm, Activation and Convolution throughout).  Returns
    (symbol, 1x1 fused nodes, 3x3 fused nodes)."""
    sym = mx.sym
    data = sym.var("data")
    body = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=0.9,
                         axis=3, name="bn_data")
    counts = {(1, 1): 0, (3, 3): 0}

    def brc(x, bn, bn_vars, conv, num_filter, kernel, stride, pad):
        if fuse and _fusable(kernel, stride, pad):
            counts[kernel] += 1
        return _sym_bn_relu_conv(mx, x, bn, bn_vars, conv, num_filter,
                                 kernel, stride, pad, impl, fuse)
    if image_shape[1] <= 32:  # CIFAR-style stem
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, layout="NHWC", name="conv0")
    else:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, layout="NHWC", name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                             axis=3, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", layout="NHWC")
    for i, n_units in enumerate(units):
        nf = filter_list[i + 1]
        for j in range(n_units):
            name = f"stage{i+1}_unit{j+1}"
            stride = (2, 2) if i > 0 and j == 0 else (1, 1)
            v1 = _sym_bn_vars(mx, name + "_bn1")
            x = brc(body, name + "_bn1", v1, name + "_conv1", nf // 4,
                    (1, 1), (1, 1), (0, 0))
            x = brc(x, name + "_bn2", _sym_bn_vars(mx, name + "_bn2"),
                    name + "_conv2", nf // 4, (3, 3), stride, (1, 1))
            x = brc(x, name + "_bn3", _sym_bn_vars(mx, name + "_bn3"),
                    name + "_conv3", nf, (1, 1), (1, 1), (0, 0))
            shortcut = body if j > 0 else brc(
                body, name + "_bn1", v1, name + "_sc", nf, (1, 1), stride,
                (0, 0))
            body = x + shortcut
    body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                         axis=3, name="bn1")
    body = sym.Activation(body, act_type="relu", name="relu1")
    body = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", layout="NHWC", name="pool1")
    fc1 = sym.FullyConnected(sym.Flatten(body), num_hidden=num_classes,
                             name="fc1")
    return fc1, counts[(1, 1)], counts[(3, 3)]


def sym_fused_params(fused, arg_params, aux_params):
    """A checkpoint's (arg, aux) params as the fused symbol binds them:
    the moving statistics that only _FusedBNReluConv nodes read are
    arguments there (the JAX package's classification), so their
    ``aux:`` entries move to ``arg:``, by name."""
    args = set(fused.list_arguments())
    moved = {k: v for k, v in aux_params.items() if k in args}
    out_args = dict(arg_params, **moved)
    out_aux = {k: v for k, v in aux_params.items() if k not in args}
    return out_args, out_aux, sorted(moved)


# symbolic_train: examples/train_imagenet.py's ResNet-50 v2 through
# Module.fit with the example's settings, from data_train's records
SYM_LAYERS, SYM_CLASSES, SYM_IMAGE = 50, 1000, (3, 224, 224)
SYM_UNITS, SYM_FILTERS = [3, 4, 6, 3], [64, 256, 512, 1024, 2048]
SYM_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
SYM_MEAN = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94)
SYM_THREADS, SYM_SPEEDOMETER = 4, 5
SYM_RESIDENT_STEPS, SYM_REF_BATCH = 5, 2
# symbolic_serving: the checkpoint behind ModelServer at MAX_BATCH
SYM_SERVE_RTOL = 1e-4


def _sym_module_step(mx, sym, ctx, arg_params, aux_params, x, y):
    """One forward_backward + update of a Module on ``ctx`` from the given
    weights: (softmax outputs, mean cross-entropy, {name: tensor} of the
    updated arguments and moving statistics)."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SYM_OPT)
    mod.forward_backward(mx.io.DataBatch(
        data=[mx.nd.array(x, ctx=mx.cpu())],
        label=[mx.nd.array(y, ctx=mx.cpu())]))
    mod.update()
    p = mod.get_outputs()[0].asnumpy()
    loss = float(-np.log(p[np.arange(len(y)), y.astype(int)]).mean())
    args, aux = mod.get_params()
    state = {k: torch.from_numpy(v.asnumpy())
             for k, v in list(args.items()) + list(aux.items())}
    return p, loss, state


def phase_symbolic_train(seed, tmpdir):
    """ResNet-50 v2 (``sym_get_resnet(50, 1000, (3, 224, 224))``, NCHW,
    fp32, SoftmaxOutput) trained through ``mx.mod.Module(net,
    context=mx.gpu(0)).fit`` with the example's settings (SGD lr 0.05,
    momentum 0.9, wd 1e-4; Xavier gaussian/in/2; Speedometer(128, 5);
    do_checkpoint) for one epoch of data_train's 12 batches of 128 JPEG
    records through ImageRecordIter (224x224 random crops and mirrors,
    mean subtraction, 4 threads), the kernel counts set to 0 just before
    and read just after (the NCHW graph has no fused node: none
    launches); then SYM_RESIDENT_STEPS forward_backward + update steps on
    one resident batch (ms a step, images/s, peak memory) and one under
    torch.profiler (the idle share).  Gate: one b=2 Module step on the
    card against the same step on the CPU: loss and outputs within 1e-4
    of max, moving statistics within STEP_RTOL, parameters within
    SPREAD_FACTOR of the CPU's own spread: the larger of the same step
    of the graph after the FuseBatchNormRelu pass and of the same
    network in NHWC (``sym_resnet_fused(fuse=False)``).  Returns
    (launches, checkpoint prefix)."""
    import os
    import incubator_mxnet_tpu_torch as mx
    torch.cuda.empty_cache()
    rec = os.path.join(tmpdir, "train")
    if not os.path.exists(rec + ".rec"):
        fail("symbolic_train: data_train wrote no JPEG records (no decoder "
             "on this machine)")
    decoder = "cv2" if _decoders()["cv2"] else "python"
    mx.random.seed(seed)
    net = sym_get_resnet(mx, SYM_LAYERS, SYM_CLASSES, SYM_IMAGE)
    train = mx.io.ImageRecordIter(
        path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
        data_shape=SYM_IMAGE, batch_size=TRAIN_BATCH, shuffle=True,
        rand_crop=True, rand_mirror=True, resize=-1,
        preprocess_threads=SYM_THREADS, decoder=decoder, seed=seed,
        **SYM_MEAN)
    prefix = os.path.join(tmpdir, "resnet50_v2")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    acc = mx.metric.Accuracy()
    speed = mx.callback.Speedometer(TRAIN_BATCH, SYM_SPEEDOMETER)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=acc, optimizer="sgd",
            optimizer_params=SYM_OPT,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=speed,
            epoch_end_callback=mx.callback.do_checkpoint(prefix),
            num_epoch=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _counts()
    fit_peak = torch.cuda.max_memory_allocated()
    train.close()
    _expect(launches, dict.fromkeys(launches, 0),
            "Module.fit of the NCHW ResNet-50 v2")
    if not (os.path.exists(prefix + "-symbol.json")
            and os.path.exists(prefix + "-0001.params")):
        fail("symbolic_train: do_checkpoint wrote no checkpoint")
    args, aux = mod.get_params()
    if not all(np.isfinite(v.asnumpy()).all() for v in args.values()):
        fail("symbolic_train: non-finite parameters after fit")

    # the resident step: one batch on the card, forward_backward + update
    rs = np.random.RandomState(seed + 40)
    xd = mx.nd.array(rs.rand(TRAIN_BATCH, *SYM_IMAGE).astype(np.float32),
                     ctx=mx.gpu(0))
    yd = mx.nd.array(rs.randint(0, SYM_CLASSES, TRAIN_BATCH).astype(
        np.float32), ctx=mx.gpu(0))
    batch = mx.io.DataBatch(data=[xd], label=[yd])
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for _ in range(SYM_RESIDENT_STEPS):
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / SYM_RESIDENT_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    for _ in range(SYM_RESIDENT_STEPS):
        mod.forward_backward(batch)
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t1) / SYM_RESIDENT_STEPS * 1e3
    t1 = time.perf_counter()
    for _ in range(SYM_RESIDENT_STEPS):
        mod.update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t1) / SYM_RESIDENT_STEPS * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    profiled = _profile_summary(prof, wall)
    del mod, batch, xd, yd
    torch.cuda.empty_cache()

    # the gate: one b=2 step from the fitted weights, card vs CPU
    init_args = {k: v.asnumpy() for k, v in args.items()}
    init_aux = {k: v.asnumpy() for k, v in aux.items()}
    x = rs.rand(SYM_REF_BATCH, *SYM_IMAGE).astype(np.float32) * 100
    y = rs.randint(0, SYM_CLASSES, SYM_REF_BATCH).astype(np.float32)
    t1 = time.perf_counter()
    runs = {}
    # the CPU's own spread: the graph after the FuseBatchNormRelu pass
    # (nearly the same arithmetic), and the same math in NHWC (other
    # conv and reduction orders: the formulation that shows how far fp32
    # itself reproduces a b=2 step through 50 BatchNorms)
    fused_net = mx.sym.passes.apply_pass(net, "FuseBatchNormRelu").symbol
    nhwc_net = mx.sym.SoftmaxOutput(sym_resnet_fused(
        mx, SYM_UNITS, SYM_FILTERS, SYM_CLASSES, SYM_IMAGE, fuse=False)[0],
        name="softmax")
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for key, sym, ctx, xx in (("card", net, mx.gpu(0), x),
                              ("cpu", net, mx.cpu(), x),
                              ("cpu_fused", fused_net, mx.cpu(), x),
                              ("cpu_nhwc", nhwc_net, mx.cpu(), xh)):
        with ctx:
            runs[key] = _sym_module_step(
                mx, sym, ctx, {k: mx.nd.array(v) for k, v in
                               init_args.items()},
                {k: mx.nd.array(v) for k, v in init_aux.items()}, xx, y)
    ref_s = time.perf_counter() - t1
    (p_gpu, loss_gpu, got), (p_cpu, loss_cpu, ref) = runs["card"], \
        runs["cpu"]
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    out_err = float(np.abs(p_gpu - p_cpu).max())
    out_scale = float(np.abs(p_cpu).max())
    stats = [k for k in ref if k.endswith(("moving_mean", "moving_var"))]
    params = [k for k in ref if k not in stats]
    stats_worst, stats_key = _worst(got, ref, stats)
    params_worst, params_key = _worst(got, ref, params)
    spreads = {k: _worst(runs[k][2], ref, params)
               for k in ("cpu_fused", "cpu_nhwc")}
    spread, spread_key = max(spreads.values(), key=lambda v: v[0])
    emit({"phase": "symbolic_train", "net": "resnet50_v2 (symbol, NCHW)",
          "batch": TRAIN_BATCH, "reader": "ImageRecordIter",
          "decoder": decoder, "preprocess_threads": SYM_THREADS,
          "epoch_batches": speed.last_count + 1,
          "fit_s": fit_s, "fit_images_per_s":
          (speed.last_count + 1) * TRAIN_BATCH / fit_s,
          "speedometer_samples_per_s": speed.speeds,
          "train_accuracy": float(acc.get()[1]),
          "fit_peak_mem_gb": fit_peak / 1e9, "launches": launches,
          "resident_ms_per_step": step_ms,
          "resident_images_per_s": TRAIN_BATCH / step_ms * 1e3,
          "forward_backward_ms": fb_ms, "update_ms": update_ms,
          "peak_mem_gb": peak / 1e9,
          "profiled_step": {k: profiled[k] for k in (
              "wall_s", "device_busy_s", "device_idle_share",
              "device_ms_by_kind", "top_kernels")},
          "reference": {
              "batch": SYM_REF_BATCH, "loss_card": loss_gpu,
              "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
              "outputs_max_abs_err": out_err, "outputs_abs_max": out_scale,
              "stats_worst_over_bound": stats_worst, "stats_worst": stats_key,
              "params_worst_over_bound": params_worst,
              "params_worst": params_key,
              "cpu_spread_worst_over_bound": spread,
              "cpu_spread_worst": spread_key,
              "cpu_spread_by_formulation": spreads,
              "spread_factor": SPREAD_FACTOR, "rtol": STEP_RTOL,
              "tensors": len(ref), "seconds": ref_s}})
    if not math.isfinite(loss_gpu) or loss_rel > STEP_LOSS_RTOL:
        fail(f"symbolic_train: card vs CPU loss {loss_gpu} vs {loss_cpu}")
    if out_err > STEP_LOSS_RTOL * out_scale:
        fail(f"symbolic_train: card vs CPU outputs differ by {out_err} > "
             f"{STEP_LOSS_RTOL} x {out_scale}")
    if stats_worst > 1.0:
        fail(f"symbolic_train: card vs CPU moving statistics: {stats_key} "
             f"is {stats_worst} x its bound off")
    if params_worst > max(1.0, SPREAD_FACTOR * spread):
        fail(f"symbolic_train: card vs CPU parameters after one step: "
             f"{params_key} is {params_worst} x its bound off, the CPU's "
             f"own spread {spread}")
    torch.cuda.empty_cache()
    return launches, prefix


def phase_symbolic_serving(seed, prefix):
    """The checkpoint of symbolic_train served: ``load_checkpoint_predictor
    (prefix, 1, {"data": (32, 3, 224, 224)})`` under ``ModelServer(
    predictor, max_batch=32)`` (one ``Predictor.reshape`` per bucket),
    warmed up, then V1 serving's burst with the kernel counts set to 0
    just before and read just after (none launches).  Gates: served
    outputs equal a direct ``Predictor.forward`` of the same images at
    b=32 within SYM_SERVE_RTOL of max; the Predictor's outputs equal the
    Module's (``Module.load``, ``is_train=False``) on 32 images within
    SYM_SERVE_RTOL of max.  Also the PlanMemory pass's bytes at b=32 on
    the card."""
    import incubator_mxnet_tpu_torch as mx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = mx.predict.load_checkpoint_predictor(
        prefix, 1, {"data": (MAX_BATCH,) + SYM_IMAGE})
    server = mx.serving.ModelServer(pred, max_batch=MAX_BATCH)
    server.warmup()
    setup_s = time.perf_counter() - t0
    n_images = CLIENTS * PER_CLIENT + BATCH_REQS * BATCH_SIZE
    images = np.random.RandomState(seed + 50).rand(
        n_images, *SYM_IMAGE).astype(np.float32) * 100
    before = server._counters()
    _zero_counts()
    got, lat, wall = _burst(server, images)
    launches = _counts()
    tel, own = _serving_held("symbolic_serving", server, before, BURST_REQUESTS)
    buckets = sorted(server._runner.by_bucket)
    server.close()
    _expect(launches, dict.fromkeys(launches, 0),
            "serving the NCHW ResNet-50 v2 checkpoint")
    if got.shape != (n_images, SYM_CLASSES) or not np.isfinite(got).all():
        fail(f"symbolic_serving: bad served outputs {got.shape}")
    direct = np.concatenate([
        pred.forward(data=images[i:i + MAX_BATCH])[0].asnumpy()
        for i in range(0, n_images, MAX_BATCH)])
    err = float(np.abs(got - direct).max())
    scale = float(np.abs(direct).max())
    # the PlanMemory pass on the card: the bytes of the arguments and
    # outputs, and what one b=32 eval forward allocates beyond them
    graph = mx.sym.passes.apply_pass(pred._symbol, "InferShape",
                                     data=(MAX_BATCH,) + SYM_IMAGE)
    memory = mx.sym.passes.apply_pass(graph, "PlanMemory",
                                      ctx=mx.gpu(0)).attrs["memory"]
    mod = mx.mod.Module.load(prefix, 1, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (MAX_BATCH,) + SYM_IMAGE)],
             for_training=False)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(images[:MAX_BATCH],
                                                  ctx=mx.cpu())]),
                is_train=False)
    mod_err = float(np.abs(mod.get_outputs()[0].asnumpy()
                           - direct[:MAX_BATCH]).max())
    peak = torch.cuda.max_memory_allocated()
    lat.sort()
    emit({"phase": "symbolic_serving", "images": n_images,
          "requests": len(lat), "wall_s": wall,
          "images_per_s": n_images / wall,
          "batches": tel["serving.batch.count"],
          "mean_fill": own["examples"] / own["padded"], "telemetry": tel,
          "e2e_p50_ms": lat[len(lat) // 2],
          "e2e_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
          "executors_by_bucket": {str(b): 1 for b in buckets},
          "executors": len(buckets), "launches": launches,
          "served_vs_direct_max_abs_err": err, "outputs_abs_max": scale,
          "predictor_vs_module_max_abs_err": mod_err,
          "plan_memory_b32": memory,
          "rtol": SYM_SERVE_RTOL, "setup_s": setup_s,
          "peak_mem_gb": peak / 1e9})
    if err > SYM_SERVE_RTOL * scale:
        fail(f"symbolic_serving: served outputs differ from direct "
             f"forwards by {err} > {SYM_SERVE_RTOL} x {scale}")
    if mod_err > SYM_SERVE_RTOL * scale:
        fail(f"symbolic_serving: Predictor vs Module outputs differ by "
             f"{mod_err} > {SYM_SERVE_RTOL} x {scale}")
    del pred, server, mod
    torch.cuda.empty_cache()
    return launches


def phase_symbolic_fused(seed, prefix):
    """The checkpoint's weights in the NHWC graph of ``sym_resnet_fused``
    (B1 in conv1 and conv3 of every unit and stage 1's shortcut, B2 in
    conv2 of the 13 stride-1 units), through a Predictor at b=32 on the
    card, beside the NCHW unfused logits (``fc1_output``).  One forward
    with the kernel counts set to 0 just before and read just after:
    sbr_matmul and sbr_conv3x3 as many times as the graph has fused
    nodes, nothing else.  Gates: those counts; the logits within
    RESNET_RTOL of max of the unfused Predictor's; at each distinct
    shape the path gave a kernel (its inputs recorded in one more
    forward), the kernel against its plain version (CONV_RTOL of max);
    infer_shape and binding launch nothing.  Times one forward of each,
    and profiles one of each (device time by kind, the idle share)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    torch.cuda.empty_cache()
    sym, args, aux = mx.model.load_checkpoint(prefix, 1)
    fused, n1, n3 = sym_resnet_fused(mx, SYM_UNITS, SYM_FILTERS, SYM_CLASSES,
                                     SYM_IMAGE)
    fargs, faux, moved = sym_fused_params(fused, args, aux)
    _zero_counts()
    shape = (MAX_BATCH,) + SYM_IMAGE[1:] + SYM_IMAGE[:1]
    fpred = mx.predict.Predictor(
        fused, dict({f"arg:{k}": v for k, v in fargs.items()},
                    **{f"aux:{k}": v for k, v in faux.items()}),
        {"data": shape})
    bind_launches = _counts()
    _expect(bind_launches, dict.fromkeys(bind_launches, 0),
            "infer_shape and binding of the fused graph")
    upred = mx.predict.Predictor(
        sym.get_internals()["fc1_output"],
        dict({f"arg:{k}": v for k, v in args.items()},
             **{f"aux:{k}": v for k, v in aux.items()}),
        {"data": (MAX_BATCH,) + SYM_IMAGE})
    x = np.random.RandomState(seed + 60).rand(
        MAX_BATCH, *SYM_IMAGE).astype(np.float32) * 100
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = upred.forward(data=x)[0].asnumpy()
    _zero_counts()
    got = fpred.forward(data=xh)[0].asnumpy()
    torch.cuda.synchronize()
    launches = _counts()
    want = dict.fromkeys(launches, 0)
    want.update(sbr_matmul=n1, sbr_conv3x3=n3)
    _expect(launches, want, f"one forward of the fused NHWC graph "
                            f"({n1} 1x1 and {n3} 3x3 fused nodes)")
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    # the kernels at the path's own shapes and inputs
    seen = {}
    wrappers = {"sbr_matmul": (fc.sbr_matmul, fc._sbr_matmul_plain),
                "sbr_conv3x3": (fc.sbr_conv3x3, fc._sbr_conv3x3_plain)}

    def recorder(name):
        kern = wrappers[name][0]

        def call(xt, a, b, w, bias):
            seen.setdefault((name, tuple(xt.shape), w.shape[0]),
                            (xt, a, b, w, bias))
            return kern(xt, a, b, w, bias)
        # the wrapper counts its launch on the module's name, which is
        # this recorder while it stands in: the recording's launches
        # land here, outside the counts
        call.launches = call.launches_bf16 = 0
        return call
    for name in wrappers:
        setattr(fc, name, recorder(name))
    try:
        fpred.forward(data=xh)
    finally:
        for name, (kern, _) in wrappers.items():
            setattr(fc, name, kern)
    rows = []
    for (name, xs, cout), ins in sorted(seen.items()):
        kern, plain = wrappers[name]
        out, pl = kern(*ins), plain(*ins)
        e = (out - pl).abs().max().item()
        s = pl.abs().max().item()
        rows.append({"kernel": name, "x": list(xs), "cout": cout,
                     "max_abs_err": e, "ref_abs_max": s})
        if e > CONV_RTOL * s:
            fail(f"symbolic_fused: {name} vs its plain version at {xs} -> "
                 f"{cout}: {e} > {CONV_RTOL} x {s}")
    # one forward each on the inputs already on the card
    fpred.set_input("data", xh)
    upred.set_input("data", x)
    fused_ms = time_ms(fpred.forward, iters=5, warmup=1)
    unfused_ms = time_ms(upred.forward, iters=5, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    profiled = {}
    for key, pred in (("fused", fpred), ("unfused", upred)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            pred.forward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        summary = _profile_summary(prof, wall)
        summary["top_kernels"] = summary["top_kernels"][:8]
        profiled[key] = summary
    emit({"phase": "symbolic_fused", "batch": MAX_BATCH,
          "fused_nodes": {"1x1": n1, "3x3": n3}, "launches": launches,
          "moved_aux_to_arg": len(moved),
          "logits_max_abs_err": err, "logits_abs_max": scale,
          "rtol": RESNET_RTOL, "path_shapes": rows,
          "fused_forward_ms": fused_ms, "unfused_forward_ms": unfused_ms,
          "profiled_forward": profiled})
    if err > RESNET_RTOL * scale:
        fail(f"symbolic_fused: fused logits differ from the unfused by "
             f"{err} > {RESNET_RTOL} x {scale}")
    del fpred, upred
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- recurrent
# phase rnn_op: (mode, T, N, input, hidden, layers, bidirectional); the
# first is the word LM's LSTM
RNN_OP_CASES = (("lstm", 35, 32, 650, 650, 2, False),
                ("gru", 20, 16, 200, 200, 2, False),
                ("rnn_tanh", 20, 16, 200, 200, 2, False),
                ("lstm", 20, 16, 200, 200, 2, True))
# cuDNN vs the plain composition on the card, both fp32 with TF32 off:
# outputs, final states and gradients within RNN_OP_RTOL of each
# tensor's max |value| (other summation orders through up to 70 steps)
RNN_OP_RTOL = 1e-4
RNN_OP_ITERS = 20
# phase rnn_lm_train: examples/word_language_model.py's tied LSTM LM at
# the width of MXNet's example/gluon/word_language_model README medium
# run (--emsize 650 --nhid 650 --nlayers 2 --dropout 0.5 --tied, bptt
# 35, batch 32), WikiText-2's vocabulary (33,278 with <unk> and <eos>)
# over a synthetic token file; Adam and clip_global_norm with the
# example's defaults (lr 0.003, clip 0.25 per token)
LM_VOCAB = 33278
LM_WIDTH = 650
LM_LAYERS = 2
LM_DROPOUT = 0.5
LM_BPTT = 35
LM_BATCH = 32
LM_LR = 0.003
LM_CLIP = 0.25
LM_TOKENS = 90000
LM_WARMUP = 2
LM_WINDOWS = 3
LM_WINDOW_STEPS = 5
LM_EVAL_BATCHES = 4
LM_REF_BATCH = 8
# phase rnn_bucketing: MXNet's example/rnn/bucketing/lstm_bucketing.py
# (num-hidden 200, num-embed 200, num-layers 2, batch 32, buckets
# 10..60, lr 0.01, wd 1e-5; the repository's example trains with Adam)
# over 10,000 words, and its cudnn_lstm_bucketing.py (FusedRNNCell)
BUCKET_VOCAB = 10000
BUCKET_WIDTH = 200
BUCKET_LAYERS = 2
BUCKET_BATCH = 32
BUCKETS = (10, 20, 30, 40, 50, 60)
BUCKET_BATCHES = 3          # batches per bucket in the fit epoch
BUCKET_TIMED = 3            # resident batches timed per bucket
BUCKET_OPT = {"learning_rate": 0.01, "wd": 1e-5}
BUCKET_REF_KEY = 30


def word_lm(mx, vocab, width, layers, dropout, prefix="rnnmodel_",
            cells=False):
    """examples/word_language_model.py's RNNModel with tied weights
    (embedding -> dropout -> fused LSTM -> dropout -> a Dense decoder
    sharing the embedding's weight), built from ``mx`` (the JAX package
    or the port; only the package differs).  ``cells=True`` runs the
    LSTM as unrolled ``gluon.rnn.LSTMCell``s under the fused layer's
    parameter names (another fp32 formulation of the same function; no
    dropout between its layers)."""
    nn = mx.gluon.nn

    class RNNModel(mx.gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab, width)
                if cells:
                    self.rnn = mx.gluon.rnn.SequentialRNNCell(prefix="lstm0_")
                    with self.rnn.name_scope():
                        for i in range(layers):
                            self.rnn.add(mx.gluon.rnn.LSTMCell(
                                width, input_size=width, prefix=f"l{i}_"))
                else:
                    self.rnn = mx.gluon.rnn.LSTM(width, layers,
                                                 dropout=dropout,
                                                 input_size=width)
                self.decoder = nn.Dense(vocab, in_units=width,
                                        params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            if cells:
                states = [s[i] for i in range(layers) for s in hidden]
                output, states = self.rnn.unroll(
                    inputs.shape[0], emb, begin_state=states, layout="TNC",
                    merge_outputs=True)
                hidden = [mx.nd.stack(*states[k::2], axis=0)
                          for k in (0, 1)]
            else:
                output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, width)))
            return decoded, hidden

        def begin_state(self, *args, **kwargs):
            if not cells:
                return self.rnn.begin_state(*args, **kwargs)
            # the fused layer's (layers, batch, width) h and c
            batch = kwargs["batch_size"] if "batch_size" in kwargs \
                else args[0]
            return [mx.nd.zeros((layers, batch, width), ctx=kwargs.get("ctx"))
                    for _ in range(2)]

    return RNNModel(prefix=prefix)


def write_wikitext(path, words, tokens, seed):
    """A token file in WikiText-2's format (one paragraph a line, tokens
    split by spaces, blank lines between paragraphs) holding each of
    ``words`` distinct words at least once among ``tokens`` tokens, the
    rest drawn Zipf-like, all shuffled, from ``seed``."""
    rs = np.random.RandomState(seed)
    ids = rs.permutation(np.concatenate([
        np.arange(words), np.minimum(rs.zipf(1.2, tokens - words) - 1,
                                     words - 1)]))
    lines, i = [], 0
    while i < len(ids):
        n = int(rs.randint(10, 90))
        lines.append(" " + " ".join(f"w{k}" for k in ids[i:i + n]) + " ")
        lines.append("")
        i += n
    with open(path, "w", encoding="utf8") as f:
        f.write("\n".join(lines))


def word_lm_steps(mx, model, trainer, batches, ctx, hidden, batch,
                  bptt=LM_BPTT, clip=LM_CLIP, grads=None):
    """examples/word_language_model.py's training loop over ``batches``
    of (data, label), each (batch, bptt) from the DataLoader: the hidden
    state carried and detached, the summed cross-entropy's gradients
    clipped to ``clip * bptt * batch`` by ``clip_global_norm``, then
    ``trainer.step``.  Returns (each step's loss NDArray, hidden).  A
    ``grads`` dict gets, by parameter name, the last step's gradients
    before and after clipping (float64 CPU tensors)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in model.collect_params().values()
              if p.grad_req != "null"]
    losses = []
    for data, label in batches:
        data = mx.nd.transpose(data.as_in_context(ctx), axes=(1, 0))
        label = mx.nd.transpose(label.as_in_context(ctx),
                                axes=(1, 0)).reshape((-1,))
        hidden = [h.detach() for h in hidden]
        with mx.autograd.record():
            out, hidden = model(data, hidden)
            loss = loss_fn(out, label)
        loss.backward()
        raw = [_f64(p.grad()) for p in params] if grads is not None \
            else None
        mx.gluon.utils.clip_global_norm([p.grad() for p in params],
                                        clip * bptt * batch)
        if grads is not None:
            for p, g in zip(params, raw):
                grads[p.name] = (g, _f64(p.grad()))
        trainer.step(batch * bptt)
        losses.append(loss)
    return losses, hidden


def bucket_stack(mx, hidden, layers, fused):
    """The bucketing examples' cell stack: ``layers`` legacy LSTMCells
    (``lstm_l{i}_``, lstm_bucketing.py) or one FusedRNNCell of as many
    layers (``lstm_``, cudnn_lstm_bucketing.py), whose ``unfuse()`` gives
    cells of the same names."""
    if fused:
        return mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm",
                                   prefix="lstm_")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=hidden, prefix=f"lstm_l{i}_"))
    return stack


def bucket_sym_gen(mx, stack, vocab, embed, hidden, invalid_label=-1):
    """examples/rnn_bucketing.py's ``sym_gen``: embedding, the stack
    unrolled over the bucket's length, a classifier over the vocabulary
    and SoftmaxOutput ignoring the padding label."""
    sym = mx.sym

    def sym_gen(seq_len):
        data = sym.var("data")
        label = sym.var("softmax_label")
        emb = sym.Embedding(data, input_dim=vocab, output_dim=embed,
                            name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(pred, label=label, name="softmax",
                                 use_ignore=True, ignore_label=invalid_label)
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def bucket_sentences(seed, vocab, buckets, per_bucket):
    """``per_bucket`` sentences of ids below ``vocab`` for each bucket,
    their lengths uniform above the bucket below it."""
    rs = np.random.RandomState(seed)
    sentences, low = [], 0
    for b in buckets:
        for _ in range(per_bucket):
            sentences.append(rs.randint(0, vocab, rs.randint(low + 1, b + 1))
                             .tolist())
        low = b
    return sentences


def _rnn_op_inputs(gen, mode, t, n, isz, h, layers, bi):
    from incubator_mxnet_tpu_torch.ops.rnn import rnn_param_size
    d = 2 if bi else 1
    k = 1.0 / math.sqrt(h)

    def u(*shape):
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * k
    x = torch.randn(t, n, isz, generator=gen, device="cuda")
    params = u(rnn_param_size(layers, isz, h, bi, mode))
    h0 = u(layers * d, n, h)
    c0 = u(layers * d, n, h) if mode == "lstm" else None
    return [x, params, h0, c0]


def _rnn_route(route, inputs, mode, h, layers, bi, heads=None):
    """One forward (and with ``heads`` a backward of sum(out * head))
    of the RNN op's cuDNN route or its plain composition, on the card:
    (outputs, gradients of the inputs)."""
    from incubator_mxnet_tpu_torch.ops import get_op
    from incubator_mxnet_tpu_torch.ops.rnn import _plain, slice_rnn_weights
    x, params, h0, c0 = [None if a is None else
                         a.detach().requires_grad_(heads is not None)
                         for a in inputs]
    with torch.set_grad_enabled(heads is not None):
        if route == "cudnn":
            outs = get_op("RNN").fn(None, x, params, h0, c0, state_size=h,
                                    num_layers=layers, mode=mode,
                                    bidirectional=bi, state_outputs=True)
        else:
            w = slice_rnn_weights(params, layers, x.shape[2], h, bi, mode)
            outs = _plain(None, x, w, h0, c0, mode, layers, 2 if bi else 1,
                          0.0)
            outs = outs if mode == "lstm" else outs[:2]
    if heads is None:
        return list(outs), []
    leaves = [a for a in (x, params, h0, c0) if a is not None]
    grads = torch.autograd.grad(list(outs), leaves, heads)
    return [o.detach() for o in outs], list(grads)


def rnn_bound_ms(mode, t, n, isz, h, layers, bi):
    """Least time for the op's forward: 2 flops per multiply-add of the
    gate products (the input and the recurrent ones, every layer and
    direction, fp32-accurate), x, the parameters and the states read
    and the output and final states written once (fp32)."""
    from incubator_mxnet_tpu_torch.ops.rnn import _NUM_GATES, rnn_param_size
    g, d = _NUM_GATES[mode], 2 if bi else 1
    flops = sum(2.0 * t * n * g * h * ((isz if i == 0 else d * h) + h) * d
                for i in range(layers))
    states = (2 if mode == "lstm" else 1) * layers * d * n * h
    nbytes = 4.0 * (t * n * isz + rnn_param_size(layers, isz, h, bi, mode)
                    + 2 * states + t * n * d * h)
    return _bound(flops, nbytes, torch.float32)


def phase_rnn_op(seed):
    """The RNN op's cuDNN route (``torch._VF``, the views cut from the
    flat vector) against its plain composition, both on the card in fp32
    with TF32 off, for RNN_OP_CASES: outputs, final states and the
    gradients of every input under random head gradients within
    RNN_OP_RTOL of each tensor's max.  Times (CUDA events) of each
    route's forward and forward + backward over RNN_OP_ITERS calls, and
    on the LM case of ``torch.nn.LSTM`` with its weights flattened into
    cuDNN's packed buffer (the library call), in turns with the cuDNN
    route's forward (route, library, library, route): the difference is
    the cost of copying the views into that buffer each call.
    ``ops.rnn.cudnn_calls`` is read around the phase."""
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_mod
    from incubator_mxnet_tpu_torch.ops.rnn import slice_rnn_weights
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 60)
    calls0, made = rnn_mod.cudnn_calls, [0]
    cases, worst = [], 0.0
    for mode, t, n, isz, h, layers, bi in RNN_OP_CASES:
        inputs = _rnn_op_inputs(gen, mode, t, n, isz, h, layers, bi)

        def run(route, heads=None):
            made[0] += route == "cudnn"
            return _rnn_route(route, inputs, mode, h, layers, bi, heads)
        ref, _ = run("plain")
        heads = [torch.randn(o.shape, generator=gen, device="cuda")
                 for o in ref]
        got = {r: run(r, heads) for r in ("cudnn", "plain")}
        errs = {}
        for kind, idx in (("outputs", 0), ("gradients", 1)):
            for i, (a, b) in enumerate(zip(got["cudnn"][idx],
                                           got["plain"][idx])):
                errs[f"{kind}[{i}]"] = (a - b).abs().max().item() / max(
                    b.abs().max().item(), 1e-30)
        case_worst = max(errs.values())
        worst = max(worst, case_worst)
        ms = {}
        for r in ("cudnn", "plain"):
            ms[r] = time_ms(lambda r=r: run(r), iters=RNN_OP_ITERS)
            ms[r + "_fwd_bwd"] = time_ms(lambda r=r: run(r, heads),
                                         iters=RNN_OP_ITERS)
        library = None
        if mode == "lstm" and not bi and isz == LM_WIDTH:
            lstm = torch.nn.LSTM(isz, h, layers).cuda()
            with torch.no_grad():
                views = slice_rnn_weights(inputs[1], layers, isz, h, bi,
                                          mode)
                for i in range(layers):
                    for name, v in zip(("weight_ih", "weight_hh", "bias_ih",
                                        "bias_hh"), views[i][0]):
                        getattr(lstm, f"{name}_l{i}").copy_(v)
            lstm.flatten_parameters()
            x, _, h0, c0 = inputs
            with torch.no_grad():
                lib_out = lstm(x, (h0, c0))[0]
            lib_err = (lib_out - ref[0]).abs().max().item() / \
                ref[0].abs().max().item()
            with torch.no_grad():
                turns = [time_ms(lambda: run("cudnn"), iters=RNN_OP_ITERS)
                         if k == "cudnn" else
                         time_ms(lambda: lstm(x, (h0, c0)),
                                 iters=RNN_OP_ITERS)
                         for k in ("cudnn", "lib", "lib", "cudnn")]
            ms["cudnn_turns"] = (turns[0] + turns[3]) / 2
            library = (turns[1] + turns[2]) / 2
            if lib_err > RNN_OP_RTOL:
                fail(f"rnn_op: torch.nn.LSTM vs the plain route {lib_err}")
        bound, bound_by = rnn_bound_ms(mode, t, n, isz, h, layers, bi)
        cases.append({"mode": mode, "T": t, "N": n, "input": isz,
                      "hidden": h, "layers": layers, "bidirectional": bi,
                      "rel_err": errs, "cudnn_ms": ms["cudnn"],
                      "plain_ms": ms["plain"],
                      "cudnn_fwd_bwd_ms": ms["cudnn_fwd_bwd"],
                      "plain_fwd_bwd_ms": ms["plain_fwd_bwd"],
                      "library_ms": library,
                      "view_copy_ms": None if library is None
                      else ms["cudnn_turns"] - library,
                      "bound_ms": bound, "bound_by": bound_by})
        if case_worst > RNN_OP_RTOL:
            fail(f"rnn_op: cuDNN vs plain {mode} {(t, n, isz, h)} "
                 f"bidirectional={bi}: {errs}")
    calls = rnn_mod.cudnn_calls - calls0
    emit({"phase": "rnn_op", "cases": cases, "rtol": RNN_OP_RTOL,
          "worst_rel_err": worst, "cudnn_calls": calls,
          "library": "torch.nn.LSTM, flattened weights"})
    if calls != made[0]:
        fail(f"rnn_op: {calls} cuDNN calls, expected {made[0]}")


def _lm_batches(loader):
    while True:
        for batch in loader:
            yield batch


def _f64(nd):
    return torch.from_numpy(nd.asnumpy().astype(np.float64))


def _lm_state(model):
    return {n: _f64(p.data()) for n, p in model.collect_params().items()}


def _adam_first_step(weights, grads, rescale, lr, beta1=0.9, beta2=0.999,
                     eps=1e-8):
    """The parameters after Adam's first step (the optimizer's defaults,
    no weight decay) from ``weights`` and the raw gradients ``grads``,
    in float32 on the CPU, in the order of ``optimizer.adam_update``."""
    lr_t = lr * math.sqrt(1.0 - beta2) / (1.0 - beta1)
    out = {}
    for k, g in grads.items():
        w = torch.from_numpy(weights[k]).float()
        g = g.float() * rescale
        mean = (1 - beta1) * g
        var = (1 - beta2) * g.square()
        out[k] = (w - lr_t * mean / (var.sqrt() + eps)).double()
    return out


def phase_rnn_lm_train(seed, tmpdir):
    """examples/word_language_model.py's tied 2-layer LSTM LM at LM_WIDTH
    over LM_VOCAB words on the card, fed by ``gluon.contrib.data.text.
    WikiText2`` and ``gluon.data.DataLoader`` from a synthetic token file
    in WikiText-2's format, trained by ``gluon.Trainer("adam")`` with
    ``clip_global_norm``: LM_WARMUP steps, then LM_WINDOWS windows of
    LM_WINDOW_STEPS (ms a step, tokens/s, peak memory), the kernel counts
    and ``ops.rnn.cudnn_calls`` set to 0 just before the windows and
    read just after (one cuDNN call a step); one step under
    torch.profiler (the idle share); an eval-mode perplexity over
    LM_EVAL_BATCHES (cuDNN's inference forward), the first batch's
    logits within RNN_OP_RTOL of their max of the same forward on the
    CPU.  Gate: one step with dropout 0 at LM_REF_BATCH on
    the card against the same step on the CPU in fp32 (the plain route):
    the loss within STEP_LOSS_RTOL, every gradient (before clipping)
    within STEP_RTOL of its tensor's max, and the card's parameters after
    the step within STEP_RTOL of Adam's arithmetic applied on the CPU to
    the card's own clipped gradients.  The parameters after the step are
    not held card against CPU: Adam's first step is lr * g / (|g| + eps),
    and a bias entry whose gradient is near eps (every seed has some,
    sums of a few hundred terms that cancel) turns the gradients' ~1e-9
    absolute rounding into more than the bound; the card-vs-CPU figure
    is printed."""
    import os
    import incubator_mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.gluon.contrib.data import text
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_mod
    gpu = mx.gpu(0)
    root = os.path.join(tmpdir, "wikitext-2")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    write_wikitext(os.path.join(root, "wiki.train.tokens"), LM_VOCAB - 2,
                   LM_TOKENS, seed + 61)
    data = text.WikiText2(root=root, segment="train", seq_len=LM_BPTT)
    vocab = len(data.vocabulary)
    loader = mx.gluon.data.DataLoader(data, batch_size=LM_BATCH,
                                      shuffle=False, last_batch="discard")
    data_s = time.perf_counter() - t0
    if vocab != LM_VOCAB:
        fail(f"rnn_lm_train: vocabulary of {vocab} words, not {LM_VOCAB}")
    mx.random.seed(seed + 62)
    model = word_lm(mx, vocab, LM_WIDTH, LM_LAYERS, LM_DROPOUT)
    model.initialize(init=mx.init.Xavier(), ctx=gpu)
    init = {n: p.data().asnumpy() for n, p in
            model.collect_params().items()}
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": LM_LR})
    batches = _lm_batches(loader)
    hidden = model.begin_state(batch_size=LM_BATCH, ctx=gpu)
    take = lambda k: [next(batches) for _ in range(k)]  # noqa: E731
    losses, hidden = word_lm_steps(mx, model, trainer, take(LM_WARMUP), gpu,
                                   hidden, LM_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window_ms = []
    _zero_counts()
    rnn_mod.cudnn_calls = 0
    for _ in range(LM_WINDOWS):
        window = take(LM_WINDOW_STEPS)
        t1 = time.perf_counter()
        more, hidden = word_lm_steps(mx, model, trainer, window, gpu, hidden,
                                     LM_BATCH)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t1) / LM_WINDOW_STEPS * 1e3)
        losses += more
    launches, calls = _counts(), rnn_mod.cudnn_calls
    peak = torch.cuda.max_memory_allocated()
    _expect(calls, LM_WINDOWS * LM_WINDOW_STEPS, "rnn_lm_train: cuDNN RNN")
    losses = [float(loss.mean().asscalar()) for loss in losses]
    _finite(losses, "rnn_lm_train")
    window = take(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, hidden = word_lm_steps(mx, model, trainer, window, gpu, hidden,
                                  LM_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    profiled = _profile_summary(prof, wall)

    # eval mode: no recording, no dropout; cuDNN's inference forward,
    # its first batch held against the same forward on the CPU
    ppl = mx.metric.Perplexity(None)
    hidden = model.begin_state(batch_size=LM_BATCH, ctx=gpu)
    calls0 = rnn_mod.cudnn_calls
    eval_batches = take(LM_EVAL_BATCHES)
    for i, (data_b, label_b) in enumerate(eval_batches):
        out, hidden = model(mx.nd.transpose(data_b.as_in_context(gpu),
                                            axes=(1, 0)), hidden)
        if i == 0:
            first = out.asnumpy()
        ppl.update([mx.nd.transpose(label_b, axes=(1, 0)).reshape((-1,))],
                   [mx.nd.softmax(out)])
    eval_calls = rnn_mod.cudnn_calls - calls0
    eval_ppl = ppl.get()[1]
    trained = {n: p.data().asnumpy() for n, p in
               model.collect_params().items()}
    del model, trainer, hidden, prof, out
    torch.cuda.empty_cache()
    with mx.cpu():
        cpu_model = word_lm(mx, vocab, LM_WIDTH, LM_LAYERS, LM_DROPOUT)
        cpu_model.initialize(ctx=mx.cpu())
        for n, p in cpu_model.collect_params().items():
            p.set_data(mx.nd.array(trained[n]))
        ref_out, _ = cpu_model(
            mx.nd.transpose(eval_batches[0][0], axes=(1, 0)),
            cpu_model.begin_state(batch_size=LM_BATCH, ctx=mx.cpu()))
        ref_out = ref_out.asnumpy()
    eval_err = float(np.abs(first - ref_out).max() / np.abs(ref_out).max())
    del cpu_model, trained
    if not math.isfinite(eval_ppl):
        fail(f"rnn_lm_train: eval perplexity {eval_ppl}")
    _expect(eval_calls, LM_EVAL_BATCHES, "rnn_lm_train: eval cuDNN RNN")
    if eval_err > RNN_OP_RTOL:
        fail(f"rnn_lm_train: eval logits, card vs CPU: {eval_err} of max")

    # the gate: one step at dropout 0 from the same weights
    ref_batch = [(d[:LM_REF_BATCH], lb[:LM_REF_BATCH])
                 for d, lb in take(1)]
    runs = {}
    t1 = time.perf_counter()
    for key, ctx in (("card", gpu), ("cpu", mx.cpu())):
        net = word_lm(mx, vocab, LM_WIDTH, LM_LAYERS, 0.0)
        net.initialize(ctx=ctx)
        for n, p in net.collect_params().items():
            p.set_data(mx.nd.array(init[n], ctx=ctx))
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": LM_LR})
        h0 = net.begin_state(batch_size=LM_REF_BATCH, ctx=ctx)
        grads = {}
        with ctx:
            loss, _ = word_lm_steps(mx, net, tr, ref_batch, ctx, h0,
                                    LM_REF_BATCH, grads=grads)
        runs[key] = (float(loss[0].mean().asscalar()), grads,
                     _lm_state(net))
        del net, tr
    ref_s = time.perf_counter() - t1
    (loss_gpu, card_grads, got), (loss_cpu, cpu_grads, ref) = \
        runs["card"], runs["cpu"]
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    keys = sorted(ref)
    grads_worst, grads_key = _worst(
        {k: card_grads[k][0] for k in keys},
        {k: cpu_grads[k][0] for k in keys}, keys)
    adam = _adam_first_step(init, {k: card_grads[k][1] for k in keys},
                            1.0 / (LM_REF_BATCH * LM_BPTT), LM_LR)
    update_worst, update_key = _worst(got, adam, keys)
    params_worst, params_key = _worst(got, ref, keys)
    tokens_per_s = LM_BATCH * LM_BPTT / (np.median(window_ms) / 1e3)
    emit({"phase": "rnn_lm_train", "model": "word_language_model RNNModel",
          "vocab": vocab, "embed": LM_WIDTH, "hidden": LM_WIDTH,
          "layers": LM_LAYERS, "tied": True, "dropout": LM_DROPOUT,
          "bptt": LM_BPTT, "batch": LM_BATCH, "optimizer": "adam",
          "lr": LM_LR, "clip": LM_CLIP, "data_s": data_s,
          "window_ms_per_step": window_ms,
          "ms_per_step": float(np.median(window_ms)),
          "tokens_per_s": tokens_per_s, "peak_mem_gb": peak / 1e9,
          "losses": losses, "cudnn_calls": calls, "launches": launches,
          "profiled_step": {k: profiled[k] for k in (
              "wall_s", "device_busy_s", "device_idle_share",
              "device_ms_by_kind", "top_kernels")},
          "eval": {"batches": LM_EVAL_BATCHES, "perplexity": eval_ppl,
                   "cudnn_calls": eval_calls,
                   "logits_rel_err_vs_cpu": eval_err,
                   "rtol": RNN_OP_RTOL},
          "reference": {
              "batch": LM_REF_BATCH, "loss_card": loss_gpu,
              "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
              "grads_worst_over_bound": grads_worst,
              "grads_worst": grads_key,
              "adam_step_worst_over_bound": update_worst,
              "adam_step_worst": update_key,
              "params_vs_cpu_worst_over_bound": params_worst,
              "params_vs_cpu_worst": params_key, "rtol": STEP_RTOL,
              "atol": STEP_ATOL, "tensors": len(keys), "seconds": ref_s}})
    if not math.isfinite(loss_gpu) or loss_rel > STEP_LOSS_RTOL:
        fail(f"rnn_lm_train: card vs CPU loss {loss_gpu} vs {loss_cpu}")
    if grads_worst > 1.0:
        fail(f"rnn_lm_train: card vs CPU gradients of one step: "
             f"{grads_key} is {grads_worst} x its bound off")
    if update_worst > 1.0:
        fail(f"rnn_lm_train: the card's Adam step from its own gradients: "
             f"{update_key} is {update_worst} x its bound off")
    torch.cuda.empty_cache()
    return launches


def _bucket_module(mx, fused, ctx, arg_params=None):
    """A BucketingModule over the bucketing examples' sym_gen on ``ctx``,
    bound at the default bucket, its parameters from ``arg_params`` or
    Xavier (the fused stack takes only given ones)."""
    stack = bucket_stack(mx, BUCKET_WIDTH, BUCKET_LAYERS, fused)
    mod = mx.mod.BucketingModule(
        bucket_sym_gen(mx, stack, BUCKET_VOCAB, BUCKET_WIDTH, BUCKET_WIDTH),
        default_bucket_key=max(BUCKETS), context=ctx)
    shape = (BUCKET_BATCH, max(BUCKETS))
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", shape)])
    mod.init_params(initializer=mx.init.Xavier(), arg_params=arg_params,
                    allow_missing=arg_params is None)
    return mod


def _bucket_batch(mx, seed, key, ctx=None):
    rs = np.random.RandomState(seed)
    data = rs.randint(0, BUCKET_VOCAB, (BUCKET_BATCH, key)).astype(
        np.float32)
    label = np.full(data.shape, -1.0, np.float32)
    label[:, :-1] = data[:, 1:]
    return mx.io.DataBatch(
        [mx.nd.array(data, ctx=ctx or mx.cpu())],
        [mx.nd.array(label, ctx=ctx or mx.cpu())], bucket_key=key,
        provide_data=[mx.io.DataDesc("data", data.shape)],
        provide_label=[mx.io.DataDesc("softmax_label", label.shape)])


def _bucket_step(mx, fused, ctx, arg_params, batch):
    """One forward_backward + update of a fresh module: (outputs,
    {name: fp64 tensor} of the parameters after it)."""
    mod = _bucket_module(mx, fused, ctx, arg_params)
    mod.init_optimizer(optimizer="adam", optimizer_params=BUCKET_OPT)
    mod.forward_backward(batch)
    mod.update()
    out = mod.get_outputs()[0].asnumpy()
    args, _ = mod.get_params()
    return out, {k: torch.from_numpy(v.asnumpy().astype(np.float64))
                 for k, v in args.items()}


def phase_rnn_bucketing(seed):
    """examples/rnn_bucketing.py at MXNet's lstm_bucketing.py width:
    ``BucketingModule.fit`` (Adam, Perplexity, one epoch of
    BUCKET_BATCHES batches in each of BUCKETS from BucketSentenceIter)
    over 2 stacked legacy LSTMCells, then over one FusedRNNCell
    (cudnn_lstm_bucketing.py) from the same weights (packed by
    ``pack_weights``), the kernel counts and ``ops.rnn.cudnn_calls``
    read around each fit (one cuDNN call a fused batch, none unfused);
    then ms a batch by bucket on resident batches.  Gate: one batch of
    bucket BUCKET_REF_KEY on the card against the CPU for each stack:
    outputs within STEP_LOSS_RTOL of their max, parameters after the
    update within SPREAD_FACTOR of the CPU's own spread between the two
    stacks (the same weights, the unfused cells against the fused op's
    plain route)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_mod
    gpu = mx.gpu(0)
    sentences = bucket_sentences(seed + 70, BUCKET_VOCAB, BUCKETS,
                                 BUCKET_BATCHES * BUCKET_BATCH)
    mx.random.seed(seed + 71)
    stacks, launches, init = {}, {}, None
    for name, fused in (("lstm_cells", False), ("fused", True)):
        train = mx.rnn.BucketSentenceIter(sentences, BUCKET_BATCH,
                                          buckets=list(BUCKETS),
                                          invalid_label=-1)
        if fused:
            packer = bucket_stack(mx, BUCKET_WIDTH, BUCKET_LAYERS, True)
            arg_params = packer.pack_weights(init)
        else:
            arg_params = None
        mod = _bucket_module(mx, fused, gpu, arg_params)
        if init is None:
            init = mod.get_params()[0]
        metric = mx.metric.Perplexity(-1)
        seen = []
        torch.cuda.synchronize()
        _zero_counts()
        calls0 = rnn_mod.cudnn_calls
        t0 = time.perf_counter()
        mod.fit(train, eval_metric=metric, optimizer="adam",
                optimizer_params=BUCKET_OPT, num_epoch=1,
                batch_end_callback=lambda p: seen.append(p.nbatch))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches[name] = _counts()
        calls = rnn_mod.cudnn_calls - calls0
        n_batches = len(seen)
        if n_batches != BUCKET_BATCHES * len(BUCKETS):
            fail(f"rnn_bucketing {name}: fit ran {n_batches} batches")
        _expect(calls, n_batches if fused else 0,
                f"rnn_bucketing {name}: cuDNN RNN")
        ms_by_bucket = {}
        for key in BUCKETS:
            batch = _bucket_batch(mx, seed + key, key, gpu)
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(BUCKET_TIMED):
                mod.forward_backward(batch)
                mod.update()
            torch.cuda.synchronize()
            ms_by_bucket[key] = (time.perf_counter() - t1) / \
                BUCKET_TIMED * 1e3
        ppl = metric.get()[1]
        if not math.isfinite(ppl):
            fail(f"rnn_bucketing {name}: perplexity {ppl}")
        stacks[name] = {"fit_s": fit_s, "batches": n_batches,
                        "train_perplexity": ppl, "cudnn_calls": calls,
                        "launches": launches[name],
                        "ms_per_batch_by_bucket": ms_by_bucket}
        del mod
        torch.cuda.empty_cache()

    # the gate: one batch of bucket BUCKET_REF_KEY, card vs CPU
    batch = _bucket_batch(mx, seed + 72, BUCKET_REF_KEY)
    packed = bucket_stack(mx, BUCKET_WIDTH, BUCKET_LAYERS, True) \
        .pack_weights(init)
    t1 = time.perf_counter()
    runs = {}
    for name, fused, params in (("lstm_cells", False, init),
                                ("fused", True, packed)):
        for where, ctx in (("card", gpu), ("cpu", mx.cpu())):
            with ctx:
                runs[name, where] = _bucket_step(
                    mx, fused, ctx, {k: v.copyto(ctx) for k, v in
                                     params.items()}, batch)
    unpacker = bucket_stack(mx, BUCKET_WIDTH, BUCKET_LAYERS, True)
    fused_cpu = {k: torch.from_numpy(v.asnumpy().astype(np.float64))
                 for k, v in unpacker.unpack_weights(
                     {k: mx.nd.array(t.numpy(), ctx=mx.cpu()) for k, t in
                      runs["fused", "cpu"][1].items()}).items()}
    cells_cpu = runs["lstm_cells", "cpu"][1]
    spread, spread_key = _worst(fused_cpu, cells_cpu, sorted(cells_cpu))
    reference = {"bucket": BUCKET_REF_KEY, "cpu_spread_worst_over_bound":
                 spread, "cpu_spread_worst": spread_key,
                 "spread_factor": SPREAD_FACTOR, "rtol": STEP_RTOL}
    for name in ("lstm_cells", "fused"):
        (p_gpu, got), (p_cpu, ref) = runs[name, "card"], runs[name, "cpu"]
        out_err = float(np.abs(p_gpu - p_cpu).max())
        out_scale = float(np.abs(p_cpu).max())
        params_worst, params_key = _worst(got, ref, sorted(ref))
        reference[name] = {"outputs_max_abs_err": out_err,
                           "outputs_abs_max": out_scale,
                           "params_worst_over_bound": params_worst,
                           "params_worst": params_key}
        if out_err > STEP_LOSS_RTOL * out_scale:
            fail(f"rnn_bucketing {name}: card vs CPU outputs differ by "
                 f"{out_err} > {STEP_LOSS_RTOL} x {out_scale}")
        if params_worst > max(1.0, SPREAD_FACTOR * spread):
            fail(f"rnn_bucketing {name}: card vs CPU parameters after one "
                 f"batch: {params_key} is {params_worst} x its bound off, "
                 f"the CPU's own spread {spread}")
    reference["seconds"] = time.perf_counter() - t1
    emit({"phase": "rnn_bucketing", "vocab": BUCKET_VOCAB,
          "embed": BUCKET_WIDTH, "hidden": BUCKET_WIDTH,
          "layers": BUCKET_LAYERS, "batch": BUCKET_BATCH,
          "buckets": list(BUCKETS), "optimizer": "adam",
          "optimizer_params": BUCKET_OPT, "stacks": stacks,
          "reference": reference})
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- detection
# SSD-300 (Liu et al. 2016) in MXNet's example/ssd configuration
# ``vgg16_reduced`` at 300 (symbol/symbol_factory.py): the VGG-16 body
# through relu5_3 (pool3 in ceil mode, so 75 -> 38), pool5 3x3 s1 p1,
# fc6 as a 3x3 conv of dilation 6 (1024), fc7 1x1 (1024), relu4_3
# L2-normalised per channel with a learnt scale of 20, and four extra
# layers; six maps 38, 19, 10, 5, 3, 1 give 8732 anchors; VOC's 20
# classes plus background.
SSD_EDGE = 300
SSD_CLASSES = 20
SSD_BATCH = 32
SSD_WARM, SSD_TIMED = 2, 10
SSD_MAX_BOXES = 4
SSD_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961))
_RATIOS3, _RATIOS5 = (1.0, 2.0, 0.5), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)
SSD_RATIOS = (_RATIOS3, _RATIOS5, _RATIOS5, _RATIOS5, _RATIOS3, _RATIOS3)
SSD_STEPS = tuple(s / 300 for s in (8, 16, 32, 64, 100, 300))
# (1x1 halving conv, 3x3 conv, its stride, its pad) of each extra layer
SSD_EXTRAS = ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
              (128, 256, 1, 0))
SSD_ANCHORS = 8732
# examples/train_ssd.py's recipe (its loss, SGD with momentum 0.9 and wd
# 1e-4) at MXNet's example/ssd/train.py learning rate, 0.002: at the
# compact example's 0.1 the randomly initialised VGG16-reduced body
# diverges (the loss reached NaN at the fourth step of b=4 on the CPU)
SSD_OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 1e-4}
SSD_OVERLAP = 0.5
SSD_NMS = 0.45
SSD_DET_BATCH = 8
SSD_REF_BATCH = 2
SSD_DET_RTOL = 1e-4      # detections card vs CPU, of max |value|
# examples/train_ssd.py's own compact SSD at its defaults
COMPACT_SSD = dict(classes=3, edge=64, batch=32, steps=60, lr=0.1,
                   seed=11)


def make_scene(rs, edge, num_classes, max_boxes=1):
    """examples/train_ssd.py's synthetic scene: a dim noisy image with
    bright rectangles, the class encoded in channel brightness; label
    rows [cls, x1, y1, x2, y2] in [0, 1].  ``max_boxes=1`` draws exactly
    as the example does (one box); more draws 1 to ``max_boxes`` boxes
    and pads the label with -1 rows."""
    img = rs.rand(3, edge, edge).astype("float32") * 0.2
    n = 1 if max_boxes == 1 else rs.randint(1, max_boxes + 1)
    label = np.full((max_boxes, 5), -1.0, np.float32)
    for i in range(n):
        cls = rs.randint(num_classes)
        w = rs.uniform(0.35, 0.6)
        h = rs.uniform(0.35, 0.6)
        x1 = rs.uniform(0, 1 - w)
        y1 = rs.uniform(0, 1 - h)
        xs, ys = int(x1 * edge), int(y1 * edge)
        xe, ye = int((x1 + w) * edge), int((y1 + h) * edge)
        img[cls % 3, ys:ye, xs:xe] += 0.8
        img[(cls + 1) % 3, ys:ye, xs:xe] += 0.3 * (cls // 3)
        label[i] = [cls, x1, y1, x1 + w, y1 + h]
    return img, label


def scenes(rs, n, edge, num_classes, max_boxes=1):
    """A batch of ``make_scene``: images (n, 3, edge, edge) and labels
    (n, max_boxes, 5)."""
    imgs, labels = zip(*(make_scene(rs, edge, num_classes, max_boxes)
                         for _ in range(n)))
    return np.stack(imgs), np.stack(labels)


def ssd_compact(mx, num_classes, scales=((0.45, 0.6), (0.75, 0.9)),
                ratios=(1.0, 2.0, 0.5), prefix="ssd_"):
    """examples/train_ssd.py's SSD, built from ``mx`` (the JAX package or
    the port; only the package differs): a conv body, two stages, each
    with a class head, a box head and its MultiBoxPrior anchors."""
    nn = mx.gluon.nn

    class SSD(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.num_classes = num_classes
            apr = len(scales[0]) + len(ratios) - 1
            with self.name_scope():
                self.body = nn.HybridSequential(prefix="body_")
                with self.body.name_scope():
                    for f in (16, 32):
                        self.body.add(nn.Conv2D(f, 3, 1, 1), nn.BatchNorm(),
                                      nn.Activation("relu"),
                                      nn.MaxPool2D(2, 2))
                self.stages, self.cls_heads, self.box_heads = [], [], []
                for i in range(len(scales)):
                    stage = nn.HybridSequential(prefix=f"stage{i}_")
                    with stage.name_scope():
                        stage.add(nn.Conv2D(32, 3, 1, 1), nn.BatchNorm(),
                                  nn.Activation("relu"), nn.MaxPool2D(2, 2))
                    ch = nn.Conv2D(apr * (num_classes + 1), 3, 1, 1,
                                   prefix=f"cls{i}_")
                    bh = nn.Conv2D(apr * 4, 3, 1, 1, prefix=f"box{i}_")
                    for block in (stage, ch, bh):
                        self.register_child(block)
                    self.stages.append(stage)
                    self.cls_heads.append(ch)
                    self.box_heads.append(bh)

        def hybrid_forward(self, F, x):
            feat = self.body(x)
            cls_preds, box_preds, anchors = [], [], []
            for stage, ch, bh, sizes in zip(self.stages, self.cls_heads,
                                            self.box_heads, scales):
                feat = stage(feat)
                anchors.append(F.contrib.MultiBoxPrior(
                    feat, sizes=sizes, ratios=ratios, clip=True))
                cls_preds.append(F.reshape(F.transpose(
                    ch(feat), axes=(0, 2, 3, 1)),
                    shape=(0, -1, self.num_classes + 1)))
                box_preds.append(F.reshape(F.transpose(
                    bh(feat), axes=(0, 2, 3, 1)), shape=(0, -1)))
            return (F.Concat(*cls_preds, dim=1), F.Concat(*box_preds, dim=1),
                    F.Concat(*anchors, dim=1))

    return SSD(prefix=prefix)


def ssd300(mx, num_classes=SSD_CLASSES, prefix="ssd300_"):
    """SSD-300 on VGG16-reduced (module constants), built from ``mx``'s
    public API: the conv layers of ``vision.vgg16().features`` through
    relu5_3 (its pools replaced: pool3 in ceil mode, pool5 3x3 s1 p1),
    fc6 / fc7 as convolutions, ``L2Normalization(mode="channel")`` on
    relu4_3 times a learnt per-channel scale (20 at start), the extra
    layers, and a 3x3 class and box head on each of the six maps.
    Returns (cls_pred (B, A, classes+1), box_pred (B, A*4), anchors
    (1, A, 4))."""
    nn = mx.gluon.nn
    vgg = mx.gluon.model_zoo.vision.vgg16(prefix=prefix + "vgg16_")

    class SSD300(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.stage4 = nn.HybridSequential(prefix="stage4_")
                self.stage5 = nn.HybridSequential(prefix="stage5_")
                target, pools = self.stage4, 0
                for layer in vgg.features:
                    if isinstance(layer, nn.MaxPool2D):
                        pools += 1
                        if pools == 5:
                            break
                        if pools == 4:
                            target = self.stage5
                        layer = nn.MaxPool2D(2, 2, ceil_mode=pools == 3)
                    target.add(layer)
                with self.stage5.name_scope():
                    self.stage5.add(
                        nn.MaxPool2D(3, 1, 1),
                        nn.Conv2D(1024, 3, padding=6, dilation=6),
                        nn.Activation("relu"), nn.Conv2D(1024, 1),
                        nn.Activation("relu"))
                self.norm_scale = self.params.get(
                    "norm4_scale", shape=(1, 512, 1, 1),
                    init=mx.init.Constant(20.0))
                self.extras = []
                for i, (mid, out, stride, pad) in enumerate(SSD_EXTRAS):
                    seq = nn.HybridSequential(prefix=f"extra{i}_")
                    with seq.name_scope():
                        seq.add(nn.Conv2D(mid, 1), nn.Activation("relu"),
                                nn.Conv2D(out, 3, stride, pad),
                                nn.Activation("relu"))
                    self.register_child(seq)
                    self.extras.append(seq)
                self.cls_heads, self.box_heads = [], []
                for i, (sizes, ratios) in enumerate(zip(SSD_SIZES,
                                                        SSD_RATIOS)):
                    apr = len(sizes) + len(ratios) - 1
                    ch = nn.Conv2D(apr * (num_classes + 1), 3, 1, 1,
                                   prefix=f"cls{i}_")
                    bh = nn.Conv2D(apr * 4, 3, 1, 1, prefix=f"box{i}_")
                    self.register_child(ch)
                    self.register_child(bh)
                    self.cls_heads.append(ch)
                    self.box_heads.append(bh)

        def hybrid_forward(self, F, x, norm_scale):
            f4 = self.stage4(x)
            feat = self.stage5(f4)
            maps = [F.broadcast_mul(F.L2Normalization(f4, mode="channel"),
                                    norm_scale), feat]
            for extra in self.extras:
                feat = extra(feat)
                maps.append(feat)
            cls_preds, box_preds, anchors = [], [], []
            for m, ch, bh, sizes, ratios, step in zip(
                    maps, self.cls_heads, self.box_heads, SSD_SIZES,
                    SSD_RATIOS, SSD_STEPS):
                anchors.append(F.contrib.MultiBoxPrior(
                    m, sizes=sizes, ratios=ratios, steps=(step, step)))
                cls_preds.append(F.reshape(F.transpose(
                    ch(m), axes=(0, 2, 3, 1)), shape=(0, -1, num_classes + 1)))
                box_preds.append(F.reshape(F.transpose(
                    bh(m), axes=(0, 2, 3, 1)), shape=(0, -1)))
            return (F.Concat(*cls_preds, dim=1), F.Concat(*box_preds, dim=1),
                    F.Concat(*anchors, dim=1))

    return SSD300(prefix=prefix)


def ssd_step(mx, net, trainer, x, y):
    """One step of examples/train_ssd.py's loop: MultiBoxTarget, softmax
    cross-entropy on the classes plus Huber on the masked offsets,
    backward, ``trainer.step``.  Returns (the loss NDArray, the targets
    (loc_target, loc_mask, cls_target))."""
    cls_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    box_loss = mx.gluon.loss.HuberLoss()
    with mx.autograd.record():
        cls_pred, box_pred, anchor = net(x)
        targets = mx.nd.contrib.MultiBoxTarget(
            anchor, y, mx.nd.transpose(cls_pred, axes=(0, 2, 1)),
            overlap_threshold=SSD_OVERLAP)
        loc_t, loc_m, cls_t = targets
        loss = cls_loss(cls_pred, cls_t) + box_loss(box_pred * loc_m,
                                                    loc_t * loc_m)
    loss.backward()
    trainer.step(x.shape[0])
    return loss, targets


def ssd_detect(mx, net, x, nms_threshold=SSD_NMS):
    """examples/train_ssd.py's inference: softmax over the classes, then
    ``MultiBoxDetection`` (decode and NMS).  Returns (B, A, 6)."""
    with mx.autograd.predict_mode():
        cls_pred, box_pred, anchor = net(x)
        probs = mx.nd.transpose(mx.nd.softmax(cls_pred, axis=-1),
                                axes=(0, 2, 1))
        return mx.nd.contrib.MultiBoxDetection(probs, box_pred, anchor,
                                               nms_threshold=nms_threshold)


def held_out_iou(dets, labels):
    """examples/train_ssd.py's check: per image, the IoU of the
    best-scoring kept detection with the (one) true box; mean over the
    images."""
    ious = []
    for i in range(dets.shape[0]):
        valid = dets[i][dets[i, :, 0] >= 0]
        if not len(valid):
            ious.append(0.0)
            continue
        bx1, by1, bx2, by2 = valid[np.argmax(valid[:, 1])][2:6]
        gx1, gy1, gx2, gy2 = labels[i, 1:5]
        ix = max(0.0, min(bx2, gx2) - max(bx1, gx1))
        iy = max(0.0, min(by2, gy2) - max(by1, gy1))
        inter = ix * iy
        union = (bx2 - bx1) * (by2 - by1) + (gx2 - gx1) * (gy2 - gy1) - inter
        ious.append(inter / union if union > 0 else 0.0)
    return float(np.mean(ious))


# zoo_models: the 21 zoo names beyond ResNet at full width (1000
# classes, 224x224; Inception V3 at 299x299), a b=ZOO_BATCH forward of
# each on the card; the first of each family against the CPU at b=2
# with the same weights; Inception V3 served through ModelServer
ZOO_NEW = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "alexnet", "densenet121", "densenet161",
           "densenet169", "densenet201", "squeezenet1.0", "squeezenet1.1",
           "inceptionv3", "inceptionbn", "mobilenet1.0", "mobilenet0.75",
           "mobilenet0.5", "mobilenet0.25")
ZOO_FAMILY_FIRST = ("vgg11", "alexnet", "densenet121", "squeezenet1.0",
                    "inceptionv3", "inceptionbn", "mobilenet1.0")
ZOO_BATCH = 8
ZOO_REF_BATCH = 2
ZOO_RTOL = 1e-4          # card vs CPU logits, of max |logit|


def _zoo_edge(name):
    return 299 if name == "inceptionv3" else 224


def _zoo_net(mx, name, ctx, prefix=None):
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    kw = {} if prefix is None else {"prefix": prefix}
    net = vision.get_model(name, **kw)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def phase_zoo_models(seed):
    """Every zoo model beyond ResNet built by ``get_model`` on the card
    at full width; one b=ZOO_BATCH forward each (finite, (8, 1000)) with
    its ms (CUDA events over 3 forwards); for the first model of each
    family the same weights on the CPU, whose b=2 logits the card's
    match within ZOO_RTOL of max; then Inception V3 behind
    ``ModelServer(max_batch=32)`` under resnet_serving's burst (served
    vs direct within ZOO_RTOL), and one b=32 batch under
    torch.profiler."""
    import incubator_mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import convert
    from incubator_mxnet_tpu_torch.predict import BlockPredictor
    from incubator_mxnet_tpu_torch.serving import ModelServer
    gpu = mx.gpu(0)
    rs = np.random.RandomState(seed + 60)
    rows = {}
    for name in ZOO_NEW:
        edge = _zoo_edge(name)
        x = rs.rand(ZOO_BATCH, 3, edge, edge).astype(np.float32)
        t0 = time.perf_counter()
        net = _zoo_net(mx, name, gpu)
        xd = mx.nd.array(x, ctx=gpu)
        with mx.autograd.predict_mode():
            out = net(xd).asnumpy()
            build_s = time.perf_counter() - t0
            ms = time_ms(lambda: net(xd), iters=3, warmup=1)
        row = {"edge": edge, "params": int(sum(
            p.data().size for p in net.collect_params().values())),
            "forward_ms": ms, "setup_s": build_s}
        if out.shape != (ZOO_BATCH, 1000) or not np.isfinite(out).all():
            fail(f"zoo {name}: output {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
        if name in ZOO_FAMILY_FIRST:
            with mx.cpu():
                cpu = mx.gluon.model_zoo.vision.get_model(name,
                                                          prefix=net.prefix)
                convert.gluon_params_from_numpy(
                    cpu, convert.gluon_params_to_numpy(net), ctx=mx.cpu())
                ref = cpu(mx.nd.array(x[:ZOO_REF_BATCH])).asnumpy()
            with mx.autograd.predict_mode():
                got = net(mx.nd.array(x[:ZOO_REF_BATCH], ctx=gpu)).asnumpy()
            err = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
            row["vs_cpu_of_max"] = err
            if err > ZOO_RTOL:
                fail(f"zoo {name}: card vs CPU logits {err} of max > "
                     f"{ZOO_RTOL}")
            del cpu
        rows[name] = row
        del net, xd
        torch.cuda.empty_cache()
    # Inception V3 served
    net = _zoo_net(mx, "inceptionv3", gpu)
    pred = BlockPredictor(net, bf16_compute=False)
    server = ModelServer(pred, max_batch=MAX_BATCH,
                         input_shapes=[(3, 299, 299)])
    try:
        server.warmup()
        n_images = CLIENTS * PER_CLIENT + BATCH_REQS * BATCH_SIZE
        images = rs.rand(n_images, 3, 299, 299).astype(np.float32)
        before = server._counters()
        _telemetry().reset()
        got, lat, wall = _burst(server, images)
        tel, _ = _serving_held("inceptionv3_serving", server, before,
                               BURST_REQUESTS)
    finally:
        server.close()
    if got.shape != (n_images, 1000) or not np.isfinite(got).all():
        fail(f"served inceptionv3 logits: shape {got.shape}")
    direct = pred.predict(images, batch_size=MAX_BATCH).cpu().numpy()
    err = float(np.abs(got - direct).max()) / float(np.abs(direct).max())
    if err > ZOO_RTOL:
        fail(f"served inceptionv3 vs direct {err} of max > {ZOO_RTOL}")
    batch = torch.from_numpy(images[:MAX_BATCH]).cuda()
    pred(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(batch)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
    profiled = _profile_summary(prof, wall_b)
    lat.sort()
    emit({"phase": "zoo_models", "batch": ZOO_BATCH, "models": rows,
          "rtol": ZOO_RTOL, "inceptionv3_serving": {
              "images": n_images, "images_per_s": n_images / wall,
              "e2e_p50_ms": lat[len(lat) // 2],
              "e2e_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
              "batches": tel["serving.batch.count"],
              "served_vs_direct_of_max": err,
              "profiled_batch": {k: profiled[k] for k in (
                  "wall_s", "device_busy_s", "device_idle_share",
                  "device_ms_by_kind")}}})
    del net, pred, server
    torch.cuda.empty_cache()


def _ssd_reference(mx, init, x, y):
    """One SSD-300 step at b=SSD_REF_BATCH from the weights ``init`` on
    the card and on the CPU, and on the CPU once more with oneDNN off
    (another fp32 formulation of the same convolutions: the spread).
    Returns (card, cpu, alt): each (loss, {name: tensor})."""
    from incubator_mxnet_tpu_torch import convert

    def run(ctx, build_ctx):
        with build_ctx:
            net = ssd300(mx)
            convert.gluon_params_from_numpy(net, init, ctx=ctx)
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(SSD_OPT))
            loss, _ = ssd_step(mx, net, trainer, mx.nd.array(x, ctx=ctx),
                               mx.nd.array(y, ctx=ctx))
            out = (loss.asnumpy(), {k: torch.from_numpy(v) for k, v in
                                    convert.gluon_params_to_numpy(
                                        net).items()})
        del net, trainer
        return out

    card = run(mx.gpu(0), mx.gpu(0))
    cpu = run(mx.cpu(), mx.cpu())
    with torch.backends.mkldnn.flags(enabled=False):
        alt = run(mx.cpu(), mx.cpu())
    return card, cpu, alt


def phase_ssd_train(seed):
    """SSD-300 (module constants) built by ``ssd300`` from the port's
    API, Xavier (gaussian, magnitude 2) on gpu(0), trained with
    examples/train_ssd.py's recipe on seeded 300x300 scenes of 1 to 4
    boxes at b=SSD_BATCH: SSD_WARM steps, then SSD_TIMED timed (host
    clock ending in a synchronise) and one under torch.profiler; one
    b=2 step from the initial weights on the card held against the CPU
    (the loss within STEP_LOSS_RTOL, every parameter within STEP_RTOL of
    its max + STEP_ATOL, or SPREAD_FACTOR x the CPU's own spread with
    oneDNN off, where that is larger); then ``MultiBoxDetection`` (NMS
    0.45) on a b=SSD_DET_BATCH batch: its ms and the NMS's share, the
    card's kept rows identical to the CPU's on the same inputs and
    their values within SSD_DET_RTOL of max, and the card's fast NMS
    equal to its plain scan on two images.  Then examples/train_ssd.py's
    own compact SSD at its settings, with its asserts."""
    import incubator_mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import convert
    from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
    gpu = mx.gpu(0)
    rs = np.random.RandomState(seed + 70)
    steps = SSD_WARM + SSD_TIMED + 1
    batches = [scenes(rs, SSD_BATCH, SSD_EDGE, SSD_CLASSES, SSD_MAX_BOXES)
               for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = ssd300(mx)
    net.initialize(init=mx.init.Xavier(rnd_type="gaussian", magnitude=2),
                   ctx=gpu)
    with mx.autograd.pause():
        net(mx.nd.array(batches[0][0][:2], ctx=gpu))
    init = convert.gluon_params_to_numpy(net)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SSD_OPT))
    resident = [(mx.nd.array(x, ctx=gpu), mx.nd.array(y, ctx=gpu))
                for x, y in batches]
    setup_s = time.perf_counter() - t0
    _, (_, _, cls_t) = ssd_step(mx, net, trainer, *resident[0])
    anchors = net(resident[0][0][:1])[2].shape[1]
    if anchors != SSD_ANCHORS:
        fail(f"SSD-300 has {anchors} anchors, not {SSD_ANCHORS}")
    matched = float((cls_t.asnumpy() > 0).sum(1).mean())
    losses = []
    for x, y in resident[1:SSD_WARM]:
        losses.append(ssd_step(mx, net, trainer, x, y)[0].mean())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in resident[SSD_WARM:SSD_WARM + SSD_TIMED]:
        losses.append(ssd_step(mx, net, trainer, x, y)[0].mean())
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / SSD_TIMED * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(ssd_step(mx, net, trainer, *resident[-1])[0].mean())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profiled = _profile_summary(prof, wall)
    losses = [float(v.asscalar()) for v in losses]
    _finite(losses, "ssd_train")
    del resident
    torch.cuda.empty_cache()
    # one b=2 step on the card against the CPU, from the initial weights
    ref_x, ref_y = scenes(rs, SSD_REF_BATCH, SSD_EDGE, SSD_CLASSES,
                          SSD_MAX_BOXES)
    t0 = time.perf_counter()
    (card_loss, card), (cpu_loss, cpu), (_, alt) = _ssd_reference(
        mx, init, ref_x, ref_y)
    ref_s = time.perf_counter() - t0
    loss_err = float(np.abs(card_loss - cpu_loss).max()
                     / np.abs(cpu_loss).max())
    params_worst, params_key = _worst(card, cpu, list(cpu))
    spread, spread_key = _worst(alt, cpu, list(cpu))
    bound = max(1.0, SPREAD_FACTOR * spread)
    # detection on the trained net, card and CPU on the same inputs
    det_x, _ = scenes(rs, SSD_DET_BATCH, SSD_EDGE, SSD_CLASSES,
                      SSD_MAX_BOXES)
    xd = mx.nd.array(det_x, ctx=gpu)
    with mx.autograd.predict_mode():
        cls_pred, box_pred, anchor = net(xd)
        probs = mx.nd.transpose(mx.nd.softmax(cls_pred, axis=-1),
                                axes=(0, 2, 1))

    def detect():
        return mx.nd.contrib.MultiBoxDetection(probs, box_pred, anchor,
                                               nms_threshold=SSD_NMS)
    rows = mx.nd.NDArray(tcontrib.detections(probs._data, box_pred._data,
                                             anchor._data), gpu)

    def nms():
        return mx.nd.contrib.box_nms(rows, overlap_thresh=SSD_NMS,
                                     valid_thresh=0.0, coord_start=2,
                                     score_index=1, id_index=0)
    det_ms = _host_ms(lambda: detect().wait_to_read(), iters=3)
    nms_ms = _host_ms(lambda: nms().wait_to_read(), iters=3)
    dets = detect().asnumpy()
    with mx.cpu():
        cpu_dets = mx.nd.contrib.MultiBoxDetection(
            *(mx.nd.array(a.asnumpy()) for a in (probs, box_pred, anchor)),
            nms_threshold=SSD_NMS).asnumpy()
    kept_equal = bool(np.array_equal(dets[..., 0] >= 0,
                                     cpu_dets[..., 0] >= 0))
    det_err = float(np.abs(dets - cpu_dets).max()) / float(
        np.abs(cpu_dets).max())
    kept = int((dets[..., 0] >= 0).sum())
    valid = int((rows._data[..., 1] > 0).sum())
    plain_equal, plain_s = [], 0.0
    for b in range(2):
        r = rows._data[b]
        boxes = r[:, 2:6] + r[:, :1] * 1e3
        scores = torch.where(r[:, 1] > 0, r[:, 1],
                             torch.full_like(r[:, 1], float("-inf")))
        fast = tcontrib.nms_mark(boxes, scores, SSD_NMS, -1)
        t0 = time.perf_counter()
        plain = tcontrib.nms_mark_plain(boxes, scores, SSD_NMS, -1)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        plain_equal.append(bool(torch.equal(fast, plain)))
    del net, trainer, xd, probs, box_pred, cls_pred, rows
    torch.cuda.empty_cache()
    compact = _compact_ssd(mx, gpu)
    emit({"phase": "ssd_train", "edge": SSD_EDGE, "batch": SSD_BATCH,
          "classes": SSD_CLASSES + 1, "anchors": anchors,
          "matched_anchors_per_image": matched, "losses": losses,
          "ms_per_step": ms_step,
          "images_per_s": SSD_BATCH / ms_step * 1e3, "peak_mem_gb": peak_gb,
          "setup_s": setup_s, "profiled_step": {k: profiled[k] for k in (
              "wall_s", "device_busy_s", "device_idle_share",
              "device_ms_by_kind")},
          "reference": {"batch": SSD_REF_BATCH, "loss_rel": loss_err,
                        "params_worst_over_bound": params_worst,
                        "params_worst": params_key,
                        "cpu_spread_worst_over_bound": spread,
                        "cpu_spread_worst": spread_key,
                        "bound_used": bound, "rtol": STEP_RTOL,
                        "seconds": ref_s},
          "detection": {"batch": SSD_DET_BATCH, "ms_per_batch": det_ms,
                        "nms_ms": nms_ms, "nms_share": nms_ms / det_ms,
                        "valid_rows": valid, "kept_rows": kept,
                        "kept_equal_cpu": kept_equal,
                        "vs_cpu_of_max": det_err,
                        "fast_equals_plain_scan": plain_equal,
                        "plain_scan_s_two_images": plain_s},
          "compact": compact})
    if loss_err > STEP_LOSS_RTOL:
        fail(f"ssd_train: card vs CPU loss {loss_err} > {STEP_LOSS_RTOL}")
    if params_worst > bound:
        fail(f"ssd_train: card vs CPU after one step: {params_key} "
             f"{params_worst} x the bound (CPU spread {spread})")
    if not kept_equal or det_err > SSD_DET_RTOL:
        fail(f"ssd_train: detections card vs CPU: kept rows equal "
             f"{kept_equal}, values {det_err} of max")
    if not all(plain_equal):
        fail(f"ssd_train: fast NMS vs the plain scan {plain_equal}")
    if not compact["loss_halved"] or compact["mean_iou"] <= 0.5:
        fail(f"compact SSD: {compact}")


def _compact_ssd(mx, gpu):
    """examples/train_ssd.py at its defaults on the card: its SSD, Xavier
    (gaussian, 2), SGD 0.1 / 0.9 / 1e-4, COMPACT_SSD["steps"] steps of
    32 fresh 64x64 scenes; then 16 held-out scenes decoded with NMS 0.45.
    Its asserts: the last loss under half the first, the mean IoU of
    each image's best detection with its box over 0.5."""
    c = COMPACT_SSD
    rs = np.random.RandomState(c["seed"])
    net = ssd_compact(mx, c["classes"])
    net.initialize(init=mx.init.Xavier(rnd_type="gaussian", magnitude=2),
                   ctx=gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": c["lr"], "momentum": 0.9,
                                "wd": 1e-4})
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        x, y = scenes(rs, c["batch"], c["edge"], c["classes"])
        loss, _ = ssd_step(mx, net, trainer, mx.nd.array(x, ctx=gpu),
                           mx.nd.array(y, ctx=gpu))
        losses.append(float(loss.mean().asscalar()))
    ms = (time.perf_counter() - t0) / c["steps"] * 1e3
    x, y = scenes(rs, 16, c["edge"], c["classes"])
    dets = ssd_detect(mx, net, mx.nd.array(x, ctx=gpu)).asnumpy()
    iou = held_out_iou(dets, y[:, 0])
    _finite(losses, "compact SSD")
    return {"steps": c["steps"], "first_loss": losses[0],
            "last_loss": losses[-1],
            "loss_halved": losses[-1] < 0.5 * losses[0],
            "mean_iou": iou, "ms_per_step": ms}


# contrib_ops: each new op on the card against the CPU, forward and
# gradient, at its users' geometry
CONTRIB_RTOL = 1e-4      # card vs CPU, of max |value|
OCR = dict(batch=128, steps=80, digits=4, classes=10, hidden=64, feat=32,
           height=7)
RPN = dict(height=38, width=50, stride=16, image=(600, 800),
           rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300, threshold=0.7)
RFCN = dict(classes=21, group=7, rois=300, height=38, width=50)
DEFORM = dict(channels=512, height=38, width=50, batch=1)
LINALG_BATCH, LINALG_N = 16, 256
# two float32 eigensolvers agree on an eigenvector to ~n eps |A| / gap
# (8e-3 of max at n = 256, eigenvalues 1 .. n; 6.4e-4 measured on the
# H100), on the eigenvalues to ~n eps |A| (1e-4 measured)
SYEVD_RTOL = 2e-3


def ocr_net(mx, num_classes=10, hidden=64, feat=32, height=7):
    """examples/ctc_ocr.py's OCRNet, built from ``mx``: a full-height
    3-wide conv over the image's columns, a (1, 2) pool that halves
    them, a bidirectional LSTM, and a per-step classifier; (B, H, W)
    images in, (W/2, B, classes+1) pre-softmax scores out."""
    nn = mx.gluon.nn

    class OCRNet(mx.gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.conv = nn.Conv2D(feat, kernel_size=(height, 3),
                                      padding=(0, 1), in_channels=1,
                                      activation="relu")
                self.pool = nn.MaxPool2D((1, 2), (1, 2))
                self.rnn = mx.gluon.rnn.LSTM(hidden, num_layers=1,
                                             bidirectional=True,
                                             input_size=feat)
                self.fc = nn.Dense(num_classes + 1, flatten=False,
                                   in_units=2 * hidden)

        def forward(self, x):
            f = self.pool(self.conv(x.expand_dims(1)))
            f = f.reshape((x.shape[0], feat, -1))
            seq = mx.nd.transpose(f, axes=(2, 0, 1))
            out, _ = self.rnn(seq, self.rnn.begin_state(
                batch_size=x.shape[0], ctx=x.context))
            return self.fc(out)

    return OCRNet(prefix="ocrnet_")


def _nd_run(mx, fn, arrays, ctx, grad_idx, out_idx, square):
    """``fn(mx, *arrays)`` on ``ctx``; with ``grad_idx``, recorded and
    ``sum(out[out_idx] (squared) * head)`` differentiated, the head
    drawn from a fixed seed at the output's shape.  Returns (outputs,
    grads) as numpy."""
    xs = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
    for i in grad_idx:
        xs[i].attach_grad()
    with mx.autograd.record():
        out = fn(mx, *xs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if grad_idx:
            o = outs[out_idx]
            o = o * o if square else o
            head = np.random.RandomState(7).randn(*o.shape).astype(
                np.float32)
            loss = (o * mx.nd.array(head, ctx=ctx)).sum()
    if grad_idx:
        loss.backward()
    return ([o.asnumpy() for o in outs],
            [xs[i].grad.asnumpy() for i in grad_idx])


def _card_vs_cpu(mx, name, fn, arrays, grad_idx=(), out_idx=0,
                 square=False, compare=None, iters=3, rtol=CONTRIB_RTOL,
                 phase="contrib_ops"):
    """One op's row: the card's outputs and gradients against the CPU's
    (``compare(card, cpu)`` where the raw values may differ by a sign),
    of max |value| within ``rtol``, and the card's ms for the forward
    (+ backward)."""
    card = _nd_run(mx, fn, arrays, mx.gpu(0), grad_idx, out_idx, square)
    cpu = _nd_run(mx, fn, arrays, mx.cpu(), grad_idx, out_idx, square)
    pairs = compare(card[0], cpu[0]) if compare else \
        list(zip(card[0], cpu[0]))
    errs = {}
    for i, (g, w) in enumerate(pairs):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        errs[f"out{i}"] = float(np.abs(g - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
    for i, (g, w) in zip(grad_idx, zip(card[1], cpu[1])):
        errs[f"grad{i}"] = float(np.abs(g - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
    xs = [mx.nd.array(a, ctx=mx.gpu(0), dtype=a.dtype) for a in arrays]
    ms = _host_ms(lambda: [o.wait_to_read() for o in (
        lambda r: r if isinstance(r, (list, tuple)) else [r])(
            fn(mx, *xs))], iters=iters)
    worst = max(errs.values())
    if worst > rtol:
        fail(f"{phase} {name}: card vs CPU {errs} > {rtol}")
    return {"shapes": [list(a.shape) for a in arrays], "of_max": errs,
            "rtol": rtol, "forward_ms": ms}


def _abs_pairs(card, cpu):
    return [(np.abs(g), np.abs(w)) for g, w in zip(card, cpu)]


def phase_contrib_ops(seed):
    """The contrib and linalg ops on the card against the CPU, forward
    and gradient, within CONTRIB_RTOL of max: CTC behind examples/
    ctc_ocr.py's OCRNet at b=128, T=80, 4-digit labels (the library
    route on the card, counted; the plain recursion on the CPU, and
    timed on the card too); Proposal at Faster R-CNN's VGG-16 geometry;
    PSROIPooling at R-FCN's; a 512-channel 3x3 DeformableConvolution at
    38x50 beside cuDNN's plain 3x3 conv; fft / ifft; quantize /
    dequantize; every linalg op on (16, 256, 256) batches (gelqf's Q and
    L compared up to the sign a row of Q and a column of L share, its
    gradient through L squared; syevd on matrices with eigenvalues 1 ..
    256, its eigenvectors up to sign within SYEVD_RTOL, its gradient
    through the eigenvalues)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import contrib as tcontrib
    rs = np.random.RandomState(seed + 80)
    gpu = mx.gpu(0)
    rows = {}
    # --- CTC behind OCRNet
    o = OCR
    net = ocr_net(mx, o["classes"], o["hidden"], o["feat"], o["height"])
    net.initialize(mx.init.Xavier(), ctx=gpu)
    images = rs.rand(o["batch"], o["height"], 2 * o["steps"]).astype(
        np.float32)
    labels = rs.randint(0, o["classes"], (o["batch"], o["digits"])).astype(
        np.float32)
    with mx.autograd.predict_mode():
        logits = net(mx.nd.array(images, ctx=gpu)).asnumpy()
    if logits.shape != (o["steps"], o["batch"], o["classes"] + 1):
        fail(f"OCRNet scores {logits.shape}")

    def ctc(mx, pred, label):
        return mx.gluon.loss.CTCLoss(layout="TNC", label_layout="NT")(
            pred, label)
    calls = tcontrib.library_ctc_calls[0]
    rows["ctc_ocrnet"] = _card_vs_cpu(mx, "ctc", ctc, [logits, labels],
                                      grad_idx=(0,))
    if tcontrib.library_ctc_calls[0] == calls:
        fail("CTC on the card did not take the library route")
    lp = torch.log_softmax(torch.from_numpy(logits).cuda().requires_grad_(),
                           -1)
    lab = torch.from_numpy(labels).cuda().long()
    t_lens = torch.full((o["batch"],), o["steps"], device=lp.device)
    l_lens = torch.full((o["batch"],), o["digits"], device=lp.device)
    rows["ctc_ocrnet"]["plain_on_card_ms"] = _host_ms(
        lambda: torch.autograd.grad(tcontrib.ctc_loss_plain(
            lp, lab, t_lens, l_lens, o["classes"]).sum(), lp), iters=3)
    rows["ctc_ocrnet"]["library_fwd_bwd_ms"] = _host_ms(
        lambda: torch.autograd.grad(tcontrib._ctc_library(
            lp, lab, t_lens, l_lens, o["classes"]).sum(), lp), iters=3)
    del net
    # --- Proposal at Faster R-CNN's VGG-16 geometry
    r = RPN
    K = 12
    score = rs.rand(1, 2 * K, r["height"], r["width"]).astype(np.float32)
    deltas = (rs.randn(1, 4 * K, r["height"], r["width"]) * 0.1).astype(
        np.float32)
    info = np.array([[*r["image"], 1.0]], np.float32)
    attrs = {k: r[k] for k in ("rpn_pre_nms_top_n", "rpn_post_nms_top_n",
                               "threshold")}
    rows["proposal"] = _card_vs_cpu(
        mx, "Proposal", lambda mx, a, b, c: mx.nd.contrib.Proposal(
            a, b, c, feature_stride=r["stride"], output_score=True,
            **attrs), [score, deltas, info])
    rows["proposal"]["anchors"] = r["height"] * r["width"] * K
    # --- PSROIPooling at R-FCN's geometry
    f = RFCN
    data = rs.randn(1, f["classes"] * f["group"] ** 2, f["height"],
                    f["width"]).astype(np.float32)
    xy = rs.uniform(0, 500, (f["rois"], 2))
    wh = rs.uniform(32, 300, (f["rois"], 2))
    rois = np.concatenate([np.zeros((f["rois"], 1)), xy, xy + wh],
                          1).astype(np.float32)
    rows["psroi_pooling"] = _card_vs_cpu(
        mx, "PSROIPooling", lambda mx, d, q: mx.nd.contrib.PSROIPooling(
            d, q, spatial_scale=1 / 16, output_dim=f["classes"],
            pooled_size=f["group"]), [data, rois], grad_idx=(0,))
    # --- DeformableConvolution, 512 channels at 38x50
    d = DEFORM
    c, h, w = d["channels"], d["height"], d["width"]
    x = rs.randn(d["batch"], c, h, w).astype(np.float32)
    off = (rs.randn(d["batch"], 18, h, w) * 2).astype(np.float32)
    wt = (rs.randn(c, c, 3, 3) * 0.02).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    rows["deformable_conv"] = _card_vs_cpu(
        mx, "DeformableConvolution",
        lambda mx, a, b, k, e: mx.nd.contrib.DeformableConvolution(
            a, b, k, e, kernel=(3, 3), pad=(1, 1), num_filter=c),
        [x, off, wt, bias], grad_idx=(0, 1, 2, 3))
    xd, wd = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
    rows["deformable_conv"]["cudnn_conv3x3_ms"] = time_ms(
        lambda: torch.nn.functional.conv2d(xd, wd, padding=1), iters=10)
    del xd, wd
    # --- fft, quantize
    sig = rs.randn(64, 1024).astype(np.float32)
    rows["fft"] = _card_vs_cpu(mx, "fft", lambda mx, a: mx.nd.contrib.fft(a),
                               [sig], grad_idx=(0,))
    spec = rs.randn(64, 2048).astype(np.float32)
    rows["ifft"] = _card_vs_cpu(mx, "ifft",
                                lambda mx, a: mx.nd.contrib.ifft(a), [spec],
                                grad_idx=(0,))
    big = rs.uniform(-3, 5, (1024, 1024)).astype(np.float32)
    lo, hi = np.array([-3.0], np.float32), np.array([5.0], np.float32)
    rows["quantize"] = _card_vs_cpu(
        mx, "quantize", lambda mx, a, b, e: mx.nd.contrib.quantize(a, b, e),
        [big, lo, hi])
    q = np.round((big + 3) * 255 / 8).clip(0, 255).astype(np.uint8)
    rows["dequantize"] = _card_vs_cpu(
        mx, "dequantize",
        lambda mx, a, b, e: mx.nd.contrib.dequantize(a, b, e), [q, lo, hi])
    # --- linalg
    n, b = LINALG_N, LINALG_BATCH
    A = rs.randn(b, n, n).astype(np.float32)
    B = rs.randn(b, n, n).astype(np.float32)
    spd = (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    chol = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    tri = (np.tril(A) / np.sqrt(n) + 2 * np.eye(n)).astype(np.float32)
    wide = rs.randn(b, n // 2, n).astype(np.float32)
    la = lambda name, **kw: (lambda mx, *a: getattr(mx.nd.linalg, name)(
        *a, **kw))
    for name, arrays, kw in (
            ("gemm", [A, B, B], dict(alpha=0.5, beta=2.0)),
            ("gemm2", [A, B], dict(transpose_b=True)),
            ("potrf", [spd], {}), ("potri", [chol], {}),
            ("trmm", [tri, B], {}), ("trsm", [tri, B], {}),
            ("sumlogdiag", [chol], {}), ("syrk", [A], dict(alpha=0.5))):
        rows[f"linalg_{name}"] = _card_vs_cpu(
            mx, name, la(name, **kw), arrays,
            grad_idx=tuple(range(len(arrays))))
    rows["linalg_gelqf"] = _card_vs_cpu(
        mx, "gelqf", la("gelqf"), [wide], grad_idx=(0,), out_idx=1,
        square=True, compare=_abs_pairs)
    # eigenvalues 1 .. n: gaps of 1 keep each eigenvector (and the
    # eigenvalues' gradient v v^T) well conditioned
    qs = np.linalg.qr(rs.randn(b, n, n))[0]
    sym = (qs * np.arange(1, n + 1)[None, None, :]) @ qs.transpose(0, 2, 1)
    sym = ((sym + sym.transpose(0, 2, 1)) / 2).astype(np.float32)
    rows["linalg_syevd"] = _card_vs_cpu(
        mx, "syevd", la("syevd"), [sym], grad_idx=(0,), out_idx=1,
        compare=_abs_pairs, rtol=SYEVD_RTOL)
    emit({"phase": "contrib_ops", "rtol": CONTRIB_RTOL, "ops": rows})



# ------------------------------------------------ sparse, spatial, image
# the tables of MXNet example/sparse/matrix_factorization at ml-10m's id
# ranges; the recipe of examples/matrix_factorization.py (its MFBlock
# and loop are copied below with only the import changed)
MF = dict(users=71569, items=65135, factor=128, batch=256, rank=8,
          lr=0.05, epochs=3, batches_per_epoch=16, timed=20, profiled=5,
          other_steps=4)
MF_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
MF_ADAGRAD = {"learning_rate": 0.05}
SPARSE_RTOL = 1e-5      # card vs CPU, of max |value| (float atomics)
# examples/linear_classification.py at MXNet's avazu setting
LIN = dict(features=1_000_001, batch=8192, batches=16, nnz=15, epochs=2,
           lr=0.05)
# Fast R-CNN's ROI head (MXNet example/rcnn, VGG-16): conv5_3 at stride
# 16, ROIPooling 7x7, fc6/fc7 4096, 21 classes, 84 box outputs
FRCNN = dict(images=2, height=600, width=1000, rois=128, classes=21,
             pooled=7, scale=1.0 / 16, conv5_3=30, lr=0.001, momentum=0.9,
             wd=5e-4, warm=2, timed=5, cpu_rois=16)
FLOWNET_CORR = dict(batch=4, channels=256, height=48, width=64,
                    max_displacement=20, stride2=2, pad_size=20,
                    kernel_size=1)
FLOWNET_WARP = (8, 3, 384, 512)
STN = dict(shape=(32, 3, 224, 224), target=(224, 224))
IMAGE_OPS = dict(batch=32, edge=224, jitter=(0.4, 0.4, 0.4, 0.1),
                 lighting=0.1, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225))
GATHER = dict(shape=(32, 512, 768), picks=8192)
SAMPLER_DRAWS = 1 << 20
MULTINOMIAL = (1024, 33278)      # the word LM's vocabulary


def mf_block(mx, num_users, num_items, factor_size, **kwargs):
    """examples/matrix_factorization.py's MFBlock, for either package."""
    gluon, nn = mx.gluon, mx.gluon.nn

    class MFBlock(gluon.HybridBlock):
        def __init__(self, num_users, num_items, factor_size, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.user_embed = nn.Embedding(num_users, factor_size,
                                               sparse_grad=True)
                self.item_embed = nn.Embedding(num_items, factor_size,
                                               sparse_grad=True)

        def hybrid_forward(self, F, users, items):
            u = self.user_embed(users)
            v = self.item_embed(items)
            return F.sum(u * v, axis=-1)

    return MFBlock(num_users, num_items, factor_size, **kwargs)


def synthetic_ratings(num_users, num_items, rank, n, seed=13):
    """examples/matrix_factorization.py's seeded low-rank ratings."""
    rs = np.random.RandomState(seed)
    U = rs.randn(num_users, rank).astype("float32") / np.sqrt(rank)
    V = rs.randn(num_items, rank).astype("float32") / np.sqrt(rank)
    users = rs.randint(num_users, size=n).astype("int32")
    items = rs.randint(num_items, size=n).astype("int32")
    ratings = (U[users] * V[items]).sum(1) + 0.05 * rs.randn(n)
    return users, items, ratings.astype("float32")


def _mf_step(mx, net, trainer, loss_fn, users, items, ratings, ctx):
    """The example's step: record, backward, trainer.step(batch)."""
    u = mx.nd.array(users, ctx=ctx)
    i = mx.nd.array(items, ctx=ctx)
    r = mx.nd.array(ratings, ctx=ctx)
    with mx.autograd.record():
        loss = loss_fn(net(u, i), r)
    loss.backward()
    trainer.step(len(ratings))
    return loss


def _mf_tensors(params, trainer):
    """The tables and every optimizer state of them, as tensors, by
    parameter index."""
    out = []
    for i, p in enumerate(params):
        st = trainer._updaters.states.get(i)
        st = st if isinstance(st, tuple) else (st,)
        out.append([p.data()._data] + [s._data for s in st
                                       if s is not None])
    return out


def _untouched_equal(before, after, rows):
    """True when every row outside ``rows`` kept its bits."""
    keep = torch.ones(before.shape[0], dtype=torch.bool,
                      device=before.device)
    keep[rows] = False
    return bool(torch.equal(before[keep], after[keep]))


def _mf_checked(mx, net, trainer, loss_fn, data, idx, gpu, what):
    """One step with the lazy update's guarantee checked: every row the
    batch did not touch, of both tables and of every optimizer state,
    keeps its bits.  Returns the rows the update touched."""
    users, items, ratings = data
    params = [net.user_embed.weight, net.item_embed.weight]
    before = [[t.clone() for t in ts] for ts in _mf_tensors(params, trainer)]
    u = mx.nd.array(users[idx], ctx=gpu)
    i = mx.nd.array(items[idx], ctx=gpu)
    r = mx.nd.array(ratings[idx], ctx=gpu)
    with mx.autograd.record():
        loss = loss_fn(net(u, i), r)
    loss.backward()
    touched = [mx.nd.cast_storage(p.grad(), "row_sparse").num_stored
               for p in params]
    trainer.step(len(idx))
    after = _mf_tensors(params, trainer)
    for k, ids in enumerate((users[idx], items[idx])):
        rows = torch.as_tensor(ids.astype(np.int64),
                               device=before[k][0].device)
        for j, (b, a) in enumerate(zip(before[k], after[k])):
            if b.shape == a.shape and not _untouched_equal(b, a, rows):
                fail(f"sparse_mf {what}: a row no batch touched changed "
                     f"(table {k}, tensor {j})")
    return sum(touched)


def phase_sparse_mf(seed):
    """examples/matrix_factorization.py's MFBlock at ml-10m's id ranges
    (71,569 users x 65,135 items, factor 128) with the example's recipe
    (Embedding(sparse_grad=True) x2, Trainer "adam", L2Loss, b=256) on
    the example's seeded low-rank ratings; the Trainer hands each table
    its gradient's nonzero rows (the lazy update).  Epochs of RMSE that
    must fall, a timed window, a profiled one, then SGD (momentum 0.9,
    wd 1e-4) and AdaGrad steps; the first steps of each optimizer have
    the untouched rows checked bit for bit; one Adam step against the
    same step on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    import incubator_mxnet_tpu_torch as mx
    gpu = mx.gpu(0)
    torch.cuda.reset_peak_memory_stats()
    b, nb = MF["batch"], MF["batches_per_epoch"]
    data = synthetic_ratings(MF["users"], MF["items"], MF["rank"],
                             b * nb, seed=seed + 13)
    users, items, ratings = data
    t0 = time.perf_counter()
    mx.random.seed(7)
    net = mf_block(mx, MF["users"], MF["items"], MF["factor"])
    net.initialize(init=mx.init.Normal(0.1), ctx=gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": MF["lr"]})
    loss_fn = mx.gluon.loss.L2Loss()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rmse, touched = [], []
    for epoch in range(MF["epochs"]):
        perm = np.random.RandomState(epoch).permutation(b * nb)
        total = 0.0
        for s in range(nb):
            idx = perm[s * b:(s + 1) * b]
            if epoch == 0 and s < 2:
                touched.append(_mf_checked(mx, net, trainer, loss_fn, data,
                                           idx, gpu, "adam"))
                continue
            loss = _mf_step(mx, net, trainer, loss_fn, users[idx],
                            items[idx], ratings[idx], gpu)
            total += float(loss.mean().asscalar())
        rmse.append(float(np.sqrt(2 * total / (nb - (2 if epoch == 0
                                                     else 0)))))
    if not rmse[-1] < rmse[0]:
        fail(f"sparse_mf: train RMSE did not fall: {rmse}")
    rs = np.random.RandomState(seed + 1)
    batches = [rs.randint(0, b * nb, b) for _ in range(MF["timed"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in batches:
        _mf_step(mx, net, trainer, loss_fn, users[idx], items[idx],
                 ratings[idx], gpu)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for idx in batches[:MF["profiled"]]:
            _mf_step(mx, net, trainer, loss_fn, users[idx], items[idx],
                     ratings[idx], gpu)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_row = _profile_summary(prof, wall)
    # the other lazy updates on the card
    others = {}
    for name, kw in (("sgd", MF_SGD), ("adagrad", MF_ADAGRAD)):
        tr = mx.gluon.Trainer(net.collect_params(), name, dict(kw))
        for k in range(MF["other_steps"]):
            others.setdefault(name, []).append(_mf_checked(
                mx, net, tr, loss_fn, data, batches[k], gpu, name))
    # one Adam step, card vs CPU, from the same weights and batch
    weights = {n: p.data().asnumpy() for n, p in
               net.collect_params().items()}
    idx = batches[-1]
    res = []
    for ctx in (gpu, mx.cpu()):
        twin = mf_block(mx, MF["users"], MF["items"], MF["factor"],
                        prefix=net.prefix)
        twin.initialize(mx.init.Zero(), ctx=ctx)
        for n, p in twin.collect_params().items():
            p.set_data(mx.nd.array(weights[n], ctx=ctx))
        tr = mx.gluon.Trainer(twin.collect_params(), "adam",
                              {"learning_rate": MF["lr"]})
        _mf_step(mx, twin, tr, loss_fn, users[idx], items[idx],
                 ratings[idx], ctx)
        res.append({n: p.data().asnumpy() for n, p in
                    twin.collect_params().items()})
        del twin, tr
    errs = {n: float(np.abs(res[0][n] - res[1][n]).max()) /
            max(float(np.abs(res[1][n]).max()), 1e-30) for n in res[1]}
    if max(errs.values()) > SPARSE_RTOL:
        fail(f"sparse_mf: card vs CPU step {errs} > {SPARSE_RTOL}")
    emit({"phase": "sparse_mf", "users": MF["users"], "items": MF["items"],
          "factor": MF["factor"], "batch": b, "epoch_rmse": rmse,
          "rating_std": float(np.std(ratings)), "adam_step_ms": step_ms,
          "rows_touched_a_step": touched, "other_steps_rows": others,
          "vs_cpu_of_max": errs, "rtol": SPARSE_RTOL, "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "profile": {k: profile_row[k] for k in
                      ("wall_s", "device_busy_s", "device_idle_share",
                       "device_ms_by_kind")}})


def write_libsvm(path, n, d, nnz, seed):
    """Seeded libsvm rows as examples/linear_classification.py's
    synthetic_libsvm writes them (a sparse true weight, label = the sign
    of the row's dot with it), with ``nnz`` distinct sorted features a
    row."""
    rs = np.random.RandomState(seed)
    true_w = rs.randn(d) * (rs.rand(d) < 0.2)
    idx = np.sort(rs.randint(0, d, (n, nnz)), axis=1)
    dup = (np.diff(idx, axis=1) == 0).any(1)
    while dup.any():
        idx[dup] = np.sort(rs.randint(0, d, (int(dup.sum()), nnz)), axis=1)
        dup = (np.diff(idx, axis=1) == 0).any(1)
    val = rs.rand(n, nnz).astype("float32")
    labels = ((val * true_w[idx]).sum(1) > 0).astype(int)
    with open(path, "w") as f:
        for lab, ids, vs in zip(labels, idx, val):
            f.write(f"{lab} " + " ".join(
                f"{i}:{v:.4f}" for i, v in zip(ids, vs)) + "\n")


def phase_sparse_linear(seed, tmpdir):
    """examples/linear_classification.py's loop (LibSVMIter ->
    sparse.dot(csr, w) -> its transposed dot -> Adam) at MXNet's avazu
    setting (1,000,001 features, b=8192) on 16 batches of seeded rows,
    15 nonzeros a row; each CSR batch goes to the card and both dots run
    there.  The first batch's two dots against the CPU."""
    import os
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import io as mio
    from incubator_mxnet_tpu_torch.ndarray import sparse
    gpu = mx.gpu(0)
    d, bsz = LIN["features"], LIN["batch"]
    path = os.path.join(tmpdir, "linear.libsvm")
    t0 = time.perf_counter()
    write_libsvm(path, bsz * LIN["batches"], d, LIN["nnz"], seed)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = mio.LibSVMIter(data_libsvm=path, data_shape=(d,), batch_size=bsz)
    parse_ms = (time.perf_counter() - t0) * 1e3
    w = mx.nd.array(np.zeros((d, 1), "float32"), ctx=gpu)
    b = mx.nd.array(np.zeros((1,), "float32"), ctx=gpu)
    opt = mx.optimizer.Adam(learning_rate=LIN["lr"])
    st_w, st_b = opt.create_state(0, w), opt.create_state(1, b)
    batch_ms, acc = [], None
    first = None
    for epoch in range(LIN["epochs"]):
        it.reset()
        total, correct = 0, 0
        for batch in it:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            csr = batch.data[0].as_in_context(gpu)
            y = batch.label[0].asnumpy()[:, None]
            dot = sparse.dot(csr, w).asnumpy()
            logits = dot + b.asnumpy()
            prob = 1 / (1 + np.exp(-logits))
            correct += int(((prob > 0.5) == y).sum())
            total += len(y)
            gl = (prob - y) / len(y)
            gw = sparse.dot(csr, mx.nd.array(gl, ctx=gpu), transpose_a=True)
            if epoch == 1 and first is None:
                first = (batch.data[0], w.asnumpy(), gl, dot, gw.asnumpy())
            opt.update(0, w, gw, st_w)
            opt.update(1, b, mx.nd.array(gl.sum(0), ctx=gpu), st_b)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        acc = correct / total
    csr_cpu, w0, gl0, card_dot, card_gw = first
    with mx.cpu():
        cpu_logits = sparse.dot(csr_cpu, mx.nd.array(w0)).asnumpy()
        cpu_gw = sparse.dot(csr_cpu, mx.nd.array(gl0),
                            transpose_a=True).asnumpy()
    errs = {"dot": float(np.abs(card_dot - cpu_logits).max()) /
            max(float(np.abs(cpu_logits).max()), 1e-30),
            "dot_transpose_a": float(np.abs(card_gw - cpu_gw).max()) /
            max(float(np.abs(cpu_gw).max()), 1e-30)}
    if max(errs.values()) > SPARSE_RTOL:
        fail(f"sparse_linear: card vs CPU dots {errs} > {SPARSE_RTOL}")
    if not acc > 0.8:
        fail(f"sparse_linear: accuracy {acc} <= 0.8 (the example's bar)")
    emit({"phase": "sparse_linear", "features": d, "batch": bsz,
          "batches": LIN["batches"], "nnz_a_row": LIN["nnz"],
          "write_s": write_s, "parse_ms": parse_ms,
          "batch_ms_median": float(np.median(batch_ms)),
          "batch_ms_first": batch_ms[0], "train_accuracy": acc,
          "vs_cpu_of_max": errs, "rtol": SPARSE_RTOL})


def wide_deep_example(mx, TrainStep, steps=300):
    """examples/wide_deep.py with only the import changed: the three
    trainings and their asserts.  Returns the three accuracies."""
    gluon, nn = mx.gluon, mx.gluon.nn
    N_CAT, CARD = 2, 64
    CROSS_DIM = CARD * CARD
    _rules = np.random.RandomState(123)
    FLIP_PAIRS = set(map(tuple, _rules.randint(0, CARD, (40, 2))))
    HEAD_PAIRS = _rules.randint(0, CARD, (200, 2))

    def make_data(rs, n, train=True):
        if train:
            head = HEAD_PAIRS[rs.randint(0, len(HEAD_PAIRS), n)]
            tail = rs.randint(0, CARD, (n, N_CAT))
            use_head = (rs.rand(n) < 0.9)[:, None]
            f = np.where(use_head, head, tail)
        else:
            f = rs.randint(0, CARD, (n, N_CAT))
        group = (f // 16).sum(axis=1) % 2
        cross_hit = np.array([tuple(row) in FLIP_PAIRS for row in f])
        y = np.where(cross_hit, 1 - group, group)
        return f.astype("float32"), y.astype("float32")

    class WideDeep(gluon.Block):
        def __init__(self, wide=True, deep=True, **kwargs):
            super().__init__(**kwargs)
            self._wide, self._deep = wide, deep
            with self.name_scope():
                if wide:
                    self.wide_w = nn.Embedding(CROSS_DIM, 1, sparse_grad=True)
                if deep:
                    self.embed = nn.Embedding(CARD * N_CAT, 8,
                                              sparse_grad=True)
                    self.mlp = nn.HybridSequential()
                    with self.mlp.name_scope():
                        self.mlp.add(nn.Dense(16, activation="relu",
                                              in_units=8 * N_CAT,
                                              flatten=False),
                                     nn.Dense(1, in_units=16, flatten=False))

        def forward(self, fields):
            parts = []
            if self._wide:
                cross = fields[:, 0] * CARD + fields[:, 1]
                parts.append(self.wide_w(cross).reshape((-1,)))
            if self._deep:
                offset = mx.nd.array(
                    np.arange(N_CAT, dtype="float32") * CARD)
                emb = self.embed(fields + offset.reshape((1, N_CAT)))
                parts.append(self.mlp(emb.reshape((emb.shape[0], -1)))
                             .reshape((-1,)))
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out

    def train_and_eval(wide, deep, rs, steps):
        mx.random.seed(4)
        net = WideDeep(wide=wide, deep=deep, prefix="wd_")
        net.initialize(init=mx.init.Xavier())
        bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        step = TrainStep(net, lambda o, l: bce(o, l).mean(),
                         mx.optimizer.Adam(learning_rate=0.01))
        for _ in range(steps):
            f, y = make_data(rs, 256)
            step(mx.nd.array(f), mx.nd.array(y))
        step.sync_params()
        f, y = make_data(rs, 4096, train=False)
        pred = (net(mx.nd.array(f)).asnumpy() > 0).astype(np.float64)
        return float((pred == y).mean())

    rs = np.random.RandomState(0)
    acc_wide = train_and_eval(True, False, rs, steps)
    acc_deep = train_and_eval(False, True, rs, steps)
    acc_both = train_and_eval(True, True, rs, steps)
    assert acc_both > 0.9, acc_both
    assert acc_both > acc_wide + 0.01, (acc_wide, acc_both)
    assert acc_both > acc_deep + 0.01, (acc_deep, acc_both)
    return acc_wide, acc_deep, acc_both


def phase_wide_deep(seed):
    """examples/wide_deep.py as it stands on the card: three trainings
    through parallel.TrainStep (Gluon blocks with sparse_grad
    embeddings, updated densely as the JAX step does) and its asserts."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.parallel import TrainStep
    t0 = time.perf_counter()
    try:
        accs = wide_deep_example(mx, TrainStep)
    except AssertionError as e:
        fail(f"wide_deep: the example's assert failed: {e}")
    emit({"phase": "wide_deep", "accuracy": dict(zip(
        ("wide_only", "deep_only", "wide_and_deep"), accs)),
        "seconds": time.perf_counter() - t0})


def fast_rcnn_head(mx, classes, pooled, scale, conv5_3):
    """Fast R-CNN's ROI head on the zoo's VGG-16: its features through
    conv5_3 (stride 16), ROIPooling, its fc6 / fc7 (4096, ReLU, dropout),
    then a classifier and a box regressor."""
    gluon, nn = mx.gluon, mx.gluon.nn

    class FastRCNN(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.vgg = mx.gluon.model_zoo.vision.get_model("vgg16")
                self.cls = nn.Dense(classes, in_units=4096)
                self.bbox = nn.Dense(4 * classes, in_units=4096)

        def conv(self, x):
            layers = list(self.vgg.features._children.values())
            for layer in layers[:conv5_3]:
                x = layer(x)
            return x

        def forward(self, x, rois):
            feat = self.conv(x)
            cells = mx.nd.ROIPooling(feat, rois, pooled_size=(pooled,
                                                              pooled),
                                     spatial_scale=scale)
            h = cells.reshape((cells.shape[0], -1))
            for layer in list(self.vgg.features._children.values())[
                    conv5_3 + 1:]:
                h = layer(h)
            return self.cls(h), self.bbox(h)

    return FastRCNN(prefix="frcnn_")


def frcnn_batch(rs, n_img, rois_per, height, width, classes):
    """Seeded images, rois [batch, x1, y1, x2, y2] of 32..400 pixels, a
    quarter foreground with a class and box targets."""
    imgs = rs.randn(n_img, 3, height, width).astype(np.float32)
    r = n_img * rois_per
    w = rs.uniform(32, 400, r)
    h = rs.uniform(32, 400, r)
    x1 = rs.uniform(0, width - w)
    y1 = rs.uniform(0, height - h)
    rois = np.stack([np.repeat(np.arange(n_img), rois_per), x1, y1,
                     x1 + w, y1 + h], 1).astype(np.float32)
    labels = np.where(rs.rand(r) < 0.25, rs.randint(1, classes, r), 0)
    targets = np.zeros((r, 4 * classes), np.float32)
    mask = np.zeros_like(targets)
    for k in np.nonzero(labels)[0]:
        targets[k, 4 * labels[k]:4 * labels[k] + 4] = 0.1 * rs.randn(4)
        mask[k, 4 * labels[k]:4 * labels[k] + 4] = 1.0
    return imgs, rois, labels.astype(np.float32), targets, mask


def _frcnn_step(mx, net, trainer, batch, ctx):
    imgs, rois, labels, targets, mask = (mx.nd.array(a, ctx=ctx)
                                         for a in batch)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        cls, bbox = net(imgs, rois)
        box = mx.nd.smooth_l1((bbox - targets) * mask, scalar=1.0)
        loss = ce(cls, labels).mean() + box.sum() / rois.shape[0]
    loss.backward()
    trainer.step(1)
    return loss


def fast_rcnn_roi_example(mx, TrainStep, steps=200):
    """examples/fast_rcnn_roi.py with only the import changed: its
    synthetic scenes, FastRCNNHead, TrainStep loop and asserts.  Returns
    (accuracy, recalls)."""
    gluon, nn = mx.gluon, mx.gluon.nn
    SIZE, ROIS_PER_IMG = 32, 8

    def make_scene(rs):
        img = rs.rand(SIZE, SIZE).astype("float32") * 0.15
        boxes = {}
        s = rs.randint(8, 12)
        y, x = rs.randint(0, SIZE - s, 2)
        img[y:y + s, x:x + s] += 0.8
        boxes[1] = (x, y, x + s - 1, y + s - 1)
        r = rs.randint(5, 7)
        cy, cx = rs.randint(r, SIZE - r, 2)
        yy, xx = np.meshgrid(np.arange(SIZE), np.arange(SIZE),
                             indexing="ij")
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[disk] = 0.55 + rs.rand() * 0.25
        boxes[2] = (cx - r, cy - r, cx + r, cy + r)
        return img[None], boxes

    def jitter(box, rs, amt=2):
        x1, y1, x2, y2 = box
        j = rs.randint(-amt, amt + 1, 4)
        return (np.clip(x1 + j[0], 0, SIZE - 2),
                np.clip(y1 + j[1], 0, SIZE - 2),
                np.clip(x2 + j[2], 1, SIZE - 1),
                np.clip(y2 + j[3], 1, SIZE - 1))

    def random_bg_box(rs, boxes):
        for _ in range(50):
            w, h = rs.randint(6, 14, 2)
            x1 = rs.randint(0, SIZE - w)
            y1 = rs.randint(0, SIZE - h)
            cx, cy = x1 + w / 2, y1 + h / 2
            inside = False
            for (bx1, by1, bx2, by2) in boxes.values():
                if bx1 - 2 <= cx <= bx2 + 2 and by1 - 2 <= cy <= by2 + 2:
                    inside = True
                    break
            if not inside:
                return (x1, y1, x1 + w - 1, y1 + h - 1)
        return (0, 0, 5, 5)

    def make_batch(rs, n_img):
        imgs = np.zeros((n_img, 1, SIZE, SIZE), np.float32)
        rois = np.zeros((n_img * ROIS_PER_IMG, 5), np.float32)
        labels = np.zeros(n_img * ROIS_PER_IMG, np.float32)
        k = 0
        for i in range(n_img):
            imgs[i], boxes = make_scene(rs)
            for cls in (1, 2):
                for _ in range(2):
                    rois[k] = (i,) + jitter(boxes[cls], rs)
                    labels[k] = cls
                    k += 1
            for _ in range(4):
                rois[k] = (i,) + random_bg_box(rs, boxes)
                labels[k] = 0
                k += 1
        return imgs, rois, labels

    class FastRCNNHead(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                with self.backbone.name_scope():
                    self.backbone.add(
                        nn.Conv2D(16, 3, padding=1, activation="relu",
                                  in_channels=1),
                        nn.Conv2D(32, 3, strides=2, padding=1,
                                  activation="relu", in_channels=16))
                self.fc = nn.Dense(64, activation="relu",
                                   in_units=32 * 4 * 4)
                self.cls = nn.Dense(3, in_units=64)

        def forward(self, x, rois):
            feat = self.backbone(x)
            pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(4, 4),
                                      spatial_scale=0.5)
            return self.cls(self.fc(pooled.reshape((pooled.shape[0], -1))))

    rs = np.random.RandomState(0)
    mx.random.seed(0)
    net = FastRCNNHead(prefix="frcnn_")
    net.initialize(init=mx.init.Xavier())
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     mx.optimizer.Adam(learning_rate=2e-3))
    for i in range(steps):
        imgs, rois, labels = make_batch(rs, 8)
        float(step(mx.nd.array(imgs), mx.nd.array(rois),
                   mx.nd.array(labels)).asscalar())
    step.sync_params()
    imgs, rois, labels = make_batch(rs, 32)
    pred = net(mx.nd.array(imgs),
               mx.nd.array(rois)).asnumpy().argmax(axis=1)
    acc = float((pred == labels).mean())
    recalls = [float((pred[labels == c] == c).mean()) for c in range(3)]
    assert acc > 0.9, acc
    assert min(recalls) > 0.8, recalls
    return acc, recalls


def phase_fast_rcnn(seed):
    """Fast R-CNN's ROI head at MXNet example/rcnn's VGG-16 widths (2
    images of 600x1000, 128 seeded rois each, SGD 0.001 / 0.9 / 5e-4,
    fp32; random weights, synthetic boxes): timed and profiled steps;
    ROIPooling's forward and gradient at this geometry against the CPU;
    then examples/fast_rcnn_roi.py with its own asserts."""
    from torch.profiler import ProfilerActivity, profile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.parallel import TrainStep
    gpu = mx.gpu(0)
    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    mx.random.seed(seed)
    net = fast_rcnn_head(mx, FRCNN["classes"], FRCNN["pooled"],
                         FRCNN["scale"], FRCNN["conv5_3"])
    net.initialize(mx.init.Xavier(), ctx=gpu)
    # the zoo net's own classifier is not part of the head
    skip = net.vgg.output.prefix
    trainer = mx.gluon.Trainer(
        [p for n, p in net.collect_params().items()
         if not n.startswith(skip)], "sgd", {
        "learning_rate": FRCNN["lr"], "momentum": FRCNN["momentum"],
        "wd": FRCNN["wd"]})
    rs = np.random.RandomState(seed)
    batch = frcnn_batch(rs, FRCNN["images"], FRCNN["rois"],
                        FRCNN["height"], FRCNN["width"], FRCNN["classes"])
    losses = [float(_frcnn_step(mx, net, trainer, batch, gpu).asscalar())
              for _ in range(FRCNN["warm"])]
    setup_s = time.perf_counter() - t_setup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRCNN["timed"]):
        loss = _frcnn_step(mx, net, trainer, batch, gpu)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / FRCNN["timed"] * 1e3
    losses.append(float(loss.asscalar()))
    if not np.isfinite(losses).all():
        fail(f"fast_rcnn: losses not finite: {losses}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            _frcnn_step(mx, net, trainer, batch, gpu)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_row = _profile_summary(prof, wall)
    # ROIPooling at this geometry: the card's conv5_3 map, a subset of
    # the rois, forward and gradient against the CPU
    with mx.autograd.pause():
        feat = net.conv(mx.nd.array(batch[0], ctx=gpu)).asnumpy()
    rois = batch[1][rs.choice(len(batch[1]), FRCNN["cpu_rois"],
                              replace=False)]
    t_check = time.perf_counter()
    roi_row = _card_vs_cpu(
        mx, "ROIPooling", lambda m, f, r: m.nd.ROIPooling(
            f, r, pooled_size=(FRCNN["pooled"], FRCNN["pooled"]),
            spatial_scale=FRCNN["scale"]), [feat, rois], grad_idx=(0,),
        phase="fast_rcnn")
    check_s = time.perf_counter() - t_check
    peak = torch.cuda.max_memory_allocated() / 1e9
    del net, trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        acc, recalls = fast_rcnn_roi_example(mx, TrainStep)
    except AssertionError as e:
        fail(f"fast_rcnn: examples/fast_rcnn_roi.py's assert failed: {e}")
    emit({"phase": "fast_rcnn", "images": FRCNN["images"],
          "image_hw": [FRCNN["height"], FRCNN["width"]],
          "rois": FRCNN["images"] * FRCNN["rois"],
          "conv5_3": list(feat.shape), "step_ms": step_ms,
          "setup_s": setup_s, "roi_check_s": check_s,
          "losses": losses, "peak_mem_gb": peak,
          "profile": {k: profile_row[k] for k in
                      ("wall_s", "device_busy_s", "device_idle_share",
                       "device_ms_by_kind")},
          "roi_pooling_vs_cpu": roi_row,
          "example": {"accuracy": acc, "recalls": recalls,
                      "seconds": time.perf_counter() - t0}})


def phase_spatial_ops(seed):
    """The spatial ops at their users' geometry on the card against the
    CPU, forward and gradient: FlowNetC's Correlation (256 channels,
    48x64, max_displacement 20, stride2 2, pad 20: 441 displacements;
    b=4 on the card, its first sample on the CPU), FlowNet2's warping
    layer (GridGenerator("warp") + BilinearSampler on (8, 3, 384, 512))
    and a SpatialTransformer on (32, 3, 224, 224) -> 224x224."""
    import incubator_mxnet_tpu_torch as mx
    rs = np.random.RandomState(seed)
    rows = {}
    c = FLOWNET_CORR
    shape = (c["batch"], c["channels"], c["height"], c["width"])
    a = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    attrs = {k: c[k] for k in ("max_displacement", "stride2", "pad_size",
                               "kernel_size")}

    def corr(m, x, y):
        return m.nd.Correlation(x, y, **attrs)

    # b=4 on the card; the CPU runs the first sample (each sample is
    # its own computation), and the card's b=1 run gives the gradients
    # under the same head
    card = _nd_run(mx, corr, [a, b], mx.gpu(0), (0, 1), 0, False)
    cpu = _nd_run(mx, corr, [a[:1], b[:1]], mx.cpu(), (0, 1), 0, False)
    card1 = _nd_run(mx, corr, [a[:1], b[:1]], mx.gpu(0), (0, 1), 0, False)
    errs = {"out0": float(np.abs(card[0][0][:1] - cpu[0][0]).max()) /
            float(np.abs(cpu[0][0]).max())}
    for i in range(2):
        errs[f"grad{i}"] = float(np.abs(card1[1][i] - cpu[1][i]).max()) / \
            float(np.abs(cpu[1][i]).max())
    if max(errs.values()) > CONTRIB_RTOL:
        fail(f"spatial_ops Correlation: card vs CPU {errs}")
    xs = [mx.nd.array(v, ctx=mx.gpu(0)) for v in (a, b)]
    rows["Correlation"] = {
        "shapes": [list(shape)] * 2, "out_channels": card[0][0].shape[1],
        "of_max": errs, "rtol": CONTRIB_RTOL,
        "forward_ms": _host_ms(lambda: corr(mx, *xs).wait_to_read(),
                               iters=3)}
    img = rs.randn(*FLOWNET_WARP).astype(np.float32)
    flow = (3 * rs.randn(FLOWNET_WARP[0], 2, *FLOWNET_WARP[2:])).astype(
        np.float32)
    rows["warp"] = _card_vs_cpu(
        mx, "warp", lambda m, x, f: m.nd.BilinearSampler(
            x, m.nd.GridGenerator(f, transform_type="warp")),
        [img, flow], grad_idx=(0, 1), phase="spatial_ops")
    x = rs.randn(*STN["shape"]).astype(np.float32)
    loc = (np.array([0.9, 0.1, 0.05, -0.1, 1.1, -0.05], np.float32) +
           0.05 * rs.randn(STN["shape"][0], 6)).astype(np.float32)
    rows["SpatialTransformer"] = _card_vs_cpu(
        mx, "SpatialTransformer", lambda m, d, l: m.nd.SpatialTransformer(
            d, l, target_shape=STN["target"], transform_type="affine",
            sampler_type="bilinear"), [x, loc], grad_idx=(0, 1),
        phase="spatial_ops")
    emit({"phase": "spatial_ops", "rtol": CONTRIB_RTOL, "ops": rows})


def phase_image_ops(seed):
    """A b=32 uint8 HWC 224x224 batch on the card through random flip,
    random_color_jitter(0.4, 0.4, 0.4, 0.1), random_lighting(0.1),
    to_tensor and ImageNet normalize, then one forward of ResNet-50 v1
    (fuse_block=True): B1 and B2 16 times each.  The deterministic ops
    bit for bit against the CPU; the random ones by their properties
    (one coin or factor per call, drawn in range)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.ops import sbr_conv3x3, sbr_matmul
    io = IMAGE_OPS
    gpu = mx.gpu(0)
    img = mx.nd.image
    rs = np.random.RandomState(seed)
    host = rs.randint(0, 256, (io["batch"], io["edge"], io["edge"], 3)
                      ).astype(np.uint8)
    x = mx.nd.array(host, ctx=gpu, dtype="uint8")
    det = {}
    for name, fn, kw in (("to_tensor", img.to_tensor, {}),
                         ("flip_left_right", img.flip_left_right, {}),
                         ("flip_top_bottom", img.flip_top_bottom, {})):
        card = fn(x, **kw).asnumpy()
        with mx.cpu():
            cpu = fn(mx.nd.array(host, dtype="uint8"), **kw).asnumpy()
        if not np.array_equal(card, cpu):
            fail(f"image_ops {name}: card != CPU")
        det[name] = "equal"
    t = img.to_tensor(x)
    card = img.normalize(t, mean=io["mean"], std=io["std"]).asnumpy()
    with mx.cpu():
        cpu = img.normalize(mx.nd.array(t.asnumpy()), mean=io["mean"],
                            std=io["std"]).asnumpy()
    if not np.array_equal(card, cpu):
        fail("image_ops normalize: card != CPU")
    det["normalize"] = "equal"
    xf = x.astype("float32")
    # one coin per call: the whole batch flipped, or none of it
    coins = []
    for _ in range(8):
        out = img.random_flip_left_right(x).asnumpy()
        if np.array_equal(out, host):
            coins.append(0)
        elif np.array_equal(out, host[:, :, ::-1]):
            coins.append(1)
        else:
            fail("image_ops random_flip_left_right: not one coin a call")
    # one factor per call, in range
    factors = []
    for _ in range(4):
        out = img.random_brightness(xf, min_factor=0.6,
                                    max_factor=1.4).asnumpy()
        ratio = out[host > 0] / host[host > 0]
        f = float(np.median(ratio))
        if not (0.6 <= f < 1.4 and np.allclose(ratio, f, rtol=1e-6)):
            fail(f"image_ops random_brightness: factor {f} not one per "
                 "call in [0.6, 1.4)")
        factors.append(f)
    out = img.random_lighting(xf, alpha_std=io["lighting"]).asnumpy()
    delta = (out - host).reshape(-1, 3)
    if not np.allclose(delta, delta[0], atol=1e-3):
        fail("image_ops random_lighting: not one offset per call")
    # the pipeline (timed warm, host clock around a synchronised chain),
    # then the net
    def augment():
        y = img.random_flip_left_right(x)
        y = img.random_color_jitter(y, **dict(zip(
            ("brightness", "contrast", "saturation", "hue"), io["jitter"])))
        y = img.random_lighting(y, alpha_std=io["lighting"])
        y = img.to_tensor(y)
        return img.normalize(y, mean=io["mean"], std=io["std"])

    augment().wait_to_read()
    aug_ms = _host_ms(lambda: augment().wait_to_read(), iters=5)
    y = augment()
    if y.shape != (io["batch"], 3, io["edge"], io["edge"]) or \
            not np.isfinite(y.asnumpy()).all():
        fail(f"image_ops: bad augmented batch {y.shape}")
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **RESNET50).eval()
    nhwc = y._data.permute(0, 2, 3, 1).contiguous()
    with torch.inference_mode():
        net(nhwc)
        sbr_matmul.launches = sbr_conv3x3.launches = 0
        logits = net(nhwc)
        torch.cuda.synchronize()
    launches = {"sbr_matmul": sbr_matmul.launches,
                "sbr_conv3x3": sbr_conv3x3.launches}
    if any(v != 16 for v in launches.values()):
        fail(f"image_ops: ResNet-50 forward launched {launches}, expected "
             "16 each")
    if tuple(logits.shape) != (io["batch"], 1000) or \
            not torch.isfinite(logits).all():
        fail("image_ops: bad logits")
    emit({"phase": "image_ops", "batch": io["batch"],
          "deterministic_vs_cpu": det, "flip_coins": coins,
          "brightness_factors": factors, "augment_ms": aug_ms,
          "forward_launches": launches})


def _moments(x, mean, var, what):
    """Mean and variance of the draws within 5 standard errors."""
    x = x.double().flatten()
    n = x.numel()
    m4 = ((x - x.mean()) ** 4).mean().item()
    se_mean = math.sqrt(var / n)
    se_var = math.sqrt(max(m4 - var * var, 1e-30) / n)
    got_m, got_v = x.mean().item(), x.var(unbiased=False).item()
    if abs(got_m - mean) > 5 * se_mean or abs(got_v - var) > 5 * se_var:
        fail(f"indexing_random_ops {what}: mean {got_m} var {got_v}, "
             f"expected {mean} {var}")
    return {"mean": got_m, "var": got_v, "mean_se": se_mean}


def phase_indexing_random_ops(seed):
    """gather_nd / scatter_nd picking 8192 (b, t) positions of a (32,
    512, 768) tensor, forward and gradient against the CPU; each sampler
    at 1M draws on the card, its mean and variance within 5 standard
    errors; sample_multinomial over (1024, 33278) probabilities with
    get_prob the log-probability of the drawn ids; the same seed, the
    same draws."""
    import incubator_mxnet_tpu_torch as mx
    rs = np.random.RandomState(seed)
    g = GATHER
    data = rs.randn(*g["shape"]).astype(np.float32)
    idx = np.stack([rs.randint(0, g["shape"][0], g["picks"]),
                    rs.randint(0, g["shape"][1], g["picks"])]).astype(
        np.float32)
    rows = {"gather_nd": _card_vs_cpu(
        mx, "gather_nd", lambda m, d, i: m.nd.gather_nd(d, i), [data, idx],
        grad_idx=(0,), rtol=SPARSE_RTOL, phase="indexing_random_ops")}
    vals = rs.randn(g["picks"], g["shape"][2]).astype(np.float32)
    rows["scatter_nd"] = _card_vs_cpu(
        mx, "scatter_nd", lambda m, v, i: m.nd.scatter_nd(
            v, i, shape=g["shape"]), [vals, idx], grad_idx=(0,),
        rtol=0.0, phase="indexing_random_ops")
    gpu = mx.gpu(0)
    n = SAMPLER_DRAWS
    nd = mx.nd
    k, p, mu, alpha = 3, 0.4, 2.0, 0.5
    samplers = {
        "gamma": (lambda: nd.random.gamma(alpha=2.5, beta=0.7, shape=(n,),
                                          ctx=gpu), 1.75, 2.5 * 0.49),
        "exponential": (lambda: nd.random.exponential(lam=4.0, shape=(n,),
                                                      ctx=gpu), 0.25, 1 / 16),
        "poisson": (lambda: nd.random.poisson(lam=3.5, shape=(n,), ctx=gpu),
                    3.5, 3.5),
        "negative_binomial": (lambda: nd.random.negative_binomial(
            k=k, p=p, shape=(n,), ctx=gpu), k * (1 - p) / p,
            k * (1 - p) / p ** 2),
        "generalized_negative_binomial": (
            lambda: nd.random.generalized_negative_binomial(
                mu=mu, alpha=alpha, shape=(n,), ctx=gpu), mu,
            mu + alpha * mu ** 2),
        "uniform": (lambda: nd.random.uniform(low=-1.0, high=3.0, shape=(n,),
                                              ctx=gpu), 1.0, 16 / 12),
        "normal": (lambda: nd.random.normal(loc=0.5, scale=2.0, shape=(n,),
                                            ctx=gpu),
                   0.5, 4.0)}
    draws = {}
    for name, (fn, mean, var) in samplers.items():
        mx.random.seed(seed + 3)
        out = fn()
        if out._data.device.type != "cuda" or out.shape != (n,):
            fail(f"indexing_random_ops {name}: not {n} draws on the card")
        draws[name] = _moments(out._data, mean, var, name)
        mx.random.seed(seed + 3)
        if not torch.equal(fn()._data, out._data):
            fail(f"indexing_random_ops {name}: the same seed gave other "
                 "draws")
    lam = mx.nd.array(np.array([0.5, 2.0, 7.0, 20.0], np.float32), ctx=gpu)
    per = n // 4
    out = nd._sample_poisson(lam, shape=(per,))
    for j, l in enumerate((0.5, 2.0, 7.0, 20.0)):
        draws[f"_sample_poisson[{l}]"] = _moments(out._data[j], l, l,
                                                  "_sample_poisson")
    out = nd._sample_exponential(lam, shape=(per,))
    for j, l in enumerate((0.5, 2.0, 7.0, 20.0)):
        draws[f"_sample_exponential[{l}]"] = _moments(
            out._data[j], 1 / l, 1 / l ** 2, "_sample_exponential")
    probs = rs.rand(*MULTINOMIAL).astype(np.float32) ** 4
    pc = mx.nd.array(probs, ctx=gpu)
    mx.random.seed(seed + 5)
    ids, logp = nd.sample_multinomial(pc, get_prob=True)
    ids_np, logp_np = ids.asnumpy(), logp.asnumpy()
    if ids_np.shape != (MULTINOMIAL[0],) or ids_np.min() < 0 or \
            ids_np.max() >= MULTINOMIAL[1]:
        fail("indexing_random_ops sample_multinomial: bad ids")
    norm = probs / probs.sum(1, keepdims=True)
    want = np.log(norm[np.arange(MULTINOMIAL[0]), ids_np])
    lp_err = float(np.abs(logp_np - want).max())
    if lp_err > 1e-4:
        fail(f"indexing_random_ops sample_multinomial: get_prob off by "
             f"{lp_err}")
    mx.random.seed(seed + 5)
    if not np.array_equal(nd.sample_multinomial(pc).asnumpy(), ids_np):
        fail("indexing_random_ops sample_multinomial: the same seed gave "
             "other draws")
    ms = _host_ms(lambda: nd.sample_multinomial(pc).wait_to_read(),
                  iters=5)
    emit({"phase": "indexing_random_ops", "ops": rows, "samplers": draws,
          "multinomial": {"shape": list(MULTINOMIAL),
                          "get_prob_max_abs_err": lp_err, "ms": ms}})


# data parallelism: the two-rank phases run tools/port_dist_worker.py
# under tools/launch.py (both ranks on the one card over gloo); the
# single process on the global batch and the bf16 spread of each config
# are run here after them
DIST_WORKER_TIMEOUT_S = 600
DIST_WORLD1_BATCH = 32
DIST_KV_SEED = 23
# dist_two_ranks: bench.py:main's global batch over two ranks, its two
# kernel configurations (B1/B2; B3/B4) and their bf16 launches a step
DIST_GLOBAL_BATCH, DIST_STEPS = 128, 5
DIST_CONFIGS = {"fused": dict(BENCH_NET, fuse_block=True),
                "chain": BENCH_CHAIN_NET}
DIST_PER_STEP = {"fused": dict(sbr_matmul_bf16=16, sbr_conv3x3_bf16=16),
                 "chain": dict(chain_stats_bf16=16, chain_emit_bf16=16)}
# the one-process reference's other bf16 formulation (the spread)
DIST_ALT = {"fused": dict(fuse_bn_relu=False), "chain": dict(fuse_block=False)}
# the two-rank run's parameters after DIST_STEPS steps against the one
# process's: each leaf's change error (as at BF16_STEP_FACTOR) within
# DIST_STEP_FACTOR of the median over the leaves of the two bf16
# formulations' spread.  On an NVIDIA H100 80GB HBM3 at 700 W over
# seeds 0-3 (tools/port_dist_margin.py) the worst leaf lay at 1.28-1.65x
# that median, the stem BatchNorm's gamma or beta in 7 of 8 readings
# (a sum over 128 x 112 x 112 bf16 terms that nearly cancel), and a
# rank's half batch alone, the planted fault, at 3.29-3.56x; so the
# factor is 2.0, and the phase checks that the planted fault fails it
DIST_STEP_FACTOR = 2.0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (its default
    backward algorithms may add in another order each run)."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


# C18's card check: moe_ffn with a zero gate (every token's expert
# probabilities tied) at the ep LM's widths, card vs CPU
MOE_TIE = dict(tokens=1024, dim=768, experts=4, hidden=3072, top_k=2)


def phase_moe_zero_gate(seed):
    """``moe_ffn`` with ``gate_w = 0`` on the card: each token's experts
    are the two lowest (the stable sort's tie rule, as ``lax.top_k``
    picks), and the output, aux loss and gradients equal the CPU's
    within CARD_VS_CPU_RTOL of each tensor's max."""
    from incubator_mxnet_tpu_torch.parallel.moe import (_dispatch_tensors,
                                                        moe_ffn)
    m = MOE_TIE
    rs = np.random.RandomState(seed + 18)
    f = np.float32
    host = [rs.randn(m["tokens"], m["dim"]).astype(f),
            np.zeros((m["dim"], m["experts"]), f),
            (0.02 * rs.randn(m["experts"], m["dim"], m["hidden"])).astype(f),
            (0.01 * rs.randn(m["experts"], m["hidden"])).astype(f),
            (0.02 * rs.randn(m["experts"], m["hidden"], m["dim"])).astype(f),
            (0.01 * rs.randn(m["experts"], m["dim"])).astype(f)]
    cot = rs.randn(m["tokens"], m["dim"]).astype(f)
    got = {}
    for dev in ("cuda:0", "cpu"):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in host]
        y, aux = moe_ffn(*ts, top_k=m["top_k"], capacity_factor=1.0)
        ((y * torch.tensor(cot, device=dev)).sum() + aux).backward()
        got[dev] = [y.detach().cpu(), aux.detach().cpu().reshape(1)] + \
            [t.grad.cpu() for t in ts]
    probs = torch.full((m["tokens"], m["experts"]), 1.0 / m["experts"],
                       device="cuda:0")
    dispatch, _ = _dispatch_tensors(probs, m["top_k"], m["tokens"], True)
    chosen = sorted(set(dispatch.sum(-1).nonzero()[:, 1].tolist()))
    err = _worst_of_max(got["cuda:0"], got["cpu"])
    emit({"phase": "moe_zero_gate", **m, "experts_chosen": chosen,
          "card_vs_cpu_err_of_max": err, "rtol": CARD_VS_CPU_RTOL})
    if chosen != list(range(m["top_k"])):
        fail(f"moe_zero_gate: tied tokens went to experts {chosen}, not "
             f"the lowest {m['top_k']}")
    if not err <= CARD_VS_CPU_RTOL:
        fail(f"moe_zero_gate: card vs CPU {err} > {CARD_VS_CPU_RTOL} of "
             f"max")


# group2ctx's card check: a two-group MLP (ResNet-50's classifier
# widths), one group's arrays on the CPU, the other's on the card
G2C = dict(batch=64, features=2048, hidden=1024, classes=1000)


def phase_group2ctx(seed):
    """``group2ctx={"dev1": cpu(0), "dev2": gpu(0)}`` under a ``gpu(0)``
    executor: each group's argument and gradient arrays live on its
    context, and forward and backward equal the one-device bind within
    1e-6 of each array's max."""
    import incubator_mxnet_tpu_torch as mx
    g = G2C
    rs = np.random.RandomState(seed + 22)
    vals = {"x": rs.rand(g["batch"], g["features"]),
            "w1": 0.02 * rs.randn(g["hidden"], g["features"]),
            "w2": 0.02 * rs.randn(g["classes"], g["hidden"])}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    cot = rs.randn(g["batch"], g["classes"]).astype(np.float32)
    with mx.AttrScope(ctx_group="dev1"):
        x, w1 = mx.sym.var("x"), mx.sym.var("w1")
        h = mx.sym.FullyConnected(x, weight=w1, no_bias=True,
                                  num_hidden=g["hidden"])
    with mx.AttrScope(ctx_group="dev2"):
        w2 = mx.sym.var("w2")
        out = mx.sym.FullyConnected(mx.sym.relu(h), weight=w2, no_bias=True,
                                    num_hidden=g["classes"])
    gpu, runs = mx.gpu(0), {}
    for key, g2c in (("placed", {"dev1": mx.cpu(0), "dev2": gpu}),
                     ("one", None)):
        ex = out.bind(ctx=gpu, args={k: mx.nd.array(v, ctx=gpu)
                                     for k, v in vals.items()},
                      args_grad={k: mx.nd.zeros(v.shape, ctx=gpu)
                                 for k, v in vals.items()},
                      group2ctx=g2c)
        y = ex.forward(is_train=True)[0]
        ex.backward(mx.nd.array(cot, ctx=gpu))
        runs[key] = ([y] + [ex.grad_dict[k] for k in vals],
                     {k: (str(ex.arg_dict[k].context),
                          str(ex.grad_dict[k].context)) for k in vals})
    placed, one = runs["placed"], runs["one"]
    err = _worst_of_max(placed[0], one[0])
    emit({"phase": "group2ctx", **g, "contexts": placed[1],
          "vs_one_device_err_of_max": err})
    if placed[1] != {"x": ("cpu(0)", "cpu(0)"), "w1": ("cpu(0)", "cpu(0)"),
                     "w2": ("gpu(0)", "gpu(0)")}:
        fail(f"group2ctx: arrays on {placed[1]}")
    if not err <= 1e-6:
        fail(f"group2ctx: the placed bind differs from the one-device "
             f"bind by {err} of max")


def phase_dist_world1(seed):
    """An NCCL world of one rank in this process, on a TCPStore at a
    free port: ``kv.create("dist_sync")`` push and pull of a gradient the
    size of each of ResNet-50's parameters (the mean over one rank: the
    gradient itself), and one bf16 ``TrainStep(mesh=make_mesh(dp=1))``
    step (its gradients through one NCCL ``all_reduce``) against the
    same step with no mesh, bit for bit, with the same kernel
    launches."""
    import torch.distributed as tdist
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    store = tdist.TCPStore("127.0.0.1", _free_port(), 1, True)
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        kv = mx.kv.create("dist_sync")
        net = get_resnet(1, 50, device="cuda:0", seed=seed, **RESNET50)
        gen = torch.Generator(device="cuda").manual_seed(DIST_KV_SEED)
        gpu = mx.gpu(0)
        grads = [torch.randn(p.shape, generator=gen, device="cuda")
                 for p in net.parameters()]
        outs = [mx.nd.zeros(g.shape, ctx=gpu) for g in grads]
        kv.init(list(range(len(grads))),
                [mx.nd.NDArray(p.detach().clone(), gpu)
                 for p in net.parameters()])
        torch.cuda.synchronize()
        _telemetry().reset()
        t0 = time.perf_counter()
        for i, g in enumerate(grads):
            kv.push(i, mx.nd.NDArray(g, gpu))
            kv.pull(i, out=outs[i])
        torch.cuda.synchronize()
        kv_ms = (time.perf_counter() - t0) * 1e3
        kv_tel = _held("dist_world1", _telemetry().report(as_dict=True),
                       {"kvstore.push.count": len(grads),
                        "kvstore.pull.count": len(grads)})
        kv_equal = all(torch.equal(o._data, g) for o, g in zip(outs, grads))
        del net, grads, outs
        mesh = make_mesh(dp=1)
        backend = tdist.get_backend(mesh.group("dp"))
        cfg = dict(BENCH_NET, fuse_block=True)
        x, y = _resident(seed + 9, DIST_WORLD1_BATCH)
        runs = {}
        # two runs compared bit for bit: cuDNN's deterministic algorithms
        with _cudnn_deterministic():
            for key, kw in (("mesh", dict(mesh=mesh)), ("plain", {})):
                net = get_resnet(1, 50, device="cuda:0", seed=seed, **cfg)
                step = _train_step(net, bf16_compute=True, **kw)
                _zero_counts()
                loss = step(x, y).item()
                torch.cuda.synchronize()
                runs[key] = (loss, _counts(), net.state_dict())
        equal = runs["mesh"][0] == runs["plain"][0] and all(
            torch.equal(v, runs["plain"][2][k])
            for k, v in runs["mesh"][2].items())
        launches = runs["mesh"][1]
    finally:
        tdist.destroy_process_group()
    want = dict.fromkeys(launches, 0)
    want.update(sbr_matmul_bf16=16, sbr_conv3x3_bf16=16)
    emit({"phase": "dist_world1", "backend": backend,
          "kv_keys": len(kv._data), "kv_push_pull_ms": kv_ms,
          "kv_pull_equals_push": kv_equal, "kv_telemetry": kv_tel,
          "batch": DIST_WORLD1_BATCH,
          "loss_mesh": runs["mesh"][0], "loss_plain": runs["plain"][0],
          "mesh_step_bit_equal": equal, "launches": launches,
          "launches_plain": runs["plain"][1]})
    if backend != "nccl":
        fail(f"dist_world1: the mesh's dp group runs {backend}, not nccl")
    if not kv_equal:
        fail("dist_world1: a dist_sync pull over one rank is not the push")
    if not equal:
        fail("dist_world1: the dp=1 mesh step differs from the plain step")
    _expect(launches, want, "dist_world1's mesh step")
    _expect(runs["plain"][1], launches, "dist_world1's plain step")
    return launches


def _dist_reference(seed, cfg, alt_kw):
    """One process on the global batch, under cuDNN's deterministic
    algorithms: (init, the final state and losses after the worker's
    steps in bf16, the same in the alternative bf16 formulation and in
    fp32, the launches of the steps at the local batch and the state
    they end in: one rank's half alone, the planted fault)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    xd, yd = _resident(seed, DIST_GLOBAL_BATCH)
    half = DIST_GLOBAL_BATCH // 2
    out = {}
    with _cudnn_deterministic():
        for key, kw, bf16, n in (("ref", cfg, True, DIST_GLOBAL_BATCH),
                                 ("alt", dict(cfg, **alt_kw), True,
                                  DIST_GLOBAL_BATCH),
                                 ("fp32", cfg, False, DIST_GLOBAL_BATCH),
                                 ("half", cfg, True, half)):
            net = get_resnet(1, 50, device="cuda:0", seed=seed, **kw)
            if key == "ref":
                out["init"] = {k: v.detach().cpu().clone()
                               for k, v in net.state_dict().items()}
            step = _train_step(net, bf16_compute=bf16)
            _zero_counts()
            out[key + "_losses"] = [step(xd[:n], yd[:n]).item()
                                    for _ in range(DIST_STEPS)]
            torch.cuda.synchronize()
            if key == "half":
                out["launches"] = _counts()
            out[key] = {k: v.detach().cpu()
                        for k, v in net.state_dict().items()}
            del net, step
            torch.cuda.empty_cache()
    return out


def _dist_noise_leaves(ref, ref32, init, params):
    """The leaves whose gradient is 0 to within rounding, by
    phase_bf16_reference's rule over DIST_STEPS momentum steps: the
    gradient part of the change of the fp32 run at most BF16_NOISE_GRAD
    of the bf16 run's.  With the weights all but constant over the
    steps, weight decay moves a leaf by -lr * wd * w * C, where C sums
    the momentum's geometric series over the steps."""
    m = SGD_KW["momentum"]
    c = sum(sum(m ** s for s in range(t)) for t in
            range(1, DIST_STEPS + 1))
    lr_wd = c * SGD_KW["learning_rate"] * SGD_KW["wd"]
    return sorted(k for k in params if
                  (ref32[k] - init[k] + lr_wd * init[k]).norm() <=
                  BF16_NOISE_GRAD *
                  (ref[k] - init[k] + lr_wd * init[k]).norm())


def _dist_run_ranks(seed, mesh_only=False):
    """tools/port_dist_worker.py under tools/launch.py -n 2 (both ranks
    on the one card over gloo): each rank's JSON and rank 0's final
    state of each config.  A rank that exits non-zero fails the phase."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    # the ranks need the card's memory: give back this process's cache
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
             "2", "--", sys.executable,
             os.path.join(root, "tools", "port_dist_worker.py"), "--out",
             out, "--seed", str(seed)] + (["--mesh-only"] if mesh_only
                                          else []),
            cwd=root, capture_output=True, text=True,
            timeout=DIST_WORKER_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"dist_two_ranks: a rank failed (rc {proc.returncode}):\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        finals = {name: torch.load(os.path.join(out, f"{name}.pt"))
                  for name in DIST_CONFIGS}
    return ranks, finals, ranks_s


def _dist_rows(seed, ranks, finals):
    """Each config's two-rank run against the single process on the
    global batch: (rows, launches, failures).  The parameters are held
    by the per-leaf change gate of phase_bf16_reference at
    DIST_STEP_FACTOR (the leaves of zero gradient left out by its rule,
    here over DIST_STEPS steps), and the half batch alone, a rank that
    never hears of the other, must fail it."""
    rows, launches, failures = {}, {}, []
    for i, name in enumerate(DIST_CONFIGS):
        ref = _dist_reference(seed, DIST_CONFIGS[name], DIST_ALT[name])
        got = finals[name]
        stats = [k for k in got if k.endswith(("running_mean",
                                               "running_var"))]
        params = [k for k in got if k not in stats]
        noise = _dist_noise_leaves(ref["ref"], ref["fp32"], ref["init"],
                                   params)
        kept = [k for k in params if k not in noise]
        spread = _change_errs(ref["alt"], ref["ref"], ref["init"], kept)
        bound = DIST_STEP_FACTOR * float(np.median(list(spread.values())))
        errs = _change_errs(got, ref["ref"], ref["init"], kept)
        worst_key = max(errs, key=errs.get)
        half_err = float(np.median(list(_change_errs(
            ref["half"], ref["ref"], ref["init"], kept).values())))
        stats_worst = _worst(got, ref["ref"], stats, rtol=1.0)
        stats_spread = _worst(ref["alt"], ref["ref"], stats, rtol=1.0)
        per_rank = [rk["dist_two_ranks"][i] for rk in ranks]
        # each step's loss within BF16_LOSS_RTOL, or within
        # BF16_SPREAD_FACTOR of the two formulations' difference where
        # that is larger (a loss near 0 after a few steps)
        loss_rel = max(abs(a - b) / max(BF16_LOSS_RTOL * abs(b),
                                        BF16_SPREAD_FACTOR * abs(c - b))
                       for a, b, c in zip(per_rank[0]["losses"],
                                          ref["ref_losses"],
                                          ref["alt_losses"]))
        launches[name] = per_rank[0]["launches"]
        rows[name] = {
            "per_rank": [{k: pr[k] for k in (
                "ms_per_step", "step_ms", "collective_ms_per_step",
                "collective_bytes_per_step", "collective_calls_per_step",
                "peak_mem_gb", "launches")} for pr in per_rank],
            "losses": per_rank[0]["losses"],
            "losses_single_process": ref["ref_losses"],
            "losses_alt_formulation": ref["alt_losses"],
            "loss_err_of_bound": loss_rel,
            "ranks_bit_equal_each_step":
                per_rank[0]["ranks_bit_equal_each_step"],
            "leaves": len(params), "zero_gradient_leaves": len(noise),
            "change_err_worst": [errs[worst_key], worst_key],
            "change_err_worst_of_bound": errs[worst_key] / bound,
            "change_err_median": float(np.median(list(errs.values()))),
            "spread_median": float(np.median(list(spread.values()))),
            "spread_max": max(spread.values()),
            "step_bound": bound, "planted_half_batch": half_err,
            "stats_worst_of_max": stats_worst,
            "stats_spread_of_max": stats_spread,
            "launches_single_process": ref["launches"]}
        if not all(per_rank[0]["ranks_bit_equal_each_step"]):
            failures.append(f"{name}: the ranks' parameters differ after a "
                            "step")
        if any(not k.endswith(("body.0.bias", "body.2.conv.bias"))
               for k in noise):
            failures.append(f"{name}: the zero-gradient rule left out other "
                            f"leaves than the biases that feed a BatchNorm: "
                            f"{noise}")
        if errs[worst_key] > bound:
            failures.append(f"{name}: {worst_key} moved {errs[worst_key]} "
                            f"of its change off the single process, the "
                            f"bound {bound}")
        if half_err <= bound:
            failures.append(f"{name}: the gate passes one rank's half batch "
                            f"alone ({half_err} <= {bound})")
        if stats_worst[0] > BF16_SPREAD_FACTOR * stats_spread[0]:
            failures.append(f"{name}: moving statistics {stats_worst} of "
                            f"max off, the spread {stats_spread}")
        if loss_rel > 1.0:
            failures.append(f"{name}: losses {loss_rel} of their bound "
                            "off the single process")
        for pr in per_rank:
            if pr["launches"] != ref["launches"] or not pr["launches_ok"]:
                failures.append(f"{name}: a rank launched {pr['launches']}, "
                                f"one process {ref['launches']}")
    return rows, launches, failures


def phase_dist_two_ranks(seed):
    """Two ranks on the one card over gloo (_dist_run_ranks), then here
    the single process on the global batch: phases ``dist_two_ranks``
    and ``dist_trainer``."""
    ranks, finals, ranks_s = _dist_run_ranks(seed)
    rows, launches, failures = _dist_rows(seed, ranks, finals)
    per_rank = ranks[0]["dist_two_ranks"][0]
    emit({"phase": "dist_two_ranks", "backend": ranks[0]["backend"],
          "device": ranks[0]["device"], "ranks_s": ranks_s,
          "rank_setup_s": [rk["setup_s"] for rk in ranks],
          "rank_total_s": [rk["total_s"] for rk in ranks],
          "local_batch": per_rank["local_batch"],
          "global_batch": per_rank["global_batch"],
          "steps": per_rank["steps"], "dtype": "bfloat16",
          "step_factor": DIST_STEP_FACTOR,
          "spread_factor": BF16_SPREAD_FACTOR,
          "loss_rtol": BF16_LOSS_RTOL, "configs": rows})
    trainer = [rk["dist_trainer"] for rk in ranks]
    emit({"phase": "dist_trainer", "trainer": [t["trainer"] for t in trainer],
          "module": [t["module"] for t in trainer],
          "checkpoint": [t["checkpoint"] for t in trainer]})
    for t in trainer:
        tr, mod, ck = t["trainer"], t["module"], t["checkpoint"]
        if not tr["wire_ok"] or not tr["ranks_bit_equal"]:
            failures.append(f"dist_trainer: 2-bit Trainer wire "
                            f"{tr['wire_bytes_pushed']} vs fp32 "
                            f"{tr['fp32_bytes']} / 16 + "
                            f"{tr['padding_bytes']}, ranks equal "
                            f"{tr['ranks_bit_equal']}")
        if not all(math.isfinite(v) for v in tr["losses"]):
            failures.append(f"dist_trainer: losses {tr['losses']}")
        if mod["store"] != "KVStoreDist" or not mod["finite"] or \
                not mod["ranks_bit_equal"]:
            failures.append(f"dist_trainer: Module.fit {mod}")
        if not ck["bit_equal"]:
            failures.append(f"dist_trainer: checkpoint resume {ck}")
    if failures:
        fail("; ".join(failures))
    return launches


# ------------------------------------------------ model parallelism
# the decoder-only LM of examples/transformer_lm.py at GPT-2-small width
# (the generation server's), with the parallel layers composed in as
# __graft_entry__.py composes them; trained with Adam at lr 0.003 on the
# Markov batches of examples/transformer_lm.py
MP = dict(vocab=50257, dim=768, heads=12, seq_len=1024)
MP_EXPERTS, MP_LR = 4, 0.003
LM_TRAIN_DEPTH, LM_TRAIN_BATCH, LM_TRAIN_STEPS = 12, 4, 3
LM_CPU_DEPTH, LM_CPU_BATCH = 2, 1
# card vs CPU at depth 2, one forward and backward: the loss relative
# (LM_CPU_RTOL), each gradient's L2 error relative to its L2 norm
# (LM_CPU_GRAD_RTOL).  At initialisation the softmax over 50257 words is
# near uniform and the gradients cancel: fp32 routes lie up to ~1e-3
# (L2, the median leaf) off the card's fp64 gradient, seed by seed, and
# card vs CPU worst leaf read 9.3e-4 and 1.1e-3 for seeds 0 and 1 on an
# NVIDIA H100 80GB HBM3 at 700 W (tools/port_mp_margin.py's companion
# run); so the gate sits at 1e-2, where a wrong backward (O(1)) fails.
# The card's fp64 gradient is printed beside as the truth
LM_CPU_RTOL = 1e-4
LM_CPU_GRAD_RTOL = 1e-2
MP_DEPTH, MP_BATCH, MP_STEPS, MP_MICROBATCHES = 2, 4, 3, 4
MP_TIMEOUT_S = 600
FLASH_GRAD = (2, 12, 1024, 64)      # b, heads, T, head_dim; causal
# the worlds of the model-parallel phases: ranks, mesh axes, and the
# runs each makes (name, model kind, attention); one world per axis
MP_WORLDS = {"tp": (2, dict(tp=2), [("tp", "mlp", "flash")]),
             "sp": (2, dict(sp=2), [("sp_ulysses", "mlp", "ulysses"),
                                    ("sp_ring", "mlp", "ring")]),
             "ep": (2, dict(ep=2), [("ep", "moe", "flash")]),
             "pp": (2, dict(pp=2), [("pp", "pp", "flash")]),
             "tp_pp": (4, dict(tp=2, pp=2), [("tp_pp", "pp", "flash")])}
# flash launches a rank a step: one a block for the plain LMs, one a
# tick (M + S - 1) for the pipelined one; ring attention runs no kernel
MP_FLASH_PER_STEP = {"flash": MP_DEPTH, "ulysses": MP_DEPTH, "ring": 0,
                     "pipeline": MP_MICROBATCHES + 2 - 1}
# the gates of a mesh run against the one process on the card after
# MP_STEPS Adam steps.  Adam's first steps move each weight by about
# lr * sign(g), so a gradient element near 0 that another summation
# order rounds to the other sign moves by 2 lr, and Adam is blind to a
# gradient's scale.  So two gates: each leaf's change error
# (_change_errs) at most MP_STEP_BOUND, and each leaf's first moment
# (Adam's m, a running sum of the gradients, linear in them: a gradient
# counted twice shows as 1.0) within MP_MOMENT_BOUND in L2, relative;
# each step's loss within MP_LOSS_RTOL.  Over seeds 0-3
# (tools/port_mp_margin.py, NVIDIA H100 80GB HBM3 at 700 W) the worst
# readings of the 24 runs were 1.87e-2 (a pipelined LayerNorm beta),
# 4.6e-3 (ring attention's qkv) and 1.15e-5; Ulysses read 0 (the same
# arithmetic as one process), ep at most 1.3e-3
MP_STEP_BOUND = 0.05
MP_MOMENT_BOUND = 0.02
MP_LOSS_RTOL = 5e-5


def mp_lm_classes(mx):
    """The LM's blocks over the port (tests/torch_mp_models.py holds
    them for both packages)."""
    from incubator_mxnet_tpu_torch.ndarray.ndarray import NDArray
    gluon, nn, par = mx.gluon, mx.gluon.nn, mx.parallel

    class CausalSelfAttention(gluon.Block):
        def __init__(self, dim, heads, attend, **kwargs):
            super().__init__(**kwargs)
            self._dim, self._heads, self._attend = dim, heads, attend
            with self.name_scope():
                self.qkv = par.ColumnParallelDense(
                    3 * dim, in_units=dim, flatten=False, use_bias=False)
                self.proj = par.RowParallelDense(dim, in_units=dim,
                                                 flatten=False)

        def forward(self, x):
            b, t, _ = x.shape
            dim, h = self._dim, self._heads
            a = self.qkv(x)._data

            def split(z):
                return z.reshape(b, t, h, dim // h).swapaxes(1, 2) \
                    .contiguous()

            o = self._attend(split(a[..., :dim]), split(a[..., dim:2 * dim]),
                             split(a[..., 2 * dim:]))
            o = o.swapaxes(1, 2).reshape(b, t, dim)
            return self.proj(NDArray(o, x.context))

    class TransformerBlock(gluon.Block):
        def __init__(self, dim, heads, attend, experts=0, **kwargs):
            super().__init__(**kwargs)
            self._moe = bool(experts)
            with self.name_scope():
                self.ln1 = nn.LayerNorm(in_channels=dim)
                self.attn = CausalSelfAttention(dim, heads, attend)
                self.ln2 = nn.LayerNorm(in_channels=dim)
                if experts:
                    self.mlp = par.MoELayer(dim, 4 * dim,
                                            num_experts=experts, top_k=2,
                                            capacity_factor=2.0)
                else:
                    self.mlp = nn.HybridSequential()
                    with self.mlp.name_scope():
                        self.mlp.add(par.ColumnParallelDense(
                            4 * dim, in_units=dim, flatten=False,
                            activation="relu"),
                            par.RowParallelDense(dim, in_units=4 * dim,
                                                 flatten=False))

        def forward(self, x):
            x = x + self.attn(self.ln1(x))
            h = self.ln2(x)
            if self._moe:
                b, t, dim = h.shape
                return x + self.mlp(h.reshape((-1, dim))).reshape(
                    (b, t, dim))
            return x + self.mlp(h)

    class TransformerLM(gluon.Block):
        """``depth`` blocks, or with ``stages`` a ``PipelineStack`` of one
        block (its embedding and head split over ``pp``)."""

        def __init__(self, vocab, dim, heads, seq_len, depth, attend,
                     experts=0, stages=0, **kwargs):
            super().__init__(**kwargs)
            axis = "pp" if stages else "tp"
            with self.name_scope():
                self.embed = par.ShardedEmbedding(vocab, dim, axis=axis)
                self.pos = self.params.get(
                    "pos", shape=(1, seq_len, dim), init=mx.init.Normal(0.02))
                if stages:
                    self.blocks = par.PipelineStack(
                        TransformerBlock(dim, heads, attend,
                                         prefix="stage_"),
                        num_stages=stages, num_microbatches=MP_MICROBATCHES)
                else:
                    self.blocks = nn.Sequential()
                    with self.blocks.name_scope():
                        for _ in range(depth):
                            self.blocks.add(TransformerBlock(
                                dim, heads, attend, experts))
                self.ln_f = nn.LayerNorm(in_channels=dim)
                self.head = par.ColumnParallelDense(
                    vocab, in_units=dim, flatten=False, axis=axis)

        def forward(self, tokens):
            x = self.embed(tokens) + self.pos.data()
            return self.head(self.ln_f(self.blocks(x)))

    class FlatLoss:
        def __init__(self, vocab):
            self._vocab = vocab
            self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def __call__(self, out, y):
            return self._ce(out.reshape((-1, self._vocab)), y.reshape((-1,)))

    return TransformerLM, FlatLoss


def mp_attend(kind, mesh=None):
    """attend(q, k, v) of an LM: flash (B5) on the full sequence; Ulysses
    (B5 on heads/sp heads); ring attention over ``sp``."""
    from incubator_mxnet_tpu_torch import parallel
    if kind == "flash":
        return lambda q, k, v: parallel.flash_attention(q, k, v, causal=True)
    if kind == "ulysses":
        return lambda q, k, v: parallel.ulysses_attention_sharded(
            q, k, v, mesh, causal=True, attn_fn=parallel.flash_attention)
    return lambda q, k, v: parallel.ring_attention_sharded(q, k, v, mesh,
                                                           causal=True)


def mp_build(mx, seed, kind, attend, device="cuda:0", depth=MP_DEPTH,
             values=None):
    """The LM of ``kind`` ("mlp", "moe" or "pp"), its weights made from
    ``seed`` (Xavier by name; the pipeline's stacked stages each moved
    by their own draw, so no two stages are alike), or ``values`` (by
    name)."""
    from incubator_mxnet_tpu_torch.convert import gluon_params_from_numpy
    lm, _ = mp_lm_classes(mx)
    ctx = mx.gpu(0) if device != "cpu" else mx.cpu()
    mx.random.seed(seed)
    with ctx:
        net = lm(**MP, depth=depth, attend=attend,
                 experts=MP_EXPERTS if kind == "moe" else 0,
                 stages=2 if kind == "pp" else 0, prefix="lm_")
        if values is not None:
            return gluon_params_from_numpy(net, values, ctx=ctx)
        net.initialize(init=mx.init.Xavier(), ctx=ctx)
    gen = torch.Generator().manual_seed(seed + 77)
    for name, p in net.collect_params().items():
        if "pipelinestack" in name:
            t = p.data()._data
            p.set_data(mx.nd.NDArray(t + 0.02 * torch.randn(
                t.shape, generator=gen).to(t.device), ctx))
    return net


def mp_batch(seed, n=MP_BATCH):
    rs = np.random.RandomState(seed + 101)
    vocab, t = MP["vocab"], MP["seq_len"]
    toks = np.zeros((n, t + 1), np.int64)
    toks[:, 0] = rs.randint(vocab, size=n)
    for i in range(1, t + 1):
        nxt = (toks[:, i - 1] * 3 + 1) % vocab
        toks[:, i] = np.where(rs.rand(n) < 0.9, nxt,
                              rs.randint(vocab, size=n))
    return toks[:, :-1].astype("float32"), toks[:, 1:].astype("float32")


def _mp_step(mx, net, mesh=None):
    _, flat = mp_lm_classes(mx)
    from incubator_mxnet_tpu_torch.parallel import TrainStep
    return TrainStep(net, flat(MP["vocab"]),
                     mx.optimizer.Adam(learning_rate=MP_LR), mesh=mesh)


def phase_flash_grad(seed):
    """B5 through ``flash_attention``'s autograd Function (C17): the
    output and dq/dk/dv on the card against the plain fp32 route's,
    and the forward's and backward's times."""
    from incubator_mxnet_tpu_torch.parallel.flash_attention import (
        _flash_plain, flash_attention)
    b, h, t, d = FLASH_GRAD
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda")
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    _zero_counts()
    out = flash_attention(*leaves, causal=True)
    node = type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, leaves, do)
    launches = _counts().get("flash_attention_fwd", 0)
    plain_leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    ref = _flash_plain(*plain_leaves, True, scale)
    ref_grads = torch.autograd.grad(ref, plain_leaves, do)
    errs = {"out": ((out - ref).abs().max() / ref.abs().max()).item()}
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        errs[name] = ((g - r).abs().max() / r.abs().max()).item()

    def fwd_bwd(fn):
        xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
        return lambda: torch.autograd.grad(fn(*xs), xs, do)

    fwd_ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    total_ms = time_ms(fwd_bwd(lambda *a: flash_attention(*a, causal=True)))
    plain_fwd_ms = time_ms(lambda: _flash_plain(q, k, v, True, scale))
    plain_total_ms = time_ms(fwd_bwd(
        lambda *a: _flash_plain(*a, True, scale)))
    sdpa_total_ms = time_ms(fwd_bwd(
        lambda *a: torch.nn.functional.scaled_dot_product_attention(
            *a, is_causal=True)))
    emit({"phase": "flash_grad", "shape": FLASH_GRAD, "causal": True,
          "grad_fn": node, "launches": launches,
          "max_err_of_max": errs, "tolerance": KERNEL_ATOL,
          "fwd_ms": fwd_ms, "fwd_bwd_ms": total_ms,
          "bwd_ms": total_ms - fwd_ms, "plain_fwd_ms": plain_fwd_ms,
          "plain_fwd_bwd_ms": plain_total_ms,
          "plain_bwd_ms": plain_total_ms - plain_fwd_ms,
          "sdpa_fwd_bwd_ms": sdpa_total_ms})
    if node != "_FlashBackward" or any(g is None for g in grads):
        fail(f"flash_grad: the kernel's output has no gradient ({node})")
    if launches != 1:
        fail(f"flash_grad: {launches} kernel launches for one forward")
    bad = {k: e for k, e in errs.items() if not e <= KERNEL_ATOL}
    if bad:
        fail(f"flash_grad: the Function disagrees with the plain route: "
             f"{bad}")
    return {"flash_attention_fwd": launches}


def _grads_of(mx, net, x, y):
    """(loss, {name: grad}) of one forward and backward of the LM."""
    _, flat = mp_lm_classes(mx)
    ctx = next(iter(net.collect_params().values())).data().context
    with mx.autograd.record():
        loss = flat(MP["vocab"])(net(mx.nd.array(x, ctx=ctx)),
                                 mx.nd.array(y, ctx=ctx)).mean()
    loss.backward()
    return float(loss.asscalar()), {
        n: p.grad()._data.detach().cpu()
        for n, p in net.collect_params().items()}


def phase_lm_train(seed):
    """The LM in one process with no mesh at full width and depth 12:
    LM_TRAIN_STEPS Adam steps at b=4 through ``TrainStep``, the flash
    kernel launched once a block a forward; then at depth 2 one forward
    and backward at b=1 on the card against the CPU route (loss and
    every gradient)."""
    import incubator_mxnet_tpu_torch as mx
    x, y = mp_batch(seed, LM_TRAIN_BATCH)
    net = mp_build(mx, seed, "mlp", mp_attend("flash"),
                   depth=LM_TRAIN_DEPTH)
    step = _mp_step(mx, net)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms = [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, y).asscalar()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del net, step
    torch.cuda.empty_cache()
    from incubator_mxnet_tpu_torch.convert import gluon_params_to_numpy
    xs, ys = x[:LM_CPU_BATCH], y[:LM_CPU_BATCH]
    card_net = mp_build(mx, seed, "mlp", mp_attend("flash"),
                        depth=LM_CPU_DEPTH)
    values = gluon_params_to_numpy(card_net)
    card = _grads_of(mx, card_net, xs, ys)
    cpu = _grads_of(mx, mp_build(mx, seed, "mlp", mp_attend("flash"),
                                 device="cpu", depth=LM_CPU_DEPTH,
                                 values=values), xs, ys)
    del card_net
    # the truth: the card in fp64 (plain attention: B5 takes fp32)
    f64 = mp_build(mx, seed, "mlp", lambda q, k, v: mx.parallel.attention(
        q, k, v, causal=True), depth=LM_CPU_DEPTH, values=values)
    f64.cast("float64")
    truth = _grads_of(mx, f64, xs.astype(np.float64), ys.astype(np.float64))
    del f64
    torch.cuda.empty_cache()
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])

    def l2_errs(got, ref):
        return {n: ((g.double() - ref[n].double()).norm() /
                    ref[n].double().norm()).item()
                for n, g in got.items() if ref[n].norm() > 0}

    grad_errs = l2_errs(card[1], cpu[1])
    worst = max(grad_errs, key=grad_errs.get)
    of_truth = {k: float(np.median(list(l2_errs(g[1], truth[1]).values())))
                for k, g in (("card", card), ("cpu", cpu))}
    want = LM_TRAIN_DEPTH * LM_TRAIN_STEPS
    emit({"phase": "lm_train", "widths": MP, "depth": LM_TRAIN_DEPTH,
          "batch": LM_TRAIN_BATCH, "steps": LM_TRAIN_STEPS,
          "optimizer": f"adam lr {MP_LR}", "losses": losses,
          "step_ms": step_ms, "ms_per_step": float(np.median(step_ms[1:])),
          "peak_mem_gb": peak, "launches": launches,
          "cpu_check": {"depth": LM_CPU_DEPTH, "batch": LM_CPU_BATCH,
                        "loss_card": card[0], "loss_cpu": cpu[0],
                        "loss_rel_err": loss_err,
                        "grad_worst_l2_rel": [grad_errs[worst], worst],
                        "grad_median_l2_rel": float(np.median(
                            list(grad_errs.values()))),
                        "median_l2_rel_of_fp64": of_truth,
                        "loss_fp64": truth[0],
                        "loss_tolerance": LM_CPU_RTOL,
                        "grad_tolerance": LM_CPU_GRAD_RTOL}})
    _finite(losses, "lm_train")
    if launches.get("flash_attention_fwd", 0) != want:
        fail(f"lm_train: flash launched {launches}, want {want}")
    if not losses[-1] < losses[0]:
        fail(f"lm_train: the loss did not fall: {losses}")
    if loss_err > LM_CPU_RTOL or grad_errs[worst] > LM_CPU_GRAD_RTOL:
        fail(f"lm_train: card vs CPU loss {loss_err}, gradient "
             f"{grad_errs[worst]} at {worst}")
    return launches


def mp_moments(net, step):
    """Adam's first moment of each trained parameter, global (gathered
    over the axes that cut it), by name."""
    params = {id(p._data._data): p for p in net.collect_params().values()}
    out = {}
    for t, state in zip(step._params, step._states):
        p = params[id(t)]
        m = state[0] if p._cut is None else p._cut.gather(state[0], p.shape)
        out[p.name] = m.detach().cpu()
    return out


def _mp_reference(seed, kind):
    """The one process on the card on the global batch, under cuDNN's
    deterministic algorithms: (init, final params, losses, Adam's first
    moments)."""
    import incubator_mxnet_tpu_torch as mx
    x, y = mp_batch(seed)
    with _cudnn_deterministic():
        net = mp_build(mx, seed, kind, mp_attend("flash"))
        init = {n: p.data()._data.detach().cpu().clone()
                for n, p in net.collect_params().items()}
        step = _mp_step(mx, net)
        losses = [float(step(x, y).asscalar()) for _ in range(MP_STEPS)]
        final = {n: p.data()._data.detach().cpu()
                 for n, p in net.collect_params().items()}
        moments = mp_moments(net, step)
    del net, step
    torch.cuda.empty_cache()
    return init, final, losses, moments


def _mp_predict_reference(final, kind, x):
    """One process's ``BlockPredictor`` logits of the final weights."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.predict import BlockPredictor
    net = mp_build(mx, 0, kind, mp_attend("flash"))
    for n, p in net.collect_params().items():
        p.set_data(mx.nd.NDArray(final[n].cuda(), mx.gpu(0)))
    out = BlockPredictor(net, bf16_compute=False)(x).cpu()
    del net
    torch.cuda.empty_cache()
    return out


def _mp_world(seed, world):
    """tools/port_mp_worker.py under tools/launch.py (the ranks share the
    one card over gloo): each rank's JSON and rank 0's final global
    parameters of each run."""
    import os
    import tempfile
    ranks = MP_WORLDS[world][0]
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
             str(ranks), "--", sys.executable,
             os.path.join(root, "tools", "port_mp_worker.py"), "--out", out,
             "--seed", str(seed), "--world", world],
            cwd=root, capture_output=True, text=True, timeout=MP_TIMEOUT_S)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"mp world {world}: a rank failed (rc {proc.returncode}):"
                 f"\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        per_rank = []
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                per_rank.append(json.load(f))
        finals = {run: torch.load(os.path.join(out, f"{run}.pt"))
                  for run, _, _ in MP_WORLDS[world][2]}
        logits = None
        if os.path.exists(os.path.join(out, "logits.pt")):
            logits = torch.load(os.path.join(out, "logits.pt"))
    return per_rank, finals, logits, secs


def _mp_check(run, attend, per_rank, final, ref, failures):
    """One run of a world against the one process: its row."""
    init, ref_final, ref_losses, ref_moments = ref
    final, moments = final["params"], final["moments"]
    rows = [pr["runs"][run] for pr in per_rank]
    moved = [k for k in ref_final if (ref_final[k] - init[k]).abs().max() > 0]
    errs = _change_errs(final, ref_final, init, moved)
    worst = max(errs, key=errs.get)
    m_errs = {k: ((moments[k].double() - m.double()).norm() /
                  m.double().norm()).item()
              for k, m in ref_moments.items() if m.norm() > 0}
    m_worst = max(m_errs, key=m_errs.get)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(rows[0]["losses"], ref_losses))
    per_step = MP_FLASH_PER_STEP[
        "pipeline" if run in ("pp", "tp_pp") else attend]
    want = per_step * MP_STEPS
    replicated = rows[0]["replicated_sha"]
    equal = all(r["replicated_sha"] == replicated for r in rows)
    blocks = all(have == want for r in rows
                 for have, _, want in r["sharded_bytes"].values())
    row = {"ranks": len(rows), "losses": rows[0]["losses"],
           "losses_single_process": ref_losses, "loss_rel_err": loss_rel,
           "loss_err_of_bound": loss_rel / MP_LOSS_RTOL,
           "change_err_worst": [errs[worst], worst],
           "change_err_worst_of_bound": errs[worst] / MP_STEP_BOUND,
           "change_err_median": float(np.median(list(errs.values()))),
           "moment_err_worst": [m_errs[m_worst], m_worst],
           "moment_err_worst_of_bound": m_errs[m_worst] / MP_MOMENT_BOUND,
           "moment_err_median": float(np.median(list(m_errs.values()))),
           "leaves": len(errs), "replicated_leaves": len(replicated),
           "sharded_leaves": len(rows[0]["sharded_bytes"]),
           "ranks_bit_equal_replicated": equal,
           "sharded_bytes_are_blocks": blocks,
           "sharded_bytes_rank0": rows[0]["sharded_bytes"],
           "per_rank": [{k: r[k] for k in (
               "ms_per_step", "step_ms", "collective_ms_per_step",
               "collective_bytes_per_step", "collective_calls_per_step",
               "peak_mem_gb", "launches", "routes")} for r in rows],
           "flash_launches_expected": want}
    if errs[worst] > MP_STEP_BOUND:
        failures.append(f"{run}: {worst} moved {errs[worst]} of its change "
                        f"off the single process (bound {MP_STEP_BOUND})")
    if m_errs[m_worst] > MP_MOMENT_BOUND:
        failures.append(f"{run}: {m_worst}'s Adam moment {m_errs[m_worst]} "
                        f"off the single process's (bound "
                        f"{MP_MOMENT_BOUND})")
    if loss_rel > MP_LOSS_RTOL:
        failures.append(f"{run}: losses {rows[0]['losses']} vs "
                        f"{ref_losses}")
    if not equal:
        failures.append(f"{run}: the ranks differ on a replicated parameter")
    if not blocks or (not rows[0]["sharded_bytes"] and
                      run not in ("sp_ulysses", "sp_ring")):
        failures.append(f"{run}: sharded bytes {rows[0]['sharded_bytes']}")
    for r in rows:
        if r["launches"].get("flash_attention_fwd", 0) != want:
            failures.append(f"{run}: a rank launched {r['launches']}, "
                            f"want {want} flash")
    return row


def _mp_rows(seed, worlds):
    """Each world of ``worlds`` (MP_WORLDS) launched and held to the one
    process on the card on the same global batch and weights:
    (rows by world, launches by run, failures)."""
    refs = {}
    out, launches, failures = {}, {}, []
    x, _ = mp_batch(seed)
    for world in worlds:
        per_rank, finals, logits, secs = _mp_world(seed, world)
        rows = {}
        for run, kind, attend in MP_WORLDS[world][2]:
            if kind not in refs:
                refs[kind] = _mp_reference(seed, kind)
            rows[run] = _mp_check(run, attend, per_rank, finals[run],
                                  refs[kind], failures)
            launches[run] = per_rank[0]["runs"][run]["launches"]
        if logits is not None:
            want = _mp_predict_reference(finals["tp"]["params"], "mlp",
                                         x[:1])
            err = ((logits - want).abs().max() / want.abs().max()).item()
            rows["tp"]["predictor_logits_err_of_max"] = err
            if err > LM_CPU_RTOL:
                failures.append(f"BlockPredictor(mesh=) logits {err} of "
                                "max off one process's")
        out[world] = {"ranks": MP_WORLDS[world][0],
                      "mesh": MP_WORLDS[world][1], "world_s": secs,
                      "rank_setup_s": [pr["setup_s"] for pr in per_rank],
                      "runs": rows}
    del refs
    torch.cuda.empty_cache()
    return out, launches, failures


def phase_mp(seed, worlds, phase):
    """The model-parallel worlds ``worlds`` (``_mp_rows``): one JSON
    line, and a failed gate fails the run."""
    out, launches, failures = _mp_rows(seed, worlds)
    emit({"phase": phase, "widths": MP, "depth": MP_DEPTH,
          "global_batch": MP_BATCH, "steps": MP_STEPS,
          "microbatches": MP_MICROBATCHES, "optimizer": f"adam lr {MP_LR}",
          "step_bound": MP_STEP_BOUND, "moment_bound": MP_MOMENT_BOUND,
          "loss_rtol": MP_LOSS_RTOL,
          "backend": "gloo", "worlds": out})
    if failures:
        fail(f"{phase}: " + "; ".join(failures))
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # the port must be importable before anything is printed: alone in a
    # directory this script fails here, with no result
    import incubator_mxnet_tpu_torch  # noqa: F401
    smi = phase_device()
    # fp32 means fp32: no TF32 in cuBLAS or cuDNN on either side
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(["flash_attention", "sbr_matmul", "sbr_conv3x3",
                 "chain_stats", "chain_emit"])
    kernels = [phase_kernels()]
    conv = phase_kernels_conv()
    chain = phase_kernels_chain()
    axpy_row, axpy = phase_kernels_rtc(args.seed)
    launches, net, greedy, sampled = phase_generation(args.seed)
    if launches != GPT2_SMALL["depth"] * sum(prefill_buckets().values()):
        fail(f"flash launched {launches} times, but its per-run total "
             f"weighs the buckets {prefill_buckets()}")
    kernels[0]["launches"] = launches
    phase_profile(net, greedy, sampled)
    phase_generation_stages(net, args.seed)
    phase_telemetry_cost(args.seed, axpy, net)
    del net
    torch.cuda.empty_cache()
    conv_launches, rnet, server, images = phase_resnet_serving(args.seed)
    try:
        phase_resnet_reference(rnet, images, args.seed)
        phase_resnet_profile(server, images)
    finally:
        server.close()
    for name in ("sbr_matmul", "sbr_conv3x3"):
        conv[name]["launches"] = conv_launches[name]
    del rnet, server
    torch.cuda.empty_cache()
    train_launches, tnet, step, xd, yd = phase_resnet_train(args.seed)
    phase_resnet_train_profile(step, xd, yd)
    phase_resnet_train_eval(tnet, args.seed)
    del step, xd, yd
    torch.cuda.empty_cache()
    phase_resnet_train_reference(args.seed)
    torch.cuda.empty_cache()
    fused_train_ms = phase_fused_train(args.seed)
    torch.cuda.empty_cache()
    bnet, step, xd, yd = phase_resnet_train_bench(args.seed)
    phase_resnet_train_profile(step, xd, yd, "resnet_train_bench_profile",
                               by_source=True)
    cnet, cstep, bench_chain_launches = phase_resnet_train_bench_chain(
        args.seed, step, xd, yd)
    phase_resnet_train_profile(cstep, xd, yd,
                               "resnet_train_bench_chain_profile",
                               by_source=True)
    del step, cstep, xd, yd
    torch.cuda.empty_cache()
    phase_bf16_reference(args.seed + 5, "resnet_train_bench_reference",
                         BENCH_NET, dict(fuse_bn_relu=False))
    phase_bf16_reference(args.seed + 12,
                         "resnet_train_bench_chain_reference",
                         BENCH_CHAIN_NET, dict(fuse_block=False))
    bf16_conv_launches = phase_resnet_train_bf16_modes(args.seed)
    phase_resnet_train_chain34(args.seed)
    phase_resnet_train_1x1(args.seed)
    phase_train_step_options(args.seed)
    phase_eval_step(tnet, bnet, cnet, args.seed)
    del tnet, bnet, cnet
    bf16 = FORMS[torch.bfloat16]
    for name in ("sbr_matmul", "sbr_conv3x3"):
        conv[name + bf16]["launches"] = bf16_conv_launches[name + bf16]
    for name in ("chain_stats", "chain_emit"):
        chain[name]["launches"] = train_launches[name]
        chain[name + bf16]["launches"] = bench_chain_launches[name + bf16]
    kernels += list(conv.values()) + list(chain.values())
    torch.cuda.empty_cache()
    rtc_launches = phase_nd_imperative(args.seed, axpy)
    kernels.append({
        "name": "rtc_axpy", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/rtc.py",
        "kernel_source": "chip_smoke.py:AXPY_SRC",
        "replaces": "incubator_mxnet_tpu/rtc.py:36",
        "launches": rtc_launches, "max_abs_err": axpy_row["max_abs_err"],
        "ms": axpy_row["kernel_ms"], "plain_ms": axpy_row["plain_ms"],
        "bound_ms": axpy_row["bound_ms"],
        "bound_by": axpy_row["bound_by"],
        "library_ms": axpy_row["library_ms"],
        "per": f"one axpy over n = {axpy_row['n']} floats (resnet50_v1's "
               "parameter count); compiled by NVRTC at run time"})
    torch.cuda.empty_cache()
    phase_kernels_gluon(args.seed)
    gluon_paths = {"gluon_layers": phase_gluon_layers(args.seed)}
    torch.cuda.empty_cache()
    gluon_paths["gluon_train"] = phase_gluon_train(args.seed, fused_train_ms)
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmpdir:
        data_paths = {"data_train": phase_data_train(args.seed, tmpdir)}
        data_paths["resnet_v2_serving"] = phase_resnet_v2_serving(args.seed)
        sym_launches, prefix = phase_symbolic_train(args.seed, tmpdir)
        symbolic_paths = {"symbolic_train": sym_launches}
        symbolic_paths["symbolic_serving"] = phase_symbolic_serving(
            args.seed, prefix)
        symbolic_paths["symbolic_fused"] = phase_symbolic_fused(args.seed,
                                                                prefix)
        torch.cuda.empty_cache()
        _zero_counts()
        phase_rnn_op(args.seed)
        recurrent_paths = {"rnn_op": _counts()}
        recurrent_paths["rnn_lm_train"] = phase_rnn_lm_train(args.seed,
                                                             tmpdir)
        for name, counts in phase_rnn_bucketing(args.seed).items():
            recurrent_paths[f"rnn_bucketing_{name}"] = counts
    torch.cuda.empty_cache()
    detection_paths = {}
    for name, phase in (("zoo_models", phase_zoo_models),
                        ("ssd_train", phase_ssd_train),
                        ("contrib_ops", phase_contrib_ops)):
        _zero_counts()
        phase(args.seed)
        detection_paths[name] = _counts()
        torch.cuda.empty_cache()
    sparse_paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sparse_") as tmpdir:
        for name, phase in (
                ("sparse_mf", phase_sparse_mf),
                ("sparse_linear", lambda s: phase_sparse_linear(s, tmpdir)),
                ("wide_deep", phase_wide_deep),
                ("fast_rcnn", phase_fast_rcnn),
                ("spatial_ops", phase_spatial_ops),
                ("image_ops", phase_image_ops),
                ("indexing_random_ops", phase_indexing_random_ops)):
            _zero_counts()
            phase(args.seed)
            sparse_paths[name] = _counts()
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    phase_moe_zero_gate(args.seed)
    phase_group2ctx(args.seed)
    torch.cuda.empty_cache()
    dist_paths = {"dist_world1": phase_dist_world1(args.seed)}
    for name, counts in phase_dist_two_ranks(args.seed).items():
        dist_paths[f"dist_two_ranks_{name}"] = counts
    torch.cuda.empty_cache()
    mp_paths = {"flash_grad": phase_flash_grad(args.seed),
                "lm_train": phase_lm_train(args.seed)}
    torch.cuda.empty_cache()
    for phase, worlds in (("mp_two_ranks", ["tp", "sp", "ep", "pp"]),
                          ("mp_four_ranks", ["tp_pp"])):
        for run, counts in phase_mp(args.seed, worlds, phase).items():
            mp_paths[f"{phase}_{run}"] = counts
    paths = {"launches_gluon": gluon_paths, "launches_data": data_paths,
             "launches_symbolic": symbolic_paths,
             "launches_recurrent": recurrent_paths,
             "launches_detection": detection_paths,
             "launches_sparse_image": sparse_paths,
             "launches_dist": dist_paths,
             "launches_model_parallel": mp_paths}
    for row in kernels:
        for key, runs in paths.items():
            row[key] = {path: counts.get(row["name"], 0)
                        for path, counts in runs.items()}
    print(smi or "nvidia-smi: not available", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
