"""Attention primitives and kernels, the training and inference steps,
and the parallel stack of the port: the data-parallel half (mesh,
kvstore ``"tpu"``, the dist backend, gradient compression, checkpoints)
and the model-parallel half (tensor-parallel layers, MoE over ``ep``,
the GPipe ``PipelineStack`` over ``pp``, Ulysses and ring attention
over ``sp``)."""
from . import compression, dist
from .checkpoint import TrainCheckpoint
from .flash_attention import flash_attention
from .kvstore_tpu import KVStoreTPU
from .layers import ColumnParallelDense, RowParallelDense, ShardedEmbedding
from .mesh import (DP, EP, PP, SP, TP, DeviceMesh, Sharding, current_mesh,
                   make_mesh, replicated, shard_spec)
from .moe import MoELayer, moe_ffn, moe_ffn_alltoall, moe_ffn_sharded
from .paged_attention import (copy_blocks, gather_layer_blocks,
                              scatter_prompt_blocks, write_token_rows)
from .pipeline import (Pipeline, PipelineStack, PipelineStage,
                       pipeline_forward, pipeline_spmd)
from .ring_attention import (attention, make_ring_attention, ring_attention,
                             ring_attention_sharded)
from .step import EvalStep, TrainStep, uint8_input_prep
from .ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = ["DP", "DeviceMesh", "EP", "EvalStep", "KVStoreTPU", "PP", "SP",
           "Sharding", "TP", "TrainCheckpoint", "TrainStep", "attention",
           "compression", "current_mesh", "dist", "flash_attention",
           "make_mesh", "replicated", "shard_spec", "uint8_input_prep",
           "gather_layer_blocks", "scatter_prompt_blocks", "write_token_rows",
           "copy_blocks", "ColumnParallelDense", "RowParallelDense",
           "ShardedEmbedding", "MoELayer", "moe_ffn", "moe_ffn_sharded",
           "moe_ffn_alltoall", "Pipeline", "PipelineStage", "PipelineStack",
           "pipeline_spmd", "pipeline_forward", "ring_attention",
           "ring_attention_sharded", "make_ring_attention",
           "ulysses_attention", "ulysses_attention_sharded"]
