"""Attention primitives and kernels, the training and inference steps,
and the data-parallel half of the parallel stack (mesh, kvstore
``"tpu"``, the dist backend, gradient compression, checkpoints) of the
port."""
from . import compression, dist
from .checkpoint import TrainCheckpoint
from .flash_attention import flash_attention
from .kvstore_tpu import KVStoreTPU
from .mesh import (DP, EP, PP, SP, TP, DeviceMesh, Sharding, current_mesh,
                   make_mesh, replicated, shard_spec)
from .paged_attention import (copy_blocks, gather_layer_blocks,
                              scatter_prompt_blocks, write_token_rows)
from .ring_attention import attention
from .step import EvalStep, TrainStep, uint8_input_prep

__all__ = ["DP", "DeviceMesh", "EP", "EvalStep", "KVStoreTPU", "PP", "SP",
           "Sharding", "TP", "TrainCheckpoint", "TrainStep", "attention",
           "compression", "current_mesh", "dist", "flash_attention",
           "make_mesh", "replicated", "shard_spec", "uint8_input_prep",
           "gather_layer_blocks", "scatter_prompt_blocks", "write_token_rows",
           "copy_blocks"]
