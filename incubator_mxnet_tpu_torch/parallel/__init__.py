"""Attention primitives and kernels of the port."""
from .flash_attention import flash_attention
from .paged_attention import (copy_blocks, gather_layer_blocks,
                              scatter_prompt_blocks, write_token_rows)
from .ring_attention import attention
from .step import TrainStep

__all__ = ["TrainStep", "attention", "flash_attention", "gather_layer_blocks",
           "scatter_prompt_blocks", "write_token_rows", "copy_blocks"]
