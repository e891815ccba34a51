"""Attention primitives and kernels, and the training and inference
steps, of the port."""
from .flash_attention import flash_attention
from .paged_attention import (copy_blocks, gather_layer_blocks,
                              scatter_prompt_blocks, write_token_rows)
from .ring_attention import attention
from .step import EvalStep, TrainStep, uint8_input_prep

__all__ = ["EvalStep", "TrainStep", "attention", "flash_attention",
           "uint8_input_prep",
           "gather_layer_blocks", "scatter_prompt_blocks", "write_token_rows",
           "copy_blocks"]
