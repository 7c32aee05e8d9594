"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper beside their plain PyTorch versions."""
from repro_torch.kernels.flash_attention.ops import (
    MAX_HEAD_DIM, build, flash_attention, flash_attention_bwd,
    flash_attention_fwd_lse, gqa_flash_attention, gqa_flash_attention_bwd,
    gqa_flash_attention_fwd_lse, launch_counts, reset_launch_counts)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["MAX_HEAD_DIM", "attention_ref", "build", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd_lse",
           "gqa_flash_attention", "gqa_flash_attention_bwd",
           "gqa_flash_attention_fwd_lse", "launch_counts",
           "reset_launch_counts"]
