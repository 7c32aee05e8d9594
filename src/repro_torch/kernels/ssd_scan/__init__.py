"""The Mamba2 SSD chunked scan: a hand-written CUDA kernel for Hopper beside
its plain PyTorch version."""
from repro_torch.kernels.ssd_scan.ops import (MAX_CHUNK, MAX_HEAD_DIM,
                                              MAX_STATE, build, launch_counts,
                                              reset_launch_counts, ssd_scan,
                                              ssd_scan_kernel)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "build",
           "launch_counts", "reset_launch_counts", "ssd_scan",
           "ssd_scan_kernel", "ssd_scan_ref"]
