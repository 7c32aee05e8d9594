"""The Dif-MAML outer-update kernels: ``dif_combine`` (paper eq. 6b) and
``fused_combine_update`` (clip, moments and combine in one pass)."""
from repro_torch.kernels.dif_combine.ops import (build, dif_combine,
                                                 fused_combine_update,
                                                 launch_counts,
                                                 reset_launch_counts)

__all__ = ["build", "dif_combine", "fused_combine_update", "launch_counts",
           "reset_launch_counts"]
