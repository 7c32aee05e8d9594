"""The Dif-MAML outer-update kernels: ``dif_combine`` (paper eq. 6b) and
``fused_combine_update`` (clip, moments and combine in one pass), each over
one (K, M) buffer or over a dict of (K, ...) leaves in one launch."""
from repro_torch.kernels.dif_combine.ops import (build, dif_combine,
                                                 dif_combine_leaves,
                                                 fused_combine_update,
                                                 fused_combine_update_leaves,
                                                 launch_counts,
                                                 reset_launch_counts)

__all__ = ["build", "dif_combine", "dif_combine_leaves",
           "fused_combine_update", "fused_combine_update_leaves",
           "launch_counts", "reset_launch_counts"]
