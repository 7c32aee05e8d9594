"""Checkpoints in the JAX package's ``.npz`` format."""
from repro_torch.checkpoint.io import (latest_step, restore_centroid,
                                       restore_checkpoint, save_checkpoint)

__all__ = ["latest_step", "restore_centroid", "restore_checkpoint",
           "save_checkpoint"]
