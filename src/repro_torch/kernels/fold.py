"""The ``vmap`` folding rule of the kernels' ``autograd.Function``s: a
raw-pointer launch cannot see a batched tensor, so each ``vmap`` rule
merges the mapped dimension into the batch, launches once, and splits the
results again.  Also the zero tangents their ``jvp`` rules fill in."""
from __future__ import annotations

import torch

__all__ = ["fold", "unfold", "zeros_for_none"]


def fold(x: torch.Tensor, dim: int | None, n: int) -> torch.Tensor:
    """Move the vmapped dim (or a broadcast of an unmapped input) to the
    front and merge it into the batch dim: (n, B, ...) → (n·B, ...)."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:])


def unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n·B, ...) → (n, B, ...)."""
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def zeros_for_none(tangents, primals) -> list:
    """A ``jvp`` rule's input tangents with zeros for the inputs that have
    none (forward mode passes ``None`` for them)."""
    return [torch.zeros_like(p) if t is None else t
            for t, p in zip(tangents, primals)]
