"""Low-rank storage of inner-loop adaptation deltas (port of
``repro/serve/lowrank.py``).

A resident serving user is an adapted launch model ``φ = w + δ``, where
``w`` is the shared launch model and ``δ`` the inner-loop delta.  The cache
stores only ``δ``: rank-r factors for a matrix leaf, the dense delta for the
rest.  Compression is *fidelity-gated*, with the reference's gate: a matrix
leaf is stored factored only when the factors are smaller than the dense
delta (``r·(rows+cols) < rows·cols``) and the rank-r truncation keeps the
relative Frobenius error within ``tol``; otherwise it stays dense.

Where the work runs: the delta, its SVD (``torch.linalg.svd`` in float32)
and the reconstruction run on the params' device; only the factors and the
dense deltas are kept, on the host, as float32 numpy arrays — the cache's
job is residency beyond device memory.  The reference runs the SVD with
numpy on the host; at full width its matrices are up to 43008 × 8960, which
is minutes per leaf there.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

__all__ = ["CompressedDelta", "DenseLeaf", "LowRankLeaf", "apply_delta",
           "compress_delta"]


@dataclasses.dataclass(frozen=True)
class LowRankLeaf:
    """``δ ≈ (u @ v).reshape(shape)``: rank-r factors of a matrix leaf
    (leading dims folded into rows, trailing dim = cols)."""
    u: np.ndarray                   # (rows, r) float32
    v: np.ndarray                   # (r, cols) float32
    shape: tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return self.u.nbytes + self.v.nbytes

    def materialize(self, device=None) -> torch.Tensor:
        u = torch.from_numpy(self.u).to(device)
        v = torch.from_numpy(self.v).to(device)
        return (u @ v).reshape(self.shape)


@dataclasses.dataclass(frozen=True)
class DenseLeaf:
    """Verbatim float32 delta — vectors, scalars, and matrix leaves whose
    rank-r truncation would exceed the fidelity tolerance."""
    x: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.x.nbytes

    def materialize(self, device=None) -> torch.Tensor:
        return torch.from_numpy(self.x).to(device)


@dataclasses.dataclass
class CompressedDelta:
    """One resident user's adaptation state: a flat dict of
    :class:`LowRankLeaf` / :class:`DenseLeaf` keyed as the params, with the
    seconds its compression took (``svd_seconds`` of them in the SVDs)."""
    leaves: dict
    dense_nbytes: int               # bytes of the uncompressed f32 delta
    seconds: float = 0.0
    svd_seconds: float = 0.0

    @property
    def nbytes(self) -> int:
        return sum(leaf.nbytes for leaf in self.leaves.values())

    @property
    def compression(self) -> float:
        """dense_bytes / stored_bytes (≥ 1; higher is better)."""
        return self.dense_nbytes / max(self.nbytes, 1)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).contiguous().numpy()


def _compress_leaf(d: torch.Tensor, rank: int, tol: float
                   ) -> tuple[LowRankLeaf | DenseLeaf, float]:
    """(stored leaf, seconds spent in the SVD)."""
    if d.ndim < 2:
        return DenseLeaf(_host(d)), 0.0
    rows, cols = math.prod(d.shape[:-1]), d.shape[-1]
    r = min(rank, rows, cols)
    # factored storage must actually save bytes
    if r * (rows + cols) >= rows * cols:
        return DenseLeaf(_host(d)), 0.0
    t0 = time.perf_counter()
    u, s, vt = torch.linalg.svd(d.reshape(rows, cols), full_matrices=False)
    total = float(torch.sum(s * s))
    kept = float(torch.sum(s[:r] * s[:r]))
    svd_s = time.perf_counter() - t0
    # relative Frobenius error of the truncation: sqrt(1 - kept/total)
    if total > 0.0 and 1.0 - kept / total > tol * tol:
        return DenseLeaf(_host(d)), svd_s
    return LowRankLeaf(_host(u[:, :r] * s[:r]), _host(vt[:r]),
                       tuple(d.shape)), svd_s


def compress_delta(base: dict[str, torch.Tensor],
                   adapted: dict[str, torch.Tensor], rank: int = 8,
                   tol: float = 0.3) -> CompressedDelta:
    """Compress ``adapted − base`` leaf by leaf, in float32 on the leaves'
    device.  ``rank`` bounds the factorization; ``tol`` is the per-leaf
    relative Frobenius error above which a leaf stays dense."""
    t0 = time.perf_counter()
    leaves, dense_nbytes, svd_s = {}, 0, 0.0
    for k, b in base.items():
        d = adapted[k].float() - b.float()
        dense_nbytes += d.numel() * 4
        leaves[k], s = _compress_leaf(d, rank, tol)
        svd_s += s
    return CompressedDelta(leaves, dense_nbytes,
                           seconds=time.perf_counter() - t0,
                           svd_seconds=svd_s)


def apply_delta(base: dict[str, torch.Tensor], comp: CompressedDelta
                ) -> dict[str, torch.Tensor]:
    """Reconstruct adapted params: ``base + δ`` in float32 on the base's
    device, cast back to each base leaf's dtype — the cache-hit path, one
    add per leaf and no gradient."""
    return {k: (b.float() + comp.leaves[k].materialize(b.device)).to(b.dtype)
            for k, b in base.items()}
