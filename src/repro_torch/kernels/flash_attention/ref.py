"""Plain PyTorch versions of the flash-attention kernels.

:func:`attention_ref` is the JAX package's ``kernels/flash_attention/ref.py``
oracle copied: float32 logits, masked softmax, output cast to q's dtype.
Its autograd gradient is the plain backward.

:func:`flash_fwd_ref` and :func:`flash_bwd_ref` compute what the CUDA
kernels compute, with the kernels' interface: the forward also returns the
per-row logsumexp, and the backward takes it (with ``out``) instead of
recomputing the softmax's normaliser — the FlashAttention-2 backward of the
JAX package's ``flash_bwd.py``.  The kernel wrappers use them for CPU
tensors, and ``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

__all__ = ["NEG_INF", "attention_ref", "band_mask", "flash_bwd_ref",
           "flash_fwd_ref"]


def band_mask(S: int, Sk: int, causal: bool, window: int | None,
              device=None) -> torch.Tensor:
    """(S, Sk) bool: query i may see key j iff (j <= i if causal) and
    (j > i - window if a window is given)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    """q/k/v: (B, H, S, d).  Full-materialization masked softmax."""
    d = q.shape[-1]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()
                          ) / math.sqrt(d)
    mask = band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)


def _logits(q, k, causal, window, scale):
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    mask = band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.where(mask, s, NEG_INF)


def flash_fwd_ref(q, k, v, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, S, d) in q's dtype, lse (B, H, S) float32)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = _logits(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.to(q.dtype), lse


def flash_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of (q, k, v):  P = exp(S − lse),
    dP = dO Vᵀ, dS = P ⊙ (dP − D) · scale with D = rowsum(dO ⊙ O),
    dQ = dS K, dK = dSᵀ Q, dV = Pᵀ dO."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    p = torch.exp(_logits(q, k, causal, window, scale) - lse[..., None])
    dof = do.float()
    dsum = (dof * out.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, v.float())
    ds = p * (dp - dsum) * scale
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k.float())
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float())
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
