"""Neural layers of the dense decoder and Mamba2 families: norms, RoPE, GQA
attention (full-sequence and single-token decode with the sliding-window
ring buffer), the MLP and the Mamba2 mixer (the chunked SSD scan,
full-sequence and single-token decode) — port of that subset of
``repro/models/layers.py``.

Everything is functional: ``*_specs(cfg)`` builds a Spec tree,
``*_apply(params, ...)`` runs it on a dict of tensors keyed as the specs.

:func:`sdpa` is where the hand-written flash-attention kernel goes: on a
CUDA tensor it calls the flash-attention ``Function`` (kernel forward and
backward); on a CPU tensor it runs the port's copy of the reference's
``_sdpa``/``_sdpa_chunked``, the same function the JAX package's ``sdpa``
computes.  The numbers differ in one place: the jnp path rounds the
probabilities to the value dtype before P·V, the kernel keeps them float32
(as the Pallas kernel does).  In float32 the two agree to rounding.

:func:`mamba2_apply` is where the hand-written SSD scan kernel goes: on a
CUDA tensor it calls the SSD scan ``Function`` (kernel forward, the chunked
scan's VJP as backward); on a CPU tensor it runs :func:`ssd_scan`, the
port of the reference's jnp chunked scan (its ``use_kernel=False``
branch), which lives in ``kernels/ssd_scan/chunked.py`` beside its VJP and
is exported here under the reference's name.  The kernel keeps the state and the decay tile in float32, where
the chunked scan keeps them in the model dtype; in float32 the two agree to
rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.kernels.flash_attention.ref import band_mask
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.chunked import ssd_scan
from repro_torch.models.init import Spec

Params = dict[str, torch.Tensor]
NEG_INF = -1e30

__all__ = ["norm_specs", "norm_apply", "rope", "sdpa", "causal_mask",
           "attention_specs", "attention_apply", "attention_decode",
           "mlp_specs", "mlp_apply", "mamba2_specs", "ssd_scan",
           "mamba2_apply", "mamba2_decode", "sub"]


def sub(params: Params, prefix: str) -> Params:
    """The sub-dict of ``params`` under ``prefix/``, keys without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ArchConfig, d: int | None = None) -> dict:
    d = d or cfg.d_model
    p = {"scale": Spec((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = Spec((d,), ("embed",), "zeros")
    return p


def norm_apply(params: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if "bias" in params:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32,
                            device=x.device) / d
    freqs = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Scaled-dot-product attention
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, mask, scale):
    """q:(B,S,H,D) k/v:(B,T,H,D) mask:(B,S,T) or (S,T) broadcastable."""
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    logits = torch.where(mask[..., None, :, :] if mask.ndim == 3 else mask,
                         logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_chunked(q, k, v, scale, *, causal: bool, window: int | None,
                  q_chunk: int):
    """Query-chunked attention: only (q_chunk, T) logit tiles exist at a
    time (the reference scans the chunks under ``jax.checkpoint``)."""
    S, T = q.shape[1], k.shape[1]
    kpos = torch.arange(T, device=q.device)[None, :]
    outs = []
    for ci in range(S // q_chunk):
        qi = q[:, ci * q_chunk:(ci + 1) * q_chunk]
        logits = torch.einsum("bshd,bthd->bhst", qi, k).float() * scale
        qpos = ci * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        mask = torch.ones(q_chunk, T, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", probs, v))
    return torch.cat(outs, dim=1)


def sdpa(q, k, v, scale, *, causal: bool, window: int | None = None,
         q_chunk: int | None = 512):
    """q: (B,S,H,D), k/v: (B,T,H,D) (heads expanded).  On a CUDA tensor,
    the flash-attention kernels; on a CPU tensor, chunked when the query
    length divides cleanly, full otherwise (the reference's dispatch)."""
    if q.device.type == "cuda":
        return gqa_flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    S, T = q.shape[1], k.shape[1]
    if q_chunk and S > q_chunk and S % q_chunk == 0:
        return _sdpa_chunked(q, k, v, scale, causal=causal, window=window,
                             q_chunk=q_chunk)
    return _sdpa(q, k, v, band_mask(S, T, causal, window, q.device), scale)


def causal_mask(S: int, T: int, offset: int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """(S, T) mask: query i (global pos offset+i) may see key j iff j <= pos
    and (pos - j) < window."""
    qpos = offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ArchConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": Spec((d, H, hd), ("embed", "heads", "head_dim"), "fan_in"),
        "wk": Spec((d, KV, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wv": Spec((d, KV, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wo": Spec((H, hd, d), ("heads", "head_dim", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        p["bq"] = Spec((H, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = Spec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = Spec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    return p


def _qkv(params: Params, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    KV = k.shape[-2]
    if KV == H:
        return k
    return k.repeat_interleave(H // KV, dim=-2)


def attention_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True
                    ) -> torch.Tensor:
    """Full-sequence self-attention.  x: (B,S,d)."""
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    k, v = _expand_kv(k, H), _expand_kv(v, H)
    out = sdpa(q, k, v, 1.0 / math.sqrt(hd), causal=causal,
               window=cfg.sliding_window if causal else None,
               q_chunk=cfg.attn_q_chunk)
    return torch.einsum("bshd,hdo->bso", out, params["wo"])


def attention_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode.  x: (B,1,d); pos: (B,) current position;
    cache_k/v: (B, C, KV, hd) where C = full seq (dense) or window (SWA).
    Returns (out (B,1,d), cache_k, cache_v).  The caches are updated in
    place (the reference returns updated copies): decode is never
    differentiated, and a copy per layer per token is pure traffic."""
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x)
    C = cache_k.shape[1]
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    slot = pos % C if cfg.sliding_window else pos               # ring buffer
    bidx = torch.arange(x.shape[0], device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    kpos = torch.arange(C, device=x.device)[None, :]
    if cfg.sliding_window:
        # ring buffer: index r holds global position g, the largest g <= pos
        # with g ≡ r (mod C); valid iff g >= 0 and within the window.
        g = pos[:, None] - torch.remainder(pos[:, None] - kpos, C)
        mask = (g >= 0) & (pos[:, None] - g < min(cfg.sliding_window, C))
    else:
        mask = kpos <= pos[:, None]
    # grouped-query attention against the *unexpanded* cache
    KV = cache_k.shape[2]
    qg = q[:, 0].reshape(q.shape[0], KV, H // KV, hd)           # (B,KV,G,hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.to(x.dtype))
    logits = logits.float() / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v.to(x.dtype))
    out = out.reshape(x.shape[0], 1, H, hd)
    return torch.einsum("bshd,hdo->bso", out, params["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"w1": Spec((d, f), ("embed", "ffn"), "fan_in"),
                "w3": Spec((d, f), ("embed", "ffn"), "fan_in"),
                "w2": Spec((f, d), ("ffn", "embed"), "fan_in")}
    return {"w1": Spec((d, f), ("embed", "ffn"), "fan_in"),
            "b1": Spec((f,), ("ffn",), "zeros"),
            "w2": Spec((f, d), ("ffn", "embed"), "fan_in"),
            "b2": Spec((d,), ("embed",), "zeros")}


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "w3" in params:
        h = F.silu(x @ params["w1"]) * (x @ params["w3"])
        return h @ params["w2"]
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="tanh")
    return h @ params["w2"] + params["b2"]


# ---------------------------------------------------------------------------
# Mamba2 — SSD (state-space duality) chunked scan [arXiv:2405.21060]
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    cw = cfg.ssm_conv
    return {
        "w_x": Spec((d, H, P), ("embed", "ssm_head", "ssm_dim"), "fan_in"),
        "w_z": Spec((d, H, P), ("embed", "ssm_head", "ssm_dim"), "fan_in"),
        "w_B": Spec((d, G, N), ("embed", None, "ssm_state"), "fan_in"),
        "w_C": Spec((d, G, N), ("embed", None, "ssm_state"), "fan_in"),
        "w_dt": Spec((d, H), ("embed", "ssm_head"), "fan_in"),
        "dt_bias": Spec((H,), ("ssm_head",), "zeros"),
        "A_log": Spec((H,), ("ssm_head",), "zeros"),
        "D": Spec((H,), ("ssm_head",), "ones"),
        "conv_x": Spec((cw, H, P), (None, "ssm_head", "ssm_dim"), "fan_in"),
        "conv_B": Spec((cw, G, N), (None, None, "ssm_state"), "fan_in"),
        "conv_C": Spec((cw, G, N), (None, None, "ssm_state"), "fan_in"),
        "norm": {"scale": Spec((H, P), ("ssm_head", "ssm_dim"), "ones")},
        "w_out": Spec((H, P, d), ("ssm_head", "ssm_dim", "embed"), "fan_in"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time.  x: (B, L, *ch); w: (cw, *ch)."""
    cw, L = w.shape[0], x.shape[1]
    pad = torch.zeros(x.shape[:1] + (cw - 1,) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + L] * w[i] for i in range(cw))
    return F.silu(out)


def _gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    x = x * F.silu(z)
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def mamba2_apply(params: Params, cfg: ArchConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """Full-sequence Mamba2 mixer.  x: (B, L, d)."""
    xin = torch.einsum("bld,dhp->blhp", x, params["w_x"])
    z = torch.einsum("bld,dhp->blhp", x, params["w_z"])
    Bm = torch.einsum("bld,dgn->blgn", x, params["w_B"])
    Cm = torch.einsum("bld,dgn->blgn", x, params["w_C"])
    xin = _causal_conv(xin, params["conv_x"])
    Bm = _causal_conv(Bm, params["conv_B"])
    Cm = _causal_conv(Cm, params["conv_C"])
    dt = F.softplus(torch.einsum("bld,dh->blh", x, params["w_dt"])
                    + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    chunk = min(cfg.ssm_chunk, x.shape[1])
    if x.device.type == "cuda":
        y, _ = ssd_ops.ssd_scan(xin, dt, A, Bm, Cm, chunk=chunk)
    else:
        y, _ = ssd_scan(xin, dt.float(), A, Bm, Cm, chunk)
    y = y + xin * params["D"][None, None, :, None]
    y = _gated_rmsnorm(params["norm/scale"], y, z)
    return torch.einsum("blhp,hpd->bld", y, params["w_out"])


def mamba2_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (B,1,d);
    conv_state: (B, cw-1, H*P + 2*G*N) channel history in the order
    ``[x | B | C]``; ssm_state: (B, H, P, N).  Returns (out (B,1,d),
    conv_state, ssm_state); both states are updated in place (the
    reference returns updated copies): the history shifts by one and the
    state is overwritten."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    cw = cfg.ssm_conv
    xin = torch.einsum("bld,dhp->blhp", x, params["w_x"])[:, 0]  # (B,H,P)
    z = torch.einsum("bld,dhp->blhp", x, params["w_z"])[:, 0]
    Bm = torch.einsum("bld,dgn->blgn", x, params["w_B"])[:, 0]
    Cm = torch.einsum("bld,dgn->blgn", x, params["w_C"])[:, 0]
    Bsz = x.shape[0]
    ch = torch.cat([xin.reshape(Bsz, -1), Bm.reshape(Bsz, -1),
                    Cm.reshape(Bsz, -1)], dim=-1)              # (B, ch)
    hist = torch.cat([conv_state, ch[:, None, :]], dim=1)      # (B,cw,ch)
    wall = torch.cat([params["conv_x"].reshape(cw, -1),
                      params["conv_B"].reshape(cw, -1),
                      params["conv_C"].reshape(cw, -1)], dim=-1)  # (cw, ch)
    conved = F.silu(torch.einsum("bcw,cw->bw", hist, wall))
    xin = conved[:, : H * P].reshape(Bsz, H, P)
    Bm = conved[:, H * P: H * P + G * N].reshape(Bsz, G, N)
    Cm = conved[:, H * P + G * N:].reshape(Bsz, G, N)
    dt = F.softplus(torch.einsum("bld,dh->blh", x, params["w_dt"])[:, 0]
                    + params["dt_bias"])                        # (B,H)
    A = -torch.exp(params["A_log"].float())
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1)                       # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * A)[..., None, None]                  # (B,H,1,1)
    upd = dt[..., None, None] * torch.einsum("bhn,bhp->bhpn", Bh, xin)
    new = (ssm_state * decay.to(ssm_state.dtype)
           + upd.to(ssm_state.dtype))
    conv_state.copy_(hist[:, 1:])
    ssm_state.copy_(new)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state.to(x.dtype), Ch)
    y = y + xin * params["D"][None, :, None]
    y = _gated_rmsnorm(params["norm/scale"], y, z)
    out = torch.einsum("bhp,hpd->bd", y, params["w_out"])[:, None, :]
    return out, conv_state, ssm_state
