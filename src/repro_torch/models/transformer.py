"""Model assembly for the dense decoder family — port of the dense subset of
``repro/models/transformer.py``.

A model is a list of **segments**; each segment repeats a **period** (a
short list of blocks) ``n`` times, with the period's parameters stacked on
a leading layer axis.  The reference scans the stack with ``lax.scan``; the
port loops over it in Python.  For a dense LM the plan is one segment of L
``attn + mlp`` blocks, and the parameters are the flat dict of the
reference's tree (``segments/0/0/attn/wq`` has shape (L, d, H, hd)).

The reference wraps each layer in ``jax.checkpoint`` (``cfg.remat``).
``torch.func`` transforms reject ``torch.utils.checkpoint``, so the port
runs without it: remat changes memory, not numbers.

MoE, MLA, Mamba, cross-attention and the encoder-decoder and vision
families come with later slices; :func:`segment_plan` raises for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.init import Spec, flatten_tree, materialize, stack_specs

Params = dict[str, torch.Tensor]

__all__ = ["BlockDesc", "Segment", "Model", "block_specs", "block_apply",
           "block_cache_specs", "block_decode", "segment_plan",
           "segment_specs", "segment_apply", "segment_cache_specs",
           "segment_decode", "build_model"]


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    mixer: str          # attn | attn_nc (non-causal)
    ffn: str            # dense | none


@dataclasses.dataclass(frozen=True)
class Segment:
    n: int
    period: tuple[BlockDesc, ...]


# ---------------------------------------------------------------------------
# Block specs / apply / decode
# ---------------------------------------------------------------------------

def _check_block(desc: BlockDesc) -> None:
    if desc.mixer not in ("attn", "attn_nc") or desc.ffn not in ("dense",
                                                                 "none"):
        raise ValueError(f"block {desc} is not in the port's dense decoder "
                         f"family (MLA, Mamba, cross-attention and MoE "
                         f"blocks come with later slices)")


def block_specs(cfg: ArchConfig, desc: BlockDesc) -> dict:
    _check_block(desc)
    p: dict[str, Any] = {"norm1": L.norm_specs(cfg),
                         "attn": L.attention_specs(cfg)}
    if desc.ffn != "none":
        p["norm2"] = L.norm_specs(cfg)
        p["ffn"] = L.mlp_specs(cfg)
    return p


def block_apply(cfg: ArchConfig, desc: BlockDesc, p: Params,
                x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    h = L.norm_apply(L.sub(p, "norm1"), x)
    x = x + L.attention_apply(L.sub(p, "attn"), cfg, h, positions,
                              causal=desc.mixer == "attn")
    if desc.ffn != "none":
        h = L.norm_apply(L.sub(p, "norm2"), x)
        x = x + L.mlp_apply(L.sub(p, "ffn"), h)
    return x


def block_cache_specs(cfg: ArchConfig, desc: BlockDesc, batch: int,
                      cache_len: int) -> dict:
    """Spec tree of this block's decode state."""
    _check_block(desc)
    C = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    kv = Spec((batch, C, cfg.num_kv_heads, cfg.head_dim),
              ("batch", "seq", "kv_heads", "head_dim"), "zeros")
    return {"k": kv, "v": kv}


def block_decode(cfg: ArchConfig, desc: BlockDesc, p: Params, cache: Params,
                 x: torch.Tensor, pos: torch.Tensor
                 ) -> tuple[torch.Tensor, Params]:
    h = L.norm_apply(L.sub(p, "norm1"), x)
    y, ck, cv = L.attention_decode(L.sub(p, "attn"), cfg, h, pos,
                                   cache["k"], cache["v"])
    x, cache = x + y, {"k": ck, "v": cv}
    if desc.ffn != "none":
        h = L.norm_apply(L.sub(p, "norm2"), x)
        x = x + L.mlp_apply(L.sub(p, "ffn"), h)
    return x, cache


# ---------------------------------------------------------------------------
# Segment plans
# ---------------------------------------------------------------------------

def segment_plan(cfg: ArchConfig) -> list[Segment]:
    if cfg.arch_type != "dense":
        raise ValueError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet; the "
            f"port's LM models are the dense decoder family (moe, ssm, "
            f"hybrid, vlm and audio come with later slices)")
    return [Segment(cfg.num_layers, (BlockDesc("attn", "dense"),))]


# ---------------------------------------------------------------------------
# Segment-level specs / apply / decode (a loop over the stacked layer axis)
# ---------------------------------------------------------------------------

def segment_specs(cfg: ArchConfig, seg: Segment) -> tuple:
    return tuple(stack_specs(block_specs(cfg, d), seg.n) for d in seg.period)


def _layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params.items()}


def segment_apply(cfg: ArchConfig, seg: Segment, params: Params,
                  x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``params``: this segment's flat dict (keys ``{period index}/...``),
    every leaf stacked on a leading axis of size ``seg.n``."""
    blocks = [L.sub(params, str(j)) for j in range(len(seg.period))]
    for i in range(seg.n):
        for desc, p in zip(seg.period, blocks):
            x = block_apply(cfg, desc, _layer(p, i), x, positions)
    return x


def segment_cache_specs(cfg: ArchConfig, seg: Segment, batch: int,
                        cache_len: int) -> tuple:
    return tuple(stack_specs(block_cache_specs(cfg, d, batch, cache_len),
                             seg.n) for d in seg.period)


def segment_decode(cfg: ArchConfig, seg: Segment, params: Params,
                   cache: Params, x: torch.Tensor, pos: torch.Tensor
                   ) -> tuple[torch.Tensor, Params]:
    """One token through the segment; ``cache`` (flat, keys
    ``{period index}/k``...) is updated in place and returned."""
    blocks = [L.sub(params, str(j)) for j in range(len(seg.period))]
    caches = [L.sub(cache, str(j)) for j in range(len(seg.period))]
    for i in range(seg.n):
        for desc, p, c in zip(seg.period, blocks, caches):
            x, _ = block_decode(cfg, desc, _layer(p, i), _layer(c, i), x,
                                pos)
    return x, cache


# ---------------------------------------------------------------------------
# Full models
# ---------------------------------------------------------------------------

class Model:
    """Bundles specs + pure functions for one architecture."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.plan = segment_plan(cfg)

    # -- specs ---------------------------------------------------------------
    def specs(self) -> dict[str, Spec]:
        """Flat dict of the reference's Spec tree."""
        cfg = self.cfg
        V, d = cfg.padded_vocab, cfg.d_model
        return flatten_tree({
            "embed": Spec((V, d), ("vocab", "embed"), "embed", 0.02),
            "final_norm": L.norm_specs(cfg),
            "head": Spec((d, V), ("embed", "vocab"), "fan_in"),
            "segments": [segment_specs(cfg, s) for s in self.plan],
        })

    def init(self, gen: torch.Generator, dtype: torch.dtype = torch.float32,
             device=None) -> Params:
        return materialize(self.specs(), gen, dtype, device)

    # -- forward -------------------------------------------------------------
    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        S = tokens.shape[-1]
        x = params["embed"][tokens]
        positions = torch.arange(S, device=x.device)[None]
        for si, seg in enumerate(self.plan):
            x = segment_apply(self.cfg, seg, L.sub(params, f"segments/{si}"),
                              x, positions)
        x = L.norm_apply(L.sub(params, "final_norm"), x)
        return x @ params["head"]

    def loss_fn(self, params: Params, batch: dict) -> torch.Tensor:
        logits = self.forward(params, batch).float()
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (logz - gold).mean()

    # -- decode --------------------------------------------------------------
    def cache_specs(self, batch: int, cache_len: int) -> dict[str, Spec]:
        return flatten_tree([segment_cache_specs(self.cfg, s, batch,
                                                 cache_len)
                             for s in self.plan])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None
                   ) -> Params:
        """Zero caches, flat dict keyed ``{segment}/{period index}/k``..."""
        device = resolve_device(device)
        return {k: torch.zeros(s.shape, dtype=dtype, device=device)
                for k, s in self.cache_specs(batch, cache_len).items()}

    def decode_step(self, params: Params, cache: Params, token: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, Params]:
        """One decode step.  token: (B,1) int, pos: (B,) int.  Returns
        (logits (B,1,V), cache); the cache is updated in place."""
        x = params["embed"][token]
        for si, seg in enumerate(self.plan):
            x, _ = segment_decode(self.cfg, seg,
                                  L.sub(params, f"segments/{si}"),
                                  L.sub(cache, str(si)), x, pos)
        x = L.norm_apply(L.sub(params, "final_norm"), x)
        return x @ params["head"], cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
