"""Step builders shared by the port's entry points — the serve part of
``repro/launch/steps.py``: ``DTYPES``, ``modality_extras`` and
``build_serve``.  The reference's mesh, sharding rules and the training
and prefill builders have no counterpart here yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import ArchConfig, InputShape
from repro_torch.models.transformer import build_model

__all__ = ["DTYPES", "ServeBundle", "build_serve", "modality_extras"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def modality_extras(cfg: ArchConfig, lead: tuple[int, ...],
                    dtype: torch.dtype, device=None) -> dict:
    """Zero-stub modality inputs the model's loss expects beyond
    tokens/labels.  The dense decoder and Mamba2 families need none; the
    audio and vision families (later slices) raise."""
    if cfg.arch_type in ("audio", "vlm"):
        raise ValueError(f"{cfg.name}: {cfg.arch_type} inputs are not "
                         f"ported yet")
    return {}


@dataclasses.dataclass
class ServeBundle:
    cfg: ArchConfig
    step_fn: Callable          # (params, cache, token, pos) -> (logits, cache)
    params_specs: Any          # flat dict of meta tensors (shape, dtype)


def build_serve(cfg: ArchConfig, shape: InputShape) -> ServeBundle:
    """The decode step of ``cfg`` and the shapes and dtypes of its params
    (meta tensors: no memory), for an engine serving ``shape``."""
    if shape.kind != "decode":
        raise ValueError(f"build_serve needs a decode shape, got "
                         f"{shape.kind!r}")
    dt = DTYPES[cfg.dtype]
    model = build_model(cfg)
    specs = {k: torch.empty(s.shape, dtype=dt, device="meta")
             for k, s in model.specs().items()}
    return ServeBundle(cfg, model.decode_step, specs)
