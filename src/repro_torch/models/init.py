"""Parameter specs and their materialization (port of
``repro/models/init.py``).

A model is described by a flat dict of :class:`Spec` leaves keyed by the
JAX package's key paths joined with ``/`` (``l0/w``); ``materialize`` turns
it into tensors.  Init draws from an explicit ``torch.Generator`` on the CPU
and then moves to ``device``, so one seed gives the same weights on every
device.  Torch's generator gives other numbers than ``jax.random`` for the
same seed: parity tests copy the reference's weights in
(:func:`repro_torch.convert.from_jax_params`) instead of comparing inits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Spec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical name per dim (len == len(shape))
    init: str = "normal"           # normal | zeros | ones | fan_in | embed
    scale: float = 1.0

    def __repr__(self):  # keep prints short
        return f"Spec{self.shape}"


def _init_leaf(gen: torch.Generator, spec: Spec) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape)
    if spec.init == "ones":
        return torch.ones(shape)
    normal = torch.randn(shape, generator=gen, dtype=torch.float32)
    if spec.init == "normal":
        return normal * 0.02 * spec.scale
    if spec.init == "embed":
        return normal * spec.scale
    if spec.init == "fan_in":
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return normal * (spec.scale / max(1.0, np.sqrt(fan_in)))
    raise ValueError(spec.init)


def materialize(specs: dict[str, Spec], gen: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None) -> dict[str, torch.Tensor]:
    """Initialize every Spec leaf from ``gen``, in key order."""
    device = resolve_device(device)
    return {k: _init_leaf(gen, s).to(dtype=dtype, device=device)
            for k, s in specs.items()}

