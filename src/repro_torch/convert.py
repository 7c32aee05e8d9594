"""Weights carried across from the JAX package.

The reference's parameter pytrees (nested dicts, lists and tuples — the LM
tree is ``{"segments": [({block},)]}`` with a leading layer axis on every
block leaf — and, for the trainer, a leading agent axis) and optimizer
states (``AdamState(step, mu, nu)``,
``MomentumState(velocity)``, ``()`` for sgd), handed over as numpy arrays,
become the port's flat param dicts keyed by the joined key paths
(``{"l0": {"w": ...}}`` → ``{"l0/w": ...}``; list and tuple entries by their
index, ``segments/0/0/attn/wq``) and its optimizer states, so
both packages start from one init and one optimizer state.  Nothing here
imports JAX: the caller converts with ``jax.tree.map(np.asarray, tree)``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.init import flatten_tree
from repro_torch.optim.optimizers import AdamState, MomentumState

__all__ = ["from_jax_params", "from_jax_opt_state"]


def _tensor(x: Any) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":      # ml_dtypes' bf16: widen exactly
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def from_jax_params(tree_of_numpy: Any, device=None) -> dict[str, torch.Tensor]:
    """Nested dicts/lists/tuples of numpy arrays → flat dict of tensors on
    ``device`` (None: the CUDA card), keys joined with ``/``, dtypes kept."""
    device = resolve_device(device)
    return {k: _tensor(v).to(device)
            for k, v in flatten_tree(tree_of_numpy).items()}


def from_jax_opt_state(state: Any, device=None):
    """The reference optimizer state (as numpy) → the port's: AdamState
    (``step`` an int32 scalar tensor, fp32 ``mu``/``nu``), MomentumState,
    or ``()`` for sgd."""
    device = resolve_device(device)
    fields = getattr(state, "_fields", ())
    if fields == ("step", "mu", "nu"):
        return AdamState(
            torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                         device=device),
            from_jax_params(state.mu, device), from_jax_params(state.nu,
                                                               device))
    if fields == ("velocity",):
        return MomentumState(from_jax_params(state.velocity, device))
    if state == ():
        return ()
    raise ValueError(f"unrecognised optimizer state {type(state).__name__} "
                     f"with fields {fields}")

