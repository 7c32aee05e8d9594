"""Weights carried across from the JAX package.

The reference's parameter pytrees (nested dicts, a leading agent axis on
every leaf) and optimizer states (``AdamState(step, mu, nu)``,
``MomentumState(velocity)``, ``()`` for sgd), handed over as numpy arrays,
become the port's flat param dicts keyed by the joined key paths
(``{"l0": {"w": ...}}`` → ``{"l0/w": ...}``) and its optimizer states, so
both packages start from one init and one optimizer state.  Nothing here
imports JAX: the caller converts with ``jax.tree.map(np.asarray, tree)``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import AdamState, MomentumState

__all__ = ["from_jax_params", "from_jax_opt_state"]


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):          # the reference's leaf order
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _tensor(x: Any) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":      # ml_dtypes' bf16: widen exactly
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def from_jax_params(tree_of_numpy: Any, device=None) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays → flat dict of tensors on ``device``
    (None: the CUDA card), keys joined with ``/``, dtypes kept."""
    device = resolve_device(device)
    return {k: _tensor(v).to(device)
            for k, v in _flatten(tree_of_numpy).items()}


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

