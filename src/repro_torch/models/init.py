"""Parameter specs and their materialization (port of
``repro/models/init.py``).

A model is described by a tree of :class:`Spec` leaves — nested dicts,
lists and tuples, as the JAX package builds it — and its parameters are the
flat dict of that tree, keyed by the key paths joined with ``/`` (``l0/w``,
``segments/0/0/attn/wq``): the form ``torch.func`` transforms take.
``materialize`` turns a Spec tree into that dict.  Init draws from an
explicit ``torch.Generator`` on the CPU, in chunks of at most
``_CHUNK`` elements, and moves each chunk to ``device`` in ``dtype`` (a
worker thread scales, casts and copies a chunk while the next is drawn),
so one seed gives the same weights on every device and a full-width init
holds a few chunks in float32 on the host, not a float32 copy of the
model.  Torch's
generator gives other numbers than ``jax.random`` for the same seed: parity
tests copy the reference's weights in
(:func:`repro_torch.convert.from_jax_params`) instead of comparing inits.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Spec", "count_params", "flatten_tree", "materialize",
           "stack_specs"]

_CHUNK = 1 << 24          # elements drawn per generator call


class Spec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical name per dim (len == len(shape))
    init: str = "normal"           # normal | zeros | ones | fan_in | embed
    scale: float = 1.0

    def __repr__(self):  # keep prints short
        return f"Spec{self.shape}"


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Nested dicts/lists/tuples → flat dict keyed by ``/``-joined paths,
    in the reference's leaf order (dict keys sorted, sequences in order).
    Named tuples such as :class:`Spec` are leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = {}
        for i, x in enumerate(tree):
            out.update(flatten_tree(x, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def count_params(tree: Any) -> int:
    """Elements of every Spec leaf of ``tree`` (a Spec tree or its flat
    dict)."""
    return int(sum(np.prod(s.shape) for s in flatten_tree(tree).values()))


def _map_specs(fn, tree):
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a Spec tree node: {type(tree).__name__}")


def stack_specs(tree: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacking dim of size n (the reference's lax.scan'd layer
    stacks; the port loops over it)."""
    return _map_specs(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                       s.scale), tree)


def _scaled(normal: torch.Tensor, spec: Spec) -> torch.Tensor:
    """A standard-normal draw scaled as the reference scales it."""
    if spec.init == "normal":
        return normal * 0.02 * spec.scale
    if spec.init == "embed":
        return normal * spec.scale
    if spec.init == "fan_in":
        shape = spec.shape
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return normal * (spec.scale / max(1.0, np.sqrt(fan_in)))
    raise ValueError(spec.init)


def _init_leaf(gen: torch.Generator, spec: Spec, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    n = int(np.prod(shape))
    if n <= _CHUNK:
        normal = torch.randn(shape, generator=gen, dtype=torch.float32)
        return _scaled(normal, spec).to(dtype=dtype, device=device)
    out = torch.empty(n, dtype=dtype, device=device)

    def store(lo: int, normal: torch.Tensor) -> None:
        out[lo:lo + normal.numel()].copy_(_scaled(normal, spec).to(dtype))

    # the generator draws chunk after chunk on this thread while a worker
    # scales, casts and copies the one before (the same numbers: the draws
    # keep their order)
    with ThreadPoolExecutor(1, thread_name_prefix="init") as pool:
        pending: list = []
        for lo in range(0, n, _CHUNK):
            normal = torch.randn(min(_CHUNK, n - lo), generator=gen,
                                 dtype=torch.float32)
            if len(pending) == 2:
                pending.pop(0).result()
            pending.append(pool.submit(store, lo, normal))
        for job in pending:
            job.result()
    return out.view(shape)


def materialize(specs: Any, gen: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None) -> dict[str, torch.Tensor]:
    """Initialize every Spec leaf of ``specs`` (a Spec tree or its flat
    dict) from ``gen``, in key order, into a flat dict of tensors."""
    device = resolve_device(device)
    flat = specs if _is_flat(specs) else flatten_tree(specs)
    return {k: _init_leaf(gen, s, dtype, device) for k, s in flat.items()}


def _is_flat(specs: Any) -> bool:
    return isinstance(specs, dict) and all(isinstance(v, Spec)
                                           for v in specs.values())
