"""Decentralized outer-update composition (port of ``repro/core/update.py``).

The trainer (:func:`repro_torch.core.meta_trainer.make_meta_step`) is a thin
assembly of

    InnerAlgo × DiffusionStrategy × CommSchedule

with each factor a registry entry.

DiffusionStrategy registry — ``apply(params, updates, combine_fn, step)``:

``atc``          Adapt-then-Combine (paper Algorithm 1): ``w' = A (w + u)``.
``cta``          Combine-then-Adapt: the iterate is mixed *before* the
                 meta-gradient (``pre_combine=True``), ``w' = ψ + u(ψ)``.
``consensus``    consensus/DGD: ``w' = A w + u(w)``.
``none``         non-cooperative baseline: ``w' = w + u``.
``centralized``  every agent receives the centroid of the adapted iterates.

InnerAlgo registry: names the meta-gradient algorithm
(:mod:`repro_torch.core.maml` modes).

CommSchedule: ``every=n`` communicates on steps with ``step % n == n − 1``.
The step is a host-side int in the port, so the trainer gates with a
Python branch and skipped steps launch no combine at all.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import diffusion

__all__ = [
    "DiffusionStrategy",
    "register_strategy",
    "update_strategies",
    "get_strategy",
    "InnerAlgo",
    "inner_algos",
    "get_inner_algo",
    "CommSchedule",
    "local_update",
]


@dataclasses.dataclass(frozen=True)
class DiffusionStrategy:
    """One registered outer-update composition.

    ``communicates``     whether the strategy moves bytes between agents
    ``needs_combine_fn`` whether ``apply`` consumes the topology's combine
    ``pre_combine``      mix the iterate before the gradient step (``cta``)
    """

    name: str
    apply: Callable[..., diffusion.Params]
    communicates: bool = True
    needs_combine_fn: bool = True
    pre_combine: bool = False


_STRATEGIES: dict[str, DiffusionStrategy] = {}


def register_strategy(name: str, **flags: bool):
    """Decorator: register an ``apply`` composition under ``name``."""

    def deco(apply):
        _STRATEGIES[name] = DiffusionStrategy(name, apply, **flags)
        return apply

    return deco


def update_strategies() -> tuple[str, ...]:
    return tuple(_STRATEGIES)


def get_strategy(name: str) -> DiffusionStrategy:
    s = _STRATEGIES.get(name)
    if s is None:
        raise ValueError(f"unknown diffusion strategy {name!r}; "
                         f"registered: {update_strategies()}")
    return s


def local_update(params: diffusion.Params,
                 updates: diffusion.Params) -> diffusion.Params:
    """The communication-free outer update w' = w + u — the 'none' strategy
    and the skip branch of the CommSchedule gate."""
    return {k: p + updates[k] for k, p in params.items()}


@register_strategy("atc")
def _atc(params, updates, combine_fn, step):
    """w' = A (w + u): paper Algorithm 1 (eq. 6a adapt, 6b combine)."""
    return diffusion.atc_step(params, updates, lambda p: combine_fn(p, step))


@register_strategy("cta", pre_combine=True)
def _cta(params, updates, combine_fn, step):
    """w' = ψ + u(ψ) with ψ = A w mixed before the gradient."""
    return local_update(params, updates)


@register_strategy("consensus")
def _consensus(params, updates, combine_fn, step):
    """w' = A w + u(w): consensus/DGD."""
    return diffusion.cta_step(params, updates, lambda p: combine_fn(p, step))


@register_strategy("none", communicates=False, needs_combine_fn=False)
def _none(params, updates, combine_fn, step):
    """w' = w + u: non-cooperative baseline (A = I)."""
    return local_update(params, updates)


@register_strategy("centralized", needs_combine_fn=False)
def _centralized(params, updates, combine_fn, step):
    """Every agent receives the centroid of the adapted iterates."""
    return diffusion.centralized_combine(local_update(params, updates))


@dataclasses.dataclass(frozen=True)
class InnerAlgo:
    """A named inner meta-gradient algorithm; ``mode`` is the string
    :func:`repro_torch.core.maml.multi_task_meta_grad` dispatches on."""

    name: str
    mode: str
    order: int                 # derivative order of the meta-gradient
    doc: str = ""


_INNER: dict[str, InnerAlgo] = {
    "maml": InnerAlgo("maml", "maml", 2,
                      "exact second-order meta-gradient (paper eq. 4)"),
    "fomaml": InnerAlgo("fomaml", "fomaml", 1,
                        "first-order: curvature term dropped"),
    "reptile": InnerAlgo("reptile", "reptile", 1,
                         "update direction = (w_adapted - w)"),
    "maml_naive": InnerAlgo("maml_naive", "maml_naive", 2,
                            "differentiate-through-the-update "
                            "cross-validation form"),
}


def inner_algos() -> tuple[str, ...]:
    return tuple(_INNER)


def get_inner_algo(name: str) -> InnerAlgo:
    a = _INNER.get(name)
    if a is None:
        raise ValueError(f"unknown inner algorithm {name!r}; "
                         f"registered: {inner_algos()}")
    return a


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Communicate every ``every``-th step (the combine runs when
    ``step % every == every - 1``)."""

    every: int = 1

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"CommSchedule.every must be >= 1, "
                             f"got {self.every}")

    @property
    def always(self) -> bool:
        return self.every == 1

    def is_comm_step(self, step: int) -> bool:
        return (step % self.every) == self.every - 1

