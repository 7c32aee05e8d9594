"""MAML inner/outer loops (paper §1.1, eq. 2-4; port of
``repro/core/maml.py``).

Generic over the model: a ``loss_fn(params, batch) -> scalar`` closure over
a flat param dict.  The exact meta-gradient (eq. 4) — including the
``(I - α ∇²Q)`` curvature factor — is computed with ``torch.func``; no
Hessian is ever materialized.

Modes:
  'maml'        exact second-order meta-gradient, forward-over-reverse
                HVPs (``torch.func.jvp`` over ``torch.func.grad``)
  'fomaml'      first-order: the inner gradient is detached
  'reptile'     update direction = (w - w_adapted) / α
  'maml_naive'  differentiate-through-the-update form (cross-validation)
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import grad, grad_and_value, jvp, vmap
from torch.utils.checkpoint import checkpoint

from repro_torch.data.episodes import tree_map

Params = dict[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]

__all__ = ["inner_adapt", "meta_loss", "meta_grad", "multi_task_meta_grad"]


def _sgd_step(params: Params, grads: Params, alpha: float) -> Params:
    return {k: p - alpha * grads[k] for k, p in params.items()}


def inner_adapt(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    alpha: float,
    steps: int = 1,
    first_order: bool = False,
    remat: bool = False,
) -> Params:
    """Task adaptation: ``w' = w - α ∇Q(w; X_in)`` applied ``steps`` times.

    With ``first_order=True`` the inner gradient is detached, a constant of
    the outer differentiation (FOMAML).

    ``remat=True`` wraps each inner step in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): the outer backward recomputes the inner
    forward and backward instead of keeping them alive.  PyTorch accepts it
    only when ``torch.autograd`` differentiates through the adaptation —
    ``torch.func`` transforms reject checkpointing — so :func:`meta_grad`
    adapts without it.  The sine model runs without remat either way.
    """

    def step_fn(p):
        g = grad(loss_fn)(p, batch)
        if first_order:
            g = {k: v.detach() for k, v in g.items()}
        return _sgd_step(p, g, alpha)

    if remat and not first_order:
        plain = step_fn
        step_fn = lambda p: checkpoint(plain, p, use_reentrant=False)

    for _ in range(steps):
        params = step_fn(params)
    return params


def meta_loss(
    loss_fn: LossFn,
    params: Params,
    support: Any,
    query: Any,
    alpha: float,
    steps: int = 1,
    mode: str = "maml",
) -> torch.Tensor:
    """Meta objective for a single task: ``Q(w - α∇Q(w; X_in); X_o)``.
    ``fomaml`` and ``reptile`` adapt with the inner gradient detached
    (Reptile has no outer loss of its own; its callers use
    :func:`meta_grad`)."""
    adapted = inner_adapt(loss_fn, params, support, alpha, steps,
                          first_order=mode in ("fomaml", "reptile"))
    return loss_fn(adapted, query)


def meta_grad(
    loss_fn: LossFn,
    params: Params,
    support: Any,
    query: Any,
    alpha: float,
    steps: int = 1,
    mode: str = "maml",
    hvp_subsample: float = 1.0,
    freeze_mask: dict[str, bool] | None = None,
) -> tuple[torch.Tensor, Params]:
    """Stochastic meta-gradient ``∇Q̄`` for one task (eq. 4).  Returns
    (outer loss value, meta-gradient dict).

    mode='maml' computes the exact second-order gradient

        ∇Q̄ = ∏_j (I − α ∇²Q_in(w_j)) · ∇Q_o(w')

    with the curvature factors applied as Hessian-vector products in
    forward-over-reverse form, ``jvp(grad(Q_in), (w_j,), (v,))``.
    mode='maml_naive' differentiates through the update instead, for
    cross-validation on small models.
    """
    if mode == "reptile":
        adapted = inner_adapt(loss_fn, params, support, alpha, steps,
                              first_order=True)
        # Direction (w - w') / α plays the role of the meta-gradient.
        g = {k: (p - adapted[k]) / max(alpha, 1e-12)
             for k, p in params.items()}
        return loss_fn(adapted, query), g
    if freeze_mask is not None:
        # ANIL-style partial adaptation: frozen leaves are detached inside
        # the *inner* loss, so the inner gradient, the inner update and the
        # curvature cross-terms vanish on them; the outer gradient still
        # trains them.
        def _mix(p):
            return {k: v.detach() if freeze_mask[k] else v
                    for k, v in p.items()}
        inner_loss = lambda p, b: loss_fn(_mix(p), b)
    else:
        inner_loss = loss_fn
    if mode == "maml":
        grad_in = lambda p: grad(inner_loss)(p, support)
        trajectory = []
        p = params
        for _ in range(steps):
            trajectory.append(p)
            p = _sgd_step(p, grad_in(p), alpha)
        v, loss = grad_and_value(loss_fn)(p, query)
        if hvp_subsample < 1.0:
            # estimate ∇²Q_in on a support subsample (beyond-paper knob)
            def sub(x):
                return x[:max(1, int(x.shape[0] * hvp_subsample))]
            sub_batch = tree_map(sub, support)
            grad_hvp = lambda p: grad(inner_loss)(p, sub_batch)
        else:
            grad_hvp = grad_in
        for w_j in reversed(trajectory):
            _, hv = jvp(grad_hvp, (w_j,), (v,))       # ∇²Q_in(w_j) · v
            v = {k: a - alpha * hv[k] for k, a in v.items()}
        return loss, v
    if mode not in ("fomaml", "maml_naive"):
        raise ValueError(f"unknown meta-gradient mode {mode!r}; one of "
                         f"('maml', 'fomaml', 'reptile', 'maml_naive')")
    # fomaml / maml_naive: adapt with the (possibly masked) inner loss, take
    # the outer loss unmasked so frozen leaves still receive meta-gradients
    first_order = mode == "fomaml"

    def full(p):
        adapted = inner_adapt(inner_loss, p, support, alpha, steps,
                              first_order=first_order)
        return loss_fn(adapted, query)

    g, loss = grad_and_value(full)(params)
    return loss, g


def multi_task_meta_grad(
    loss_fn: LossFn,
    params: Params,
    support: Any,
    query: Any,
    alpha: float,
    steps: int = 1,
    mode: str = "maml",
    hvp_subsample: float = 1.0,
    freeze_mask: dict[str, bool] | None = None,
) -> tuple[torch.Tensor, Params]:
    """Meta-gradient averaged over a batch of tasks (leading axis of
    ``support``/``query`` is the task axis): ``(1/|S_k|) Σ_t ∇Q̄^(t)``."""

    def per_task(s, q):
        return meta_grad(loss_fn, params, s, q, alpha, steps, mode,
                         hvp_subsample, freeze_mask)

    losses, grads = vmap(per_task)(support, query)
    return losses.mean(), {k: g.mean(0) for k, g in grads.items()}
