"""Adaptation at evaluation time (paper Fig. 2b/2c) — the ``curves``,
``adapt_states`` and ``task_loss`` primitives of ``repro/eval/harness.py``.

Adaptation itself is :func:`repro_torch.core.maml.inner_adapt`, the same
code path the meta step differentiates through.  The reference's
recurring-vs-unseen protocol (``evaluate``, ``measure``, ``agent_curves``,
``EvalReport``) comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import maml

LossFn = Callable[[dict, Any], torch.Tensor]

__all__ = ["EvalHarness"]


@dataclasses.dataclass
class EvalHarness:
    """Batched adapt-and-measure on ``maml.inner_adapt``.

    ``curves(params, support, query)`` — params one launch model (no agent
    axis), support/query task-leading pytrees — returns ``(n_tasks,
    inner_steps + 1)`` query-loss curves, ``torch.func.vmap`` over tasks.
    Eval is never differentiated, so adaptation runs ``first_order=True``.
    """
    loss_fn: LossFn
    inner_lr: float
    inner_steps: int = 1

    def curves(self, params: dict, support: Any, query: Any) -> torch.Tensor:
        """(n_tasks, inner_steps+1) loss curves for one launch model."""
        def eval_one(s, q):
            p = params
            losses = [self.loss_fn(p, q)]
            for _ in range(self.inner_steps):
                p = maml.inner_adapt(self.loss_fn, p, s, alpha=self.inner_lr,
                                     steps=1, first_order=True)
                losses.append(self.loss_fn(p, q))
            return torch.stack(losses)

        return torch.func.vmap(eval_one)(support, query)

    def adapt_states(self, params: dict, support: Any) -> dict:
        """Adapted parameters, task-stacked: one ``torch.func.vmap`` of
        ``inner_adapt`` over a batch of support sets (leading axis = tasks)
        from one launch model — the serving tier's batched adaptation, N
        concurrent user episodes in one dispatch."""
        return torch.func.vmap(lambda s: maml.inner_adapt(
            self.loss_fn, params, s, alpha=self.inner_lr,
            steps=self.inner_steps, first_order=True))(support)

    def task_loss(self, stacked_params: dict, batch: Any) -> torch.Tensor:
        """(n_tasks,) losses: each task's own adapted params (leading task
        axis, e.g. from :meth:`adapt_states`) on its own batch."""
        return torch.func.vmap(self.loss_fn)(stacked_params, batch)
