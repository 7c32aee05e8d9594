"""The adaptation-at-evaluation-time engine (paper Fig. 2b/2c) — port of
``repro/eval/harness.py``.

Every consumer that measures how well a launch model *adapts* — the
trainer's in-training eval hook and the serving path — goes through this
module.  Adaptation itself is :func:`repro_torch.core.maml.inner_adapt`,
the same code path the meta step differentiates through.

:class:`EvalHarness`
    Bound to ``(loss_fn, inner_lr, inner_steps)``.  ``curves`` is the
    batched adapt-and-measure primitive (``torch.func.vmap`` over tasks):
    per-inner-step query-loss curves (index 0 = zero-shot).  ``evaluate``
    is the recurring-vs-unseen protocol: draw ``eval_sample`` episodes from
    both splits of a task source, measure against the **centroid** and the
    **per-agent** parameters of a ``TrainState``, and report the
    generalization gap and the network disagreement at eval time.

:class:`EvalReport` / :class:`SplitReport`
    Plain-data results with a JSON-ready ``to_record()`` for the trainer's
    JSONL run log, field for field the reference's.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import diffusion, maml
from repro_torch.data.episodes import (EVAL_SPLITS, Episode, host_tensors,
                                       to_device)

LossFn = Callable[[dict, Any], torch.Tensor]

__all__ = ["EvalHarness", "EvalReport", "SplitReport", "split_seed"]


def split_seed(seed: int | None, split: str) -> int | None:
    """An independent eval seed per split name: the split's name mixed into
    the base seed (deterministic per (seed, split)), so the recurring and
    unseen draws do not share one rng stream.  ``None`` passes through."""
    if seed is None:
        return None
    return (seed * 1_000_003 + zlib.crc32(split.encode())) & 0x7FFF_FFFF


@dataclasses.dataclass
class SplitReport:
    """Adaptation-loss curves for one eval split, averaged over tasks.
    Curves have ``inner_steps + 1`` entries; index 0 is zero-shot."""
    split: str
    n_tasks: int
    centroid_curve: np.ndarray        # (steps+1,) centroid launch model
    agent_curve: np.ndarray | None    # (steps+1,) mean over per-agent models

    def to_record(self) -> dict:
        rec = {"n_tasks": self.n_tasks,
               "centroid_curve": [float(x) for x in self.centroid_curve]}
        if self.agent_curve is not None:
            rec["agent_curve"] = [float(x) for x in self.agent_curve]
        return rec


@dataclasses.dataclass
class EvalReport:
    """One EvalHarness pass: per-split adaptation curves + scalars."""
    step: int | None
    splits: dict[str, SplitReport]
    disagreement: float | None = None

    @property
    def generalization_gap(self) -> float | None:
        """Final-adapted unseen loss minus recurring loss (centroid)."""
        if not {"recurring", "unseen"} <= set(self.splits):
            return None
        return (float(self.splits["unseen"].centroid_curve[-1])
                - float(self.splits["recurring"].centroid_curve[-1]))

    def to_record(self) -> dict:
        rec: dict[str, Any] = {
            "splits": {name: s.to_record() for name, s in self.splits.items()},
        }
        if self.step is not None:
            rec["step"] = int(self.step)
        if self.disagreement is not None:
            rec["disagreement"] = float(self.disagreement)
        gap = self.generalization_gap
        if gap is not None:
            rec["generalization_gap"] = gap
        return rec


@dataclasses.dataclass
class EvalHarness:
    """Batched adapt-and-measure on ``maml.inner_adapt``.

    ``curves(params, support, query)`` — params one launch model (no agent
    axis), support/query task-leading pytrees — returns ``(n_tasks,
    inner_steps + 1)`` query-loss curves, ``torch.func.vmap`` over tasks;
    ``agent_curves`` maps the same over a leading agent axis.  Eval is never
    differentiated, so adaptation runs ``first_order=True``.
    """
    loss_fn: LossFn
    inner_lr: float
    inner_steps: int = 1
    splits: tuple[str, ...] = EVAL_SPLITS

    # -- primitives ----------------------------------------------------------

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

    def agent_curves(self, params: dict, support: Any, query: Any
                     ) -> torch.Tensor:
        """(K, n_tasks, inner_steps+1): every agent's own launch model
        measured on the same eval tasks."""
        return torch.func.vmap(self.curves, in_dims=(0, None, None))(
            params, support, query)

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

    # -- the recurring-vs-unseen protocol ------------------------------------

    def measure(self, params: dict, episode: Episode, split: str,
                per_agent: bool = False,
                prepare: Callable[[Any], Any] | None = None) -> SplitReport:
        """One split's report.  ``params`` carries a leading agent axis when
        ``per_agent`` (the centroid is its mean over that axis), otherwise
        it is the centroid itself.  The episode goes to the params' device;
        ``prepare`` post-processes (support, query)."""
        device = next(iter(params.values())).device
        support, query = to_device(host_tensors(
            (episode.support, episode.query), pin=device.type == "cuda"),
            device)
        if prepare is not None:
            support, query = prepare((support, query))
        with torch.no_grad():
            centroid = diffusion.centroid(params) if per_agent else params
            cc = self.curves(centroid, support, query).float().mean(0)
            ac = None
            if per_agent:
                ac = self.agent_curves(params, support, query).float().mean(
                    (0, 1))
        n_tasks = next(iter(support.values())).shape[0]
        return SplitReport(split, int(n_tasks), cc.cpu().numpy(),
                           None if ac is None else ac.cpu().numpy())

    def evaluate(self, state_or_params: Any, source: Any, n_tasks: int,
                 seed: int | None = None,
                 splits: tuple[str, ...] | None = None,
                 prepare: Callable[[Any], Any] | None = None) -> EvalReport:
        """The full protocol: ``n_tasks`` ``eval_sample`` episodes from each
        split of ``source``, centroid and per-agent curves, the
        generalization gap and the disagreement at eval.  Accepts a
        ``TrainState`` (``.params`` with a leading agent axis) or bare
        agent-stacked params."""
        step = None
        params = state_or_params
        if hasattr(state_or_params, "params"):
            params = state_or_params.params
            s = getattr(state_or_params, "step", None)
            step = int(s) if s is not None else None
        reports = {}
        for split in (self.splits if splits is None else splits):
            ep = source.eval_sample(n_tasks, seed=split_seed(seed, split),
                                    split=split)
            reports[split] = self.measure(params, ep, split, per_agent=True,
                                          prepare=prepare)
        return EvalReport(step, reports,
                          float(diffusion.disagreement(params)))
