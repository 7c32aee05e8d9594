"""Adaptation at evaluation time: ``EvalHarness`` (``curves``,
``adapt_states``, ``task_loss``)."""
from repro_torch.eval.harness import EvalHarness

__all__ = ["EvalHarness"]
