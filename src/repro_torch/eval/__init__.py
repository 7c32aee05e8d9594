"""Adaptation at evaluation time (this slice: ``EvalHarness.curves``)."""
from repro_torch.eval.harness import EvalHarness

__all__ = ["EvalHarness"]
