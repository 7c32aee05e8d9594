"""Adaptation at evaluation time: ``EvalHarness`` (``curves``,
``agent_curves``, ``adapt_states``, ``task_loss``, and the
recurring-vs-unseen ``evaluate``) and its reports."""
from repro_torch.eval.harness import (EvalHarness, EvalReport, SplitReport,
                                      split_seed)

__all__ = ["EvalHarness", "EvalReport", "SplitReport", "split_seed"]
