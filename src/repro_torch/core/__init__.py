"""Dif-MAML core: decentralized meta-learning over a graph of agents.

  - topology.py      combination matrices A, mixing rate λ₂, and per-step
                     TopologySchedules
  - maml.py          inner adaptation and the stochastic meta-gradient (eq. 4)
  - diffusion.py     combine backends over the agent axis (eq. 6b)
  - update.py        DiffusionStrategy, InnerAlgo registry, CommSchedule
  - fused.py         the fused combine-then-update outer step
  - meta_trainer.py  the InnerAlgo × DiffusionStrategy × CommSchedule
                     assembly
"""
from repro_torch.core import diffusion, maml, topology, update
from repro_torch.core.meta_trainer import (MetaConfig, TopologyConfig,
                                           TrainState, UpdateConfig,
                                           init_state, make_eval_fn,
                                           make_meta_step)

__all__ = ["MetaConfig", "TopologyConfig", "UpdateConfig", "TrainState",
           "init_state", "make_meta_step", "make_eval_fn",
           "topology", "maml", "diffusion", "update"]
