"""Task-distribution substrate behind one `TaskSource` contract (the sine
benchmark, the few-shot classification episodes, the LM meta-tasks and the
prefetching pipeline).  The pre-`TaskSource` building blocks
(``SineTaskDistribution``, ``FewShotSampler``, ``LMTaskSampler``) stay as
the reference keeps them."""
from repro_torch.data.episodes import (AgentStream, DomainShardedSource,
                                       Episode, TaskSource, episode_rng,
                                       partition_domains)
from repro_torch.data.fewshot import FewShotSampler, FewShotTaskSource
from repro_torch.data.lm_tasks import LMTaskSampler, LMTaskSource
from repro_torch.data.pipeline import MetaBatchPipeline
from repro_torch.data.sine import (SineTaskDistribution, SineTaskSource,
                                   agent_sine_distributions)

__all__ = ["AgentStream", "DomainShardedSource", "Episode", "TaskSource",
           "episode_rng", "partition_domains", "FewShotSampler",
           "FewShotTaskSource", "LMTaskSampler", "LMTaskSource",
           "MetaBatchPipeline", "SineTaskDistribution", "SineTaskSource",
           "agent_sine_distributions"]
