"""Task-distribution substrate behind one `TaskSource` contract (the sine
benchmark, the LM meta-tasks and the prefetching pipeline)."""
from repro_torch.data.episodes import (AgentStream, DomainShardedSource,
                                       Episode, TaskSource, episode_rng,
                                       partition_domains)
from repro_torch.data.lm_tasks import LMTaskSampler, LMTaskSource
from repro_torch.data.pipeline import MetaBatchPipeline
from repro_torch.data.sine import SineTaskSource

__all__ = ["AgentStream", "DomainShardedSource", "Episode", "TaskSource",
           "episode_rng", "partition_domains", "LMTaskSampler",
           "LMTaskSource", "MetaBatchPipeline", "SineTaskSource"]
