"""Synthetic per-domain language-model meta-tasks (port of
``repro/data/lm_tasks.py``: the same numpy sampling, so episodes are
bit-identical to the reference's for the same seeds).

The production analogue of the paper's heterogeneous agents: each agent
holds a distribution over *domains* (a "task" = a domain); a domain is a
seeded synthetic Markov source over the vocabulary.  Adapting the launch
model to a new domain with a few gradient steps is exactly the MAML setting,
at LM scale.

Sequences are generated with a light-weight order-1 Markov chain whose
transition structure is domain-seeded (deterministic given ``domain_id``),
so data is reproducible across hosts without files.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.episodes import DomainShardedSource, Episode


@dataclasses.dataclass
class LMTaskSampler:
    vocab_size: int
    seq_len: int
    n_domains: int = 64
    branching: int = 32     # out-degree of the Markov chain per state bucket
    n_buckets: int = 256    # states are token % n_buckets
    seed: int = 0

    def _domain_table(self, domain_id: int) -> np.ndarray:
        """(n_buckets, branching) allowed next-tokens for this domain."""
        rng = np.random.default_rng(self.seed * 100003 + int(domain_id))
        return rng.integers(0, self.vocab_size,
                            size=(self.n_buckets, self.branching))

    def sample_tokens(self, domain_id: int, batch: int, rng: np.random.Generator
                      ) -> np.ndarray:
        table = self._domain_table(domain_id)
        toks = np.empty((batch, self.seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        for t in range(self.seq_len):
            bucket = toks[:, t] % self.n_buckets
            choice = rng.integers(0, self.branching, size=batch)
            toks[:, t + 1] = table[bucket, choice]
        return toks

    def sample_task(self, domain_id: int, batch: int, seed: int = 0):
        """Returns {tokens, labels} of shape (batch, seq_len)."""
        rng = np.random.default_rng(seed)
        toks = self.sample_tokens(domain_id, batch, rng)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def sample_agents(self, K: int, tasks_per_agent: int, task_batch: int,
                      step: int = 0):
        """Dif-MAML step data: support/query dicts with leading
        (K, tasks_per_agent, task_batch, seq).  Agent k draws domains from
        its own shard of the domain universe (heterogeneous π_k).

        Legacy per-task python-loop path; production code uses
        :class:`LMTaskSource`, which batches all K·T·tb sequences into one
        generator pass."""
        per_agent = max(1, self.n_domains // K)
        sup_t, sup_l, qry_t, qry_l = [], [], [], []
        rng = np.random.default_rng(self.seed + 7919 * step)
        for k in range(K):
            st, sl, qt, ql = [], [], [], []
            for t in range(tasks_per_agent):
                dom = k * per_agent + int(rng.integers(0, per_agent))
                s = self.sample_task(dom, task_batch, seed=int(rng.integers(2**31)))
                q = self.sample_task(dom, task_batch, seed=int(rng.integers(2**31)))
                st.append(s["tokens"]); sl.append(s["labels"])
                qt.append(q["tokens"]); ql.append(q["labels"])
            sup_t.append(np.stack(st)); sup_l.append(np.stack(sl))
            qry_t.append(np.stack(qt)); qry_l.append(np.stack(ql))
        pack = lambda a: np.stack(a, axis=0)
        support = {"tokens": pack(sup_t), "labels": pack(sup_l)}
        query = {"tokens": pack(qry_t), "labels": pack(qry_l)}
        return support, query


@dataclasses.dataclass
class LMTaskSource(DomainShardedSource):
    """`TaskSource` view of the LM meta-task universe: a domain = one seeded
    Markov source, ``partition_domains`` gives each agent a disjoint domain
    shard (heterogeneous π_k), and ``holdout_domains`` reserves the tail of
    the universe for :meth:`eval_sample` — the recurring-vs-unseen task
    split of Fallah et al. 2021.

    Episode generation is vectorized: all K·T·2·tb sequences of a step run
    through ONE Markov-generator pass (domain transition tables stacked and
    indexed per row, all randomness pre-drawn per agent) instead of the
    K×T python loop of ``LMTaskSampler.sample_agents`` — same O(seq) chain
    recurrence, but each iteration advances every row at once and each
    domain table is built (and cached) once instead of per task.
    """
    vocab_size: int = 1024
    seq_len: int = 64
    K: int = 4
    tasks_per_agent: int = 2
    task_batch: int = 2
    n_domains: int = 64
    branching: int = 32
    n_buckets: int = 256
    holdout_domains: int = 0
    seed: int = 0
    heterogeneity: str = "domain-shards"

    def __post_init__(self):
        self.sampler = LMTaskSampler(
            vocab_size=self.vocab_size, seq_len=self.seq_len,
            n_domains=self.n_domains, branching=self.branching,
            n_buckets=self.n_buckets, seed=self.seed)
        self._stacked: np.ndarray | None = None

    @property
    def n_train_domains(self) -> int:
        return self.n_domains - self.holdout_domains

    def _tables(self) -> np.ndarray:
        """(n_domains, n_buckets, branching) stacked transition tables,
        built once and indexed by domain id per row thereafter (stacking
        per step would memcpy every table on every sample)."""
        if self._stacked is None:
            self._stacked = np.stack(
                [self.sampler._domain_table(d) for d in range(self.n_domains)]
            ).astype(np.int32)
        return self._stacked

    def _generate(self, row_dom: np.ndarray, first: np.ndarray,
                  choice: np.ndarray) -> np.ndarray:
        """One batched Markov pass: rows (R,) domains, (R,) first tokens,
        (R, seq) branch choices -> (R, seq+1) token sequences."""
        tables = self._tables()
        toks = np.empty((len(row_dom), self.seq_len + 1), dtype=np.int64)
        toks[:, 0] = first
        for t in range(self.seq_len):
            toks[:, t + 1] = tables[row_dom, toks[:, t] % self.n_buckets,
                                    choice[:, t]]
        return toks

    @staticmethod
    def _pack(toks: np.ndarray) -> dict:
        return {"tokens": toks[..., :-1].astype(np.int32),
                "labels": toks[..., 1:].astype(np.int32)}

    def sample(self, step: int) -> Episode:
        K, T, tb, S = self.K, self.tasks_per_agent, self.task_batch, self.seq_len
        rows_per_agent = T * 2 * tb          # support + query
        doms, firsts, choices = [], [], []
        for k, shard in enumerate(self.shards()):
            rng = self._rng(step, k)
            doms.append(rng.choice(shard, size=T))
            firsts.append(rng.integers(0, self.vocab_size,
                                       size=rows_per_agent))
            choices.append(rng.integers(0, self.branching,
                                        size=(rows_per_agent, S)))
        doms = np.stack(doms)                                    # (K, T)
        row_dom = np.repeat(doms.reshape(-1), 2 * tb)            # (K·T·2tb,)
        toks = self._generate(row_dom, np.concatenate(firsts),
                              np.concatenate(choices))
        folded = toks.reshape(K, T, 2 * tb, S + 1)
        return Episode(self._pack(folded[:, :, :tb]),
                       self._pack(folded[:, :, tb:]),
                       domains=doms, step=step)

    def eval_sample(self, n_tasks: int, seed: int | None = None,
                    split: str | None = None,
                    task_batch: int | None = None) -> Episode:
        """Eval tasks: ``split=None`` keeps the legacy default — held-out
        domains when ``holdout_domains > 0`` (the unseen-task split),
        otherwise the full universe; 'recurring'/'unseen' select the
        trained shards / held-out tail explicitly."""
        tb = self.task_batch if task_batch is None else task_batch
        rng = self._eval_rng(seed)
        if split is None:
            split = "unseen" if self.holdout_domains else "full"
        dom = rng.choice(self.eval_domain_pool(split), size=n_tasks)
        rows = n_tasks * 2 * tb
        toks = self._generate(np.repeat(dom, 2 * tb),
                              rng.integers(0, self.vocab_size, size=rows),
                              rng.integers(0, self.branching,
                                           size=(rows, self.seq_len)))
        folded = toks.reshape(n_tasks, 2 * tb, self.seq_len + 1)
        return Episode(self._pack(folded[:, :tb]), self._pack(folded[:, tb:]),
                       domains=dom)
