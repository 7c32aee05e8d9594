"""The port's serving tier (``repro_torch.serve``, ``launch.serve``), LM
task source, batched adaptation and checkpoint reader against the JAX
package's, on the reduced qwen2-1.5b config in float32 with the
reference's weights carried across."""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_centroid as jax_restore_centroid
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_config
from repro.core.meta_trainer import TrainState as JaxTrainState
from repro.data.lm_tasks import LMTaskSource as JaxLMTaskSource
from repro.launch.serve import make_support_source as jax_support_source
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import compress_delta as jax_compress_delta
from repro.serve import LowRankLeaf as JaxLowRankLeaf
from repro.serve import source_fingerprint as jax_fingerprint
from repro_torch.checkpoint import restore_centroid, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.meta_trainer import TrainState
from repro_torch.data.lm_tasks import LMTaskSource
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (LowRankLeaf, ServeEngine, compress_delta,
                               source_fingerprint)

ROOT = pathlib.Path(__file__).resolve().parents[1]
P, G, B = 4, 4, 2
STEPS = 2
# float32 both sides: the same products in another summation order
# through two inner SGD steps of a 2-layer model.
ADAPT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    kw = dict(dtype="float32")
    return (dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **kw),
            dataclasses.replace(get_config("qwen2-1.5b").reduced(), **kw))


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = _cfgs()
    jeng = JaxServeEngine(jcfg, prompt_len=P, gen=G, batch=B,
                          adapt_steps=STEPS, buckets=(1, 2, 4),
                          dtype=jnp.float32)
    jparams = jeng.model.init(jax.random.key(0), jnp.float32)
    jeng.load_params(jparams)
    eng = ServeEngine(cfg, prompt_len=P, gen=G, batch=B, adapt_steps=STEPS,
                      buckets=(1, 2, 4), dtype=torch.float32, device="cpu")
    eng.load_params(_port(jparams))
    return jeng, eng


@pytest.fixture(scope="module")
def episode(engines):
    """Three distinct domains (seed 3), as tests/test_serve.py draws."""
    jeng, eng = engines
    source = serve_cli.make_support_source(eng.cfg, P + G, B)
    ep = source.eval_sample(3, seed=3, split="full")
    assert len(set(np.asarray(ep.domains).tolist())) == 3
    return source, ep


@pytest.fixture(scope="module")
def adapted(engines, episode):
    """Both harnesses' vmapped 2-step adaptation of the same supports."""
    jeng, eng = engines
    _, ep = episode
    jstates = jeng.harness.adapt_states(
        jeng.params, jax.tree.map(jnp.asarray, ep.support))
    states = eng.harness.adapt_states(
        eng.params, {k: torch.from_numpy(v) for k, v in ep.support.items()})
    return jstates, states


# -- task source ---------------------------------------------------------------

@pytest.mark.parametrize("call", ["sample", "eval_full", "eval_recurring",
                                  "eval_unseen"])
def test_lm_task_source_episodes_are_bit_identical(call):
    kw = dict(vocab_size=512, seq_len=16, K=3, tasks_per_agent=2,
              task_batch=2, n_domains=12, holdout_domains=3, seed=5)
    jsrc, src = JaxLMTaskSource(**kw), LMTaskSource(**kw)
    if call == "sample":
        jep, ep = jsrc.sample(4), src.sample(4)
    else:
        split = call.split("_")[1]
        jep = jsrc.eval_sample(5, seed=9, split=split)
        ep = src.eval_sample(5, seed=9, split=split)
    for part in ("support", "query"):
        for k in ("tokens", "labels"):
            a, b = getattr(jep, part)[k], getattr(ep, part)[k]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jep.domains, ep.domains)


def test_source_fingerprint_and_support_source_match(engines):
    jeng, eng = engines
    jsrc = jax_support_source(jeng.cfg, P + G, B, seed=2)
    src = serve_cli.make_support_source(eng.cfg, P + G, B, seed=2)
    assert source_fingerprint(src) == jax_fingerprint(jsrc)


# -- batched adaptation ---------------------------------------------------------

def test_adapt_states_match_the_reference(adapted):
    jstates, states = adapted
    want = _port(jstates)
    assert set(want) == set(states)
    for k, v in states.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   atol=ADAPT_ATOL, rtol=0, err_msg=k)


def test_compress_delta_reconstructs_as_the_reference(engines, adapted):
    """Same per-leaf low-rank/dense decision, reconstructions within 1e-5."""
    jeng, eng = engines
    jstates, _ = adapted
    jone = jax.tree.map(lambda x: x[0], jstates)
    jcomp = jax_compress_delta(jeng.params, jone, rank=8, tol=0.3)
    comp = compress_delta(eng.params, _port(jone), rank=8, tol=0.3)
    jleaves = _port(jax.tree.map(
        lambda lf: np.asarray(lf.materialize()), jcomp.leaves,
        is_leaf=lambda x: hasattr(x, "materialize")))
    jflat = {}
    for path, lf in jax.tree_util.tree_flatten_with_path(
            jcomp.leaves, is_leaf=lambda x: hasattr(x, "materialize"))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        jflat[key] = isinstance(lf, JaxLowRankLeaf)
    assert {k: isinstance(lf, LowRankLeaf) for k, lf in
            comp.leaves.items()} == jflat
    assert any(jflat.values()) and not all(jflat.values())
    for k, lf in comp.leaves.items():
        np.testing.assert_allclose(lf.materialize().numpy(),
                                   jleaves[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert comp.dense_nbytes == jcomp.dense_nbytes
    np.testing.assert_allclose(comp.compression, jcomp.compression,
                               rtol=1e-6)


# -- the engine -----------------------------------------------------------------

def test_adapt_miss_then_hit_counters(engines, episode):
    _, eng = engines
    source, ep = episode
    reqs = eng.requests_from_episode(source, ep)
    eng.cache._store.clear()
    h0, m0 = eng.cache.hits, eng.cache.misses
    _, m = eng.adapt(reqs)
    assert m["misses"] == 3 and m["hits"] == 0 and m["buckets"] == [4]
    _, m = eng.adapt(reqs)
    assert m["hits"] == 3 and m["misses"] == 0 and m["buckets"] == []
    assert (eng.cache.hits - h0, eng.cache.misses - m0) == (3, 3)
    assert eng.cache.stats()["residents"] == 3


def test_reconstruction_drift_equals_the_reference_engines(engines, episode):
    """The drift of delta-reconstructed states (|Δ query loss|) on the
    same episode equals the JAX engine's drift within 1e-4 — the reference
    is the yardstick, not its 1e-2 pin (which the reference itself fails
    on this tree)."""
    source, ep = episode
    drifts = []
    for eng in engines:
        reqs = eng.requests_from_episode(source, ep)
        eng.cache._store.clear()
        full, m = eng.adapt(reqs)
        assert m["misses"] == 3
        rec, m = eng.adapt(reqs)
        assert m["hits"] == 3
        qry = [{k: v[i] for k, v in ep.query.items()} for i in range(3)]
        drifts.append(np.abs(np.asarray(eng.adapted_loss(full, qry))
                             - np.asarray(eng.adapted_loss(rec, qry))))
    np.testing.assert_allclose(drifts[1], drifts[0], atol=1e-4, rtol=0)


def test_greedy_decode_tokens_identical(engines, episode):
    _, ep = episode
    prompt = np.asarray(ep.query["tokens"][0])[:, :P]
    jeng, eng = engines
    want, _ = jeng.decode(jeng.params, prompt)
    got, metrics = eng.decode(eng.params, prompt)
    np.testing.assert_array_equal(got, want)
    assert metrics["prompt_tok_s"] > 0 and metrics["decode_tok_s"] > 0
    with pytest.raises(ValueError, match="prompt shape"):
        eng.decode(eng.params, np.zeros((B, P + 1), np.int32))


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_bit_for_bit(engines, tmp_path, dtype):
    """A TrainState the JAX package saved (K=3 agents) restores in the port
    to exactly the reference's centroid."""
    jeng, eng = engines
    jdt = getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    agents = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal((3,) + p.shape)
                              .astype(np.float32), jdt), jeng.params)
    jax_save_checkpoint(str(tmp_path), 7, JaxTrainState(
        jnp.zeros((), jnp.int32), agents, ()))
    like = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jdt),
                        jeng.params)
    want = _port(jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
        jax_restore_centroid(str(tmp_path), like)))
    tdt = getattr(torch, dtype)
    got = restore_centroid(str(tmp_path),
                           {k: torch.empty(v.shape, dtype=tdt, device="meta")
                            for k, v in eng.params.items()}, device="cpu")
    for k, v in got.items():
        assert v.dtype == tdt
        np.testing.assert_array_equal(v.float().numpy(), want[k].numpy())


def test_port_checkpoint_restores_in_the_reference(engines, tmp_path):
    jeng, eng = engines
    agents = {k: torch.stack([v, 2 * v, -v]) for k, v in eng.params.items()}
    save_checkpoint(str(tmp_path), 3, TrainState(0, agents, ()))
    like = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                        jeng.params)
    want = _port(jax_restore_centroid(str(tmp_path), like, step=3))
    for k, v in restore_centroid(str(tmp_path), dict(eng.params),
                                 device="cpu").items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    with pytest.raises(FileNotFoundError, match="available steps"):
        restore_centroid(str(tmp_path), dict(eng.params), step=9,
                         device="cpu")


# -- the CLI ---------------------------------------------------------------------

def test_serve_cli_on_cpu_writes_a_checked_run_log(tmp_path):
    log = tmp_path / "serve.jsonl"
    out = serve_cli.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                          "cpu", "--batch", str(B), "--prompt-len", str(P),
                          "--gen", str(G), "--users", "3", "--rounds", "2",
                          "--run-log", str(log)])
    assert [m["misses"] for m in out["rounds"]] == [3, 0]
    assert out["tokens"].shape == (B, P + G)
    rec = json.loads(log.read_text().splitlines()[-1])
    assert rec["kind"] == "serve" and rec["device"] == "cpu"
    check = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_run_log.py"),
         "--serve", str(log)], capture_output=True, text=True, timeout=60,
        check=False)
    assert check.returncode == 0, check.stdout + check.stderr
