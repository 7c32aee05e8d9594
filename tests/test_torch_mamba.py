"""The Mamba2 family of the port (``repro_torch.models.layers`` and
``.transformer``, served by ``repro_torch.serve``) against the JAX
package's, on the reduced mamba2-130m config in float32 (2 layers, d_model
128, 16 heads of head dim 16, state 32, chunk 32): the same numpy inputs and
the reference's weights carried across with ``from_jax_params``.  On CPU
tensors ``mamba2_apply`` runs the port of the reference's jnp chunked
scan.  Sequences of 64 tokens cross two chunks, so the state is carried."""
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

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import MAMBA2_130M, get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model
from repro_torch.serve import LowRankLeaf, ServeEngine, compress_delta

ROOT = pathlib.Path(__file__).resolve().parents[1]
# float32 on both sides: the same products summed in another order.
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ADAPT_ATOL = 1e-5
BATCH, SEQ = 2, 64
P, G, B, STEPS = 32, 32, 2, 2          # the engines' geometry: 64 tokens


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
    return (dataclasses.replace(jax_config("mamba2-130m").reduced(), **kw),
            dataclasses.replace(get_config("mamba2-130m").reduced(), **kw))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jax.jit(lambda key: jm.init(key, jnp.float32))(
        jax.random.key(0))
    # the init's constant leaves (A_log, dt_bias, D and the norms' zeros
    # and ones) made distinct, so every leaf's role shows in the comparisons
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if np.ptp(np.asarray(a)) == 0 else a, jparams)
    return jm, jparams, m, _port(jparams)


def _mixer_params(models):
    """Layer 0's mixer on both sides."""
    jm, jparams, m, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0][0]["mamba"])
    return jp, {k: v[0] for k, v in
                L.sub(params, "segments/0/0/mamba").items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 512, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_full_width_config_is_the_reference_config():
    """mamba2-130m at its published width: the reference's fields, 24
    layers of 24 SSD heads (head dim 64, state 128, one group), vocab padded
    to 50432.  The published 130M ties embed and head; the reference keeps
    them as two leaves, 38.7M more."""
    want = jax_config("mamba2-130m")
    for f in dataclasses.fields(MAMBA2_130M):
        assert getattr(MAMBA2_130M, f.name) == getattr(want, f.name), f.name
    assert (MAMBA2_130M.ssm_d_inner, MAMBA2_130M.ssm_heads,
            MAMBA2_130M.padded_vocab) == (1536, 24, 50432)
    specs = build_model(MAMBA2_130M).specs()
    n = sum(int(np.prod(s.shape)) for s in specs.values())
    want_n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jax_build(want).specs(), is_leaf=lambda x: hasattr(x, "axes")))
    assert n == want_n == 167_788_992
    assert 125e6 < n - 50432 * 768 < 135e6
    assert specs["segments/0/0/mamba/w_x"].shape == (24, 768, 24, 64)
    assert "embed" in specs and "head" in specs


def test_specs_and_flat_keys_match_the_reference_tree(models):
    """A reference mamba2 tree converts to the port's spec keys and
    shapes."""
    jm, jparams, m, params = models
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) == len(params)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    assert shapes == {k: s.shape for k, s in m.specs().items()}
    assert shapes["segments/0/0/mamba/w_x"] == (2, 128, 16, 16)
    assert shapes["segments/0/0/mamba/norm/scale"] == (2, 16, 16)


def test_causal_conv_and_gated_rmsnorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, SEQ, 4, 8)).astype(np.float32)
    w = rng.standard_normal((4, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        L._causal_conv(_t(x), _t(w)).numpy(),
        _np(JL._causal_conv(jnp.asarray(x), jnp.asarray(w))), **LAYER_TOL)
    z = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.standard_normal((4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        L._gated_rmsnorm(_t(scale), _t(x), _t(z)).numpy(),
        _np(JL._gated_rmsnorm(jnp.asarray(scale), jnp.asarray(x),
                              jnp.asarray(z))), **LAYER_TOL)


def test_mamba2_apply_matches_the_reference(models):
    jcfg, cfg = _cfgs()
    jp, p = _mixer_params(models)
    x = np.random.default_rng(2).standard_normal(
        (BATCH, SEQ, 128)).astype(np.float32)
    want = jax.jit(lambda p, x: JL.mamba2_apply(p, jcfg, x))(
        jp, jnp.asarray(x))
    got = L.mamba2_apply(p, cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


def test_mamba2_decode_matches_the_reference_in_place(models):
    """Token by token against the reference's decode, each step on the
    caches both sides built; the port's caches are updated in place."""
    jcfg, cfg = _cfgs()
    jp, p = _mixer_params(models)
    rng = np.random.default_rng(3)
    ch = 16 * 16 + 2 * 32
    jconv, jssm = jnp.zeros((BATCH, 3, ch)), jnp.zeros((BATCH, 16, 16, 32))
    conv, ssm = torch.zeros(BATCH, 3, ch), torch.zeros(BATCH, 16, 16, 32)
    jdecode = jax.jit(lambda *a: JL.mamba2_decode(a[0], jcfg, *a[1:]))
    for _ in range(6):
        x = rng.standard_normal((BATCH, 1, 128)).astype(np.float32)
        want, jconv, jssm = jdecode(jp, jnp.asarray(x), jconv, jssm)
        got, c2, s2 = L.mamba2_decode(p, cfg, _t(x), conv, ssm)
        assert c2 is conv and s2 is ssm
        np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)
        np.testing.assert_allclose(conv.numpy(), _np(jconv), **LAYER_TOL)
        np.testing.assert_allclose(ssm.numpy(), _np(jssm), **LAYER_TOL)


def test_model_forward_and_loss(models, batch):
    jm, jparams, m, params = models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(m.forward(params, tb).numpy(),
                               _np(jax.jit(jm.forward)(jparams, jb)),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(m.loss_fn(params, tb)),
                               float(jax.jit(jm.loss_fn)(jparams, jb)),
                               **MODEL_TOL)


def test_loss_gradient(models, batch):
    """The gradient the inner SGD step takes, leaf by leaf."""
    jm, jparams, m, params = models
    jg = jax.jit(jax.grad(jm.loss_fn))(jparams, {k: jnp.asarray(v)
                                                 for k, v in batch.items()})
    g = torch.func.grad(m.loss_fn)(params, {k: _t(v)
                                            for k, v in batch.items()})
    want = _port(jg)
    for k in params:
        np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_incremental_decode_matches_forward(models, batch):
    """decode_step over the conv and SSM caches, token by token, against
    the reference's full-sequence forward (tests/test_decode.py's check)."""
    jm, jparams, m, params = models
    full = _np(jax.jit(jm.forward)(jparams, {k: jnp.asarray(v)
                                             for k, v in batch.items()}))
    toks = _t(batch["tokens"]).long()
    cache = m.init_cache(BATCH, SEQ, torch.float32, "cpu")
    outs = []
    for t in range(SEQ):
        logits, cache = m.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((BATCH,), t))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full,
                               rtol=1e-4, atol=1e-4)


def test_cache_is_constant_in_seq(models):
    """O(1) recurrent state (tests/test_decode.py's check), and the
    reference's cache shapes."""
    jm, _, m, _ = models
    sizes = [sum(int(np.prod(s.shape)) for s in m.cache_specs(2, n).values())
             for n in (16, 512)]
    assert sizes[0] == sizes[1]
    want = jm.cache_specs(2, 16)[0][0]
    got = m.cache_specs(2, 16)
    assert got["0/0/conv"].shape == want["conv"].shape
    assert got["0/0/ssm"].shape == want["ssm"].shape


def test_lowrank_takes_a_stacked_mamba_leaf():
    """The cache's delta compression flattens a 4-D stacked mixer leaf,
    ``w_x`` at its full width (24, 768, 24, 64), to (24·768·24, 64)."""
    gen = torch.Generator().manual_seed(0)
    shape = (24, 768, 24, 64)
    base = torch.randn(shape, generator=gen)
    u = torch.randn(24 * 768 * 24, 4, generator=gen)
    v = torch.randn(4, 64, generator=gen)
    delta = (u @ v).reshape(shape) * 1e-3
    comp = compress_delta({"w_x": base}, {"w_x": base + delta}, rank=8,
                          tol=0.3)
    leaf = comp.leaves["w_x"]
    assert isinstance(leaf, LowRankLeaf) and leaf.shape == shape
    assert leaf.u.shape == (24 * 768 * 24, 8) and leaf.v.shape == (8, 64)
    np.testing.assert_allclose(leaf.materialize().numpy(), delta.numpy(),
                               atol=1e-5, rtol=0)


# -- the engine -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(models):
    jcfg, cfg = _cfgs()
    _, jparams, _, params = models
    jeng = JaxServeEngine(jcfg, prompt_len=P, gen=G, batch=B,
                          adapt_steps=STEPS, buckets=(1, 2, 4),
                          dtype=jnp.float32)
    jeng.load_params(jparams)
    eng = ServeEngine(cfg, prompt_len=P, gen=G, batch=B, adapt_steps=STEPS,
                      buckets=(1, 2, 4), dtype=torch.float32, device="cpu")
    eng.load_params(params)
    return jeng, eng


@pytest.fixture(scope="module")
def episode(engines):
    _, eng = engines
    source = serve_cli.make_support_source(eng.cfg, P + G, B)
    return source, source.eval_sample(3, seed=3, split="full")


def test_adapt_states_match_the_reference(engines, episode):
    """Both harnesses' vmapped 2-step adaptation of the same supports."""
    jeng, eng = engines
    _, ep = episode
    jstates = jeng.harness.adapt_states(
        jeng.params, jax.tree.map(jnp.asarray, ep.support))
    states = eng.harness.adapt_states(
        eng.params, {k: torch.from_numpy(v) for k, v in ep.support.items()})
    want = _port(jstates)
    assert set(want) == set(states)
    for k, v in states.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   atol=ADAPT_ATOL, rtol=0, err_msg=k)


def test_adapt_miss_then_hit_counters(engines, episode):
    _, eng = engines
    source, ep = episode
    reqs = eng.requests_from_episode(source, ep)
    eng.cache._store.clear()
    _, m = eng.adapt(reqs)
    assert (m["misses"], m["hits"], m["buckets"]) == (3, 0, [4])
    _, m = eng.adapt(reqs)
    assert (m["misses"], m["hits"], m["buckets"]) == (0, 3, [])


def test_greedy_decode_tokens_identical(engines, episode):
    _, ep = episode
    prompt = np.asarray(ep.query["tokens"][0])[:, :P]
    jeng, eng = engines
    want, _ = jeng.decode(jeng.params, prompt)
    got, _ = eng.decode(eng.params, prompt)
    np.testing.assert_array_equal(got, want)


def test_serve_cli_on_cpu_writes_a_checked_run_log(tmp_path):
    log = tmp_path / "serve.jsonl"
    out = serve_cli.main(["--arch", "mamba2-130m", "--reduced", "--device",
                          "cpu", "--batch", str(B), "--prompt-len", str(P),
                          "--gen", str(G), "--users", "3", "--rounds", "2",
                          "--run-log", str(log)])
    assert [(m["misses"], m["hits"]) for m in out["rounds"]] == [(3, 0),
                                                                 (0, 3)]
    assert out["tokens"].shape == (B, P + G)
    rec = json.loads(log.read_text().splitlines()[-1])
    assert rec["kind"] == "serve" and rec["arch"] == "mamba2-130m"
    check = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_run_log.py"),
         "--serve", str(log)], capture_output=True, text=True, timeout=60,
        check=False)
    assert check.returncode == 0, check.stdout + check.stderr
