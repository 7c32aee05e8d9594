"""The four dense decoder configurations ported last (qwen2-7b, its 8k
sliding-window variant qwen2-7b-swa, codeqwen1.5-7b and command-r-35b)
against the JAX package's: every field, the full-width parameter trees,
the segment plans of every LM config, and at reduced width (2 layers,
d_model 128, 4 heads over 2 KV heads of 32, vocab 512) the forward, loss,
gradient and token-by-token decode on the same numpy inputs with the
reference's weights carried across by ``from_jax_params``, in float32;
then qwen2-7b's ``maml`` train step through ``tests/torch_train_ref.py``.

Sequences of 80 tokens pass qwen2-7b-swa's reduced window of 64, so its
masked attention and its decode's ring buffer both wrap; command-r runs
LayerNorm (a bias beside each scale) and no QKV bias."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from repro.configs import get_config as jax_config
from repro.configs.base import ASSIGNED as JAX_ASSIGNED
from repro.models.transformer import build_model as jax_build
from repro.models.transformer import segment_plan as jax_plan
from repro_torch.configs import QWEN2_7B, QWEN2_7B_SWA, get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.steps import cut_depth
from repro_torch.models.init import count_params
from repro_torch.models.transformer import build_model, segment_plan

ARCHS = ["qwen2-7b", "qwen2-7b-swa", "codeqwen1.5-7b", "command-r-35b"]
# float32 on both sides: the same products summed in another order
# (tests/test_torch_lm.py's limits).
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# token-by-token decode against the full forward (tests/test_torch_moe.py)
DECODE_TOL = dict(rtol=1e-4, atol=5e-5)
BATCH, SEQ = 2, 80


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def _jax_flat(tree) -> dict:
    """The reference's spec tree as the port's flat keys."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


def _plan(plan) -> list:
    return [(s.n, tuple((d.mixer, d.ffn) for d in s.period)) for s in plan]


# -- configs and plans ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    """Every field equals the reference's, full and reduced."""
    for cfg, want in ((get_config(arch), jax_config(arch)),
                      (get_config(arch).reduced(),
                       jax_config(arch).reduced())):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name


def test_swa_is_qwen2_7b_with_a_window():
    """qwen2-7b-swa differs from qwen2-7b only in its name, window and
    citation; reduced, its window is 64."""
    diff = {f.name for f in dataclasses.fields(QWEN2_7B)
            if getattr(QWEN2_7B, f.name) != getattr(QWEN2_7B_SWA, f.name)}
    assert diff == {"name", "sliding_window", "source"}
    assert QWEN2_7B_SWA.sliding_window == 8192
    assert QWEN2_7B_SWA.reduced().sliding_window == 64


@pytest.mark.parametrize("name", JAX_ASSIGNED + ["qwen2_7b_swa"])
def test_segment_plan_is_the_reference_plan(name):
    """Every LM config of the reference's list, and the swa variant."""
    assert _plan(segment_plan(get_config(name))) == \
        _plan(jax_plan(jax_config(name)))


@pytest.mark.parametrize("arch,layers,n", [
    ("qwen2-7b", 28, 7_615_616_512), ("qwen2-7b", 2, 1_556_113_920),
    ("codeqwen1.5-7b", 32, 8_190_038_016),
    ("command-r-35b", 40, 32_381_353_984)])
def test_full_width_specs_match_the_reference(arch, layers, n):
    """Spec keys and shapes at full width (``--layers`` cut) equal the
    reference tree's; the parameter counts of the published models, and
    qwen2-7b's 2-layer cut that the card serves."""
    cfg = cut_depth(get_config(arch), layers)
    assert cfg.d_model == get_config(arch).d_model
    specs = build_model(cfg).specs()
    jspecs = jax_build(dataclasses.replace(jax_config(arch),
                                           num_layers=layers)).specs()
    assert {k: s.shape for k, s in specs.items()} == _jax_flat(jspecs)
    assert count_params(specs) == n


# -- the models at reduced width -----------------------------------------------

def _cfgs(arch, **kw):
    kw = dict(dtype="float32", attn_q_chunk=16, **kw)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jax.jit(lambda key: jm.init(key, jnp.float32))(
        jax.random.key(0))
    # the norms' ones and zeros and the zero biases made distinct, so every
    # leaf's role shows in the comparisons
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if np.ptp(np.asarray(a)) == 0 else a, jparams)
    return jm, jparams, m, _port(jparams)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(29)
    toks = rng.integers(0, 512, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_specs_and_flat_keys_match_the_reference_tree(models):
    jm, jparams, m, params = models
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) == len(params)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    assert shapes == {k: s.shape for k, s in m.specs().items()}
    cfg = m.cfg
    assert ("segments/0/0/attn/bq" in shapes) == cfg.qkv_bias
    assert ("final_norm/bias" in shapes) == (cfg.norm == "layernorm")


def test_model_forward_and_loss(models, batch):
    jm, jparams, m, params = models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(m.forward(params, tb).numpy(),
                               np.asarray(jax.jit(jm.forward)(jparams, jb)),
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
                                   err_msg=k, **GRAD_TOL)


def test_incremental_decode_matches_forward(models, batch):
    """decode_step over the KV cache, token by token, against the
    reference's full-sequence forward; qwen2-7b-swa's cache is a ring of
    64 slots that the 80 tokens wrap."""
    jm, jparams, m, params = models
    full = np.asarray(jax.jit(jm.forward)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    cache = m.init_cache(BATCH, SEQ, torch.float32, "cpu")
    ring = m.cfg.sliding_window
    assert cache["0/0/k"].shape[2] == (ring or SEQ)
    toks = _t(batch["tokens"]).long()
    outs = []
    for t in range(SEQ):
        logits, cache = m.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((BATCH,), t))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full,
                               **DECODE_TOL)


def test_window_bites_past_64_tokens(batch):
    """qwen2-7b-swa's reduced logits past its window of 64 differ from the
    same weights' under full attention, and equal them before it: the
    80-token inputs above hold the window's masking."""
    _, cfg = _cfgs("qwen2-7b-swa")
    m = build_model(cfg)
    full_attn = build_model(dataclasses.replace(cfg, sliding_window=None))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    got, ref = m.forward(params, tb), full_attn.forward(params, tb)
    torch.testing.assert_close(got[:, :64], ref[:, :64], rtol=0, atol=0)
    assert bool(((got[:, 64:] - ref[:, 64:]).abs().amax(-1) > 1e-3).all())


# -- meta-training -------------------------------------------------------------

def test_train_step_matches_reference():
    """Two ``maml`` steps of reduced qwen2-7b (exact second order), ATC on
    the ring, Adam (the config's own), the dense combine, float32:
    per-step losses and the final params (set-up and limits in
    torch_train_ref.py)."""
    steps = 2
    jcfg, cfg = R.cfgs("qwen2-7b", "float32")
    assert (cfg.meta_mode, cfg.outer_optimizer) == ("maml", "adam")
    jstep, jstate, _ = R.jax_setup(jcfg, "dense")
    bundle = R.port_bundle(cfg, "dense")
    assert (bundle.T, bundle.tb, bundle.combine_backend) == (2, 1, "dense")
    state = R.to_port(jstate)
    for ep in R.episodes(n=steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in ep.as_flat_batch().items()})
        state, m = bundle.step_fn(state, R.flat(ep))
        assert np.isfinite(float(jm["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=R.LOSS_RTOL["float32"])
    want = _port(jstate.params)
    assert int(state.step) == steps
    R.assert_params_close(state.params, want, R.PARAMS_ATOL["float32"],
                          steps)
