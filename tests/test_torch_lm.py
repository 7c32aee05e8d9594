"""The dense decoder family of the port (``repro_torch.models.layers`` and
``.transformer``) against the JAX package's, on the reduced qwen2-1.5b
config in float32: the same numpy inputs and the reference's weights
carried across with ``from_jax_params``.  On CPU tensors ``layers.sdpa``
runs the port's copy of the reference's ``_sdpa``/``_sdpa_chunked``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model

# float32 on both sides: the same products summed in another order.
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    """The reduced qwen2-1.5b (2 layers, d 128, 4 heads, 2 KV heads, head
    dim 32, vocab 512) in float32, for the reference and for the port."""
    kw = dict(dtype="float32", attn_q_chunk=8, **kw)
    return (dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **kw),
            dataclasses.replace(get_config("qwen2-1.5b").reduced(), **kw))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0), jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, m, params


def _block_params(models, prefix):
    """One layer's sub-tree (layer 0) on both sides."""
    jm, jparams, m, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0][0])
    for part in prefix.split("/"):
        jp = jp[part]
    return jp, {k: v[0] for k, v in
                L.sub(params, f"segments/0/0/{prefix}").items()}


def test_specs_and_flat_keys_match_the_reference_tree(models):
    jm, jparams, m, params = models
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) == len(params)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    assert shapes == {k: s.shape for k, s in m.specs().items()}
    assert shapes["segments/0/0/attn/wq"] == (2, 128, 4, 32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply(norm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SEQ, 128)).astype(np.float32)
    p = {"scale": rng.standard_normal(128).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(128).astype(np.float32)
    want = JL.norm_apply(p, jnp.asarray(x))
    got = L.norm_apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


def test_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, SEQ, 4, 32)).astype(np.float32)
    pos = np.arange(SEQ)[None] + np.array([[0], [5]])
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.rope(_t(x), _t(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("q_chunk", [None, 8], ids=["full", "chunked"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)],
                         ids=["causal", "window5", "bidirectional"])
def test_sdpa(q_chunk, causal, window):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((BATCH, SEQ, 4, 32)).astype(np.float32)
               for _ in "qkv")
    kw = dict(causal=causal, window=window, q_chunk=q_chunk)
    want = JL.sdpa(*(jnp.asarray(a) for a in (q, k, v)), 0.17, **kw)
    got = L.sdpa(_t(q), _t(k), _t(v), 0.17, **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_attention_apply(models, window):
    jcfg, cfg = _cfgs(sliding_window=window)
    jp, p = _block_params(models, "attn")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, SEQ, 128)).astype(np.float32)
    pos = np.arange(SEQ)[None]
    want = JL.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention_apply(p, cfg, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("window", [None, 4], ids=["dense", "ring4"])
def test_attention_decode(models, window):
    """Token by token against the reference's decode, each step on the
    cache both sides built; a window of 4 over 10 steps wraps the ring
    buffer."""
    jcfg, cfg = _cfgs(sliding_window=window)
    jp, p = _block_params(models, "attn")
    rng = np.random.default_rng(4)
    C = window or 11
    jk = jv = jnp.zeros((BATCH, C, 2, 32), jnp.float32)
    ck, cv = torch.zeros(BATCH, C, 2, 32), torch.zeros(BATCH, C, 2, 32)
    for t in range(10):
        x = rng.standard_normal((BATCH, 1, 128)).astype(np.float32)
        pos = np.array([t, t + 1])
        want, jk, jv = JL.attention_decode(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), jk, jv)
        got, ck, cv = L.attention_decode(p, cfg, _t(x), _t(pos), ck, cv)
        np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)
        np.testing.assert_allclose(ck.numpy(), _np(jk), **LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act):
    jcfg, cfg = _cfgs(mlp_act=act)
    rng = np.random.default_rng(5)
    specs = JL.mlp_specs(jcfg)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.1
         for k, s in specs.items()}
    assert {k: s.shape for k, s in L.mlp_specs(cfg).items()} == \
        {k: s.shape for k, s in specs.items()}
    x = rng.standard_normal((BATCH, SEQ, 128)).astype(np.float32)
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    got = L.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 512, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_model_forward_and_loss(models, batch):
    jm, jparams, m, params = models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(m.forward(params, tb).numpy(),
                               _np(jm.forward(jparams, jb)), **MODEL_TOL)
    np.testing.assert_allclose(float(m.loss_fn(params, tb)),
                               float(jm.loss_fn(jparams, jb)), **MODEL_TOL)


def test_loss_gradient(models, batch):
    """The gradient the inner SGD step takes, leaf by leaf."""
    jm, jparams, m, params = models
    jg = jax.grad(jm.loss_fn)(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    g = torch.func.grad(m.loss_fn)(params, {k: _t(v)
                                            for k, v in batch.items()})
    want = from_jax_params(jax.tree.map(np.asarray, jg), device="cpu")
    for k in params:
        np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_incremental_decode_matches_forward(models, batch):
    """decode_step over the KV cache, token by token, against the
    reference's full-sequence forward (tests/test_decode.py's check)."""
    jm, jparams, m, params = models
    full = _np(jm.forward(jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()}))
    toks = _t(batch["tokens"]).long()
    cache = m.init_cache(BATCH, SEQ, torch.float32, "cpu")
    outs = []
    for t in range(SEQ):
        logits, cache = m.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((BATCH,), t))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full,
                               **MODEL_TOL)


def test_other_families_raise():
    """Every config of the reference's list (and qwen2-7b-swa) resolves in
    the port, under either spelling of its name; an unknown name raises
    and lists the port's configs, and so does an ``arch_type`` the port
    has no plan for."""
    for name in jax_list_archs(include_paper=True) + ["qwen2_7b_swa"]:
        cfg = get_config(name)
        assert cfg.name == jax_config(name).name
        assert get_config(cfg.name) is cfg
    with pytest.raises(ValueError, match="unknown config 'qwen3-8b'.*"
                                         "jamba_1_5_large_398b"):
        get_config("qwen3-8b")
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              arch_type="diffusion")
    with pytest.raises(ValueError, match="arch_type 'diffusion'"):
        build_model(cfg)
