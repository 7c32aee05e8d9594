"""MLA (``repro_torch.models.layers.mla_specs``, ``mla_apply``,
``mla_decode``) against the JAX package's, on the reduced
deepseek-v2-lite-16b config in float32 (kv_lora 64, rope 16, nope 32, v 32,
4 heads): the same numpy inputs and the reference's weights carried
across."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models.init import materialize as jax_materialize
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import layers as L
from repro_torch.models.init import flatten_tree
from repro_torch.models.transformer import build_model

# float32 on both sides (tests/test_torch_lm.py's limits)
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
# gradients of a sum of squares (entries up to ~10): each leaf within
# GRAD_RTOL of its own largest |value| — the same sums in another order
GRAD_RTOL = 1e-5
BATCH, SEQ = 2, 16
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jax_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = _cfgs()
    jp = jax_materialize(JL.mla_specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def test_mla_specs_match_the_reference(mla):
    jcfg, cfg, jp, p = mla
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (128, 4, 48), "w_dkv": (128, 64), "w_kr": (128, 16),
        "w_uk": (64, 4, 32), "w_uv": (64, 4, 32), "wo": (4, 32, 128),
        "kv_norm/scale": (64,)}
    assert {k: s.shape for k, s in flatten_tree(L.mla_specs(cfg)).items()} \
        == {k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("q_chunk", [None, 8], ids=["full", "chunked"])
def test_mla_apply(mla, q_chunk):
    """Forward and the gradients of every leaf and of x, the plain
    attention full and query-chunked."""
    jcfg, cfg, jp, p = mla
    jcfg = dataclasses.replace(jcfg, attn_q_chunk=q_chunk)
    cfg = dataclasses.replace(cfg, attn_q_chunk=q_chunk)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SEQ, 128)).astype(np.float32)
    pos = np.arange(SEQ)[None]
    want = JL.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.mla_apply(p, cfg, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    jg, jgx = jax.grad(lambda a, b: jnp.sum(JL.mla_apply(
        a, jcfg, b, jnp.asarray(pos)) ** 2), argnums=(0, 1))(jp,
                                                             jnp.asarray(x))
    g, gx = torch.func.grad(lambda a, b: (L.mla_apply(
        a, cfg, b, _t(pos)) ** 2).sum(), argnums=(0, 1))(p, _t(x))
    want_g = from_jax_params(jax.tree.map(np.asarray, jg), device="cpu")
    pairs = [("x", gx.numpy(), np.asarray(jgx))] + [
        (k, g[k].numpy(), want_g[k].numpy()) for k in p]
    for k, a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_RTOL * np.abs(b).max(),
                                   err_msg=k)


def test_mla_apply_runs_the_plain_attention_by_name(mla, monkeypatch):
    """MLA's q/k head (nope + rope) is not its v head: it calls the plain
    attention directly and never ``sdpa`` (whose CUDA route is the flash
    kernels)."""
    jcfg, cfg, jp, p = mla
    calls = []
    plain = L._plain_sdpa

    def spy(q, k, v, *a, **kw):
        calls.append((q.shape[-1], v.shape[-1]))
        return plain(q, k, v, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("mla_apply reached sdpa")

    monkeypatch.setattr(L, "_plain_sdpa", spy)
    monkeypatch.setattr(L, "sdpa", refuse)
    x = torch.randn(1, SEQ, 128)
    L.mla_apply(p, cfg, x, torch.arange(SEQ)[None])
    assert calls == [(48, 32)]


def test_mla_decode_step_by_step(mla):
    """Token by token against the reference's latent-cache decode, each
    step on the caches both sides built; positions differ per row."""
    jcfg, cfg, jp, p = mla
    rng = np.random.default_rng(1)
    C = 12
    jckv = jnp.zeros((BATCH, C, 64), jnp.float32)
    jkr = jnp.zeros((BATCH, C, 16), jnp.float32)
    ckv, kr = torch.zeros(BATCH, C, 64), torch.zeros(BATCH, C, 16)
    for t in range(10):
        x = rng.standard_normal((BATCH, 1, 128)).astype(np.float32)
        pos = np.array([t, t + 2])
        want, jckv, jkr = JL.mla_decode(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos), jckv, jkr)
        got, ckv2, kr2 = L.mla_decode(p, cfg, _t(x), _t(pos), ckv, kr)
        assert ckv2 is ckv and kr2 is kr            # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
        np.testing.assert_allclose(ckv.numpy(), np.asarray(jckv),
                                   **LAYER_TOL)
        np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), **LAYER_TOL)


def test_latent_cache_holds_kv_lora_plus_rope_dims_a_token():
    """The MLA blocks' decode state is the latent cache only: (B, C, r)
    and (B, C, dr) a layer (576 numbers a token at full width, against
    H·(dn + dv) = 4096 for the expanded K/V), the reference's specs."""
    cfg = get_config(ARCH)
    jcfg = jax_config(ARCH)
    specs = build_model(dataclasses.replace(cfg, num_layers=2)).cache_specs(
        4, 256)
    assert {k: s.shape for k, s in specs.items()} == {
        "0/0/ckv": (1, 4, 256, 512), "0/0/kr": (1, 4, 256, 64),
        "1/0/ckv": (1, 4, 256, 512), "1/0/kr": (1, 4, 256, 64)}
    jspecs = jax_build(dataclasses.replace(jcfg, num_layers=2)).cache_specs(
        4, 256)
    assert [{k: s.shape for k, s in seg[0].items()} for seg in jspecs] == [
        {"ckv": (1, 4, 256, 512), "kr": (1, 4, 256, 64)}] * 2
    cache = build_model(cfg.reduced()).init_cache(2, 16, torch.float32,
                                                  "cpu")
    assert sum(v[0, 0].numel() for v in cache.values()) == 2 * 16 * (64 + 16)


def test_model_decode_with_the_latent_cache_matches_the_reference_decode():
    """The whole reduced model's decode_step against the reference's
    decode_step, token by token (capacity ample, as serving decodes one
    token a step)."""
    jcfg, cfg = _cfgs(moe_capacity_factor=4.0)
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(2), jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, 512, size=(BATCH, 8))
    jcache = jm.init_cache(BATCH, 8, jnp.float32)
    cache = m.init_cache(BATCH, 8, torch.float32, "cpu")
    for t in range(8):
        tok = toks[:, t:t + 1]
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.full((BATCH,), t, jnp.int32))
        got, cache = m.decode_step(params, cache, _t(tok).long(),
                                   torch.full((BATCH,), t))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                   **MODEL_TOL)
    np.testing.assert_allclose(cache["1/0/ckv"].numpy(),
                               np.asarray(jcache[1][0]["ckv"]), **MODEL_TOL)
