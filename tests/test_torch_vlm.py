"""The vision family of the port (llama-3.2-vision-90b: periods of self-
attention blocks and one tanh-gated cross-attention block over projected
patches) against the JAX package's, on the reduced config (10 layers, 2
periods, 16 patches, 4 heads over 2 KV heads) in float32 with random
patches and every gate at 0.5 (set-up in torch_encdec_ref.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_encdec_ref as E
from repro.models import layers as JL
from repro_torch.models import layers as L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return E.models(E.VISION)


def test_flat_keys_carry_the_reference_params(models):
    jm, jparams, m, params = models
    assert len(jax.tree_util.tree_flatten_with_path(jparams)[0]) == len(
        params)
    assert {k: tuple(v.shape) for k, v in params.items()} == E.spec_shapes(
        jm)
    assert params["segments/0/4/gate"].shape == (2,)
    assert params["vision_proj"].shape == (128, 128)
    assert "encoder/final_norm/scale" not in params


def test_gqa_cross_attention_decode(models):
    """Decode-time cross-attention against (B, 16, 2, 32) K/V read
    unexpanded for 4 query heads, against the reference's (which expands
    them)."""
    jm, jparams, m, params = models
    jcfg, cfg = E.cfgs(E.VISION)
    jp = jax.tree.map(lambda a: a[1], jparams["segments"][0][4]["cross"])
    p = {k: v[1] for k, v in L.sub(params, "segments/0/4/cross").items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((E.BATCH, 1, 128)).astype(np.float32)
    enc = rng.standard_normal((E.BATCH, 16, 128)).astype(np.float32)
    jk, jv = JL.cross_kv(jp, jnp.asarray(enc))
    k, v = L.cross_kv(p, torch.from_numpy(enc))
    assert tuple(k.shape) == (E.BATCH, 16, 2, 32)
    want = JL.cross_attention_decode(jp, jcfg, jnp.asarray(x), jk, jv)
    got = L.cross_attention_decode(p, cfg, torch.from_numpy(x), k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **E.LAYER_TOL)


def test_forward_and_loss_match_the_reference(models):
    jm, jparams, m, params = models
    b = E.batch(E.cfgs(E.VISION)[1])
    np.testing.assert_allclose(m.forward(params, E.tx(b)).numpy(),
                               np.asarray(jm.forward(jparams, E.jx(b))),
                               **E.MODEL_TOL)
    np.testing.assert_allclose(float(m.loss_fn(params, E.tx(b))),
                               float(jm.loss_fn(jparams, E.jx(b))),
                               rtol=1e-6)


def test_gradient_matches_the_reference(models):
    """Every leaf's gradient, ``vision_proj``'s and the gates' among them,
    each of those nonzero."""
    jm, jparams, m, params = models
    b = E.batch(E.cfgs(E.VISION)[1], seed=4)
    want = E.flat(jax.grad(jm.loss_fn)(jparams, E.jx(b)))
    got = torch.func.grad(m.loss_fn)(params, E.tx(b))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **E.MODEL_TOL)
    for k in ("vision_proj", "segments/0/4/gate", "segments/0/4/cross/wv"):
        assert float(got[k].abs().max()) > 0, k


def test_zero_patches_give_the_cross_path_nothing(models):
    """The reference's stub: zero patches make the cross K/V zero (the
    cross specs have no bias), so every cross weight and ``vision_proj``
    get a zero gradient, whatever the gate — on both sides."""
    jm, jparams, m, params = models
    b = E.batch(E.cfgs(E.VISION)[1], seed=6)
    b["image_patches"] = np.zeros_like(b["image_patches"])
    want = E.flat(jax.grad(jm.loss_fn)(jparams, E.jx(b)))
    got = torch.func.grad(m.loss_fn)(params, E.tx(b))
    for k in ("vision_proj", "segments/0/4/cross/wk",
              "segments/0/4/cross/wv"):
        assert not got[k].any() and not want[k].numpy().any(), k


def test_decode_with_the_filled_cross_cache_matches_the_reference(models):
    """Projected patches into the cross blocks' K/V, then the tokens one
    by one against the reference's ``decode_step`` (RoPE positions, the
    KV cache of the self-attention blocks)."""
    jm, jparams, m, params = models
    cfg = E.cfgs(E.VISION)[1]
    b = E.batch(cfg, seed=5)
    jenc = jm._aux(jparams, E.jx(b))["enc"]
    enc = m._aux(params, E.tx(b))["enc"]
    jcache = jm.init_cache(E.BATCH, E.SEQ, jnp.float32, params=jparams,
                           enc=jenc)
    cache = m.init_cache(E.BATCH, E.SEQ, torch.float32, "cpu",
                         params=params, enc=enc)
    assert tuple(cache["0/4/ck"].shape) == (2, E.BATCH, 16, 2, 32)
    np.testing.assert_allclose(cache["0/4/cv"].numpy(),
                               np.asarray(jcache[0][4]["cv"]), **E.MODEL_TOL)
    full = np.asarray(jm.forward(jparams, E.jx(b)))
    toks = torch.from_numpy(b["tokens"]).long()
    for t in range(E.SEQ):
        jl, jcache = jm.decode_step(jparams, jcache,
                                    jnp.asarray(b["tokens"][:, t:t + 1]),
                                    jnp.full((E.BATCH,), t, jnp.int32))
        lg, cache = m.decode_step(params, cache, toks[:, t:t + 1],
                                  torch.full((E.BATCH,), t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   **E.MODEL_TOL)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t],
                                   **E.MODEL_TOL)
