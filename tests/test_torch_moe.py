"""The MoE family of the port (``repro_torch.models.layers`` MoE functions,
the ``moe`` plans of ``.transformer``, the deepseek-v2-lite-16b and
mixtral-8x22b configs) against the JAX package's: the same numpy inputs
and the reference's weights carried across with ``from_jax_params``, at
reduced width, in float32 (bfloat16 for the model forward).

Router inputs are float32 draws from a seeded numpy generator: they hold
no exact ties, where ``torch.topk`` and ``lax.top_k`` may order equal
probabilities differently."""
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
from repro.models.transformer import segment_plan as jax_plan
from repro_torch.configs import (DEEPSEEK_V2_LITE_16B, MIXTRAL_8X22B,
                                 get_config)
from repro_torch.convert import from_jax_params
from repro_torch.models import layers as L
from repro_torch.models.init import count_params
from repro_torch.models.transformer import (BlockDesc, Segment, build_model,
                                            segment_plan)

# float32 on both sides: the same products summed in another order
# (tests/test_torch_lm.py's limits).
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
# gradients: a few more sums in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# bfloat16 on both sides: each product rounded to bf16 in another order,
# through two layers of six (MLA) or four (attention) chained products and
# the experts': the logits against the largest |value| of their row
# (measured: 1.7e-2 deepseek, 5.7e-3 mixtral), the loss relative
# (tests/torch_train_ref.py's bf16 LOSS_RTOL).
BF16_ATOL = 2 ** -5
BF16_LOSS_RTOL = 2e-3
BATCH, SEQ = 2, 16
ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x22b"]


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


def _moe_cfgs(E=4, k=2, cap=8.0, shared=0, dispatch="sorted"):
    """The reference's tests/test_moe.py MoE config (reduced mixtral, d 32,
    expert hidden 16) in both packages, float32."""
    kw = dict(num_experts=E, experts_per_token=k, moe_capacity_factor=cap,
              d_model=32, moe_d_ff=16, d_ff=16, num_shared_experts=shared,
              moe_dispatch=dispatch, dtype="float32")
    return (dataclasses.replace(jax_config("mixtral-8x22b").reduced(), **kw),
            dataclasses.replace(get_config("mixtral-8x22b").reduced(), **kw))


def _moe_params(jcfg, seed=0):
    jp = jax_materialize(JL.moe_specs(jcfg), jax.random.key(seed))
    return jp, _port(jp)


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_config_is_the_reference_config(arch):
    """Every field of the port's config equals the reference's; so do the
    reduced variants (the MoE and MLA rules of ``reduced``)."""
    ours = get_config(arch)
    assert ours is {"deepseek-v2-lite-16b": DEEPSEEK_V2_LITE_16B,
                    "mixtral-8x22b": MIXTRAL_8X22B}[arch]
    for cfg, want in ((ours, jax_config(arch)),
                      (ours.reduced(), jax_config(arch).reduced())):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        assert cfg.moe_hidden == want.moe_hidden


@pytest.mark.parametrize("arch,layers", [("deepseek-v2-lite-16b", 27),
                                         ("deepseek-v2-lite-16b", 2),
                                         ("mixtral-8x22b", 1)])
def test_full_width_parameter_counts_match_the_reference(arch, layers):
    """Spec keys and shapes at full width equal the reference tree's:
    deepseek 15.71 B at 27 layers (the published 16 B), 1.085 B at the
    2-layer cut; one full-width mixtral layer 2.907 B with its embedding
    and head."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    jcfg = dataclasses.replace(jax_config(arch), num_layers=layers)
    specs = build_model(cfg).specs()
    jspecs = jax_build(jcfg).specs()
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): s.shape
             for path, s in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {k: s.shape for k, s in specs.items()} == jflat
    n = count_params(specs)
    if arch == "deepseek-v2-lite-16b" and layers == 27:
        assert 15.6e9 < n < 15.8e9
        assert specs["segments/1/0/ffn/w1"].shape == (26, 64, 2048, 1408)
        assert specs["segments/1/0/ffn/shared/w1"].shape == (26, 2048, 2816)
        assert specs["segments/0/0/ffn/w1"].shape == (1, 2048, 10944)
        assert specs["segments/0/0/mla/kv_norm/scale"].shape == (1, 512)
    elif arch == "deepseek-v2-lite-16b":
        assert 1.08e9 < n < 1.09e9
    else:
        assert 2.90e9 < n < 2.91e9
        assert specs["segments/0/0/ffn/w1"].shape == (1, 8, 6144, 16384)


def test_plans_of_the_moe_family():
    assert segment_plan(get_config("mixtral-8x22b")) == [
        Segment(56, (BlockDesc("attn", "moe"),))]
    assert segment_plan(get_config("deepseek-v2-lite-16b")) == [
        Segment(1, (BlockDesc("mla", "dense"),)),
        Segment(26, (BlockDesc("mla", "moe"),))]
    cut = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=2)
    assert [s.n for s in segment_plan(cut)] == [1, 1]


# -- routing ---------------------------------------------------------------------

ROUTE_CASES = {
    # (G tokens, E experts, k choices, C slots an expert)
    "ample": (16, 4, 2, 16),
    "tight": (32, 4, 2, 5),
    "one_slot": (24, 8, 2, 1),
    "deepseek": (64, 64, 6, 7),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_group_buffers_equal_the_reference(case):
    """The token buffers equal the reference's exactly (the same pairs
    kept, in the same slots; the same pairs dropped), the weights within
    LAYER_TOL; batched over three groups at once."""
    G, E, k, C = ROUTE_CASES[case]
    logits = np.random.default_rng(len(case)).standard_normal(
        (3, G, E)).astype(np.float32)
    tok, w = L._route_group(_t(logits), k, E, C)
    for g in range(3):
        jtok, jw = JL._route_group(jnp.asarray(logits[g]), k, E, C)
        np.testing.assert_array_equal(tok[g].numpy(), np.asarray(jtok))
        np.testing.assert_allclose(w[g].numpy(), np.asarray(jw), **LAYER_TOL)
    kept = (tok < G).sum().item()
    assert kept <= 3 * E * C
    if case == "ample":
        assert kept == 3 * G * k
    else:
        assert kept < 3 * G * k


def test_route_group_respects_capacity_when_all_tokens_pick_one_expert():
    """The reference's capacity case: every token prefers expert 0; only C
    pairs are kept, the first C tokens in order."""
    G, E, k, C = 32, 2, 1, 4
    logits = np.stack([np.ones(G) * 10, np.zeros(G)], 1).astype(np.float32)
    tok, w = L._route_group(_t(logits), k, E, C)
    jtok, jw = JL._route_group(jnp.asarray(logits), k, E, C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **LAYER_TOL)
    assert tok[:C].tolist() == list(range(C))
    assert int((w > 0).sum()) == C


def test_route_group_slots_equal_the_one_hot_cumsum():
    """Each kept pair's slot within its expert (the sorted path's
    searchsorted) is the exclusive cumsum of the one-hot over the pairs in
    token order, the einsum path's rule: the same integers."""
    G, E, k, C = 40, 8, 3, 100
    logits = _t(np.random.default_rng(7).standard_normal(
        (G, E)).astype(np.float32))
    tok, _ = L._route_group(logits, k, E, C)
    top_e = torch.topk(torch.softmax(logits, -1), k).indices.reshape(-1)
    oh = (top_e[:, None] == torch.arange(E)).long()
    slot = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)
    want = torch.full((E * C,), G)
    want[top_e * C + slot] = torch.arange(G).repeat_interleave(k)
    assert torch.equal(tok, want)


def test_route_group_under_vmap_equals_the_batched_call():
    G, E, k, C = 16, 4, 2, 6
    logits = _t(np.random.default_rng(8).standard_normal(
        (5, G, E)).astype(np.float32))
    tok, w = L._route_group(logits, k, E, C)
    vtok, vw = torch.func.vmap(lambda x: L._route_group(x, k, E, C))(logits)
    assert torch.equal(vtok, tok)
    assert torch.equal(vw, w)


# -- the MoE layer -----------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cap", [8.0, 1.25, 0.3], ids=["ample", "tight",
                                                        "drop"])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 1)])
def test_moe_apply_sorted_forward_and_gradients(E, k, cap, shared):
    """Forward and the gradients with respect to x, the router and the
    experts (and the shared experts) against the reference's sorted
    dispatch."""
    jcfg, cfg = _moe_cfgs(E=E, k=k, cap=cap, shared=shared)
    jp, p = _moe_params(jcfg)
    x = np.random.default_rng(9).standard_normal(
        (BATCH, SEQ, 32)).astype(np.float32)
    want = JL.moe_apply(jp, jcfg, jnp.asarray(x))
    got = L.moe_apply(p, cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)

    cot = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)
    jgp, jgx = jax.grad(lambda a, b: jnp.sum(
        JL.moe_apply(a, jcfg, b) * cot), argnums=(0, 1))(jp, jnp.asarray(x))
    gp, gx = torch.func.grad(lambda a, b: (L.moe_apply(a, cfg, b)
                                           * _t(cot)).sum(),
                             argnums=(0, 1))(p, _t(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    wantp = _port(jgp)
    assert set(gp) == set(wantp)
    for key in gp:
        np.testing.assert_allclose(gp[key].numpy(), wantp[key].numpy(),
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("cap", [8.0, 1.0], ids=["ample", "tight"])
def test_moe_apply_einsum_forward_and_gradients(cap):
    """The GShard one-hot dispatch over two groups of 8 tokens against the
    reference's, forward and gradients."""
    jcfg, cfg = _moe_cfgs(cap=cap, shared=1)
    jp, p = _moe_params(jcfg, seed=1)
    x = np.random.default_rng(11).standard_normal(
        (BATCH, SEQ, 32)).astype(np.float32)
    want = JL.moe_apply_einsum(jp, jcfg, jnp.asarray(x), group_size=8)
    got = L.moe_apply_einsum(p, cfg, _t(x), group_size=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    jg = jax.grad(lambda a: jnp.sum(JL.moe_apply_einsum(
        a, jcfg, jnp.asarray(x), group_size=8) ** 2))(jp)
    g = torch.func.grad(lambda a: (L.moe_apply_einsum(
        a, cfg, _t(x), group_size=8) ** 2).sum())(p)
    wantg = _port(jg)
    for key in ("router", "w1", "w2", "w3"):
        np.testing.assert_allclose(g[key].numpy(), wantg[key].numpy(),
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("dispatch", ["einsum", "auto"])
def test_moe_apply_dispatch_rule_at_1024_tokens(dispatch):
    """``moe_apply``'s dispatch rule at a length that divides 1024:
    ``einsum`` takes the one-hot path, ``auto`` the one its flop ratio
    picks (sorted, at k=2 and expert hidden 16); both as the reference."""
    jcfg, cfg = _moe_cfgs(cap=1.25, shared=1, dispatch=dispatch)
    jp, p = _moe_params(jcfg, seed=2)
    x = np.random.default_rng(12).standard_normal(
        (1, 1024, 32)).astype(np.float32)
    want = JL.moe_apply(jp, jcfg, jnp.asarray(x))
    got = L.moe_apply(p, cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_einsum_equals_sorted_under_ample_capacity():
    jcfg, cfg = _moe_cfgs(E=8, k=2, cap=8.0)
    _, p = _moe_params(jcfg, seed=3)
    x = _t(np.random.default_rng(13).standard_normal(
        (BATCH, SEQ, 32)).astype(np.float32))
    np.testing.assert_allclose(
        L.moe_apply_einsum(p, cfg, x, group_size=SEQ).numpy(),
        L.moe_apply_sorted(p, cfg, x).numpy(), **LAYER_TOL)


def test_moe_load_balance_loss():
    jcfg, cfg = _moe_cfgs(E=8, k=2)
    jp, p = _moe_params(jcfg, seed=4)
    x = np.random.default_rng(14).standard_normal(
        (BATCH, SEQ, 32)).astype(np.float32)
    want = float(JL.moe_load_balance_loss(jp, jcfg, jnp.asarray(x)))
    got = float(L.moe_load_balance_loss(p, cfg, _t(x)))
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    assert got >= 0.0


def test_moe_vmap_of_grad_equals_the_per_user_grads():
    """The serving dispatch's transform (vmap over users of grad) through
    the sorted dispatch's sort, searchsorted, gather and scatters."""
    jcfg, cfg = _moe_cfgs(cap=1.25, shared=1)
    _, p = _moe_params(jcfg, seed=5)
    xs = _t(np.random.default_rng(15).standard_normal(
        (3, BATCH, SEQ, 32)).astype(np.float32))

    def loss(params, x):
        return (L.moe_apply(params, cfg, x) ** 2).mean()

    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(p,
                                                                       xs)
    for u in range(3):
        one = torch.func.grad(loss)(p, xs[u])
        for key in one:
            torch.testing.assert_close(batched[key][u], one[key],
                                       rtol=1e-5, atol=1e-7)


def test_record_routes_collects_each_moe_call():
    jcfg, cfg = _moe_cfgs(E=8, k=2)
    _, p = _moe_params(jcfg, seed=6)
    x = _t(np.random.default_rng(16).standard_normal(
        (BATCH, SEQ, 32)).astype(np.float32))
    with L.record_routes() as routes:
        L.moe_apply(p, cfg, x)
        L.moe_apply(p, cfg, x)
    assert len(routes) == 2 and routes[0].shape == (BATCH, SEQ, 2)
    assert torch.equal(routes[0], routes[1])
    L.moe_apply(p, cfg, x)
    assert len(routes) == 2


# -- the models ------------------------------------------------------------------------

def _model_cfgs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, attn_q_chunk=8, **kw)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _model_cfgs(request.param)
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0), jnp.float32)
    return jm, jparams, m, _port(jparams)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(17)
    toks = rng.integers(0, 512, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_specs_and_flat_keys_match_the_reference_tree(models):
    jm, jparams, m, params = models
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) == len(params)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: s.shape for k, s in m.specs().items()}
    assert any(k.endswith("ffn/router") for k in params)


def test_model_forward_and_loss(models, batch):
    jm, jparams, m, params = models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(m.forward(params, tb).numpy(),
                               np.asarray(jm.forward(jparams, jb)),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(m.loss_fn(params, tb)),
                               float(jm.loss_fn(jparams, jb)), **MODEL_TOL)


def test_loss_gradient(models, batch):
    """The gradient the inner SGD step takes, leaf by leaf."""
    jm, jparams, m, params = models
    jg = jax.grad(jm.loss_fn)(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    g = torch.func.grad(m.loss_fn)(params, {k: _t(v)
                                            for k, v in batch.items()})
    want = _port(jg)
    for k in params:
        np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_forward(arch, batch):
    """bfloat16 weights and activations on both sides, the router in
    float32: the logits within BF16_ATOL of each row's largest |value|,
    the loss within BF16_LOSS_RTOL."""
    jcfg, cfg = _model_cfgs(arch, "bfloat16")
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0), jnp.bfloat16)
    params = _port(jparams)
    assert params["embed"].dtype == torch.bfloat16
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want = np.asarray(jm.forward(jparams, jb)).astype(np.float32)
    got = m.forward(params, tb).float()
    scale = np.abs(want).max(-1, keepdims=True)
    assert np.all(np.abs(got.numpy() - want) <= BF16_ATOL * scale)
    np.testing.assert_allclose(float(m.loss_fn(params, tb)),
                               float(jm.loss_fn(jparams, jb)),
                               rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_forward(arch, batch):
    """decode_step over the decode caches (MLA's latent cache for
    deepseek, the ring buffer for mixtral's window), token by token,
    against the reference's full-sequence forward with no capacity drops
    (tests/test_decode.py's setting)."""
    kw = dict(moe_capacity_factor=4.0)
    if arch == "mixtral-8x22b":
        kw["sliding_window"] = 8
    jcfg, cfg = _model_cfgs(arch, **kw)
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(1), jnp.float32)
    params = _port(jparams)
    full = np.asarray(jm.forward(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()}))
    toks = _t(batch["tokens"]).long()
    cache = m.init_cache(BATCH, SEQ, torch.float32, "cpu")
    outs = []
    for t in range(SEQ):
        logits, cache = m.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((BATCH,), t))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full,
                               atol=5e-5, rtol=1e-4)


def test_hybrid_and_other_families_still_raise():
    """The MoE-in-a-period rule of the hybrid plan against the reference's:
    jamba's MoE FFN on the odd places of its period of 8, and reduced
    mixtral's blocks laid out as hybrid periods (every third place, from
    the second; no experts: every FFN dense)."""
    def plan(p):
        return [(s.n, tuple((d.mixer, d.ffn) for d in s.period)) for s in p]

    jamba = get_config("jamba-1.5-large-398b")
    assert [d.ffn for d in segment_plan(jamba)[0].period] == \
        ["dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"]
    assert plan(segment_plan(jamba)) == plan(jax_plan(
        jax_config("jamba-1.5-large-398b")))
    mixtral = [dict(), dict(num_experts=0)]
    wants = [["moe", "dense", "dense", "moe", "dense"], ["dense"] * 5]
    for kw, want in zip(mixtral, wants):
        kw.update(arch_type="hybrid", num_layers=12, attn_every=6,
                  moe_every=3, moe_offset=1)
        cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                                  **kw)
        jcfg = dataclasses.replace(jax_config("mixtral-8x22b").reduced(),
                                   **kw)
        assert plan(segment_plan(cfg)) == plan(jax_plan(jcfg))
        assert segment_plan(cfg)[0].n == 2
        assert [d.ffn for d in segment_plan(cfg)[0].period[1:]] == want
