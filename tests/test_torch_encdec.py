"""The encoder-decoder family of the port (whisper-large-v3) against the
JAX package's, on the reduced config in float32 with random frames and
every cross gate at 0.5 (set-up in torch_encdec_ref.py): sinusoidal
positions, specs and flat keys (also at full width, on meta tensors), the
cross-attention layers, the encoder, the forward, the loss and its
gradient, decode against the filled cross cache, the modality stubs and
input specs, and the entry points' ``--layers`` rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_encdec_ref as E
from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JaxShape
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import (LLAMA_3_2_VISION_90B, WHISPER_LARGE_V3,
                                 InputShape, get_config)
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.init import count_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return E.models(E.WHISPER)


# -- configs, plans and specs ----------------------------------------------

@pytest.mark.parametrize("arch", [E.WHISPER, E.VISION])
def test_configs_are_the_reference_configs(arch):
    """Every field of the port's config equals the reference's, full width
    and reduced (the encoder and vision rules of ``reduced``)."""
    ours = get_config(arch)
    assert ours is {E.WHISPER: WHISPER_LARGE_V3,
                    E.VISION: LLAMA_3_2_VISION_90B}[arch]
    for cfg, want in ((ours, jax_config(arch)),
                      (ours.reduced(), jax_config(arch).reduced())):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("arch,layers,count", [
    (E.WHISPER, None, 1_602_114_592), (E.WHISPER, 2, 224_860_162),
    (E.WHISPER, 4, 316_677_124), (E.VISION, None, 87_733_903_380),
    (E.VISION, 10, None)], ids=["whisper", "whisper-2+2", "whisper-4+4",
                                "vision", "vision-2-periods"])
def test_full_width_specs_match_the_reference_tree(arch, layers, count):
    """Flat keys and shapes at full width equal the reference tree's
    (``encoder/segments/0/0/attn/wq``, ``segments/0/1/gate``,
    ``vision_proj``), also under the ``--layers`` cut; the serve bundle's
    params are meta tensors of those shapes in the config's dtype."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    if layers:
        cfg = S.cut_depth(cfg, layers)
        kw = dict(num_layers=layers)
        if arch == E.WHISPER:
            kw["encoder_layers"] = layers
        jcfg = dataclasses.replace(jcfg, **kw)
    specs = T.build_model(cfg).specs()
    want = E.spec_shapes(JT.build_model(jcfg))
    assert {k: tuple(s.shape) for k, s in specs.items()} == want
    if count is not None:
        assert count_params(specs) == count
    metas = S.build_serve(cfg, InputShape("d", 8, 1, "decode")).params_specs
    assert all(t.is_meta and t.dtype == torch.bfloat16
               for t in metas.values())
    assert {k: tuple(t.shape) for k, t in metas.items()} == want
    if arch == E.WHISPER:
        n = layers or 32
        assert specs["encoder/segments/0/0/attn/wq"].shape == (n, 1280, 20,
                                                               64)
        assert specs["segments/0/1/gate"].shape == (n,)
        assert "segments/0/1/cross/bq" not in specs
        assert specs["segments/0/0/attn/bq"].shape == (n, 20, 64)
    else:
        assert specs["vision_proj"].shape == (8192, 8192)
        assert specs["segments/0/4/gate"].shape == ((layers or 100) // 5,)


@pytest.mark.parametrize("arch", [E.WHISPER, E.VISION])
def test_plans_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    plan = lambda segs: [(s.n, [(b.mixer, b.ffn) for b in s.period])
                         for s in segs]
    jm, m = JT.build_model(jcfg), T.build_model(cfg)
    assert plan(m.plan) == plan(jm.plan)
    assert m.is_encdec == jm.is_encdec == (arch == E.WHISPER)
    if arch == E.WHISPER:
        assert plan(m.enc_plan) == plan(jm.enc_plan) == [
            (32, [("attn_nc", "dense")])]
        assert plan(m.plan) == [(32, [("attn", "none"), ("cross", "dense")])]
    else:
        assert plan(m.plan) == [(20, [("attn", "dense")] * 4
                                 + [("cross", "dense")])]


def test_flat_keys_carry_the_reference_params(models):
    jm, jparams, m, params = models
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) == len(params)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: s.shape for k, s in m.specs().items()}
    assert (params["segments/0/1/gate"] == E.GATE).all()


# -- positions ----------------------------------------------------------------

@pytest.mark.parametrize("S_,d", [(16, 128), (1500, 1280), (448, 64)])
def test_sinusoidal_positions_are_the_references(S_, d):
    np.testing.assert_array_equal(L.sinusoidal_positions(S_, d),
                                  JL.sinusoidal_positions(S_, d))


def test_sinusoid_at_matches_the_reference():
    """The decode's positions, float32 from exp of an arange on both
    sides (they differ from the forward's float64 table by rounding, in
    the reference too)."""
    pos = np.array([0, 1, 3, 127, 447, 1499], np.int32)
    want = np.asarray(JT._sinusoid_at(jnp.asarray(pos), 1280))
    got = T._sinusoid_at(torch.from_numpy(pos).long(), 1280)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    table = L.sinusoidal_positions(1500, 1280)[pos]
    np.testing.assert_allclose(got.numpy(), table, rtol=0, atol=2e-4)


# -- layers -------------------------------------------------------------------

def _cross_params(models):
    """Layer 0's cross block on both sides."""
    jm, jparams, m, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0][1]["cross"])
    return jp, {k: v[0] for k, v in
                L.sub(params, "segments/0/1/cross").items()}


def test_cross_attention_layers(models):
    """``attention_apply`` with ``kv_x`` (no rope, no mask), ``cross_kv``
    and ``cross_attention_decode`` against the reference's."""
    jcfg, cfg = E.cfgs(E.WHISPER)
    jp, p = _cross_params(models)
    assert "bq" not in p and "bq" not in jp
    rng = np.random.default_rng(3)
    x = rng.standard_normal((E.BATCH, E.SEQ, 128)).astype(np.float32)
    enc = rng.standard_normal((E.BATCH, 16, 128)).astype(np.float32)
    pos = np.arange(E.SEQ)[None]
    want = JL.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              causal=False, kv_x=jnp.asarray(enc))
    got = L.attention_apply(p, cfg, E.tx({"x": x})["x"],
                            torch.from_numpy(pos), causal=False,
                            kv_x=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **E.LAYER_TOL)
    jk, jv = JL.cross_kv(jp, jnp.asarray(enc))
    k, v = L.cross_kv(p, torch.from_numpy(enc))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **E.LAYER_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **E.LAYER_TOL)
    want = JL.cross_attention_decode(jp, jcfg, jnp.asarray(x[:, :1]), jk, jv)
    got = L.cross_attention_decode(p, cfg, torch.from_numpy(x[:, :1]), k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **E.LAYER_TOL)


def test_encode_matches_the_reference(models):
    jm, jparams, m, params = models
    jcfg, cfg = E.cfgs(E.WHISPER)
    frames = E.modality(cfg, (E.BATCH,), 7)["encoder_frames"]
    want = jm.encode(jparams, jnp.asarray(frames))
    got = m.encode(params, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **E.MODEL_TOL)


def test_forward_and_loss_match_the_reference(models):
    jm, jparams, m, params = models
    b = E.batch(E.cfgs(E.WHISPER)[1])
    np.testing.assert_allclose(m.forward(params, E.tx(b)).numpy(),
                               np.asarray(jm.forward(jparams, E.jx(b))),
                               **E.MODEL_TOL)
    np.testing.assert_allclose(float(m.loss_fn(params, E.tx(b))),
                               float(jm.loss_fn(jparams, E.jx(b))),
                               rtol=1e-6)


def test_gradient_matches_the_reference(models):
    """Every leaf's gradient, the encoder's and the gates' among them, and
    each of those nonzero (the cross path carries the loss)."""
    jm, jparams, m, params = models
    b = E.batch(E.cfgs(E.WHISPER)[1], seed=4)
    want = E.flat(jax.grad(jm.loss_fn)(jparams, E.jx(b)))
    got = torch.func.grad(m.loss_fn)(params, E.tx(b))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **E.MODEL_TOL)
    for k in ("segments/0/1/gate", "segments/0/1/cross/wk",
              "encoder/segments/0/0/attn/wq", "encoder/final_norm/scale"):
        assert float(got[k].abs().max()) > 0, k


def test_decode_with_the_filled_cross_cache_matches_the_reference(models):
    """The cross blocks' K/V filled from the encoder's states, then a
    prompt token by token and a greedy continuation against the
    reference's ``decode_step``: the logits each step, the tokens picked,
    and the cache's cross K/V."""
    jm, jparams, m, params = models
    cfg = E.cfgs(E.WHISPER)[1]
    b = E.batch(cfg, seed=5)
    jenc = jm._aux(jparams, E.jx(b))["enc"]
    enc = m._aux(params, E.tx(b))["enc"]
    total = E.SEQ + 8
    jcache = jm.init_cache(E.BATCH, total, jnp.float32, params=jparams,
                           enc=jenc)
    cache = m.init_cache(E.BATCH, total, torch.float32, "cpu",
                         params=params, enc=enc)
    for key in ("0/1/ck", "0/1/cv"):
        np.testing.assert_allclose(
            cache[key].numpy(), np.asarray(jcache[0][1][key[-2:]]),
            **E.MODEL_TOL)
    tok = b["tokens"]
    jtok, ttok = jnp.asarray(tok[:, :1]), torch.from_numpy(tok[:, :1]).long()
    for t in range(total):
        jl, jcache = jm.decode_step(jparams, jcache, jtok,
                                    jnp.full((E.BATCH,), t, jnp.int32))
        lg, cache = m.decode_step(params, cache, ttok,
                                  torch.full((E.BATCH,), t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   **E.MODEL_TOL)
        if t + 1 < E.SEQ:         # the prompt, then greedy
            nxt = tok[:, t + 1:t + 2]
        else:
            nxt = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None]
            assert (torch.argmax(lg[:, 0], -1).numpy() == nxt[:, 0]).all()
        jtok, ttok = jnp.asarray(nxt), torch.from_numpy(
            np.array(nxt)).long()


# -- entry points -------------------------------------------------------------

@pytest.mark.parametrize("arch", [E.WHISPER, E.VISION])
def test_modality_extras_and_input_specs_match_the_reference(arch):
    """The zero stubs (shapes, dtype, zeros) and the train, prefill and
    decode input specs, against the reference's ``ShapeDtypeStruct``s."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    want = JS.modality_extras(jcfg, (3, 2), jnp.bfloat16)
    got = S.modality_extras(cfg, (3, 2), torch.bfloat16, "cpu")
    assert set(got) == set(want) == {E.WHISPER: {"encoder_frames"},
                                     E.VISION: {"image_patches"}}[arch]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16 and not got[k].any()
    for kind in ("train", "prefill", "decode"):
        jspecs = JS.input_specs(jcfg, JaxShape("s", 32, 4, kind))
        specs = S.input_specs(cfg, InputShape("s", 32, 4, kind))
        jflat = {
            "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): x.shape
            for path, x in jax.tree_util.tree_flatten_with_path(jspecs)[0]}
        flat = {}
        for k, v in specs.items():
            if isinstance(v, dict):
                flat.update({f"{k}/{kk}": vv for kk, vv in v.items()})
            else:
                flat[k] = v
        assert {k: tuple(v.shape) for k, v in flat.items()} == jflat
        assert all(v.is_meta for v in flat.values())


def test_layers_rule_of_the_entry_points():
    """``--layers N`` cuts whisper's encoder and decoder each to N, the
    vision model takes whole periods (a multiple of cross_attn_every) and
    raises otherwise, before anything is built; the other families cut
    their decoder."""
    from repro_torch.launch import serve, train
    w = S.cut_depth(get_config(E.WHISPER), 4)
    assert (w.num_layers, w.encoder_layers) == (4, 4)
    v = S.cut_depth(get_config(E.VISION), 10)
    assert (v.num_layers, v.encoder_layers) == (10, 0)
    assert len(T.build_model(v).plan[0].period) == 5
    q = S.cut_depth(get_config("qwen2-1.5b"), 2)
    assert (q.num_layers, q.encoder_layers) == (2, 0)
    for main in (serve.main, train.main):
        with pytest.raises(ValueError, match="multiple of cross_attn_every"):
            main(["--arch", E.VISION, "--layers", "7", "--device", "cpu"])
