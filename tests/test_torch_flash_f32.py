"""The float32 flash-attention routes to their Hopper kernels (namespace
``tf32`` of ``csrc/flash_attention.cu``: the forward, the backward and the
backward's tangent T2), on the CPU.

* The kernels' arithmetic, modelled in PyTorch (``ref.split_tf32``,
  ``ref.tf32_matmul``): every product as three TF32 products.  Through that
  model the attention gradients stay within the float32 backward tolerance
  of a float64 backward, and T2's tangents within the float32 tangent
  tolerance of ``torch.func.jvp`` of a float64 backward; one TF32 product a
  product would not.  (The forward's model is test_torch_flash_tf32_fwd.py.)
* What the wrappers hand the kernel entries: a fake library records the
  launches, so the model layout's forward, backward and T2 are seen to
  pass the caller's views in place, K/V unexpanded (by data pointer and
  strides), never to expand heads, and to get dK/dV back as (B, S, KV, d).
The kernels themselves run in test_torch_cuda.py and chip_smoke.py."""
import contextlib
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

# chip_smoke.py's FLASH_TOL[float32]["bwd"]: the kernels' gradients against
# autograd and the plain version.
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
# chip_smoke.py's TANGENT_TOL[float32]: within 1e-4 of the output's largest
# |value|.
TANGENT_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mask(S, causal, window):
    return ref.band_mask(S, S, causal, window)


def _bwd_f64(q, k, v, do, causal, window, scale):
    """The backward in float64 from float32 inputs: (dq, dk, dv, out,
    lse), out and lse rounded to float32 as the forward kernel stores
    them."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    s = torch.where(_mask(q.shape[2], causal, window),
                    qd @ kd.transpose(-1, -2) * scale, ref.NEG_INF)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = p @ vd
    dp = dod @ vd.transpose(-1, -2)
    ds = p * (dp - (dod * out).sum(-1, keepdim=True)) * scale
    return (ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod,
            out.float(), lse.float())


def _bwd_model(q, k, v, out, lse, do, causal, window, scale, products):
    """The float32 backward kernels' arithmetic: S, dP, dQ, dK and dV each
    through ``tf32_matmul`` (``products`` TF32 products a product), P, dS,
    lse and D = rowsum(dO ⊙ O) in float32."""
    mm = lambda a, b: ref.tf32_matmul(a, b, products)
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(torch.where(_mask(q.shape[2], causal, window), s,
                              ref.NEG_INF) - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (do * out).sum(-1, keepdim=True)) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _outside(got, want):
    err = (got.double() - want).abs()
    return int((err > BWD_TOL["atol"] + BWD_TOL["rtol"] * want.abs()).sum())


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)],
                         ids=["causal", "full", "window64"])
@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_gradients_meet_the_float32_tolerance(d, causal, window):
    """dq, dk and dv through the 3×TF32 model within the float32 backward
    tolerance (1e-4) of a float64 backward at head dims 64 and 128 (the
    lm-100m and qwen2 widths); one TF32 product a product, printed beside
    it, leaves elements outside — why the kernels take three."""
    rng = np.random.default_rng(d + 7 * (window or 0) + causal)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, 2, 256, d)).astype(np.float32))
        for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    *want, out, lse = _bwd_f64(q, k, v, do, causal, window, scale)
    three = _bwd_model(q, k, v, out, lse, do, causal, window, scale, 3)
    one = _bwd_model(q, k, v, out, lse, do, causal, window, scale, 1)
    err = lambda gs: max(float((g.double() - w).abs().max())
                         for g, w in zip(gs, want))
    bad3 = [_outside(g, w) for g, w in zip(three, want)]
    bad1 = [_outside(g, w) for g, w in zip(one, want)]
    print(f"d={d} causal={causal} window={window}: 3xTF32 max abs err "
          f"{err(three):.2e} ({sum(bad3)} outside {BWD_TOL}); one TF32 "
          f"product {err(one):.2e} ({sum(bad1)} outside)")
    assert bad3 == [0, 0, 0]
    assert sum(bad1) > 0 and err(one) > 10 * err(three)


def test_split_tf32_rounds_to_nearest_and_keeps_21_bits():
    """hi has no bits below TF32's 10-bit mantissa and is x rounded to
    nearest (within half a TF32 ulp, 2^-11 relative); hi + lo is within
    2^-21 of x, relative, over many magnitudes and both signs."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.uniform(-20, 20, 1 << 16)
                          ).astype(np.float32))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    assert ((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((hi.double() + lo.double() - xd).abs()
            <= 2.0 ** -21 * xd.abs()).all()
    assert torch.equal(ref.tf32_round(-x), -ref.tf32_round(x))


def _bwd64(q, k, v, out, lse, do, causal, window, scale):
    """The FlashAttention-2 backward in float64 (P from lse, D from the
    stored output): what T2 is the tangent of."""
    s = torch.where(_mask(q.shape[2], causal, window),
                    q @ k.transpose(-1, -2) * scale, ref.NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2)
              - (do * out).sum(-1, keepdim=True)) * scale
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def _t2_model(q, k, v, out, lse, do, tq, tk, tv, tout, tlse, tdo, causal,
              window, scale, products):
    """T2's kernels' arithmetic on float32 inputs: S, S', dP, dP', dQ',
    dK' and dV' each through ``tf32_matmul``; P = exp(S - lse), P' = P (S'
    - lse'), D, D', dS and dS' in float32."""
    mm = lambda a, b: ref.tf32_matmul(a, b, products)
    t = lambda x: x.transpose(-1, -2)
    mask = _mask(q.shape[2], causal, window)
    p = torch.exp(torch.where(mask, mm(q, t(k)) * scale, ref.NEG_INF)
                  - lse[..., None])
    pd = p * ((mm(tq, t(k)) + mm(q, t(tk))) * scale - tlse[..., None])
    dp = mm(do, t(v))
    dpd = mm(tdo, t(v)) + mm(do, t(tv))
    dsum = (do * out).sum(-1, keepdim=True)
    tdsum = (tdo * out + do * tout).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    dsd = pd * (dp - dsum) + p * (dpd - tdsum)
    return (scale * (mm(dsd, k) + mm(ds, tk)),
            scale * (mm(t(dsd), q) + mm(t(ds), tq)),
            mm(t(pd), do) + mm(t(p), tdo))


def _tangent_outside(got, want):
    err = (got.double() - want).abs()
    return int((err > TANGENT_REL * want.abs().max()).sum())


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)],
                         ids=["causal", "full", "window64"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_3xtf32_backward_tangent_meets_the_float32_tolerance(d, causal,
                                                             window):
    """T2's tangents (dq', dk', dv') through the 3×TF32 model within 1e-4
    of the largest |value| (``TANGENT_TOL[float32]``) of ``torch.func.jvp``
    of a float64 backward, at the point the float64 forward gives (out,
    lse and their tangents rounded to float32, as the kernels read them);
    one TF32 product a product leaves elements outside."""
    rng = np.random.default_rng(11 * d + (window or 0) + causal)
    q, k, v, do, tq, tk, tv, tdo = (torch.from_numpy(
        rng.standard_normal((1, 2, 256, d))) for _ in range(8))
    scale = 1.0 / math.sqrt(d)

    def f64_forward(q, k, v):
        s = torch.where(_mask(q.shape[2], causal, window),
                        q @ k.transpose(-1, -2) * scale, ref.NEG_INF)
        lse = torch.logsumexp(s, -1)
        return torch.exp(s - lse[..., None]) @ v, lse

    (out, lse), (tout, tlse) = torch.func.jvp(f64_forward, (q, k, v),
                                              (tq, tk, tv))
    point = tuple(t.float().double() for t in (q, k, v, out, lse, do))
    tangent = tuple(t.float().double() for t in (tq, tk, tv, tout, tlse,
                                                 tdo))
    want = torch.func.jvp(
        lambda *a: _bwd64(*a, causal, window, scale), point, tangent)[1]
    f32 = [t.float() for t in point + tangent]
    three = _t2_model(*f32, causal, window, scale, 3)
    one = _t2_model(*f32, causal, window, scale, 1)
    err = lambda gs: max(float(((g.double() - w).abs().max())
                               / w.abs().max()) for g, w in zip(gs, want))
    bad3 = [_tangent_outside(g, w) for g, w in zip(three, want)]
    bad1 = [_tangent_outside(g, w) for g, w in zip(one, want)]
    print(f"d={d} causal={causal} window={window}: 3xTF32 largest err "
          f"{err(three):.2e} of the largest |value| ({sum(bad3)} outside "
          f"{TANGENT_REL}); one TF32 product {err(one):.2e} ({sum(bad1)} "
          f"outside)")
    assert bad3 == [0, 0, 0]
    assert sum(bad1) > 0 and err(one) > 10 * err(three)


class _FakeLib:
    """Records each call of the float32 forward's, backward's and T2's C
    entries: the pointer arguments, the strides array and the scalars."""

    def __init__(self):
        self.calls = []

    def repro_flash_bwd_f32(self, *args):
        ptrs, strides, rest = args[:10], args[10], args[11:]
        self.calls.append(dict(entry="bwd", ptrs=ptrs,
                               strides=list(strides)[:24], rest=rest))
        return 0

    def repro_flash_fwd_f32(self, *args):
        ptrs, strides, rest = args[:5], args[5], args[6:]
        self.calls.append(dict(entry="fwd", ptrs=ptrs,
                               strides=list(strides)[:12], rest=rest))
        return 0

    def repro_flash_bwd_tangent(self, *args):
        ptrs, strides, rest = args[:17], args[17], args[18:]
        self.calls.append(dict(entry="tangent", ptrs=ptrs,
                               strides=list(strides)[:39], rest=rest))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' CUDA route on CPU tensors: the route forced to the
    kernels, the library replaced by a recorder, the stream and device
    context stubbed; repeat_interleave raises if anything expands heads."""
    lib = _FakeLib()
    monkeypatch.setattr(ops, "_route", lambda name, q: "cuda")
    monkeypatch.setattr(ops, "_LIB", types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_expansion(*args, **kw):
        raise AssertionError("a float32 kernel route expanded K/V heads")

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", no_expansion)
    monkeypatch.setattr(torch, "repeat_interleave", no_expansion)
    return lib


def _bsh(t, heads_dim):
    sb, s1, s2, _ = t.stride()
    return [sb, s2, s1] if heads_dim == 1 else [sb, s1, s2]


def test_model_layout_backward_hands_the_kernel_unexpanded_kv(fake_launch):
    """``gqa_flash_attention_bwd`` in float32: two launches (dQ with D,
    then dK/dV), each given q, k, v, out and dO by their own data pointers
    and (b, s, h) strides — K/V with their 2 KV heads, not 4 — and dK/dV
    allocated as (B, S, KV, d)."""
    B, S, H, KV, d = 2, 64, 4, 2, 32
    gen = torch.Generator().manual_seed(0)
    q, out, do = (torch.randn(B, S, H, d, generator=gen) for _ in range(3))
    k, v = (torch.randn(B, S, KV, d, generator=gen) for _ in "kv")
    lse = torch.randn(B, H, S, generator=gen)
    before = ops.launch_counts["flash_attention_bwd"]
    dq, dk, dv = ops.gqa_flash_attention_bwd(q, k, v, out, lse, do)
    assert ops.launch_counts["flash_attention_bwd"] == before + 2
    assert dq.shape == (B, S, H, d)
    assert dk.shape == dv.shape == (B, S, KV, d)
    calls = fake_launch.calls
    assert [c["rest"][-3] for c in calls] == [0, 1]      # dQ, then dK/dV
    for c in calls:
        ptrs = c["ptrs"]
        assert ptrs[:6] == tuple(t.data_ptr() for t in (q, k, v, out, do,
                                                        lse))
        assert ptrs[7:] == tuple(t.data_ptr() for t in (dq, dk, dv))
        views = (q, k, v, out, do, dq, dk, dv)
        assert c["strides"] == sum((_bsh(t, 2) for t in views), [])
        assert c["rest"][:6] == (B, H, KV, S, S, d)
        assert c["rest"][-2] == 1                        # 16-byte tiles


def test_heads_first_backward_reads_views_in_place(fake_launch):
    """``flash_attention_bwd`` in float32 on (B, H, S, d) views of (B, S,
    H, d) tensors (the forward's transposed output, as the autograd
    Function saves it): the same pointers, the views' own strides, no
    contiguous copy; an odd row stride turns the 16-byte tiles off."""
    B, S, H, d = 1, 48, 2, 16
    gen = torch.Generator().manual_seed(1)
    q, k, v, out, do = (torch.randn(B, S, H, d, generator=gen
                                    ).transpose(1, 2) for _ in range(5))
    lse = torch.randn(B, H, S, generator=gen)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=False, window=8)
    assert dq.shape == dk.shape == dv.shape == (B, H, S, d)
    c = fake_launch.calls[-1]
    assert c["ptrs"][:5] == tuple(t.data_ptr() for t in (q, k, v, out, do))
    assert c["strides"][:15] == sum((_bsh(t, 1) for t in
                                     (q, k, v, out, do)), [])
    assert c["rest"][7:11] == (0, 8, 1, 1)   # causal, window, part, vec
    odd = torch.randn(B, S, H, d + 1, generator=gen)[..., :d].transpose(1, 2)
    ops.flash_attention_bwd(odd, k, v, out, lse, do)
    assert fake_launch.calls[-1]["rest"][10] == 0       # element by element


def test_model_layout_forward_hands_the_kernel_unexpanded_kv(fake_launch):
    """``gqa_flash_attention_fwd_lse`` in float32: one launch of the 3×TF32
    forward, given q, k and v by their own data pointers and (b, s, h)
    strides — K/V with their 2 KV heads, not 4 — and out allocated in q's
    layout (B, S, H, d), lse as (B, H, S)."""
    B, S, H, KV, d = 2, 64, 4, 2, 32
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(B, S, H, d, generator=gen)
    k, v = (torch.randn(B, S, KV, d, generator=gen) for _ in "kv")
    before = ops.launch_counts["flash_attention_fwd"]
    out, lse = ops.gqa_flash_attention_fwd_lse(q, k, v, window=16)
    assert ops.launch_counts["flash_attention_fwd"] == before + 1
    assert out.shape == (B, S, H, d) and lse.shape == (B, H, S)
    (c,) = fake_launch.calls
    assert c["entry"] == "fwd"
    assert c["ptrs"] == tuple(t.data_ptr() for t in (q, k, v, out, lse))
    assert c["strides"] == sum((_bsh(t, 2) for t in (q, k, v, out)), [])
    assert c["rest"][:6] == (B, H, KV, S, S, d)
    assert c["rest"][7:10] == (1, 16, 1)         # causal, window, vec


def test_heads_first_forward_reads_views_in_place(fake_launch):
    """``flash_attention_fwd_lse`` in float32 on (B, H, S, d) views of (B,
    S, H, d) tensors: the views' own pointers and strides, no contiguous
    copy, out as (B, H, S, d); rows that are not 16-byte aligned turn the
    16-byte tiles off."""
    B, S, H, d = 1, 48, 2, 16
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(B, S, H, d, generator=gen).transpose(1, 2)
               for _ in range(3))
    out, lse = ops.flash_attention_fwd_lse(q, k, v, causal=False)
    assert out.shape == (B, H, S, d) and lse.shape == (B, H, S, 1)
    c = fake_launch.calls[-1]
    assert c["ptrs"][:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert c["strides"][:9] == sum((_bsh(t, 1) for t in (q, k, v)), [])
    assert c["rest"][7:10] == (0, 0, 1)          # causal, window, vec
    odd = torch.randn(B, S, H, d + 1, generator=gen)[..., :d].transpose(1, 2)
    ops.flash_attention_fwd_lse(odd, k, v)
    assert fake_launch.calls[-1]["rest"][9] == 0        # element by element


def test_float32_tangent_hands_the_kernels_views_in_place(fake_launch):
    """``flash_attention_bwd_tangent`` in float32, the model layout: two
    launches (dq' with D and D', then dk'/dv'), each given the caller's
    twelve inputs by their own data pointers and all thirteen views' (b,
    s, h) strides — K/V and their tangents with their 2 KV heads — dtype
    flag 0 (the 3×TF32 kernels), and dk'/dv' allocated as (B, S, KV, d)."""
    B, S, H, KV, d = 2, 64, 4, 2, 32
    gen = torch.Generator().manual_seed(4)
    q, out, do, tq, tout, tdo = (torch.randn(B, S, H, d, generator=gen)
                                 for _ in range(6))
    k, v, tk, tv = (torch.randn(B, S, KV, d, generator=gen)
                    for _ in range(4))
    lse, tlse = (torch.randn(B, H, S, generator=gen) for _ in "lt")
    before = ops.launch_counts["flash_attention_bwd_tangent"]
    tdq, tdk, tdv = ops.flash_attention_bwd_tangent(
        q, k, v, out, lse, do, tq, tk, tv, tout, tlse, tdo, heads_dim=2)
    assert ops.launch_counts["flash_attention_bwd_tangent"] == before + 2
    assert tdq.shape == (B, S, H, d)
    assert tdk.shape == tdv.shape == (B, S, KV, d)
    calls = fake_launch.calls
    assert [c["entry"] for c in calls] == ["tangent", "tangent"]
    assert [c["rest"][-3] for c in calls] == [0, 1]     # dq', then dk'/dv'
    views = (q, k, v, out, do, tq, tk, tv, tout, tdo, tdq, tdk, tdv)
    for c in calls:
        ptrs = c["ptrs"]
        assert ptrs[:12] == tuple(t.data_ptr() for t in (
            q, k, v, out, do, lse, tq, tk, tv, tout, tdo, tlse))
        assert ptrs[14:] == tuple(t.data_ptr() for t in (tdq, tdk, tdv))
        assert c["strides"] == sum((_bsh(t, 2) for t in views), [])
        assert c["rest"][:6] == (B, H, KV, S, S, d)
        assert c["rest"][-2] == 0                        # float32
