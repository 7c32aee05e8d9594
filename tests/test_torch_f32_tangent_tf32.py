"""The float32 tangents on the tensor cores, modelled on the CPU: T1
(namespace ``tf32`` of ``flash_attention/csrc/flash_attention.cu``) and the
SSD backward's tangent (namespace ``tbw`` of ``ssd_scan/csrc/ssd_bwd.cu``),
every product as three TF32 products (``ref.split_tf32``: hi = tf32(x)
rounded to nearest, lo = x - hi as the tensor core reads it).

* T1's arithmetic (S, S', P V, (P ⊙ S') V and P V' through
  ``ref.tf32_matmul``; P = exp(S - lse), P ⊙ S', lse' and o' = O' - lse' O
  in float32; o recomputed as P V, as the kernel does) stays within the
  float32 tangent tolerance of ``torch.func.jvp`` of a float64 forward at
  lm-100m's head dim, causal and windowed, on N(0, 1) inputs and on inputs
  sharing a mean (chip_smoke.py's SHARED_MEAN construction).
* The SSD backward's tangent: the backward's passes with every einsum
  through three TF32 products and ``torch.func.jvp`` of that (a product's
  tangent is A' B + A B', each product three TF32 products, as the kernels
  form them) stay within ``SSD_BWD_TOL[float32]`` of the same passes in
  float64, at two chunks and two groups and where seg falls past 88 within
  a chunk (dA there within STEEP_DA_REL).  The float64 passes are held
  against ``ref.tangent_bwd_chunk_ref`` (float32) first.
* One TF32 product a product (hi · hi) falls outside those tolerances:
  the three products are needed.
The kernels themselves run in test_torch_cuda.py and chip_smoke.py."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssd_scan import ref as sref

# chip_smoke.py's TANGENT_TOL[float32] and SSD_BWD_TOL[float32]: within
# 1e-4 of the output's largest |value|
TANGENT_REL = 1e-4
SSD_REL = 1e-4
# dA where seg falls past 88 within a chunk: a sum of row and column sums
# that nearly cancel (test_torch_ssd_bwd.py's limit)
STEEP_DA_REL = 1e-4
# chip_smoke.py's shared-mean construction: values sharing a mean, keys a
# direction
V_MEAN, K_DIRECTION = 4.0, 1.0
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# T1
# ---------------------------------------------------------------------------

def _t1_inputs(d, shared_mean, seed):
    """q, k, v and their tangents (1, 2, 256, d) float32, drawn with numpy;
    with ``shared_mean`` the values share a mean of V_MEAN and the keys a
    direction, so that o' = O' - lse' O is a difference of large sums."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(s)
    q, k, v, tq, tk, tv = (draw(1, 2, 256, d) for _ in range(6))
    if shared_mean:
        k, v = k + K_DIRECTION * draw(d), v + V_MEAN
    return tuple(torch.from_numpy(t.astype(np.float32))
                 for t in (q, k, v, tq, tk, tv))


def _fwd64(q, k, v, causal, window, scale):
    mask = fref.band_mask(q.shape[2], k.shape[2], causal, window)
    s = torch.where(mask, q @ k.transpose(-1, -2) * scale, fref.NEG_INF)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ v, lse


def _t1_model(q, k, v, lse, tq, tk, tv, causal, window, scale, products):
    """T1's kernel arithmetic on float32 inputs: S, S', P V, (P ⊙ S') V and
    P V' through ``tf32_matmul``; P from the saved lse; the tangent logit 0
    on the pairs the band excludes."""
    mm = lambda a, b: fref.tf32_matmul(a, b, products)
    t = lambda x: x.transpose(-1, -2)
    mask = fref.band_mask(q.shape[2], k.shape[2], causal, window)
    p = torch.exp(torch.where(mask, mm(q, t(k)) * scale, fref.NEG_INF)
                  - lse[..., None])
    ps = p * torch.where(mask, (mm(tq, t(k)) + mm(q, t(tk))) * scale, 0.0)
    tlse = ps.sum(-1)
    o = mm(p, v)
    return mm(ps, v) + mm(p, tv) - tlse[..., None] * o, tlse


def _t1_outside(d, causal, window, shared_mean, products):
    """(elements outside TANGENT_REL of o' and lse', largest error relative
    to the largest |value|) of T1's model against the float64 jvp."""
    inputs = _t1_inputs(d, shared_mean, 7 * d + causal + (window or 0)
                        + 100 * shared_mean)
    scale = 1.0 / math.sqrt(d)
    q, k, v, tq, tk, tv = (x.double() for x in inputs)
    (_, lse), want = torch.func.jvp(
        lambda q, k, v: _fwd64(q, k, v, causal, window, scale), (q, k, v),
        (tq, tk, tv))
    got = _t1_model(*inputs[:3], lse.float(), *inputs[3:], causal, window,
                    scale, products)
    bad, rel = 0, 0.0
    for g, w in zip(got, want):
        err = (g.double() - w).abs()
        bad += int((err > TANGENT_REL * w.abs().max()).sum())
        rel = max(rel, float(err.max() / w.abs().max()))
    return bad, rel


T1_CASES = [(64, True, None, False), (64, True, 64, False),
            (64, True, None, True), (64, False, None, True)]
T1_IDS = ["causal", "window64", "causal-shared-mean", "full-shared-mean"]


@pytest.mark.parametrize("d,causal,window,shared_mean", T1_CASES,
                         ids=T1_IDS)
def test_t1_3xtf32_meets_the_float32_tangent_tolerance(d, causal, window,
                                                       shared_mean):
    """o' and lse' through T1's 3×TF32 model within 1e-4 of the largest
    |value| of the float64 jvp, at lm-100m's head dim (64)."""
    bad, rel = _t1_outside(d, causal, window, shared_mean, 3)
    assert bad == 0, (bad, rel)


# ---------------------------------------------------------------------------
# the SSD backward's tangent
# ---------------------------------------------------------------------------

def _einsum3(spec, a, b, products):
    """einsum(spec, a, b) with both operands split as ``ref.split_tf32``:
    lo_a hi_b + hi_a lo_b + hi_a hi_b (``products=3``) or hi_a hi_b (1);
    ``products=None``: the einsum as it is (float64)."""
    if products is None:
        return torch.einsum(spec, a, b)
    ah, al = fref.split_tf32(a)
    bh, bl = fref.split_tf32(b)
    out = torch.einsum(spec, ah, bh)
    if products == 3:
        out = torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl) + out
    return out


class _TF32Einsum(torch.autograd.Function):
    """A product as the kernels take it, with the kernels' tangent rule:
    (A B)' = A' B + A B', each of the two products as the value's."""

    @staticmethod
    def forward(a, b, spec, products):
        return _einsum3(spec, a, b, products)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, ctx.spec, ctx.products = inputs
        ctx.save_for_forward(a, b)

    @staticmethod
    def jvp(ctx, ta, tb, *_):
        a, b = ctx.saved_tensors
        out = 0
        if ta is not None:
            out = out + _einsum3(ctx.spec, ta, b, ctx.products)
        if tb is not None:
            out = out + _einsum3(ctx.spec, a, tb, ctx.products)
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("forward mode only")


def _bwd_model(x, dt, A, Bg, Cg, gy, gs, chunk, products):
    """(dx, ddt, dA, dB, dC): the backward's three passes (``ref``'s
    algebra, the kernels' float32 order of terms) with every product
    through :class:`_TF32Einsum`; float64 inputs and ``products=None`` give
    the exact passes."""
    mm = lambda spec, a, b: _TF32Einsum.apply(a, b, spec, products)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    dtc = dt.reshape(B, nc, chunk, H)
    a = A if A.ndim == 2 else A.expand(B, H)
    segc = torch.cumsum(dtc * a[:, None, None, :], 2)
    u1 = torch.exp(segc[:, :, -1:] - segc) * dtc
    e1 = torch.exp(segc)
    ux = u1[..., None] * x.reshape(B, nc, chunk, H, P)
    eg = e1[..., None] * gy.reshape(B, nc, chunk, H, P)
    bs, cs = (t.reshape(B, nc, chunk, G, N) for t in (Bg, Cg))
    S = mm("bckgrp,bckgn->bcgrpn", ux.reshape(B, nc, chunk, G, r, P), bs)
    Lc = mm("bckgrp,bckgn->bcgrpn", eg.reshape(B, nc, chunk, G, r, P), cs)
    seg = segc.permute(0, 3, 1, 2).reshape(B, H, L)
    # pass 2: the states forward, their cotangents back
    S, Lc = (t.reshape(B, nc, H, P, N) for t in (S, Lc))
    dec = torch.exp(seg.reshape(B, H, nc, chunk)[..., -1])       # (B, H, nc)
    s, s_in = torch.zeros_like(S[:, 0]), []
    for c in range(nc):
        s_in.append(s)
        s = dec[:, :, c, None, None] * s + S[:, c]
    g, gO, sg = gs, [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        gO[c] = g
        sg[c] = (s_in[c] * g).sum((-1, -2))
        g = dec[:, :, c, None, None] * g + Lc[:, c]
    s_in, gO = torch.stack(s_in, 1), torch.stack(gO, 1)
    sg = torch.stack(sg, 1)                                       # (B, nc, H)
    # pass 3
    xs, gys = (t.reshape(B, nc, chunk, G, r, P) for t in (x, gy))
    dts = dtc.reshape(B, nc, chunk, G, r)
    sgm = seg.reshape(B, G, r, nc, chunk).permute(0, 3, 4, 1, 2)
    sin, go = (t.reshape(B, nc, G, r, P, N) for t in (s_in, gO))
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()[:, :, None,
                                                              None]
    E = torch.exp(torch.where(causal, sgm[:, :, :, None] - sgm[:, :, None],
                              -torch.inf))
    gram = mm("bcqgn,bckgn->bcqkg", cs, bs)[..., None]
    D = mm("bcqgrp,bckgrp->bcqkgr", gys, xs)
    GE = gram * E
    M = GE * dts[:, :, None]
    Z = D * E * dts[:, :, None]
    R = D * M * ~torch.eye(chunk, dtype=torch.bool)[:, :, None, None]
    w = torch.exp(sgm[:, :, -1:] - sgm)
    u = w * dts
    v = mm("bckgn,bcgrpn->bckgrp", bs, go)
    xv = (xs * v).sum(-1)
    dx = mm("bcqkgr,bcqgrp->bckgrp", M, gys) + u[..., None] * v
    wq = mm("bcqgrp,bcgrpn->bcqgrn", gys, sin)
    es = torch.exp(sgm)
    dC = (mm("bcqkgr,bckgn->bcqgrn", Z, bs) + es[..., None] * wq).sum(4)
    dB = (mm("bcqkgr,bcqgn->bckgrn", Z, cs)
          + u[..., None] * mm("bckgrp,bcgrpn->bckgrn", xs, go)).sum(4)
    T = torch.cat([u[:, :, :-1] * xv[:, :, :-1],
                   torch.zeros_like(u[:, :, -1:])], 2)
    dseg = (R.sum(3) - R.sum(2)
            + es * (cs[:, :, :, :, None] * wq).sum(-1) - T)
    end = T.sum(2) + torch.exp(sgm[:, :, -1]) * sg.reshape(
        B, nc, G, r)
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + end[:, :, None]], 2)
    rcs = dseg.flip(2).cumsum(2).flip(2)
    ddt = (GE * D).sum(2) + w * xv + a.reshape(B, 1, 1, G, r) * rcs
    dA = (dts * rcs).sum((1, 2)).reshape(B, H)
    if A.ndim == 1:
        dA = dA.sum(0)
    return (dx.reshape(B, L, H, P), ddt.reshape(B, L, H), dA,
            dB.reshape(B, L, G, N), dC.reshape(B, L, G, N))


# (B, L, H, P, N, G, chunk, steep dt): two chunks and two groups; seg
# falling by about 250 within each of two chunks
SSD_SHAPES = [(2, 256, 4, 16, 32, 2, 128, None),
              (1, 512, 2, 16, 32, 1, 256, 4.0)]
SSD_IDS = ["groups-two-chunks", "steep-seg"]


def _ssd_case(shape):
    """float32 inputs (A per sequence), cotangents and tangents, drawn with
    numpy."""
    B, L, H, P, N, G, chunk, steep = shape
    rng = np.random.default_rng(3)
    draw = lambda *s: rng.standard_normal(s)
    x = draw(B, L, H, P)
    dt = 0.5 * np.log1p(np.exp(draw(B, L, H)))
    if steep is not None:
        dt = np.full_like(dt, steep)
    A = -np.exp(0.3 * draw(H)) * (0.5 + rng.random((B, 1)))
    Bm, Cm = (0.3 * draw(B, L, G, N) for _ in "BC")
    gy, gs = draw(B, L, H, P), draw(B, H, P, N)
    args = [x, dt, A, Bm, Cm, gy, gs]
    targs = [draw(*t.shape) for t in args]
    f32 = lambda ts: [torch.from_numpy(t.astype(np.float32)) for t in ts]
    return f32(args), f32(targs), chunk, steep is not None


def _ssd_tangent(args, targs, chunk, products):
    dtype = torch.float64 if products is None else torch.float32
    cast = lambda ts: tuple(t.to(dtype) for t in ts)
    return torch.func.jvp(lambda *a: _bwd_model(*a, chunk, products),
                          cast(args), cast(targs))[1]


def _ssd_outside(got, want, steep):
    out = {}
    for name, g, w in zip(NAMES, got, want):
        rel = STEEP_DA_REL if steep and name == "dA" else SSD_REL
        out[name] = int(((g.double() - w.double()).abs()
                         > rel * w.double().abs().max()).sum())
    return out


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=SSD_IDS)
def test_ssd_tangent_float64_passes_match_the_plain_version(shape):
    """The model's passes in float64 (the yardstick below) against the
    plain tangent, ``ref.tangent_bwd_chunk_ref`` after its state and pass
    passes, in float32: within SSD_BWD_TOL[float32]."""
    args, targs, chunk, steep = _ssd_case(shape)
    want = _ssd_tangent(args, targs, chunk, None)
    S, tS, Lc, tLc, seg, tseg = sref.tangent_bwd_state_ref(
        *args[:6], *targs[:6], chunk)
    s_in, ts_in, gO, tgO, sg, tsg = sref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, args[6], targs[6], chunk)
    plain = sref.tangent_bwd_chunk_ref(*args[:6], seg, s_in, gO, sg,
                                       *targs[:6], tseg, ts_in, tgO, tsg,
                                       chunk)
    outside = _ssd_outside(plain, want, steep)
    assert not any(outside.values()), outside


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=SSD_IDS)
def test_ssd_tangent_3xtf32_meets_the_float32_tolerance(shape):
    """dx', ddt', dA', dB', dC' through the 3×TF32 model within
    SSD_BWD_TOL[float32] of the float64 passes (dA' within STEEP_DA_REL
    where seg falls steeply)."""
    args, targs, chunk, steep = _ssd_case(shape)
    want = _ssd_tangent(args, targs, chunk, None)
    got = _ssd_tangent(args, targs, chunk, 3)
    outside = _ssd_outside(got, want, steep)
    assert not any(outside.values()), outside


def test_one_tf32_product_falls_outside():
    """With one TF32 product a product (hi · hi) the models leave elements
    outside the float32 tolerances, for T1 and for the SSD tangent: the
    kernels need the three."""
    t1 = {i: _t1_outside(*case, 1)[0] for i, case in zip(T1_IDS, T1_CASES)}
    ssd = {}
    for i, shape in zip(SSD_IDS, SSD_SHAPES):
        args, targs, chunk, steep = _ssd_case(shape)
        ssd[i] = _ssd_outside(_ssd_tangent(args, targs, chunk, 1),
                              _ssd_tangent(args, targs, chunk, None), steep)
    print("one TF32 product, outside:", t1, ssd)
    assert sum(t1.values()) > 0, t1
    assert sum(sum(o.values()) for o in ssd.values()) > 0, ssd
