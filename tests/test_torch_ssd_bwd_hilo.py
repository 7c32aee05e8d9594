"""The bfloat16 SSD backward's rounding (``ssd_scan_bwd`` and
``ssd_scan_bwd_tangent`` on the tensor cores, namespace ``hbw`` of
``csrc/ssd_bwd.cu``), modelled in plain torch on the CPU and held against
the float32 plain passes within the tolerance that ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels to.

The model takes what the kernels take and rounds where they round: bf16
inputs x, gy, B and C, whose products are exact in float32; float32 sums;
the float32 intermediates that enter a product — u·x and e·gy in the
state pass, M and Z in the chunk pass, and the states gO and s_in — as two
bf16 halves, hi = bf16(v) and lo = bf16(v - hi); D, G, R and the row sums
in float32; dx, dB and dC rounded to bf16 at the end.  The tangent is
``torch.func.jvp`` of the model: the tangent of a pair of halves is the
pair of halves of the tangent, as the kernels split M', Z', gO' and s_in'.

Without the lo halves (each intermediate rounded once to bf16) the same
check must fail: ddt and dA are float32 results held within 1e-4 of their
largest |value|, and the state terms they carry (w_k x_k·(gO B_k) and
e_q C_q·(gy_q s_in)) keep only 8 bits of gO and s_in then.
"""
import pytest
import torch

from repro_torch.kernels.ssd_scan import ref

# chip_smoke.py's SSD_BWD_TOL: (rtol, share of the largest |value|), by the
# plain version's dtype (dx, dB, dC bf16; ddt, dA float32)
SSD_BWD_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (1.6e-2, 2.0 ** -8)}
# dA where seg falls past 88 within a chunk (test_torch_ssd_bwd.py's)
STEEP_DA_REL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (B, L, H, P, N, G, chunk, steep dt): two groups and two chunks; seg
# falling by about 250 within each of two chunks
SHAPES = [(2, 256, 4, 16, 32, 2, 128, None), (1, 512, 2, 16, 32, 1, 256, 4.0)]
IDS = ["groups-two-chunks", "steep-seg"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _halves(v, lo: bool):
    """v as the tensor core reads it: bf16(v) + bf16(v - bf16(v)), or bf16(v)
    alone."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float() if lo else hi


def bwd_model(x, dt, A, Bg, Cg, gy, gs, chunk, lo=True):
    """(dx, ddt, dA, dB, dC) as the bf16 kernels round them: the plain
    passes of ``ref`` with the operands of each product rounded as the
    kernels give them to the tensor cores."""
    h = lambda v: _halves(v, lo)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    # pass 1: S = (u x)^T B, Lc = (e gy)^T C, the scaled operands split
    dtc = dt.float().reshape(B, nc, chunk, H)
    segc = torch.cumsum(dtc * ref._per_sequence(A, B)[:, None, None, :], 2)
    u1 = torch.exp(segc[:, :, -1:] - segc) * dtc
    e1 = torch.exp(segc)
    ux = h(u1[..., None] * x.float().reshape(B, nc, chunk, H, P))
    eg = h(e1[..., None] * gy.float().reshape(B, nc, chunk, H, P))
    bs, cs = (t.float().reshape(B, nc, chunk, G, N) for t in (Bg, Cg))
    S = torch.einsum("bckgrp,bckgn->bcgrpn",
                     ux.reshape(B, nc, chunk, G, r, P), bs)
    Lc = torch.einsum("bckgrp,bckgn->bcgrpn",
                      eg.reshape(B, nc, chunk, G, r, P), cs)
    seg = segc.permute(0, 3, 1, 2).reshape(B, H, L)
    # pass 2 in float32
    s_in, gO, sg = ref.bwd_state_pass_ref(S.reshape(B, nc, H, P, N),
                                          Lc.reshape(B, nc, H, P, N), seg,
                                          gs, chunk)
    # pass 3: ref.bwd_chunk_ref with M, Z, gO and s_in split
    xs, gys = (ref._chunked(t, B, nc, chunk, G) for t in (x, gy))
    dts = dtc.reshape(B, nc, chunk, G, r)
    sgm = seg.reshape(B, G, r, nc, chunk).permute(0, 3, 4, 1, 2)
    sin, go = (t.reshape(B, nc, G, r, P, N) for t in (s_in, gO))
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()[:, :, None,
                                                              None]
    E = torch.exp(torch.where(causal, sgm[:, :, :, None] - sgm[:, :, None],
                              -torch.inf))
    gram = torch.einsum("bcqgn,bckgn->bcqkg", cs, bs)[..., None]
    D = torch.einsum("bcqgrp,bckgrp->bcqkgr", gys, xs)
    GE = gram * E
    M = GE * dts[:, :, None]
    Z = D * E * dts[:, :, None]
    R = D * M * ~torch.eye(chunk, dtype=torch.bool)[:, :, None, None]
    w = torch.exp(sgm[:, :, -1:] - sgm)
    u = w * dts
    v = torch.einsum("bckgn,bcgrpn->bckgrp", bs, h(go))
    xv = (xs * v).sum(-1)
    dx = torch.einsum("bcqkgr,bcqgrp->bckgrp", h(M), gys) + u[..., None] * v
    wq = torch.einsum("bcqgrp,bcgrpn->bcqgrn", gys, h(sin))
    es = torch.exp(sgm)
    dC = (torch.einsum("bcqkgr,bckgn->bcqgrn", h(Z), bs)
          + es[..., None] * wq).sum(4)
    dB = (torch.einsum("bcqkgr,bcqgn->bckgrn", h(Z), cs)
          + u[..., None] * torch.einsum("bckgrp,bcgrpn->bckgrn", xs, h(go))
          ).sum(4)
    T = torch.cat([u[:, :, :-1] * xv[:, :, :-1],
                   torch.zeros_like(u[:, :, -1:])], 2)
    dseg = (R.sum(3) - R.sum(2)
            + es * (cs[:, :, :, :, None] * wq).sum(-1) - T)
    end = T.sum(2) + torch.exp(sgm[:, :, -1]) * sg.reshape(
        B, G, r, nc).permute(0, 3, 1, 2)
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + end[:, :, None]], 2)
    rcs = dseg.flip(2).cumsum(2).flip(2)
    a = ref._per_sequence(A, B).reshape(B, 1, 1, G, r)
    ddt = (GE * D).sum(2) + w * xv + a * rcs
    dA = (dts * rcs).sum((1, 2)).reshape(B, H)
    if A.ndim == 1:
        dA = dA.sum(0)
    return (dx.reshape(B, L, H, P), ddt.reshape(B, L, H), dA,
            dB.reshape(B, L, G, N), dC.reshape(B, L, G, N))


def _case(shape):
    """bf16 inputs (A per sequence), standard normal cotangents and
    tangents, drawn with a seeded generator."""
    B, L, H, P, N, G, chunk, steep = shape
    gen = torch.Generator().manual_seed(1)
    draw = lambda *s: torch.randn(*s, generator=gen)
    x = draw(B, L, H, P).to(torch.bfloat16)
    dt = 0.5 * torch.nn.functional.softplus(draw(B, L, H))
    if steep is not None:
        dt = torch.full_like(dt, steep)
    dt = dt.to(torch.bfloat16).float()
    A = -torch.exp(0.3 * draw(H)) * (0.5 + torch.rand(B, 1, generator=gen))
    Bm, Cm = ((0.3 * draw(B, L, G, N)).to(torch.bfloat16) for _ in "BC")
    gy = draw(B, L, H, P).to(torch.bfloat16)
    gs = draw(B, H, P, N)
    args = [x, dt, A, Bm, Cm, gy, gs]
    targs = [draw(*t.shape).to(t.dtype) for t in args]
    return args, targs, chunk, steep is not None


def _plain(args, chunk):
    S, Lc, seg = ref.bwd_state_ref(*args[:6], chunk)
    s_in, gO, sg = ref.bwd_state_pass_ref(S, Lc, seg, args[6], chunk)
    return ref.bwd_chunk_ref(*args[:6], seg, s_in, gO, sg, chunk)


def _outside(got, want, steep) -> dict:
    """Elements of each of the five outside its limit (dx, dB, dC rounded to
    bf16 first, as the kernels write them)."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        rtol, rel = SSD_BWD_TOL[w.dtype]
        if steep and name == "dA":
            rel = max(rel, STEEP_DA_REL)
        g, w = g.to(w.dtype).float(), w.float()
        out[name] = int(((g - w).abs() > rtol * w.abs()
                         + rel * w.abs().max()).sum())
    return out


def _model_and_plain(shape, tangent, lo):
    args, targs, chunk, steep = _case(shape)
    if not tangent:
        return bwd_model(*args, chunk, lo=lo), _plain(args, chunk), steep
    f32 = lambda ts: tuple(t.float() for t in ts)
    _, got = torch.func.jvp(lambda *a: bwd_model(*a, chunk, lo=lo),
                            f32(args), f32(targs))
    want = ref.tangent_bwd_chunk_ref  # the plain tangent, passes composed
    S, tS, Lc, tLc, seg, tseg = ref.tangent_bwd_state_ref(
        *args[:6], *targs[:6], chunk)
    s_in, ts_in, gO, tgO, sg, tsg = ref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, args[6], targs[6], chunk)
    plain = want(*args[:6], seg, s_in, gO, sg, *targs[:6], tseg, ts_in, tgO,
                 tsg, chunk)
    return got, plain, steep


@pytest.mark.parametrize("tangent", [False, True], ids=["bwd", "tangent"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_hi_lo_model_is_within_the_backward_tolerance(shape, tangent):
    got, want, steep = _model_and_plain(shape, tangent, lo=True)
    outside = _outside(got, want, steep)
    assert not any(outside.values()), outside


@pytest.mark.parametrize("tangent", [False, True], ids=["bwd", "tangent"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_model_without_lo_halves_falls_outside(shape, tangent):
    got, want, steep = _model_and_plain(shape, tangent, lo=False)
    outside = _outside(got, want, steep)
    assert sum(outside.values()) > 0, outside
