"""The float32 SSD kernels' arithmetic modelled on the CPU: every product
as the tensor cores take it in namespaces ``tbw`` (``ssd_bwd.cu``) and
``tfs`` (``ssd_scan.cu``), three TF32 products (``ref.split_tf32``: hi =
tf32(x) rounded to nearest, lo = x - hi as the tensor core reads it), or
one; float64 inputs with ``products=None`` give the exact passes.  Shared
by ``test_torch_f32_tangent_tf32.py`` (the backward's tangent) and
``test_torch_ssd_f32_tf32.py`` (the forward and the backward)."""
import torch

from repro_torch.kernels.flash_attention import ref as fref


def einsum3(spec, a, b, products):
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


class TF32Einsum(torch.autograd.Function):
    """A product as the kernels take it, with the kernels' tangent rule:
    (A B)' = A' B + A B', each of the two products as the value's."""

    @staticmethod
    def forward(a, b, spec, products):
        return einsum3(spec, a, b, products)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, ctx.spec, ctx.products = inputs
        ctx.save_for_forward(a, b)

    @staticmethod
    def jvp(ctx, ta, tb, *_):
        a, b = ctx.saved_tensors
        out = 0
        if ta is not None:
            out = out + einsum3(ctx.spec, ta, b, ctx.products)
        if tb is not None:
            out = out + einsum3(ctx.spec, a, tb, ctx.products)
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("forward mode only")


def bwd_model(x, dt, A, Bg, Cg, gy, gs, chunk, products):
    """(dx, ddt, dA, dB, dC): the backward's three passes (``ref``'s
    algebra, the kernels' float32 order of terms) with every product
    through :class:`TF32Einsum`; float64 inputs and ``products=None`` give
    the exact passes."""
    mm = lambda spec, a, b: TF32Einsum.apply(a, b, spec, products)
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


def fwd_model(x, dt, A, Bg, Cg, chunk, products):
    """(y, final state): the float32 forward's three passes (namespace
    ``tfs``; ``ref.chunk_state_ref``, ``state_pass_ref``,
    ``chunk_scan_ref``'s algebra) with every product through
    :func:`einsum3`: S = (u x)^T B, C B^T, M x and C s_in^T; seg, u, M and
    the states passed across chunks in the inputs' dtype."""
    mm = lambda spec, a, b: einsum3(spec, a, b, products)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    dtc = dt.reshape(B, nc, chunk, H)
    a = A if A.ndim == 2 else A.expand(B, H)
    segc = torch.cumsum(dtc * a[:, None, None, :], 2)         # (B,nc,c,H)
    u = torch.exp(segc[:, :, -1:] - segc) * dtc
    ux = (u[..., None] * x.reshape(B, nc, chunk, H, P)).reshape(
        B, nc, chunk, G, r, P)
    bs, cs = (t.reshape(B, nc, chunk, G, N) for t in (Bg, Cg))
    S = mm("bckgrp,bckgn->bcgrpn", ux, bs).reshape(B, nc, H, P, N)
    dec = torch.exp(segc[:, :, -1])                           # (B,nc,H)
    s, s_in = torch.zeros_like(S[:, 0]), []
    for c in range(nc):
        s_in.append(s)
        s = dec[:, c, :, None, None] * s + S[:, c]
    s_in = torch.stack(s_in, 1).reshape(B, nc, G, r, P, N)
    sgm = segc.reshape(B, nc, chunk, G, r)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()[:, :, None,
                                                              None]
    E = torch.exp(torch.where(causal, sgm[:, :, :, None] - sgm[:, :, None],
                              -torch.inf))
    M = (mm("bcqgn,bckgn->bcqkg", cs, bs)[..., None] * E
         * dtc.reshape(B, nc, chunk, G, r)[:, :, None])
    y = mm("bcqkgr,bckgrp->bcqgrp", M,
           x.reshape(B, nc, chunk, G, r, P))
    y = y + torch.exp(sgm)[..., None] * mm("bcqgn,bcgrpn->bcqgrp", cs, s_in)
    return y.reshape(B, L, H, P), s
