"""The port's SSD scan (``repro_torch.kernels.ssd_scan`` and the chunked
``models.layers.ssd_scan``) against the JAX package's, on the same numpy
inputs: the plain version against ``ssd_scan_ref`` and against the Pallas
kernel in interpret mode, the chunked scan against the jnp one, and the
autograd pairing (kernel forward, chunked-scan VJP) under ``vmap(grad)``
against ``jax.vmap(jax.grad)`` of the jnp scan.  On CPU tensors the
pairing's forward is the plain version, in the kernel's place."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro.models import layers as JL
from repro_torch.kernels.ssd_scan import chunked, ops, ref
from repro_torch.models import layers as L

# float32 on both sides: the same recurrence or the same chunked products
# summed in another order.
TOL = dict(rtol=1e-5, atol=1e-5)
# The Pallas kernel's chunked form against the per-step recurrence, as
# tests/test_kernels.py holds them.
PALLAS_F32_TOL = dict(rtol=3e-5, atol=3e-5)
# bfloat16: both round the float32 result to bf16 once, one bf16 ulp
# (2^-7 relative) apart at most, plus 2^-8 of the row's largest |value|
# for the float32 sums' order near zero.
BF16_RTOL, BF16_ROW_ATOL = 1.6e-2, 2.0 ** -8
GRID = [(128, 32), (256, 64), (256, 128)]     # tests/test_kernels.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, B=2, L=128, H=2, P=16, N=32, G=None):
    """tests/test_kernels.py's distributions, drawn with numpy: B and C per
    head (G = H) unless G is given."""
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, L, H)), 0) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = BF16_ROW_ATOL * np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= atol + BF16_RTOL * np.abs(want)).all()


@pytest.mark.parametrize("shape", [dict(), dict(B=1, L=96, H=3, P=8, N=16)],
                         ids=["grid", "odd"])
def test_ssd_scan_ref_matches_the_reference(shape):
    x, dt, A, Bm, Cm = _inputs(0, **shape)
    yj, sj = jax_ssd_scan_ref(*map(_j, (x, dt, A, Bm, Cm)))
    y, s = ref.ssd_scan_ref(*map(_t, (x, dt, A, Bm, Cm)))
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,chunk", GRID)
def test_plain_version_matches_pallas_interpret(L, chunk, dtype):
    """The kernel wrapper on CPU tensors (the plain version) against
    ``ssd_scan_pallas`` in interpret mode on tests/test_kernels.py's grid."""
    x, dt, A, Bm, Cm = _inputs(L + chunk, L=L)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    yp, sp = ssd_scan_pallas(_j(x).astype(jdt), _j(dt).astype(jdt), _j(A),
                             _j(Bm).astype(jdt), _j(Cm).astype(jdt),
                             chunk=chunk, interpret=True)
    y, s = ops.ssd_scan_kernel(_t(x).to(tdt), _t(dt).to(tdt).float(), _t(A),
                               _t(Bm).to(tdt), _t(Cm).to(tdt), chunk=chunk)
    assert y.dtype == tdt and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), **PALLAS_F32_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(yp),
                                   **PALLAS_F32_TOL)
    else:
        assert_bf16_close(y.float().numpy(), yp.astype(jnp.float32))


def test_plain_version_reads_groups_as_the_reference_repeats_them():
    """G=2 groups for H=4 heads: the reference's ops.ssd_scan repeats each
    group to H // G consecutive heads."""
    from repro.kernels.ssd_scan.ops import ssd_scan as jax_ops_ssd_scan
    x, dt, A, Bm, Cm = _inputs(3, H=4, G=2)
    yj, sj = jax_ops_ssd_scan(*map(_j, (x, dt, A, Bm, Cm)), chunk=32,
                              interpret=True)
    y, s = ops.ssd_scan_kernel(*map(_t, (x, dt, A, Bm, Cm)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **PALLAS_F32_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **PALLAS_F32_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_scan_matches_jnp(chunk):
    x, dt, A, Bm, Cm = _inputs(4, H=4, G=2)
    yj, sj = JL.ssd_scan(*map(_j, (x, dt, A, Bm, Cm)), chunk)
    y, s = L.ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)


def test_chunked_scan_is_chunk_invariant_and_carries_state():
    """Any chunk gives the per-step recurrence's results, and scanning two
    halves with the state carried equals one scan."""
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(5))
    yr, sr = ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    for chunk in (8, 32, 128):
        y, s = L.ssd_scan(x, dt, A, Bm, Cm, chunk)
        np.testing.assert_allclose(y.numpy(), yr.numpy(), **PALLAS_F32_TOL)
        np.testing.assert_allclose(s.numpy(), sr.numpy(), **PALLAS_F32_TOL)
    h = x.shape[1] // 2
    first = [t[:, :h] for t in (x, dt)] + [A] + [t[:, :h] for t in (Bm, Cm)]
    second = [t[:, h:] for t in (x, dt)] + [A] + [t[:, h:] for t in (Bm, Cm)]
    y1, s1 = L.ssd_scan(*first, 32)
    y2, s2 = L.ssd_scan(*second, 32, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), yr.numpy(),
                               **PALLAS_F32_TOL)
    np.testing.assert_allclose(s2.numpy(), sr.numpy(), **PALLAS_F32_TOL)


def test_chunked_scan_gradient_is_finite_where_the_reference_overflows():
    """dt = 1, A = -1 over a chunk of 256: seg falls by 255, and the
    reference's exp of the masked differences overflows; its dt gradient is
    NaN.  The port masks before the exponential: same values, a finite
    gradient, equal to the reference's at dt = 0.3 where both are finite."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 256, 1, 4)).astype(np.float32)
    Bm = rng.standard_normal((1, 256, 1, 8)).astype(np.float32)
    A = -np.ones(1, np.float32)

    def jloss(dt):
        return JL.ssd_scan(_j(x), dt, _j(A), _j(Bm), _j(Bm), 256)[0].sum()

    def loss(dt):
        return L.ssd_scan(_t(x), dt, _t(A), _t(Bm), _t(Bm), 256)[0].sum()

    ones = np.ones((1, 256, 1), np.float32)
    assert np.isnan(np.asarray(jax.grad(jloss)(_j(ones)))).any()
    assert torch.isfinite(torch.func.grad(loss)(_t(ones))).all()
    np.testing.assert_allclose(
        torch.func.grad(loss)(_t(0.3 * ones)).numpy(),
        np.asarray(jax.grad(jloss)(_j(0.3 * ones))), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("per_sequence_A", [False, True],
                         ids=["A_shared", "A_per_sequence"])
def test_chunked_vjp_matches_the_vjp_of_the_whole_scan(dtype,
                                                      per_sequence_A):
    """The pairing's backward, chunk by chunk in reverse with the entering
    states carried forward first, equals ``torch.func.vjp`` of the whole
    float32 chunked scan, gradients in the inputs' dtypes."""
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(11, L=64, H=4, G=2))
    if per_sequence_A:
        A = torch.stack([A, 0.5 * A])
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    gen = torch.Generator().manual_seed(12)
    gy = torch.randn(x.shape, generator=gen).to(dtype)
    gs = torch.randn(2, 4, 16, 32, generator=gen)

    def f32_scan(x, dt, A, Bm, Cm):
        return L.ssd_scan(*(t.float() for t in (x, dt, A, Bm, Cm)), 16)

    _, vjp_fn = torch.func.vjp(f32_scan, x, dt, A, Bm, Cm)
    want = vjp_fn((gy.float(), gs))
    got = chunked.ssd_scan_vjp(x, dt, A, Bm, Cm, gy, gs, 16)
    for name, g, w, inp in zip(("x", "dt", "A", "B", "C"), got, want,
                               (x, dt, A, Bm, Cm)):
        assert g.dtype == inp.dtype and g.shape == inp.shape, name
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **TOL, err_msg=name)


def test_chunked_vjp_builds_one_chunk_at_a_time(monkeypatch):
    """The VJP recomputes each chunk's tile once, last chunk first, each
    within its own ``torch.func.vjp``: one chunk's (B, c, c, H) tiles are
    live at a time."""
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(13, L=64))
    seen = []

    def spy(xc, *args):
        seen.append(xc.shape[1])
        return real(xc, *args)

    real = chunked._chunk
    monkeypatch.setattr(chunked, "_chunk", spy)
    starts = []
    real_vjp = torch.func.vjp

    def vjp_spy(fn, *primals):
        starts.append((len(seen), int(primals[0].shape[1])))
        return real_vjp(fn, *primals)

    monkeypatch.setattr(chunked.torch.func, "vjp", vjp_spy)
    gy, gs = torch.ones_like(x), torch.ones(2, 2, 16, 32)
    got = chunked.ssd_scan_vjp(x, dt, A, Bm, Cm, gy, gs, 16)
    assert seen == [16] * 4 and starts == [(0, 16), (1, 16), (2, 16),
                                           (3, 16)]
    monkeypatch.undo()
    want = chunked.ssd_scan_vjp(x, dt, A, Bm, Cm, gy, gs, 16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _loss_inputs(seed, n=3):
    """n users' inputs (x, dt, B, C mapped; A_log shared) and a per-user
    weight on y for the loss."""
    x, dt, A, Bm, Cm = _inputs(seed, B=n * 2, L=64, H=2, P=8, N=16, G=1)
    rs = lambda a: a.reshape((n, 2) + a.shape[1:])
    w = np.random.default_rng(seed + 1).standard_normal(
        (n, 2, 64, 2, 8)).astype(np.float32)
    a_log = np.log(-A)
    return rs(x), rs(dt), a_log, rs(Bm), rs(Cm), w


@pytest.mark.parametrize("a_mapped", [False, True], ids=["A_shared",
                                                         "A_per_user"])
def test_function_under_vmap_of_grad_matches_jax(a_mapped):
    """``torch.func.vmap(torch.func.grad(...))`` through the pairing (the
    plain forward here, the chunked VJP backward) against
    ``jax.vmap(jax.grad(...))`` of the jnp chunked scan, for every input;
    A is -exp(A_log), shared by the users or one per user."""
    x, dt, a_log, Bm, Cm, w = _loss_inputs(7)
    if a_mapped:
        a_log = np.stack([a_log, a_log * 0.5, a_log + 0.2])
    chunk = 16

    def jloss(x, dt, a_log, Bm, Cm, w):
        y, s = JL.ssd_scan(x, dt, -jnp.exp(a_log), Bm, Cm, chunk)
        return (y * w).sum() + 0.1 * (s ** 2).sum()

    def loss(x, dt, a_log, Bm, Cm, w):
        y, s = ops.ssd_scan(x, dt, -torch.exp(a_log), Bm, Cm, chunk=chunk)
        return (y * w).sum() + 0.1 * (s ** 2).sum()

    a_dim = 0 if a_mapped else None
    args = (x, dt, a_log, Bm, Cm, w)
    want = jax.vmap(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)),
                    in_axes=(0, 0, a_dim, 0, 0, 0))(*map(_j, args))
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)),
                          in_dims=(0, 0, a_dim, 0, 0, 0))(*map(_t, args))
    for name, g, gj in zip(("x", "dt", "A_log", "B", "C"), got, want):
        assert tuple(g.shape) == gj.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL,
                                   err_msg=name)


def test_kernel_sees_folded_plain_tensors_under_vmap_of_grad(monkeypatch):
    """What the card needs: under ``vmap(grad(...))`` the kernel wrapper is
    called with plain tensors (a raw-pointer launch cannot read a batched or
    grad-tracking one), the users folded into the batch, A one row a
    folded sequence; the backward's VJP sees them folded too."""
    from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor
    seen = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            seen.append((name, tuple(ts[0].shape), tuple(ts[2].shape),
                         any(is_batchedtensor(t) or is_gradtrackingtensor(t)
                             for t in ts)))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "ssd_scan_kernel",
                        spy("fwd", ops.ssd_scan_kernel))
    monkeypatch.setattr(ops, "_chunked_vjp", spy("bwd", ops._chunked_vjp))
    x, dt, a_log, Bm, Cm, w = (_t(a) for a in _loss_inputs(8))
    torch.func.vmap(torch.func.grad(
        lambda x, a_log: (ops.ssd_scan(x, dt[0], -torch.exp(a_log), Bm[0],
                                       Cm[0], chunk=16)[0] ** 2).sum()),
        in_dims=(0, None))(x, a_log)
    assert seen == [("fwd", (6, 64, 2, 8), (6, 2), False),
                    ("bwd", (6, 64, 2, 8), (6, 2), False)]


def test_second_order_and_bad_shapes_raise():
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(9, L=64))
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.func.grad(lambda x: torch.func.grad(
            lambda x: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)[0].pow(2)
            .sum())(x).sum())(x)
    with pytest.raises(ValueError, match=r"L=64 % chunk=48 = 16"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match=r"L=64 % chunk=48 = 16"):
        L.ssd_scan(x, dt, A, Bm, Cm, 48)
    with pytest.raises(ValueError, match="do not fit x"):
        ops.ssd_scan_kernel(x, dt[:, :32], A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="G dividing 2"):
        ops.ssd_scan_kernel(x, dt, A, torch.cat([Bm, Bm[:, :, :1]], 2),
                            torch.cat([Cm, Cm[:, :, :1]], 2), chunk=32)
    with pytest.raises(ValueError, match=r"A has shape \(3,\)"):
        ops.ssd_scan_kernel(x, dt, torch.ones(3), Bm, Cm, chunk=32)


def test_cuda_checks_raise_with_the_numbers():
    """What the kernel refuses (checked before any launch): head dim, state
    and chunk past its limits, other dtypes, mixed dtypes, non-contiguous
    inputs."""
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(10, L=64))
    A2 = A.expand(2, 2).contiguous()
    with pytest.raises(ValueError, match="P=80, state N=32 and chunk=32"):
        ops._check_cuda(torch.zeros(2, 64, 2, 80), dt, A2, Bm, Cm, 32)
    with pytest.raises(ValueError, match="N=129"):
        ops._check_cuda(x, dt, A2, torch.zeros(2, 64, 2, 129), Cm, 32)
    with pytest.raises(ValueError, match="chunk=512"):
        ops._check_cuda(x, dt, A2, Bm, Cm, 512)
    with pytest.raises(ValueError, match="float16 is not supported"):
        ops._check_cuda(x.half(), dt, A2, Bm, Cm, 32)
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        ops._check_cuda(x, dt.double(), A2, Bm, Cm, 32)
    with pytest.raises(ValueError, match="B must be torch.float32"):
        ops._check_cuda(x, dt, A2, Bm.bfloat16(), Cm, 32)
    with pytest.raises(ValueError, match="x .* is not contiguous"):
        ops._check_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), dt,
                        A2, Bm, Cm, 32)


def _compose(x, dt, A, Bm, Cm, chunk, through_wrappers):
    """The three passes of the bfloat16 route, composed: their plain
    versions in float32, or the kernel wrappers on CPU tensors (the plain
    versions, with the entering states handed over as hi/lo bf16 planes, as
    the kernels hand them over)."""
    if through_wrappers:
        S, seg = ops.ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
        hi, lo, state = ops.ssd_state_pass(S, seg, chunk=chunk)
        return ops.ssd_chunk_scan(x, dt, seg, Bm, Cm, hi, lo,
                                  chunk=chunk), state
    S, seg = ref.chunk_state_ref(x, dt, A, Bm, chunk)
    entering, state = ref.state_pass_ref(S, seg, chunk)
    return ref.chunk_scan_ref(x, dt, seg, Bm, Cm, entering, chunk), state


def _expand(a, H):
    """B or C (B, L, G, N) repeated to H heads, as the reference's
    ops.ssd_scan does before its kernel."""
    return np.repeat(a, H // a.shape[2], axis=2)


def _assert_scan_close(y, s, yw, sw, dtype):
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), **PALLAS_F32_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(yw),
                                   **PALLAS_F32_TOL)
    else:
        assert_bf16_close(y.float().numpy(), np.asarray(yw, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L,chunk", GRID)
def test_passes_compose_to_the_reference_scan(L, chunk, G, dtype):
    """Chunk states, state passing and chunk outputs (C·Bᵀ once per group)
    composed: against ``ssd_scan_pallas`` in interpret mode and against
    ``ssd_scan_ref``, on tests/test_kernels.py's grid with one or two B/C
    groups for H = 4.  float32 composes the plain versions; bfloat16 goes
    through the kernel wrappers, hi/lo planes and all."""
    H = 4
    x, dt, A, Bm, Cm = _inputs(L + chunk + G, L=L, H=H, G=G)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, s = _compose(_t(x).to(tdt), _t(dt).to(tdt).float(), _t(A),
                    _t(Bm).to(tdt), _t(Cm).to(tdt), chunk,
                    through_wrappers=dtype == "bfloat16")
    assert y.dtype == tdt and s.dtype == torch.float32
    jx, jdt_, jB, jC = (_j(a).astype(jdt) for a in
                        (x, dt, _expand(Bm, H), _expand(Cm, H)))
    yp, sp = ssd_scan_pallas(jx, jdt_, _j(A), jB, jC, chunk=chunk,
                             interpret=True)
    _assert_scan_close(y, s, yp.astype(jnp.float32), sp, dtype)
    yr, sr = jax_ssd_scan_ref(jx, jdt_.astype(jnp.float32), _j(A), jB, jC)
    _assert_scan_close(y, s, yr, sr, dtype)


@pytest.mark.parametrize("through_wrappers", [False, True],
                         ids=["plain", "wrappers"])
def test_passes_compose_with_A_per_sequence(through_wrappers):
    """A per sequence (B, H), as ``vmap`` over users folds it: against the
    Pallas kernel run sequence by sequence with that sequence's A, and
    against ``ssd_scan_ref`` (which broadcasts a (B, H) A)."""
    x, dt, A, Bm, Cm = _inputs(21, B=3, L=128, H=4, G=2)
    A2 = np.stack([A, 0.5 * A, 2.0 * A])
    y, s = _compose(*map(_t, (x, dt, A2, Bm, Cm)), 32, through_wrappers)
    for b in range(3):
        yp, sp = ssd_scan_pallas(
            _j(x[b:b + 1]), _j(dt[b:b + 1]), _j(A2[b]),
            _j(_expand(Bm[b:b + 1], 4)), _j(_expand(Cm[b:b + 1], 4)),
            chunk=32, interpret=True)
        _assert_scan_close(y[b:b + 1], s[b:b + 1], yp, sp, "float32")
    yr, sr = jax_ssd_scan_ref(*map(_j, (x, dt, A2, _expand(Bm, 4),
                                        _expand(Cm, 4))))
    _assert_scan_close(y, s, yr, sr, "float32")


@pytest.mark.parametrize("through_wrappers", [False, True],
                         ids=["plain", "wrappers"])
def test_passes_stay_finite_where_seg_falls_past_88(through_wrappers):
    """dt near 1 and A = -1 over chunks of 256: seg falls by about 250
    within a chunk, so exp(seg_q) exp(-seg_k) and exp of the unmasked
    differences overflow.  The passes take exp of masked differences: y is
    finite and equals the per-step recurrence."""
    rng = np.random.default_rng(22)
    x, _, _, Bm, Cm = _inputs(22, B=1, L=512, H=2, P=8, N=16, G=1)
    dt = (0.9 + 0.2 * rng.random((1, 512, 2))).astype(np.float32)
    A = -np.ones(2, np.float32)
    y, s = _compose(*map(_t, (x, dt, A, Bm, Cm)), 256, through_wrappers)
    seg = np.cumsum(dt[0, :256, 0] * A[0])
    assert seg[0] - seg[-1] > 88
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = jax_ssd_scan_ref(*map(_j, (x, dt, A, Bm, Cm)))
    _assert_scan_close(y, s, yr, sr, "float32")


def test_split_hi_lo_keeps_16_bits():
    """hi + lo of ``split_hi_lo`` is within 2^-16 of the float32 value,
    relative, over many magnitudes: the precision the entering states keep
    on their way into the tensor cores."""
    rng = np.random.default_rng(23)
    s = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.uniform(-20, 20, 1 << 16)
                          ).astype(np.float32))
    hi, lo = ref.split_hi_lo(s)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - s.double()).abs()
    assert (err <= 2.0 ** -16 * s.double().abs()).all()
    assert float((err / s.double().abs()).max()) > 2.0 ** -20  # not exact


def test_pass_wrappers_check_their_shapes():
    x, dt, A, Bm, Cm = (_t(a) for a in _inputs(24, L=64))
    S, seg = ops.ssd_chunk_state(x, dt, A, Bm, chunk=32)
    assert S.shape == (2, 2, 2, 16, 32) and seg.shape == (2, 2, 64)
    hi, lo, state = ops.ssd_state_pass(S, seg, chunk=32)
    assert hi.shape == lo.shape == (2, 1, 2, 16, 32)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert state.shape == (2, 2, 16, 32)
    with pytest.raises(ValueError, match="does not fit S"):
        ops.ssd_state_pass(S, seg[:, :, :32], chunk=32)
    with pytest.raises(ValueError, match=r"do not fit x"):
        ops.ssd_chunk_scan(x, dt, seg[:, :, :32], Bm, Cm, hi, lo, chunk=32)
    with pytest.raises(ValueError, match=r"do not fit x"):
        ops.ssd_chunk_scan(x, dt, seg, Bm, Cm, hi[:, :0], lo, chunk=32)
    with pytest.raises(ValueError, match=r"L=64 % chunk=48 = 16"):
        ops.ssd_chunk_state(x, dt, A, Bm, chunk=48)


@pytest.mark.parametrize("through_wrappers", [False, True],
                         ids=["plain", "wrappers"])
@pytest.mark.parametrize("L,chunk,H,G,P,N", [(256, 256, 4, 1, 64, 128),
                                             (100, 100, 4, 2, 16, 32)],
                         ids=["full-width", "ragged100"])
def test_passes_compose_on_one_chunk(L, chunk, H, G, P, N, through_wrappers):
    """A prompt no longer than the chunk is one chunk (the model takes
    chunk = min(ssm_chunk, L)): no state enters it, so the hi/lo planes are
    empty, and the chunk need not be a multiple of 16.  Against the Pallas
    kernel in interpret mode and against ``ssd_scan_ref``."""
    x, dt, A, Bm, Cm = _inputs(25 + L, B=2, L=L, H=H, P=P, N=N, G=G)
    y, s = _compose(*map(_t, (x, dt, A, Bm, Cm)), chunk, through_wrappers)
    jx, jdt, jA, jB, jC = map(_j, (x, dt, A, _expand(Bm, H),
                                   _expand(Cm, H)))
    yp, sp = ssd_scan_pallas(jx, jdt, jA, jB, jC, chunk=chunk,
                             interpret=True)
    _assert_scan_close(y, s, yp, sp, "float32")
    _assert_scan_close(y, s, *jax_ssd_scan_ref(jx, jdt, jA, jB, jC),
                       "float32")
