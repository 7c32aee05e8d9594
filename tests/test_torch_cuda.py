"""The CUDA kernels of ``repro_torch.kernels.dif_combine``,
``repro_torch.kernels.flash_attention`` and ``repro_torch.kernels.ssd_scan``
against their plain PyTorch versions, on the card.  Every test here needs a CUDA card and skips
without one.  The file imports neither JAX nor the reference package, so it
also runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest --noconftest -m requires_cuda \\
      tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.dif_combine import ops, ref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ref as sref

# float32: the same expressions, the K terms of a mix summed in another
# order.  bfloat16: outputs rounded to bf16 after that, one ulp apart at most.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_cuda_dif_combine_matches_plain_version(cuda, dtype):
    """Vectorised and scalar paths (M a multiple of 16 bytes or not), up to
    the largest supported K."""
    gen = torch.Generator().manual_seed(0)
    for K, M in ((6, 2048), (6, 1000), (16, 4096), (ops.MAX_AGENTS, 640)):
        A = torch.rand(K, K, generator=gen).to(cuda)
        phi = torch.randn(K, M, generator=gen).to(cuda, dtype)
        before = ops.launch_counts["dif_combine"]
        got = ops.dif_combine(A, phi)
        assert ops.launch_counts["dif_combine"] == before + 1
        want = ref.dif_combine_ref(A, phi)
        assert got.dtype == dtype and got.device.type == "cuda"
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_cuda_fused_update_matches_plain_version(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    for kind in ops.KINDS:
        for mode in ops.MODES:
            for gate in (0.0, 1.0):
                K, M = 6, 2048
                mom_dt = torch.float32 if kind == "adam" else dtype
                args = [torch.rand(4, K, K, generator=gen),
                        torch.tensor([[2]], dtype=torch.int32),
                        torch.tensor([[gate, 0.3, 0.02]]),
                        torch.rand(K, 1, generator=gen),
                        torch.randn(K, M, generator=gen).to(dtype),
                        torch.randn(K, M, generator=gen).to(dtype)]
                if kind != "sgd":
                    args.append(torch.randn(K, M, generator=gen).to(mom_dt))
                if kind == "adam":
                    args.append(torch.rand(K, M, generator=gen))
                args = [a.to(cuda) for a in args]
                hyper = dict(mode=mode, kind=kind, lr=1e-2,
                             weight_decay=0.01 * (kind == "adam"))
                got = ops.fused_combine_update(*args, **hyper)
                want = ref.fused_update_ref(*args, **hyper)
                for a, b in zip(got, want):
                    if b is not None:
                        torch.testing.assert_close(a.float(), b.float(),
                                                   **TOL[a.dtype])
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    """What the kernels do not take raises on a CUDA tensor; nothing falls
    back to the plain version."""
    with pytest.raises(ValueError, match="exceeds"):
        K = ops.MAX_AGENTS + 1
        ops.dif_combine(torch.eye(K, device=cuda),
                        torch.ones(K, 128, device=cuda))
    with pytest.raises(ValueError, match="not supported"):
        ops.dif_combine(torch.eye(2, device=cuda),
                        torch.ones(2, 128, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.dif_combine(torch.eye(2, device=cuda),
                        torch.ones(128, 2, device=cuda).t())



# Grouped kernels: ragged leaves (rows of m = 1 and 1001 are not 16-byte
# aligned and are read element by element), a misaligned view, mixed dtypes
# in one dict.
# ``big`` adds two wide leaves, so that the launch takes the TMA ring
# (more tiles than two a block) with the ragged leaves among its tiles.
def _ragged_leaves(gen, K, cuda, dtypes=DTYPES, big=False):
    leaves = {}
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        for m in (1, 40, 1001, 1600, 4096) + ((1 << 19, 300001) if big
                                                 else ()):
            leaves[f"{name}_{m}"] = torch.randn(K, m, generator=gen).to(
                cuda, dt)
        leaves[f"{name}_3d"] = torch.randn(K, 40, 40, generator=gen).to(
            cuda, dt)
        # contiguous, but 4 bytes past an aligned start
        flat = torch.randn(K * 1600 + 2, generator=gen).to(cuda, dt)
        leaves[f"{name}_misaligned"] = flat[2:].view(K, 1600)
    return leaves


def _assert_leaves_close(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        torch.testing.assert_close(got[k].float(), w.float(),
                                   **TOL[w.dtype], msg=k)


RING = pytest.mark.parametrize("big", [False, True],
                               ids=["direct", "ring"])


@pytest.mark.requires_cuda
@RING
@pytest.mark.parametrize("K", [6, ops.MAX_AGENTS], ids=["K6", "K64"])
def test_cuda_dif_combine_leaves_match_plain_version(cuda, K, big):
    """One launch per dtype group over ragged, misaligned and 3-d leaves."""
    gen = torch.Generator().manual_seed(1)
    A = torch.rand(K, K, generator=gen).to(cuda)
    leaves = _ragged_leaves(gen, K, cuda, big=big)
    before = ops.launch_counts["dif_combine"]
    got = ops.dif_combine_leaves(A, leaves)
    assert ops.launch_counts["dif_combine"] == before + 2
    _assert_leaves_close(got, ref.dif_combine_leaves_ref(A, leaves))
    torch.cuda.synchronize()


def _fused_leaf_inputs(gen, kind, K, cuda, dtypes=DTYPES, big=False):
    params = _ragged_leaves(gen, K, cuda, dtypes, big)
    grads = {k: torch.randn(p.shape, generator=gen).to(cuda, p.dtype)
             for k, p in params.items()}
    mu = nu = None
    if kind == "adam":
        mu = {k: 0.1 * torch.randn(p.shape, generator=gen).to(cuda)
              for k, p in params.items()}
        nu = {k: 0.01 * torch.rand(p.shape, generator=gen).to(cuda)
              for k, p in params.items()}
    elif kind == "momentum":
        mu = {k: torch.randn(p.shape, generator=gen).to(cuda, p.dtype)
              for k, p in params.items()}
    return params, grads, mu, nu


@pytest.mark.requires_cuda
@RING
@pytest.mark.parametrize("mode", ops.MODES)
@pytest.mark.parametrize("kind", ops.KINDS)
def test_cuda_fused_leaves_match_plain_version(cuda, kind, mode, big):
    """Each step of a 3-row schedule with every=2: the kernel derives the
    row, the gate and the bias corrections from the step (host int and
    device tensor) as the plain version does, one launch per dtype."""
    gen = torch.Generator().manual_seed(2)
    K, S = 6, 3
    table = torch.rand(S, K, K, generator=gen).to(cuda)
    scale = torch.rand(K, 1, generator=gen).to(cuda)
    params, grads, mu, nu = _fused_leaf_inputs(gen, kind, K, cuda, big=big)
    count = torch.tensor(4, dtype=torch.int32, device=cuda)
    hyper = dict(mode=mode, kind=kind, lr=1e-2, every=2,
                 weight_decay=0.01 * (kind == "adam"),
                 count=count if kind == "adam" else None)
    for step in (0, 1, 2, 5):
        for s in (step, torch.tensor(step, device=cuda),
                  torch.tensor(step, dtype=torch.int32, device=cuda)):
            before = ops.launch_counts["fused_combine_update"]
            got = ops.fused_combine_update_leaves(
                table, scale, params, grads, mu, nu, step=s, **hyper)
            assert ops.launch_counts["fused_combine_update"] == before + 2
            want = ref.fused_update_leaves_ref(table, scale, params, grads,
                                               mu, nu, step=step, **hyper)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    _assert_leaves_close(g, w)
    torch.cuda.synchronize()


SENTINEL = -65536.0          # exact in bf16; far from any output here


def _sentinel_views(tree, cuda):
    """Same-shaped views into one buffer of SENTINEL, each starting 16 or
    more elements past the last one's end, on a 16-element boundary (so the
    aligned leaves keep their bulk path)."""
    starts, end = [], 0
    for x in tree.values():
        starts.append(-(-(end + 16) // 16) * 16)
        end = starts[-1] + x.numel()
    buf = torch.full((end + 16,), SENTINEL, device=cuda,
                     dtype=next(iter(tree.values())).dtype)
    views = {k: buf[s:s + x.numel()].view(x.shape)
             for (k, x), s in zip(tree.items(), starts)}
    return buf, views


def _assert_only_views_written(buf, views):
    inside = torch.zeros(buf.numel(), dtype=torch.bool, device=buf.device)
    for v in views.values():
        start = (v.data_ptr() - buf.data_ptr()) // buf.element_size()
        inside[start:start + v.numel()] = True
    assert bool((buf[~inside] == SENTINEL).all())
    for k, v in views.items():
        assert not bool((v == SENTINEL).any()), k


@pytest.mark.requires_cuda
@RING
@pytest.mark.parametrize("kind", ops.KINDS)
def test_cuda_grouped_kernels_write_nothing_past_a_leaf(cuda, kind, big):
    """Outputs laid out in one buffer with sentinels between the leaves: the
    kernels write every element of each leaf and none of the sentinels."""
    gen = torch.Generator().manual_seed(3)
    K = 6
    table = torch.rand(1, K, K, generator=gen).to(cuda)
    for dtype in DTYPES:
        params, grads, mu, nu = _fused_leaf_inputs(gen, kind, K, cuda,
                                                   [dtype], big)
        laid = [None if t is None else _sentinel_views(t, cuda)
                for t in (params, mu, nu)]
        outs = tuple(None if x is None else x[1] for x in laid)
        count = torch.tensor(2, dtype=torch.int32, device=cuda)
        ops._fused_into(table, None, params, grads, mu, nu, outs,
                        (None, None, None, 1, 0, count, 1), mode="atc",
                        kind=kind, lr=1e-2, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.0, beta=0.9)
        combined = _sentinel_views(params, cuda)
        ops._combine_launch(table[0], params, combined[1])
        torch.cuda.synchronize()
        for x in [*laid, combined]:
            if x is not None:
                _assert_only_views_written(*x)


@pytest.mark.requires_cuda
def test_cuda_grouped_wrappers_raise_instead_of_falling_back(cuda):
    K = ops.MAX_AGENTS + 1
    with pytest.raises(ValueError, match="exceeds"):
        ops.dif_combine_leaves(torch.eye(K, device=cuda),
                               {"a": torch.ones(K, 8, device=cuda)})
    half = {"a": torch.ones(2, 8, device=cuda),
            "b": torch.ones(2, 8, device=cuda, dtype=torch.float16)}
    with pytest.raises(ValueError, match="not supported"):
        ops.dif_combine_leaves(torch.eye(2, device=cuda), half)
    with pytest.raises(ValueError, match="not supported"):
        ops.fused_combine_update_leaves(
            torch.eye(2, device=cuda)[None], None, half, half, step=0,
            kind="sgd", lr=0.1)
    big = {"a": torch.ones(K, 8, device=cuda)}
    with pytest.raises(ValueError, match="exceeds"):
        ops.fused_combine_update_leaves(
            torch.eye(K, device=cuda)[None], None, big, big, step=0,
            kind="sgd", lr=0.1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["adam", "momentum"])
def test_cuda_graph_replay_of_the_fused_outer_update_equals_eager(cuda,
                                                                  kind):
    """12 replays of one captured outer update (combine_every=2, a 3-row
    link-failure schedule, clip 1.0) against 12 eager calls with a host
    step: the graph advances the device step, and the kernel reads the
    row, the gate and the bias corrections from it."""
    from repro_torch.core import fused, topology, update
    from repro_torch.optim import get_optimizer

    gen = torch.Generator().manual_seed(4)
    K = 6
    A = topology.make_schedule(
        "link_failure", topology.build_topology("paper", K, "metropolis"),
        p=0.2, period=3, seed=0).stacked()
    opt = get_optimizer(kind, 1e-2)
    outer = fused.make_fused_outer(opt, "atc", update.CommSchedule(2), A,
                                   grad_clip=1.0, num_agents=K, device=cuda)
    params = {"w": torch.randn(K, 40, 40, generator=gen).to(cuda),
              "b": torch.randn(K, 1, generator=gen).to(cuda)}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    eager_p, eager_s = ({k: p.clone() for k, p in params.items()},
                        opt.init(params))
    graph_p = {k: p.clone() for k, p in params.items()}
    graph_s = opt.init(graph_p)
    step = torch.zeros((), dtype=torch.int64, device=cuda)
    replay = fused.capture_outer(outer, graph_p, grads, graph_s, step)
    for i in range(12):
        for g in grads.values():
            g.copy_(torch.randn(g.shape, generator=gen).to(cuda))
        eager_p, eager_s = outer(eager_p, grads, eager_s, i)
        replay()
    torch.cuda.synchronize()
    assert int(step) == 12
    for k in params:
        torch.testing.assert_close(graph_p[k], eager_p[k],
                                   **TOL[torch.float32])
    for a, b in zip(fused._tensors(graph_s), fused._tensors(eager_s)):
        torch.testing.assert_close(a, b, **TOL[torch.float32])

# flash attention against attention_ref, its autograd gradient and the plain
# backward.  float32: a blocked online softmax sums in another order;
# bfloat16: both round float32 results to bf16 (two ulps, rtol), plus an
# atol of one bf16 ulp (2^-8 relative) of the largest |value| in the
# element's row: late rows of dq and dk are smaller than any fixed atol.
FLASH_TOL = {torch.float32: (dict(rtol=1e-5, atol=1e-5),
                             dict(rtol=1e-4, atol=1e-4)),
             torch.bfloat16: (dict(rtol=1.6e-2, atol=0.0),
                              dict(rtol=1.6e-2, atol=0.0))}
BF16_ROW_ATOL = 2.0 ** -8


def assert_flash_close(got, want, tol):
    """``got`` within ``tol`` of ``want``, plus the bf16 row atol."""
    assert got.shape == want.shape and got.dtype == want.dtype
    bf16 = want.dtype == torch.bfloat16
    got, want = got.detach().float(), want.detach().float()
    limit = tol["atol"] + tol["rtol"] * want.abs()
    if bf16:
        limit = limit + BF16_ROW_ATOL * want.abs().amax(-1, keepdim=True)
    bad = (got - want).abs() > limit
    assert not bad.any(), (f"{int(bad.sum())} elements outside {tol}; max "
                           f"abs err {float((got - want).abs().max()):.3e}")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 3, 256, 128), True, None),
    ((1, 2, 200, 64), False, 48),
], ids=["causal-256x128", "window-ragged200x64"])
def test_cuda_flash_attention_matches_plain_version(cuda, dtype, shape,
                                                    causal, window):
    """Forward (out, lse) and backward (dq, dk, dv), through the autograd
    Function, with a ragged sequence length (no block alignment)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda, dtype)
                   for _ in range(4))
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    before = dict(fops.launch_counts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fops.flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    assert fops.launch_counts["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    assert fops.launch_counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2         # the backward's two
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = fref.attention_ref(*plain, causal=causal, window=window)
    want.backward(do)
    assert_flash_close(out, want, fwd_tol)
    _, lse = fops.flash_attention_fwd_lse(q, k, v, causal=causal,
                                          window=window)
    _, want_lse = fref.flash_fwd_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(lse[..., 0], want_lse,
                               **FLASH_TOL[torch.float32][0])
    # the backward against its plain version on the same inputs (both read
    # the stored output); in float32 also against autograd, where the
    # stored output's rounding is below the tolerance
    want_grads = fref.flash_bwd_ref(q, k, v, out.detach(), lse[..., 0], do,
                                    causal=causal, window=window)
    for got, w, p in zip(leaves, want_grads, plain):
        assert_flash_close(got.grad, w, bwd_tol)
        if dtype == torch.float32:
            assert_flash_close(got.grad, p.grad, bwd_tol)
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_flash_attention_raises_instead_of_falling_back(cuda):
    q = torch.ones(1, 2, 64, 160, device=cuda)
    with pytest.raises(ValueError, match="d=160 exceeds"):
        fops.flash_attention(q, q, q)
    h = torch.ones(1, 2, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        fops.flash_attention(h, h, h)


# The model layout with KV heads not expanded, against the plain versions
# in that layout: in bfloat16 the Hopper kernels (the last case has d = 36,
# whose rows are read element by element instead of by TMA); in float32 the
# 3xTF32 forward and backward on the unexpanded views (d = 36 by 16-byte
# tiles, its rows being 144 bytes).
GQA_CASES = [((2, 256, 12, 2, 128), True, None),
             ((1, 200, 4, 1, 64), False, 48),
             ((2, 40, 4, 2, 64), True, None),
             ((1, 130, 4, 2, 36), True, None)]
GQA_IDS = ["causal-256-12x2-128", "window-ragged200-4x1-64",
           "causal-short40-4x2-64", "causal-130-4x2-36-elementwise"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", GQA_CASES, ids=GQA_IDS)
def test_cuda_gqa_flash_attention_matches_plain_version(cuda, dtype, shape,
                                                        causal, window):
    """Forward and gradients through ``gqa_flash_attention``: dk and dv come
    back as (B, S, KV, d), summed over each KV head's query heads."""
    B, S, H, KV, d = shape
    gen = torch.Generator().manual_seed(0)
    q, do = (torch.randn(B, S, H, d, generator=gen).to(cuda, dtype)
             for _ in "qo")
    k, v = (torch.randn(B, S, KV, d, generator=gen).to(cuda, dtype)
            for _ in "kv")
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    before = dict(fops.launch_counts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fops.gqa_flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    assert fops.launch_counts["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    assert fops.launch_counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2
    want, want_lse = fref.gqa_flash_fwd_ref(q, k, v, causal=causal,
                                            window=window)
    assert_flash_close(out, want, fwd_tol)
    want_grads = fref.gqa_flash_bwd_ref(q, k, v, out.detach(), want_lse, do,
                                        causal=causal, window=window)
    for got, w in zip(leaves, want_grads):
        assert_flash_close(got.grad, w, bwd_tol)
    torch.cuda.synchronize()


def _device_kernels(prof) -> list[str]:
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            for _ in range(e.count)]


@pytest.mark.requires_cuda
def test_cuda_gqa_flash_attention_launches_only_its_kernels(cuda):
    """At the serving shape (16, 256, 12 heads, 2 KV heads, 128) in bf16, a
    forward call runs one kernel on the card and its backward two: no copy,
    transpose, expansion or reduction kernel besides them."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    q, do = (torch.randn(16, 256, 12, 128, generator=gen).to(
        cuda, torch.bfloat16) for _ in "qo")
    k, v = (torch.randn(16, 256, 2, 128, generator=gen).to(
        cuda, torch.bfloat16) for _ in "kv")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(fops.gqa_flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()                    # build and first launches
    with profile(activities=[ProfilerActivity.CUDA]) as fwd:
        out = fops.gqa_flash_attention(*leaves)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert len(_device_kernels(fwd)) == 1, _device_kernels(fwd)
    assert "fwd_kernel" in _device_kernels(fwd)[0]
    names = _device_kernels(bwd)
    assert len(names) == 2, names
    assert "dq_kernel" in " ".join(names) and "dkv_kernel" in " ".join(names)


@pytest.mark.requires_cuda
def test_cuda_f32_flash_backward_launches_only_its_kernels(cuda):
    """At lm-100m's attention shape (16, 256, 8 heads, 4 KV heads, 64) in
    float32, a backward call runs the two 3xTF32 kernels on the card and
    nothing else: no head expansion, copy, D or per-KV-head sum."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    q, do = (torch.randn(16, 256, 8, 64, generator=gen).to(cuda)
             for _ in "qo")
    k, v = (torch.randn(16, 256, 4, 64, generator=gen).to(cuda)
            for _ in "kv")
    out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v)
    fops.gqa_flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        grads = fops.gqa_flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    names = _device_kernels(bwd)
    assert len(names) == 2 and all("tf32" in n for n in names), names
    assert "dq_kernel" in " ".join(names) and "dkv_kernel" in " ".join(names)


@pytest.mark.requires_cuda
def test_cuda_bf16_flash_attention_raises_when_its_kernel_cannot_launch(
        cuda):
    """A batch past the grid's 65535 limit: the launch is refused and the
    call raises; nothing runs in its place."""
    q = torch.ones(65536, 1, 1, 8, device=cuda, dtype=torch.bfloat16)
    before = dict(fops.launch_counts)
    with pytest.raises(RuntimeError, match="launch failed"):
        fops.gqa_flash_attention(q, q, q)
    assert fops.launch_counts == before


# The SSD scan against the per-step recurrence.  float32: the chunked form
# sums in another order (1e-4, as chip_smoke.py holds it at the serving
# shape); bfloat16: y is rounded to bf16 once (rtol) plus the row atol; the
# state stays float32.
SSD_F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _ssd_inputs(gen, B, L, H, P, N, G, dtype, device):
    """tests/test_kernels.py's distributions."""
    x = torch.randn(B, L, H, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=gen))
    A = -torch.exp(torch.randn(H, generator=gen) * 0.3)
    Bm, Cm = (torch.randn(B, L, G, N, generator=gen) * 0.3 for _ in "BC")
    return (x.to(device, dtype), (0.5 * dt).to(dtype).float().to(device),
            A.to(device), Bm.to(device, dtype), Cm.to(device, dtype))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L,chunk,H,G,P,N", [
    (128, 32, 2, 2, 16, 32), (256, 64, 2, 2, 16, 32),
    (256, 128, 2, 2, 16, 32), (96, 48, 4, 2, 8, 16),
    (512, 256, 4, 1, 64, 128), (256, 256, 4, 1, 64, 128),
    (100, 100, 4, 2, 16, 32)],
    ids=["grid128x32", "grid256x64", "grid256x128", "groups-ragged48",
         "full-width", "one-chunk-full-width", "one-chunk-ragged100"])
def test_cuda_ssd_scan_matches_plain_version(cuda, dtype, L, chunk, H, G,
                                             P, N):
    gen = torch.Generator().manual_seed(L + chunk)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, L, H, P, N, G, dtype, cuda)
    before = sops.launch_counts["ssd_scan"]
    y, s = sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    assert sops.launch_counts["ssd_scan"] == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    rep = H // G
    yr, sr = sref.ssd_scan_ref(x, dt, A, Bm.repeat_interleave(rep, 2),
                               Cm.repeat_interleave(rep, 2))
    torch.testing.assert_close(s, sr, **SSD_F32_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yr, **SSD_F32_TOL)
    else:
        assert_flash_close(y, yr.to(dtype), dict(rtol=1.6e-2, atol=0.0))
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_ssd_scan_vmap_of_grad_matches_the_cpu(cuda):
    """The pairing (kernel forward, chunked-scan VJP backward) under
    ``vmap(grad)`` on the card against the same on the CPU (plain forward):
    one launch for the three users."""
    gen = torch.Generator().manual_seed(0)
    n, B, L, H, P, N = 3, 2, 128, 4, 16, 32
    xs = torch.randn(n, B, L, H, P, generator=gen)
    dts = torch.nn.functional.softplus(torch.randn(n, B, L, H,
                                                   generator=gen)) * 0.5
    a_log = torch.randn(H, generator=gen) * 0.3
    Bs, Cs = (torch.randn(n, B, L, 1, N, generator=gen) * 0.3 for _ in "BC")
    w = torch.randn(n, B, L, H, P, generator=gen)

    def loss(x, dt, a_log, Bm, Cm, w):
        y, s = sops.ssd_scan(x, dt, -torch.exp(a_log), Bm, Cm, chunk=32)
        return (y * w).sum() + 0.1 * (s ** 2).sum()

    f = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)),
                        in_dims=(0, 0, None, 0, 0, 0))
    args = (xs, dts, a_log, Bs, Cs, w)
    before = sops.launch_counts["ssd_scan"]
    got = f(*(t.to(cuda) for t in args))
    assert sops.launch_counts["ssd_scan"] == before + 1
    for g, want in zip(got, f(*args)):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_cuda_ssd_scan_raises_instead_of_falling_back(cuda):
    gen = torch.Generator().manual_seed(1)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 64, 2, 16, 32, 1, torch.float32,
                                   cuda)
    with pytest.raises(ValueError, match="P=80"):
        sops.ssd_scan_kernel(torch.ones(1, 64, 2, 80, device=cuda), dt, A,
                             Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="not supported"):
        sops.ssd_scan_kernel(x.half(), dt, A, Bm.half(), Cm.half(),
                             chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        sops.ssd_scan_kernel(x.transpose(2, 3).contiguous().transpose(2, 3),
                             dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match=r"L=64 % chunk=48 = 16"):
        sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=48)


# The last two are one chunk (a prompt no longer than the model's chunk):
# empty hi/lo planes, and a chunk of 100 rows, not a multiple of 16.
SSD_PASS_SHAPES = [(128, 32, 2, 2, 16, 32), (256, 64, 2, 2, 16, 32),
                   (256, 128, 2, 2, 16, 32), (96, 48, 4, 2, 8, 16),
                   (512, 256, 4, 1, 64, 128), (256, 256, 4, 1, 64, 128),
                   (100, 100, 4, 2, 16, 32)]
SSD_PASS_IDS = ["grid128x32", "grid256x64", "grid256x128", "groups-ragged48",
                "full-width", "one-chunk-full-width", "one-chunk-ragged100"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("L,chunk,H,G,P,N", SSD_PASS_SHAPES,
                         ids=SSD_PASS_IDS)
def test_cuda_ssd_passes_match_plain_versions(cuda, L, chunk, H, G, P, N):
    """Each kernel of the bfloat16 route against its plain version on the
    same inputs (the kernel's own outputs of the pass before), each
    counting its launch: the chunk states and the state passing in float32
    within SSD_F32_TOL (the hi/lo halves keep 16 bits of each float32
    operand), the chunk outputs as the bf16 scan."""
    gen = torch.Generator().manual_seed(L + chunk + 1)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, L, H, P, N, G, torch.bfloat16,
                                   cuda)
    before = dict(sops.launch_counts)
    S, seg = sops.ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    hi, lo, state = sops.ssd_state_pass(S, seg, chunk=chunk)
    y = sops.ssd_chunk_scan(x, dt, seg, Bm, Cm, hi, lo, chunk=chunk)
    assert {k: sops.launch_counts[k] - before[k] for k in before} == {
        **{k: 0 for k in before}, "ssd_chunk_state": 1, "ssd_state_pass": 1,
        "ssd_chunk_scan": 1}
    Sr, segr = sref.chunk_state_ref(x, dt, A, Bm, chunk)
    torch.testing.assert_close(S, Sr, **SSD_F32_TOL)
    torch.testing.assert_close(seg, segr, **SSD_F32_TOL)
    entering, state_r = sref.state_pass_ref(S, seg, chunk)
    assert hi.dtype == lo.dtype == torch.bfloat16
    torch.testing.assert_close(hi.float() + lo.float(), entering,
                               **SSD_F32_TOL)
    torch.testing.assert_close(state, state_r, **SSD_F32_TOL)
    yr = sref.chunk_scan_ref(x, dt, seg, Bm, Cm, hi.float() + lo.float(),
                             chunk)
    assert y.dtype == torch.bfloat16
    assert_flash_close(y, yr, dict(rtol=1.6e-2, atol=0.0))
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_tensor_map_kernels_launch_from_a_fresh_thread(cuda):
    """The kernels fed by TMA tensor maps (bf16 flash forward and backward,
    the bf16 SSD scan and T3) called from a thread that has made no CUDA
    call, as autograd's device thread may be: the same results as on the
    main thread (each kernel gives the same bits from run to run)."""
    import threading
    gen = torch.Generator().manual_seed(9)
    q, do = (torch.randn(2, 128, 4, 64, generator=gen).to(
        cuda, torch.bfloat16) for _ in "qo")
    k, v = (torch.randn(2, 128, 2, 64, generator=gen).to(
        cuda, torch.bfloat16) for _ in "kv")
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, 256, 4, 16, 32, 2,
                                   torch.bfloat16, cuda)
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen).to(
        cuda, t.dtype) for t in (x, dt, A, Bm, Cm))

    def calls():
        out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v, causal=True)
        grads = fops.gqa_flash_attention_bwd(q, k, v, out, lse, do,
                                             causal=True)
        scan = sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=64)
        tangent = sops.ssd_scan_tangent(x, dt, A, Bm, Cm, tx, tdt, tA, tB,
                                        tC, chunk=64)
        torch.cuda.synchronize()
        return (out, lse, *grads, *scan, *tangent)

    want = calls()
    got = {}

    def run():
        try:
            got["results"] = calls()
        except Exception as err:          # raised again on the main thread
            got["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "error" in got:
        raise got["error"]
    for g, w in zip(got["results"], want):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_cuda_ssd_scan_counts_calls_and_each_kernel(cuda):
    """A bf16 call counts one ``ssd_scan`` call and one launch of each of
    its three kernels, with A per sequence read through its strides; a
    float32 call counts one ``ssd_scan`` launch and none of theirs."""
    gen = torch.Generator().manual_seed(5)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, 256, 4, 16, 32, 2,
                                   torch.bfloat16, cuda)
    A2 = torch.stack([A, 0.5 * A])
    for dtype, want in ((torch.bfloat16, (1, 1, 1, 1)),
                        (torch.float32, (1, 0, 0, 0))):
        before = dict(sops.launch_counts)
        y, s = sops.ssd_scan_kernel(x.to(dtype), dt, A2, Bm.to(dtype),
                                    Cm.to(dtype), chunk=64)
        keys = ("ssd_scan", "ssd_chunk_state", "ssd_state_pass",
                "ssd_chunk_scan")
        assert tuple(sops.launch_counts[k] - before[k] for k in keys) == want
        yr, sr = sref.ssd_scan_ref(x.to(dtype), dt, A2,
                                   Bm.repeat_interleave(2, 2).to(dtype),
                                   Cm.repeat_interleave(2, 2).to(dtype))
        torch.testing.assert_close(s, sr, **SSD_F32_TOL)
        if dtype == torch.float32:
            torch.testing.assert_close(y, yr, **SSD_F32_TOL)
        else:
            assert_flash_close(y, yr.to(dtype), dict(rtol=1.6e-2, atol=0.0))


@pytest.mark.requires_cuda
def test_cuda_ssd_bf16_raises_on_what_its_kernels_do_not_take(cuda):
    """bf16 rows the kernels' TMA cannot read (P or N not a multiple of 8)
    raise, with nothing launched: there is no other bf16 route."""
    gen = torch.Generator().manual_seed(6)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 64, 2, 12, 32, 1, torch.bfloat16,
                                   cuda)
    before = dict(sops.launch_counts)
    with pytest.raises(ValueError, match="multiples of 8"):
        sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=32)
    assert sops.launch_counts == before


# ---------------------------------------------------------------------------
# Forward-mode tangent kernels (T1, T2 of flash attention; T3 of the SSD
# scan) against their plain versions, ``torch.func.jvp`` of the plain
# forward and backward.  Each check bounds the error by the output's
# largest |value|: float32 1e-4 of it (the same products summed in another
# order; the plain backward sums in float64), bfloat16 one rounding of it
# (2^-8) plus the output's own rounding (rtol 1.6e-2) — a tangent that is
# exactly 0 in the plain version (a row that sees one key) is a rounding
# residue of the kernel's float32 sums.
TANGENT_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (1.6e-2, 2.0 ** -8)}


def assert_tangent_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if not want.numel():                 # one chunk: no entering states
        return
    rtol, rel = TANGENT_TOL[want.dtype]
    got, want = got.detach().float(), want.detach().float()
    limit = rtol * want.abs() + rel * want.abs().max()
    bad = (got - want).abs() > limit
    assert not bad.any(), (f"{int(bad.sum())} elements outside; max abs err "
                           f"{float((got - want).abs().max()):.3e} of "
                           f"{float(want.abs().max()):.3e}")


# (layout, shape, causal, window): heads_dim 1 is (B, H, S, d) expanded,
# heads_dim 2 the model layout (B, S, H, d) with (B, S, KV, d) K/V; the
# last is qwen2-1.5b's training shape.
TANGENT_CASES = [(1, (2, 3, 256, 128), True, None),
                 (1, (1, 2, 200, 64), False, 48),
                 (2, (1, 130, 4, 2, 36), True, None),
                 (2, (1, 200, 4, 1, 64), False, 48),
                 (2, (16, 256, 12, 2, 128), True, None)]
TANGENT_IDS = ["bhsd-causal-256x128", "bhsd-window-ragged200x64",
               "gqa-causal-130-4x2-36", "gqa-window-200-4x1-64",
               "gqa-qwen2-16x256-12x2-128"]


def _flash_tangent_inputs(heads_dim, shape, dtype, device, seed=0,
                          unaligned=False):
    """q, k, v, dO and their tangents in the layout of ``heads_dim``;
    ``unaligned``: views of the first d columns of tensors with d + 1,
    whose rows are not 16-byte aligned."""
    gen = torch.Generator().manual_seed(seed)
    if heads_dim == 1:
        qs = ks = shape
    else:
        B, S, H, KV, d = shape
        qs, ks = (B, S, H, d), (B, S, KV, d)

    def draw(s):
        if not unaligned:
            return torch.randn(s, generator=gen).to(device, dtype)
        wide = torch.randn(*s[:-1], s[-1] + 1, generator=gen)
        return wide.to(device, dtype)[..., :s[-1]]

    q, tq, do, tdo = (draw(qs) for _ in range(4))
    k, v, tk, tv = (draw(ks) for _ in range(4))
    return q, k, v, do, tq, tk, tv, tdo


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("heads_dim,shape,causal,window", TANGENT_CASES,
                         ids=TANGENT_IDS)
def test_cuda_flash_tangents_match_plain_versions(cuda, dtype, heads_dim,
                                                  shape, causal, window):
    """T1 (o', lse') and T2 (dq', dk', dv'), one and two launches."""
    q, k, v, do, tq, tk, tv, tdo = _flash_tangent_inputs(heads_dim, shape,
                                                         dtype, cuda)
    fwd = fref.flash_fwd_ref if heads_dim == 1 else fref.gqa_flash_fwd_ref
    out, lse = fwd(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, heads_dim=heads_dim)
    before = dict(fops.launch_counts)
    to, tlse = fops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv,
                                                **kw)
    assert fops.launch_counts["flash_attention_fwd_tangent"] == \
        before["flash_attention_fwd_tangent"] + 1
    want_to, want_tlse = fref.flash_fwd_tangent_ref(q, k, v, tq, tk, tv, **kw)
    assert_tangent_close(to, want_to)
    assert_tangent_close(tlse, want_tlse)
    grads = fops.flash_attention_bwd_tangent(q, k, v, out, lse, do, tq, tk,
                                             tv, want_to, want_tlse, tdo, **kw)
    assert fops.launch_counts["flash_attention_bwd_tangent"] == \
        before["flash_attention_bwd_tangent"] + 2
    want = fref.flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv,
                                      want_to, want_tlse, tdo, **kw)
    for g, w in zip(grads, want):
        assert_tangent_close(g, w)
    torch.cuda.synchronize()


# The float32 forward and T2 on their 3xTF32 kernels, over the cases that
# reach their code paths (heads_dim, shape, causal, window, unaligned): both
# layouts, d = 30 (d % 4 != 0) and unaligned views read element by element,
# d 32, 64 and 128, ragged S, causal, full and window, GQA ratios 1, 2, 6.
F32_CASES = [(1, (2, 3, 256, 128), True, None, False),
             (1, (1, 2, 200, 64), False, 48, True),
             (2, (2, 200, 4, 4, 32), True, None, False),
             (2, (2, 130, 8, 4, 64), True, 48, False),
             (2, (1, 300, 12, 2, 128), False, None, False),
             (2, (2, 100, 6, 1, 30), True, None, False),
             (2, (1, 160, 4, 2, 64), True, None, True)]
F32_IDS = ["bhsd-causal-256x128", "bhsd-window-200x64-unaligned",
           "gqa-causal-200-4x4-32", "gqa-window-130-8x4-64",
           "gqa-full-300-12x2-128", "gqa-causal-100-6x1-30",
           "gqa-causal-160-4x2-64-unaligned"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("heads_dim,shape,causal,window,unaligned",
                         F32_CASES, ids=F32_IDS)
def test_cuda_f32_forward_and_t2_match_plain_versions(
        cuda, heads_dim, shape, causal, window, unaligned):
    """The 3xTF32 forward (out, lse; one launch) within the float32
    forward tolerance of its plain version, and T2 (dq', dk', dv'; two
    launches) within TANGENT_TOL of ``torch.func.jvp`` of the plain
    backward."""
    q, k, v, do, tq, tk, tv, tdo = _flash_tangent_inputs(
        heads_dim, shape, torch.float32, cuda, unaligned=unaligned)
    kw = dict(causal=causal, window=window)
    before = dict(fops.launch_counts)
    if heads_dim == 1:
        out, lse = fops.flash_attention_fwd_lse(q, k, v, **kw)
        lse = lse[..., 0]
        want, want_lse = fref.flash_fwd_ref(q, k, v, **kw)
    else:
        out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v, **kw)
        want, want_lse = fref.gqa_flash_fwd_ref(q, k, v, **kw)
    assert fops.launch_counts["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    fwd_tol = FLASH_TOL[torch.float32][0]
    assert_flash_close(out, want, fwd_tol)
    torch.testing.assert_close(lse, want_lse, **fwd_tol)
    tkw = dict(kw, heads_dim=heads_dim)
    want_to, want_tlse = fref.flash_fwd_tangent_ref(q, k, v, tq, tk, tv,
                                                    **tkw)
    grads = fops.flash_attention_bwd_tangent(q, k, v, want, want_lse, do, tq,
                                             tk, tv, want_to, want_tlse, tdo,
                                             **tkw)
    assert fops.launch_counts["flash_attention_bwd_tangent"] == \
        before["flash_attention_bwd_tangent"] + 2
    wants = fref.flash_bwd_tangent_ref(q, k, v, want, want_lse, do, tq, tk,
                                       tv, want_to, want_tlse, tdo, **tkw)
    for g, w in zip(grads, wants):
        assert_tangent_close(g, w)
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_f32_forward_and_t2_launch_only_their_kernels(cuda):
    """At lm-100m's attention shape (16, 256, 8 heads, 4 KV heads, 64) in
    float32, a forward call runs the one 3xTF32 forward kernel on the card
    and a T2 call its two tangent kernels, and nothing else: no head
    expansion, copy or elementwise kernel."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do, tq, tk, tv, tdo = _flash_tangent_inputs(
        2, (16, 256, 8, 4, 64), torch.float32, cuda)
    out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v)
    to, tlse = fops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv,
                                                heads_dim=2)
    t2 = lambda: fops.flash_attention_bwd_tangent(
        q, k, v, out, lse, do, tq, tk, tv, to, tlse, tdo, heads_dim=2)
    t2()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as fwd:
        fops.gqa_flash_attention_fwd_lse(q, k, v)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        grads = t2()
        torch.cuda.synchronize()
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    names = _device_kernels(fwd)
    assert len(names) == 1 and "tf32::fwd_kernel" in names[0], names
    names = _device_kernels(bwd)
    assert len(names) == 2 and all("tf32::tangent_d" in n for n in names), \
        names


@pytest.mark.requires_cuda
def test_cuda_f32_forward_and_t2_raise_when_their_kernels_cannot_launch(
        cuda):
    """A batch past the grid's 65535 limit: each float32 launch is refused
    and the call raises; nothing runs in its place."""
    q = torch.ones(65536, 1, 1, 8, device=cuda)
    lse = torch.zeros(65536, 1, 1, device=cuda)
    before = dict(fops.launch_counts)
    with pytest.raises(RuntimeError, match="launch failed"):
        fops.gqa_flash_attention_fwd_lse(q, q, q)
    with pytest.raises(RuntimeError, match="launch failed"):
        fops.flash_attention_bwd_tangent(q, q, q, q, lse, q, q, q, q, q, lse,
                                         q, heads_dim=2)
    assert fops.launch_counts == before


SSD_TANGENT_SHAPES = [(128, 32, 2, 2, 16, 32), (96, 48, 4, 2, 8, 16),
                      (512, 256, 4, 1, 64, 128), (100, 100, 4, 2, 16, 32)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("per_sequence_A", [False, True],
                         ids=["A-shared", "A-per-sequence"])
@pytest.mark.parametrize("L,chunk,H,G,P,N", SSD_TANGENT_SHAPES,
                         ids=["grid128x32", "groups-ragged48", "full-width",
                              "one-chunk-ragged100"])
def test_cuda_ssd_tangent_matches_plain_version(cuda, dtype, per_sequence_A,
                                                L, chunk, H, G, P, N):
    """T3 (y', state') against ``torch.func.jvp`` of the per-step
    recurrence, one launch."""
    gen = torch.Generator().manual_seed(L + chunk)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, L, H, P, N, G, dtype, cuda)
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen).to(
        cuda, t.dtype) for t in (x, dt, A, Bm, Cm))
    if per_sequence_A:
        A, tA = torch.stack([A, 0.5 * A]), torch.stack([tA, -tA])
    before = dict(sops.launch_counts)
    ty, ts = sops.ssd_scan_tangent(x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC,
                                   chunk=chunk)
    passes = int(dtype == torch.bfloat16)      # T3's three bf16 kernels
    assert {k: sops.launch_counts[k] - before[k] for k in (
        "ssd_scan_tangent", "ssd_tangent_state", "ssd_tangent_pass",
        "ssd_tangent_scan")} == {"ssd_scan_tangent": 1,
                                 "ssd_tangent_state": passes,
                                 "ssd_tangent_pass": passes,
                                 "ssd_tangent_scan": passes}
    wy, ws = sref.ssd_scan_tangent_ref(x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC)
    assert_tangent_close(ty, wy.to(dtype))
    assert_tangent_close(ts, ws)
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("L,chunk,H,G,P,N", SSD_PASS_SHAPES,
                         ids=SSD_PASS_IDS)
def test_cuda_t3_passes_match_plain_versions(cuda, L, chunk, H, G, P, N):
    """Each of T3's bfloat16 kernels against its plain version on the same
    inputs (the kernel's own outputs of the pass before), A per sequence,
    each counting its launch: the tangent chunk states and state passing
    (float32) and the tangent chunk outputs (bf16) within TANGENT_TOL."""
    gen = torch.Generator().manual_seed(L + chunk + 2)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, L, H, P, N, G, torch.bfloat16,
                                   cuda)
    A = torch.stack([A, 0.5 * A])
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen).to(
        cuda, t.dtype) for t in (x, dt, A, Bm, Cm))
    before = dict(sops.launch_counts)
    S, tS, seg, tseg = sops.ssd_tangent_state(x, dt, A, Bm, tx, tdt, tA, tB,
                                              chunk=chunk)
    hi, lo, thi, tlo, tstate = sops.ssd_tangent_pass(S, tS, seg, tseg,
                                                     chunk=chunk)
    ty = sops.ssd_tangent_scan(x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC, hi,
                               lo, thi, tlo, chunk=chunk)
    assert {k: sops.launch_counts[k] - before[k] for k in before} == {
        **{k: 0 for k in before}, "ssd_tangent_state": 1,
        "ssd_tangent_pass": 1, "ssd_tangent_scan": 1}
    for got, want in zip((S, tS, seg, tseg), sref.tangent_state_ref(
            x, dt, A, Bm, tx, tdt, tA, tB, chunk)):
        assert_tangent_close(got, want)
    s_in, ts_in, ts_want = sref.tangent_pass_ref(S, tS, seg, tseg, chunk)
    assert_tangent_close(hi.float() + lo.float(), s_in)
    assert_tangent_close(thi.float() + tlo.float(), ts_in)
    assert_tangent_close(tstate, ts_want)
    assert_tangent_close(ty, sref.tangent_scan_ref(
        x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC, hi.float() + lo.float(),
        thi.float() + tlo.float(), chunk))
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_ssd_tangent_stays_finite_where_seg_falls_past_88(cuda):
    """dt near 4 over a 256-step chunk: seg falls by hundreds, and every
    exponential the kernel takes is of a difference that is at most 0."""
    gen = torch.Generator().manual_seed(3)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 256, 2, 16, 32, 1,
                                   torch.float32, cuda)
    dt = dt * 0 + 4.0
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen).to(cuda)
                           for t in (x, dt, A, Bm, Cm))
    ty, ts = sops.ssd_scan_tangent(x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC,
                                   chunk=256)
    assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
    wy, ws = sref.ssd_scan_tangent_ref(x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC)
    assert_tangent_close(ty, wy)


@pytest.mark.requires_cuda
def test_cuda_t3_passes_stay_finite_where_seg_falls_past_88(cuda):
    """The bfloat16 route (T3's three passes) with dt at 4 over two chunks
    of 256 steps and two groups: seg falls by hundreds within each chunk,
    so a masked pair's difference is far past 88; y' and S' stay finite
    and within TANGENT_TOL of the plain version."""
    gen = torch.Generator().manual_seed(3)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 512, 4, 16, 32, 2,
                                   torch.bfloat16, cuda)
    dt = dt * 0 + 4.0
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen).to(
        cuda, t.dtype) for t in (x, dt, A, Bm, Cm))
    before = dict(sops.launch_counts)
    ty, ts = sops.ssd_scan_tangent(x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC,
                                   chunk=256)
    keys = ("ssd_scan_tangent", "ssd_tangent_state", "ssd_tangent_pass",
            "ssd_tangent_scan")
    assert {k: sops.launch_counts[k] - before[k] for k in keys} == {
        k: 1 for k in keys}
    assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
    wy, ws = sref.ssd_scan_tangent_ref(x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC)
    assert_tangent_close(ty, wy.to(torch.bfloat16))
    assert_tangent_close(ts, ws)


def _hvp_through(loss, params, batch, v):
    """vmap over two tasks of jvp(grad): the meta-gradient's nesting."""
    return torch.func.vmap(lambda b, t: torch.func.jvp(
        lambda p: torch.func.grad(loss)(p, b), (params,), (t,))[1])(batch, v)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_cuda_forward_over_reverse_through_the_model_matches_the_cpu(cuda,
                                                                     arch):
    """A reduced model's Hessian-vector products in float32, on the card
    through the kernels (and their tangent kernels) against the CPU (plain
    layers): within 1e-3 of each leaf's largest |value|."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, torch.float32, device="cpu")
    v = {k: torch.randn((2,) + p.shape, generator=gen) * 0.1
         for k, p in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 64), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    want = _hvp_through(model.loss_fn, params, batch, v)
    before = (dict(fops.launch_counts), dict(sops.launch_counts))
    got = _hvp_through(model.loss_fn, {k: p.to(cuda) for k, p in
                                       params.items()},
                       {k: t.to(cuda) for k, t in batch.items()},
                       {k: t.to(cuda) for k, t in v.items()})
    if cfg.arch_type == "ssm":
        assert sops.launch_counts["ssd_scan_tangent"] > \
            before[1]["ssd_scan_tangent"]
    else:
        for key in ("flash_attention_fwd_tangent",
                    "flash_attention_bwd_tangent"):
            assert fops.launch_counts[key] > before[0][key]
    for k in want:
        err = (got[k].cpu() - want[k]).abs().max()
        assert err <= 1e-3 * want[k].abs().max(), (k, float(err))


# The SSD scan's backward (ssd_scan_bwd) and its tangent
# (ssd_scan_bwd_tangent) against their plain passes composed, as
# (rtol, share of the largest |value|): float32 results within 1e-4 of the
# largest |value|; the bf16 route's dx, dB and dC (rounded to bf16) one bf16
# rounding plus 2^-8 of the largest |value| (chip_smoke.py's SSD_BWD_TOL).
SSD_BWD_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (1.6e-2, 2.0 ** -8)}
SSD_BWD_SHAPES = [(128, 32, 2, 2, 16, 32, False), (96, 48, 4, 2, 8, 16, True),
                  (512, 256, 4, 1, 64, 128, True),
                  (100, 100, 4, 2, 16, 32, False)]
SSD_BWD_IDS = ["grid128x32", "groups-ragged48-A-per-seq",
               "full-width-A-per-seq", "one-chunk-ragged100"]


def _bwd_inputs(gen, B, L, H, P, N, G, dtype, device, per_seq):
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, L, H, P, N, G, dtype, device)
    if per_seq:
        A = A * (0.5 + torch.rand(B, 1, generator=gen)).to(device)
    gy = torch.randn(x.shape, generator=gen).to(device, dtype)
    gs = torch.randn(B, H, P, N, generator=gen).to(device)
    args = [x, dt, A, Bm, Cm, gy, gs]
    return args, [torch.randn(a.shape, generator=gen).to(device, a.dtype)
                  for a in args]


def _bwd_plain(args, chunk):
    S, Lc, seg = sref.bwd_state_ref(*args[:6], chunk)
    s_in, gO, sg = sref.bwd_state_pass_ref(S, Lc, seg, args[6], chunk)
    return sref.bwd_chunk_ref(*args[:6], seg, s_in, gO, sg, chunk)


def _bwd_tangent_plain(args, targs, chunk):
    S, tS, Lc, tLc, seg, tseg = sref.tangent_bwd_state_ref(
        *args[:6], *targs[:6], chunk)
    s_in, ts_in, gO, tgO, sg, tsg = sref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, args[6], targs[6], chunk)
    return sref.tangent_bwd_chunk_ref(*args[:6], seg, s_in, gO, sg,
                                      *targs[:6], tseg, ts_in, tgO, tsg,
                                      chunk)


def _assert_bwd_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        rtol, rel = SSD_BWD_TOL[w.dtype]
        err = (g.float() - w.float()).abs()
        assert torch.isfinite(g.float()).all()
        assert (err <= rtol * w.float().abs()
                + rel * w.float().abs().max()).all(), float(err.max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tangent", [False, True], ids=["bwd", "tangent"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L,chunk,H,G,P,N,per_seq", SSD_BWD_SHAPES,
                         ids=SSD_BWD_IDS)
def test_cuda_ssd_bwd_matches_plain_version(cuda, L, chunk, H, G, P, N,
                                            per_seq, dtype, tangent):
    """One call, five launches, within SSD_BWD_TOL of the plain passes
    composed; a second call gives the same bits."""
    gen = torch.Generator().manual_seed(L + chunk + tangent)
    args, targs = _bwd_inputs(gen, 2, L, H, P, N, G, dtype, cuda, per_seq)
    key = "ssd_scan_bwd_tangent" if tangent else "ssd_scan_bwd"
    prefix = "ssd_bwd_tangent_" if tangent else "ssd_bwd_"
    before = dict(sops.launch_counts)
    if tangent:
        call = lambda: sops.ssd_scan_bwd_tangent(*args, *targs, chunk=chunk)
    else:
        call = lambda: sops.ssd_scan_bwd(*args, chunk=chunk)
    got = call()
    after = dict(sops.launch_counts)
    assert after[key] == before[key] + 1
    for p in ("state", "pass", "chunk", "finish", "reduce"):
        assert after[prefix + p] == before[prefix + p] + 1
    want = (_bwd_tangent_plain(args, targs, chunk) if tangent
            else _bwd_plain(args, chunk))
    _assert_bwd_close(got, want)
    for a, b in zip(got, call()):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_cuda_ssd_scan_grad_and_its_jvp_run_the_backward_kernels(cuda):
    """``vmap(jvp(grad))`` through ``ssd_scan`` on the card (the exact
    meta-gradient's shape of call) launches the backward's kernel and its
    tangent's, each once for the three users, never the chunked VJP, and
    matches the CPU (the chunked VJP and its jvp)."""
    gen = torch.Generator().manual_seed(2)
    n, B, L, H, P, N = 3, 2, 128, 4, 16, 32
    xs = torch.randn(n, B, L, H, P, generator=gen)
    dts = torch.nn.functional.softplus(torch.randn(n, B, L, H,
                                                   generator=gen)) * 0.5
    a_log = torch.randn(H, generator=gen) * 0.3
    Bs, Cs = (torch.randn(n, B, L, 1, N, generator=gen) * 0.3 for _ in "BC")
    w = torch.randn(n, B, L, H, P, generator=gen)
    v = torch.randn(n, B, L, H, P, generator=gen)

    def loss(x, dt, a_log, Bm, Cm, w):
        y, s = sops.ssd_scan(x, dt, -torch.exp(a_log), Bm, Cm, chunk=32)
        return (y * w).sum() + 0.1 * (s ** 2).sum()

    def hvp(x, dt, a_log, Bm, Cm, w, v):
        grad = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4))
        return torch.func.jvp(lambda x: grad(x, dt, a_log, Bm, Cm, w), (x,),
                              (v,))

    f = torch.func.vmap(hvp, in_dims=(0, 0, None, 0, 0, 0, 0))
    args = (xs, dts, a_log, Bs, Cs, w, v)
    before = dict(sops.launch_counts)
    got = f(*(t.to(cuda) for t in args))
    for key in ("ssd_scan_bwd", "ssd_scan_bwd_tangent"):
        assert sops.launch_counts[key] == before[key] + 1, key
    want = f(*args)
    for g, w_ in zip(torch.utils._pytree.tree_leaves(got),
                     torch.utils._pytree.tree_leaves(want)):
        err = (g.cpu() - w_).abs().max()
        assert err <= 1e-4 * max(1.0, float(w_.abs().max())), float(err)


@pytest.mark.requires_cuda
def test_cuda_ssd_bwd_raises_instead_of_falling_back(cuda, monkeypatch):
    """A dtype or size the kernels do not take raises, and so does a
    refused launch: no wrapper gives way to the chunked VJP."""
    gen = torch.Generator().manual_seed(3)
    args, targs = _bwd_inputs(gen, 1, 64, 2, 16, 32, 1, torch.float32, cuda,
                              False)
    x, dt, A, Bm, Cm, gy, gs = args
    with pytest.raises(ValueError, match="not supported"):
        sops.ssd_scan_bwd(x.half(), dt, A, Bm.half(), Cm.half(), gy.half(),
                          gs, chunk=32)
    with pytest.raises(ValueError, match="P=80"):
        big = torch.ones(1, 64, 2, 80, device=cuda)
        sops.ssd_scan_bwd(big, dt, A, Bm, Cm, big, torch.ones(
            1, 2, 80, 32, device=cuda), chunk=32)
    with pytest.raises(ValueError, match="float32"):
        sops.ssd_scan_bwd(x, dt.bfloat16(), A, Bm, Cm, gy, gs, chunk=32)
    with pytest.raises(ValueError, match="on cpu"):
        sops.ssd_scan_bwd_tangent(*args, *(t.cpu() for t in targs), chunk=32)
    sops.BWD_LIB.build()
    monkeypatch.setattr(sops.BWD_LIB.lib, "repro_ssd_bwd_launch",
                        lambda *a: 1)
    with pytest.raises(RuntimeError, match="ssd_bwd_state kernel launch"):
        sops.ssd_scan_bwd(*args, chunk=32)
    with pytest.raises(RuntimeError, match="ssd_bwd_tangent_state kernel"):
        sops.ssd_scan_bwd_tangent(*args, *targs, chunk=32)
