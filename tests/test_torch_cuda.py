"""The CUDA kernels of ``repro_torch.kernels.dif_combine`` and
``repro_torch.kernels.flash_attention`` against their plain PyTorch
versions, on the card.  Every test here needs a CUDA card and skips
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
        before["flash_attention_bwd"] + 2         # dK/dV, then dQ
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
