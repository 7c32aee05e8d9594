"""The CUDA kernels of ``repro_torch.kernels.dif_combine`` against their plain
PyTorch versions, on the card.  Every test here needs a CUDA card and skips
without one.  The file imports neither JAX nor the reference package, so it
also runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest --noconftest -m requires_cuda \\
      tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.dif_combine import ops, ref

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
