"""The float32 flash-attention forward's arithmetic on the tensor cores
(``tf32::fwd_kernel`` of ``csrc/flash_attention.cu``), modelled on the CPU.

The kernel visits the keys 32 at a time: S = Q Kᵀ as three TF32 products
(``ref.tf32_matmul``), an online softmax in float32 in log2 units, and P V
as three TF32 products into a fresh accumulator that a float32 update
``O = α O + t`` takes in.  Through that model the output and the per-row
logsumexp stay within the float32 forward tolerance (rtol 1e-5, atol 1e-5,
``chip_smoke.py``'s ``FLASH_TOL[float32]["fwd"]``) of a float64 forward and
of the JAX package's Pallas forward (interpret mode); one TF32 product a
product would not.  The kernel itself runs in test_torch_cuda.py and
chip_smoke.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_fwd_lse as jax_fwd_lse)
from repro_torch.kernels.flash_attention import ref

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = 1.4426950408889634
TILE = 32                      # keys a step visits (tf32::kVis)
MASKS = [(True, None), (False, None), (True, 64)]
MASK_IDS = ["causal", "full", "window64"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fwd_model(q, k, v, causal, window, scale, products):
    """(out, lse) as the kernel computes them on (B, H, S, d) float32
    inputs: per 32-key tile, logits times scale·log2 e, masked pairs at
    -1e30·log2 e, the running row max m and sum l, P = 2^(x - m), and the
    tile's P V added to the rescaled total; lse = (m + log2 l) ln 2."""
    mm = lambda a, b: ref.tf32_matmul(a, b, products)
    S, Sk = q.shape[2], k.shape[2]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    masked = torch.tensor(ref.NEG_INF * LOG2E, dtype=torch.float32)
    mask = ref.band_mask(S, Sk, causal, window)
    m = torch.full(q.shape[:3] + (1,), float(masked))
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape)
    for k0 in range(0, Sk, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        x = torch.where(mask[:, k0:k0 + TILE], mm(q, kt.transpose(-1, -2)) * c,
                        masked)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt)
        m = mx
    lc = l.clamp_min(1e-30)
    return acc * (1.0 / lc), ((m + torch.log2(lc)) * math.log(2.0))[..., 0]


def _fwd_f64(q, k, v, causal, window, scale):
    s = torch.where(ref.band_mask(q.shape[2], k.shape[2], causal, window),
                    q.double() @ k.double().transpose(-1, -2) * scale,
                    ref.NEG_INF)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ v.double(), lse


def _outside(got, want):
    err = (got.double() - want.double()).abs()
    return int((err > FWD_TOL["atol"] + FWD_TOL["rtol"]
                * want.double().abs()).sum())


@pytest.fixture(scope="module", params=[32, 64, 128], ids=lambda d: f"d{d}")
def head_dim(request):
    return request.param


@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
def test_3xtf32_forward_meets_the_float32_tolerance(head_dim, causal,
                                                    window):
    """out and lse through the 3×TF32 model within rtol 1e-5, atol 1e-5 of
    a float64 forward, at head dims 32, 64 and 128 over S = 256 (eight key
    tiles); one TF32 product a product leaves elements outside."""
    d = head_dim
    rng = np.random.default_rng(3 * d + (window or 0) + causal)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((1, 2, 256, d)).astype(np.float32))
        for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    want_out, want_lse = _fwd_f64(q, k, v, causal, window, scale)
    three = _fwd_model(q, k, v, causal, window, scale, 3)
    one = _fwd_model(q, k, v, causal, window, scale, 1)
    bad3 = [_outside(g, w) for g, w in zip(three, (want_out, want_lse))]
    bad1 = [_outside(g, w) for g, w in zip(one, (want_out, want_lse))]
    err = lambda gs: max(float((g.double() - w).abs().max())
                         for g, w in zip(gs, (want_out, want_lse)))
    print(f"d={d} causal={causal} window={window}: 3xTF32 max abs err "
          f"{err(three):.2e} ({sum(bad3)} outside {FWD_TOL}); one TF32 "
          f"product {err(one):.2e} ({sum(bad1)} outside)")
    assert bad3 == [0, 0]
    assert sum(bad1) > 0 and err(one) > 10 * err(three)


@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
def test_3xtf32_forward_matches_the_pallas_forward(head_dim, causal,
                                                   window):
    """The same model against the JAX package's ``flash_attention_fwd_lse``
    run in interpret mode on the same numpy inputs (64-row blocks): out and
    lse within the float32 forward tolerance."""
    d = head_dim
    rng = np.random.default_rng(5 * d + (window or 0) + causal)
    q, k, v = (rng.standard_normal((1, 2, 128, d)).astype(np.float32)
               for _ in range(3))
    out, lse = jax_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, block_q=64,
                           block_k=64, interpret=True)
    got_out, got_lse = _fwd_model(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal, window, 1.0 / math.sqrt(d), 3)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), **FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               **FWD_TOL)
