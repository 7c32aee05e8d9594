"""The two kernels of the training step: their plain PyTorch versions (what
the wrappers compute on CPU tensors) against the JAX Pallas kernels run in
interpret mode, and the packing both kernel paths share.  The CUDA kernels
themselves are held against these plain versions in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology
from repro.kernels.dif_combine.dif_combine import dif_combine as jax_combine
from repro.kernels.dif_combine.ops import fused_update_flat
from repro_torch.core import diffusion
from repro_torch.kernels.dif_combine import ops

# f32: the same f32 products summed in another order.  bf16: outputs are
# rounded to bf16 after that, so a sum that differs in its last f32 ulp can
# land one bf16 ulp (2^-8 relative) away.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x, dtype="float32"):
    """numpy (or jax) array -> CPU tensor of ``dtype``, exactly."""
    return torch.from_numpy(np.array(x, np.float32)).to(TDT[dtype])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# dif_combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 6, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dif_combine_plain_matches_pallas(K, dtype):
    rng = np.random.default_rng(K)
    A = topology.combination_matrix(K, "ring").astype(np.float32)
    phi = jnp.asarray(rng.normal(size=(K, 512)), JDT[dtype])
    want = jax_combine(jnp.asarray(A), phi, block_m=128, interpret=True)
    got = ops.dif_combine(torch.from_numpy(A), _t(phi, dtype))
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (K, 512)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def test_pack_round_trips_ragged_leaves_exactly():
    """pack_pytree pads by pad_geometry; unpack of the untouched buffers
    gives every leaf back bit for bit, and the pad is zero."""
    K = 4
    rng = np.random.default_rng(0)
    phi = {"a": torch.from_numpy(rng.normal(size=(K, 3, 37)).astype(np.float32)),
           "b": torch.from_numpy(rng.normal(size=(K, 130)).astype(np.float32)),
           "c": torch.randn(K, 5).to(torch.bfloat16)}
    bufs, unpack = diffusion.pack_pytree(phi, block_m=128)
    assert [tuple(b.shape) for b in bufs] == [(K, 256), (K, 128)]
    assert torch.count_nonzero(bufs[0][:, 111 + 130:]) == 0
    back = unpack(bufs)
    for k, x in phi.items():
        assert back[k].dtype == x.dtype
        assert torch.equal(back[k], x), k


@pytest.mark.parametrize("m", [1, 40, 128, 1600, 1761])
def test_one_padding_rule_for_both_kernel_paths(m):
    """A single leaf packs to the width the fused path pads it to."""
    bufs, _ = diffusion.pack_pytree({"x": torch.ones(3, m)})
    m_pad, bm = diffusion.pad_geometry(m, 512)
    assert bufs[0].shape[1] == m_pad and m_pad % 128 == 0 and m_pad >= m
    assert bm == min(m_pad, 512)


def test_packed_kernel_combine_matches_dense():
    K = 4
    A = topology.combination_matrix(K, "full")
    phi = {"a": torch.randn(K, 3, 37), "b": torch.randn(K, 130)}
    got = diffusion.make_combine("pallas", A, device="cpu")(phi)
    want = diffusion.make_combine("dense", A, device="cpu")(phi)
    for k in phi:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fused_combine_update
# ---------------------------------------------------------------------------

def _fused_inputs(rng, K, M, S, kind, dtype, clip):
    tab = rng.random((S, K, K)).astype(np.float32)
    scale = (rng.random((K, 1)) if clip else np.ones((K, 1))).astype(np.float32)
    w = rng.normal(size=(K, M))
    g = rng.normal(size=(K, M))
    mu = nu = None
    if kind == "adam":
        mu = rng.normal(size=(K, M)).astype(np.float32) * 0.1
        nu = rng.random((K, M)).astype(np.float32) * 0.01
    elif kind == "momentum":
        mu = rng.normal(size=(K, M))
    return tab, scale, w, g, mu, nu


CASES = [(k, m, "float32") for k in ops.KINDS for m in ops.MODES] + [
    ("adam", m, "bfloat16") for m in ops.MODES]


@pytest.mark.parametrize("kind,mode,dtype", CASES)
def test_fused_plain_matches_pallas(kind, mode, dtype):
    K, M = 6, 256
    rng = np.random.default_rng(7)
    mom_dt = "float32" if kind == "adam" else dtype
    hyper = dict(mode=mode, kind=kind, lr=1e-2, weight_decay=0.05 * (
        kind == "adam"))
    for S in (1, 4):
        for gate in (0.0, 1.0):
            for clip in (False, True):
                tab, scale, w, g, mu, nu = _fused_inputs(rng, K, M, S, kind,
                                                         dtype, clip)
                sel = np.array([[S - 1]], np.int32)
                ctl = np.array([[gate, 0.271, 0.0199]], np.float32)
                jm = [jnp.asarray(x, JDT[mom_dt if i == 0 else "float32"])
                      for i, x in enumerate((mu, nu)) if x is not None]
                want = fused_update_flat(
                    jnp.asarray(tab), jnp.asarray(sel), jnp.asarray(ctl),
                    jnp.asarray(scale), jnp.asarray(w, JDT[dtype]),
                    jnp.asarray(g, JDT[dtype]), *jm, block_m=128,
                    interpret=True, **hyper)
                tm = [_t(x, mom_dt if i == 0 else "float32")
                      for i, x in enumerate((mu, nu)) if x is not None]
                got = ops.fused_combine_update(
                    torch.from_numpy(tab), torch.from_numpy(sel),
                    torch.from_numpy(ctl), torch.from_numpy(scale),
                    _t(w, dtype), _t(g, dtype), *tm, **hyper)
                for name, a, b in zip(("w", "mu", "nu"), got, want):
                    if b is None:
                        assert a is None, name
                        continue
                    assert a.dtype == TDT[str(b.dtype)], name
                    np.testing.assert_allclose(
                        a.float().numpy(), _np(b), err_msg=f"{name} S={S} "
                        f"gate={gate} clip={clip}", **TOL[str(b.dtype)])


@pytest.mark.parametrize("mode", ops.MODES)
@pytest.mark.parametrize("kind", ops.KINDS)
def test_fused_padded_columns_stay_zero(kind, mode):
    K, M, pad = 5, 200, 56
    rng = np.random.default_rng(1)
    tab, scale, w, g, mu, nu = _fused_inputs(rng, K, M + pad, 2, kind,
                                             "float32", True)
    bufs = [x for x in (w, g, mu, nu) if x is not None]
    for x in bufs:
        x[:, M:] = 0
    outs = ops.fused_combine_update(
        torch.from_numpy(tab), torch.tensor([[1]], dtype=torch.int32),
        torch.tensor([[1.0, 0.1, 0.001]]), torch.from_numpy(scale),
        *(_t(x) for x in bufs), mode=mode, kind=kind, lr=0.1,
        weight_decay=0.01 * (kind == "adam"))
    for o in outs:
        if o is not None:
            assert torch.count_nonzero(o[:, M:]) == 0
            assert torch.count_nonzero(o[:, :M]) > 0


def test_wrappers_reject_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises — never a silent fallback."""
    A = torch.eye(2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.dif_combine(A, torch.empty(2, 128, device="meta"))
    with pytest.raises(ValueError, match="exceeds"):
        ops._check_cuda("dif_combine", 65, torch.float32, {})
