"""The twins of the reference's examples and the small functions they
need, against the reference: the legacy sine API, ``maml.meta_loss``,
``meta_trainer.combination_matrix_for``, ``models.init.count_params``, one
``--tiny`` step of ``launch/decentralized_lm.py`` against the reference's
``build_train`` step on a 4-device CPU mesh, and ``launch/fewshot.py`` and
``launch/serve_adapted.py`` end to end on the CPU."""
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from repro.configs import get_config as jax_config
from repro.core import maml as jmaml
from repro.core import meta_trainer as jmt
from repro.data import agent_sine_distributions as jax_dists
from repro.data.sine import stacked_agent_batch as jax_stacked
from repro.models.init import count_params as jax_count_params
from repro.models.simple import FewShotCNN as JaxCNN
from repro.models.simple import SineMLP as JaxMLP
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core import MetaConfig, TopologyConfig, TrainState, maml
from repro_torch.core.meta_trainer import combination_matrix_for
from repro_torch.data import SineTaskDistribution, agent_sine_distributions
from repro_torch.data.sine import stacked_agent_batch
from repro_torch.launch import decentralized_lm, fewshot
from repro_torch.models import FewShotCNN, SineMLP, build_model, count_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
# meta_loss: one task of the sine MLP, float32 both sides (the same sums
# in another order).
META_LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_example(name):
    """A module of ``examples/`` by path (they are scripts, not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_legacy_sine_api_gives_the_references_arrays():
    """``agent_sine_distributions`` and ``stacked_agent_batch`` over two
    draws (the distributions' generators advance), and one distribution on
    its own: equal arrays."""
    port, ref = agent_sine_distributions(4, seed=2), jax_dists(4, seed=2)
    assert [(d.amp_lo, d.amp_hi, d.seed) for d in port] == \
        [(d.amp_lo, d.amp_hi, d.seed) for d in ref]
    for _ in range(2):
        got, want = stacked_agent_batch(port, 3, 5), jax_stacked(ref, 3, 5)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype == np.float32
            assert a.shape == b.shape == (4, 3, 5, 1)
            np.testing.assert_array_equal(a, b)
    from repro.data import SineTaskDistribution as JaxDist
    got = SineTaskDistribution(1.0, 2.0, 7).sample_batch(6, 10)
    want = JaxDist(1.0, 2.0, 7).sample_batch(6, 10)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["maml", "fomaml", "reptile"])
def test_meta_loss_matches_reference(mode):
    """The single-task meta objective after two inner steps."""
    jm = JaxMLP(jax_config("sine_mlp"))
    jp = jm.init(jax.random.key(3))
    rng = np.random.default_rng(1)
    xs, xq = (rng.uniform(-5, 5, size=(10, 1)).astype(np.float32)
              for _ in range(2))
    sup, qry = (xs, np.sin(xs)), (xq, np.sin(xq))
    want = float(jmaml.meta_loss(jm.loss_fn, jp, jax.tree.map(jnp.asarray,
                                                              sup),
                                 jax.tree.map(jnp.asarray, qry), 0.01,
                                 steps=2, mode=mode))
    m = SineMLP(get_config("sine_mlp"))
    got = float(maml.meta_loss(
        m.loss_fn, from_jax_params(jax.tree.map(np.asarray, jp), "cpu"),
        tuple(map(torch.from_numpy, sup)), tuple(map(torch.from_numpy, qry)),
        0.01, steps=2, mode=mode))
    np.testing.assert_allclose(got, want, rtol=META_LOSS_RTOL)


@pytest.mark.parametrize("graph,K", [("paper", 6), ("ring", 4), ("full", 5),
                                     ("ring", 1)])
def test_combination_matrix_matches_reference(graph, K):
    want = jmt.combination_matrix_for(jmt.MetaConfig(
        num_agents=K, topology_config=jmt.TopologyConfig(graph=graph)))
    got = combination_matrix_for(MetaConfig(
        num_agents=K, topology_config=TopologyConfig(graph=graph)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["omniglot_cnn", "lm-tiny", "lm-100m",
                                   "qwen2-1.5b", "mamba2-130m"])
def test_count_params_matches_reference(which):
    """``count_params`` of the few-shot CNN, the example's lm-100m (and its
    tiny cut) and the reduced qwen2-1.5b and mamba2-130m, against the
    reference's count of its own specs."""
    ex = _load_example("decentralized_lm")
    if which == "omniglot_cnn":
        got = count_params(FewShotCNN(get_config(which)).specs())
        want = jax_count_params(JaxCNN(jax_config(which)).specs())
        assert got == want == 11_013
        return
    if which.startswith("lm-"):
        tiny = which == "lm-tiny"
        cfg, jcfg = decentralized_lm.lm_100m(tiny), ex.lm_100m(tiny)
    else:
        cfg, jcfg = get_config(which).reduced(), jax_config(which).reduced()
    got = count_params(build_model(cfg).specs())
    assert got == jax_count_params(jax_build_model(jcfg).specs())


# The reference's step of the example, run in a subprocess with four CPU
# devices: its build_train takes K from the host mesh (data=4), as
# examples/decentralized_lm.py does.  It writes the initial state, the
# first batch, the step's metrics and the stepped params as numpy.
_REF_STEP = r"""
import pickle, sys
import jax, numpy as np
from repro.configs.base import InputShape
from repro.data import LMTaskSource
from repro.launch import steps as S
from repro.launch.mesh import make_host_mesh
sys.path.insert(0, sys.argv[2])
import decentralized_lm as ex

cfg = ex.lm_100m(True)
shape = InputShape("lm_example", 32, 8, "train")
to_np = lambda t: jax.tree.map(np.asarray, t)
mesh = make_host_mesh(data=min(4, len(jax.devices())))
with mesh:
    bundle = S.build_train(cfg, mesh, shape)
    state = bundle.init_state(seed=0)
    init = (to_np(state.params), to_np(state.opt_state))
    source = LMTaskSource(
        vocab_size=cfg.padded_vocab, seq_len=32, K=bundle.K,
        tasks_per_agent=bundle.T, task_batch=bundle.tb,
        n_domains=8 * bundle.K, holdout_domains=1, seed=0)
    with bundle.make_pipeline(source, depth=0) as pipe:
        batch = next(pipe)
    state, m = jax.jit(bundle.step_fn)(state, batch)
    out = dict(K=bundle.K, T=bundle.T, tb=bundle.tb, init=init,
               batch=to_np(batch), loss=float(m["loss"]),
               disagreement=float(m["disagreement"]),
               params=to_np(state.params))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def test_decentralized_lm_tiny_step_matches_reference(tmp_path):
    """One ``--tiny`` step of ``launch/decentralized_lm.py`` (K=4 from
    ``--agents``) from the reference's initial state against the
    reference's ``build_train`` step (K=4 from its 4-device mesh): the same
    geometry and batch, the loss and the params within
    test_torch_train.py's float32 limits."""
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_STEP, str(out), str(ROOT / "examples")],
        env=env, capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        ref = pickle.load(f)
    state = TrainState(0, from_jax_params(ref["init"][0], "cpu"),
                       from_jax_opt_state(ref["init"][1], "cpu"))
    args = decentralized_lm.parse_args(["--tiny", "--steps", "1",
                                        "--device", "cpu", "--prefetch",
                                        "0"])
    with pytest.warns(RuntimeWarning, match="falling back to T=1"):
        res = decentralized_lm.run(args, state=state)
    bundle = res["bundle"]
    assert (bundle.K, bundle.T, bundle.tb) == (ref["K"], ref["T"],
                                               ref["tb"]) == (4, 1, 1)
    src = decentralized_lm.make_source(bundle.cfg, 32, bundle)
    got_batch = src.sample(0).as_flat_batch()
    for k, v in ref["batch"].items():
        np.testing.assert_array_equal(got_batch[k], v)
    np.testing.assert_allclose(float(res["loss"][0]), ref["loss"],
                               rtol=R.LOSS_RTOL["float32"])
    want = from_jax_params(ref["params"], "cpu")
    R.assert_params_close(res["state"].params, want,
                          R.PARAMS_ATOL["float32"], steps=1)
    assert set(res["report"].splits) == {"recurring", "unseen"}
    assert np.isfinite(res["report"].generalization_gap)


def test_fewshot_entry_point_learns_on_cpu():
    """``launch/fewshot.py --device cpu``: the Dif-MAML run's meta-train
    loss falls and its test accuracy beats chance (0.2) well."""
    out = fewshot.main(["--device", "cpu", "--steps", "20", "--strategies",
                        "dif-maml", "--prefetch", "0"])
    run = out["dif-maml"]
    loss = run["loss"].numpy()
    assert loss.shape == (20,) and np.isfinite(loss).all()
    assert loss[-5:].mean() < 0.9 * loss[:5].mean(), loss
    assert float(run["disagreement"].max()) < 1e-2
    assert run["accuracy"] > 0.5


def test_serve_adapted_on_cpu_writes_an_accepted_log(tmp_path):
    """``launch/serve_adapted.py --device cpu`` exits 0, and its serve log
    passes ``scripts/check_run_log.py --serve``."""
    log = tmp_path / "serve.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_adapted",
         "--device", "cpu", "--ckpt-root", str(tmp_path / "ckpt"),
         "--run-log", str(log)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "ckpt" / "seed0").is_dir()
    check = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_run_log.py"),
         "--serve", str(log)], capture_output=True, text=True, timeout=120,
        check=False)
    assert check.returncode == 0, check.stdout + check.stderr
