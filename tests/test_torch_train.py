"""The LM meta-training slice beyond the step itself: the superstep, the
stacked pipeline, the eval harness and ``split_seed`` against the
reference, the checkpoint exchange with the JAX package, and the driver
(``launch/train.py``) end to end on the CPU (set-up in
torch_train_ref.py)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.data.lm_tasks import LMTaskSource as JaxLMTaskSource
from repro.eval.harness import EvalHarness as JaxHarness
from repro.eval.harness import split_seed as jax_split_seed
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.convert import from_jax_params
from repro_torch.data.lm_tasks import LMTaskSource
from repro_torch.eval.harness import split_seed
from repro_torch.launch import steps as S
from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, SEQ, BATCH = R.K, R.SEQ, R.BATCH
ARCHS = R.ARCHS


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ARCHS)
def test_superstep_of_two_equals_two_steps(arch):
    """``make_superstep`` at C=2 over ``make_pipeline(stack=2)`` equals two
    ``step_fn`` calls over the per-step pipeline, step for step."""
    _, cfg = R.cfgs(arch, "float32")
    bundle = R.port_bundle(cfg, "dense")
    src = LMTaskSource(vocab_size=512, seq_len=SEQ, K=K, tasks_per_agent=2,
                       task_batch=1, n_domains=18, holdout_domains=2)
    state0 = bundle.init_state(seed=1)
    with bundle.make_pipeline(src, depth=0) as pipe:
        s, per_step = state0, []
        for _ in range(4):
            s, m = bundle.step_fn(s, next(pipe))
            per_step.append([float(m[k]) for k in S.SUPERSTEP_METRICS])
    sup = S.make_superstep(bundle.step_fn)
    with bundle.make_pipeline(src, depth=2, stack=2) as pipe:
        t, got = state0, []
        for _ in range(2):
            batch = next(pipe)
            assert batch["tokens"].shape == (2, BATCH, SEQ)
            t, m = sup(t, batch)
            got += list(zip(*[m[k].tolist() for k in S.SUPERSTEP_METRICS]))
    assert t.step == s.step == 4
    np.testing.assert_array_equal(np.array(got), np.array(per_step))
    for k in s.params:
        torch.testing.assert_close(t.params[k], s.params[k], rtol=0, atol=0)


def test_stacked_pipeline_groups_without_reordering():
    """``stack=3`` items are episodes (3i, 3i+1, 3i+2) in order, equal to
    the per-step items, whatever the prefetch depth."""
    _, cfg = R.cfgs("qwen2-1.5b", "float32")
    bundle = R.port_bundle(cfg, "dense")
    src = LMTaskSource(vocab_size=512, seq_len=SEQ, K=K, tasks_per_agent=2,
                       task_batch=1, n_domains=18, holdout_domains=2)
    with bundle.make_pipeline(src, depth=0, start_step=5) as pipe:
        single = [next(pipe) for _ in range(6)]
    for depth in (0, 2):
        with bundle.make_pipeline(src, depth=depth, start_step=5,
                                  stack=3) as pipe:
            stacked = [next(pipe) for _ in range(2)]
            assert pipe.step == 11
        for i, item in enumerate(stacked):
            for j in range(3):
                for k in item:
                    assert torch.equal(item[k][j], single[3 * i + j][k])
    with pytest.raises(ValueError, match="does not match"):
        bundle.make_pipeline(LMTaskSource(K=2), depth=0)


def test_split_seed_and_eval_harness_match_reference():
    """``split_seed`` and ``EvalHarness.evaluate`` (report and
    ``to_record()``) against the reference on the same state and source."""
    for seed in (None, 0, 7, 2 ** 31 - 5):
        for split in ("recurring", "unseen", "full"):
            assert split_seed(seed, split) == jax_split_seed(seed, split)
    jcfg, cfg = R.cfgs("mamba2-130m", "float32")
    _, jstate, jmodel = R.jax_setup(jcfg, "dense")
    jsrc = JaxLMTaskSource(vocab_size=512, seq_len=SEQ, K=K,
                           tasks_per_agent=2, task_batch=1, n_domains=18,
                           holdout_domains=2, seed=3)
    src = LMTaskSource(vocab_size=512, seq_len=SEQ, K=K, tasks_per_agent=2,
                       task_batch=1, n_domains=18, holdout_domains=2, seed=3)
    want = JaxHarness(jmodel.loss_fn, inner_lr=jcfg.inner_lr,
                      inner_steps=2).evaluate(jstate, jsrc, 3, seed=11)
    bundle = R.port_bundle(cfg, "dense")
    got = bundle.make_eval_harness(2).evaluate(
        R.to_port(jstate), src, 3, seed=11, prepare=bundle.eval_prepare())
    rg, rw = got.to_record(), want.to_record()
    assert set(rg) == set(rw) and rg["step"] == rw["step"] == 0
    assert set(rg["splits"]) == {"recurring", "unseen"}
    for name, s in rw["splits"].items():
        assert rg["splits"][name]["n_tasks"] == s["n_tasks"] == 3
        for curve in ("centroid_curve", "agent_curve"):
            np.testing.assert_allclose(rg["splits"][name][curve], s[curve],
                                       rtol=1e-5)
    np.testing.assert_allclose(rg["generalization_gap"],
                               rw["generalization_gap"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rg["disagreement"], rw["disagreement"],
                               rtol=1e-5)
    json.dumps(rg)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_exchange_resumes_training(direction, tmp_path):
    """One package trains 2 steps and saves; the other restores and trains
    2 more; the result matches the first package's 4 uninterrupted steps."""
    jcfg, cfg = R.cfgs("qwen2-1.5b", "float32")
    jstep, jstate, _ = R.jax_setup(jcfg, "fused")
    bundle = R.port_bundle(cfg, "fused")
    eps = R.episodes(n=4)
    jb = [{k: jnp.asarray(v) for k, v in ep.as_flat_batch().items()}
          for ep in eps]
    ref = jstate
    for b in jb:
        ref, ref_m = jstep(ref, b)
    d = str(tmp_path)
    if direction == "jax-to-port":
        s = jstate
        for b in jb[:2]:
            s, _ = jstep(s, b)
        jax_save(d, 2, s)
        like = bundle.init_state(seed=5)
        state = restore_checkpoint(d, like)
        assert state.step == 2 and state.opt_state.step.dtype == torch.int32
        for ep in eps[2:]:
            state, m = bundle.step_fn(state, R.flat(ep))
        want = from_jax_params(jax.tree.map(np.asarray, ref.params), "cpu")
        R.assert_params_close(state.params, want, R.PARAMS_ATOL["float32"], 4)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=R.LOSS_RTOL["float32"])
    else:
        state = R.to_port(jstate)
        for ep in eps[:2]:
            state, _ = bundle.step_fn(state, R.flat(ep))
        save_checkpoint(d, 2, state)
        s = jax_restore(d, jstate)
        assert int(s.step) == 2
        for b in jb[2:]:
            s, m = jstep(s, b)
        as_port = lambda t: from_jax_params(jax.tree.map(np.asarray, t),
                                            "cpu")
        R.assert_params_close(as_port(s.params), as_port(ref.params),
                             R.PARAMS_ATOL["float32"], 4)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=R.LOSS_RTOL["float32"])


def _check_log(path, *flags):
    out = subprocess.run([sys.executable,
                          os.path.join(ROOT, "scripts", "check_run_log.py"),
                          path, *flags], capture_output=True, text=True,
                         timeout=60, check=False)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_end_to_end_with_eval_checkpoint_and_resume(arch, tmp_path):
    """``train.main`` on the CPU: 4 steps in dispatches of 2 with eval and
    checkpoints, the log accepted by ``scripts/check_run_log.py``; then a
    run resumed from the step-2 checkpoint reaches the same step-4 loss
    and appends to its own log."""
    log, ck = str(tmp_path / "run.jsonl"), str(tmp_path / "ck")
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "64",
            "--global-batch", "16", "--agents", "4",
            "--steps-per-dispatch", "2", "--eval-every", "2",
            "--eval-tasks", "2", "--eval-inner-steps", "1",
            "--ckpt-every", "2", "--prefetch", "0"]
    extra = ["--fused-outer"] if arch == "mamba2-130m" else \
        ["--combine", "pallas"]
    full = train.main(argv + extra + ["--steps", "4", "--ckpt-dir", ck,
                                      "--run-log", log])
    assert sorted(full["losses"]) == [1, 2, 3, 4]
    assert all(np.isfinite(list(full["losses"].values())))
    flags = ["--expect-outer-dtype", "bfloat16"]
    if arch == "mamba2-130m":
        flags.append("--expect-fused")
    _check_log(log, *flags)
    records = [json.loads(line) for line in open(log)]
    assert [r["kind"] for r in records].count("eval") == 2
    # resume from the step-2 checkpoint alone
    ck2 = tmp_path / "ck2" / "seed0"
    ck2.mkdir(parents=True)
    os.link(os.path.join(ck, "seed0", "ckpt_00000002.npz"),
            ck2 / "ckpt_00000002.npz")
    log2 = str(tmp_path / "resumed.jsonl")
    with open(log2, "w") as f:
        f.write(open(log).readlines()[0])
    resumed = train.main(argv + extra + ["--steps", "2", "--ckpt-dir",
                                         str(tmp_path / "ck2"),
                                         "--run-log", log2])
    assert sorted(resumed["losses"]) == [3, 4]
    np.testing.assert_allclose(resumed["losses"][4], full["losses"][4],
                               rtol=1e-6)
    lines = open(log2).readlines()
    assert json.loads(lines[0])["kind"] == "config" and len(lines) > 2
    _check_log(log2, *flags)


def test_input_specs_match_reference():
    """``input_specs``: the reference's shapes and dtypes, as meta tensors,
    for a train shape and a decode shape (with the KV cache's leaves)."""
    from repro.configs import get_config as jax_config
    from repro.configs.base import InputShape as JaxShape
    from repro.launch import steps as JS
    from repro_torch.configs import InputShape, get_config
    for kind in ("train", "decode"):
        want = JS.input_specs(jax_config("qwen2-1.5b").reduced(),
                              JaxShape("s", 32, 4, kind))
        got = S.input_specs(get_config("qwen2-1.5b").reduced(),
                            InputShape("s", 32, 4, kind))
        if kind == "decode":
            flat = jax.tree_util.tree_flatten_with_path(want.pop("cache"))[0]
            cache = got.pop("cache")
            assert len(cache) == len(flat)
            for (path, leaf), (k, t) in zip(flat, cache.items()):
                assert tuple(t.shape) == leaf.shape and t.device.type == "meta"
        assert set(got) == set(want)
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


def test_driver_refuses_what_is_not_ported():
    base = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu"]
    for extra in (["--multi-pod"], ["--mesh-agents", "2"]):
        with pytest.raises(SystemExit):
            train.main(base + extra)
    with pytest.raises(ValueError, match="not ported"):
        train.main(base + ["--combine", "sparse", "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(base + ["--fused-outer", "--combine", "dense"])
