"""The MoE family's meta-training step and serving round against the
reference's, at reduced width.

The step: the port's ``build_train`` for reduced deepseek-v2-lite-16b
(``fomaml``, momentum) and mixtral-8x22b (``fomaml``, sgd) at K=4 against
``repro.core.make_meta_step``, three steps, in float32 and with a bfloat16
outer dtype (set-up and limits in torch_train_ref.py).  The serving round:
one vmapped adaptation of three users and a greedy decode of reduced
deepseek through the port's ``ServeEngine`` against the reference's, in
float32, the engines padding the users to a bucket of 4 (the padded user's
tokens are routed and take capacity in its own groups on both sides)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from repro.configs import get_config as jax_config
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import ServeEngine

# float32 both sides through two inner SGD steps of a 2-layer model
# (tests/test_torch_serve.py's limit).
ADAPT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# The reference's pallas backend runs its kernel in interpret mode, 70 s a
# bfloat16 case here; test_torch_train_qwen2.py holds that pairing.
CASES = [("dense", "float32"), ("dense", "bfloat16"), ("fused", "float32"),
         ("fused", "bfloat16"), ("pallas", "float32")]


@pytest.mark.parametrize("backend,dtype", CASES)
@pytest.mark.parametrize("arch,optimizer", [
    ("deepseek-v2-lite-16b", "momentum"), ("mixtral-8x22b", "sgd")])
def test_train_step_matches_reference(arch, optimizer, backend, dtype):
    """Three ``fomaml`` steps, ATC on the ring, the config's outer
    optimizer: per-step losses and the final params."""
    jcfg, cfg = R.cfgs(arch, dtype)
    assert (cfg.meta_mode, cfg.outer_optimizer) == ("fomaml", optimizer)
    jstep, jstate, _ = R.jax_setup(jcfg, backend)
    bundle = R.port_bundle(cfg, backend)
    assert (bundle.T, bundle.tb, bundle.combine_backend) == (2, 1, backend)
    assert bundle.mcfg.update_config.inner == "fomaml"
    state = R.to_port(jstate)
    for ep in R.episodes():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in ep.as_flat_batch().items()})
        state, m = bundle.step_fn(state, R.flat(ep))
        assert np.isfinite(float(jm["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=R.LOSS_RTOL[dtype])
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params), "cpu")
    assert int(state.step) == R.STEPS
    R.assert_params_close(state.params, want, R.PARAMS_ATOL[dtype], R.STEPS)


P, G, B = 4, 4, 2


@pytest.fixture(scope="module")
def engines():
    arch = "deepseek-v2-lite-16b"
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jeng = JaxServeEngine(jcfg, prompt_len=P, gen=G, batch=B, adapt_steps=2,
                          buckets=(1, 2, 4), dtype=jnp.float32)
    jparams = jeng.model.init(jax.random.key(0), jnp.float32)
    jeng.load_params(jparams)
    eng = ServeEngine(cfg, prompt_len=P, gen=G, batch=B, adapt_steps=2,
                      buckets=(1, 2, 4), dtype=torch.float32, device="cpu")
    eng.load_params(from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu"))
    return jeng, eng


def test_serve_round_matches_the_reference_engine(engines):
    """Three users' support episodes through ``adapt`` (a miss round padded
    to the bucket of 4, then a hit round from the low-rank cache) and a
    greedy decode from the first adapted model, against the reference
    engine on the same episode."""
    jeng, eng = engines
    source = serve_cli.make_support_source(eng.cfg, P + G, B)
    ep = source.eval_sample(3, seed=3, split="full")
    jreq = jeng.requests_from_episode(source, ep)
    req = eng.requests_from_episode(source, ep)
    jstates, jm = jeng.adapt(jreq)
    states, m = eng.adapt(req)
    assert (m["misses"], m["buckets"]) == (jm["misses"], jm["buckets"]) == (
        3, [4])
    for js, s in zip(jstates, states):
        want = from_jax_params(jax.tree.map(np.asarray, js), device="cpu")
        for k, v in s.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=ADAPT_ATOL, rtol=0, err_msg=k)
    _, jhit = jeng.adapt(jreq)
    _, hit = eng.adapt(req)
    assert hit["hits"] == jhit["hits"] == 3
    prompt = np.asarray(ep.query["tokens"][0])[:, :P]
    jtoks, _ = jeng.decode(jstates[0], prompt)
    toks, _ = eng.decode(states[0], prompt)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))


def test_trainer_checkpoints_once_and_resumes_without_writing(
        tmp_path, monkeypatch):
    """``launch/train.py`` for reduced deepseek on the CPU: 4 steps
    uninterrupted; 2 steps with ``--ckpt-every 2`` write the step-2
    checkpoint once (the run's end does not write the step its last
    dispatch saved); 2 more resumed from it with ``--ckpt-every 0`` write
    none, draw no weights, and reach the uninterrupted step-4 loss."""
    from repro_torch.launch import train
    saves = []
    real_save = train.save_checkpoint
    monkeypatch.setattr(train, "save_checkpoint", lambda d, step, st: (
        saves.append(step), real_save(d, step, st))[1])
    argv = ["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
            "--seq", "32", "--global-batch", "16", "--agents", "4",
            "--fused-outer", "--steps-per-dispatch", "2", "--prefetch", "0",
            "--ckpt-every", "2"]
    full = train.main(argv + ["--steps", "4", "--run-log",
                              str(tmp_path / "full.jsonl")])
    ck = str(tmp_path / "ck")
    train.main(argv + ["--steps", "2", "--ckpt-dir", ck, "--run-log",
                       str(tmp_path / "ck.jsonl")])
    assert saves == [2]
    drawn = []
    real_init = train.S.TrainBundle.__init__

    def spy(self, *a, **kw):
        real_init(self, *a, **kw)
        init = self.init_state
        self.init_state = lambda seed=0, draw=True: (drawn.append(draw),
                                                     init(seed, draw))[1]

    monkeypatch.setattr(train.S.TrainBundle, "__init__", spy)
    resumed = train.main(argv + ["--steps", "2", "--ckpt-dir", ck,
                                 "--ckpt-every", "0", "--run-log",
                                 str(tmp_path / "resumed.jsonl")])
    assert saves == [2] and drawn == [False]
    assert sorted(resumed["losses"]) == [3, 4]
    np.testing.assert_allclose(resumed["losses"][4], full["losses"][4],
                               rtol=1e-6)
