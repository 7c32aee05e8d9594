"""The encoder-decoder and vision families' meta-training step and serving
round against the reference's, at reduced width, with random frames and
patches and every cross gate at 0.5 (torch_encdec_ref.py).

The step: the port's ``build_train`` at K=4 against
``repro.core.make_meta_step`` (set-up and limits in torch_train_ref.py),
three steps on the same episodes: whisper-large-v3 in its config's mode
(exact ``maml``, Adam), llama-3.2-vision-90b in its (``fomaml``, sgd), and
whisper with ``inner_freeze="encoder"``, whose encoder leaves are frozen
in the inner loop (the reference's ANIL mask) and still trained by the
outer step.  The serving round: one vmapped adaptation of three users
and a greedy decode through the port's ``ServeEngine`` against the
reference's, in float32, the engines stubbing frames and patches with
zeros as the reference does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_encdec_ref as E
import torch_train_ref as R
from repro.configs import get_config as jax_config
from repro.core import make_meta_step as jax_meta_step
from repro.core.meta_trainer import TrainState as JaxTrainState
from repro.core.meta_trainer import schedule_for as jax_schedule_for
from repro.configs.base import InputShape as JaxShape
from repro.launch import steps as JS
from repro.models.init import abstract
from repro.models.transformer import build_model as jax_build_model
from repro.optim import get_optimizer as jax_optimizer
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import ServeEngine

# float32 both sides through two inner SGD steps of a small model
# (tests/test_torch_serve.py's limit).
ADAPT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_setup(jcfg):
    """The reference's step for ``jcfg`` (dense combine) with its
    ``build_train`` freeze mask, and its initial state with every gate at
    GATE."""
    shape = JaxShape("t", R.SEQ, R.BATCH, "train")
    T, tb = JS.batch_geometry(jcfg, shape, R.K)
    mcfg = JS.meta_config_for(jcfg, R.K, T)
    model = jax_build_model(jcfg)
    opt = jax_optimizer(jcfg.outer_optimizer, jcfg.outer_lr)
    out_dt = JS.DTYPES[jcfg.outer_dtype or jcfg.dtype]
    freeze_mask = None
    if jcfg.inner_freeze:
        freeze_mask = jax.tree_util.tree_map_with_path(
            lambda path, _: any(getattr(k, "key", None) == jcfg.inner_freeze
                                for k in path),
            abstract(model.specs(), out_dt))
    meta = jax_meta_step(model.loss_fn, mcfg, optimizer=opt,
                         A=jax_schedule_for(mcfg).stacked(),
                         freeze_mask=freeze_mask)

    @jax.jit
    def step(state, batch):
        support, query = JS.split_meta_batch(jcfg, batch, R.K, T, tb)
        return meta(state, support, query)

    keys = jax.random.split(jax.random.key(0), R.K)
    params = E.with_gates(jax.vmap(lambda k: model.init(k, out_dt))(keys))
    return step, JaxTrainState(jnp.zeros((), jnp.int32), params,
                               opt.init(params))


CASES = [(E.WHISPER, ""), (E.VISION, ""), (E.WHISPER, "encoder")]


@pytest.mark.parametrize("arch,freeze", CASES,
                         ids=["whisper-maml", "vision-fomaml",
                              "whisper-freeze-encoder"])
def test_train_step_matches_reference(arch, freeze):
    """Three steps, ATC on the ring, float32, the config's mode and outer
    optimizer, random frames or patches beside each episode's tokens:
    per-step losses and the final params."""
    kw = dict(dtype="float32", outer_dtype="float32", inner_freeze=freeze)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jstep, jstate = jax_setup(jcfg)
    bundle = R.port_bundle(cfg, "dense")
    assert bundle.mcfg.update_config.inner == cfg.meta_mode == {
        E.WHISPER: "maml", E.VISION: "fomaml"}[arch]
    state = R.to_port(jstate)
    init = {k: v.clone() for k, v in state.params.items()}
    for i, ep in enumerate(R.episodes()):
        b = {**ep.as_flat_batch(), **E.modality(cfg, (R.BATCH,), 10 + i)}
        jstate, jm = jstep(jstate, E.jx(b))
        state, m = bundle.step_fn(state, E.tx(b))
        assert np.isfinite(float(jm["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=R.LOSS_RTOL["float32"])
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params), "cpu")
    R.assert_params_close(state.params, want, R.PARAMS_ATOL["float32"],
                          R.STEPS)
    # the outer step trains every part, the encoder and gates among them
    for k in ("encoder/segments/0/0/attn/wq", "segments/0/1/gate",
              "vision_proj", "segments/0/4/gate"):
        if k in init:
            assert not torch.equal(state.params[k], init[k]), k


def test_freeze_mask_is_the_encoder_subtree(monkeypatch):
    """``inner_freeze="encoder"``: ``build_train`` hands the meta-step a
    mask that holds every leaf under a key path with an ``encoder``
    component, and only those (17 at reduced width); with it the
    meta-gradient differs from the unfrozen one (the inner update skips
    the encoder) and still reaches the encoder leaves."""
    from repro_torch.core import maml
    from repro_torch.launch import steps as S
    seen = {}
    real = S.make_meta_step

    def spy(*a, **kw):
        seen["mask"] = kw.get("freeze_mask")
        return real(*a, **kw)

    monkeypatch.setattr(S, "make_meta_step", spy)
    cfg = dataclasses.replace(get_config(E.WHISPER).reduced(),
                              dtype="float32", inner_freeze="encoder")
    bundle = R.port_bundle(cfg, "dense")
    mask = seen["mask"]
    assert mask == {k: k.startswith("encoder/")
                    for k in bundle.init_state(draw=False).params}
    assert sum(mask.values()) == 17
    R.port_bundle(dataclasses.replace(cfg, inner_freeze=""), "dense")
    assert seen["mask"] is None
    _, jstate = jax_setup(dataclasses.replace(
        jax_config(E.WHISPER).reduced(), dtype="float32",
        outer_dtype="float32"))
    params = {k: v[0] for k, v in R.to_port(jstate).params.items()}
    b = {**R.episodes(n=1)[0].as_flat_batch(),
         **E.modality(cfg, (R.BATCH,), 3)}
    sup = {k: torch.from_numpy(np.array(v[:2]))[None] for k, v in b.items()}
    qry = {k: torch.from_numpy(np.array(v[2:4]))[None] for k, v in b.items()}
    frozen = maml.multi_task_meta_grad(bundle.loss_fn, params, sup, qry,
                                       alpha=cfg.inner_lr, freeze_mask=mask)
    free = maml.multi_task_meta_grad(bundle.loss_fn, params, sup, qry,
                                     alpha=cfg.inner_lr)
    assert float(frozen[0]) != float(free[0])
    assert float(frozen[1]["encoder/segments/0/0/attn/wq"].abs().max()) > 0


P, G, B = 4, 4, 2


@pytest.fixture(scope="module", params=[E.WHISPER, E.VISION])
def engines(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jeng = JaxServeEngine(jcfg, prompt_len=P, gen=G, batch=B, adapt_steps=2,
                          buckets=(1, 2, 4), dtype=jnp.float32)
    jparams = E.with_gates(jeng.model.init(jax.random.key(0), jnp.float32))
    jeng.load_params(jparams)
    eng = ServeEngine(cfg, prompt_len=P, gen=G, batch=B, adapt_steps=2,
                      buckets=(1, 2, 4), dtype=torch.float32, device="cpu")
    eng.load_params(from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu"))
    return jeng, eng


def test_serve_round_matches_the_reference_engine(engines):
    """Three users' support episodes through ``adapt`` (a miss round padded
    to the bucket of 4, then a hit round from the low-rank cache) and a
    greedy decode from the first adapted model (whisper: the cross K/V from
    the encoder over zero frames; vision: zero patches), against the
    reference engine on the same episode."""
    jeng, eng = engines
    source = serve_cli.make_support_source(eng.cfg, P + G, B)
    ep = source.eval_sample(3, seed=3, split="full")
    jstates, jm = jeng.adapt(jeng.requests_from_episode(source, ep))
    states, m = eng.adapt(eng.requests_from_episode(source, ep))
    assert (m["misses"], m["buckets"]) == (jm["misses"], jm["buckets"]) == (
        3, [4])
    for js, s in zip(jstates, states):
        want = from_jax_params(jax.tree.map(np.asarray, js), device="cpu")
        for k, v in s.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=ADAPT_ATOL, rtol=0, err_msg=k)
    _, hit = eng.adapt(eng.requests_from_episode(source, ep))
    assert hit["hits"] == 3
    prompt = np.asarray(ep.query["tokens"][0])[:, :P]
    jtoks, _ = jeng.decode(jstates[0], prompt)
    toks, _ = eng.decode(states[0], prompt)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    rec = eng.log_record()
    assert (rec["num_layers"], rec["encoder_layers"]) == (
        eng.cfg.num_layers, eng.cfg.encoder_layers)


def test_trainer_runs_and_resumes_whisper(tmp_path):
    """``launch/train.py`` for reduced whisper on the CPU, eval and
    checkpoint: the log records the encoder's depth; a resumed run reaches
    the uninterrupted step-4 loss."""
    import json
    from repro_torch.launch import train
    argv = ["--arch", E.WHISPER, "--reduced", "--device", "cpu", "--seq",
            "32", "--global-batch", "16", "--agents", "4", "--fused-outer",
            "--steps-per-dispatch", "2", "--prefetch", "0", "--eval-every",
            "2", "--eval-tasks", "2", "--eval-inner-steps", "1"]
    full = train.main(argv + ["--steps", "4", "--run-log",
                              str(tmp_path / "full.jsonl")])
    ck = str(tmp_path / "ck")
    train.main(argv + ["--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2",
                       "--run-log", str(tmp_path / "ck.jsonl")])
    resumed = train.main(argv + ["--steps", "2", "--ckpt-dir", ck,
                                 "--ckpt-every", "0", "--run-log",
                                 str(tmp_path / "resumed.jsonl")])
    np.testing.assert_allclose(resumed["losses"][4], full["losses"][4],
                               rtol=1e-6)
    config = json.loads(open(tmp_path / "full.jsonl").readline())
    assert (config["num_layers"], config["encoder_layers"]) == (2, 2)
    kinds = [json.loads(x)["kind"] for x in open(tmp_path / "full.jsonl")]
    assert kinds.count("eval") == 2
