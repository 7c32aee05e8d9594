"""Shared set-up of the LM meta-training tests (test_torch_train*.py): the
reference's train step (``repro.core.make_meta_step`` built from its
``meta_config_for``, ``build_model(cfg).loss_fn`` and ``split_meta_batch``)
and the port's ``build_train`` for reduced configs at K=4, the same
``LMTaskSource`` episodes, and the reference's initial state carried
across."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JaxShape
from repro.core import make_meta_step as jax_meta_step
from repro.core.meta_trainer import TrainState as JaxTrainState
from repro.core.meta_trainer import schedule_for as jax_schedule_for
from repro.data.lm_tasks import LMTaskSource as JaxLMTaskSource
from repro.launch import steps as JS
from repro.models.transformer import build_model as jax_build_model
from repro.optim import get_optimizer as jax_optimizer
from repro_torch.configs import InputShape, get_config
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core import TrainState
from repro_torch.launch import steps as S

K, SEQ, BATCH, STEPS = 4, 64, 16, 3
ARCHS = ["qwen2-1.5b", "mamba2-130m"]
# float32 on both sides, the same weights and batches; the sums differ in
# order (ulps), which three Adam steps carry along.  bfloat16 params and
# activations: both sides round every product to bf16, in another order.
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 2e-3}
PARAMS_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Adam normalises each coordinate's step, so a coordinate whose exact
# meta-gradient is 0 (an embedding row no token of the batch reads, or the
# key bias, whose gradient softmax's shift invariance makes exactly 0)
# moves by up to lr a step either way on the two sides' rounding residues:
# observed 19 of 262,144 embedding and 10 of 512 key-bias entries in
# three float32 steps.  Such entries (at most 0.1% of all parameters) may
# differ by up to 2 lr a step.
ADAM_FLIP_SHARE = 1e-3


def assert_params_close(got, want, atol, steps, lr=1e-3):
    flips = 0
    for k, p in got.items():
        assert p.dtype == want[k].dtype, k
        diff = (p.float() - want[k].float()).abs()
        off = diff > atol
        flips += int(off.sum())
        assert float(diff.max()) <= max(atol, 2 * lr * steps), (
            k, float(diff.max()))
    total = sum(p.numel() for p in got.values())
    assert flips <= ADAM_FLIP_SHARE * total, (flips, total)


def cfgs(arch, dtype):
    """The reduced config in both packages; float32 sets the model and
    the outer dtype, bfloat16 keeps the config's (bf16 params and moments
    in float32)."""
    kw = dict(dtype="float32", outer_dtype="float32") \
        if dtype == "float32" else dict(outer_dtype="bfloat16")
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def episodes(seed=0, start=0, n=STEPS):
    """The reference's LM episodes (the port's source draws the same)."""
    src = JaxLMTaskSource(vocab_size=512, seq_len=SEQ, K=K,
                          tasks_per_agent=2, task_batch=1, n_domains=18,
                          holdout_domains=2, seed=seed)
    return [src.sample(i) for i in range(start, start + n)]


def jax_setup(jcfg, backend):
    shape = JaxShape("t", SEQ, BATCH, "train")
    T, tb = JS.batch_geometry(jcfg, shape, K)
    mcfg = JS.meta_config_for(jcfg, K, T)
    mcfg = dataclasses.replace(mcfg, update_config=dataclasses.replace(
        mcfg.update_config, backend=backend))
    model = jax_build_model(jcfg)
    opt = jax_optimizer(jcfg.outer_optimizer, jcfg.outer_lr)
    A = jax_schedule_for(mcfg).stacked()
    meta = jax_meta_step(model.loss_fn, mcfg, optimizer=opt, A=A)

    @jax.jit
    def step(state, batch):
        support, query = JS.split_meta_batch(jcfg, batch, K, T, tb)
        return meta(state, support, query)

    out_dt = JS.DTYPES[jcfg.outer_dtype or jcfg.dtype]
    keys = jax.random.split(jax.random.key(0), K)
    params = jax.vmap(lambda k: model.init(k, out_dt))(keys)
    state = JaxTrainState(jnp.zeros((), jnp.int32), params, opt.init(params))
    return step, state, model


def to_port(jstate):
    return TrainState(int(jstate.step),
                      from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params), "cpu"),
                      from_jax_opt_state(jax.tree.map(np.asarray,
                                                      jstate.opt_state),
                                         "cpu"))


def port_bundle(cfg, backend):
    return S.build_train(cfg, InputShape("t", SEQ, BATCH, "train"), K,
                         combine_override=backend, device="cpu")


def flat(ep):
    return {k: torch.from_numpy(v) for k, v in ep.as_flat_batch().items()}


