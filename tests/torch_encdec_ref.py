"""Shared set-up of the encoder-decoder and vision tests
(test_torch_encdec.py, test_torch_vlm.py, test_torch_train_encdec.py):
the reduced whisper-large-v3 and llama-3.2-vision-90b configs in both
packages, the reference's weights with every cross gate set to GATE and
carried across, and batches with random frames or patches.

Both families' cross blocks carry llama's tanh gate, initialised to zero,
and the reference's callers stub the frames and patches with zeros: with
either, the cross path carries nothing and its weights get no gradient, so
these tests draw the frames and patches at random and set the gates to
GATE before converting the weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.transformer import build_model

WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-90b"
GATE = 0.5
BATCH, SEQ = 2, 16
# float32 on both sides: the same products summed in another order
# (tests/test_torch_lm.py's limits).
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def cfgs(arch, **kw):
    """The reduced config in float32, for the reference and for the port
    (whisper: 2 + 2 layers, 16 frames; vision: 10 layers, 2 periods of 4
    self-attention + 1 cross-attention blocks, 16 patches; both d 128, 4
    heads, head dim 32, vocab 512)."""
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def with_gates(tree, value=GATE):
    """The reference's params with every ``gate`` leaf set to ``value``."""
    def leaf(path, x):
        if getattr(path[-1], "key", None) == "gate":
            return jnp.full_like(x, value)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def models(arch, **kw):
    """(reference model, its params, port model, port params): seed-0
    weights with the gates at GATE."""
    jcfg, cfg = cfgs(arch, **kw)
    jm, m = jax_build(jcfg), build_model(cfg)
    jparams = with_gates(jm.init(jax.random.key(0), jnp.float32))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, m, params


def modality(cfg, lead, seed):
    """Random float32 frames (audio) or patches (vision) of leading axes
    ``lead``, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        return {"encoder_frames": rng.standard_normal(
            lead + (cfg.encoder_frames, cfg.d_model)).astype(np.float32)}
    return {"image_patches": rng.standard_normal(
        lead + (cfg.num_patches, cfg.d_model)).astype(np.float32)}


def batch(cfg, seed=0, B=BATCH, S=SEQ):
    """Tokens, labels and random frames or patches, as numpy."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    out.update(modality(cfg, (B,), seed + 1))
    return out


def jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tx(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def flat(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def spec_shapes(jm):
    """The reference model's Spec tree, flattened to the port's keys."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jm.specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
