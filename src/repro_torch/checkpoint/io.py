"""Checkpoints in the JAX package's flat ``.npz`` format (port of
``repro/checkpoint/io.py``).

A checkpoint is ``ckpt_{step:08d}.npz`` holding one array per leaf, keyed by
the leaf's key path with ``::`` between entries: ``k:{key}`` for a dict
key, ``i:{index}`` for a list or tuple entry, ``x:.{field}`` for a named
tuple's field (``x:.params::k:segments::i:0::i:0::k:attn::k:wq``).  The
port's flat param dicts split their ``/``-joined keys back into those
entries (a numeric entry is a list or tuple index).  bfloat16 leaves are
stored as raw 2-byte void, as numpy saves the reference's ml_dtypes arrays,
and are widened exactly on load.  Writes are atomic (temporary file, then
rename), so a checkpoint the JAX trainer wrote serves from the port and one
the port wrote restores in the JAX package.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["latest_step", "restore_centroid", "restore_checkpoint",
           "save_checkpoint"]

_SEP = "::"
# The reference TrainState's params field, as jax spells a named tuple
# field in a key path.
_PARAMS_PREFIX = "x:.params"


def _entry(part: str) -> str:
    return f"i:{part}" if part.isdigit() else f"k:{part}"


def _key(path: str, prefix: tuple[str, ...] = ()) -> str:
    """A flat param key (``segments/0/0/attn/wq``) → its archive key."""
    return _SEP.join(prefix + tuple(_entry(p) for p in path.split("/")))


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:       # raw bf16 bits, as numpy saves it
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + tuple(
                _entry(p) for p in str(k).split("/"))))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_flatten(getattr(tree, name), prefix + (f"x:.{name}",)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flatten(x, prefix + (f"i:{i}",)))
        return out
    return {_SEP.join(prefix): _to_numpy(tree)}


def _widen(arr: np.ndarray) -> np.ndarray:
    """Raw 2-byte void (bfloat16 as npz stores it) → the float32 of the same
    value, exactly; anything else as it is."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` (nested dicts, lists, tuples and named tuples of
    tensors or arrays; flat ``/``-keyed dicts count as nested) atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _resolve_ckpt(ckpt_dir: str, step: int | None) -> str:
    """Path of the checkpoint to restore; a missing directory, a directory
    with no checkpoints and a step that was never written each raise their
    own message."""
    if step is None:
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"checkpoint dir {ckpt_dir!r} does not exist")
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"checkpoint dir {ckpt_dir!r} exists but holds no "
                f"ckpt_*.npz files (contents: "
                f"{sorted(os.listdir(ckpt_dir))[:8]})")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    if not os.path.exists(path):
        have = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                      if (m := re.match(r"ckpt_(\d+)\.npz$", f))) \
            if os.path.isdir(ckpt_dir) else []
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {ckpt_dir!r} "
            f"(available steps: {have})")
    return path


def _lookup(data, key: str, path: str) -> np.ndarray:
    if key not in data:
        have = sorted(data.files)
        raise KeyError(
            f"{path} has no leaf {key!r} — the checkpoint does not match "
            f"the requested spec (was it written by a different arch or "
            f"TrainState layout?).  Archive holds {len(have)} leaves, "
            f"e.g. {have[:4]}")
    return _widen(data[key])


def restore_centroid(ckpt_dir: str, like_params: dict[str, torch.Tensor],
                     step: int | None = None, device=None
                     ) -> dict[str, torch.Tensor]:
    """Restore the agent-**centroid** launch model from a TrainState
    checkpoint: every ``params`` leaf is loaded and averaged over its
    leading agent axis (in float32, as the reference) into the shapes and
    dtypes of ``like_params`` — single-agent tensors, which may lie on the
    ``meta`` device — on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    path = _resolve_ckpt(ckpt_dir, step)
    out = {}
    with np.load(path) as data:
        for name, leaf in like_params.items():
            key = _key(name, (_PARAMS_PREFIX,))
            arr = _lookup(data, key, path)
            if arr.shape[1:] != tuple(leaf.shape):
                raise ValueError(
                    f"agent-stacked shape mismatch for {key}: checkpoint "
                    f"{arr.shape} vs (K,) + {tuple(leaf.shape)}")
            mean = arr.astype(np.float32).mean(axis=0)
            out[name] = torch.from_numpy(np.ascontiguousarray(mean)).to(
                device=device, dtype=leaf.dtype)
    return out


def _restore(tree: Any, prefix: tuple[str, ...], data, path: str) -> Any:
    """``tree`` rebuilt from the archive, leaf by leaf, in the key paths
    :func:`_flatten` writes."""
    if isinstance(tree, dict):
        return {k: _restore(v, prefix + tuple(
            _entry(p) for p in str(k).split("/")), data, path)
            for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_restore(getattr(tree, name),
                                     prefix + (f"x:.{name}",), data, path)
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(x, prefix + (f"i:{i}",), data, path)
                          for i, x in enumerate(tree))
    key = _SEP.join(prefix)
    arr = _lookup(data, key, path)
    shape = tuple(tree.shape) if hasattr(tree, "shape") else ()
    if arr.shape != shape:
        raise ValueError(f"shape mismatch for {key}: checkpoint {arr.shape} "
                         f"vs {shape}")
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=tree.device, dtype=tree.dtype)
    if isinstance(tree, int):                # the port's host step counter
        return int(arr)
    raise TypeError(f"cannot restore {key} into a {type(tree).__name__}")


def restore_checkpoint(ckpt_dir: str, like: Any, step: int | None = None
                       ) -> Any:
    """Restore into the structure of ``like`` (nested dicts — flat
    ``/``-keyed dicts count as nested —, lists, tuples and named tuples of
    tensors or Python ints, e.g. a ``TrainState``): each leaf
    from the archive key its path names, in the leaf's dtype and on the
    leaf's device.  ``step`` None: the latest checkpoint.  A checkpoint the
    JAX trainer wrote restores here, and one written here restores in the
    JAX package (:func:`save_checkpoint` writes the same keys)."""
    path = _resolve_ckpt(ckpt_dir, step)
    with np.load(path) as data:
        return _restore(like, (), data, path)
