"""What the port must never do: pull in JAX or the reference package, or
carry on on the CPU when nobody asked for it."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert out.returncode == 0, out.stdout + out.stderr


def test_import_check_covers_the_example_modules():
    """The few-shot data module (whose reference imports jax inside two
    functions) and the example entry points are among the modules the
    import test loads."""
    mods = set(_modules())
    assert {"repro_torch.data.fewshot", "repro_torch.launch.fewshot",
            "repro_torch.launch.decentralized_lm",
            "repro_torch.launch.serve_adapted"} <= mods
    text = (PORT / "data" / "fewshot.py").read_text()
    assert "jax" not in text.replace("repro_torch", "")


def test_no_source_names_the_reference_package():
    pattern = re.compile(r"^\s*(import repro\b(?!_torch)|from repro\b"
                         r"(?!_torch)|import jax|from jax)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_no_card_script_names_the_reference_package():
    """The scripts that measure the port on the card (ablations, profiles)
    import neither jax nor the reference package, as chip_smoke.py."""
    pattern = re.compile(r"^\s*(import repro\b(?!_torch)|from repro\b"
                         r"(?!_torch)|import jax|from jax)", re.M)
    files = sorted((ROOT / "scripts").glob("ablate_*.py")) + sorted(
        (ROOT / "scripts").glob("profile_*.py"))
    assert any(f.name == "ablate_ssd_scan_f32.py" for f in files)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_raise_without_a_device():
    """No device given and no CUDA card: every entry point refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None resolves to it")
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import MetaConfig, diffusion, init_state
    from repro_torch.core import make_meta_step
    from repro_torch.data import MetaBatchPipeline, SineTaskSource
    from repro_torch.launch import quickstart
    from repro_torch.models import SineMLP

    model = SineMLP(get_config("sine_mlp"))
    calls = {
        "init": lambda: model.init(torch.Generator()),
        "init_state": lambda: init_state(torch.Generator(), model.init,
                                         MetaConfig()),
        "make_meta_step": lambda: make_meta_step(model.loss_fn,
                                                 MetaConfig()),
        "make_combine": lambda: diffusion.make_combine("dense", np.eye(2)),
        "pipeline": lambda: MetaBatchPipeline(SineTaskSource(), depth=0),
        "from_jax_params": lambda: convert.from_jax_params(
            {"w": np.ones(2, np.float32)}),
        "quickstart": lambda: quickstart.main(["--steps", "1"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(f"{name} ran without a device")


def test_serve_entry_points_raise_without_a_device():
    """The serving slice's entry points follow the same rule."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None resolves to it")
    from repro_torch.checkpoint import restore_centroid
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen2-1.5b").reduced()
    calls = {
        "Model.init": lambda: build_model(cfg).init(torch.Generator()),
        "init_cache": lambda: build_model(cfg).init_cache(1, 4),
        "ServeEngine": lambda: ServeEngine(cfg, prompt_len=2, gen=2,
                                           batch=1),
        "restore_centroid": lambda: restore_centroid("missing", {}),
        "serve": lambda: serve.main(["--arch", "qwen2-1.5b", "--reduced"]),
        "serve mamba2": lambda: serve.main(["--arch", "mamba2-130m",
                                            "--reduced"]),
        "Model.init mamba2": lambda: build_model(
            get_config("mamba2-130m").reduced()).init(torch.Generator()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(f"{name} ran without a device")


def test_training_entry_points_raise_without_a_device():
    """The LM training slice's entry points follow the same rule: the
    trainer, the train step's builder and its pipeline."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None resolves to it")
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps, train

    cfg = get_config("mamba2-130m").reduced()
    shape = InputShape("t", 32, 8, "train")
    calls = {
        "train": lambda: train.main(["--arch", "mamba2-130m", "--reduced",
                                     "--steps", "1"]),
        "train qwen2": lambda: train.main(["--arch", "qwen2-1.5b",
                                           "--reduced", "--steps", "1"]),
        "build_train": lambda: steps.build_train(cfg, shape, 2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(f"{name} ran without a device")


def test_example_entry_points_raise_without_a_device():
    """The example twins (few-shot classification, the decentralized LM,
    adapt-then-serve) and the few-shot CNN's init follow the same rule."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None resolves to it")
    from repro_torch.configs import get_config
    from repro_torch.launch import decentralized_lm, fewshot, serve_adapted
    from repro_torch.models import FewShotCNN

    calls = {
        "fewshot": lambda: fewshot.main(["--steps", "1"]),
        "decentralized_lm": lambda: decentralized_lm.main(["--tiny",
                                                           "--steps", "1"]),
        "serve_adapted": lambda: serve_adapted.main([]),
        "FewShotCNN.init": lambda: FewShotCNN(
            get_config("omniglot_cnn")).init(torch.Generator()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(f"{name} ran without a device")


def test_tangent_kernels_raise_on_other_devices():
    """The tangent wrappers route by device: a plain version for a CPU
    tensor, the kernel for a CUDA tensor, and an error for anything else
    (never a quiet fallback)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    q = torch.ones(1, 2, 8, 4, device="meta")
    lse = torch.ones(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fops.flash_attention_fwd_tangent(q, q, q, lse, q, q, q)
    x = torch.ones(1, 8, 2, 4, device="meta")
    dt, A = torch.ones(1, 8, 2, device="meta"), torch.ones(2, device="meta")
    Bm = torch.ones(1, 8, 1, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sops.ssd_scan_tangent(x, dt, A, Bm, Bm, x, dt, A, Bm, Bm, chunk=8)
