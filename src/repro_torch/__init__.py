"""Dif-MAML in PyTorch: the port of the ``repro`` JAX package for NVIDIA
Hopper GPUs.

The layout and names follow the JAX package module for module, so each
module's counterpart is found under the same path.  Parameters are flat
dicts keyed ``l{i}/w``, ``l{i}/b`` (the JAX package's key paths joined by
``/``), and every function is functional over them, which is the form
``torch.func.grad``/``jvp``/``vmap`` need.

Device rule: every entry point takes ``device``.  Left as ``None`` it means
the CUDA card, and raises when there is none; CPU runs are asked for with
``device="cpu"`` (the tests do).  The two TPU kernels of the training step
(``dif_combine`` and ``fused_combine_update``) are hand-written CUDA kernels
in :mod:`repro_torch.kernels.dif_combine`; on CPU tensors their wrappers use
the plain PyTorch versions.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
