"""Profile one meta-step of mamba2-130m cut to chip_smoke.py's training
depth, with the code of a given checkout, on one CUDA card.

  python scripts/profile_mamba2_step.py <checkout root>

Runs that checkout's ``chip_smoke.train_phase`` (2 steps, then one profiled
meta-step) and prints one line ``CMP {...}``: the run's step times and peak
memory, the profiled step's wall and device time, its device split and
idle share.  To compare two commits on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run both in one
call, alternating (other, this, this, other).
"""
import dataclasses
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path[:0] = [os.path.join(root, "src"), root]

import chip_smoke as cs  # noqa: E402  (sets the allocator before torch)
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.dif_combine import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("profile_mamba2_step: needs a CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
libraries = {"dif_combine": dops, "flash_attention": fops, "ssd_scan": sops}
if hasattr(sops, "BWD_LIB"):                      # the backward's source
    libraries["ssd_bwd"] = sops.BWD_LIB
cs.build_phase(libraries)
cfg = dataclasses.replace(get_config("mamba2-130m"),
                          num_layers=cs.MAMBA_TRAIN_LAYERS)
row = cs.train_phase("mamba2", cfg, cs.MAMBA_TRAIN_ARGS, cs.TRAIN_SHAPE,
                     ("ssd_scan",), ("--expect-fused", "--expect-outer-dtype",
                                     "bfloat16"))
p = row["profile"]
print("CMP", json.dumps(dict(
    checkout=sys.argv[1], device=torch.cuda.get_device_name(0),
    step_time_s=row["step_time_s"], peak_run_gb=row["peak_run_gb"],
    wall_s=p["wall_s"], device_ms=p.get("device_ms"),
    idle=p.get("device_idle_share"), split=p.get("split_ms"),
    chunked_bwd_ms=p.get("chunked_bwd_ms"),
    chunked_bwd_jvp_ms=p.get("chunked_bwd_jvp_ms"),
    peak_step_gb=p["peak_gb"])), flush=True)
