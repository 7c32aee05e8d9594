"""Where one float32 ``maml`` meta-gradient of mamba2-130m's 2-layer cut
spends its device time, with the kernels of a given checkout, on one CUDA
card.

  python scripts/profile_f32_meta_grad.py <checkout root>

Builds that checkout's SSD kernels, makes chip_smoke.py's inputs of its
mamba2 training agreement (phase 15: one agent, one task of one
512-token sequence, full width cut to 2 layers) with that checkout's
``chip_smoke.meta_grad_inputs``, and runs this tree's
``chip_smoke.meta_grad_split`` on them (it reads kernel names only): one
line ``CMP {...}`` with the meta-gradient's wall and device time, and the
device time, launches and share of the SSD scan's forward kernels, of its
tangent T3's, of the backward's and of the backward's tangent's, each SSD
kernel's beside.  To compare two commits on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run both in one
call, alternating (other, this, this, other).
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path[:0] = [os.path.join(root, "src"), root]

import chip_smoke as cs  # noqa: E402  (sets the allocator before torch)
import torch  # noqa: E402

from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("profile_f32_meta_grad: needs a CUDA card")
spec = importlib.util.spec_from_file_location("this_smoke",
                                              THIS / "chip_smoke.py")
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
torch.backends.cuda.matmul.allow_tf32 = False
# mamba2 runs no attention and no outer update here: the SSD kernels only
cs.build_phase({"ssd_scan": sops, "ssd_bwd": sops.BWD_LIB})
inputs = cs.meta_grad_inputs("mamba2-130m", cs.MAMBA_AGREE_SEQ)
row = this.meta_grad_split(inputs, torch.float32)
print("CMP", json.dumps(dict(checkout=sys.argv[1],
                             device=torch.cuda.get_device_name(0), **row)),
      flush=True)
