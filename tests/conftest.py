import os
import sys

# Tests run on the real single CPU device — never the 512-device dry-run
# fake (see launch/dryrun.py, which sets XLA_FLAGS itself).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA card; skips without one")
