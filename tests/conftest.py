import os

# Smoke tests and benches must see the single real CPU device; ONLY the
# dry-run forces 512 host devices (and does so in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")
