"""Production mesh construction, after the JAX package's
``launch/mesh.py``: a function, not a module constant, so importing this
module starts nothing.

Single pod: 16 x 16 = 256 ranks over ``("data", "model")``. Multi-pod: 2
pods x 256 = 512 ranks over ``("pod", "data", "model")``. The process
group must hold exactly that many ranks (one process each).
"""
from __future__ import annotations

import math

from repro_torch.runtime.sharding import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    import torch.distributed as dist
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}; have {have} (start {n} "
            f"ranks, one process each, joined by "
            f"repro_torch.runtime.sharding.init_distributed)")
    return make_mesh(shape, axes, device)


# NVIDIA H100 SXM constants for the roofline model (the card's data
# sheet, dense): per card
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12               # bytes/s of HBM3
NVLINK_BW = 450e9              # bytes/s each way, NVLink 4
