"""Learning-rate schedules: ``linear_anneal``, the annealing suggested
for TinyReptile's server rate alpha (paper Appendix A / Reptile paper),
computed in float32 as the JAX package computes it."""
from __future__ import annotations

import numpy as np


def linear_anneal(lr, total_steps, floor=0.0):
    """step -> ``lr (1 - frac) + floor frac`` with ``frac = clip(step /
    total_steps, 0, 1)``, every operation in float32 (the JAX package's
    jnp arithmetic on a float32 frac); returns a NumPy float32."""
    lr32, floor32, one = np.float32(lr), np.float32(floor), np.float32(1.0)

    def f(step):
        frac = np.float32(np.clip(step / max(total_steps, 1), 0.0, 1.0))
        return np.float32(lr32 * (one - frac) + floor32 * frac)
    return f
