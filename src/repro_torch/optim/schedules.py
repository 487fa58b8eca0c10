"""Learning-rate schedules, computed in float32 as the JAX package's
``optim/schedules.py`` computes them, each returning a NumPy float32.

``wsd`` is the Warmup-Stable-Decay schedule used to train MiniCPM-2B
[arXiv:2404.06395]; ``linear_anneal`` implements the annealing suggested
for TinyReptile's server rate alpha (paper Appendix A / Reptile paper).
A Python number meets an fp32 array in the JAX package as a weak type:
it is rounded to float32 where it meets one, and arithmetic between two
Python numbers stays in float64 before that. The code below keeps those
places.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr):
    return lambda step: _F(lr)


def linear_anneal(lr, total_steps, floor=0.0):
    """step -> ``lr (1 - frac) + floor frac`` with ``frac = clip(step /
    total_steps, 0, 1)``, every operation in float32 (the JAX package's
    jnp arithmetic on a float32 frac)."""
    lr32, floor32, one = _F(lr), _F(floor), _F(1.0)

    def f(step):
        frac = _F(np.clip(step / max(total_steps, 1), 0.0, 1.0))
        return _F(lr32 * (one - frac) + floor32 * frac)
    return f


def cosine(lr, total_steps, warmup=0, floor_ratio=0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from ``lr`` to
    ``floor_ratio lr`` at ``total_steps``."""
    def f(step):
        step = _F(step)
        warm = _F(lr) * step / _F(max(warmup, 1))
        frac = np.clip((step - _F(warmup)) / _F(max(total_steps - warmup, 1)),
                       _F(0), _F(1))
        cos = _F(floor_ratio * lr) + _F((1 - floor_ratio) * lr * 0.5) * (
            _F(1) + np.cos(_F(np.pi) * frac))
        return _F(warm if step < warmup else cos)
    return f


def wsd(lr, total_steps, warmup_frac=0.01, decay_frac=0.1, floor_ratio=0.1):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, long stable plateau,
    fast exponential-ish (linear here) decay tail."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        step = _F(step)
        warm = _F(lr) * step / _F(warmup)
        frac = np.clip((step - _F(decay_start))
                       / _F(max(total_steps - decay_start, 1)), _F(0), _F(1))
        tail = _F(lr) * (_F(1) - _F(1 - floor_ratio) * frac)
        if step < warmup:
            return _F(warm)
        return _F(lr) if step < decay_start else _F(tail)
    return f
