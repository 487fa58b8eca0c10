"""The dry run's skip matrix, after the JAX package's ``launch/dryrun.py``.

Only ``skip_reason`` is ported so far: which (arch x input shape) cells
the production plan leaves out. The dry run itself (tracing a cell's
step as one rank of a 256- or 512-rank group, its memory, collectives,
costs and roofline) and the sweep over the cells are still to port
(ROADMAP queue A).
"""
from __future__ import annotations


def skip_reason(cfg, shape):
    if shape.name == "long_500k":
        if cfg.name == "whisper-tiny":
            return "enc-dec decoder (448-pos design); 500k decode meaningless"
        if not cfg.supports_long_context():
            return "pure full-attention arch; no sub-quadratic variant"
    return None
