"""The paper's own three models (Table I, from the MLPerf Tiny benchmark).

These are the FAITHFUL reproduction targets: the federated meta-learning
experiments (Figs. 1-6, Tables II-IV) run on these, exactly as the paper
does. They are plain pytree models (not ArchConfig transformers).

| task                        | type            | params (paper) |
|-----------------------------|-----------------|----------------|
| Sine-wave example           | fully connected | 1,153          |
| Keywords spotting (4 cls)   | convolutional   | 19,812         |
| Omniglot (5 cls)            | convolutional   | 113,733        |
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PaperModelConfig:
    name: str
    kind: str                    # "mlp" | "conv"
    input_shape: Tuple[int, ...]
    num_outputs: int
    hidden: Tuple[int, ...] = ()
    channels: Tuple[int, ...] = ()
    loss: str = "mse"            # "mse" | "xent"


# 1 -> 32 -> 32 -> 1 fully connected (paper Fig. 1): exactly 1,153 params.
SINE_MLP = PaperModelConfig(
    name="sine_mlp", kind="mlp", input_shape=(1,), num_outputs=1,
    hidden=(32, 32), loss="mse")

# Keywords spotting: 4-class audio classifier over MFCC maps (49x10x1,
# MLPerf-Tiny DS-CNN style). Channel widths chosen to land near the
# paper's 19,812 parameters (we hit 20,612; the paper does not publish
# the exact topology).
KWS_CONV = PaperModelConfig(
    name="kws_conv", kind="conv", input_shape=(49, 10, 1), num_outputs=4,
    channels=(32, 32, 32), loss="xent")

# Omniglot: 5-way classifier, the canonical Reptile 4xconv(stride2) net on
# 28x28x1 glyphs. 112,709 params vs the paper's 113,733 (head-size delta;
# topology not published).
OMNIGLOT_CONV = PaperModelConfig(
    name="omniglot_conv", kind="conv", input_shape=(28, 28, 1), num_outputs=5,
    channels=(64, 64, 64, 64), loss="xent")

PAPER_MODELS = {m.name: m for m in (SINE_MLP, KWS_CONV, OMNIGLOT_CONV)}
