"""Which device a port entry point runs on.

The port runs on the GPU. An entry point given no device takes
``cuda``; the CPU is used only when the caller asks for it (the tests
do), never as a quiet substitute for a missing card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; a CUDA device is
    checked to exist. Raises RuntimeError when CUDA is asked for (or
    implied) and this process sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU. "
            "Pass device='cpu' (or --device cpu) to run the plain "
            "PyTorch path on the CPU.")
    return dev
