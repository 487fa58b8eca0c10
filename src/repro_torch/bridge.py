"""Carry parameter trees between the JAX package and the port.

Both sides speak NumPy: the JAX package's params are ``{w0, b0, ...}``
dicts whose leaves convert with ``np.asarray``; the port's are dicts of
torch tensors. Dtypes are kept as they are.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree, device: DeviceLike = None) -> Dict:
    """Nested dict of array-likes -> same dict of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def params_to_numpy(params) -> Dict:
    """Nested dict of tensors -> same dict of host NumPy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)
