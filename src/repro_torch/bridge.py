"""Carry parameter trees between the JAX package and the port.

Both sides speak NumPy: the JAX package's params are ``{w0, b0, ...}``
dicts whose leaves convert with ``np.asarray``; the port's are dicts of
torch tensors. Dtypes are kept as they are. ``FlatLayout`` packs such
a dict into one flat buffer, the form the port's kernels update in one
launch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a ``{name: tensor}`` tree sits in one flat
    buffer: leaves in sorted-name order, each flattened, concatenated
    along the last axis. Leading (batch) axes are kept, so a cohort of C
    models is one ``(C, size)`` buffer, and the gradient of the summed
    per-model losses with respect to it is each model's own gradient."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, tree, batch_dims: int = 0) -> "FlatLayout":
        names = tuple(sorted(tree))
        return cls(names, tuple(tuple(tree[k].shape[batch_dims:])
                                for k in names))

    def pack(self, tree, batch_dims: int = 0) -> torch.Tensor:
        """The tree as one buffer ``(*batch, size)`` (a copy)."""
        lead = tuple(tree[self.names[0]].shape[:batch_dims])
        return torch.cat([tree[k].reshape(lead + (-1,)) for k in self.names],
                         dim=-1)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: view}`` of a ``(*batch, size)`` buffer, each view
        shaped ``(*batch, *leaf_shape)``; no copy."""
        out, off = {}, 0
        for k, shape in zip(self.names, self.shapes):
            n = math.prod(shape)
            out[k] = flat[..., off:off + n].reshape(flat.shape[:-1] + shape)
            off += n
        return out
