"""The kernels the port's paths call, dispatched by the tensor's device.

A CPU tensor gets the plain version (``kernels/ref.py``); a CUDA tensor
gets the hand-written kernel, or an exception if it cannot launch —
never the plain version. Each kernel's wrapper counts its launches
(``<wrapper>.launches``; ``launch_counts`` reads them all).
"""
from __future__ import annotations

from repro_torch.bridge import FlatLayout
from repro_torch.kernels.meta_update import meta_update
from repro_torch.kernels.online_sgd import online_sgd, online_sgd_momentum
from repro_torch.kernels.online_sgd_int8 import dfa_epoch_int8

# every kernel wrapper of the port, by name
KERNELS = {"online_sgd": online_sgd, "dfa_epoch_int8": dfa_epoch_int8,
           "meta_update": meta_update,
           "online_sgd_momentum": online_sgd_momentum}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def tree_meta_update(phi, phi_hat, alpha):
    """Reptile interpolation over a whole ``{leaf: tensor}`` tree in ONE
    launch: both trees are packed into flat buffers (sorted leaf names),
    updated, and handed back as views of the result."""
    layout = FlatLayout.of(phi)
    return layout.views(meta_update(layout.pack(phi), layout.pack(phi_hat),
                                    alpha))
