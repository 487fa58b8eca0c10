"""The kernels the port's paths call, dispatched by the tensor's device.

A CPU tensor gets the plain version (``kernels/ref.py``); a CUDA tensor
gets the hand-written kernel, or an exception if it cannot launch —
never the plain version. Each kernel's wrapper counts its launches
(``online_sgd.launches``, ``dfa_epoch_int8.launches``).
"""
from __future__ import annotations

from repro_torch.kernels.online_sgd import online_sgd  # noqa: F401
from repro_torch.kernels.online_sgd_int8 import dfa_epoch_int8  # noqa: F401

# every kernel wrapper of the port, by name
KERNELS = {"online_sgd": online_sgd, "dfa_epoch_int8": dfa_epoch_int8}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
