"""The kernels the port's paths call, dispatched by the tensor's device.

A CPU tensor gets the plain version (``kernels/ref.py``); a CUDA tensor
gets the hand-written kernel, or an exception if it cannot launch —
never the plain version. Each kernel's wrapper counts its launches
(``<wrapper>.launches``; ``launch_counts`` reads them all).
``flash_decode`` takes ``cache_len`` as a host int or as an int32 tensor
on the device, which it never reads on the host (its device-L route), so
a decode step can be captured once and replayed.
"""
from __future__ import annotations

from repro_torch.bridge import GroupedLayout
from repro_torch.kernels.client_mean import client_mean
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.meta_update import meta_update
from repro_torch.kernels.online_sgd import online_sgd, online_sgd_momentum
from repro_torch.kernels.online_sgd_int8 import dfa_epoch_int8
from repro_torch.kernels.ssd_scan import ssd_scan

# every kernel wrapper of the port, by name
KERNELS = {"online_sgd": online_sgd, "dfa_epoch_int8": dfa_epoch_int8,
           "meta_update": meta_update,
           "online_sgd_momentum": online_sgd_momentum, "ssd_scan": ssd_scan,
           "flash_decode": flash_decode, "client_mean": client_mean}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def tree_meta_update(phi, phi_hat, alpha):
    """Reptile interpolation over a whole params tree (nested dicts and
    lists) in ONE launch per leaf dtype: the leaves of each dtype are
    packed into one flat buffer (sorted paths), updated, and handed back
    as views of the result, each leaf in its own dtype. A tree that is
    already such views (an earlier result, ``streaming_sgd``'s phi_hat)
    is read from its buffer, without a copy."""
    layout = GroupedLayout.of_tree(phi)
    trees = layout.named(phi), layout.named(phi_hat)
    out = {}
    for group in layout.groups:
        w, w_hat = (group.buffer(t) for t in trees)
        out.update(group.views(meta_update(
            group.pack(trees[0]) if w is None else w,
            group.pack(trees[1]) if w_hat is None else w_hat, alpha)))
    return layout.tree(out)
