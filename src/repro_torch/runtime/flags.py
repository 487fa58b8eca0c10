"""Runtime mode flags, the port of the JAX package's ``runtime/flags.py``.

The same names, the same environment variables, so one environment
drives both packages: ``REPRO_PROBE=1`` turns probe mode on and
``REPRO_OPT_<NAME>=1`` a feature; ``probe_scope`` and ``feature_scope``
override them for the calling thread, nest, and restore on exit.

PROBE mode, in the JAX package, replaces loops over layers and blocks
with their unrolled, single-block equivalents for XLA's exact-cost
compiles, and materialises S^2 scores: never use it for real execution.
The port has no cost analysis to serve; what it keeps of probe mode is
the per-layer params layout (``Model.jax_layout`` is None), so that the
bridge carries the JAX package's probe trees. Its other routes compute
what the default routes compute, and the port takes those.

The features (the JAX package's performance levers), with what each
does on one device in the port:

- ``ringkv``: a sliding-window layer's decode cache is a ring of
  ``window`` rows (``Model.init_cache``), written at ``cache_len % window``
  and attended over ``min(cache_len + 1, window)`` rows through
  ``flash_decode``: cache bytes and attention reads / (S / window).
- ``banded``: sliding-window attention gathers only the KV band of each
  query block (``models/attention.py::_banded_attention``).
- ``gqa_flat``, ``seqpar``, ``moelocal``, ``moe2d``: accepted, and change
  nothing. With no device mesh each computes what the default route
  computes (K and V repeated to the query heads, one query block, the
  MoE block as one token group, shards only placed); they exist to be
  sharded, and their sharding needs a mesh, which is not ported.
- ``ssd_pallas``: mamba2's chunked scan through the Pallas kernel; the
  port's train path always takes ``ssd_scan``.
"""
from __future__ import annotations

import contextlib
import os
import threading

_state = threading.local()

_FEATURES = ("gqa_flat", "banded", "moe2d", "ringkv", "moelocal",
             "seqpar", "ssd_pallas")


def probe_mode() -> bool:
    """The calling thread's probe scope, else ``REPRO_PROBE == "1"``."""
    if getattr(_state, "probe", None) is not None:
        return _state.probe
    return os.environ.get("REPRO_PROBE", "0") == "1"


@contextlib.contextmanager
def probe_scope(on: bool = True):
    prev = getattr(_state, "probe", None)
    _state.probe = on
    try:
        yield
    finally:
        _state.probe = prev


def _known(names) -> None:
    unknown = set(names) - set(_FEATURES)
    if unknown:
        raise ValueError(f"unknown feature(s) {sorted(unknown)}; the "
                         f"features are {_FEATURES}")


def feature(name: str) -> bool:
    """The calling thread's setting of ``name`` (a scope, or
    ``set_features_from_env_string``), else ``REPRO_OPT_<NAME> == "1"``."""
    _known([name])
    st = getattr(_state, "features", None)
    if st is not None and name in st:
        return st[name]
    return os.environ.get(f"REPRO_OPT_{name.upper()}", "0") == "1"


@contextlib.contextmanager
def feature_scope(**kw):
    _known(kw)
    prev = getattr(_state, "features", None)
    _state.features = {**(prev or {}), **kw}
    try:
        yield
    finally:
        _state.features = prev


def set_features_from_env_string(s: str) -> None:
    """``"gqa_flat,moe2d"`` -> those features on and every other off, for
    the calling thread (the dry run's ``--opt``)."""
    on = {x.strip() for x in s.split(",") if x.strip()}
    _known(on)
    _state.features = {f: (f in on) for f in _FEATURES}
