"""Checkpoints in the JAX package's format: a tree of arrays to ``.npz``,
and the round-state layer that makes ``run_federated`` preemption-safe.

A checkpoint is ``ckpt_<step:08d>.npz`` (leaves stored under their tree
paths, e.g. ``"phi/w0"``, plus ``__step__`` and a JSON ``__extra__``)
next to a checksum manifest ``ckpt_<step>.json`` (size and crc32) and a
``LATEST`` pointer; every file is written to a tmp name and moved into
place with ``os.replace``, so a reader never sees a half-written file
under its final name. Files of either package read in the other.

Tree paths follow ``jax.tree_util``'s flattening as the JAX package
prints it: dict keys sorted, sequences by index, a ``PoolState`` by its
field index (it is a pytree node without keys there), ``None`` an empty
subtree, parts joined with "/". Leaves leave the device as NumPy; a
bf16 tensor is written as the JAX package writes an ``ml_dtypes``
bfloat16 array, its raw 2-byte bits (``|V2``), and only such an array
restores into a bf16 template (as a CPU bf16 tensor, NumPy having no
bf16).

Restoring validates structure, shapes and dtypes against a template
(nested dicts of arrays or tensors); a dtype mismatch raises unless
``cast=True``. Given a directory, snapshots are tried newest first and
torn or corrupted files are skipped with a warning.

On top sits the round-state layer of ``core.engine.run_federated``:

- :class:`RoundState`: the run's whole carry at a block boundary (phi,
  the ``PoolState`` with its FedBuff buffer, the transport bills, the
  eval history, and the host RNG, pool and policy state);
- :func:`save_round_state` / :func:`restore_round_state`;
- :class:`AsyncCheckpointWriter`: a background thread that copies a
  snapshot to the host and writes it, behind a bounded queue, keeping
  the last K snapshots.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import queue
import re
import threading
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")

#: how the JAX package stores an ``ml_dtypes`` bfloat16 leaf: raw bits
_BF16_BITS = np.dtype("V2")

#: fault-injection hook for tests (``repro_torch.testing.faults``):
#: called as hook(step) once a snapshot is durable (payload, manifest and
#: LATEST on disk). None in production.
_post_save_hook: Optional[Callable[[int], None]] = None


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(str(i), getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in the JAX package's order (see the module
    docstring); ``None`` subtrees hold no leaves."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(tree, values):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(_rebuild(getattr(tree, f.name), values)
                            for f in dataclasses.fields(tree)))
    return next(values)


def map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)`` (the nodes of
    :func:`_leaves`: dicts, sequences, dataclasses such as a
    ``PoolState``; ``None`` stays)."""
    return _rebuild(tree, (fn(leaf) for _, leaf in _leaves(tree)))


def _to_numpy(leaf) -> np.ndarray:
    """A leaf on the host as NumPy; a bf16 tensor as its raw bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {(path or f"leaf{i}"): _to_numpy(leaf)
            for i, (path, leaf) in enumerate(_leaves(tree))}


def _is_bf16(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _np_dtype(leaf) -> np.dtype:
    if _is_bf16(leaf):
        return _BF16_BITS
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _jsonable(obj):
    """Recursively coerce NumPy scalars and arrays so ``extra`` dicts
    (eval history rows, RNG bit-generator states) survive json.dumps."""
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def _crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _atomic_write_bytes(path: str, data: bytes) -> None:
    # a fixed per-process tmp name: one writer a process, and atomicity
    # comes from os.replace
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _atomic_write_text(path: str, text: str) -> None:
    _atomic_write_bytes(path, text.encode())


def manifest_path(payload_path: str) -> str:
    """The checksum manifest sitting next to ``ckpt_<step>.npz``."""
    root, _ = os.path.splitext(payload_path)
    return root + ".json"


def list_checkpoints(directory: str) -> List[str]:
    """All ``ckpt_*.npz`` payload paths in ``directory``, oldest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = [(int(m.group(1)), os.path.join(directory, name))
             for name in names for m in [_CKPT_RE.match(name)] if m]
    return [p for _, p in sorted(found)]


def _apply_retention(directory: str, keep: int) -> None:
    if keep < 1:
        return
    for path in list_checkpoints(directory)[:-keep]:
        for victim in (path, manifest_path(path)):
            try:
                os.remove(victim)
            except OSError:
                pass


def save_checkpoint(directory: str, tree: Any, step: int,
                    extra: Optional[dict] = None,
                    keep: Optional[int] = None) -> str:
    """Write ``ckpt_<step>.npz`` and its checksum manifest, point LATEST
    at it, and with ``keep`` delete all but the newest ``keep``
    snapshots. Leaves may be tensors (on any device) or arrays."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    # serialized in memory: one write a file, the checksum from the buffer
    buf = io.BytesIO()
    np.savez(buf, __step__=step,
             __extra__=json.dumps(_jsonable(extra or {})), **flat)
    payload = buf.getvalue()
    _atomic_write_bytes(path, payload)
    _atomic_write_text(manifest_path(path), json.dumps({
        "file": os.path.basename(path), "step": int(step),
        "size": len(payload),
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF}))
    _atomic_write_text(os.path.join(directory, "LATEST"),
                       os.path.basename(path))
    if keep is not None:
        _apply_retention(directory, keep)
    hook = _post_save_hook
    if hook is not None:
        hook(int(step))
    return path


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` exists and matches its manifest (size + crc32).
    A payload without a manifest passes (a torn zip is still caught at
    load time)."""
    if not os.path.exists(path):
        return False
    man = manifest_path(path)
    if not os.path.exists(man):
        return True
    try:
        with open(man) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    if meta.get("size") != os.path.getsize(path):
        return False
    return meta.get("crc32") == _crc32(path)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest checkpoint payload in ``directory``, or None. Trusts the
    LATEST pointer only when it names an existing ``ckpt_*.npz``."""
    marker = os.path.join(directory, "LATEST")
    if os.path.exists(marker):
        with open(marker) as f:
            name = f.read().strip()
        cand = os.path.join(directory, name)
        if name and _CKPT_RE.match(name) and os.path.exists(cand):
            return cand
        logger.warning(
            "checkpoint LATEST pointer in %s is stale (%r); falling back "
            "to a directory scan", directory, name)
    paths = list_checkpoints(directory)
    return paths[-1] if paths else None


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Load and materialize every member, so a torn file raises here."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _restore_from_data(data, template, cast: bool):
    out = []
    for i, (key, leaf) in enumerate(_leaves(template)):
        key = key or f"leaf{i}"
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        want = _np_dtype(leaf)
        if arr.dtype != want:
            if not cast or arr.dtype == _BF16_BITS or want == _BF16_BITS:
                raise TypeError(
                    f"{key}: checkpoint dtype {arr.dtype} != template "
                    f"{want}; refusing to cast silently (a float file "
                    f"restored into a quantized template would corrupt "
                    f"it); pass cast=True to opt in")
            arr = arr.astype(want)
        if want == _BF16_BITS and _is_bf16(leaf):
            arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        out.append(arr)
    step = int(data["__step__"])
    extra = json.loads(str(data["__extra__"]))
    return _rebuild(template, iter(out)), step, extra


def restore_checkpoint(directory_or_file: str, template: Any,
                       cast: bool = False):
    """Returns (tree, step, extra) with NumPy leaves shaped like
    ``template`` (bf16 leaves as CPU bf16 tensors). A directory is tried
    newest snapshot first, skipping torn or corrupted files; a mismatch
    against the template raises."""
    path = directory_or_file
    if not os.path.isdir(path):
        if not verify_checkpoint(path):
            raise ValueError(f"checkpoint {path} fails its checksum "
                             f"manifest (torn or corrupted write)")
        return _restore_from_data(_read_npz(path), template, cast)

    candidates = list(reversed(list_checkpoints(path)))
    pointed = latest_checkpoint(path)
    if pointed in candidates:
        candidates.remove(pointed)
        candidates.insert(0, pointed)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {directory_or_file}")
    for cand in candidates:
        if not verify_checkpoint(cand):
            logger.warning(
                "checkpoint %s fails its checksum manifest (torn or "
                "corrupted write); falling back to the next snapshot",
                cand)
            continue
        try:
            data = _read_npz(cand)
        except (OSError, ValueError, EOFError, zipfile.BadZipFile,
                zlib.error) as exc:
            logger.warning(
                "checkpoint %s is unreadable (%s); falling back to the "
                "next snapshot", cand, exc)
            continue
        return _restore_from_data(data, template, cast)
    raise ValueError(
        f"every checkpoint in {directory_or_file} is torn or corrupted "
        f"({len(candidates)} candidates tried)")


# ---------------------------------------------------------------------------
# The round-state layer: run_federated's whole carry.

@dataclasses.dataclass
class RoundState:
    """``run_federated``'s carry at a block boundary.

    round:            completed rounds; resume plans its blocks from here
                      (``plan_blocks(..., start=round)``).
    phi:              the server params as a ``{leaf: array}`` tree.
    pool_state:       a ``core.pool.PoolState`` (the full ``(N,)``
                      identity arrays, the FedBuff buffer and its
                      counters), or None.
    per_client_bytes: (N,) int64 transport bills.
    comm_bytes:       total transport billed so far.
    history:          the eval rows so far (JSON-able dicts).
    host:             the host state that makes resume bit-for-bit:
                      ``{"rng": <bit_generator state>, "pool":
                      ClientPool.host_state(), "sampling":
                      SamplingPolicy.state_dict()}``, captured on the
                      prefetch producer right after the block's draws.
    fingerprint:      the run's identity (seed, cohort, pool, strategy,
                      ...), checked at resume.
    """
    round: int
    phi: Any
    pool_state: Any = None
    per_client_bytes: Any = None
    comm_bytes: int = 0
    history: list = dataclasses.field(default_factory=list)
    host: dict = dataclasses.field(default_factory=dict)
    fingerprint: dict = dataclasses.field(default_factory=dict)


def round_state_payload(state: RoundState) -> Tuple[dict, int, dict]:
    """(tree, step, extra) for the checkpoint format: the arrays go in
    the npz, the host side in the extra JSON."""
    tree = {"phi": state.phi}
    if state.pool_state is not None:
        tree["pool"] = state.pool_state
    if state.per_client_bytes is not None:
        tree["bills"] = np.asarray(state.per_client_bytes)
    extra = {"comm_bytes": int(state.comm_bytes),
             "history": state.history, "host": state.host,
             "fingerprint": state.fingerprint}
    return tree, int(state.round), extra


def save_round_state(directory: str, state: RoundState,
                     keep: Optional[int] = None) -> str:
    tree, step, extra = round_state_payload(state)
    return save_checkpoint(directory, tree, step, extra=extra, keep=keep)


def restore_round_state(directory: str, *, phi, pool_state=None,
                        per_client_bytes=None,
                        cast: bool = False) -> RoundState:
    """The newest valid :class:`RoundState` in ``directory``; the keyword
    templates fix shapes and dtypes. Raises FileNotFoundError when the
    directory holds no snapshot."""
    template = {"phi": phi}
    if pool_state is not None:
        template["pool"] = pool_state
    if per_client_bytes is not None:
        template["bills"] = np.asarray(per_client_bytes)
    tree, step, extra = restore_checkpoint(directory, template, cast=cast)
    return RoundState(
        round=step, phi=tree["phi"], pool_state=tree.get("pool"),
        per_client_bytes=tree.get("bills"),
        comm_bytes=int(extra.get("comm_bytes", 0)),
        history=list(extra.get("history", [])),
        host=dict(extra.get("host", {})),
        fingerprint=dict(extra.get("fingerprint", {})))


def load_params(directory_or_file: str, template, *, cast: bool = False):
    """Just the params tree for serving: the ``phi`` sub-tree of a
    ``run_federated(ckpt_dir=...)`` round-state checkpoint (of either
    package), or a plain ``save_checkpoint`` snapshot whose tree is the
    params. Returns NumPy leaves shaped like ``template``."""
    try:
        tree, _, _ = restore_checkpoint(directory_or_file,
                                        {"phi": template}, cast=cast)
        return tree["phi"]
    except KeyError:
        tree, _, _ = restore_checkpoint(directory_or_file, template,
                                        cast=cast)
        return tree


def _to_host(tree, ready, streams: Dict):
    """A snapshot's leaves as NumPy. CUDA leaves are read on a side
    stream of their device that first waits on ``ready`` (the event the
    training stream recorded after making the snapshot): only that
    stream is synchronized, never the device."""
    cuda = [leaf for _, leaf in _leaves(tree)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    if not cuda:
        return map_leaves(_to_numpy, tree)
    dev = cuda[0].device
    side = streams.get(dev)
    if side is None:
        side = streams[dev] = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        if ready is not None:
            side.wait_event(ready)
        return map_leaves(_to_numpy, tree)


class AsyncCheckpointWriter:
    """Background-thread snapshot writer: ``submit`` enqueues a tree and
    returns at once; the writer thread copies it to the host and writes
    it with ``save_checkpoint``. The queue is bounded (``depth``): when
    the writer falls that many snapshots behind, ``submit`` blocks.
    Errors of the writer thread are raised on the caller's thread at the
    next ``submit``, ``wait`` or ``close``.

    The engine hands this thread snapshot copies made on the training
    stream right after a block, with ``ready``, a CUDA event recorded
    after the copies: the thread waits on it on a stream of its own and
    never reads the runner's live buffers, which the next block's
    replays overwrite. With a ``tracker`` (a ``metering.MetricsTracker``)
    each snapshot's milliseconds on this thread (the copy to the host and
    the files) are observed as ``ckpt.write_ms``.
    """

    _DONE = object()

    def __init__(self, directory: str, keep: Optional[int] = 3,
                 depth: int = 2, tracker=None):
        self.directory = directory
        self.keep = keep
        self.tracker = tracker
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._error: Optional[BaseException] = None
        self._closed = False
        self._streams: Dict = {}
        self._thread = threading.Thread(target=self._run,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._DONE:
                self._q.task_done()
                return
            tree, step, extra, ready = item
            t0 = time.perf_counter()
            try:
                host = _to_host(tree, ready, self._streams)
                del tree
                save_checkpoint(self.directory, host, step, extra=extra,
                                keep=self.keep)
            except BaseException as exc:  # raised on the caller's thread
                self._error = exc
            if self.tracker is not None:
                self.tracker.observe("ckpt.write_ms",
                                     1e3 * (time.perf_counter() - t0))
            self._q.task_done()

    def _check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, tree, step: int, extra: Optional[dict] = None,
               ready=None) -> None:
        """Queue ``tree`` (tensors or arrays) as snapshot ``step``;
        ``ready`` is the CUDA event after which its device leaves hold
        their values."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        self._check()
        self._q.put((tree, int(step), extra, ready))

    def submit_state(self, state: RoundState, ready=None) -> None:
        tree, step, extra = round_state_payload(state)
        self.submit(tree, step, extra, ready)

    def wait(self) -> None:
        """Block until every submitted snapshot is durable; re-raise any
        writer error."""
        self._q.join()
        self._check()

    def close(self, raise_errors: bool = True) -> None:
        """Drain the queue and stop the thread (idempotent); with
        ``raise_errors`` re-raise a pending writer error."""
        if not self._closed:
            self._closed = True
            if self._thread.is_alive():
                self._q.put(self._DONE)
            self._thread.join(timeout=120.0)
        if raise_errors:
            self._check()
