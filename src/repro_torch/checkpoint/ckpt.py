"""Read side of the JAX package's checkpoint format, for serving.

A checkpoint is ``ckpt_<step>.npz`` (leaves stored under their tree
paths, e.g. ``"phi/w0"``, plus ``__step__`` and a JSON ``__extra__``)
next to a checksum manifest ``ckpt_<step>.json`` and a ``LATEST``
pointer. This module finds, verifies and reads such files, so the port
can serve a meta-init that a JAX training run saved. Writing comes with
the training slice.

Restoring validates structure, shapes and dtypes against a template
(nested dicts of arrays or tensors); a dtype mismatch raises unless
``cast=True``. Given a directory, snapshots are tried newest first and
torn or corrupted files are skipped with a warning.
"""
from __future__ import annotations

import json
import logging
import os
import re
import zipfile
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in the JAX package's order: dict keys sorted,
    sequences by index, path parts joined with "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def _np_dtype(leaf) -> np.dtype:
    if hasattr(leaf, "detach"):                 # a torch tensor
        return leaf.detach().cpu().numpy().dtype
    return np.asarray(leaf).dtype


def _crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


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
            if not cast:
                raise TypeError(
                    f"{key}: checkpoint dtype {arr.dtype} != template "
                    f"{want}; refusing to cast silently (a float file "
                    f"restored into a quantized template would corrupt "
                    f"it); pass cast=True to opt in")
            arr = arr.astype(want)
        out.append(arr)
    step = int(data["__step__"])
    extra = json.loads(str(data["__extra__"]))
    return _rebuild(template, iter(out)), step, extra


def restore_checkpoint(directory_or_file: str, template: Any,
                       cast: bool = False):
    """Returns (tree, step, extra) with NumPy leaves shaped like
    ``template``. A directory is tried newest snapshot first, skipping
    torn or corrupted files; a mismatch against the template raises."""
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


def load_params(directory_or_file: str, template, *, cast: bool = False):
    """Just the params tree for serving: the ``phi`` sub-tree of a
    ``run_federated(ckpt_dir=...)`` round-state checkpoint, or a plain
    ``save_checkpoint`` snapshot whose tree is the params. Returns NumPy
    leaves shaped like ``template``."""
    try:
        tree, _, _ = restore_checkpoint(directory_or_file,
                                        {"phi": template}, cast=cast)
        return tree["phi"]
    except KeyError:
        tree, _, _ = restore_checkpoint(directory_or_file, template,
                                        cast=cast)
        return tree
