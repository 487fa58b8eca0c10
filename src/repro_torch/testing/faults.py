"""Fault-injection harness for the preemption-safety layer.

Simulates the ways a federated run actually dies and the ways its
checkpoint directory actually rots, so tests can pin the recovery
contract (``repro_torch.checkpoint`` and ``run_federated(ckpt_dir=...,
resume=True)``). The port's copy of the JAX package's harness, hooked
into ``repro_torch.checkpoint.ckpt._post_save_hook``:

- :func:`crash_at_round` — deterministic in-process preemption: raise
  right after the first durable snapshot at/past a given round (pair
  with ``ckpt_async=False`` for an exact crash point);
- :func:`announce_snapshots` + :func:`kill_after_snapshot` — REAL
  preemption: a subprocess child prints a marker per durable snapshot,
  the parent SIGKILLs it mid-flight (possibly mid-block or mid-write —
  resume must fall back to the newest valid snapshot);
- :func:`truncate_file` (torn write), :func:`flip_bytes` (corrupted
  leaves under an intact size), :func:`make_stale_latest` (pointer to a
  nonexistent payload) — checkpoint-directory rot that restore must
  detect via checksums and degrade around with a warning.
"""
from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import ckpt as _ckpt

#: stdout marker printed by announce_snapshots after each durable write
SNAPSHOT_TAG = "SNAPSHOT"


class SimulatedPreemption(Exception):
    """The 'kill' raised by :func:`crash_at_round` — catch it exactly
    (never via a broad handler) in tests."""


@contextlib.contextmanager
def crash_at_round(round_threshold: int):
    """While active, raise :class:`SimulatedPreemption` right after the
    FIRST durable snapshot with ``step >= round_threshold`` (payload +
    manifest + LATEST already on disk, so a resume from that very
    snapshot must succeed). With the engine's default async writer the
    raise lands on the writer thread and surfaces at the next
    submit/close; pass ``ckpt_async=False`` for a deterministic
    main-thread crash point."""
    prev = _ckpt._post_save_hook

    def hook(step: int) -> None:
        if prev is not None:
            prev(step)
        if step >= round_threshold:
            raise SimulatedPreemption(
                f"simulated preemption after snapshot {step}")

    _ckpt._post_save_hook = hook
    try:
        yield
    finally:
        _ckpt._post_save_hook = prev


@contextlib.contextmanager
def announce_snapshots(tag: str = SNAPSHOT_TAG):
    """While active, print ``'<tag> <step>'`` (flushed) after each
    durable snapshot — the stdout marker :func:`kill_after_snapshot`
    watches for from the parent process."""
    prev = _ckpt._post_save_hook

    def hook(step: int) -> None:
        if prev is not None:
            prev(step)
        print(f"{tag} {step}", flush=True)

    _ckpt._post_save_hook = hook
    try:
        yield
    finally:
        _ckpt._post_save_hook = prev


def kill_after_snapshot(cmd: List[str], n: int = 1, *,
                        marker: str = SNAPSHOT_TAG, env=None, cwd=None,
                        timeout: float = 300.0,
                        sig=signal.SIGKILL) -> Tuple[Optional[int], str]:
    """Run ``cmd`` and SIGKILL it right after its n-th ``marker`` stdout
    line — a real preemption at an ARBITRARY execution point (the child
    may die inside a block, mid-device-transfer, or mid-write; only the
    announced snapshots are guaranteed durable). Returns
    ``(returncode, collected stdout)``; the return code is the signal's
    negative on a successful kill."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=cwd)
    seen, lines = 0, []
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            lines.append(line)
            if marker in line:
                seen += 1
                if seen >= n:
                    proc.send_signal(sig)
                    break
            if time.monotonic() > deadline:
                proc.kill()
                raise TimeoutError(
                    f"{marker} seen {seen}/{n} times within {timeout}s:\n"
                    + "".join(lines[-50:]))
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(lines)


def truncate_file(path: str, keep_fraction: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
    """Torn write: chop ``path`` to a prefix (default half its bytes).
    Returns the bytes kept."""
    size = os.path.getsize(path)
    keep = (keep_bytes if keep_bytes is not None
            else max(1, int(size * keep_fraction)))
    keep = min(keep, size)
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def flip_bytes(path: str, offset: Optional[int] = None, count: int = 8,
               seed: int = 0) -> int:
    """Corrupt ``count`` bytes in place (XOR 0xFF) WITHOUT changing the
    file size — the failure mode only a content checksum catches.
    Returns the corrupted offset."""
    size = os.path.getsize(path)
    if offset is None:
        rng = np.random.default_rng(seed)
        offset = int(rng.integers(max(1, size - count)))
    with open(path, "rb+") as f:
        f.seek(offset)
        data = f.read(count)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in data))
    return offset


def make_stale_latest(directory: str,
                      name: str = "ckpt_99999999.npz") -> None:
    """Point the LATEST marker at a payload that does not exist (a
    crash between payload write and pointer update, or a pruned file)."""
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(name)
