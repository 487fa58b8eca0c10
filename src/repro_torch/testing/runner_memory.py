"""What a dropped runner leaves on the card until Python's cyclic
collector runs.

    python -m repro_torch.testing.runner_memory [--arch tinyllama-1.1b]

With the collector off: a decode runner (``runtime/steps.py::
DecodeRunner``) of ``--arch`` at full width in bf16, ``--batch`` slots
and a cache of ``--cache-len``, built (its step captured) and run for one
wave, then dropped; and the round engine's runner of ``--strategy
reptile`` on the sine MLP (a few rounds), dropped by
``core.clear_runner_cache``. For each, ``torch.cuda.memory_allocated``
with the runner, after its last reference is dropped, and after a
``gc.collect()``: the collection's share is what a reference cycle kept
alive. For the engine also the allocator's live blocks of 1 MiB or more
that remain, and what clearing cuBLAS's workspaces then frees (PyTorch
keeps one workspace per cuBLAS handle and stream, outside any runner). Prints one JSON line. Needs a CUDA device. It uses only entry
points older than the fix, so it runs against an older checkout too
(``PYTHONPATH=<checkout>/src python <this file>``).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import subprocess

import torch


def _allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _live_blocks() -> list:
    """The sizes of the allocator's live blocks of 1 MiB or more."""
    return sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                   for b in seg["blocks"]
                   if b["state"] == "active_allocated"
                   and b["size"] >= 1 << 20), reverse=True)


def _drop(holder: dict, key: str) -> dict:
    """Allocated bytes with ``holder[key]``, after deleting it, and after
    a collection."""
    held = _allocated()
    del holder[key]
    dropped = _allocated()
    gc.collect()
    collected = _allocated()
    return {"held_bytes": held, "freed_on_drop": held - dropped,
            "freed_by_gc": dropped - collected}


def decode_runner(arch: str, batch: int, cache_len: int) -> dict:
    from repro_torch.bridge import tree_leaves, unflatten_tree
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.steps import DecodeRunner

    model = build_model(get_arch(arch))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = unflatten_tree({
        path: (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dt)
        for path, (shape, dt) in tree_leaves(model.param_shapes())})
    base = _allocated()
    box = {"runner": DecodeRunner(model, params, batch=batch, prompt_len=8,
                                  cache_len=cache_len, max_new=8,
                                  device="cuda")}
    box["runner"].wave(torch.zeros(batch, 8, dtype=torch.int64))
    cache = sum(t.numel() * t.element_size()
                for _, t in tree_leaves(box["runner"].cache))
    out = _drop(box, "runner")
    return {"arch": arch, "batch": batch, "cache_len": cache_len,
            "cache_bytes": cache, "runner_bytes": out["held_bytes"] - base,
            **out}


def engine_runner() -> dict:
    from repro_torch.core import engine
    from repro_torch.launch import train

    engine.clear_runner_cache()
    base = _allocated()
    with contextlib.redirect_stdout(io.StringIO()):
        train.run_engine_strategy(train.parse_args(
            ["--strategy", "reptile", "--rounds", "4", "--clients", "64"]))
    held = _allocated()
    engine.clear_runner_cache()
    dropped = _allocated()
    gc.collect()
    collected = _allocated()
    after = _live_blocks()
    torch._C._cuda_clearCublasWorkspaces()
    return {"strategy": "reptile", "clients": 64,
            "runner_bytes": held - base, "held_bytes": held,
            "freed_on_drop": held - dropped,
            "freed_by_gc": dropped - collected,
            "live_blocks_after_gc": after,
            "freed_by_clearing_cublas_workspaces": collected - _allocated()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=2048)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("runner_memory: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gc.disable()
    row = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "decode_runner": decode_runner(args.arch, args.batch,
                                          args.cache_len),
           "engine_runner": engine_runner()}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
