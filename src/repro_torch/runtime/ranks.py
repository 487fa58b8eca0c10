"""Run one function in every rank of a fresh process group.

    outs = run_ranks(fn, world, workdir, *args)

starts ``world`` processes (the ``spawn`` start method, so a CUDA
context is never forked), joins them into a process group through a
``FileStore`` under ``workdir`` (a file, not a port: parallel callers
never race for one), calls ``fn(rank, *args)`` in each, and returns the
ranks' return values in rank order. ``fn`` must be importable (a module
level function). ``device`` is each rank's device: "cpu", or "cuda"
(the next card, by ``runtime.sharding.place_ranks``; raises without a
card), or None for that rule wherever it lands. The backend follows
the ranks' topology (``runtime.sharding.choose_backend``): more ranks
than cards share them through gloo. A rank that raises makes the
call raise with its traceback; a rank still running after ``timeout``
seconds is terminated and reported. Every process is joined before it
returns.
"""
from __future__ import annotations

import os
import pickle
import traceback
from typing import Any, Callable, List, Optional


def _rank_main(rank, world, workdir, fn, args, device, threads):
    import torch
    import torch.distributed as dist

    from repro_torch.runtime import sharding
    if threads:
        torch.set_num_threads(threads)
    out_path = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        sharding.init_distributed(
            None, world, rank, device=device,
            store=dist.FileStore(os.path.join(workdir, "store"), world))
        result = ("ok", fn(rank, *args))
    except BaseException:                         # reported to the parent
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, workdir: str, *args: Any,
              device: Optional[str] = None, threads: int = 1,
              timeout: float = 900.0) -> List[Any]:
    import multiprocessing
    import time

    os.makedirs(workdir, exist_ok=True)
    for name in ["store"] + [f"rank{r}.pkl" for r in range(world)]:
        path = os.path.join(workdir, name)
        if os.path.exists(path):
            os.remove(path)
    ctx = multiprocessing.get_context("spawn")
    # daemonic: a caller that dies takes its ranks with it
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, workdir, fn, args, device, threads),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    outs, errors = [], []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.terminate()
            p.join()
            errors.append(f"rank {r} still ran after {timeout} s")
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r} exited with code {p.exitcode} and no "
                          f"result")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            errors.append(f"rank {r}:\n{value}")
        outs.append(value)
    if errors:
        raise RuntimeError("run_ranks: " + "\n".join(errors))
    return outs
