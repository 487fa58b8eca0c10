"""Adaptation-serving launcher of the port.

A continuous-batching ``serving.AdaptationServer`` over the sine-MLP
meta-init sustains a ragged stream of client-adaptation requests (fp32
online SGD or int8 TIFeD epochs) and prints one JSON row with
requests/sec and latency percentiles:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode adapt \\
        --strategy fp32 --requests 512 --slots 64 --k-max 10

It runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the
CPU instead. ``--ckpt-dir`` serves the phi of a checkpoint written by
the JAX package (``run_federated(ckpt_dir=...)`` or
``save_checkpoint``); otherwise phi is a fresh init from ``--seed``
drawn with torch's generator, which does not reproduce ``jax.random``'s
init at the same seed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve client-adaptation requests over the sine-MLP "
                    "meta-init.")
    ap.add_argument("--mode", choices=("adapt",), default="adapt")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the requests and of the fresh phi "
                         "(a torch-generator init: not the JAX package's "
                         "init at the same seed; use --ckpt-dir for that)")
    ap.add_argument("--strategy", choices=("fp32", "tifed"), default="fp32")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--support", type=int, default=10)
    ap.add_argument("--k-max", type=int, default=10)
    ap.add_argument("--query", type=int, default=20)
    ap.add_argument("--steps-per-tick", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and cross-validate before any tensor work."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error(f"--requests must be >= 1, got {args.requests}")
    if args.slots < 1:
        ap.error(f"--slots must be >= 1, got {args.slots}")
    if args.k_max < 1:
        ap.error(f"--k-max must be >= 1, got {args.k_max}")
    if args.steps_per_tick < 1:
        ap.error(f"--steps-per-tick must be >= 1, got "
                 f"{args.steps_per_tick}")
    if args.strategy == "fp32" and args.k_max > args.support:
        ap.error(f"--k-max {args.k_max} online steps need --support "
                 f">= k-max, got {args.support}")
    if args.strategy == "tifed" and args.support & (args.support - 1):
        ap.error(f"--support must be a power of two for tifed "
                 f"(bit-shift batch mean), got {args.support}")
    return args


def run_adapt(args):
    import functools

    import torch

    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core.strategies import tifed_requantize
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.metering import MetricsTracker
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)
    from repro_torch.serving import (AdaptationServer, Fp32Adapter,
                                     TifedAdapter)

    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    phi = init_paper_model(SINE_MLP, gen, dev)
    if args.strategy == "tifed":
        phi = tifed_requantize(phi)
        adapter = TifedAdapter(support=args.support, k_max=args.k_max)
    else:
        adapter = Fp32Adapter(
            loss_fn=functools.partial(paper_model_loss, SINE_MLP))
    if args.ckpt_dir is not None:
        from repro_torch.checkpoint import load_params
        phi = params_from_numpy(
            load_params(args.ckpt_dir, params_to_numpy(phi)), dev)

    tracker = MetricsTracker()
    server = AdaptationServer(phi, adapter, slots=args.slots,
                              k_max=args.k_max,
                              steps_per_tick=args.steps_per_tick,
                              metrics=tracker, device=dev)
    rng = np.random.default_rng(args.seed)
    a = rng.uniform(0.1, 5.0, args.requests)
    b = rng.uniform(0.0, np.pi, args.requests)

    def submit(i):
        sx = rng.uniform(-5, 5, (args.support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (args.query, 1)).astype(np.float32)
        k = int(rng.integers(1, args.k_max + 1))
        server.submit(sx, np.float32(a[i] * np.sin(sx + b[i])),
                      qx, np.float32(a[i] * np.sin(qx + b[i])), k)

    submit(0)
    server.drain()                    # warm-up: builds the kernels
    server.reset()
    tracker = MetricsTracker()
    server.metrics = tracker
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(args.requests):
        submit(i)
    results = server.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    row = {
        "mode": "adapt", "strategy": args.strategy,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "requests": len(results), "slots": args.slots,
        "k_max": args.k_max, "steps_per_tick": args.steps_per_tick,
        "wall_s": round(dt, 3),
        "req_per_s": round(len(results) / dt, 1),
        "ticks": server.ticks,
        "kernel_launches": ops.launch_counts(),
        "latency_ms": {k: round(v, 3) for k, v in
                       tracker.percentiles("serve.latency_ms").items()},
        "mean_query_loss": round(
            float(np.mean([r.query_loss for r in results])), 5)}
    print(json.dumps(row, indent=1))
    return row


def main(argv=None):
    run_adapt(parse_args(argv))


if __name__ == "__main__":
    main()
