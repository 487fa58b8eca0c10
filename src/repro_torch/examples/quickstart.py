"""Quickstart: the paper's Sine-wave case study end to end (Fig. 1 + 2),
on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        --rounds 20 --device cpu

Trains TinyReptile, Reptile and transfer learning on the sine-wave
meta-learning problem with the paper's 1->32->32->1 MLP (1,153 params),
then adapts each to unseen clients with 8 samples and 8 SGD steps and
prints the query MSE beside the random init's. Every algorithm is a
strategy on the shared round engine (``core/engine.py``); the last run
swaps the transport for an int8 ``CommChannel``, a 4x cheaper link.

The same runs as the JAX package's ``examples/quickstart.py`` (600
rounds by default; ``--rounds`` shortens them). The init is drawn with
torch's generator from seed 0, not ``jax.random``'s (``main(params=)``
takes another). It runs on the GPU; ``--device cpu`` runs the plain
PyTorch path.
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from repro_torch.configs.paper_models import SINE_MLP
from repro_torch.core import (CommChannel, evaluate_init, reptile_train,
                              tinyreptile_train, transfer_train)
from repro_torch.data import SineTasks
from repro_torch.device import resolve_device
from repro_torch.models.paper_nets import (init_paper_model,
                                           paper_model_apply,
                                           paper_model_loss, param_count)

LOSS = functools.partial(paper_model_loss, SINE_MLP)
EVAL = dict(num_tasks=10, support=8, k_steps=8, lr=0.02, query=64)
ROUNDS = 600


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error(f"--rounds must be >= 1, got {args.rounds}")
    return args


def main(argv=None, params=None):
    """Run the quickstart; returns each run's query MSE (and the comm
    bytes of the metered runs). ``params`` (a ``{leaf: array}`` tree)
    replaces the seeded torch init."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rounds = args.rounds
    if params is None:
        params = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0),
                                  dev)
    else:
        params = {k: torch.as_tensor(np.array(v), device=dev)
                  for k, v in params.items()}
    print(f"model: {SINE_MLP.name}, params = {param_count(params)} "
          "(paper Table I: 1,153)")
    dist = SineTasks()
    base = evaluate_init(LOSS, params, dist, np.random.default_rng(7), **EVAL)
    print(f"random init     : query MSE after adaptation = "
          f"{base['query_loss']:.3f}")
    run = dict(rounds=rounds, eval_every=rounds, eval_kwargs=EVAL, seed=1,
               device=dev)

    tiny = tinyreptile_train(LOSS, params, dist, alpha=1.0, beta=0.02,
                             support=32, **run)
    print(f"TinyReptile     : query MSE after adaptation = "
          f"{tiny['history'][-1]['query_loss']:.3f} "
          f"(comm = {tiny['comm_bytes']/1e6:.1f} MB)")

    rep = reptile_train(LOSS, params, dist, alpha=1.0, beta=0.02,
                        support=32, epochs=8, **run)
    print(f"Reptile (serial): query MSE after adaptation = "
          f"{rep['history'][-1]['query_loss']:.3f}")

    tr = transfer_train(LOSS, params, dist, beta=0.02, **run)
    print(f"transfer        : query MSE after adaptation = "
          f"{tr['history'][-1]['query_loss']:.3f}  <- fails (Fig. 1)")

    # the transfer collapse: predictions ~ E[f] ~ 0 everywhere
    xs = torch.linspace(-5, 5, 9, device=dev)[:, None]
    with torch.no_grad():
        preds = paper_model_apply(SINE_MLP, tr["params"], xs)[:, 0]
    preds = preds.cpu().numpy()
    print("transfer model predicts ~0 for all x:", np.round(preds, 2))

    # beyond the paper: the same engine over a quantized int8 transport
    # (the TIFeD direction), 4x fewer bytes on the wire
    q = tinyreptile_train(LOSS, params, dist, alpha=1.0, beta=0.02,
                          support=32, channel=CommChannel("int8"), **run)
    print(f"TinyReptile int8: query MSE after adaptation = "
          f"{q['history'][-1]['query_loss']:.3f} "
          f"(comm = {q['comm_bytes']/1e6:.1f} MB)")
    return {"random_init": base["query_loss"],
            "tinyreptile": tiny["history"][-1]["query_loss"],
            "reptile": rep["history"][-1]["query_loss"],
            "transfer": tr["history"][-1]["query_loss"],
            "tinyreptile_int8": q["history"][-1]["query_loss"],
            "transfer_predictions": preds.tolist(),
            "comm_bytes": tiny["comm_bytes"],
            "comm_bytes_int8": q["comm_bytes"]}


if __name__ == "__main__":
    main()
