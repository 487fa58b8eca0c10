"""Training launcher of the port: one round-engine run on the paper's
sine workload, one JSON row.

    PYTHONPATH=src python -m repro_torch.launch.train --strategy reptile

``--strategy reptile|fedavg|fedsgd|transfer`` runs ``run_federated``
with the JAX launcher's defaults (64 clients per round, 20 rounds,
beta 0.02, support 32, 8 local epochs, one eval at the end) on the GPU;
``--device cpu`` runs the plain PyTorch path on the CPU instead. The
init is drawn from ``--seed`` with torch's generator, which does not
reproduce ``jax.random``'s init at the same seed. The flags of routes
not ported yet (the LM launcher and its ``--arch``, pools, availability,
FedBuff buffering, meshes, checkpoints, multi-process runs, the
``tinyreptile`` and ``tifed`` strategies) are rejected at parse time.
"""
from __future__ import annotations

import argparse
import json
import time

ENGINE_STRATEGIES = ("reptile", "fedavg", "fedsgd", "transfer")
NOT_PORTED_STRATEGIES = ("tinyreptile", "tifed")
NOT_PORTED_FLAGS = ("--arch", "--reduced", "--batch", "--seq", "--k-inner",
                    "--pool-size", "--pool-sampler", "--pool-residency",
                    "--availability", "--buffer-size", "--devices", "--mesh",
                    "--coordinator", "--num-processes", "--process-id",
                    "--ckpt-dir", "--ckpt-every", "--resume")
# eval protocol of the JAX launcher's sine route
EVAL_KWARGS = dict(num_tasks=5, support=10, k_steps=16, lr=0.02, query=20)
SUPPORT = 32
EPOCHS = 8


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: the port's "
                     f"launcher runs the engine route --strategy "
                     f"{'|'.join(ENGINE_STRATEGIES)} on the sine MLP")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated meta-training of the sine MLP on the "
                    "port's round engine.")
    ap.add_argument("--strategy", default="tinyreptile",
                    choices=NOT_PORTED_STRATEGIES + ENGINE_STRATEGIES)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--beta", type=float, default=0.02)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of the cohort that checks in each "
                         "round (a PartialParticipation schedule)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for flag in NOT_PORTED_FLAGS:
        ap.add_argument(flag, nargs="?", action=_NotPorted,
                        help="not ported yet")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and cross-validate before any tensor work."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.strategy in NOT_PORTED_STRATEGIES:
        ap.error(f"--strategy {args.strategy} is not ported yet; pass "
                 f"--strategy {'|'.join(ENGINE_STRATEGIES)}")
    if args.rounds < 1:
        ap.error(f"--rounds must be >= 1, got {args.rounds}")
    if args.clients < 1:
        ap.error(f"--clients must be >= 1, got {args.clients}")
    if not 0.0 < args.participation <= 1.0:
        ap.error(f"--participation must be in (0, 1], got "
                 f"{args.participation}")
    return args


def run_engine_strategy(args, init_params=None):
    """One ``run_federated`` call as the JAX launcher's engine route
    makes it; prints the summary row and returns ``(row, out)``, out
    being ``run_federated``'s result. ``init_params`` (a ``{leaf:
    array}`` tree) replaces the seeded torch init — how a caller starts
    from the JAX package's init."""
    import functools

    import torch

    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core import (CommChannel, PartialParticipation,
                                  run_federated)
    from repro_torch.core.strategies import (FedAvgStrategy, FedSGDStrategy,
                                             ReptileStrategy,
                                             TransferStrategy)
    from repro_torch.data import SineTasks
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)

    dev = resolve_device(args.device)
    loss = functools.partial(paper_model_loss, SINE_MLP)
    if init_params is None:
        init_params = init_paper_model(
            SINE_MLP, torch.Generator().manual_seed(args.seed), dev)
    strategy = {
        "reptile": lambda: ReptileStrategy(loss, epochs=EPOCHS),
        "fedavg": lambda: FedAvgStrategy(loss, epochs=EPOCHS),
        "fedsgd": lambda: FedSGDStrategy(loss),
        "transfer": lambda: TransferStrategy(loss),
    }[args.strategy]()
    sampling = (PartialParticipation(args.participation)
                if args.participation < 1.0 else None)
    ops.reset_launch_counts()
    t0 = time.time()
    out = run_federated(
        init_params, SineTasks(), strategy, rounds=args.rounds,
        clients_per_round=args.clients, alpha=args.alpha, beta=args.beta,
        support=SUPPORT, seed=args.seed, eval_every=args.rounds,
        eval_kwargs=EVAL_KWARGS, channel=CommChannel(), sampling=sampling,
        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    row = {"strategy": args.strategy, "rounds": args.rounds,
           "clients": args.clients, "dt_s": round(time.time() - t0, 3),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "kernel_launches": ops.launch_counts()}
    if out["history"]:
        row["query_loss"] = round(float(out["history"][-1]["query_loss"]),
                                  4)
    if "comm_bytes" in out:
        row["comm_mb"] = round(out["comm_bytes"] / 2 ** 20, 3)
    print(json.dumps(row), flush=True)
    return row, out


def main(argv=None):
    run_engine_strategy(parse_args(argv))


if __name__ == "__main__":
    main()
