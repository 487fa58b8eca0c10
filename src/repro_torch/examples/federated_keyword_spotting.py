"""Keywords spotting (the paper's contributed TinyML dataset, §IV-A):
federated meta-learning of a 4-way keyword classifier across a simulated
heterogeneous IoT fleet, with the paper's resource accounting, on the
port.

    PYTHONPATH=src python -m repro_torch.examples.federated_keyword_spotting
    PYTHONPATH=src python -m repro_torch.examples.federated_keyword_spotting \\
        --rounds 20 --device cpu

    PYTHONPATH=src python -m repro_torch.examples.federated_keyword_spotting \\
        --pool-size 1000 --availability markov --buffer-size 4

It prints the Table-II memory model of the KWS net, the random init's
accuracy after adaptation, serial TinyReptile (the paper's Algorithm 1),
then an 8-slot fleet through ``run_federated`` with a
``PartialParticipation(0.5)`` schedule (each round half the fleet checks
in, trains and pays transport) and its per-client transport bill. With
``--pool-size`` / ``--availability`` / ``--buffer-size`` the fleet is a
persistent ``ClientPool`` instead (every device keeps its keyword task
and data stream across check-ins; check-ins follow a diurnal sine or a
two-state Markov process; aggregation optionally FedBuff-style async),
and the run prints each device's check-ins, staleness and bill. The init
is drawn with torch's generator from seed 0, not ``jax.random``'s. It
runs on the GPU; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.configs.paper_models import KWS_CONV
from repro_torch.core import (BufferedAggregation, ClientPool, CommChannel,
                              DiurnalAvailability, MarkovAvailability,
                              PartialParticipation, evaluate_init,
                              run_federated, tinyreptile_train)
from repro_torch.core.strategies import TinyReptileStrategy
from repro_torch.data import KWSTasks
from repro_torch.metering import algorithm_memory_report
from repro_torch.models.paper_nets import (init_paper_model,
                                           paper_model_accuracy,
                                           paper_model_loss, param_count)

LOSS = functools.partial(paper_model_loss, KWS_CONV)
ACC = functools.partial(paper_model_accuracy, KWS_CONV)
EVAL = dict(num_tasks=8, support=16, k_steps=8, lr=0.01, query=32,
            metric_fn=ACC)

COHORT = 8          # fleet slots per round
FRACTION = 0.5      # half the fleet checks in each round (default mode)


def positive_int(s):
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=positive_int, default=200)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--pool-size", type=positive_int, default=None,
                    help="run on a persistent ClientPool of this many "
                         "devices (default 16 when --availability or "
                         "--buffer-size imply a pool)")
    ap.add_argument("--availability", default="none",
                    choices=("none", "diurnal", "markov"),
                    help="check-in process over the pool: diurnal sine "
                         "or two-state Markov (implies a pool)")
    ap.add_argument("--buffer-size", type=positive_int, default=None,
                    help="FedBuff-style async aggregation: flush the "
                         "server buffer every K arrivals (implies a pool)")
    args = ap.parse_args(argv)
    args.pooled = (args.pool_size is not None or args.availability != "none"
                   or args.buffer_size is not None)
    if args.pooled and (args.pool_size or 16) < COHORT:
        ap.error(f"--pool-size must seat the {COHORT}-slot cohort")
    return args


def transport_table(out, params, rounds, label, staleness=None):
    """Paper Table-II style per-device bill (+ pooled identity state)."""
    round_bill = 2 * CommChannel().payload_bytes(params)  # down + up
    print(f"\ntransport accounting over {rounds} rounds "
          f"(fp32 wire, downlink + uplink, "
          f"{round_bill / 1024:.1f} KB per participated round):")
    header = f"  {'client':>8}  {'rounds':>7}  {'KB paid':>9}"
    if staleness is not None:
        header += f"  {'staleness':>10}  {'last seen':>10}"
    print(header)
    for c, paid in enumerate(out["per_client_bytes"]):
        line = f"  {c:>8}  {paid // round_bill:>7}  {paid / 1024:>9.1f}"
        if staleness is not None:
            line += (f"  {staleness['staleness'][c]:>10d}"
                     f"  {staleness['last_seen'][c]:>10d}")
        print(line)
    total = out["comm_bytes"]
    full = rounds * COHORT * round_bill
    print(f"  {'total':>8}  {total // round_bill:>7}  {total / 1024:>9.1f}"
          f"   ({total / full:.0%} of a full-participation fleet)  "
          f"[{label}]")


def main(argv=None) -> dict:
    """Run the example; returns ``{"memory", "random_init", "tinyreptile",
    "fleet"}``: the Table-II dict, the random init's eval row and the two
    runs' ``run_federated`` outputs."""
    args = parse_args(argv)
    params = init_paper_model(KWS_CONV, torch.Generator().manual_seed(0),
                              args.device)
    print(f"model: {KWS_CONV.name}, params = {param_count(params)}, "
          f"device = {args.device}")
    dist = KWSTasks()
    every = max(args.rounds // 2, 1)

    mem = algorithm_memory_report(KWS_CONV, support=16)
    print(f"memory model (Table II analogue): Reptile "
          f"{mem['reptile_bytes']/1024:.1f} KB vs TinyReptile "
          f"{mem['tinyreptile_bytes']/1024:.1f} KB "
          f"({mem['reduction_factor']:.1f}x reduction)")

    base = evaluate_init(LOSS, params, dist, np.random.default_rng(3), **EVAL)
    print(f"random init accuracy: {base['query_metric']:.2%} (chance 25%)")

    # --- serial TinyReptile (the paper's Algorithm 1 schema) ------------
    t0 = time.time()
    tiny = tinyreptile_train(LOSS, params, dist, rounds=args.rounds,
                             alpha=1.0, beta=0.01, support=16,
                             eval_every=every, eval_kwargs=EVAL, seed=1,
                             device=args.device)
    t_tiny = time.time() - t0
    for ev in tiny["history"]:
        print(f"  TinyReptile round {ev['round']:4d}: "
              f"acc {ev['query_metric']:.2%}  loss {ev['query_loss']:.3f}")
    print(f"TinyReptile serial final acc: "
          f"{tiny['history'][-1]['query_metric']:.2%} ({t_tiny:.1f}s, "
          f"{tiny['comm_bytes']/1024:.0f} KB total transport)")

    # --- the fleet through the round engine -----------------------------
    if args.pooled:
        fleet = persistent_fleet(args, params, dist, every)
        return {"memory": mem, "random_init": base, "tinyreptile": tiny,
                "fleet": fleet}
    policy = PartialParticipation(FRACTION)
    t0 = time.time()
    fleet = run_federated(params, dist, TinyReptileStrategy(LOSS),
                          rounds=args.rounds, clients_per_round=COHORT,
                          alpha=1.0, beta=0.01, support=16, seed=1,
                          eval_every=every, eval_kwargs=EVAL,
                          sampling=policy, device=args.device)
    t_fleet = time.time() - t0
    for ev in fleet["history"]:
        print(f"  fleet round {ev['round']:4d}: "
              f"acc {ev['query_metric']:.2%}  loss {ev['query_loss']:.3f}")
    print(f"partial-participation fleet ({COHORT} slots, "
          f"{policy.cohort(COHORT)}/round check in) final acc: "
          f"{fleet['history'][-1]['query_metric']:.2%} ({t_fleet:.1f}s)")
    transport_table(fleet, params, args.rounds,
                    f"anonymous cohort, {FRACTION:.0%} participation")
    return {"memory": mem, "random_init": base, "tinyreptile": tiny,
            "fleet": fleet}


def persistent_fleet(args, params, dist, every) -> dict:
    """The fleet as a persistent ``ClientPool``; prints its history, the
    final check-in count, flushes and pending updates, and the transport
    table with staleness; returns ``run_federated``'s output."""
    pool_size = args.pool_size or 16
    pool = ClientPool(dist, pool_size, seed=1)
    policy = {"none": None,
              "diurnal": DiurnalAvailability(period=24),
              "markov": MarkovAvailability()}[args.availability]
    buffered = (BufferedAggregation(args.buffer_size)
                if args.buffer_size else None)
    label = (f"pool of {pool_size}, {args.availability} check-ins"
             + (f", FedBuff K={args.buffer_size}" if buffered else ""))
    print(f"\npersistent fleet: {label}")
    t0 = time.time()
    fleet = run_federated(params, dist, TinyReptileStrategy(LOSS),
                          rounds=args.rounds, clients_per_round=COHORT,
                          alpha=1.0, beta=0.01, support=16, seed=1,
                          eval_every=every, eval_kwargs=EVAL,
                          sampling=policy, pool=pool, buffered=buffered,
                          device=args.device)
    t_fleet = time.time() - t0
    for ev in fleet["history"]:
        print(f"  fleet round {ev['round']:4d}: "
              f"acc {ev['query_metric']:.2%}  loss {ev['query_loss']:.3f}")
    ps = fleet["pool_state"]
    idle = int((ps["checkins"] == 0).sum())
    print(f"persistent fleet final acc: "
          f"{fleet['history'][-1]['query_metric']:.2%} ({t_fleet:.1f}s; "
          f"{int(ps['checkins'].sum())} check-ins, "
          f"{idle}/{pool_size} devices never checked in"
          + (f"; {ps['flushes']} buffer flushes, "
             f"{ps['buffered_pending']} updates still pending"
             if buffered else "") + ")")
    transport_table(fleet, params, args.rounds, label, staleness=ps)
    return fleet


if __name__ == "__main__":
    main()
