"""Training launcher of the port: federated meta-training, one JSON
row per round (the LM launcher) or one summary row (the round engine).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2 \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --strategy reptile

The default ``--strategy tinyreptile`` is the JAX package's LM launcher
on its plain route: each round takes one client's ``LMClientStream``
batch, splits it into ``--k-inner`` microbatches, runs that many
streaming SGD steps (``online_sgd``) through the Mamba2 model (whose
SSD scan is the ``ssd_scan`` kernel), and interpolates phi toward the
result with the annealed alpha (``meta_update``). Its defaults are the
JAX launcher's (20 rounds, batch 8, seq 64, k-inner 4, beta 0.02, alpha
1, 64 clients, seed 0); ``--reduced`` runs the family's smoke config.
Only the SSM family is ported: ``--arch mamba2-130m`` (or the family
keyword ``mamba2``).

``--strategy reptile|fedavg|fedsgd|transfer|tifed`` runs
``run_federated`` with the JAX launcher's defaults (64 clients per round,
20 rounds, beta 0.02, support 32, 8 local epochs, one eval at the end)
on the sine MLP; ``tifed`` is TIFeD's integer-only training (each epoch
of the cohort one ``dfa_epoch_int8`` launch) with native int8 uplinks
billed at 1 byte a parameter. The fleet flags map onto the engine's
plugins as in the JAX launcher: ``--pool-size`` -> ``ClientPool``
(``--pool-sampler``, ``--pool-residency``), ``--participation`` or
``--availability diurnal|markov`` -> the sampling policy,
``--buffer-size`` -> ``BufferedAggregation``; incompatible combinations
are rejected at parse time with the JAX launcher's messages.
``--ckpt-dir`` snapshots the engine's whole round state every
``--ckpt-every`` rounds (a background writer, the JAX package's file
format) and ``--resume`` continues a preempted run bit for bit, also
past the horizon it was written under:

    PYTHONPATH=src python -m repro_torch.launch.train --strategy tifed \
        --ckpt-dir /path/to/ckpt --ckpt-every 5 --resume

Both routes run on the GPU; ``--device cpu`` runs the plain PyTorch
path on the CPU instead. The init is drawn from ``--seed`` with torch's
generator, which does not reproduce ``jax.random``'s init at the same
seed (``init_params=`` carries the JAX package's init in). The flags of
routes not ported yet (the other architectures, the engine's LM route
``--strategy ... --arch``, meshes, multi-process runs, and checkpoints
and resume on the LM launcher) are rejected at parse time.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import ALL_ARCHS

ENGINE_STRATEGIES = ("reptile", "fedavg", "fedsgd", "transfer", "tifed")
#: --arch family keywords -> the canonical config each names (as in the
#: JAX launcher)
ARCH_FAMILIES = {"transformer": "tinyllama-1.1b", "mamba2": "mamba2-130m",
                 "moe": "mixtral-8x22b"}
PORTED_ARCHS = ("mamba2-130m",)
#: flags not ported yet, by the slice that ports them
NOT_PORTED_FLAGS = {
    "--devices": "the multi-device slice", "--mesh": "the multi-device slice",
    "--coordinator": "the multi-device slice",
    "--num-processes": "the multi-device slice",
    "--process-id": "the multi-device slice"}
# eval protocol of the JAX launcher's sine route (tifed's ReLU net
# diverges at the tanh net's finetune rate: 0.005 there)
EVAL_KWARGS = dict(num_tasks=5, support=10, k_steps=16, lr=0.02, query=20)
TIFED_EVAL_LR = 0.005
SUPPORT = 32
EPOCHS = 8


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet ("
                     f"{NOT_PORTED_FLAGS[option_string]} ports it): the "
                     f"port's launcher runs one device (the tinyreptile LM "
                     f"launcher and --strategy {'|'.join(ENGINE_STRATEGIES)} "
                     f"on the sine MLP)")


def fraction_arg(s: str) -> float:
    """argparse type: a fraction in (0, 1]."""
    try:
        v = float(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a number, got {s!r}")
    if not 0.0 < v <= 1.0:
        raise argparse.ArgumentTypeError(
            f"must be a fraction in (0, 1], got {v}")
    return v


def positive_int_arg(s: str) -> int:
    try:
        v = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an integer, got {s!r}")
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated meta-training: TinyReptile rounds of an LM "
                    "(--arch), or the round engine on the sine MLP.")
    ap.add_argument("--strategy", default="tinyreptile",
                    choices=("tinyreptile",) + ENGINE_STRATEGIES)
    ap.add_argument("--arch", choices=list(ALL_ARCHS) + sorted(ARCH_FAMILIES),
                    help="LM architecture of the tinyreptile launcher "
                         "(ported: mamba2-130m, family keyword mamba2)")
    ap.add_argument("--reduced", action="store_true",
                    help="the family's smoke config (2 layers, d_model "
                         "256, fp32)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--k-inner", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--beta", type=float, default=0.02)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--pool-size", type=positive_int_arg, default=None,
                    help="size of the persistent client fleet (a "
                         "ClientPool: every client keeps its own data "
                         "stream across check-ins)")
    ap.add_argument("--pool-sampler", default="reference",
                    choices=("reference", "vectorized"),
                    help="client-identity sampler for --pool-size: "
                         "'reference' keeps one RNG per client on the "
                         "host; 'vectorized' derives each check-in from a "
                         "counter array (O(cohort) host work)")
    ap.add_argument("--pool-residency", default="device",
                    choices=("device", "host"),
                    help="where --pool-size per-client state lives: "
                         "'device' keeps the (N,) arrays on the card; "
                         "'host' keeps them in host slabs and stages each "
                         "block's cohort rows")
    ap.add_argument("--participation", type=fraction_arg, default=1.0,
                    help="fraction of the cohort that checks in each "
                         "round (a PartialParticipation schedule)")
    ap.add_argument("--availability", default="iid",
                    choices=("iid", "diurnal", "markov"),
                    help="structured check-in process over the fleet "
                         "(diurnal sine / two-state Markov); rounds where "
                         "nobody is available are idle")
    ap.add_argument("--buffer-size", type=positive_int_arg, default=None,
                    help="FedBuff-style async server: apply the buffered "
                         "client updates every K arrivals, "
                         "staleness-discounted")
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot directory: engine strategies snapshot "
                         "the whole round state (phi, pool state, rng, "
                         "bills) every --ckpt-every rounds on a "
                         "background thread and resume bit for bit with "
                         "--resume")
    ap.add_argument("--ckpt-every", type=positive_int_arg, default=None,
                    help="rounds between snapshots (default 10)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid snapshot in "
                         "--ckpt-dir (a fresh start when there is none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for flag, by in NOT_PORTED_FLAGS.items():
        ap.add_argument(flag, nargs="?", action=_NotPorted,
                        help=f"not ported yet ({by})")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and cross-validate before any tensor work."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume restores from --ckpt-dir; pass both")
    if args.availability != "iid" and args.participation < 1.0:
        ap.error("--availability replaces the i.i.d. --participation "
                 "schedule; pass one or the other")
    if args.strategy == "tinyreptile":
        for flag, v in (("--ckpt-dir", args.ckpt_dir),
                        ("--ckpt-every", args.ckpt_every),
                        ("--resume", args.resume or None)):
            if v is not None:
                ap.error(
                    f"{flag} is not ported yet on the LM launcher: its "
                    f"checkpoints come with its pool, availability and "
                    f"FedBuff flags (ROADMAP queue A item 6h); the JAX "
                    f"launcher's own resume of a bf16 model fails there "
                    f"(its bf16 leaves are saved as raw |V2 bits, which "
                    f"its restore refuses to cast). Pass an engine "
                    f"--strategy ({'|'.join(ENGINE_STRATEGIES)}) to "
                    f"checkpoint")
        if args.arch is None:
            ap.error("--arch is required for the tinyreptile LM launcher "
                     "(engine strategies --strategy "
                     f"{'|'.join(ENGINE_STRATEGIES)} default to the paper "
                     "sine workload instead)")
        # family keyword -> the canonical config it names
        args.arch = ARCH_FAMILIES.get(args.arch, args.arch)
        if args.arch not in PORTED_ARCHS:
            ap.error(f"--arch {args.arch} is not ported yet: the port's LM "
                     f"launcher runs {'|'.join(PORTED_ARCHS)} (--arch "
                     f"mamba2)")
        if args.participation < 1.0:
            ap.error("--participation is not ported yet on the LM "
                     "launcher (one client per round)")
        for flag, v in (("--pool-size", args.pool_size),
                        ("--buffer-size", args.buffer_size),
                        ("--availability",
                         None if args.availability == "iid" else 1)):
            if v is not None:
                ap.error(f"{flag} is not ported yet on the LM launcher "
                         f"(its fleet flags come after the LM family's "
                         f"engine route); pass an engine --strategy")
        for flag, v in (("--batch", args.batch), ("--seq", args.seq),
                        ("--k-inner", args.k_inner)):
            if v < 1:
                ap.error(f"{flag} must be >= 1, got {v}")
        if args.batch % args.k_inner:
            ap.error(f"--batch {args.batch} must split into --k-inner "
                     f"{args.k_inner} equal microbatches")
    elif args.strategy == "tifed" and (args.arch is not None
                                       or args.reduced):
        ap.error("--strategy tifed runs TIFeD integer-only training on "
                 "the paper's ReLU sine net; the LM families are fp32 — "
                 "drop --arch")
    elif args.arch is not None or args.reduced:
        ap.error(f"--strategy {args.strategy} with an LM (--arch/--reduced)"
                 f" is the engine LM route, which is not ported yet (it "
                 f"needs a client-batched LM); drop --arch/--reduced for "
                 f"the sine MLP, or run the tinyreptile LM launcher")
    if args.ckpt_every is None:
        args.ckpt_every = 10
    if args.rounds < 1:
        ap.error(f"--rounds must be >= 1, got {args.rounds}")
    if args.clients < 1:
        ap.error(f"--clients must be >= 1, got {args.clients}")
    if args.strategy == "transfer" and args.buffer_size:
        ap.error("--strategy transfer uplinks raw client batches "
                 "(uplink_ref='none'); the FedBuff buffer stages "
                 "phi-shaped updates and cannot hold them — drop "
                 "--buffer-size")
    if args.buffer_size and args.pool_size is None:
        ap.error("--buffer-size (FedBuff) needs persistent clients to "
                 "be stale against on the engine path: pass "
                 "--pool-size N too")
    if args.availability != "iid" and args.pool_size is None:
        ap.error("--availability needs a persistent fleet on the engine "
                 "path: pass --pool-size N")
    if args.pool_size is None and (args.pool_sampler != "reference"
                                   or args.pool_residency != "device"):
        ap.error("--pool-sampler/--pool-residency configure the "
                 "persistent fleet: pass --pool-size N")
    if args.pool_size is not None and args.pool_size < args.clients:
        ap.error(f"--pool-size {args.pool_size} cannot seat a cohort of "
                 f"--clients {args.clients} (identities are unique "
                 f"within a round)")
    return args


def run_engine_strategy(args, init_params=None):
    """One ``run_federated`` call as the JAX launcher's engine route
    makes it, the fleet flags mapped onto the engine's plugins; prints
    the summary row and returns ``(row, out)``, out being
    ``run_federated``'s result. ``init_params`` (a ``{leaf: array}``
    tree) replaces the seeded torch init — how a caller starts from the
    JAX package's init."""
    import functools

    import torch

    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core import (BufferedAggregation, ClientPool,
                                  CommChannel, DiurnalAvailability,
                                  MarkovAvailability, PartialParticipation,
                                  run_federated)
    from repro_torch.core.strategies import (FedAvgStrategy, FedSGDStrategy,
                                             ReptileStrategy, TifedStrategy,
                                             TransferStrategy)
    from repro_torch.data import SineTasks
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss,
                                               relu_mlp_loss)

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
        "tifed": lambda: TifedStrategy(relu_mlp_loss, epochs=EPOCHS),
    }[args.strategy]()
    tifed = args.strategy == "tifed"
    channel = CommChannel("int8", quantize=False) if tifed else CommChannel()
    eval_kwargs = dict(EVAL_KWARGS, lr=TIFED_EVAL_LR) if tifed \
        else EVAL_KWARGS
    dist = SineTasks()
    pool = (ClientPool(dist, args.pool_size, seed=args.seed,
                       sampler=args.pool_sampler,
                       residency=args.pool_residency)
            if args.pool_size else None)
    if args.availability == "diurnal":
        sampling = DiurnalAvailability(period=24, sampler=args.pool_sampler)
    elif args.availability == "markov":
        sampling = MarkovAvailability(sampler=args.pool_sampler)
    elif args.participation < 1.0:
        sampling = PartialParticipation(args.participation,
                                        sampler=args.pool_sampler)
    else:
        sampling = None
    buffered = (BufferedAggregation(args.buffer_size)
                if args.buffer_size else None)
    ops.reset_launch_counts()
    t0 = time.time()
    out = run_federated(
        init_params, dist, strategy, rounds=args.rounds,
        clients_per_round=args.clients, alpha=args.alpha, beta=args.beta,
        support=SUPPORT, seed=args.seed, eval_every=args.rounds,
        eval_kwargs=eval_kwargs, channel=channel, sampling=sampling,
        pool=pool, buffered=buffered, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, device=dev)
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


def run_lm(args, init_params=None):
    """The tinyreptile LM launcher's run, as the JAX launcher's plain
    route makes it: prints one row per round and a summary row, and
    returns ``(rows, summary, phi)``. ``init_params`` (the JAX package's
    ``Model.init`` tree, in its own layout, as NumPy or ``jax.Array``
    leaves) replaces the seeded torch init."""
    import numpy as np
    import torch

    from repro_torch.bridge import lm_params_from_jax
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import CommChannel, _consume, _stage
    from repro_torch.data import LMClientStream
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.schedules import linear_anneal
    from repro_torch.runtime.steps import (make_meta_train_step, microbatch,
                                           prefetch_batches)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if init_params is None:
        phi = model.init(torch.Generator().manual_seed(args.seed), dev)
    else:
        phi = lm_params_from_jax(init_params, model.scan_period, dev)
    clients = [LMClientStream(cfg.vocab_size, cid)
               for cid in range(args.clients)]
    alpha_sched = linear_anneal(args.alpha, args.rounds,
                                floor=args.alpha * 0.1)
    rng = np.random.default_rng(args.seed)
    round_bill = 2 * CommChannel().payload_bytes(phi)   # down + uplink
    step = make_meta_train_step(model, beta=args.beta, alpha=args.alpha)

    def make_round_batch(rnd):
        # one client per round, drawn on the prefetch thread strictly in
        # round order, so the seeded rng gives the synchronous sequence
        client = clients[int(rng.integers(len(clients)))]
        raw = microbatch(client.batch(rng, args.batch, args.seq),
                         args.k_inner)
        alpha_t = alpha_sched(rnd)                       # float32
        staged = _stage([raw["tokens"], raw["labels"],
                         np.array([alpha_t], np.float32)], dev)
        return rnd, client.zipf_a, float(alpha_t), staged

    ops.reset_launch_counts()
    t_start = time.time()
    rows = []
    for rnd, zipf_a, alpha_t, (tensors, event) in prefetch_batches(
            make_round_batch, args.rounds):
        t0 = time.time()
        _consume(tensors, event)
        tokens, labels, alpha_dev = tensors
        phi, metrics = step(phi, {"tokens": tokens, "labels": labels},
                            alpha_dev)
        loss, first, last = torch.stack(
            [metrics["loss"], metrics["inner_first"],
             metrics["inner_last"]]).tolist()          # one host read
        row = {"round": rnd, "client": zipf_a, "loss": loss,
               "inner_first": first, "inner_last": last, "alpha": alpha_t,
               "comm_mb": round((rnd + 1) * round_bill / 2 ** 20, 2),
               "dt_s": round(time.time() - t0, 3)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    summary = {"arch": cfg.name, "rounds": args.rounds,
               "tokens_per_round": args.batch * args.seq,
               "dt_s": round(time.time() - t_start, 3),
               "comm_mb": round(args.rounds * round_bill / 2 ** 20, 2),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "kernel_launches": ops.launch_counts()}
    print(json.dumps(summary), flush=True)
    return rows, summary, phi


def main(argv=None):
    args = parse_args(argv)
    if args.strategy == "tinyreptile":
        run_lm(args)
    else:
        run_engine_strategy(args)


if __name__ == "__main__":
    main()
