"""Training launcher of the port: federated meta-training, one JSON
row per round (the LM launcher) or one summary row (the round engine).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2 \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --strategy reptile
    PYTHONPATH=src python -m repro_torch.launch.train --strategy reptile \
        --arch mamba2 --device cpu

The default ``--strategy tinyreptile`` is the JAX package's LM launcher
on its plain route: each round takes one client's ``LMClientStream``
batch, splits it into ``--k-inner`` microbatches, runs that many
streaming SGD steps (``online_sgd``) through the LM, and interpolates
phi toward the result with the annealed alpha (``meta_update``). Its
defaults are the JAX launcher's (20 rounds, batch 8, seq 64, k-inner 4,
beta 0.02, alpha 1, 64 clients, seed 0); ``--reduced`` runs the
family's smoke config. Ported: the SSM family (``--arch mamba2-130m``,
family keyword ``mamba2``; its SSD scan is the ``ssd_scan`` kernel), the
dense family (``--arch tinyllama-1.1b``, ``starcoder2-15b``,
``glm4-9b`` or ``minicpm-2b``, family keyword ``transformer``), the MoE
family (``--arch mixtral-8x22b`` or ``llama4-maverick-400b-a17b``,
family keyword ``moe``), the hybrid ``--arch zamba2-1.2b``, the
encoder-decoder ``--arch whisper-tiny`` and the VLM ``--arch
paligemma-3b``. As in the JAX launcher, each round's batch also carries
random float32 ``frames`` (batch, encoder_tokens, d_model) for
whisper-tiny and ``patch_embeds`` (batch, frontend_tokens, d_model) for
paligemma-3b, whose sequence is then ``--seq`` + frontend_tokens long
(the loss over the text). A full-width MoE tree mixes dtypes (the fp32
router in a bf16 model): the inner loop's per-dtype groups take it.

The JAX LM launcher's fleet and checkpoint flags apply as they do there:
``--pool-size N`` is a persistent fleet of N ``LMClientStream``s, client
i seeded by i (a client's stream is built when it is drawn: the JAX
launcher builds all N up front, two vocab-sized arrays a client, some
80 GB of host memory at 100,000 clients of mamba2-130m's vocabulary;
the draws are the same); ``--participation f`` thins each round's check-ins i.i.d.
and ``--availability diurnal|markov`` draws them from a diurnal or
Markov process over the whole run, troughs leaving a round idle (a row
``{"round", "idle": true, "alpha"}``, nothing trained or billed); the
round's client is drawn among those checked in. ``--buffer-size K``
splits the round: the client's streaming SGD runs at once and its delta
(phi_hat - phi, in each leaf's dtype) is buffered; every K deltas the
buffer flushes, staleness-weighted by ``default_staleness_weight`` and
normalised, as one Reptile step (``meta_update``), also before every
snapshot and at the end of the run; rows carry ``buffered`` and
``flushes``. ``--ckpt-dir`` writes phi with ``save_checkpoint`` every
``--ckpt-every`` rounds and at the end, each leaf in its dtype (bf16 as
its raw ``|V2`` bits); ``--resume`` restores phi and the round from the
newest snapshot. As in the JAX launcher, a resumed run draws its host RNG
anew from ``--seed``: it equals the JAX launcher's resumed run, not the
run that was never interrupted, and bills the rounds before the resume
that were not idle. The JAX launcher cannot restore a bf16 snapshot (it
refuses to cast its own ``|V2`` leaves); the port restores them bit for
bit. An fp32 snapshot of a reduced config (one dict per layer in both
packages) resumes in either package.

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
``--arch transformer|mamba2|moe`` on an engine strategy swaps the sine
MLP for next-token personalization of the family's reduced config
(tinyllama-1.1b, mamba2-130m or mixtral-8x22b ``.reduced()``, fp32; the
engine also takes the families' trees in their own dtypes, one flat
buffer per dtype group, when ``init_params`` carries them) over
heterogeneous LM clients (``data.LmTaskDistribution``, support = ``--batch``
sequences of ``--seq`` tokens, ``data.lm_loss``), as the JAX launcher's
engine route does; every fleet and checkpoint flag applies to it too.
``--ckpt-dir`` snapshots the engine's whole round state every
``--ckpt-every`` rounds (a background writer, the JAX package's file
format) and ``--resume`` continues a preempted run bit for bit, also
past the horizon it was written under:

    PYTHONPATH=src python -m repro_torch.launch.train --strategy tifed \
        --ckpt-dir /path/to/ckpt --ckpt-every 5 --resume

Both routes run on the GPU; ``--device cpu`` runs the plain PyTorch
path on the CPU instead. The init is drawn from ``--seed`` with torch's
generator, which does not reproduce ``jax.random``'s init at the same
seed (``init_params=`` carries the JAX package's init in).

Across ranks, one process a rank (``runtime/sharding.py``), with the
JAX launcher's flags and parse checks. ``--devices N`` or ``--mesh
clients:K`` on an engine strategy splits each round's cohort over N (K)
ranks, ``run_federated(mesh=N)``; ``--mesh data --devices N`` splits
each microbatch of the LM launcher's round over N ranks (the cohort
step, ``make_meta_train_step(mesh=)``), and ``--mesh pod --devices N``
makes each rank one pod client (``core/federated.py``). The launcher
starts those N local ranks itself (spawned, each joining a process
group through a file store), each on card ``rank % cards``: NCCL where
every rank has a card of its own, gloo over the CUDA tensors where ranks
share one, gloo on the CPU with ``--device cpu``. ``--num-processes N
--coordinator host:port --process-id i`` is the cross-host form: the
user starts every rank, each with its own ``--process-id``, and the
client mesh spans the N processes. Rank 0 alone prints the rows and
writes the snapshots; its summary row carries ``"mesh"`` when
``--mesh clients:K[,model:M]`` sized it, as the JAX launcher's does.
``--mesh clients:K,model:M`` runs K x M ranks on the 2-D mesh
(``client_model_mesh``): the cohort over K, phi's leaves split over M
by the family's registered partitioner (``partitioner_for(--arch)``,
the default rules for the sine MLP); ``--strategy tifed`` is refused
there, as by the JAX launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --strategy reptile \
        --devices 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2 \
        --reduced --mesh pod --devices 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --strategy reptile \
        --arch transformer --mesh clients:2,model:2 --device cpu
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
# eval protocol of the JAX launcher's sine route (tifed's ReLU net
# diverges at the tanh net's finetune rate: 0.005 there)
EVAL_KWARGS = dict(num_tasks=5, support=10, k_steps=16, lr=0.02, query=20)
TIFED_EVAL_LR = 0.005
SUPPORT = 32
EPOCHS = 8
# eval protocol of the JAX launcher's engine LM route
LM_EVAL_KWARGS = dict(num_tasks=2, support=4, k_steps=4, lr=0.01, query=8)


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


def mesh_arg(s: str):
    """argparse type for --mesh: the LM launcher's keywords
    ('none'|'data'|'pod') pass through; an engine mesh spec
    'clients:K[,model:M]' parses to a {'clients': K[, 'model': M]} dict,
    rejected at parse time when malformed."""
    if s in ("none", "data", "pod"):
        return s
    spec = {}
    for part in s.split(","):
        name, sep, extent = part.partition(":")
        if not sep or name not in ("clients", "model") or name in spec:
            raise argparse.ArgumentTypeError(
                f"expected 'none', 'data', 'pod', or "
                f"'clients:K[,model:M]', got {s!r}")
        try:
            v = int(extent)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"mesh axis extent must be an integer, got {extent!r}")
        if v < 1:
            raise argparse.ArgumentTypeError(
                f"mesh axis extent must be >= 1, got {v}")
        spec[name] = v
    if "clients" not in spec:
        raise argparse.ArgumentTypeError(
            f"an engine mesh spec needs a clients axis: "
            f"'clients:K[,model:M]', got {s!r}")
    return spec


def _visible_cards(device: str) -> int:
    """Ranks of a --mesh data|pod run without --devices: the visible
    cards (at least 1), one on the CPU."""
    if device == "cpu":
        return 1
    import torch
    return max(torch.cuda.device_count(), 1)


def _prints() -> bool:
    """Whether this process prints the rows: rank 0, or a run without a
    process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated meta-training: TinyReptile rounds of an LM "
                    "(--arch), or the round engine on the sine MLP.")
    ap.add_argument("--strategy", default="tinyreptile",
                    choices=("tinyreptile",) + ENGINE_STRATEGIES)
    ap.add_argument("--arch", choices=list(ALL_ARCHS) + sorted(ARCH_FAMILIES),
                    help="LM architecture of the tinyreptile launcher "
                         "(family keywords mamba2, transformer, moe); with "
                         "an engine --strategy, the family keyword "
                         "mamba2|transformer|moe meta-trains that "
                         "family's reduced config instead of the sine "
                         "MLP")
    ap.add_argument("--reduced", action="store_true",
                    help="the family's smoke config (2 layers, d_model "
                         "256, fp32); the engine route always reduces")
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
                         "--resume; the LM launcher snapshots phi")
    ap.add_argument("--ckpt-every", type=positive_int_arg, default=None,
                    help="rounds between snapshots (default 10)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid snapshot in "
                         "--ckpt-dir (a fresh start when there is none)")
    ap.add_argument("--devices", type=positive_int_arg, default=None,
                    help="ranks to run, one process each, started by the "
                         "launcher: with an engine --strategy the client "
                         "mesh's size; with --mesh data|pod the LM "
                         "launcher's (default there: the visible cards, "
                         "1 on the CPU)")
    ap.add_argument("--mesh", default="none", type=mesh_arg,
                    help="split the round across ranks: 'data' runs the "
                         "cohort step on a 1-D data mesh (each rank its "
                         "rows of every microbatch, the gradient "
                         "all-reduced); 'pod' makes each rank one pod "
                         "client (core/federated.py: inner SGD per pod, "
                         "one all-reduce across pods a round); "
                         "'clients:K' runs an engine strategy on a 1-D "
                         "client mesh of K ranks; 'none' (default) one "
                         "rank")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store for a run whose "
                         "ranks the user starts; required with "
                         "--num-processes > 1 (every process passes the "
                         "same address) and meaningless without it")
    ap.add_argument("--num-processes", type=positive_int_arg, default=1,
                    help="ranks of a run whose processes the user starts "
                         "(one a rank, across hosts too); the client mesh "
                         "then spans them")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's rank in [0, --num-processes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and cross-validate before any tensor work."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not args.coordinator:
        ap.error("--num-processes > 1 is a cross-host run; pass the "
                 "shared --coordinator host:port")
    if args.coordinator and args.num_processes == 1:
        ap.error("--coordinator only applies with --num-processes > 1")
    if not 0 <= args.process_id < args.num_processes:
        ap.error(f"--process-id {args.process_id} out of range for "
                 f"--num-processes {args.num_processes}")
    if args.num_processes > 1 and args.strategy not in ENGINE_STRATEGIES:
        ap.error("multi-process runs drive the round engine; pass an "
                 f"engine --strategy ({'|'.join(ENGINE_STRATEGIES)})")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume restores from --ckpt-dir; pass both")
    if args.availability != "iid" and args.participation < 1.0:
        ap.error("--availability replaces the i.i.d. --participation "
                 "schedule; pass one or the other")
    if args.mesh == "pod" and args.buffer_size:
        ap.error("--mesh pod runs the fused pod-client round; FedBuff "
                 "buffering (--buffer-size) needs the split inner/flush "
                 "step — pass one or the other")
    if args.strategy == "tinyreptile":
        if args.arch is None:
            ap.error("--arch is required for the tinyreptile LM launcher "
                     "(engine strategies --strategy "
                     f"{'|'.join(ENGINE_STRATEGIES)} default to the paper "
                     "sine workload instead)")
        if isinstance(args.mesh, dict):
            ap.error("--mesh clients:K[,model:M] drives the round "
                     "engine; pass an engine --strategy "
                     f"({'|'.join(ENGINE_STRATEGIES)})")
        if args.devices is not None and args.mesh == "none":
            ap.error("--devices only applies with --mesh data|pod (or "
                     "with an engine --strategy, where it sizes the "
                     "client mesh)")
        # family keyword -> the canonical config it names
        args.arch = ARCH_FAMILIES.get(args.arch, args.arch)
        for flag, v in (("--batch", args.batch), ("--seq", args.seq),
                        ("--k-inner", args.k_inner)):
            if v < 1:
                ap.error(f"{flag} must be >= 1, got {v}")
        if args.batch % args.k_inner:
            ap.error(f"--batch {args.batch} must split into --k-inner "
                     f"{args.k_inner} equal microbatches")
        args.ranks = 1
        if args.mesh != "none":
            args.ranks = args.devices or _visible_cards(args.device)
            mb = args.batch // args.k_inner
            if mb % args.ranks:
                ap.error(f"--mesh {args.mesh}: the per-step microbatch "
                         f"({mb} = --batch/--k-inner) must divide over "
                         f"{args.ranks} devices")
    elif args.arch is not None:
        if args.arch not in ARCH_FAMILIES:
            ap.error(f"--strategy {args.strategy} meta-trains a reduced LM "
                     f"family (--arch {'|'.join(sorted(ARCH_FAMILIES))}) or, "
                     f"without --arch, the paper sine MLP; the canonical "
                     f"config {args.arch!r} runs the tinyreptile LM "
                     f"launcher")
        if args.strategy == "tifed":
            ap.error("--strategy tifed runs TIFeD integer-only training on "
                     "the paper's ReLU sine net; the LM families are fp32 "
                     "— drop --arch")
        for flag, v in (("--batch", args.batch), ("--seq", args.seq)):
            if v < 1:
                ap.error(f"{flag} must be >= 1, got {v}")
    if args.strategy != "tinyreptile":
        if args.mesh in ("data", "pod"):
            ap.error(f"--strategy {args.strategy} shards the client axis "
                     f"via --devices N or --mesh clients:K[,model:M]; "
                     f"--mesh data|pod belongs to the LM launcher")
        args.ranks = args.devices or 1
        if isinstance(args.mesh, dict):
            spec = ",".join(f"{k}:{v}" for k, v in args.mesh.items())
            if args.devices is not None:
                ap.error(f"--mesh {spec} already sizes the client mesh; "
                         f"drop --devices")
            if "model" in args.mesh and args.strategy == "tifed":
                ap.error("--strategy tifed uplinks NATIVE int8 trees whose "
                         "quantization grids need each parameter tensor "
                         "whole on every device; a model-sharded mesh "
                         "splits them — use --mesh clients:K (no model "
                         "axis)")
            # one process a rank: K x M of them on the 2-D mesh
            args.ranks = args.mesh["clients"] * args.mesh.get("model", 1)
        if args.num_processes > 1:
            if args.devices is not None or isinstance(args.mesh, dict):
                if args.ranks != args.num_processes:
                    ap.error(f"--num-processes {args.num_processes}: the "
                             f"port runs one process a rank, so the client "
                             f"mesh is those {args.num_processes} ranks "
                             f"(got a mesh of {args.ranks})")
            args.ranks = args.num_processes
    if args.ckpt_every is None:
        args.ckpt_every = 10
    if args.rounds < 1:
        ap.error(f"--rounds must be >= 1, got {args.rounds}")
    if args.clients < 1:
        ap.error(f"--clients must be >= 1, got {args.clients}")
    if args.strategy == "tinyreptile":
        # the JAX launcher checks the fleet flags below on the engine
        # path only: the LM launcher's fleet is --pool-size or --clients
        return args
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
    ``run_federated``'s result. ``init_params`` replaces the seeded
    torch init — how a caller starts from the JAX package's init: the
    sine MLP's ``{leaf: array}`` tree, or with ``--arch`` the reduced
    LM's nested tree (the JAX init through
    ``bridge.lm_params_from_jax``; the reduced configs keep one dict per
    layer in both packages)."""
    import functools

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core import (BufferedAggregation, ClientPool,
                                  CommChannel, DiurnalAvailability,
                                  MarkovAvailability, PartialParticipation,
                                  run_federated)
    from repro_torch.core.strategies import (FedAvgStrategy, FedSGDStrategy,
                                             ReptileStrategy, TifedStrategy,
                                             TransferStrategy)
    from repro_torch.data import LmTaskDistribution, SineTasks, lm_loss
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss,
                                               relu_mlp_loss)
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.sharding import (client_model_mesh,
                                              partitioner_for)

    dev = resolve_device(args.device)
    tifed = args.strategy == "tifed"
    if args.arch is not None:
        # the family keyword -> its canonical config, reduced: the engine
        # trains every cohort client every round
        model = build_model(get_arch(ARCH_FAMILIES[args.arch]).reduced())
        loss = lm_loss(model)
        dist = LmTaskDistribution(model.cfg.vocab_size, args.seq)
        support, eval_kwargs = args.batch, LM_EVAL_KWARGS
        if init_params is None:
            init_params = model.init(
                torch.Generator().manual_seed(args.seed), dev)
    else:
        loss = functools.partial(paper_model_loss, SINE_MLP)
        dist = SineTasks()
        support = SUPPORT
        eval_kwargs = dict(EVAL_KWARGS, lr=TIFED_EVAL_LR) if tifed \
            else EVAL_KWARGS
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
    channel = CommChannel("int8", quantize=False) if tifed else CommChannel()
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
    # the client mesh: the process group's ranks (one rank without one);
    # with a model axis the 2-D mesh, phi split by the family's rules (the
    # sine MLP takes the default ones)
    mesh = (args.ranks if args.ranks > 1 or args.devices
            or isinstance(args.mesh, dict) else None)
    partitioner = None
    if isinstance(args.mesh, dict) and "model" in args.mesh:
        mesh = client_model_mesh(args.mesh["clients"], args.mesh["model"],
                                 dev)
        partitioner = partitioner_for(args.arch or "default")
    ops.reset_launch_counts()
    t0 = time.time()
    out = run_federated(
        init_params, dist, strategy, rounds=args.rounds,
        clients_per_round=args.clients, alpha=args.alpha, beta=args.beta,
        support=support, seed=args.seed, eval_every=args.rounds,
        eval_kwargs=eval_kwargs, channel=channel, sampling=sampling,
        pool=pool, buffered=buffered, mesh=mesh, partitioner=partitioner,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    row = {"strategy": args.strategy, "rounds": args.rounds,
           "clients": args.clients, "dt_s": round(time.time() - t0, 3),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "kernel_launches": ops.launch_counts()}
    if args.arch is not None:
        row["arch"] = args.arch
    if isinstance(args.mesh, dict):
        row["mesh"] = ",".join(f"{k}:{v}" for k, v in args.mesh.items())
    if out["history"]:
        row["query_loss"] = round(float(out["history"][-1]["query_loss"]),
                                  4)
    if "comm_bytes" in out:
        row["comm_mb"] = round(out["comm_bytes"] / 2 ** 20, 3)
    if _prints():
        print(json.dumps(row), flush=True)
    return row, out


def frontend_inputs(cfg, rng, batch: int):
    """The random frontend embeddings the JAX LM launcher draws after a
    round's tokens, from the same NumPy ``rng`` and in its order, as
    float32: ``patch_embeds`` (batch, frontend_tokens, d_model) for a
    vision frontend, then ``frames`` (batch, encoder_tokens, d_model) for
    the audio family; none for the other families."""
    import numpy as np
    out = {}
    if cfg.frontend == "vision":
        out["patch_embeds"] = np.asarray(rng.normal(size=(
            batch, cfg.frontend_tokens, cfg.d_model)), np.float32)
    if cfg.family == "audio":
        out["frames"] = np.asarray(rng.normal(size=(
            batch, cfg.encoder_tokens, cfg.d_model)), np.float32)
    return out


def fedbuff_flush(phi, buffer, flush_rnd: int, alpha_t: float):
    """The LM launcher's FedBuff flush, as the JAX launcher computes it:
    the buffered ``(round, {path: delta})`` pairs weighted by
    ``default_staleness_weight(flush_rnd - round)`` (fp32 on the host) and
    normalised, their weighted sum per leaf in fp32 in the JAX launcher's
    Python order (``0 + w0 d0 + w1 d1 ...``, each op rounded on its own,
    a bf16 delta widened to fp32 first, as JAX promotes it), phi plus that
    mean in fp32, then the Reptile interpolation toward it
    (``tree_meta_update``: one ``meta_update`` launch per dtype group, a
    bf16 group reading the fp32 target unrounded)."""
    import numpy as np
    import torch

    from repro_torch.bridge import flatten_tree, unflatten_tree
    from repro_torch.core.pool import default_staleness_weight
    from repro_torch.kernels.ops import tree_meta_update

    taus = torch.tensor([float(flush_rnd - r) for r, _ in buffer],
                        dtype=torch.float32)
    ws = default_staleness_weight(taus).numpy()
    total = np.float32(0.0)
    for w in ws:                  # the host sum, in order
        total = np.float32(total + w)
    ws = [float(np.float32(w / total)) for w in ws]
    deltas = [d for _, d in buffer]
    target = {}
    for path, p in flatten_tree(phi).items():
        acc = 0
        for w, d in zip(ws, deltas):
            acc = acc + d[path].float() * w
        target[path] = p.float() + acc
    return tree_meta_update(phi, unflatten_tree(target), alpha_t)


def run_lm(args, init_params=None):
    """The tinyreptile LM launcher's run, as the JAX launcher's plain
    route makes it: prints one row per round (an idle one for a round
    nobody checked in) and a summary row, and returns ``(rows, summary,
    phi)``. ``init_params`` replaces the seeded torch init: the JAX
    package's ``Model.init`` tree (its own layout, NumPy or ``jax.Array``
    leaves), carried over by ``bridge.lm_params_from_jax``, or the port's
    own tree (``torch.Tensor`` leaves on the run's device), taken as
    given; ``--resume`` then restores over it, as the JAX launcher
    restores over its init."""
    import numpy as np
    import torch

    from repro_torch.bridge import (flatten_tree, lm_params_from_jax,
                                    tree_leaves)
    from repro_torch.checkpoint.ckpt import (map_leaves, restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import CommChannel, _consume, _stage
    from repro_torch.core.engine import streaming_sgd
    from repro_torch.core.pipeline import PartialParticipation
    from repro_torch.core.pool import DiurnalAvailability, MarkovAvailability
    from repro_torch.data import LMClientStream
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.schedules import linear_anneal
    from repro_torch.runtime.sharding import make_mesh
    from repro_torch.runtime.steps import (data_mesh_sgd,
                                           make_meta_train_step, microbatch,
                                           prefetch_batches)

    dev = resolve_device(args.device)
    # --mesh data|pod: the process group's ranks (one without a group)
    mesh = None
    if args.mesh == "data":
        mesh = make_mesh((args.ranks,), ("data",), dev)
    elif args.mesh == "pod":
        mesh = make_mesh((args.ranks, 1), ("pod", "data"), dev)
    prints = _prints()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if init_params is None:
        phi = model.init(torch.Generator().manual_seed(args.seed), dev)
    elif all(isinstance(t, torch.Tensor)
             for _, t in tree_leaves(init_params)):
        phi = init_params
    else:
        phi = lm_params_from_jax(init_params, model.jax_layout, dev)
    start_round = 0
    if args.resume:
        try:
            saved, start_round, _ = restore_checkpoint(args.ckpt_dir, phi)
            phi = map_leaves(lambda a: torch.as_tensor(a).to(dev), saved)
            print(f"resumed from round {start_round}", flush=True)
        except FileNotFoundError:
            pass
    fleet = args.pool_size or args.clients
    alpha_sched = linear_anneal(args.alpha, args.rounds,
                                floor=args.alpha * 0.1)
    rng = np.random.default_rng(args.seed)
    # check-ins over the fleet, drawn from the rng before any round's
    # data, as the JAX launcher draws them; a resume bills the rounds
    # before it that were not idle
    checkin = None
    billed_rounds = start_round
    if args.availability != "iid":
        proc = (DiurnalAvailability(period=24)
                if args.availability == "diurnal" else MarkovAvailability())
        full = np.asarray(proc.availability(rng, 0, args.rounds, fleet),
                          bool)
        billed_rounds = int(full[:start_round].any(axis=1).sum())
        checkin = full[start_round:]
    elif args.participation < 1.0:
        checkin = PartialParticipation(args.participation).plan_schedule(
            rng, start_round, args.rounds, fleet,
            args.k_inner)["participation"]
    round_bill = 2 * CommChannel().payload_bytes(phi)   # down + uplink
    if args.mesh == "pod":
        from repro_torch.core.federated import make_pod_client_meta_step
        step = make_pod_client_meta_step(model, mesh, beta=args.beta,
                                         alpha=args.alpha)
    else:
        step = make_meta_train_step(model, beta=args.beta, alpha=args.alpha,
                                    mesh=mesh)
    buffer = []                   # (round, delta) pairs awaiting a flush
    flushes = 0

    def make_round_batch(i):
        # one client per round, drawn on the prefetch thread strictly in
        # round order, so the seeded rng gives the synchronous sequence;
        # then the frontend's random embeddings, in the JAX launcher's
        # order
        rnd = start_round + i
        alpha_t = alpha_sched(rnd)                       # float32
        if checkin is None:
            cid = int(rng.integers(fleet))
        else:
            avail = np.flatnonzero(checkin[i])
            if len(avail) == 0:                          # nobody: idle
                return rnd, None, float(alpha_t), None, None
            cid = int(avail[rng.integers(len(avail))])
        client = LMClientStream(cfg.vocab_size, cid)
        raw = client.batch(rng, args.batch, args.seq)
        raw.update(frontend_inputs(cfg, rng, args.batch))
        raw = microbatch(raw, args.k_inner)
        staged = _stage(list(raw.values())
                        + [np.array([alpha_t], np.float32)], dev)
        return rnd, client.zipf_a, float(alpha_t), list(raw), staged

    ops.reset_launch_counts()
    t_start = time.time()
    rows = []
    batches = prefetch_batches(make_round_batch, args.rounds - start_round)
    try:
        for rnd, zipf_a, alpha_t, names, staged in batches:
            t0 = time.time()
            if names is None:
                row = {"round": rnd, "idle": True, "alpha": alpha_t}
                if prints:
                    print(json.dumps(row), flush=True)
                rows.append(row)
                continue
            tensors, event = staged
            _consume(tensors, event)
            batch = dict(zip(names, tensors[:-1]))
            if args.buffer_size:
                if mesh is None:
                    phi_hat, losses = streaming_sgd(model.loss_fn, phi,
                                                    batch, args.beta)
                else:                         # --mesh data: this rank's rows
                    phi_hat, losses = data_mesh_sgd(model, phi, batch,
                                                    args.beta, mesh)
                hat = flatten_tree(phi_hat)
                buffer.append((rnd, {k: hat[k] - p for k, p in
                                     flatten_tree(phi).items()}))
                del phi_hat, hat
                metrics = {"loss": losses.mean(), "inner_first": losses[0],
                           "inner_last": losses[-1]}
                if len(buffer) >= args.buffer_size:
                    phi = fedbuff_flush(phi, buffer, rnd, alpha_t)
                    buffer.clear()
                    flushes += 1
            else:
                phi, metrics = step(phi, batch, tensors[-1])
            loss, first, last = torch.stack(
                [metrics["loss"], metrics["inner_first"],
                 metrics["inner_last"]]).tolist()          # one host read
            billed_rounds += 1
            row = {"round": rnd, "client": zipf_a, "loss": loss,
                   "inner_first": first, "inner_last": last, "alpha": alpha_t,
                   "comm_mb": round(billed_rounds * round_bill / 2 ** 20, 2),
                   "dt_s": round(time.time() - t0, 3)}
            if args.buffer_size:
                row["buffered"] = len(buffer)
                row["flushes"] = flushes
            if prints:
                print(json.dumps(row), flush=True)
            rows.append(row)
            if args.ckpt_dir and (rnd + 1) % args.ckpt_every == 0:
                if buffer:                       # a snapshot sees every update
                    phi = fedbuff_flush(phi, buffer, rnd, alpha_t)
                    buffer.clear()
                    flushes += 1
                if prints:                       # rank 0 writes
                    save_checkpoint(args.ckpt_dir, phi, rnd + 1,
                                    extra={"arch": args.arch})
    finally:
        batches.close()      # stops the producer if a round raised
    if buffer:                               # drain the pending tail
        last = buffer[-1][0]
        phi = fedbuff_flush(phi, buffer, last, float(alpha_sched(last)))
        buffer.clear()
        flushes += 1
    if args.ckpt_dir and prints:
        save_checkpoint(args.ckpt_dir, phi, args.rounds,
                        extra={"arch": args.arch})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    summary = {"arch": cfg.name, "rounds": args.rounds,
               "tokens_per_round": args.batch * args.seq,
               "dt_s": round(time.time() - t_start, 3),
               "comm_mb": round(billed_rounds * round_bill / 2 ** 20, 2),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "kernel_launches": ops.launch_counts()}
    if args.buffer_size:
        summary["flushes"] = flushes
    if mesh is not None:
        summary["mesh"] = args.mesh
    if prints:
        print(json.dumps(summary), flush=True)
    return rows, summary, phi


def run(args):
    """The route ``args`` name, in this process."""
    if args.strategy == "tinyreptile":
        run_lm(args)
    else:
        run_engine_strategy(args)


def _rank_run(rank, argv):
    """One rank of the ranks the launcher started: its process group is
    up."""
    del rank
    run(parse_args(argv))


def main(argv=None):
    """Parse, then run: in this process; or, for ``--num-processes N``,
    as rank ``--process-id`` of the N ranks the user starts; or, for
    more ranks than one (``--devices``, ``--mesh clients:K[,model:M]``)
    and no process group yet, in that many local ranks started here."""
    import sys
    import tempfile

    import torch.distributed as dist

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.num_processes > 1:
        from repro_torch.runtime.sharding import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id,
                         device="cpu" if args.device == "cpu" else None)
        try:
            run(args)
        finally:
            dist.destroy_process_group()
    elif args.ranks > 1 and not dist.is_initialized():
        from repro_torch.device import resolve_device
        from repro_torch.runtime.ranks import run_ranks
        resolve_device(args.device)            # no card: raise here
        import os
        # CPU ranks share the host's cores; card ranks keep torch's default
        threads = (max(1, (os.cpu_count() or 1) // args.ranks)
                   if args.device == "cpu" else 0)
        with tempfile.TemporaryDirectory() as workdir:
            run_ranks(_rank_run, args.ranks, workdir, argv,
                      device=args.device, threads=threads)
    else:
        run(args)


if __name__ == "__main__":
    main()
