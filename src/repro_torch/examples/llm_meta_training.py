"""TinyReptile at framework scale: federated meta-training of a reduced
LM over heterogeneous LM clients, then serving it, on the port.

    PYTHONPATH=src python -m repro_torch.examples.llm_meta_training
    PYTHONPATH=src python -m repro_torch.examples.llm_meta_training \\
        mamba2-130m --device cpu

The same steps as the JAX package's ``examples/llm_meta_training.py``,
through the public API the launchers use:

- ``runtime.steps.make_meta_train_step`` (the paper's round as a step)
  over 16 ``LMClientStream`` clients, one drawn each round, its batch
  split into K microbatches (``microbatch``), 30 rounds of 8 x 64
  tokens at K = 4; the meta loss must fall;
- ``checkpoint.save_checkpoint`` / ``restore_checkpoint``, a round trip;
- 8 greedy tokens from the meta-learned init through ``decode_fn``, as
  ``runtime.steps.DecodeRunner`` serves one prompt of one token (built
  once and replayed on the card).

The arch is ``tinyllama-1.1b`` reduced by default (any ported arch runs:
``mamba2-130m``, ``starcoder2-15b``, ``glm4-9b``, ``minicpm-2b``, the
MoE ``mixtral-8x22b`` and ``llama4-maverick-400b-a17b``, the hybrid
``zamba2-1.2b``). The init is drawn with torch's
generator from seed 0, not ``jax.random``'s (``main(init_params=)``
takes the JAX package's init, through ``bridge.lm_params_from_jax``). It
runs on the GPU; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.bridge import lm_params_from_jax, tree_leaves
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import LMClientStream
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import (DecodeRunner, make_meta_train_step,
                                       microbatch)

ROUNDS, BATCH, SEQ, K = 30, 8, 64, 4
CLIENTS = 16
NEW_TOKENS, CACHE_LEN = 8, 32


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="tinyllama-1.1b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None, init_params=None):
    """Run the example; returns the per-round meta losses, the greedy
    tokens and the meta-learned params. ``init_params`` (the JAX
    package's ``Model.init`` tree) replaces the seeded torch init."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = build_model(get_arch(args.arch).reduced())
    if init_params is None:
        phi = model.init(torch.Generator().manual_seed(0), dev)
    else:
        phi = lm_params_from_jax(init_params, model.jax_layout, dev)
    clients = [LMClientStream(model.cfg.vocab_size, cid)
               for cid in range(CLIENTS)]
    step = make_meta_train_step(model, beta=0.02, alpha=1.0)
    rng = np.random.default_rng(0)

    losses = []
    for rnd in range(ROUNDS):
        client = clients[int(rng.integers(len(clients)))]
        batch = microbatch({k: torch.from_numpy(v).to(dev) for k, v in
                            client.batch(rng, BATCH, SEQ).items()}, K)
        phi, m = step(phi, batch)
        loss, first, last = torch.stack(
            [m["loss"], m["inner_first"], m["inner_last"]]).tolist()
        losses.append(loss)
        if rnd % 10 == 0:
            print(f"round {rnd:3d}  loss {loss:.3f}  "
                  f"(inner {first:.3f} -> {last:.3f})")
    print(f"meta-training: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "meta loss should improve"

    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, phi, ROUNDS, extra={"arch": args.arch})
        phi2, rnd, extra = restore_checkpoint(d, phi)
        for (path, a), (_, b) in zip(tree_leaves(phi), tree_leaves(phi2)):
            assert torch.equal(a.cpu(), torch.as_tensor(b)), path
        print(f"checkpoint round-trip ok (round {rnd}, {extra})")

    # serve a few greedy tokens from the meta-learned init: one prompt of
    # one token (id 1), each new token fed back at the next position
    runner = DecodeRunner(model, phi, batch=1, prompt_len=1,
                          cache_len=CACHE_LEN, max_new=NEW_TOKENS,
                          device=dev)
    outs = runner.wave(torch.ones((1, 1), dtype=torch.int64))[0]
    print("greedy sample:", outs)
    return {"losses": losses, "greedy": outs, "params": phi}


if __name__ == "__main__":
    main()
