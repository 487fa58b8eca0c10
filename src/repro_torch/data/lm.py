"""Synthetic heterogeneous LM client streams for meta-training the LM
family (a copy of the JAX package's ``data/lm.py``, NumPy only, bit for
bit): each client is a 'domain' with its own Zipfian unigram + bigram
structure, so clients are non-iid, the regime where the paper shows
FedAVG fails and TinyReptile works.

``LmTaskDistribution`` exposes those domains as a
``data.tasks.TaskDistribution``, so the round engine runs next-token
personalization over the LM families: every client task is one domain,
a support "sample" is one fixed-length (seq,) int32 token sequence with
its shifted labels (-1 tail ignored by the loss), and the vectorized
``sample_support_block`` / ``sample_client_support`` hooks draw whole
blocks in O(1) NumPy calls, so LM tasks compose with
``ClientPool(sampler="vectorized")`` and the prefetcher. Every draw
equals the JAX package's bit for bit (the same NumPy calls in the same
order).

``lm_loss`` adapts ``Model.loss_fn`` to the engine's cohort hooks: the
params carry a leading cohort axis C and the batch is ``{"x", "y"}`` of
(C, S, seq) int32; it returns the (C,) per-client losses.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.bridge import index_tree
from repro_torch.data.tasks import ClientTask, TaskDistribution


class LMClientStream:
    def __init__(self, vocab_size: int, client_id: int,
                 zipf_a_range=(1.05, 1.6)):
        self.vocab = vocab_size
        r = np.random.default_rng(client_id)
        self.zipf_a = r.uniform(*zipf_a_range)
        # client-specific token permutation -> distinct head of the dist
        self.perm = r.permutation(vocab_size)
        # light bigram structure: each token has a preferred successor
        self.succ = r.integers(0, vocab_size, size=vocab_size)
        self.succ_p = r.uniform(0.1, 0.4)

    def batch(self, rng: np.random.Generator, batch: int,
              seq: int) -> Dict[str, np.ndarray]:
        ranks = rng.zipf(self.zipf_a, size=(batch, seq)) - 1
        tokens = self.perm[np.clip(ranks, 0, self.vocab - 1)]
        # inject bigram continuations
        use_succ = rng.uniform(size=(batch, seq)) < self.succ_p
        for t in range(1, seq):
            tokens[:, t] = np.where(use_succ[:, t],
                                    self.succ[tokens[:, t - 1]],
                                    tokens[:, t])
        labels = _shift_labels(tokens)
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}


def _shift_labels(tokens: np.ndarray) -> np.ndarray:
    """Next-token labels along the last axis; -1 (LABEL_IGNORE) tail."""
    return np.concatenate(
        [tokens[..., 1:], np.full(tokens.shape[:-1] + (1,), -1,
                                  tokens.dtype)], axis=-1)


class LmTaskDistribution(TaskDistribution):
    """Per-client next-token personalization tasks over LMClientStream
    domains. A task IS one domain (Zipf head + bigram successor table
    keyed by the domain id); a support sample is one (seq,) int32 token
    sequence with shifted labels, so blocks are fixed-shape
    (rounds, clients, support, seq) padded arrays, what the engine's
    one-build-per-config round needs.

    RNG contract (see ``data/tasks.py``): the reference path draws
    task-then-samples per client via ``sample_task``; the vectorized
    overrides draw in BLOCK order (all domain ids as one draw, then the
    Zipf ranks as one array draw, then the bigram coin flips as one
    draw), identically distributed, deterministic within a sampler.
    """

    def __init__(self, vocab_size: int, seq_len: int,
                 num_domains: int = 4096):
        self.vocab = int(vocab_size)
        self.seq = int(seq_len)
        self.num_domains = int(num_domains)
        self._streams: Dict[int, LMClientStream] = {}

    def _stream(self, cid: int) -> LMClientStream:
        if cid not in self._streams:
            self._streams[cid] = LMClientStream(self.vocab, cid)
        return self._streams[cid]

    def sample_task(self, rng: np.random.Generator) -> ClientTask:
        cid = int(rng.integers(self.num_domains))
        stream = self._stream(cid)
        seq = self.seq

        def make_sample(r):
            b = stream.batch(r, 1, seq)
            return b["tokens"][0], b["labels"][0]

        return ClientTask(make_sample=make_sample, task_id=cid)

    def _domain_tables(self, cids: np.ndarray):
        """Stacked per-domain tables for the UNIQUE domains of a block:
        (perm, succ) lookup matrices plus the scalar zipf_a / succ_p
        vectors, and the inverse map back to block rows."""
        uniq, inv = np.unique(cids, return_inverse=True)
        streams = [self._stream(int(c)) for c in uniq]
        perms = np.stack([s.perm for s in streams])
        succs = np.stack([s.succ for s in streams])
        zipf_a = np.array([s.zipf_a for s in streams])
        succ_p = np.array([s.succ_p for s in streams])
        return inv, perms, succs, zipf_a, succ_p

    def _materialize(self, ranks, coin, inv, perms, succs, succ_p):
        """Tokens from pre-drawn Zipf ranks + bigram coin flips.
        ranks/coin: (..., seq) with a leading row axis indexed by inv.
        The only Python loop is over seq positions (the bigram chain is
        sequential by construction, as in LMClientStream.batch)."""
        tokens = np.take_along_axis(
            perms[inv], np.clip(ranks, 0, self.vocab - 1).reshape(
                len(inv), -1), axis=1).reshape(ranks.shape)
        use = coin < succ_p[inv].reshape((-1,) + (1,) * (ranks.ndim - 1))
        succ_rows = succs[inv]                   # (rows, vocab)
        flat_t = tokens.reshape(len(inv), -1, tokens.shape[-1])
        flat_u = use.reshape(len(inv), -1, tokens.shape[-1])
        for t in range(1, tokens.shape[-1]):
            prev = flat_t[:, :, t - 1]
            cont = np.take_along_axis(succ_rows, prev, axis=1)
            flat_t[:, :, t] = np.where(flat_u[:, :, t], cont,
                                       flat_t[:, :, t])
        return flat_t.reshape(ranks.shape)

    def sample_client_support(self, rng_task, rng_data, support,
                              data_mode="batch"):
        """Counter-derived pooled check-in (``ClientPool(sampler=
        "vectorized")``): the domain id with the SAME single draw as
        ``sample_task``, then the whole support set's Zipf ranks and
        bigram coins each as one array draw."""
        del data_mode                 # stream and batch share one layout
        cid = int(rng_task.integers(self.num_domains))
        cids = np.array([cid])
        inv, perms, succs, _, succ_p = self._domain_tables(cids)
        ranks = rng_data.zipf(self._stream(cid).zipf_a,
                              size=(1, support, self.seq)) - 1
        coin = rng_data.uniform(size=(1, support, self.seq))
        tokens = self._materialize(ranks, coin, inv, perms, succs, succ_p)
        x = tokens[0].astype(np.int32)
        return x, _shift_labels(x)

    def sample_support_block(self, rng, rounds, clients, support,
                             data_mode="batch", participation=None):
        """Vectorized block, no per-task Python loop. Block RNG order:
        (1) all domain ids as one draw, (2) all Zipf ranks as one draw
        (per-row Zipf parameter broadcast), (3) all bigram coin flips as
        one draw. Scheduled-out ``participation`` slots are zeroed after
        the draw."""
        del data_mode
        n = rounds * clients
        cids = rng.integers(self.num_domains, size=n)
        inv, perms, succs, zipf_a, succ_p = self._domain_tables(cids)
        ranks = rng.zipf(zipf_a[inv][:, None, None],
                         size=(n, support, self.seq)) - 1
        coin = rng.uniform(size=(n, support, self.seq))
        tokens = self._materialize(ranks, coin, inv, perms, succs, succ_p)
        x = tokens.astype(np.int32)
        y = _shift_labels(x)
        return self._mask_block(
            {"x": x.reshape(rounds, clients, support, self.seq),
             "y": y.reshape(rounds, clients, support, self.seq)},
            participation)


def lm_loss(model):
    """``Model.loss_fn`` as the engine's cohort loss: ``loss_fn(params,
    batch)`` with every leaf of ``params`` carrying a leading cohort axis
    C and ``batch`` = {"x": (C, S, seq), "y": (C, S, seq)} int32 token
    blocks and shifted labels (-1 = ignore), (C, 1, seq) on the stream
    path. Returns the (C,) fp32 losses, one ``model.loss_fn`` per client
    on its own views of the leaves (no copies): the summed losses'
    gradient is each client's own gradient (``core.meta.cohort_grad``).

    Where the JAX package vmaps one model's loss, this loops over the C
    clients; the Mamba2 scan's ``autograd.Function`` launches a kernel
    through ``ctypes`` and has no vmap rule. On the engine's 2-D route
    the leaves are this rank's shards and ``Model.loss_fn`` computes on
    them (``gathers_at_use``)."""
    def loss_fn(params, batch):
        x, y = batch["x"], batch["y"]
        return torch.stack([
            model.loss_fn(index_tree(params, c),
                          {"tokens": x[c], "labels": y[c]}).float()
            for c in range(x.shape[0])])
    # on the 2-D route the model computes on its shards itself
    loss_fn.gathers_at_use = True
    return loss_fn
