"""Synthetic heterogeneous LM client streams for meta-training the LM
family (a copy of the JAX package's ``data/lm.py`` stream, NumPy only,
bit for bit): each client is a 'domain' with its own Zipfian unigram +
bigram structure, so clients are non-iid, the regime where the paper
shows FedAVG fails and TinyReptile works.

``LmTaskDistribution`` and ``lm_loss`` (the engine's LM route) are not
ported yet.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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
