"""The JAX package's key-derived permutations, in NumPy.

``PartialCommChannel`` picks the parameter entries a round transmits
from a permutation keyed by ``mask_seed``: in the JAX package,
``jax.random.permutation(jax.random.fold_in(PRNGKey(mask_seed), i), n)``
for leaf ``i`` of ``n`` entries. Both ends of the wire derive it, so the
port must draw the very same permutation for its masks to equal the
reference's. This module reimplements that draw: the Threefry-2x32 hash
(20 rounds, the counter layout of JAX's default "partitionable"
threefry), ``fold_in``, a two-way ``split``, 32-bit ``random_bits`` and
the sort-based shuffle of ``jax.random.permutation``. It runs on the
host, once per run; ``tests/test_torch_partial_comm.py`` holds it to
``jax.random``.
"""
from __future__ import annotations


import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` (uint32 arrays of one shape) under ``key`` (two uint32
    words); returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as two words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key, np.uint32(0), np.uint32(data & 0xFFFFFFFF))
    return np.array([a, b], np.uint32)


def _counters(n: int):
    """The 64-bit iota over n entries, as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key):
    """``jax.random.split(key)``: two child keys."""
    a, b = threefry2x32(key, *_counters(2))
    return np.stack([a, b], axis=1)


def random_bits32(key, n: int):
    """``jax.random.bits(key, (n,), uint32)``."""
    a, b = threefry2x32(key, *_counters(n))
    return a ^ b


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: a shuffle of ``arange(n)`` by
    stable sorts on fresh 32-bit keys, ``ceil(3 ln n / ln(2^32 - 1))``
    rounds of them."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x


def leaf_permutations(mask_seed: int, sizes):
    """One permutation per leaf, leaf ``i`` of ``sizes[i]`` entries keyed
    by ``fold_in(PRNGKey(mask_seed), i)``, as ``PartialCommChannel``
    derives them."""
    key = prng_key(mask_seed)
    return [permutation(fold_in(key, i), int(n)) for i, n in enumerate(sizes)]

