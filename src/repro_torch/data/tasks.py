"""Meta-learning task distributions (streaming, deterministic, offline).

The port's own copy of the JAX package's ``data/tasks.py``, which
imports only NumPy: the samplers must stay bit-equal to it (pinned in
tests/test_torch_tasks.py), so edit the two together.

The paper's three benchmarks:
- Sine-wave regression  [MAML / paper §IV-A]: f(x) = a sin(bx + c).
- Omniglot M-way classification: real Omniglot is unavailable offline, so
  classes are synthetic stroke glyphs generated per class id — the
  meta-learning STRUCTURE (disjoint class subsets per client, few-shot
  support/query) is preserved exactly.
- Keywords spotting (paper's contributed dataset, from Speech Commands):
  synthetic per-keyword spectrogram prototypes (49x10 MFCC maps, the
  MLPerf-Tiny input shape), samples jittered in time/amplitude.

Every client exposes BOTH a batch view (Reptile/FedAVG) and a one-sample-
at-a-time stream view (TinyReptile's online learning).

Block sampling (the round engine's host path) comes in two flavours:

- ``sample_support_block_reference``: a per-task Python loop consuming
  the RNG in exactly the order the legacy per-round loops did (task
  parameters interleaved with that task's support draws). This is the
  seeded-parity anchor — the engine's default, and what every
  vectorized override is validated against in spirit.
- ``sample_support_block``: batched vectorized sampling — one NumPy
  allocation for the whole ``rounds x clients`` block, no per-sample
  ``np.stack``. Overrides consume the RNG in a documented BLOCK order
  (all task-level draws first, then each per-sample quantity as one
  array draw), so a given seed yields different — but identically
  distributed — tasks than the reference order. Within one sampler the
  stream is deterministic, which is what the engine's prefetch pipeline
  relies on for bit-for-bit pipelined-vs-synchronous parity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class ClientTask:
    """One client/device with its underlying task."""
    make_sample: callable          # rng -> (x, y)
    task_id: int

    def support_batch(self, rng: np.random.Generator, size: int) -> Dict:
        xs, ys = zip(*(self.make_sample(rng) for _ in range(size)))
        return {"x": np.stack(xs), "y": np.stack(ys)}

    def support_stream(self, rng: np.random.Generator,
                       size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Streaming view: one sample at a time, never stored (TinyReptile)."""
        for _ in range(size):
            yield self.make_sample(rng)

    def query_batch(self, rng: np.random.Generator, size: int) -> Dict:
        return self.support_batch(rng, size)


class TaskDistribution:
    def sample_task(self, rng: np.random.Generator) -> ClientTask:
        raise NotImplementedError

    def materialize_client(self, i: int, seed: int = 0) -> ClientTask:
        """Persistent-identity hook (the JAX package's
        ``core.pool.ClientPool``): the STABLE task of pool client ``i``.

        Unlike ``sample_task`` (fresh anonymous task per cohort slot per
        round), this derives the task from ``(seed, i)`` alone, so pool
        client ``i`` owns the same task/data shard every round, every
        block, every run — the TinyReptile deployment model, where each
        device keeps its own data across check-ins. The base
        implementation routes through ``sample_task`` with a
        client-keyed generator; distributions with out-of-band per-client
        shards can override."""
        return self.sample_task(np.random.default_rng([seed, 0x9E37, i]))

    def sample_support_block_reference(self, rng: np.random.Generator,
                                       rounds: int, clients: int,
                                       support: int,
                                       data_mode: str = "batch",
                                       participation=None) -> Dict:
        """Seeded-parity reference: sample ``rounds x clients`` client
        support sets with a per-task Python loop, consuming `rng` in
        exactly the order the legacy per-round loops did (for each round,
        for each client: the task, then its support data).

        Returns {"x": (rounds, clients, support, ...), "y": ...} NumPy
        arrays. Stream- and batch-mode clients draw identically here;
        the mode only matters for distributions whose two views differ.

        ``participation`` (optional (rounds, clients) bool — a
        ClientSchedule's mask) drives the sampling: scheduled-out slots
        draw NOTHING from the rng and their block entries stay zero, so
        host sampling work scales with the participating fraction. An
        all-True mask consumes the rng identically to no mask.
        """
        samples = []
        for i in range(rounds * clients):
            if (participation is not None
                    and not participation[i // clients, i % clients]):
                samples.append(None)
                continue
            task = self.sample_task(rng)
            if data_mode == "stream":
                sx, sy = zip(*task.support_stream(rng, support))
                x, y = np.stack(sx), np.stack(sy)
            else:
                b = task.support_batch(rng, support)
                x, y = np.asarray(b["x"]), np.asarray(b["y"])
            samples.append((x, y))
        template = next((s for s in samples if s is not None), None)
        if template is None:
            raise ValueError("participation mask schedules zero clients "
                             "across the whole block; every round needs "
                             "at least one participant")
        zx, zy = np.zeros_like(template[0]), np.zeros_like(template[1])
        xs = [zx if s is None else s[0] for s in samples]
        ys = [zy if s is None else s[1] for s in samples]
        x = np.stack(xs).reshape(rounds, clients, *zx.shape)
        y = np.stack(ys).reshape(rounds, clients, *zy.shape)
        return {"x": x, "y": y}

    def sample_support_block(self, rng: np.random.Generator, rounds: int,
                             clients: int, support: int,
                             data_mode: str = "batch",
                             participation=None) -> Dict:
        """Batched block sampling: one vectorized allocation for the whole
        block. Subclasses override with true vectorized implementations
        (block RNG order, see module docstring); the base class falls back
        to the reference loop so every distribution supports the API.

        Vectorized overrides sample the FULL block in one allocation and
        zero the scheduled-out ``participation`` slots afterwards (the
        reference loop instead skips their rng draws entirely)."""
        return self.sample_support_block_reference(rng, rounds, clients,
                                                   support, data_mode,
                                                   participation)

    def sample_client_support(self, rng_task: np.random.Generator,
                              rng_data: np.random.Generator, support: int,
                              data_mode: str = "batch"):
        """One pooled check-in's support set from two COUNTER-DERIVED
        streams (the ``sampler="vectorized"`` path of the JAX package's
        ``core.pool.ClientPool``): ``rng_task`` is freshly seeded from
        ``(seed, 0x9E37, i)`` — the same derivation as
        ``materialize_client`` — and
        ``rng_data`` from ``(seed, data-stream, i, k)`` where ``k`` is
        the client's check-in count, so the draw is a pure function of
        ``(seed, i, k)`` and the pool keeps NO per-client host objects.

        Returns ``(x, y)`` arrays shaped ``(support, ...)``. The base
        implementation materializes the task and replays the per-sample
        reference order; overrides draw each per-sample quantity as ONE
        array call (the block RNG order of ``sample_support_block``),
        which for distributions whose per-sample draws are independent
        (SineTasks) reproduces the base implementation bit-for-bit."""
        task = self.sample_task(rng_task)
        if data_mode == "stream":
            sx, sy = zip(*task.support_stream(rng_data, support))
            return np.stack(sx), np.stack(sy)
        b = task.support_batch(rng_data, support)
        return np.asarray(b["x"]), np.asarray(b["y"])

    @staticmethod
    def _mask_block(block: Dict, participation) -> Dict:
        """Zero the scheduled-out (round, client) slots of a sampled
        block in place (vectorized overrides' participation contract)."""
        if participation is not None:
            off = ~np.asarray(participation, bool)
            for v in block.values():
                v[off] = 0
        return block

    @staticmethod
    def _choice_block(rng: np.random.Generator, n: int, m: int,
                      k: int) -> np.ndarray:
        """``n`` independent without-replacement draws of ``k`` of ``m``
        items as ONE vectorized operation: a single (n, m) uniform draw,
        argsorted per row, first-k prefix taken — each row is a uniform
        random permutation's prefix, i.e. exactly the distribution of a
        per-task ``rng.choice(m, size=k, replace=False)`` loop, at one
        rng draw and zero Python-level iterations. This replaced the
        last per-task loops in the shipped vectorized block samplers
        (PR-2 follow-up); it consumes the rng ONCE, as one (n, m)
        uniform array, which is the documented block order."""
        if k > m:
            raise ValueError(f"cannot draw {k} of {m} without replacement")
        u = rng.random((n, m))
        return np.argsort(u, axis=1)[:, :k]


class SineTasks(TaskDistribution):
    """f(x) = a sin(b x + c); a ~ U[0.1, 5], b ~ U[0.8, 1.2], c ~ U[0, pi]."""

    def __init__(self, x_range=(-5.0, 5.0)):
        self.x_range = x_range

    def sample_task(self, rng) -> ClientTask:
        a = rng.uniform(0.1, 5.0)
        b = rng.uniform(0.8, 1.2)
        c = rng.uniform(0.0, np.pi)
        lo, hi = self.x_range

        def make_sample(r):
            x = r.uniform(lo, hi, size=(1,)).astype(np.float32)
            y = (a * np.sin(b * x + c)).astype(np.float32)
            return x, y

        return ClientTask(make_sample=make_sample,
                          task_id=int(rng.integers(1 << 31)))

    def sample_client_support(self, rng_task, rng_data, support,
                              data_mode="batch"):
        """Counter-derived pooled check-in, vectorized over the support
        axis: (a, b, c) as one row-major uniform triple (the same three
        doubles a scalar a/b/c loop draws), then all ``support`` inputs
        as one draw — bit-for-bit the base per-sample replay, at O(1)
        NumPy calls per check-in instead of O(support)."""
        del data_mode  # the stream and batch views share one layout
        # Python floats, not np.float64 scalars: make_sample's a/b/c are
        # Python floats, which leave the float32 x un-promoted — an
        # np.float64 scalar would push the sin into float64 and change
        # the last bits.
        a, b, c = map(float, rng_task.uniform([0.1, 0.8, 0.0],
                                              [5.0, 1.2, np.pi]))
        lo, hi = self.x_range
        x = rng_data.uniform(lo, hi, size=(support, 1)).astype(np.float32)
        y = (a * np.sin(b * x + c)).astype(np.float32)
        return x, y

    def sample_support_block(self, rng, rounds, clients, support,
                             data_mode="batch", participation=None):
        """Vectorized block: (1) all task parameter triples (a, b, c) as
        one (n, 3) uniform draw (row-major — the same values a scalar
        per-task a/b/c loop would draw), then (2) all support inputs as
        one (n, support, 1) draw. Per-sample math is identical to
        ``make_sample``, so a scalar loop over this block order
        reproduces it bit-for-bit (tested). Scheduled-out
        ``participation`` slots are zeroed after the full-block draw."""
        del data_mode  # the stream and batch views share one layout
        n = rounds * clients
        abc = rng.uniform([0.1, 0.8, 0.0], [5.0, 1.2, np.pi], size=(n, 3))
        a, b, c = (abc[:, j, None, None] for j in range(3))
        lo, hi = self.x_range
        x = rng.uniform(lo, hi, size=(n, support, 1)).astype(np.float32)
        y = (a * np.sin(b * x + c)).astype(np.float32)
        return self._mask_block(
            {"x": x.reshape(rounds, clients, support, 1),
             "y": y.reshape(rounds, clients, support, 1)}, participation)


def _glyph_prototype(class_id: int, side: int = 28) -> np.ndarray:
    """Deterministic synthetic stroke glyph for a class id."""
    r = np.random.default_rng(class_id)
    img = np.zeros((side, side), np.float32)
    pos = r.integers(4, side - 4, size=2).astype(np.float64)
    for _ in range(3):  # three strokes
        ang = r.uniform(0, 2 * np.pi)
        step = np.array([np.cos(ang), np.sin(ang)])
        for _ in range(r.integers(8, 16)):
            ang += r.normal(0, 0.4)
            step = np.array([np.cos(ang), np.sin(ang)])
            pos = np.clip(pos + step * 1.5, 1, side - 2)
            i, j = int(pos[0]), int(pos[1])
            img[i - 1:i + 2, j - 1:j + 2] += 0.5
        pos = r.integers(4, side - 4, size=2).astype(np.float64)
    return np.clip(img, 0, 1)


class OmniglotTasks(TaskDistribution):
    """M-way few-shot classification over synthetic glyph classes.

    Each client samples M classes from a pool of `num_classes`; labels are
    0..M-1 locally (heterogeneous across clients, as in the paper)."""

    def __init__(self, num_classes: int = 1623, ways: int = 5,
                 noise: float = 0.1):
        self.num_classes = num_classes
        self.ways = ways
        self.noise = noise
        self._cache: Dict[int, np.ndarray] = {}

    def _proto(self, cid: int) -> np.ndarray:
        if cid not in self._cache:
            self._cache[cid] = _glyph_prototype(cid)
        return self._cache[cid]

    def sample_task(self, rng) -> ClientTask:
        classes = rng.choice(self.num_classes, size=self.ways, replace=False)

        def make_sample(r):
            label = r.integers(self.ways)
            proto = self._proto(int(classes[label]))
            dx, dy = r.integers(-2, 3, size=2)
            img = np.roll(proto, (dx, dy), axis=(0, 1))
            img = img + r.normal(0, self.noise, img.shape).astype(np.float32)
            return (img[..., None].astype(np.float32),
                    np.int32(label))

        return ClientTask(make_sample=make_sample,
                          task_id=int(rng.integers(1 << 31)))

    def sample_client_support(self, rng_task, rng_data, support,
                              data_mode="batch"):
        """Counter-derived pooled check-in, vectorized over the support
        axis. ``rng_task`` draws the class subset with the SAME call as
        ``sample_task`` (the stable classes of ``materialize_client``);
        ``rng_data`` then draws labels, roll offsets, and noise each as
        ONE array call — the documented block order, identically
        distributed to (but differently interleaved than) the per-sample
        reference replay."""
        del data_mode
        side = 28
        classes = rng_task.choice(self.num_classes, size=self.ways,
                                  replace=False)
        labels = rng_data.integers(self.ways, size=support)
        shifts = rng_data.integers(-2, 3, size=(support, 2))
        noise = rng_data.normal(0, self.noise,
                                size=(support, side, side)).astype(np.float32)
        imgs = np.stack([self._proto(int(classes[l])) for l in labels])
        r_idx = (np.arange(side)[None, :, None]
                 - shifts[:, 0, None, None]) % side
        c_idx = (np.arange(side)[None, None, :]
                 - shifts[:, 1, None, None]) % side
        rolled = imgs[np.arange(support)[:, None, None], r_idx, c_idx]
        x = (rolled + noise)[..., None].astype(np.float32)
        return x, labels.astype(np.int32)

    def sample_support_block(self, rng, rounds, clients, support,
                             data_mode="batch", participation=None):
        """Vectorized block — no per-task Python loop left. RNG order:
        ALL class subsets as one (n, num_classes) uniform draw
        (``_choice_block``: per-row argsort prefix, the same
        without-replacement distribution as the old per-task ``choice``
        loop), then labels, roll offsets, and noise each as one array
        draw. The per-sample roll is a wrapped gather instead of
        ``np.roll``. Scheduled-out ``participation`` slots are zeroed
        post-draw."""
        del data_mode
        n, side = rounds * clients, 28
        classes = self._choice_block(rng, n, self.num_classes, self.ways)
        labels = rng.integers(self.ways, size=(n, support))
        shifts = rng.integers(-2, 3, size=(n, support, 2))
        noise = rng.normal(0, self.noise,
                           size=(n, support, side, side)).astype(np.float32)
        class_ids = np.take_along_axis(classes, labels, axis=1)
        uniq, inv = np.unique(class_ids, return_inverse=True)
        protos = np.stack([self._proto(int(c)) for c in uniq])
        imgs = protos[inv.reshape(n, support)]            # (n, S, side, side)
        r_idx = (np.arange(side)[None, None, :, None]
                 - shifts[:, :, 0, None, None]) % side    # (n, S, side, 1)
        c_idx = (np.arange(side)[None, None, None, :]
                 - shifts[:, :, 1, None, None]) % side    # (n, S, 1, side)
        rolled = imgs[np.arange(n)[:, None, None, None],
                      np.arange(support)[None, :, None, None], r_idx, c_idx]
        x = (rolled + noise)[..., None].astype(np.float32)
        return self._mask_block(
            {"x": x.reshape(rounds, clients, support, side, side, 1),
             "y": labels.astype(np.int32).reshape(rounds, clients, support)},
            participation)


def _kws_prototype(class_id: int, t: int = 49, f: int = 10) -> np.ndarray:
    """Synthetic MFCC-like map: smooth temporal envelope x spectral shape."""
    r = np.random.default_rng(class_id + (1 << 20))
    env = np.convolve(r.normal(0, 1, t + 8), np.ones(9) / 9, "valid")
    spec = np.convolve(r.normal(0, 1, f + 4), np.ones(5) / 5, "valid")
    proto = np.outer(env, spec)
    # add a couple of formant-like tracks
    for _ in range(2):
        f0 = r.integers(0, f)
        drift = np.clip(np.cumsum(r.normal(0, 0.3, t)).astype(int) + f0,
                        0, f - 1)
        proto[np.arange(t), drift] += 1.0
    return (proto / (np.abs(proto).max() + 1e-6)).astype(np.float32)


class KWSTasks(TaskDistribution):
    """Keywords-spotting meta-learning (the paper's contributed dataset):
    M-way keyword classification; each client draws its own M keywords
    from the 35-word vocabulary."""

    def __init__(self, num_words: int = 35, ways: int = 4,
                 noise: float = 0.15):
        self.num_words = num_words
        self.ways = ways
        self.noise = noise
        self._cache: Dict[int, np.ndarray] = {}

    def _proto(self, cid: int) -> np.ndarray:
        if cid not in self._cache:
            self._cache[cid] = _kws_prototype(cid)
        return self._cache[cid]

    def sample_task(self, rng) -> ClientTask:
        words = rng.choice(self.num_words, size=self.ways, replace=False)

        def make_sample(r):
            label = r.integers(self.ways)
            proto = self._proto(int(words[label]))
            shift = r.integers(-3, 4)
            x = np.roll(proto, shift, axis=0)
            x = x * r.uniform(0.8, 1.2)
            x = x + r.normal(0, self.noise, x.shape).astype(np.float32)
            return x[..., None].astype(np.float32), np.int32(label)

        return ClientTask(make_sample=make_sample,
                          task_id=int(rng.integers(1 << 31)))

    def sample_client_support(self, rng_task, rng_data, support,
                              data_mode="batch"):
        """Counter-derived pooled check-in, vectorized over the support
        axis: keyword subset via the same ``choice`` call as
        ``sample_task``, then labels, time shifts, amplitudes, and noise
        each as one array draw (block order; the time roll is a wrapped
        gather along the frame axis)."""
        del data_mode
        t, f = 49, 10
        words = rng_task.choice(self.num_words, size=self.ways,
                                replace=False)
        labels = rng_data.integers(self.ways, size=support)
        shifts = rng_data.integers(-3, 4, size=support)
        amps = rng_data.uniform(0.8, 1.2, size=support)
        noise = rng_data.normal(0, self.noise,
                                size=(support, t, f)).astype(np.float32)
        maps = np.stack([self._proto(int(words[l])) for l in labels])
        r_idx = (np.arange(t)[None, :] - shifts[:, None]) % t
        rolled = maps[np.arange(support)[:, None], r_idx]
        x = rolled * amps[:, None, None] + noise
        return x[..., None].astype(np.float32), labels.astype(np.int32)

    def sample_support_block(self, rng, rounds, clients, support,
                             data_mode="batch", participation=None):
        """Vectorized block — no per-task Python loop left. RNG order:
        ALL keyword subsets as one (n, num_words) uniform draw
        (``_choice_block``), then labels, time shifts, amplitudes, and
        noise each as one array draw; the time roll is a wrapped gather
        along the frame axis. Scheduled-out ``participation`` slots are
        zeroed post-draw."""
        del data_mode
        n, t, f = rounds * clients, 49, 10
        words = self._choice_block(rng, n, self.num_words, self.ways)
        labels = rng.integers(self.ways, size=(n, support))
        shifts = rng.integers(-3, 4, size=(n, support))
        amps = rng.uniform(0.8, 1.2, size=(n, support))
        noise = rng.normal(0, self.noise,
                           size=(n, support, t, f)).astype(np.float32)
        word_ids = np.take_along_axis(words, labels, axis=1)
        uniq, inv = np.unique(word_ids, return_inverse=True)
        protos = np.stack([self._proto(int(w)) for w in uniq])
        maps = protos[inv.reshape(n, support)]             # (n, S, t, f)
        r_idx = (np.arange(t)[None, None, :] - shifts[..., None]) % t
        rolled = maps[np.arange(n)[:, None, None],
                      np.arange(support)[None, :, None], r_idx]
        x = (rolled * amps[..., None, None] + noise)
        x = x[..., None].astype(np.float32)
        return self._mask_block(
            {"x": x.reshape(rounds, clients, support, t, f, 1),
             "y": labels.astype(np.int32).reshape(rounds, clients, support)},
            participation)
