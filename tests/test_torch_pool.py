"""The port's persistent client pool (``core/pool.py``), FedBuff and
availability processes, and the engine's pooled and buffered rounds,
held against the JAX package on the CPU.

The contracts of tests/test_pool.py, ported: stable identities, the
pool state through the round against a host replay of the plan, FedBuff
flush semantics, availability statistics, no-show rounds, the
single-build contract. Where a case runs both packages from the same
seeded init (the JAX package's, carried across as NumPy), cohorts, the
pool state and every byte count are held exactly and fp32 params at
1e-4 (``test_torch_engine.TOL``).
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers


from repro import core as jcore  # noqa: E402
from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import FlatLayout  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.pool import (PoolState,  # noqa: E402
                                   default_staleness_weight)
from repro_torch.core.strategies import TinyReptileStrategy  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402

from test_torch_engine import assert_same_run, init  # noqa: E402,F401

JLOSS = functools.partial(j_loss, J_SINE)
TLOSS = functools.partial(paper_model_loss, SINE_MLP)
EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.02, query=8)
PAYLOAD = 1153 * 4              # the sine MLP on the fp32 wire


def _tiny(init, **kw):
    return tcore.tinyreptile_train(TLOSS, init, SineTasks(), device="cpu",
                                   **kw)


def _same_pool_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


def _params_equal(out, init):
    for k, v in init.items():
        np.testing.assert_array_equal(out["params"][k].numpy(), v)


# -- stable identities --------------------------------------------------------

def test_materialize_client_is_stable():
    dist = SineTasks()
    a = dist.materialize_client(3, seed=7)
    b = dist.materialize_client(3, seed=7)
    xa, ya = a.make_sample(np.random.default_rng(0))
    xb, yb = b.make_sample(np.random.default_rng(0))
    np.testing.assert_array_equal(ya, yb)          # same task both times
    xc, yc = dist.materialize_client(4, seed=7).make_sample(
        np.random.default_rng(0))
    assert not np.array_equal(ya, yc)              # different client
    # the JAX package's client 3 is the same task
    xj, yj = JSine().materialize_client(3, seed=7).make_sample(
        np.random.default_rng(0))
    np.testing.assert_array_equal(ya, yj)


@pytest.mark.parametrize("sampler", ["reference", "vectorized"])
def test_pool_data_depends_only_on_own_checkins(sampler):
    """Client 2's k-th check-in draws the same data whoever else was
    scheduled, and the very data the JAX package's pool draws."""
    part_a = np.array([[True, True], [True, True]])
    cohort_a = np.array([[2, 5], [2, 1]], np.int32)
    got_a = tcore.ClientPool(SineTasks(), 8, sampler=sampler)\
        .sample_cohort_block(cohort_a, part_a, support=4)
    part_b = np.array([[True, False], [True, False]])
    cohort_b = np.array([[2, 0], [2, 0]], np.int32)
    got_b = tcore.ClientPool(SineTasks(), 8, sampler=sampler)\
        .sample_cohort_block(cohort_b, part_b, support=4)
    np.testing.assert_array_equal(got_a["x"][:, 0], got_b["x"][:, 0])
    assert not np.array_equal(got_a["x"][0, 0], got_a["x"][1, 0])
    assert (got_b["x"][:, 1] == 0).all() and (got_b["y"][:, 1] == 0).all()
    want = jcore.ClientPool(JSine(), 8, sampler=sampler)\
        .sample_cohort_block(cohort_a, part_a, support=4)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got_a[k], want[k])


def test_pool_validation():
    with pytest.raises(ValueError):
        tcore.ClientPool(SineTasks(), 0)
    with pytest.raises(IndexError):
        tcore.ClientPool(SineTasks(), 4).client_task(4)
    with pytest.raises(ValueError, match="buffer_size"):
        tcore.BufferedAggregation(0)
    with pytest.raises(ValueError, match="pool_size"):
        tcore.UniformSampling().plan_pool_schedule(
            np.random.default_rng(0), 0, 4, clients=8, budget=2,
            pool_size=4)
    with pytest.raises(ValueError, match="residency"):
        tcore.ClientPool(SineTasks(), 4, residency="disk")


def test_pool_host_state_round_trips():
    """host_state / load_host_state in both samplers' forms, and a
    snapshot of the other form is refused."""
    for sampler in ("reference", "vectorized"):
        pool = tcore.ClientPool(SineTasks(), 6, sampler=sampler)
        part = np.ones((2, 2), bool)
        cohort = np.array([[1, 4], [4, 0]], np.int32)
        pool.sample_cohort_block(cohort, part, 3)
        snap = pool.host_state()
        nxt = pool.sample_cohort_block(cohort, part, 3)
        fresh = tcore.ClientPool(SineTasks(), 6, sampler=sampler)
        fresh.load_host_state(snap)
        np.testing.assert_array_equal(
            fresh.sample_cohort_block(cohort, part, 3)["x"], nxt["x"])
        other = "vectorized" if sampler == "reference" else "reference"
        with pytest.raises(ValueError, match="snapshot"):
            tcore.ClientPool(SineTasks(), 6, sampler=other)\
                .load_host_state(snap)


# -- cohort seating, against the JAX package ----------------------------------

@pytest.mark.parametrize("policy,sampler,pool_size", [
    ("UniformSampling", "reference", 9),
    ("UniformSampling", "vectorized", 1000),   # the sparse rejection draw
    ("UniformSampling", "vectorized", 12),     # the dense choice draw
    ("PartialParticipation", "reference", 9),
    ("DiurnalAvailability", "reference", 40),
    ("DiurnalAvailability", "vectorized", 40),
    ("MarkovAvailability", "reference", 40),
    ("MarkovAvailability", "vectorized", 40),
])
def test_pool_schedules_match_jax_seat_for_seat(policy, sampler, pool_size):
    """plan_pool_schedule draws the host RNG in the JAX order: the same
    cohorts, participation, budgets and weights, block after block."""
    kw = {"PartialParticipation": dict(fraction=0.5)}.get(policy, {})
    tp = getattr(tcore, policy)(sampler=sampler, **kw)
    jp = getattr(jcore, policy)(sampler=sampler, **kw)
    tr, jr = np.random.default_rng(5), np.random.default_rng(5)
    for start, end in ((0, 7), (7, 11)):
        got = tp.plan_pool_schedule(tr, start, end, 4, 3, pool_size)
        want = jp.plan_pool_schedule(jr, start, end, 4, 3, pool_size)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        tpipe.seat_cohorts(np.random.default_rng(1), 500, 6, 5),
        jpipe.seat_cohorts(np.random.default_rng(1), 500, 6, 5))


# -- the pool state through the round -----------------------------------------

def _replay_pool_state(policy, seed, rounds, eval_every, max_block,
                       clients, budget, pool_size):
    """Host replay of the engine's planning: the last_seen, staleness and
    checkins the round must reproduce."""
    rng = np.random.default_rng(seed)
    last_seen = np.full(pool_size, -1, np.int64)
    staleness = np.zeros(pool_size, np.int64)
    checkins = np.zeros(pool_size, np.int64)
    for start, end in tpipe.plan_blocks(rounds, eval_every, max_block)[0]:
        plan = policy.plan_pool_schedule(rng, start, end, clients, budget,
                                         pool_size)
        for j, r in enumerate(range(start, end)):
            for c in range(clients):
                if plan["participation"][j, c]:
                    m = plan["cohort"][j, c]
                    staleness[m] = r - last_seen[m]
                    last_seen[m] = r
                    checkins[m] += 1
    return last_seen, staleness, checkins


@pytest.mark.parametrize("policy", [
    "UniformSampling", "PartialParticipation", "DiurnalAvailability"])
def test_pool_state_scan_matches_host_replay(init, policy):
    """The in-round gather and scatter of per-client state by cohort
    indices is exact against a host replay of the planned schedule,
    across uneven eval blocks; the JAX package's run gives the same
    params (1e-4), history, pool state and bills."""
    kw = {"PartialParticipation": dict(fraction=0.5),
          "DiurnalAvailability": dict(period=5)}.get(policy, {})
    args = dict(rounds=13, beta=0.02, support=4, seed=6, eval_every=5,
                eval_kwargs=EVAL, clients_per_round=3)
    out = _tiny(init, pool=tcore.ClientPool(SineTasks(), 7),
                sampling=getattr(tcore, policy)(**kw), **args)
    want = _replay_pool_state(getattr(tcore, policy)(**kw), seed=6,
                              rounds=13, eval_every=5, max_block=512,
                              clients=3, budget=4, pool_size=7)
    got = out["pool_state"]
    for k, w in zip(("last_seen", "staleness", "checkins"), want):
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    np.testing.assert_array_equal(out["per_client_bytes"],
                                  2 * PAYLOAD * want[2])
    assert out["comm_bytes"] == sum(out["per_client_bytes"])
    jout = jcore.tinyreptile_train(JLOSS, init, JSine(),
                                   pool=jcore.ClientPool(JSine(), 7),
                                   sampling=getattr(jcore, policy)(**kw),
                                   **args)
    assert_same_run(out, jout)
    _same_pool_state(got, jout["pool_state"])


def test_pooled_prefetch_parity(init):
    """Pipelined and synchronous pooled runs are bit for bit the same."""
    kw = dict(rounds=11, beta=0.02, support=4, seed=2, eval_every=4,
              eval_kwargs=EVAL, clients_per_round=3, epochs=2,
              sampling=tcore.PartialParticipation(0.5), device="cpu")
    sync = tcore.reptile_train(TLOSS, init, SineTasks(), prefetch=0,
                               pool=tcore.ClientPool(SineTasks(), 6), **kw)
    piped = tcore.reptile_train(TLOSS, init, SineTasks(), prefetch=2,
                                pool=tcore.ClientPool(SineTasks(), 6), **kw)
    for k in sync["params"]:
        assert torch.equal(sync["params"][k], piped["params"][k])
    assert sync["history"] == piped["history"]
    _same_pool_state(sync["pool_state"], piped["pool_state"])
    assert sync["per_client_bytes"] == piped["per_client_bytes"]


def test_staleness_under_partial_participation(init):
    policy = tcore.PartialParticipation(0.5)
    out = _tiny(init, rounds=16, beta=0.02, support=4, seed=3,
                clients_per_round=4, sampling=policy,
                pool=tcore.ClientPool(SineTasks(), 8))
    ps = out["pool_state"]
    assert ps["checkins"].sum() == 16 * policy.cohort(4)
    assert (ps["last_seen"] < 16).all()
    seen = ps["checkins"] > 0
    assert (ps["staleness"][seen] >= 1).all()
    assert ps["staleness"].max() > 1               # somebody skipped rounds


# -- FedBuff ------------------------------------------------------------------

def test_fedbuff_flush_cadence(init):
    """Full participation, cohort 3, threshold 4: a flush every 2 rounds,
    as in the JAX package's run (params 1e-4, pool state exact)."""
    args = dict(rounds=10, beta=0.02, support=4, seed=0,
                clients_per_round=3)
    out = _tiny(init, pool=tcore.ClientPool(SineTasks(), 6),
                buffered=tcore.BufferedAggregation(4), **args)
    assert out["pool_state"]["flushes"] == 5
    assert out["pool_state"]["buffered_pending"] == 0
    jout = jcore.tinyreptile_train(JLOSS, init, JSine(),
                                   pool=jcore.ClientPool(JSine(), 6),
                                   buffered=jcore.BufferedAggregation(4),
                                   **args)
    assert_same_run(out, jout)
    _same_pool_state(out["pool_state"], jout["pool_state"])


def test_fedbuff_phi_frozen_until_first_flush(init):
    out = _tiny(init, rounds=4, beta=0.02, support=4, seed=0,
                clients_per_round=2, pool=tcore.ClientPool(SineTasks(), 4),
                buffered=tcore.BufferedAggregation(100))
    assert out["pool_state"]["flushes"] == 0
    assert out["pool_state"]["buffered_pending"] == 8     # 4 rounds x 2
    _params_equal(out, init)
    assert out["pool_state"]["checkins"].sum() == 8


def test_fedbuff_flush_every_round_matches_unbuffered(init):
    """buffer_size == cohort: every round flushes its own arrivals at
    zero staleness, which is the unbuffered pooled run."""
    kw = dict(rounds=8, beta=0.02, support=4, seed=5, clients_per_round=3,
              eval_every=8, eval_kwargs=EVAL)
    plain = _tiny(init, pool=tcore.ClientPool(SineTasks(), 6), **kw)
    buff = _tiny(init, pool=tcore.ClientPool(SineTasks(), 6),
                 buffered=tcore.BufferedAggregation(3), **kw)
    assert buff["pool_state"]["flushes"] == 8
    for k in plain["params"]:
        np.testing.assert_allclose(plain["params"][k], buff["params"][k],
                                   rtol=1e-5, atol=1e-5)


def test_fedbuff_staleness_discount_weights():
    """Two buffered updates, one fresh and one 3 rounds stale, fold 2/3 :
    1/3, through the strategy's weighted aggregation on flat buffers."""
    w = default_staleness_weight(torch.tensor([0.0, 3.0]))
    np.testing.assert_allclose(w.numpy(), [1.0, 0.5])
    layout = FlatLayout.of({"w": torch.zeros(2)})
    phi = torch.zeros(2)
    buf = torch.tensor([[3.0, 3.0], [6.0, 6.0], [0.0, 0.0]])
    tau = (4 - torch.tensor([4, 1, 0])).float()
    w = default_staleness_weight(tau) * (torch.arange(3) < 2)
    w = w / w.sum()
    got = TinyReptileStrategy(TLOSS).server_aggregate_weighted(
        layout, phi, buf, torch.tensor([1.0]), 0.01, w)
    np.testing.assert_allclose(got.numpy(), [4.0, 4.0], rtol=1e-6)


def test_fedbuff_flush_staleness_deadline_of_one_degenerates(init):
    kw = dict(rounds=8, beta=0.02, support=4, seed=5, clients_per_round=3,
              eval_every=8, eval_kwargs=EVAL)
    by_count = _tiny(init, pool=tcore.ClientPool(SineTasks(), 6),
                     buffered=tcore.BufferedAggregation(3), **kw)
    by_deadline = _tiny(init, pool=tcore.ClientPool(SineTasks(), 6),
                        buffered=tcore.BufferedAggregation(
                            100, flush_staleness=1), **kw)
    assert by_deadline["pool_state"]["flushes"] == 8
    assert by_deadline["pool_state"]["buffered_pending"] == 0
    for k in by_count["params"]:
        np.testing.assert_allclose(by_count["params"][k],
                                   by_deadline["params"][k], rtol=1e-5,
                                   atol=1e-5)


def test_fedbuff_flush_staleness_bounds_buffer_age(init):
    """Cohort 1, deadline 3: one flush per 3 rounds (as the JAX package
    flushes); the count-only control never flushes and phi stays put."""
    args = dict(rounds=9, beta=0.02, support=4, seed=1, clients_per_round=1)
    out = _tiny(init, pool=tcore.ClientPool(SineTasks(), 4),
                buffered=tcore.BufferedAggregation(100, flush_staleness=3),
                **args)
    assert out["pool_state"]["flushes"] == 3
    assert out["pool_state"]["buffered_pending"] == 0
    jout = jcore.tinyreptile_train(
        JLOSS, init, JSine(), pool=jcore.ClientPool(JSine(), 4),
        buffered=jcore.BufferedAggregation(100, flush_staleness=3), **args)
    assert_same_run(out, jout)
    _same_pool_state(out["pool_state"], jout["pool_state"])
    held = _tiny(init, pool=tcore.ClientPool(SineTasks(), 4),
                 buffered=tcore.BufferedAggregation(100), **args)
    assert held["pool_state"]["flushes"] == 0
    assert held["pool_state"]["buffered_pending"] == 9
    _params_equal(held, init)


def test_fedbuff_flush_staleness_validation():
    with pytest.raises(ValueError, match="flush_staleness"):
        tcore.BufferedAggregation(4, flush_staleness=0)
    with pytest.raises(ValueError, match="flush_staleness"):
        tcore.BufferedAggregation(4, flush_staleness=1.5)
    assert tcore.BufferedAggregation(4, flush_staleness=2)\
        .flush_staleness == 2


def test_fedbuff_validation(init):
    with pytest.raises(ValueError, match="pool="):
        _tiny(init, rounds=2, buffered=tcore.BufferedAggregation(2))
    with pytest.raises(ValueError, match="uplink"):
        tcore.run_federated(init, SineTasks(),
                            tcore.TransferStrategy(TLOSS), rounds=2,
                            clients_per_round=2,
                            pool=tcore.ClientPool(SineTasks(), 4),
                            buffered=tcore.BufferedAggregation(2),
                            device="cpu")
    with pytest.raises(ValueError, match="cohort"):
        _tiny(init, rounds=2, clients_per_round=8,
              pool=tcore.ClientPool(SineTasks(), 4))


# -- availability -------------------------------------------------------------

def test_diurnal_availability_statistics():
    proc = tcore.DiurnalAvailability(period=10, base=0.5, amplitude=0.45)
    avail = proc.availability(np.random.default_rng(0), 0, 400,
                              pool_size=32)
    np.testing.assert_array_equal(avail, jcore.DiurnalAvailability(
        period=10).availability(np.random.default_rng(0), 0, 400, 32))
    rate = avail.mean(axis=1)
    assert rate[np.arange(400) % 10 == 2].mean() > 0.8      # peaks
    assert rate[np.arange(400) % 10 == 7].mean() < 0.15     # troughs
    spread = tcore.DiurnalAvailability(period=10, phase_spread=1.0)
    rate_s = spread.availability(np.random.default_rng(0), 0, 400,
                                 pool_size=32).mean(axis=1)
    assert rate_s.std() < rate.std()                # staggered -> flat
    with pytest.raises(ValueError):
        tcore.DiurnalAvailability(period=0)


def test_markov_availability_statistics():
    proc = tcore.MarkovAvailability(p_on=0.3, p_off=0.15)
    rng = np.random.default_rng(1)
    rows = np.concatenate([proc.availability(rng, 0, 300, 16),
                           proc.availability(rng, 300, 600, 16)])
    jproc, jrng = jcore.MarkovAvailability(p_on=0.3, p_off=0.15), \
        np.random.default_rng(1)
    np.testing.assert_array_equal(rows, np.concatenate(
        [jproc.availability(jrng, 0, 300, 16),
         jproc.availability(jrng, 300, 600, 16)]))
    assert proc.state_dict() == jproc.state_dict()
    stationary = 0.3 / 0.45
    np.testing.assert_allclose(rows.mean(), stationary, atol=0.05)
    agree = (rows[1:] == rows[:-1]).mean()
    assert agree > stationary ** 2 + (1 - stationary) ** 2 + 0.2
    with pytest.raises(RuntimeError, match="contiguous"):
        proc.availability(rng, 900, 920, 16)
    # a stashed chain resumes where it stopped
    state, resumed = proc.state_dict(), tcore.MarkovAvailability()
    rng2 = np.random.default_rng(7)
    resumed.load_state_dict(state, rng=rng2)
    nxt = resumed.availability(rng2, 600, 605, 16)
    assert nxt.shape == (5, 16)
    assert proc.availability(np.random.default_rng(9), 0, 5, 16).shape \
        == (5, 16)
    with pytest.raises(ValueError):
        tcore.MarkovAvailability(p_on=0.0)


def test_availability_requires_pool(init):
    with pytest.raises(ValueError, match="PERSISTENT"):
        _tiny(init, rounds=2, sampling=tcore.DiurnalAvailability())


class _NightOnly(tcore.DiurnalAvailability):
    def availability(self, rng, start, end, pool_size):
        rows = np.zeros((end - start, pool_size), bool)
        for r, rnd in enumerate(range(start, end)):
            if rnd % 2 == 0:                 # every other round: empty
                rows[r] = rng.uniform(size=pool_size) < 0.9
        return rows


class _JNightOnly(jcore.DiurnalAvailability):
    availability = _NightOnly.availability


@pytest.mark.parametrize("buffered", [False, True])
def test_no_show_rounds_are_noops(init, buffered):
    """Rounds where nobody checks in pass phi and the pool state through
    on the device, mid-block, billing nothing — as in the JAX package
    (a buffered run too: its staleness deadline must not flush on an
    idle round)."""
    args = dict(rounds=6, beta=0.02, support=4, seed=0, clients_per_round=2)
    tb = (dict(buffered=tcore.BufferedAggregation(8, flush_staleness=2))
          if buffered else {})
    jb = (dict(buffered=jcore.BufferedAggregation(8, flush_staleness=2))
          if buffered else {})
    out = _tiny(init, sampling=_NightOnly(period=2),
                pool=tcore.ClientPool(SineTasks(), 4), **args, **tb)
    ps = out["pool_state"]
    assert set(ps["last_seen"]) <= {-1, 0, 2, 4}    # odd rounds idle
    assert out["comm_bytes"] == 2 * PAYLOAD * ps["checkins"].sum()
    jout = jcore.tinyreptile_train(JLOSS, init, JSine(),
                                   sampling=_JNightOnly(period=2),
                                   pool=jcore.ClientPool(JSine(), 4),
                                   **args, **jb)
    assert_same_run(out, jout)
    _same_pool_state(ps, jout["pool_state"])


@pytest.mark.parametrize("sampler", ["reference", "vectorized"])
def test_host_residency_matches_device_residency(init, sampler):
    """residency="host" stages each block's identity rows from the host
    slabs and scatters them back: the same run as the device-resident
    pool, and the JAX package's host-resident run, exactly (pool state,
    bills) and within 1e-4 (params)."""
    args = dict(rounds=12, beta=0.02, support=4, seed=4, eval_every=5,
                eval_kwargs=EVAL, clients_per_round=4, prefetch=2)
    pol = dict(sampling=tcore.DiurnalAvailability(period=6,
                                                  sampler=sampler))
    dev_run = _tiny(init, pool=tcore.ClientPool(
        SineTasks(), 300, sampler=sampler), **args, **pol)
    host_run = _tiny(init, pool=tcore.ClientPool(
        SineTasks(), 300, sampler=sampler, residency="host"), **args, **pol)
    for k in dev_run["params"]:
        assert torch.equal(dev_run["params"][k], host_run["params"][k])
    _same_pool_state(dev_run["pool_state"], host_run["pool_state"])
    assert dev_run["per_client_bytes"] == host_run["per_client_bytes"]
    jout = jcore.tinyreptile_train(
        JLOSS, init, JSine(),
        pool=jcore.ClientPool(JSine(), 300, sampler=sampler,
                              residency="host"),
        sampling=jcore.DiurnalAvailability(period=6, sampler=sampler),
        **args)
    assert_same_run(host_run, jout)
    _same_pool_state(host_run["pool_state"], jout["pool_state"])


# -- the single-build contract and the runner cache ---------------------------

def test_pool_none_keeps_legacy_fast_path(init):
    """pool=None runs take the unscheduled runner (no pool state), with
    prefetch parity, built once."""
    tcore.clear_runner_cache()
    beta = 0.0807                       # unique config -> fresh runner
    kw = dict(rounds=9, beta=beta, support=4, seed=4, eval_every=9,
              eval_kwargs=EVAL)
    a = _tiny(init, prefetch=0, **kw)
    b = _tiny(init, prefetch=2, **kw)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    assert a["history"] == b["history"]
    assert "pool_state" not in a
    runner = tengine._block_runner(TinyReptileStrategy(TLOSS), beta,
                                   tcore.CommChannel(), scheduled=False)
    assert runner.trace_count == 1
    tcore.clear_runner_cache()


def test_pooled_runs_trace_once(init):
    """Pooled runs over uneven eval blocks build one round per config;
    pooled, buffered and flat scheduled runners are separate entries,
    counted by runner_cache_stats."""
    tcore.clear_runner_cache()
    beta = 0.0909
    kw = dict(rounds=13, beta=beta, support=4, seed=3, eval_every=5,
              eval_kwargs=EVAL, clients_per_round=3)
    _tiny(init, pool=tcore.ClientPool(SineTasks(), 6), **kw)
    strat = TinyReptileStrategy(TLOSS)
    pooled = tengine._block_runner(strat, beta, tcore.CommChannel(),
                                   scheduled=True, pooled=True,
                                   masked=False)
    assert pooled.trace_count == 1
    _tiny(init, pool=tcore.ClientPool(SineTasks(), 6),
          buffered=tcore.BufferedAggregation(4), **kw)
    buffed = tengine._block_runner(strat, beta, tcore.CommChannel(),
                                   scheduled=True, pooled=True,
                                   buffered=tcore.BufferedAggregation(4),
                                   masked=False)
    assert buffed is not pooled
    assert buffed.trace_count == 1 and pooled.trace_count == 1
    flat = tengine._block_runner(strat, beta, tcore.CommChannel(),
                                 scheduled=True)
    assert flat is not pooled
    stats = tcore.runner_cache_stats()
    assert stats["pooled_entries"] == 2 and stats["buffered_entries"] == 1
    tcore.clear_runner_cache()


def test_pool_state_is_a_dataclass_of_tensors():
    pool = tcore.ClientPool(SineTasks(), 4)
    ps = pool.init_state(torch.zeros(5), 2, device="cpu")
    assert isinstance(ps, PoolState) and ps.buf_updates is None
    assert ps.last_seen.dtype == torch.int32
    assert ps.last_seen.tolist() == [-1] * 4
    buf = pool.init_state(torch.zeros(5), 2, tcore.BufferedAggregation(3),
                          device="cpu")
    assert tuple(buf.buf_updates.shape) == (4, 5)      # 3 + 2 - 1 slots
    assert buf.buf_round.shape == (4,) and int(buf.buf_count) == 0


# -- the launcher and the KWS example -----------------------------------------

@pytest.mark.parametrize("argv", [
    ["--strategy", "reptile", "--rounds", "6", "--clients", "4",
     "--pool-size", "40", "--availability", "diurnal", "--buffer-size", "6"],
    ["--strategy", "fedavg", "--rounds", "5", "--clients", "4",
     "--pool-size", "2000", "--pool-sampler", "vectorized",
     "--pool-residency", "host", "--participation", "0.5"],
])
def test_fleet_row_matches_the_jax_launcher(init, argv, capsys):
    """The launcher's fleet flags against the JAX launcher's, from the
    JAX package's init at seed 0: comm_mb exact, query_loss within one
    unit of its 4th place."""
    jtrain.run_engine_strategy(jtrain.parse_args(argv))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, out = ttrain.run_engine_strategy(
        ttrain.parse_args(argv + ["--device", "cpu"]), init_params=init)
    assert got["comm_mb"] == want["comm_mb"]
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12
    assert "pool_state" in out


def test_kws_example_runs_the_persistent_fleet(capsys):
    from repro_torch.examples import federated_keyword_spotting as kws
    out = kws.main(["--rounds", "3", "--device", "cpu", "--pool-size", "20",
                    "--availability", "markov", "--buffer-size", "4"])
    text = capsys.readouterr().out
    fleet = out["fleet"]
    ps = fleet["pool_state"]
    assert len(fleet["per_client_bytes"]) == 20
    assert fleet["comm_bytes"] == 2 * 82_448 * int(ps["checkins"].sum())
    assert ps["flushes"] >= 1 and 0 <= ps["buffered_pending"] < 4 + 8
    assert "persistent fleet: pool of 20, markov check-ins, FedBuff K=4" \
        in text
    assert "staleness" in text and "buffer flushes" in text

