"""Preemption-safe federated runs in the port: a run killed after a
snapshot and resumed lands bit for bit on the run that was never killed.

The port's counterpart of ``tests/test_preempt_resume.py``, at its sizes
(8 rounds, 3 clients, support 6, a snapshot every 4 rounds), on the CPU.
``run_federated(ckpt_dir=...)`` snapshots the whole carry (phi, the
``PoolState`` with its FedBuff buffer, the host RNG and the policy's
chain, the bills, the history) and ``resume=True`` restores it, so the
resumed run's params, history rows, pool state and integer bills equal
the uninterrupted run's exactly. The files are the JAX package's, so a
snapshot of either package resumes in the other: the integer state
exactly, fp32 params within the engine parity tests' 1e-4.
"""
import functools
import logging
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.models.paper_nets import init_paper_model as j_init  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro.models.paper_nets import relu_mlp_loss as j_relu  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import list_checkpoints  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402
from repro_torch.models.paper_nets import relu_mlp_loss  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = functools.partial(paper_model_loss, SINE_MLP)
JLOSS = functools.partial(j_loss, J_SINE)
EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.02, query=8)
TIFED_EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.01, query=8)
BASE = dict(rounds=8, beta=0.02, support=6, seed=5, clients_per_round=3,
            eval_every=4, eval_kwargs=EVAL)
TOL = 1e-4


@pytest.fixture(scope="module")
def init():
    return {k: np.asarray(v)
            for k, v in j_init(J_SINE, jax.random.PRNGKey(0)).items()}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_same(ref, res, tag, tol=0.0, hist_tol=None):
    """Params (exactly, or within ``tol`` across packages), history rows
    through ``==`` (they went through JSON: float repr round-trips) or
    their floats within ``hist_tol`` (default ``tol``), bills and pool
    state exactly."""
    hist_tol = tol if hist_tol is None else hist_tol
    assert set(ref["params"]) == set(res["params"]), tag
    for k in ref["params"]:
        a, b = _np(ref["params"][k]), _np(res["params"][k])
        assert a.dtype == b.dtype, (tag, k)
        if tol:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=f"{tag}:{k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag}:{k}")
    assert len(ref["history"]) == len(res["history"]), tag
    for ra, rb in zip(ref["history"], res["history"]):
        assert set(ra) == set(rb), tag
        for k in ra:
            if hist_tol and k not in ("round", "comm_bytes"):
                assert abs(float(ra[k]) - float(rb[k])) <= hist_tol * max(
                    1.0, abs(float(ra[k]))), (tag, k, ra[k], rb[k])
            else:
                assert float(ra[k]) == float(rb[k]), (tag, k, ra[k], rb[k])
    for k in ("comm_bytes", "per_client_bytes"):
        assert (k in ref) == (k in res), (tag, k)
        if k in ref:
            assert list(np.ravel(ref[k])) == list(np.ravel(res[k])), (tag, k)
    assert ("pool_state" in ref) == ("pool_state" in res), tag
    for k in ref.get("pool_state", {}):
        a = np.asarray(ref["pool_state"][k])
        b = np.asarray(res["pool_state"][k])
        assert a.dtype == b.dtype, (tag, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{tag}:{k}")


def crash_resume(make_run, crash_round, tag, d):
    """The uninterrupted run, then a run crashed right after the
    snapshot at ``crash_round`` and a resume of it; returns both."""
    ref = make_run()
    ck = dict(ckpt_dir=str(d), ckpt_every=4)
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(crash_round):
            make_run(ckpt_async=False, **ck)
    res = make_run(resume=True, **ck)
    assert_same(ref, res, tag)
    return ref, res


def _strategy(name):
    return {
        "tinyreptile": lambda: (tstrat.TinyReptileStrategy(LOSS), {}),
        "reptile": lambda: (tstrat.ReptileStrategy(LOSS, epochs=2), {}),
        "fedavg": lambda: (tstrat.FedAvgStrategy(LOSS, epochs=2), {}),
        "fedsgd": lambda: (tstrat.FedSGDStrategy(LOSS), {}),
        "transfer": lambda: (tstrat.TransferStrategy(LOSS), {}),
        # TIFeD at alpha 1 annealed: int8 codes and an int8 bill
        "tifed": lambda: (tstrat.TifedStrategy(relu_mlp_loss, epochs=8),
                          dict(beta=0.0, support=16, eval_kwargs=TIFED_EVAL,
                               channel=tcore.CommChannel("int8",
                                                         quantize=False))),
    }[name]()


@pytest.mark.parametrize("name", ["tinyreptile", "reptile", "fedavg",
                                  "fedsgd", "transfer", "tifed"])
def test_crash_resume_parity_all_six_strategies(init, name, tmp_path):
    strategy, over = _strategy(name)
    kw = dict(BASE, **over)

    def make_run(**extra):
        return tcore.run_federated(init, SineTasks(), strategy, **kw,
                                   device="cpu", **extra)

    crash_resume(make_run, 4, name, tmp_path)


POOL_CASES = {
    "buffered_markov": lambda s: dict(
        pool=tcore.ClientPool(SineTasks(), 16, seed=7, sampler=s),
        buffered=tcore.BufferedAggregation(buffer_size=3),
        sampling=tcore.MarkovAvailability(sampler=s)),
    "diurnal": lambda s: dict(
        pool=tcore.ClientPool(SineTasks(), 12, seed=11, sampler=s),
        sampling=tcore.DiurnalAvailability(period=6, sampler=s)),
    "buffered_diurnal_deadline": lambda s: dict(
        pool=tcore.ClientPool(SineTasks(), 12, seed=3, sampler=s),
        buffered=tcore.BufferedAggregation(buffer_size=4,
                                           flush_staleness=2),
        sampling=tcore.DiurnalAvailability(period=6, sampler=s)),
    "plain": lambda s: dict(
        pool=tcore.ClientPool(SineTasks(), 10, seed=2, sampler=s)),
}


@pytest.mark.parametrize("residency", ["device", "host"])
@pytest.mark.parametrize("sampler", ["reference", "vectorized"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_crash_resume_pool_buffered_availability(init, case, sampler,
                                                 residency, tmp_path):
    """The snapshot carries the pool state (identity arrays, the FedBuff
    buffer and its counters), the per-client streams and the Markov
    chain; fresh pool and policy objects every run, so the host state
    comes from the snapshot alone."""
    kw = dict(BASE, rounds=12, clients_per_round=4)

    def make_run(**extra):
        fleet = POOL_CASES[case](sampler)
        fleet["pool"] = tcore.ClientPool(
            SineTasks(), fleet["pool"].size, seed=fleet["pool"].seed,
            sampler=sampler, residency=residency)
        return tcore.run_federated(init, SineTasks(),
                                   tstrat.TinyReptileStrategy(LOSS), **kw,
                                   **fleet, device="cpu", **extra)

    ref, _ = crash_resume(make_run, 4, f"{case}-{sampler}-{residency}",
                          tmp_path)
    assert ref["pool_state"]["checkins"].sum() > 0


def test_crash_resume_tifed_pooled_buffered(init, tmp_path):
    """TIFeD's int8 buffer slabs and int32 biases ride the snapshot and
    restore without a cast."""
    strategy, over = _strategy("tifed")
    kw = dict(BASE, **over, rounds=12, clients_per_round=4)

    def make_run(**extra):
        return tcore.run_federated(
            init, SineTasks(), strategy, **kw, device="cpu",
            pool=tcore.ClientPool(SineTasks(), 16, seed=7),
            buffered=tcore.BufferedAggregation(buffer_size=3),
            sampling=tcore.MarkovAvailability(), **extra)

    ref, _ = crash_resume(make_run, 8, "tifed-pooled", tmp_path)
    assert ref["pool_state"]["flushes"] >= 1


_CHILD = """
import functools, sys
import numpy as np
from repro_torch import core
from repro_torch.configs.paper_models import SINE_MLP
from repro_torch.core.strategies import TinyReptileStrategy
from repro_torch.data import SineTasks
from repro_torch.models.paper_nets import paper_model_loss
from repro_torch.testing import faults
init = dict(np.load(sys.argv[2]))
loss = functools.partial(paper_model_loss, SINE_MLP)
with faults.announce_snapshots():
    core.run_federated(init, SineTasks(), TinyReptileStrategy(loss),
                       rounds=16, beta=0.02, support=6, seed=5,
                       clients_per_round=3, eval_every=4,
                       eval_kwargs=dict(num_tasks=2, support=4, k_steps=2,
                                        lr=0.02, query=8),
                       ckpt_dir=sys.argv[1], ckpt_every=4, device="cpu")
"""


def test_real_sigkill_resume(init, tmp_path):
    """A real preemption: the child announces each durable snapshot and
    is SIGKILLed right after the first, its async writer live; this
    process resumes from whatever is on disk and lands on the
    uninterrupted run."""
    d = tmp_path / "ck"
    np.savez(tmp_path / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    rc, out = faults.kill_after_snapshot(
        [sys.executable, "-c", _CHILD, str(d), str(tmp_path / "init.npz")],
        n=1, env=env, cwd=REPO, timeout=300)
    assert rc != 0, "the child survived the kill"
    assert faults.SNAPSHOT_TAG in out
    assert list_checkpoints(str(d))
    kw = dict(BASE, rounds=16, device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    ref = tcore.run_federated(init, SineTasks(), strategy, **kw)
    res = tcore.run_federated(init, SineTasks(), strategy, ckpt_dir=str(d),
                              ckpt_every=4, resume=True, **kw)
    assert_same(ref, res, "sigkill")


def test_resume_past_original_horizon(init, tmp_path):
    """A larger ``rounds`` on resume keeps going: snapshots at rounds=6,
    resumed to 10, equal to a fresh 10-round run (no annealing: an
    annealed alpha depends on the horizon)."""
    kw = dict(beta=0.02, support=6, seed=5, eval_every=2, eval_kwargs=EVAL,
              anneal=False, device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    d = str(tmp_path)
    tcore.run_federated(init, SineTasks(), strategy, rounds=6, ckpt_dir=d,
                        ckpt_every=2, ckpt_async=False, **kw)
    res = tcore.run_federated(init, SineTasks(), strategy, rounds=10,
                              ckpt_dir=d, ckpt_every=2, resume=True, **kw)
    fresh = tcore.run_federated(init, SineTasks(), strategy, rounds=10,
                                **kw)
    assert_same(fresh, res, "past-horizon")


def test_resume_at_horizon_is_noop(init, tmp_path):
    """Resuming a finished run returns its saved state and runs no
    block."""
    kw = dict(rounds=4, beta=0.02, support=6, seed=5, eval_every=2,
              eval_kwargs=EVAL, device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    out1 = tcore.run_federated(init, SineTasks(), strategy,
                               ckpt_dir=str(tmp_path), ckpt_every=2,
                               ckpt_async=False, **kw)
    tcore.clear_runner_cache()
    out2 = tcore.run_federated(init, SineTasks(), strategy,
                               ckpt_dir=str(tmp_path), ckpt_every=2,
                               resume=True, **kw)
    assert_same(out1, out2, "at-horizon")
    assert tcore.runner_cache_stats()["currsize"] in (0, 1)
    (runner,) = tcore.engine._RUNNER_CACHE._entries.values()
    assert runner.trace_count == 0


def test_resume_fingerprint_mismatch_rejected(init, tmp_path):
    kw = dict(rounds=4, beta=0.02, support=6, eval_every=2,
              eval_kwargs=EVAL, device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    tcore.run_federated(init, SineTasks(), strategy, seed=5,
                        ckpt_dir=str(tmp_path), ckpt_every=2,
                        ckpt_async=False, **kw)
    with pytest.raises(ValueError, match="different run config"):
        tcore.run_federated(init, SineTasks(), strategy, seed=99,
                            ckpt_dir=str(tmp_path), ckpt_every=2,
                            resume=True, **kw)


def test_resume_shrunk_horizon_rejected(init, tmp_path):
    kw = dict(beta=0.02, support=6, seed=5, eval_every=2, eval_kwargs=EVAL,
              device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    tcore.run_federated(init, SineTasks(), strategy, rounds=8,
                        ckpt_dir=str(tmp_path), ckpt_every=2,
                        ckpt_async=False, **kw)
    with pytest.raises(ValueError, match="past rounds=4"):
        tcore.run_federated(init, SineTasks(), strategy, rounds=4,
                            ckpt_dir=str(tmp_path), ckpt_every=2,
                            resume=True, **kw)


def test_resume_empty_dir_starts_fresh(init, tmp_path, caplog):
    """``resume=True`` on a directory with no snapshot is a logged fresh
    start: the first launch of a preemptible job."""
    kw = dict(rounds=4, beta=0.02, support=6, seed=5, eval_every=2,
              eval_kwargs=EVAL, device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    ref = tcore.run_federated(init, SineTasks(), strategy, **kw)
    with caplog.at_level(logging.INFO, "repro_torch.core.engine"):
        res = tcore.run_federated(init, SineTasks(), strategy,
                                  ckpt_dir=str(tmp_path), ckpt_every=2,
                                  ckpt_async=False, resume=True, **kw)
    assert any("fresh" in r.message for r in caplog.records)
    assert_same(ref, res, "empty-dir")


@pytest.mark.parametrize("bad,match", [
    (dict(ckpt_every=0), "ckpt_every"),
    (dict(ckpt_every=2.0), "ckpt_every"),
    (dict(ckpt_keep=0), "ckpt_keep"),
    (dict(resume=True, ckpt_dir=None), "needs ckpt_dir"),
])
def test_ckpt_argument_validation(init, bad, match, tmp_path):
    kw = dict(dict(ckpt_dir=str(tmp_path)), **bad)
    with pytest.raises(ValueError, match=match):
        tcore.run_federated(init, SineTasks(),
                            tstrat.TinyReptileStrategy(LOSS), rounds=2,
                            beta=0.02, support=6, seed=5, device="cpu",
                            **kw)
    assert not os.listdir(tmp_path)


def test_corrupt_newest_snapshot_resumes_from_older(init, tmp_path, caplog):
    """The newest snapshot corrupted: resume falls back to the one
    before it (with a warning) and still lands on the uninterrupted
    run."""
    kw = dict(rounds=12, beta=0.02, support=6, seed=5, eval_every=4,
              eval_kwargs=EVAL, device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    ref = tcore.run_federated(init, SineTasks(), strategy, **kw)
    d = str(tmp_path)
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(8):
            tcore.run_federated(init, SineTasks(), strategy, ckpt_dir=d,
                                ckpt_every=4, ckpt_async=False, **kw)
    faults.flip_bytes(list_checkpoints(d)[-1])
    with caplog.at_level(logging.WARNING, "repro_torch.checkpoint.ckpt"):
        res = tcore.run_federated(init, SineTasks(), strategy, ckpt_dir=d,
                                  ckpt_every=4, resume=True, **kw)
    assert any("falling back" in r.message for r in caplog.records)
    assert_same(ref, res, "corrupt-newest")


def test_async_snapshot_survives_the_next_block(init, tmp_path):
    """The async writer reads clones, not the runner's buffers: with a
    snapshot every round and blocks that follow at once, each file holds
    the phi of its own round (held against a run that stops there)."""
    kw = dict(beta=0.02, support=6, seed=5, clients_per_round=3,
              device="cpu")
    strategy = tstrat.TinyReptileStrategy(LOSS)
    d = str(tmp_path)
    tcore.run_federated(init, SineTasks(), strategy, rounds=6, ckpt_dir=d,
                        ckpt_every=1, ckpt_keep=6, anneal=False, **kw)
    from repro_torch.checkpoint import load_params
    for path in list_checkpoints(d):
        step = int(os.path.basename(path)[5:13])
        want = tcore.run_federated(init, SineTasks(), strategy,
                                   rounds=step, anneal=False, **kw)
        got = load_params(path, {k: v.numpy() for k, v in
                                 want["params"].items()})
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# across packages: a snapshot of either package resumes in the other

def _cross_cases():
    return {
        "tinyreptile": (
            lambda: jstrat.TinyReptileStrategy(JLOSS, use_pallas=False),
            lambda: tstrat.TinyReptileStrategy(LOSS), {}, {}),
        "tifed_pooled_buffered": (
            lambda: jstrat.TifedStrategy(j_relu, epochs=8,
                                         use_pallas=False),
            lambda: tstrat.TifedStrategy(relu_mlp_loss, epochs=8),
            dict(beta=0.0, support=16, eval_kwargs=TIFED_EVAL,
                 clients_per_round=4, rounds=12),
            dict(pool=(jcore.ClientPool, tcore.ClientPool, 16, 7),
                 buffered=3, markov=True, int8=True)),
    }


def _fleet(side, spec):
    """The fleet keywords of ``spec`` for side 0 (JAX) or 1 (port), fresh
    objects each run."""
    pkg = (jcore, tcore)[side]
    dist = (JSine, SineTasks)[side]()
    out = {}
    if "pool" in spec:
        cls, size, seed = spec["pool"][side], spec["pool"][2], \
            spec["pool"][3]
        out["pool"] = cls(dist, size, seed=seed)
    if spec.get("buffered"):
        out["buffered"] = pkg.BufferedAggregation(spec["buffered"])
    if spec.get("markov"):
        out["sampling"] = pkg.MarkovAvailability()
    if spec.get("int8"):
        out["channel"] = pkg.CommChannel("int8", quantize=False)
    return dist, out


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("case", ["tinyreptile", "tifed_pooled_buffered"])
def test_cross_package_resume(init, case, direction, tmp_path):
    """One package crashed right after its round-4 snapshot
    (``ckpt_async=False``), the other resumes from that snapshot: the
    result equals the resuming package's own uninterrupted run, TIFeD's
    integer params, the pool state and the bills exactly, fp32 params
    within 1e-4."""
    jmake, tmake, over, spec = _cross_cases()[case]
    kw = dict(BASE, **over)

    def jrun(**extra):
        dist, fleet = _fleet(0, spec)
        return jcore.run_federated(init, dist, jmake(), **kw, **fleet,
                                   **extra)

    def trun(**extra):
        dist, fleet = _fleet(1, spec)
        return tcore.run_federated(init, dist, tmake(), **kw, **fleet,
                                   device="cpu", **extra)

    ck = dict(ckpt_dir=str(tmp_path), ckpt_every=4)
    first, then = (jrun, trun) if direction == "jax_to_torch" else \
        (trun, jrun)
    crash = (jfaults if first is jrun else faults)
    with pytest.raises(crash.SimulatedPreemption):
        with crash.crash_at_round(4):
            first(ckpt_async=False, **ck)
    res = then(resume=True, **ck)
    ref = then()
    # TIFeD's params are integer grids: exact across packages; the eval
    # rows (fp32 finetuning) within 1e-4 wherever a package's row is in
    tol = 0.0 if case.startswith("tifed") else TOL
    assert_same(ref, res, f"{case}-{direction}", tol=tol, hist_tol=TOL)
    assert_same(first(), res, f"{case}-{direction}-vs-writer", tol=tol,
                hist_tol=TOL)


def test_crash_and_resume_build_the_round_once(init, tmp_path):
    """A run, its crash and its resume in one process find the same
    program: ``pad`` depends on ``ckpt_every`` but not on the start."""
    tcore.clear_runner_cache()
    strategy = tstrat.TinyReptileStrategy(LOSS)

    def make_run(d, **extra):
        return tcore.run_federated(init, SineTasks(), strategy, **BASE,
                                   device="cpu", ckpt_dir=str(d),
                                   ckpt_every=4, **extra)

    ref = make_run(tmp_path / "ref")
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(4):
            make_run(tmp_path / "ck", ckpt_async=False)
    assert_same(ref, make_run(tmp_path / "ck", resume=True), "one-build")
    (runner,) = tcore.engine._RUNNER_CACHE._entries.values()
    assert runner.trace_count == 1 and len(runner._programs) == 1


@pytest.mark.parametrize("args", [
    (8, 4, 512, 0, 4), (8, 4, 512, 4, 4), (12, 0, 512, 0, 5),
    (12, 0, 512, 5, 5), (10, 3, 2, 7, 4), (24, 24, 512, 16, 4),
    (16, 16, 512, 16, 4), (6, 0, 512, 0, 0), (6, 2, 4, 3, 0)])
def test_plan_blocks_from_a_start_matches_jax(args):
    """Resume plans: cuts at absolute rounds, one pad whatever the
    start, as the JAX package plans them."""
    from repro.core.pipeline import plan_blocks as jplan
    rounds, eval_every, max_block, start, ckpt_every = args
    kw = dict(start=start, ckpt_every=ckpt_every)
    got = tcore.plan_blocks(rounds, eval_every, max_block, **kw)
    assert got == jplan(rounds, eval_every, max_block, **kw)
    if start < rounds:
        assert got[1] == tcore.plan_blocks(rounds, eval_every, max_block,
                                           ckpt_every=ckpt_every)[1]
