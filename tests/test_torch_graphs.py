"""Built once, run many times: the port's block runner and serving tick,
held against the JAX package's compile-once runner and server.

On the CPU the runner's round and the server's tick run as they are:
the very functions the card captures as CUDA graphs
(tests/test_torch_cuda.py holds the replays to them there). Both
packages get the same init (the JAX package's ``init_paper_model``,
carried across as NumPy) and the same seeded requests and host RNG, so
params and history agree to float rounding (1e-4; one fp16 step, 2^-10
relative, on the fp16 wire), bytes and integers exactly, and TIFeD
weights exactly, as in tests/test_torch_engine.py and
tests/test_torch_serving.py.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.core.strategies import tifed_requantize  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.models.paper_nets import init_paper_model as j_init  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.metering import MetricsTracker  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402
from repro_torch.serving import (AdaptationServer, Fp32Adapter,  # noqa: E402
                                 TifedAdapter)

JLOSS = functools.partial(j_loss, J_SINE)
TLOSS = functools.partial(paper_model_loss, SINE_MLP)
EVAL = dict(num_tasks=4, support=8, k_steps=4, lr=0.02, query=16)
TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def init():
    return {k: np.asarray(v)
            for k, v in j_init(J_SINE, jax.random.PRNGKey(0)).items()}


def _both(name, init, jkw=None, tkw=None, **kw):
    jout = getattr(jcore, name)(JLOSS, init, JSine(), **kw, **(jkw or {}))
    tout = getattr(tcore, name)(TLOSS, init, SineTasks(), device="cpu",
                                **kw, **(tkw or {}))
    return jout, tout


def assert_same_run(got, want, rtol=TOL, atol=TOL):
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert got.get("comm_bytes") == want.get("comm_bytes")
    assert got.get("per_client_bytes") == want.get("per_client_bytes")
    assert len(got["history"]) == len(want["history"])
    for ge, we in zip(got["history"], want["history"]):
        assert set(ge) == set(we), (ge, we)
        for k, v in we.items():
            if isinstance(v, (int, np.integer)):
                assert ge[k] == v, (k, ge[k], v)
            else:
                np.testing.assert_allclose(ge[k], v, rtol=rtol, atol=atol,
                                           err_msg=k)


def _only_runner():
    (runner,) = engine._RUNNER_CACHE._entries.values()
    return runner


# uneven blocks, as tests/test_pipeline.py cuts them: 17 rounds at
# eval_every=7 (blocks 7, 7, 3, all padded to 7) and 21 rounds at
# max_block=8 (blocks 8, 8, 5)
BLOCKS = {"17_rounds_eval_7": dict(rounds=17, eval_every=7),
          "21_rounds_max_block_8": dict(rounds=21, max_block=8)}
ROUTES = {
    "tinyreptile": ("tinyreptile_train", dict(support=6), {}),
    "reptile_c3": ("reptile_train",
                   dict(support=6, epochs=3, clients_per_round=3), {}),
    "fedavg_c3": ("fedavg_train",
                  dict(support=6, epochs=3, clients_per_round=3), {}),
    "fedsgd_c3": ("fedsgd_train", dict(support=6, clients_per_round=3), {}),
    "transfer": ("transfer_train",
                 dict(batch_per_round=12, tasks_per_round=4), {}),
    "tinyreptile_straggler_c4": (
        "tinyreptile_train", dict(support=6, clients_per_round=4),
        {"sampling": ("StragglerSampling", 0.5)}),
}


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_runner_route_matches_jax_at_uneven_blocks(init, route, blocks):
    """Each strategy and the straggler schedule through the runner, with
    a last block shorter than the pad, against the JAX run_federated;
    one build of the round for the whole run."""
    name, kw, policy = ROUTES[route]
    jkw, tkw = {}, {}
    if policy:
        cls, arg = policy["sampling"]
        jkw["sampling"] = getattr(jcore, cls)(arg)
        tkw["sampling"] = getattr(tcore, cls)(arg)
    tcore.clear_runner_cache()
    jout, tout = _both(name, init, jkw, tkw, beta=0.02, seed=21,
                       eval_kwargs=EVAL, **BLOCKS[blocks], **kw)
    assert_same_run(tout, jout)
    assert _only_runner().trace_count == 1


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_runner_route_matches_jax_on_quantized_wires(init, dtype):
    """The simulated fp16 and int8 wires inside the round, at uneven
    blocks; the fp16 wire within one fp16 step (tests/test_torch_engine.py
    gives the reason)."""
    tcore.clear_runner_cache()
    jout, tout = _both("tinyreptile_train", init,
                       jkw=dict(channel=jcore.CommChannel(dtype)),
                       tkw=dict(channel=tcore.CommChannel(dtype)),
                       beta=0.02, support=6, seed=22, eval_kwargs=EVAL,
                       **BLOCKS["17_rounds_eval_7"])
    assert_same_run(tout, jout,
                    rtol=2 ** -10 if dtype == "float16" else TOL)
    assert tout["comm_bytes"] == 17 * 2 * 1153 * {"float16": 2,
                                                  "int8": 1}[dtype]
    assert _only_runner().trace_count == 1


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_one_build_per_config_across_runs(init, blocks):
    """tests/test_pipeline.py's single-trace checks: two runs of one
    config (other seeds) build the round once, and the second run is a
    cache hit whose params equal a fresh runner's exactly."""
    tcore.clear_runner_cache()
    beta = 0.021
    kw = dict(alpha=1.0, beta=beta, support=4, eval_kwargs=EVAL,
              device="cpu", **BLOCKS[blocks])
    tcore.tinyreptile_train(TLOSS, init, SineTasks(), seed=3, **kw)
    runner = engine._block_runner(tcore.TinyReptileStrategy(TLOSS), beta,
                                  tcore.CommChannel())
    assert runner.trace_count == 1
    again = tcore.tinyreptile_train(TLOSS, init, SineTasks(), seed=4, **kw)
    assert runner.trace_count == 1
    assert len(runner._programs) == 1
    tcore.clear_runner_cache()
    fresh = tcore.tinyreptile_train(TLOSS, init, SineTasks(), seed=4, **kw)
    for k in fresh["params"]:
        assert torch.equal(again["params"][k], fresh["params"][k])
    assert again["history"] == fresh["history"]


def test_returned_params_outlive_the_runner_buffers(init):
    """A run's params are its own: a later run of the same config, which
    reuses the runner's phi buffer, leaves them as they were."""
    tcore.clear_runner_cache()
    kw = dict(rounds=6, beta=0.02, support=4, device="cpu")
    first = tcore.tinyreptile_train(TLOSS, init, SineTasks(), seed=1, **kw)
    kept = {k: v.clone() for k, v in first["params"].items()}
    tcore.tinyreptile_train(TLOSS, init, SineTasks(), seed=2, **kw)
    for k, v in kept.items():
        assert torch.equal(first["params"][k], v)


def test_runner_cache_stats_and_clear(init, caplog):
    """tests/test_pipeline.py's cache checks: a miss then a hit for one
    config, an unhashable strategy counted and logged, clear resets."""
    tcore.clear_runner_cache()
    stats = tcore.runner_cache_stats()
    assert stats["currsize"] == 0 and stats["unhashable_misses"] == 0
    assert stats["maxsize"] == 64

    kw = dict(rounds=5, alpha=1.0, beta=0.0703, support=4, seed=0,
              device="cpu")
    tcore.tinyreptile_train(TLOSS, init, SineTasks(), **kw)
    tcore.tinyreptile_train(TLOSS, init, SineTasks(), **kw)
    stats = tcore.runner_cache_stats()
    assert stats["misses"] == 1 and stats["hits"] == 1
    assert stats["currsize"] == 1

    @dataclasses.dataclass(frozen=True)
    class UnhashableStrategy(tcore.TinyReptileStrategy):
        junk: list = dataclasses.field(default_factory=list)

    with caplog.at_level("WARNING", logger="repro_torch.core.engine"):
        out = tcore.run_federated(init, SineTasks(),
                                  UnhashableStrategy(TLOSS), rounds=5,
                                  beta=0.0703, support=4, seed=0,
                                  device="cpu")
    assert tcore.runner_cache_stats()["unhashable_misses"] == 1
    assert tcore.runner_cache_stats()["currsize"] == 1
    assert any("unhashable" in r.message for r in caplog.records)
    cached = tcore.tinyreptile_train(TLOSS, init, SineTasks(), **kw)
    for k in out["params"]:
        assert torch.equal(out["params"][k], cached["params"][k])

    tcore.clear_runner_cache()
    stats = tcore.runner_cache_stats()
    assert stats["currsize"] == 0 and stats["unhashable_misses"] == 0
    assert stats["hits"] == 0 and stats["misses"] == 0


def test_runner_lru_evicts_the_least_recently_used():
    lru = engine._RunnerLRU(maxsize=2)
    built = []

    def build(k):
        return lambda: built.append(k) or k

    for k in ("a", "b", "a", "c", "b"):
        lru.get(k, build(k))
    assert built == ["a", "b", "c", "b"]     # b was evicted by c
    assert lru.keys() == ["c", "b"]
    assert (lru.hits, lru.misses) == (1, 4)
    with pytest.raises(TypeError):
        lru.get(["unhashable"], build("x"))


def test_tracker_gets_the_runner_cache_gauges(init):
    """tests/test_metrics.py's run-end gauges: the wall clock and the
    runner cache's counters."""
    tcore.clear_runner_cache()
    tracker = MetricsTracker()
    tcore.reptile_train(TLOSS, init, SineTasks(), rounds=4, support=4,
                        epochs=2, clients_per_round=2, tracker=tracker,
                        device="cpu")
    assert tracker.gauges["engine.wall_s"] > 0
    stats = tcore.runner_cache_stats()
    assert {k: tracker.gauges[f"runner_cache.{k}"] for k in stats} == {
        k: float(v) for k, v in stats.items()}
    assert tracker.gauges["runner_cache.misses"] == 1.0


# ---------------------------------------------------------------------------
# the serving tick: a fixed B-row refill, one build per server
# ---------------------------------------------------------------------------

def _requests(n, support, query, ks, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        a, b = rng.uniform(0.1, 5.0), rng.uniform(0.0, np.pi)
        sx = rng.uniform(-5, 5, (support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (query, 1)).astype(np.float32)
        reqs.append((sx, np.float32(a * np.sin(sx + b)), qx,
                     np.float32(a * np.sin(qx + b)), ks[i % len(ks)]))
    return reqs


def _drain(server, reqs):
    rids = [server.submit(*r) for r in reqs]
    done = {res.rid: res for res in server.drain()}
    assert sorted(done) == sorted(rids)
    return [done[rid] for rid in rids]


@pytest.fixture(scope="module")
def jphi():
    return jax.tree.map(np.asarray, j_init(J_SINE, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("route", ["fp32", "tifed"])
@pytest.mark.parametrize("slots,n", [(8, 3), (4, 11)])
def test_tick_matches_the_jax_server(jphi, route, slots, n):
    """A drain with fewer requests than slots (most refill rows unused)
    and one with more (refills into retired slots), against the JAX
    AdaptationServer: the same steps, query losses within 1e-5 (fp32) or
    1e-6 relative (TIFeD), params within 1e-5 (fp32) or exact (TIFeD);
    one build of the tick, as the JAX server traces once."""
    if route == "fp32":
        phi, k_max, spt = jphi, 10, 3
        reqs = _requests(n, 10, 16, (3, 10, 7, 1, 5, 9), seed=5)
        tad = Fp32Adapter(TLOSS, lr=0.01)
        jad = jserving.Fp32Adapter(loss_fn=JLOSS, lr=0.01)
    else:
        phi = jax.tree.map(np.asarray, tifed_requantize(jphi))
        k_max, spt = 6, 2
        reqs = _requests(n, 8, 16, (2, 6, 4, 1, 3, 5), seed=6)
        tad = TifedAdapter(support=8, k_max=6)
        jad = jserving.TifedAdapter(support=8, k_max=6, use_pallas=False)
    kw = dict(slots=slots, k_max=k_max, steps_per_tick=spt,
              return_params=True)
    tserver = AdaptationServer(phi, tad, device="cpu", **kw)
    got = _drain(tserver, reqs)
    jserver = jserving.AdaptationServer(phi, jad, **kw)
    want = _drain(jserver, reqs)
    assert tserver.trace_count == jserver.trace_count == 1
    assert tserver.ticks == jserver.ticks
    for g, w in zip(got, want):
        assert g.steps == w.steps
        for leaf in w.params:
            if route == "tifed":
                np.testing.assert_array_equal(g.params[leaf],
                                              np.asarray(w.params[leaf]))
            else:
                np.testing.assert_allclose(g.params[leaf],
                                           np.asarray(w.params[leaf]),
                                           rtol=1e-5, atol=1e-5)
        if route == "tifed":
            np.testing.assert_allclose(g.query_loss, w.query_loss,
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(g.query_loss, w.query_loss,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["fp32", "tifed"])
def test_tick_is_built_once_across_reset_and_set_params(jphi, route):
    """``reset`` and a ``set_params`` of the same shapes keep the built
    tick; a ``set_params`` whose pack bakes other host values (TIFeD's
    exponents) or shapes builds it again, and the next drain serves the
    new init exactly as a fresh server does."""
    if route == "fp32":
        phi, adapter, k_max = jphi, Fp32Adapter(TLOSS), 10
        other = {k: v * 0.5 for k, v in jphi.items()}
        reqs = _requests(5, 10, 16, (4, 10, 2), seed=7)
    else:
        phi = jax.tree.map(np.asarray, tifed_requantize(jphi))
        adapter, k_max = TifedAdapter(support=8, k_max=6), 6
        other = {k: v * 4.0 for k, v in phi.items()}    # other exponents
        reqs = _requests(5, 8, 16, (4, 6, 2), seed=8)
    kw = dict(slots=4, k_max=k_max, steps_per_tick=2, return_params=True,
              device="cpu")
    server = AdaptationServer(phi, adapter, **kw)
    first = _drain(server, reqs)
    server.reset()
    server.set_params(phi)
    again = _drain(server, reqs)
    assert server.trace_count == 1
    for a, b in zip(first, again):
        assert (a.steps, a.query_loss) == (b.steps, b.query_loss)
    server.reset()
    server.set_params(other)
    swapped = _drain(server, reqs)
    assert server.trace_count == (1 if route == "fp32" else 2)
    fresh = _drain(AdaptationServer(other, adapter, **kw), reqs)
    for a, b in zip(swapped, fresh):
        assert (a.steps, a.query_loss) == (b.steps, b.query_loss)
        for leaf in b.params:
            np.testing.assert_array_equal(a.params[leaf], b.params[leaf])


def test_adapt_row_has_trace_count():
    """The serve launcher's adapt row carries ``trace_count``, as the JAX
    launcher's does: 1, the warm-up drain built the tick."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "adapt",
         "--device", "cpu", "--requests", "6", "--slots", "4"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout)
    assert row["trace_count"] == 1 and row["requests"] == 6
