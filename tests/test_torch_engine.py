"""The port's federated round engine held against the JAX package's.

Both sides start from the same init (the JAX package's
``init_paper_model``, carried across as NumPy) and the same seed; the
host RNG stream is the parity contract, so params and history must agree
to float rounding (1e-4) and every byte count exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.models.paper_nets import init_paper_model as j_init  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.metering import MetricsTracker  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402

JLOSS = functools.partial(j_loss, J_SINE)
TLOSS = functools.partial(paper_model_loss, SINE_MLP)
EVAL = dict(num_tasks=4, support=8, k_steps=4, lr=0.02, query=16)
TOL = 1e-4


@pytest.fixture(scope="module")
def init():
    return {k: np.asarray(v)
            for k, v in j_init(J_SINE, jax.random.PRNGKey(0)).items()}


def _both(name, init, jkw=None, tkw=None, **kw):
    """Run ``<name>_train`` on both packages with the same arguments."""
    jout = getattr(jcore, name)(JLOSS, init, JSine(), **kw, **(jkw or {}))
    tout = getattr(tcore, name)(TLOSS, init, SineTasks(), device="cpu",
                                **kw, **(tkw or {}))
    return jout, tout


def assert_same_run(got, want, rtol=TOL, atol=TOL):
    """Params and history floats within tolerance; byte counts, history
    keys and integers exact."""
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        assert got["params"][k].shape == tuple(v.shape), k
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert ("comm_bytes" in got) == ("comm_bytes" in want)
    if "comm_bytes" in want:
        assert got["comm_bytes"] == want["comm_bytes"]
        assert got["per_client_bytes"] == want["per_client_bytes"]
    assert len(got["history"]) == len(want["history"])
    for ge, we in zip(got["history"], want["history"]):
        assert set(ge) == set(we), (ge, we)
        for k, v in we.items():
            if isinstance(v, (int, np.integer)):
                assert ge[k] == v, (k, ge[k], v)
            else:
                np.testing.assert_allclose(ge[k], v, rtol=rtol, atol=atol,
                                           err_msg=k)


# the seven cases of tests/test_engine_parity.py, at their sizes
CASES = {
    "tinyreptile": ("tinyreptile_train",
                    dict(rounds=60, alpha=1.0, beta=0.02, support=8,
                         seed=11, eval_every=20, eval_kwargs=EVAL)),
    "tinyreptile_no_anneal_no_eval": (
        "tinyreptile_train", dict(rounds=25, alpha=0.7, beta=0.02,
                                  support=8, seed=12, anneal=False)),
    "reptile_serial": ("reptile_train",
                       dict(rounds=40, alpha=1.0, beta=0.02, support=8,
                            epochs=4, clients_per_round=1, seed=13,
                            eval_every=20, eval_kwargs=EVAL)),
    "reptile_batched": ("reptile_train",
                        dict(rounds=30, alpha=1.0, beta=0.02, support=8,
                             epochs=4, clients_per_round=3, seed=14,
                             eval_every=15, eval_kwargs=EVAL)),
    "fedavg": ("fedavg_train",
               dict(rounds=20, beta=0.02, support=8, epochs=4,
                    clients_per_round=3, seed=15, eval_every=10,
                    eval_kwargs=EVAL)),
    "fedsgd": ("fedsgd_train",
               dict(rounds=30, beta=0.02, support=8, clients_per_round=3,
                    seed=16, eval_every=15, eval_kwargs=EVAL)),
    "transfer": ("transfer_train",
                 dict(rounds=40, beta=0.02, batch_per_round=24,
                      tasks_per_round=6, seed=17, eval_every=20,
                      eval_kwargs=EVAL)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(init, case):
    name, kw = CASES[case]
    jout, tout = _both(name, init, **kw)
    assert_same_run(tout, jout)
    if name == "transfer_train":
        assert "comm_bytes" not in tout


@pytest.mark.parametrize("name,policy,kw", [
    ("tinyreptile_train", ("PartialParticipation", 0.5),
     dict(rounds=12, beta=0.02, support=6, clients_per_round=4, seed=31,
          eval_every=6)),
    ("tinyreptile_train", ("StragglerSampling", 0.5),
     dict(rounds=12, beta=0.02, support=6, clients_per_round=4, seed=32,
          eval_every=6)),
    ("reptile_train", ("StragglerSampling", 0.25),
     dict(rounds=10, beta=0.02, support=6, epochs=4, clients_per_round=3,
          seed=33, eval_every=5)),
    ("fedavg_train", ("PartialParticipation", 0.5),
     dict(rounds=10, beta=0.02, support=6, epochs=3, clients_per_round=4,
          seed=34, eval_every=5)),
    ("fedsgd_train", ("PartialParticipation", 0.6),
     dict(rounds=10, beta=0.02, support=6, clients_per_round=5, seed=35,
          eval_every=5)),
    ("transfer_train", ("PartialParticipation", 0.5),
     dict(rounds=10, beta=0.02, batch_per_round=12, tasks_per_round=4,
          seed=36, eval_every=5)),
])
def test_scheduled_runs_match_jax(init, name, policy, kw):
    cls, arg = policy
    jout, tout = _both(name, init,
                       jkw=dict(sampling=getattr(jcore, cls)(arg)),
                       tkw=dict(sampling=getattr(tcore, cls)(arg)),
                       eval_kwargs=EVAL, **kw)
    assert_same_run(tout, jout)


@pytest.mark.parametrize("dtype", ["float16", "int8"])
@pytest.mark.parametrize("name,kw", [
    ("tinyreptile_train", dict(rounds=20, beta=0.02, support=8, seed=41,
                               eval_every=10)),
    ("fedsgd_train", dict(rounds=10, beta=0.02, support=8,
                          clients_per_round=3, seed=42, eval_every=5)),
])
def test_quantized_channels_match_jax(init, dtype, name, kw):
    jout, tout = _both(name, init,
                       jkw=dict(channel=jcore.CommChannel(dtype)),
                       tkw=dict(channel=tcore.CommChannel(dtype)),
                       eval_kwargs=EVAL, **kw)
    # a last-bit fp32 difference can carry a value across an fp16
    # rounding boundary of the wire: the runs then differ by one fp16
    # step, 2^-10 relative at most
    assert_same_run(tout, jout,
                    rtol=2 ** -10 if dtype == "float16" else TOL)
    fp32 = 2 * kw["rounds"] * kw.get("clients_per_round", 1) * 1153 * 4
    assert tout["comm_bytes"] == fp32 * {"float16": 2, "int8": 1}[dtype] // 4


def test_wire_matches_jax_bit_for_bit():
    """The simulated int8 wire (per-leaf max-abs scale, round half to
    even) and fp16 wire, on one leaf and on a cohort-stacked leaf."""
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 4.5], np.float32)
    for x in [(rng.normal(size=s) * 3).astype(np.float32)
              for s in ((32, 32), (3, 32, 32))] + [ties]:
        for dtype in ("int8", "float16"):
            want = jcore.CommChannel(dtype).transmit(
                {"w": jax.numpy.asarray(x)})
            got = tcore.CommChannel(dtype).transmit(
                {"w": torch.from_numpy(x)})
            np.testing.assert_array_equal(got["w"].numpy(),
                                          np.asarray(want["w"]))


def test_prefetch_is_bit_for_bit(init):
    kw = dict(rounds=14, beta=0.02, support=6, clients_per_round=3, seed=5,
              eval_every=4, max_block=3, eval_kwargs=EVAL, device="cpu",
              sampling=tcore.StragglerSampling(0.5))
    runs = [tcore.tinyreptile_train(TLOSS, init, SineTasks(), prefetch=d,
                                    **kw) for d in (0, 2)]
    for k in runs[0]["params"]:
        assert torch.equal(runs[0]["params"][k], runs[1]["params"][k])
    assert runs[0]["history"] == runs[1]["history"]


def test_tracker_sees_the_run_and_changes_nothing(init):
    kw = dict(rounds=10, beta=0.02, support=6, seed=3, eval_every=5,
              eval_kwargs=EVAL, device="cpu")
    plain = tcore.tinyreptile_train(TLOSS, init, SineTasks(), **kw)
    tracker = MetricsTracker()
    traced = tcore.tinyreptile_train(TLOSS, init, SineTasks(),
                                     tracker=tracker, **kw)
    for k in plain["params"]:
        assert torch.equal(plain["params"][k], traced["params"][k])
    assert tracker.counters["engine.rounds"] == 10
    assert tracker.counters["transport.bytes"] == traced["comm_bytes"]
    losses = tracker.series_values("round.inner_loss")
    assert len(losses) == 10
    assert losses[4] == traced["history"][0]["inner_loss"]
    assert tracker.series_values("eval.query_loss") == [
        h["query_loss"] for h in traced["history"]]


def test_cpu_run_launches_no_kernel_and_returns_cpu_tensors(init):
    ops.reset_launch_counts()
    out = tcore.reptile_train(TLOSS, init, SineTasks(), rounds=3, support=4,
                              epochs=2, clients_per_round=2, device="cpu")
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in out["params"].values())
    assert sorted(out["params"]) == sorted(init)
    # the caller's init is not touched
    assert all(np.array_equal(init[k], j_init(J_SINE,
                                              jax.random.PRNGKey(0))[k])
               for k in init)


@pytest.mark.parametrize("kw", [dict(mesh=2), dict(mesh="auto"),
                                dict(mesh=1)])
def test_unported_routes_raise(init, kw):
    """mesh= resolves since the multi-process slice (two ranks:
    tests/test_torch_mesh_engine.py). Without a process group, "auto"
    and 1 are a one-rank mesh, bit for bit mesh=None's run, through
    run_federated and a train function alike; 2 asks for ranks this
    process does not have and raises, naming what to start."""
    kw2 = dict(rounds=2, clients_per_round=2, support=4, device="cpu")
    if kw["mesh"] == 2:
        with pytest.raises(ValueError, match="asked for 2 devices.*ranks"):
            tcore.run_federated(init, SineTasks(),
                                tcore.ReptileStrategy(TLOSS), **kw2, **kw)
        with pytest.raises(ValueError, match="asked for 2 devices"):
            tcore.reptile_train(TLOSS, init, SineTasks(), **kw2, **kw)
        return
    for run in (lambda **k: tcore.run_federated(
            init, SineTasks(), tcore.ReptileStrategy(TLOSS), **k),
            lambda **k: tcore.reptile_train(TLOSS, init, SineTasks(), **k)):
        want, got = run(**kw2), run(**kw2, **kw)
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), k
        assert got["per_client_bytes"] == want["per_client_bytes"]


def test_without_cuda_the_train_functions_raise(init):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tcore.tinyreptile_train, tcore.reptile_train,
               tcore.fedavg_train, tcore.fedsgd_train,
               tcore.transfer_train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(TLOSS, init, SineTasks(), rounds=2)


def test_plan_blocks_matches_jax():
    from repro.core.pipeline import plan_blocks as jplan
    for args in ((20, 0, 512), (60, 20, 512), (50, 20, 7), (5, 3, 2),
                 (0, 4, 4)):
        assert tcore.plan_blocks(*args) == jplan(*args)
