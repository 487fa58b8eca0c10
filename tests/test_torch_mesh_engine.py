"""The port's client-sharded round engine, ``run_federated(mesh=2)`` over
two gloo ranks on the CPU, held against the JAX package's
``run_federated(mesh=client_mesh(2))`` on two forced host devices.

One module fixture starts the two ranks once (a ``FileStore`` under
``tmp_path``, so parallel test workers never race for a port) and, at
the same time, the JAX side in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=2``, as
``tests/test_mesh_engine.py`` runs it. Both start from the JAX
package's init at the same seed. Held:

- the five fp32 strategies, TIFeD's int8 one and a pooled FedBuff fleet
  under availability (device- and host-resident): phi within 1e-4 of the
  JAX mesh run (TIFeD's integer grids exactly), the history within 1e-4,
  the transport bills and the pool's identity state exactly; both ranks
  bit for bit;
- against the port's own ``mesh=None`` run: bills and identity state
  exactly, phi within ``MESH_VS_ONE_TOL`` (the sums' order moves fp32's
  last bits; TIFeD's requantization can turn that into one grid step);
- ``mesh=1`` bit for bit ``mesh=None``; mesh resolution and rejection;
  ``runner_cache_stats()["mesh_entries"]``;
- snapshots: rank 0 alone writes, and a resume on the mesh equals the
  uninterrupted run exactly;
- the train launcher's two-process row (``--num-processes 2``) against
  the JAX launcher's two-process row.
"""
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.models.paper_nets import init_paper_model as j_init  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.models.paper_nets import (paper_model_loss,  # noqa: E402
                                           relu_mlp_loss)
from repro_torch.runtime.ranks import run_ranks  # noqa: E402
from repro_torch.runtime.sharding import MeshShape, ProcessMesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.02, query=8)
RUN = dict(rounds=6, beta=0.02, support=4, seed=1, eval_every=3,
           eval_kwargs=EVAL)
TOL = 1e-4
# the port's mesh=2 against its mesh=None: fp32 params moved by the
# order of the sums (7.2e-7 measured at these sizes); TIFeD's
# requantization can round one weight to the next grid step (2^-6)
MESH_VS_ONE_TOL = {"tifed": 2.0 ** -6}
MESH_VS_ONE_FP32 = 1e-5

# name -> (strategy, its kwargs, run_federated kwargs, pool kwargs,
#          FedBuff kwargs, availability (class, kwargs)); uneven cohorts
#          pad to the shard multiple
CASES = {
    "reptile": ("ReptileStrategy", dict(epochs=2),
                dict(clients_per_round=5), None, None, None),
    "tinyreptile": ("TinyReptileStrategy", {},
                    dict(clients_per_round=5), None, None, None),
    "fedavg": ("FedAvgStrategy", dict(epochs=2),
               dict(clients_per_round=6), None, None, None),
    "fedsgd": ("FedSGDStrategy", {}, dict(clients_per_round=4),
               None, None, None),
    "transfer": ("TransferStrategy", {}, dict(clients_per_round=3),
                 None, None, None),
    "tifed": ("TifedStrategy", dict(epochs=2),
              dict(clients_per_round=3, support=8), None, None, None),
    "pooled_fedbuff": ("ReptileStrategy", dict(epochs=2),
                       dict(clients_per_round=3), dict(size=7, seed=3),
                       dict(buffer_size=4, flush_staleness=3),
                       ("DiurnalAvailability", dict(period=6))),
    "pooled_host": ("ReptileStrategy", dict(epochs=2),
                    dict(clients_per_round=3),
                    dict(size=9, seed=3, sampler="vectorized",
                         residency="host"),
                    dict(buffer_size=4), None),
}


def build(core, loss, relu_loss, dist, name):
    """One case's ``run_federated`` arguments in either package (``core``
    is ``repro.core`` or ``repro_torch.core``)."""
    strat, skw, kw, pool, buf, avail = CASES[name]
    kw = dict(RUN, **kw)
    if strat == "TifedStrategy":
        strategy = core.TifedStrategy(relu_loss, **skw)
        kw["channel"] = core.CommChannel("int8", quantize=False)
    else:
        strategy = getattr(core, strat)(loss, **skw)
    if pool is not None:
        kw["pool"] = core.ClientPool(dist, **pool)
    if buf is not None:
        kw["buffered"] = core.BufferedAggregation(**buf)
    if avail is not None:
        kw["sampling"] = getattr(core, avail[0])(**avail[1])
    return strategy, kw


def _numpy_out(out):
    """A run's result as NumPy: params, query losses, bills, pool
    state."""
    res = {"params": {k: np.asarray(v) for k, v in out["params"].items()},
           "query_loss": [float(h["query_loss"]) for h in out["history"]],
           "per_client_bytes": out.get("per_client_bytes"),
           "comm_bytes": out.get("comm_bytes")}
    if "pool_state" in out:
        res["pool_state"] = {k: np.asarray(v)
                             for k, v in out["pool_state"].items()}
    return res


def jax_side(out_path):
    """The JAX package's mesh runs (two forced host devices)."""
    from repro import core as jcore
    from repro.data import SineTasks as JSine
    from repro.models.paper_nets import paper_model_loss as j_loss
    from repro.models.paper_nets import relu_mlp_loss as j_relu

    init = j_init(J_SINE, jax.random.PRNGKey(0))
    loss = functools.partial(j_loss, J_SINE)
    res = {}
    for name in CASES:
        strategy, kw = build(jcore, loss, j_relu, JSine(), name)
        out = jcore.run_federated(init, JSine(), strategy,
                                  mesh=jcore.client_mesh(2), **kw)
        res[name] = _numpy_out(out)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _rank_cases(rank, init, ckpt_root, launch_init):
    """Each rank: every case on mesh=2, the cache's mesh entries, a
    custom hook without group=, and the snapshots; rank 0 also the
    mesh=None runs."""
    loss = functools.partial(paper_model_loss, SINE_MLP)
    dist = SineTasks()
    res = {"mesh": {}, "one": {}}
    for name in CASES:
        strategy, kw = build(tcore, loss, relu_mlp_loss, dist, name)
        res["mesh"][name] = _numpy_out(tcore.run_federated(
            init, dist, strategy, mesh=2, device="cpu", **kw))
    res["stats"] = tcore.runner_cache_stats()

    class NoGroup(tcore.ReptileStrategy):
        def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                      beta, weights):
            return super().server_aggregate_weighted(
                layout, phi, results, alpha_t, beta, weights)

    try:
        tcore.run_federated(init, dist, NoGroup(loss, epochs=1), mesh=2,
                            device="cpu", rounds=1, clients_per_round=2)
        res["no_group"] = None
    except ValueError as e:
        res["no_group"] = str(e)
    # snapshots: a 3-round run into this rank's own directory, then a
    # resume to round 6 from rank 0's, on both ranks (alpha not annealed:
    # an annealed run's rate depends on its horizon)
    strategy, kw = build(tcore, loss, relu_mlp_loss, dist, "pooled_fedbuff")
    kw.update(ckpt_every=3, anneal=False)
    mine = os.path.join(ckpt_root, f"rank{rank}")
    tcore.run_federated(init, dist, strategy, mesh=2, device="cpu",
                        ckpt_dir=mine, **dict(kw, rounds=3))
    res["wrote"] = sorted(os.listdir(mine)) if os.path.isdir(mine) else []
    strategy, kw2 = build(tcore, loss, relu_mlp_loss, dist,
                          "pooled_fedbuff")
    kw2.update(ckpt_every=3, anneal=False)
    res["resumed"] = _numpy_out(tcore.run_federated(
        init, dist, strategy, mesh=2, device="cpu",
        ckpt_dir=os.path.join(ckpt_root, "rank0"), resume=True, **kw2))
    strategy, kw3 = build(tcore, loss, relu_mlp_loss, dist,
                          "pooled_fedbuff")
    kw3.update(ckpt_every=3, anneal=False)
    res["uninterrupted"] = _numpy_out(tcore.run_federated(
        init, dist, strategy, mesh=2, device="cpu",
        ckpt_dir=os.path.join(ckpt_root, f"full{rank}"), **kw3))
    # the launcher's two-process route, from the JAX launcher's init
    from repro_torch.launch import train
    res["row"], _ = train.run_engine_strategy(train.parse_args(
        LAUNCH_ARGV + ["--num-processes", "2", "--coordinator",
                       "127.0.0.1:1", "--process-id", str(rank),
                       "--device", "cpu"]), init_params=launch_init)
    if rank == 0:
        for name in CASES:
            strategy, kw = build(tcore, loss, relu_mlp_loss, dist, name)
            res["one"][name] = _numpy_out(tcore.run_federated(
                init, dist, strategy, device="cpu", **kw))
    return res


# the JAX launcher's two-process route (tests/test_distributed.py's run)
LAUNCH_ARGV = ["--strategy", "reptile", "--rounds", "4", "--clients", "2",
               "--pool-size", "5", "--pool-sampler", "vectorized",
               "--pool-residency", "host", "--seed", "3"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_env(devices):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    jax_out = str(root / "jax.pkl")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_mesh_engine as t; "
         f"t.jax_side({jax_out!r})"], env=_jax_env(2), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = str(_free_port())
    base = [sys.executable, "-m", "repro.launch.train"] + LAUNCH_ARGV + [
        "--devices", "2", "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2"]
    launch = [subprocess.Popen(base + ["--process-id", str(r)],
                               env=_jax_env(1), cwd=REPO,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in (1, 0)]
    try:
        ranks = run_ranks(_rank_cases, 2, str(root / "ranks"), _init(),
                          str(root / "ckpt"), _init(seed=3), device="cpu")
        out, err = jax_proc.communicate(timeout=600)
        assert jax_proc.returncode == 0, err[-3000:]
        outs = [p.communicate(timeout=600) for p in launch]
        assert all(p.returncode == 0 for p in launch), outs[1][1][-3000:]
    finally:
        for p in [jax_proc] + launch:
            p.kill()
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    jax_row = json.loads(outs[1][0].strip().splitlines()[-1])
    return {"ranks": ranks, "jax": want, "jax_row": jax_row}


def _same_ints(got, want, name):
    assert got["per_client_bytes"] == want["per_client_bytes"], name
    assert got["comm_bytes"] == want["comm_bytes"], name
    assert set(got.get("pool_state", {})) == set(want.get("pool_state", {}))
    for k, v in want.get("pool_state", {}).items():
        np.testing.assert_array_equal(got["pool_state"][k], v,
                                      err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_run_matches_the_jax_mesh_run(runs, name):
    got, want = runs["ranks"][0]["mesh"][name], runs["jax"][name]
    _same_ints(got, want, name)
    for k, v in want["params"].items():
        if name == "tifed":
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["params"][k], v, rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["query_loss"], want["query_loss"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_agree_bit_for_bit(runs, name):
    a, b = (r["mesh"][name] for r in runs["ranks"])
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    assert a["query_loss"] == b["query_loss"]
    _same_ints(a, b, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_run_matches_the_one_device_run(runs, name):
    """Bills and identity exact; phi within the measured tolerance."""
    got, one = runs["ranks"][0]["mesh"][name], runs["ranks"][0]["one"][name]
    _same_ints(got, one, name)
    tol = MESH_VS_ONE_TOL.get(name, MESH_VS_ONE_FP32)
    for k, v in one["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=tol,
                                   err_msg=f"{name} {k}")


def test_cache_counts_mesh_entries_and_hooks_need_group(runs):
    for r in runs["ranks"]:
        assert r["stats"]["mesh_entries"] == len(CASES)
        assert "group=" in r["no_group"]


def test_only_rank_0_writes_and_a_resume_is_exact(runs):
    r0, r1 = runs["ranks"]
    assert r0["wrote"] and not r1["wrote"]
    for r in (r0, r1):
        got, want = r["resumed"], r["uninterrupted"]
        for k in want["params"]:
            np.testing.assert_array_equal(got["params"][k],
                                          want["params"][k])
        assert got["query_loss"] == want["query_loss"]
        _same_ints(got, want, "resumed")


def test_two_process_launcher_row_matches_the_jax_launchers(runs):
    """Both launchers' two-process rows, the port's from the JAX
    launcher's init: comm_mb exact, query_loss within one unit of its
    4th place."""
    got, want = runs["ranks"][0]["row"], runs["jax_row"]
    for k in ("strategy", "rounds", "clients", "comm_mb"):
        assert got[k] == want[k], (k, got, want)
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12
    assert runs["ranks"][1]["row"] == {**got, "dt_s": runs["ranks"][1][
        "row"]["dt_s"]}


def _init(seed=0):
    """The JAX package's init of the sine MLP, as NumPy."""
    return {k: np.asarray(v) for k, v in
            j_init(J_SINE, jax.random.PRNGKey(seed)).items()}


@pytest.mark.parametrize("name", ["reptile", "pooled_fedbuff", "tifed"])
def test_one_rank_mesh_is_bit_for_bit_the_one_device_run(name):
    loss = functools.partial(paper_model_loss, SINE_MLP)
    outs = []
    for mesh in (None, 1):
        strategy, kw = build(tcore, loss, relu_mlp_loss, SineTasks(), name)
        outs.append(tcore.run_federated(_init(), SineTasks(), strategy,
                                        mesh=mesh, device="cpu", **kw))
    for k, v in outs[0]["params"].items():
        assert torch.equal(outs[1]["params"][k], v), k
    assert outs[0]["history"] == outs[1]["history"]


def test_mesh_resolution_and_rejection():
    dev = torch.device("cpu")
    auto = engine._resolve_mesh("auto", dev)
    assert auto.shape == {"clients": 1} and auto.group("clients") is None
    assert engine._resolve_mesh(1, dev).key() == auto.key()
    with pytest.raises(ValueError, match="asked for 2 devices"):
        engine._resolve_mesh(2, dev)
    with pytest.raises(ValueError, match="'clients' mesh axis"):
        engine._resolve_mesh(ProcessMesh(("data",), (1,), dev), dev)
    m2d = ProcessMesh(("clients", "model"), (1, 1), dev)
    assert engine._resolve_mesh(m2d, dev) is m2d      # the 2-D route
    assert MeshShape(("clients",), (4,)).shape == {"clients": 4}
