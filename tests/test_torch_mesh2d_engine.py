"""The port's 2-D ``("clients", "model")`` round engine,
``run_federated(mesh=client_model_mesh(2, 2), partitioner=...)`` over four
gloo ranks on the CPU, held against the JAX package's 2-D route
(``tests/test_mesh2d_engine.py``) on four forced host devices.

One module fixture starts the four ranks once (a ``FileStore`` under
``tmp_path``) and, at the same time, the JAX side in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``. Both start from
the JAX package's init at the same seed, with that test's tiny configs
(``tiny_lm``). Each rank holds its shard of every leaf the default
rules split (the transformer's attention heads, ``d_ff`` and vocab);
the tests gather them (``ModelShards.gather_exact``). Held:

- the small transformer across the JAX 2-D run (1e-3), the port's
  ``mesh=None`` and its 1-D mesh of 4: phi, the eval history, the bills
  exactly; the round built once; every rank's gathered phi the same;
  each rank's parameter bytes at most 0.6 of the replicated run's; and
  through a rotating partial wire, its masks cut to the shards;
- the sine MLP's pooled, partial-participation and FedBuff cases: phi
  within 3e-4 of the JAX 2-D run, bills, pool counters and flushes
  exactly;
- the tiny mamba2 through ``ssd_scan`` (its plain version on the CPU,
  counted at its wrapper) within 2e-3 of the JAX 2-D run;
- a 2x2 resume of a pooled FedBuff transformer run equal to the
  uninterrupted run; the validation messages and the runner cache's
  partitioner identity; ``client_model_mesh(1, 1)`` bit for bit
  ``mesh=None``; a flat snapshot refused by a ``client_model_mesh(1, 1)``
  run.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import FlatLayout  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.runtime.ranks import run_ranks  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.02, query=8)
LM_EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.01, query=4)
# tests/test_mesh2d_engine.py's runs: an uneven cohort (pads to 4)
LM_RUN = dict(rounds=5, beta=0.02, support=3, seed=3, eval_every=2,
              eval_kwargs=LM_EVAL, clients_per_round=3)
SINE_RUN = dict(rounds=11, beta=0.02, support=4, seed=6, eval_every=4,
                eval_kwargs=EVAL, clients_per_round=3)
MAMBA_RUN = dict(rounds=3, beta=0.02, support=2, seed=4,
                 clients_per_round=2)
SINE_CASES = ("plain", "partial", "fedbuff")
# the transformer through TinyMetaFed's rotating partial wire, its masks
# drawn over each whole leaf and cut to the shards
PARTIAL_RUN = dict(LM_RUN, rounds=3)
# the pooled FedBuff transformer run that is cut and resumed
RESUME_RUN = dict(rounds=5, beta=0.02, support=2, seed=5,
                  clients_per_round=3, anneal=False, ckpt_every=3)


def tiny_lm(get_arch, family):
    """``tests/test_mesh2d_engine.py``'s tiny configs, in either package
    (``get_arch`` is its ``configs.get_arch``)."""
    base = {"transformer": "tinyllama-1.1b", "mamba2": "mamba2-130m"}[family]
    cfg = get_arch(base).reduced()
    small = dict(name="tiny-" + family, vocab_size=128, d_model=64)
    if family == "transformer":
        small.update(d_ff=128, num_heads=2, num_kv_heads=2, head_dim=32)
    else:
        small.update(ssm_state=16, ssm_chunk=8)
    return dataclasses.replace(cfg, **small)


def sine_case(core, loss, dist, name):
    """One sine case's strategy and keyword arguments in either package."""
    kw = dict(SINE_RUN)
    if name == "partial":
        kw["sampling"] = core.PartialParticipation(0.5)
    if name == "fedbuff":
        kw["buffered"] = core.BufferedAggregation(4)
    if name != "plain":
        kw["pool"] = core.ClientPool(dist, 7)
    return core.TinyReptileStrategy(loss, **(
        {"use_pallas": None} if core.__name__ == "repro.core" else {})), kw


def _numpy(out, params=None):
    res = {"params": params,
           "query_loss": [float(h["query_loss"]) for h in out["history"]],
           "per_client_bytes": out.get("per_client_bytes"),
           "comm_bytes": out.get("comm_bytes")}
    if "pool_state" in out:
        res["pool_state"] = {k: np.asarray(v)
                             for k, v in out["pool_state"].items()}
    return res


def jax_side(out_path):
    """The JAX package's 2-D runs (four forced host devices), and its
    validation messages."""
    from repro.configs import get_arch
    from repro.configs.paper_models import SINE_MLP
    from repro import core as jcore
    from repro.data import LmTaskDistribution, SineTasks, lm_loss
    from repro.models import build_model
    from repro.models.paper_nets import (init_paper_model, paper_model_loss,
                                         relu_mlp_loss)
    from repro.runtime.sharding import (DEFAULT_PARTITIONER,
                                        client_model_mesh)

    def flat(params):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(params)}

    mesh2d = client_model_mesh(2, 2)
    res = {}
    model = build_model(tiny_lm(get_arch, "transformer"))
    phi = model.init(jax.random.PRNGKey(1))
    S = jcore.ReptileStrategy(lm_loss(model), epochs=2, use_pallas=None)
    out = jcore.run_federated(phi, LmTaskDistribution(128, 16), S,
                              mesh=mesh2d, **LM_RUN)
    res["transformer"] = _numpy(out, flat(out["params"]))
    out = jcore.run_federated(
        phi, LmTaskDistribution(128, 16), S, mesh=mesh2d,
        channel=jcore.PartialCommChannel(fraction=0.5, rotate=True),
        **PARTIAL_RUN)
    res["transformer_partial"] = _numpy(out, flat(out["params"]))
    loss = functools.partial(paper_model_loss, SINE_MLP)
    params = init_paper_model(SINE_MLP, jax.random.PRNGKey(0))
    for name in SINE_CASES:
        strategy, kw = sine_case(jcore, loss, SineTasks(), name)
        out = jcore.run_federated(params, SineTasks(), strategy, mesh=mesh2d,
                                  **kw)
        res[name] = _numpy(out, flat(out["params"]))
    model = build_model(tiny_lm(get_arch, "mamba2"))
    phi = model.init(jax.random.PRNGKey(2))
    S = jcore.ReptileStrategy(lm_loss(model), epochs=2, use_pallas=None)
    out = jcore.run_federated(phi, LmTaskDistribution(128, 16), S,
                              mesh=mesh2d, **MAMBA_RUN)
    res["mamba2"] = _numpy(out, flat(out["params"]))
    msgs = {}
    try:
        jcore.run_federated(params, SineTasks(), jcore.TifedStrategy(
            relu_mlp_loss, epochs=2), channel=jcore.CommChannel(
                "int8", quantize=False), mesh=mesh2d, rounds=2, beta=0.0,
            support=4, seed=1, clients_per_round=2)
    except ValueError as e:
        msgs["int8"] = str(e)
    try:
        jcore.run_federated(params, SineTasks(), jcore.TinyReptileStrategy(
            loss, use_pallas=None), partitioner=DEFAULT_PARTITIONER,
            rounds=2, beta=0.02, support=4, seed=1, clients_per_round=2)
    except ValueError as e:
        msgs["partitioner"] = str(e)
    res["messages"] = msgs
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _gathered(out, init, mesh, partitioner=sh.DEFAULT_PARTITIONER):
    """A 2-D run's params gathered whole, as ``{"a/b": array}``; the
    collective every rank of the mesh calls."""
    whole = FlatLayout.of_tree(init)
    shards = sh.ModelShards.of(partitioner, dict(zip(whole.names,
                                                     whole.shapes)), mesh)
    local = FlatLayout.of_tree(out["params"]).named(out["params"])
    return {_key(k): shards.gather_exact(k, v).numpy()
            for k, v in local.items()}


def _key(k):
    return k if isinstance(k, str) else "/".join(str(p) for p in k)


def _whole(params):
    return {_key(k): v.numpy() for k, v in
            FlatLayout.of_tree(params).named(params).items()}


def _rank_cases(rank, inits, ckpt_root):
    """Each rank: the transformer on the 2x2 mesh and on a 1-D mesh of 4,
    the sine cases, the mamba2 through ssd_scan and the resume, each on
    every rank; rank 0 also the mesh=None runs."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.data import LmTaskDistribution, SineTasks, lm_loss
    from repro_torch.kernels import ops
    from repro_torch.models.paper_nets import (paper_model_loss,
                                               relu_mlp_loss)
    from repro_torch.models.transformer import build_model

    mesh2d = sh.client_model_mesh(2, 2, "cpu")
    res = {"mesh": {}, "one": {}}
    model = build_model(tiny_lm(get_arch, "transformer"))
    lm = LmTaskDistribution(128, 16)
    S = tcore.ReptileStrategy(lm_loss(model), epochs=2)
    tcore.clear_runner_cache()
    out = tcore.run_federated(inits["transformer"], lm, S, mesh=mesh2d,
                              device="cpu", **LM_RUN)
    res["mesh"]["transformer"] = _numpy(out, _gathered(
        out, inits["transformer"], mesh2d))
    (runner,) = engine._RUNNER_CACHE._entries.values()
    res["trace_count"] = runner.trace_count
    res["local_shapes"] = {
        _key(k): tuple(v.shape) for k, v in
        FlatLayout.of_tree(out["params"]).named(out["params"]).items()}
    whole = FlatLayout.of_tree(inits["transformer"])
    res["bytes"] = (sh.per_device_param_bytes(out["params"]),
                    sum(v.nbytes for v in whole.named(
                        inits["transformer"]).values()))
    # the same run from a LocalShards init: this rank's shards only
    whole = FlatLayout.of_tree(inits["transformer"])
    shards = sh.ModelShards.of(sh.DEFAULT_PARTITIONER,
                               dict(zip(whole.names, whole.shapes)), mesh2d)
    local = sh.LocalShards(whole.tree({
        k: torch.from_numpy(np.ascontiguousarray(shards.local(k, v)))
        for k, v in whole.named(inits["transformer"]).items()}),
        dict(zip(whole.names, whole.shapes)))
    again = tcore.run_federated(local, lm, S, mesh=mesh2d, device="cpu",
                                **LM_RUN)
    res["local_init_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            FlatLayout.of_tree(again["params"]).named(
                again["params"]).values(),
            FlatLayout.of_tree(out["params"]).named(
                out["params"]).values())) and (
        again["history"] == out["history"])
    out = tcore.run_federated(inits["transformer"], lm, S, mesh=4,
                              device="cpu", **LM_RUN)
    res["one_d"] = _numpy(out, _whole(out["params"]))
    partial = tcore.PartialCommChannel(fraction=0.5, rotate=True)
    out = tcore.run_federated(inits["transformer"], lm, S, mesh=mesh2d,
                              device="cpu", channel=partial, **PARTIAL_RUN)
    res["mesh"]["transformer_partial"] = _numpy(out, _gathered(
        out, inits["transformer"], mesh2d))

    loss = functools.partial(paper_model_loss, SINE_MLP)
    for name in SINE_CASES:
        strategy, kw = sine_case(tcore, loss, SineTasks(), name)
        out = tcore.run_federated(inits["sine"], SineTasks(), strategy,
                                  mesh=mesh2d, device="cpu", **kw)
        res["mesh"][name] = _numpy(out, _gathered(out, inits["sine"],
                                                  mesh2d))

    mamba = build_model(tiny_lm(get_arch, "mamba2"))
    calls = {"n": 0}
    plain = ops.ssd_scan

    def counting(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)

    ops.ssd_scan = counting
    try:
        S_m = tcore.ReptileStrategy(lm_loss(mamba), epochs=2)
        out = tcore.run_federated(inits["mamba2"], lm, S_m, mesh=mesh2d,
                                  device="cpu", **MAMBA_RUN)
    finally:
        ops.ssd_scan = plain
    res["mesh"]["mamba2"] = _numpy(out, _gathered(out, inits["mamba2"],
                                                  mesh2d))
    res["ssd_calls"] = calls["n"]
    try:
        tcore.run_federated(inits["sine"], SineTasks(), tcore.TifedStrategy(
            relu_mlp_loss, epochs=2), channel=tcore.CommChannel(
                "int8", quantize=False), mesh=mesh2d, rounds=2, beta=0.0,
            support=4, seed=1, clients_per_round=2, device="cpu")
        res["int8"] = None
    except ValueError as e:
        res["int8"] = str(e)

    # a pooled FedBuff transformer run cut after round 3 and resumed on
    # the mesh, against the same run uninterrupted
    def resume_run(ckpt_dir, rounds, resume=False):
        pool = tcore.ClientPool(lm, 6, sampler="vectorized")
        return tcore.run_federated(
            inits["transformer"], lm, S, mesh=mesh2d, device="cpu",
            pool=pool, buffered=tcore.BufferedAggregation(2),
            ckpt_dir=ckpt_dir, resume=resume,
            **dict(RESUME_RUN, rounds=rounds))

    cut = os.path.join(ckpt_root, "cut")
    resume_run(cut, 3)
    dist.barrier()                      # rank 0's snapshots are written
    res["wrote"] = sorted(os.listdir(cut))
    out = resume_run(cut, RESUME_RUN["rounds"], resume=True)
    res["resumed"] = _numpy(out, _gathered(out, inits["transformer"],
                                           mesh2d))
    out = resume_run(os.path.join(ckpt_root, f"full{rank}"),
                     RESUME_RUN["rounds"])
    res["uninterrupted"] = _numpy(out, _gathered(
        out, inits["transformer"], mesh2d))
    if rank == 0:
        out = tcore.run_federated(inits["transformer"], lm, S, device="cpu",
                                  **LM_RUN)
        res["one"]["transformer"] = _numpy(out, _whole(out["params"]))
        out = tcore.run_federated(inits["transformer"], lm, S, device="cpu",
                                  channel=partial, **PARTIAL_RUN)
        res["one"]["transformer_partial"] = _numpy(out, _whole(
            out["params"]))
        for name in SINE_CASES:
            strategy, kw = sine_case(tcore, loss, SineTasks(), name)
            out = tcore.run_federated(inits["sine"], SineTasks(), strategy,
                                      device="cpu", **kw)
            res["one"][name] = _numpy(out, _whole(out["params"]))
        out = tcore.run_federated(inits["mamba2"], lm, S_m, device="cpu",
                                  **MAMBA_RUN)
        res["one"]["mamba2"] = _numpy(out, _whole(out["params"]))
    return res


def _jax_env(devices):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _inits():
    """The JAX package's inits of the three models, as NumPy trees."""
    from repro.configs import get_arch
    from repro.configs.paper_models import SINE_MLP
    from repro.models import build_model
    from repro.models.paper_nets import init_paper_model

    def numpy(tree):
        return jax.tree.map(np.asarray, tree)

    return {"transformer": numpy(build_model(tiny_lm(
                get_arch, "transformer")).init(jax.random.PRNGKey(1))),
            "mamba2": numpy(build_model(tiny_lm(get_arch, "mamba2")).init(
                jax.random.PRNGKey(2))),
            "sine": numpy(init_paper_model(SINE_MLP,
                                           jax.random.PRNGKey(0)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh2d")
    jax_out = str(root / "jax.pkl")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_mesh2d_engine as t; "
         f"t.jax_side({jax_out!r})"], env=_jax_env(4), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        inits = _inits()
        ranks = run_ranks(_rank_cases, 4, str(root / "ranks"), inits,
                          str(root / "ckpt"), device="cpu", timeout=600)
        _, err = jax_proc.communicate(timeout=600)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        jax_proc.kill()
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    return {"ranks": ranks, "jax": want, "inits": inits}


def _same_ints(got, want, name):
    assert got["per_client_bytes"] == want["per_client_bytes"], name
    assert got["comm_bytes"] == want["comm_bytes"], name
    assert set(got.get("pool_state", {})) == set(want.get("pool_state", {}))
    for k, v in want.get("pool_state", {}).items():
        np.testing.assert_array_equal(got["pool_state"][k], v,
                                      err_msg=f"{name} {k}")


def _close(got, want, tol, name):
    assert set(got["params"]) == set(want["params"]), name
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=tol, atol=tol,
                                   err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["query_loss"], want["query_loss"],
                               rtol=tol, atol=1e-4, err_msg=name)


# name -> the tolerance against the JAX 2-D run and the port's mesh=None
TOLS = {"transformer": 1e-3, "transformer_partial": 1e-3,
        "plain": 3e-4, "partial": 3e-4,
        "fedbuff": 3e-4, "mamba2": 2e-3}


@pytest.mark.parametrize("name", sorted(TOLS))
def test_2d_run_matches_the_jax_2d_run(runs, name):
    got, want = runs["ranks"][0]["mesh"][name], runs["jax"][name]
    _same_ints(got, want, name)
    _close(got, want, TOLS[name], name)


@pytest.mark.parametrize("name", sorted(TOLS))
def test_2d_run_matches_the_one_device_run(runs, name):
    got, one = runs["ranks"][0]["mesh"][name], runs["ranks"][0]["one"][name]
    _same_ints(got, one, name)
    _close(got, one, TOLS[name], name)
    for r in runs["ranks"][1:]:
        other = r["mesh"][name]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other["params"][k], v)
        assert other["query_loss"] == got["query_loss"]


def test_transformer_2d_matches_the_1d_mesh_and_is_built_once(runs):
    r0 = runs["ranks"][0]
    _same_ints(r0["one_d"], r0["one"]["transformer"], "one_d")
    _close(r0["mesh"]["transformer"], r0["one_d"], 1e-3, "one_d")
    assert [r["trace_count"] for r in runs["ranks"]] == [1] * 4


def test_each_rank_holds_its_shard_and_at_most_0_6_of_the_bytes(runs):
    """The memory contract the 2-D mesh exists for: the default rules
    split the heads, d_ff and the vocab in two, and each rank's params
    are its shards only."""
    for r in runs["ranks"]:
        mine, whole = r["bytes"]
        assert mine <= 0.6 * whole, (mine, whole)
        shapes = r["local_shapes"]
        assert shapes["embed"] == (64, 64)                  # vocab 128 / 2
        assert shapes["layers/0/attn/wq"] == (64, 1, 32)    # heads 2 / 2
        assert shapes["layers/0/attn/wo"] == (1, 32, 64)
        assert shapes["layers/0/mlp/w_down"] == (64, 64)    # d_ff 128 / 2
        assert shapes["layers/0/norm1"] == (64,)            # replicated


def test_a_local_shards_init_runs_bit_for_bit_the_whole_init(runs):
    assert all(r["local_init_bit_equal"] for r in runs["ranks"])


def test_mamba2_2d_round_runs_through_ssd_scan(runs):
    assert all(r["ssd_calls"] > 0 for r in runs["ranks"])


def test_validation_messages_match_the_reference(runs):
    msgs = runs["jax"]["messages"]
    got = runs["ranks"][0]["int8"]
    assert "int8" in got and "int8" in msgs["int8"]
    assert got == msgs["int8"]
    with pytest.raises(ValueError, match="partitioner") as e:
        tcore.run_federated(runs["inits"]["sine"], None, None, rounds=1,
                            partitioner=sh.DEFAULT_PARTITIONER, device="cpu")
    assert (str(e.value).replace("repro_torch.", "repro.")
            == msgs["partitioner"])
    with pytest.raises(ValueError, match="needs 4096 ranks"):
        sh.client_model_mesh(64, 64, "cpu")


def test_partitioner_is_part_of_the_runner_cache_key():
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.models.paper_nets import paper_model_loss
    S = tcore.TinyReptileStrategy(functools.partial(paper_model_loss,
                                                    SINE_MLP))
    m11 = sh.client_model_mesh(1, 1, "cpu")
    tcore.clear_runner_cache()
    kw = dict(scheduled=True, mesh=m11, masked=False)
    r_default = engine._block_runner(S, 0.05, tcore.CommChannel(),
                                     partitioner=sh.DEFAULT_PARTITIONER,
                                     **kw)
    r_renamed = engine._block_runner(
        S, 0.05, tcore.CommChannel(), partitioner=dataclasses.replace(
            sh.DEFAULT_PARTITIONER, name="other"), **kw)
    assert r_default is not r_renamed
    assert engine._block_runner(S, 0.05, tcore.CommChannel(),
                                **kw) is r_default
    assert tcore.runner_cache_stats()["mesh_entries"] == 2
    tcore.clear_runner_cache()


def test_2d_resume_equals_the_uninterrupted_run(runs):
    r0 = runs["ranks"][0]
    assert r0["wrote"]
    for r in runs["ranks"]:
        got, want = r["resumed"], r["uninterrupted"]
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
        _same_ints(got, want, "resumed")


def _sine_init():
    from repro.configs.paper_models import SINE_MLP
    from repro.models.paper_nets import init_paper_model
    return {k: np.asarray(v) for k, v in
            init_paper_model(SINE_MLP, jax.random.PRNGKey(0)).items()}


@pytest.mark.parametrize("name", SINE_CASES)
def test_client_model_mesh_1x1_is_bit_for_bit_mesh_none(name):
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.data import SineTasks
    from repro_torch.models.paper_nets import paper_model_loss
    loss = functools.partial(paper_model_loss, SINE_MLP)
    outs = []
    for mesh in (None, sh.client_model_mesh(1, 1, "cpu")):
        strategy, kw = sine_case(tcore, loss, SineTasks(), name)
        outs.append(tcore.run_federated(_sine_init(), SineTasks(), strategy,
                                        mesh=mesh, device="cpu", **kw))
    for k, v in outs[0]["params"].items():
        assert torch.equal(outs[1]["params"][k], v), k
    assert outs[0]["history"] == outs[1]["history"]
    assert outs[0]["per_client_bytes"] == outs[1]["per_client_bytes"]


def test_flat_snapshot_never_resumes_into_a_2d_run(tmp_path):
    """The JAX package's tests/test_preempt_resume.py case: a snapshot of
    a mesh=None run is refused by a client_model_mesh(1, 1) run, whose
    mesh and partitioner enter the run's identity."""
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.data import SineTasks
    from repro_torch.models.paper_nets import paper_model_loss
    loss = functools.partial(paper_model_loss, SINE_MLP)
    kw = dict(rounds=4, beta=0.02, support=4, seed=1, clients_per_round=2,
              ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    tcore.run_federated(_sine_init(), SineTasks(),
                        tcore.TinyReptileStrategy(loss), **kw)
    with pytest.raises(ValueError, match="different run config"):
        tcore.run_federated(_sine_init(), SineTasks(),
                            tcore.TinyReptileStrategy(loss),
                            mesh=sh.client_model_mesh(1, 1, "cpu"),
                            resume=True, **kw)
