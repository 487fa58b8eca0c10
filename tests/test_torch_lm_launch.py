"""The engine's LM route through the train launcher and checkpoints, on
the CPU: the launcher's ``--strategy ... --arch`` row against the JAX
launcher's, a preempted LM run resumed, round states of the reduced LM
crossing between the two packages, and the mixed-dtype guard.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.data import lm_loss as jlm_loss  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data import lm_loss  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

from test_torch_lm_engine import (RUN, assert_same_lm_run,  # noqa: E402,F401
                                  mamba2)

SMALL = ["--rounds", "2", "--clients", "2", "--batch", "2", "--seq", "16"]


@pytest.mark.parametrize("argv", [
    ["--strategy", "reptile", "--arch", "transformer"],
    ["--strategy", "fedsgd", "--arch", "mamba2", "--seed", "3"],
    ["--strategy", "transfer", "--arch", "mamba2"],
    ["--strategy", "fedavg", "--arch", "transformer", "--pool-size", "8",
     "--pool-sampler", "vectorized", "--availability", "diurnal",
     "--buffer-size", "2"],
])
def test_lm_row_matches_the_jax_launcher(argv, capsys):
    """Both launchers from the JAX package's init at the same seed: the
    row's keys (the arch among them), comm_mb exact, query_loss within
    1e-4 (both rounded to 4 places)."""
    from repro.configs import get_arch as jget_arch
    from repro.models import build_model as jbuild

    jargs = jtrain.parse_args(argv + SMALL)
    jtrain.run_engine_strategy(jargs)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jm = jbuild(jget_arch(jtrain.ARCH_FAMILIES[jargs.arch]).reduced())
    init = bridge.lm_params_from_jax(jm.init(jax.random.PRNGKey(jargs.seed)),
                                     None, "cpu")
    got, out = train.run_engine_strategy(
        train.parse_args(argv + SMALL + ["--device", "cpu"]),
        init_params=init)
    assert set(want) <= set(got)
    for key in ("strategy", "rounds", "clients", "arch"):
        assert got[key] == want[key], key
    assert got.get("comm_mb") == want.get("comm_mb")
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12
    assert isinstance(out["params"]["layers"], list)


def test_lm_launcher_resumes_the_uninterrupted_run(tmp_path):
    """``--strategy reptile --arch mamba2 --ckpt-dir D --ckpt-every 1``,
    killed after its round-1 snapshot, then ``--resume``: the row and the
    params of the run that was never killed, exactly."""
    argv = ["--strategy", "reptile", "--arch", "mamba2", "--device",
            "cpu"] + SMALL
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    want, ref = train.run_engine_strategy(train.parse_args(argv))
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(1):
            train.run_engine_strategy(train.parse_args(argv + ck))
    got, out = train.run_engine_strategy(
        train.parse_args(argv + ck + ["--resume"]))
    for key in set(want) - {"dt_s", "kernel_launches"}:
        assert got[key] == want[key], key
    for path, v in bridge.tree_leaves(ref["params"]):
        assert torch.equal(bridge.flatten_tree(out["params"])[path], v), path


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_lm_round_state_crosses_packages(mamba2, direction,  # noqa: F811
                                         tmp_path):
    """A pooled, buffered TinyReptile run of the reduced mamba2 crashed by
    one package right after its round-2 snapshot, resumed by the other:
    the resuming package's own uninterrupted run, the pool state and the
    bills exactly, the params within 1e-5. The snapshot holds phi and
    the FedBuff buffer leaf by leaf under the JAX package's tree paths
    (``phi/layers/0/mamba/w_x``, ``pool/3/embed``, ...)."""
    def run(side, **extra):
        core = (jcore, tcore)[side]
        jd, td = mamba2.dists()
        dist = (jd, td)[side]
        loss = (jlm_loss(mamba2.jm), lm_loss(mamba2.tm))[side]
        kw = dict(RUN, rounds=4, seed=8,
                  pool=core.ClientPool(dist, 12, seed=1,
                                       sampler="vectorized"),
                  buffered=core.BufferedAggregation(3), **extra)
        if side:
            kw["device"] = "cpu"
        return core.run_federated(mamba2.init, dist,
                                  core.TinyReptileStrategy(loss), **kw)

    first, then = (0, 1) if direction == "jax_to_torch" else (1, 0)
    crash = (jfaults, faults)[first]
    ck = dict(ckpt_dir=str(tmp_path), ckpt_every=2)
    with pytest.raises(crash.SimulatedPreemption):
        with crash.crash_at_round(2):
            run(first, ckpt_async=False, **ck)
    with np.load(tmp_path / "ckpt_00000002.npz") as data:
        keys = set(data.files)
    assert {"phi/layers/0/mamba/w_x", "phi/embed", "pool/3/embed",
            "pool/3/layers/1/norm1"} <= keys
    res = run(then, resume=True, **ck)
    ref = run(then)
    if then == 1:
        assert_same_lm_run(res, {**ref, "params": jax.tree.map(
            lambda t: t.numpy(), ref["params"])})
    else:
        assert_same_lm_run({**res, "params": jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), res["params"])}, ref)
    for k, v in ref["pool_state"].items():
        np.testing.assert_array_equal(np.asarray(res["pool_state"][k]),
                                      np.asarray(v), err_msg=k)


def test_mixed_dtype_tree_raises(mamba2):  # noqa: F811
    """A tree mixing fp32 and bf16 leaves raised until slice 17; the
    engine now keeps one flat buffer per dtype group, so it runs and
    hands every leaf back in its own dtype (held against the JAX engine
    in test_torch_mixed_engine.py)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    tm = build_model(dataclasses.replace(get_arch("mamba2-130m").reduced(),
                                         dtype="bfloat16"))
    init = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {v.dtype for v in bridge.flatten_tree(init).values()} == {
        torch.bfloat16, torch.float32}
    _, td = mamba2.dists()
    out = tcore.run_federated(init, td, tcore.ReptileStrategy(lm_loss(tm)),
                              device="cpu", **RUN)
    leaves = bridge.flatten_tree(out["params"])
    for path, leaf in bridge.flatten_tree(init).items():
        assert leaves[path].dtype == leaf.dtype, path
        assert torch.isfinite(leaves[path].float()).all(), path