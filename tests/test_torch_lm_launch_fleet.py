"""The tinyreptile LM launcher's fleet and checkpoint flags, held against
the JAX launcher's ``main`` on the CPU.

Both launchers start from the JAX package's init of the reduced fp32
mamba2 (one dict per layer in both packages) at seed 0, and the JAX
launcher's JSON rows are captured from its stdout. Every row's keys,
round, client, alpha, ``comm_mb``, ``buffered``, ``flushes`` and idle
marker are exact; the losses within 1e-5. The runs: a fleet of 1,000
clients under diurnal availability with a FedBuff buffer of 2 and a
snapshot every 2 rounds (the final snapshots' phi within 1e-5 of each
other), i.i.d. participation over a fleet of 16, a Markov fleet with a
buffer of 3, and ``--buffer-size`` alone (the fleet is ``--clients``, as
the JAX launcher takes it). A resume from a snapshot the JAX launcher
wrote equals the JAX launcher's own resume of it: both draw their host
RNG anew from ``--seed``, so neither equals the run that was never
interrupted.

bf16: the JAX launcher cannot restore its own bf16 snapshot (its
``restore_checkpoint`` refuses the raw ``|V2`` leaves), so a bf16 run is
held against the port itself: a child process on the reduced mamba2 in
bf16 (bf16 weights, fp32 SSM scalars) is SIGKILLed right after a
durable snapshot, and its resume equals, row by row and leaf by leaf
bit for bit, the resume of a run that stopped cleanly after the same
snapshot.
"""
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import list_checkpoints  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "mamba2", "--reduced", "--seq", "16", "--batch", "4",
        "--k-inner", "2"]
EXACT = ("round", "client", "alpha", "comm_mb", "buffered", "flushes",
         "idle")
TOL = 1e-5


@pytest.fixture(scope="module")
def jinit():
    return jbuild(jget_arch("mamba2-130m").reduced()).init(
        jax.random.PRNGKey(0))


def jax_rows(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def port_rows(argv, init=None, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return train.run_lm(train.parse_args(argv + ["--device", "cpu"]),
                            init_params=init, **kw)


def assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for k in w:
            if k in EXACT:
                assert g[k] == w[k], (k, g, w)
            elif k != "dt_s":
                assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g,
                                                                         w)


def _phi(ckpt_dir, template):
    tree, step, extra = restore_checkpoint(str(ckpt_dir), template)
    return step, extra, bridge.flatten_tree(tree)


FLEETS = {
    "diurnal_fedbuff_ckpt": ["--rounds", "6", "--pool-size", "1000",
                             "--availability", "diurnal", "--buffer-size",
                             "2", "--ckpt-every", "2"],
    "participation": ["--rounds", "4", "--pool-size", "16",
                      "--participation", "0.5"],
    "markov_fedbuff": ["--rounds", "6", "--pool-size", "12",
                       "--availability", "markov", "--buffer-size", "3"],
    "fedbuff_over_clients": ["--rounds", "3", "--clients", "8",
                             "--buffer-size", "2"],
    # round 2 finds nobody checked in (an idle row); a tail to drain
    "diurnal_idle": ["--rounds", "8", "--pool-size", "2", "--availability",
                     "diurnal", "--buffer-size", "3"],
}


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_rows_match_the_jax_launcher(case, jinit, tmp_path,
                                           monkeypatch):
    argv = BASE + FLEETS[case]
    ckpt = "--ckpt-every" in argv
    jargv = argv + (["--ckpt-dir", str(tmp_path / "j")] if ckpt else [])
    targv = argv + (["--ckpt-dir", str(tmp_path / "t")] if ckpt else [])
    want = jax_rows(jargv, monkeypatch)
    rows, summary, phi = port_rows(targv, jinit)
    assert_rows(rows, want)
    billed = [r for r in want if not r.get("idle")]
    assert summary["comm_mb"] == billed[-1]["comm_mb"]
    if "--buffer-size" in argv:
        assert summary["flushes"] >= billed[-1]["flushes"]
    if ckpt:
        tmpl = jax.tree.map(np.asarray, jinit)
        jtree, jstep, jextra = jrestore(str(tmp_path / "j"), tmpl)
        tstep, textra, tleaves = _phi(tmp_path / "t", phi)
        assert (tstep, textra) == (jstep, jextra) == (6, {
            "arch": "mamba2-130m"})
        assert [os.path.basename(p) for p in list_checkpoints(
            str(tmp_path / "t"))] == [f"ckpt_{s:08d}.npz" for s in (2, 4,
                                                                     6)]
        for path, w in bridge.flatten_tree(jtree).items():
            np.testing.assert_allclose(tleaves[path], np.asarray(w),
                                       rtol=TOL, atol=TOL,
                                       err_msg=str(path))


def test_resume_from_a_jax_snapshot_equals_the_jax_resume(jinit, tmp_path,
                                                          monkeypatch):
    """The JAX launcher writes snapshots over 4 of 6 rounds; both
    launchers resume from its round-4 snapshot to round 6 under diurnal
    availability with a FedBuff buffer. Their rows agree, and the resumed
    port bills the 3 rounds before the resume that were not idle (round 2
    is)."""
    fleet = ["--pool-size", "2", "--availability", "diurnal",
             "--buffer-size", "2", "--ckpt-every", "2"]
    d = str(tmp_path / "ck")
    jax_rows(BASE + fleet + ["--rounds", "4", "--ckpt-dir", d], monkeypatch)
    assert jrestore(d, jax.tree.map(np.asarray, jinit))[1] == 4
    import shutil
    shutil.copytree(d, tmp_path / "port")
    want = jax_rows(BASE + fleet + ["--rounds", "6", "--ckpt-dir", d,
                                    "--resume"], monkeypatch)
    rows, _, _ = port_rows(BASE + fleet + [
        "--rounds", "6", "--ckpt-dir", str(tmp_path / "port"), "--resume"],
        jinit)
    assert [r["round"] for r in rows] == [4, 5]
    assert_rows(rows, want)
    bill = rows[1]["comm_mb"] - rows[0]["comm_mb"]
    assert abs(rows[0]["comm_mb"] - 4 * bill) <= 0.02


BF16_CHILD = """
import dataclasses, sys
import torch
torch.set_num_threads(1)
import repro_torch.configs as configs
from repro_torch.launch import train
from repro_torch.testing import faults

real = configs.get_arch


class Bf16:
    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return dataclasses.replace(self.cfg.reduced(), dtype="bfloat16")


configs.get_arch = lambda name: Bf16(real(name))
with faults.announce_snapshots():
    train.run_lm(train.parse_args(sys.argv[1:]))
"""


def _bf16_run(argv, **kw):
    """``run_lm`` in this process on the reduced mamba2 in bf16."""
    import repro_torch.configs as configs
    real = configs.get_arch

    class Bf16:
        def __init__(self, cfg):
            self.cfg = cfg

        def reduced(self):
            return dataclasses.replace(self.cfg.reduced(), dtype="bfloat16")

    configs.get_arch = lambda name: Bf16(real(name))
    try:
        return port_rows(argv, **kw)
    finally:
        configs.get_arch = real


def test_bf16_sigkill_resume_is_exact(tmp_path):
    """A child SIGKILLed right after its first durable snapshot, resumed
    here, equals a run stopped cleanly after the same snapshot and
    resumed: rows (bar wall time) and every leaf bit for bit, each leaf
    in its dtype, bf16 snapshot leaves as raw ``|V2`` bits."""
    argv = BASE + ["--rounds", "10", "--pool-size", "64", "--availability",
                   "markov", "--buffer-size", "2", "--ckpt-every", "2",
                   "--seed", "3"]
    killed = str(tmp_path / "killed")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    rc, out = faults.kill_after_snapshot(
        [sys.executable, "-c", BF16_CHILD] + argv
        + ["--device", "cpu", "--ckpt-dir", killed],
        n=1, env=env, cwd=REPO, timeout=300)
    assert rc != 0, "the child survived the kill"
    snaps = list_checkpoints(killed)
    assert snaps
    step = int(os.path.basename(snaps[-1])[5:13])
    with np.load(snaps[-1]) as data:
        kinds = {k: data[k].dtype.str for k in data.files
                 if not k.startswith("__")}
    assert kinds["layers/0/mamba/A_log"] == "<f4"
    assert kinds["layers/0/mamba/w_x"] == "|V2"
    clean = str(tmp_path / "clean")
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(step):
            _bf16_run(argv + ["--ckpt-dir", clean])
    got = _bf16_run(argv + ["--ckpt-dir", killed, "--resume"])
    want = _bf16_run(argv + ["--ckpt-dir", clean, "--resume"])
    assert [r["round"] for r in got[0]] == list(range(step, 10))
    for g, w in zip(got[0], want[0]):
        g, w = dict(g), dict(w)
        g.pop("dt_s", None)
        w.pop("dt_s", None)
        assert g == w
    gl, wl = bridge.flatten_tree(got[2]), bridge.flatten_tree(want[2])
    assert {v.dtype for v in gl.values()} == {torch.bfloat16, torch.float32}
    for k in wl:
        assert gl[k].dtype == wl[k].dtype and torch.equal(gl[k], wl[k]), k
