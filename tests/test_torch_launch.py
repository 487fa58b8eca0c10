"""The port's serve and train launchers, its device rule, and its
isolation from JAX and from the JAX package."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("argv,msg", [
    (["--mode", "adapt", "--strategy", "fp32", "--k-max", "12", "--support",
      "10"], "support"),
    (["--mode", "adapt", "--strategy", "tifed", "--support", "10"],
     "power of two"),
    (["--mode", "adapt", "--slots", "0"], "slots"),
    (["--mode", "adapt", "--k-max", "0"], "k-max"),
    (["--mode", "adapt", "--steps-per-tick", "0"], "steps-per-tick"),
    (["--mode", "adapt", "--requests", "0"], "requests"),
    (["--mode", "decode"], "--arch is required for --mode decode"),
    (["--mode", "adapt", "--arch", "tinyllama-1.1b"],
     "--arch only applies with --mode decode"),
    (["--mode", "adapt", "--device", "tpu"], "invalid choice"),
])
def test_parse_rejects_bad_flags(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert msg in capsys.readouterr().err


def _run(args, timeout=120, launcher="serve"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m",
                           f"repro_torch.launch.{launcher}", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=str(ROOT))


@pytest.mark.parametrize("strategy,extra", [
    ("fp32", []), ("tifed", ["--support", "8", "--k-max", "6"])])
def test_cpu_run_prints_the_json_row(strategy, extra):
    out = _run(["--mode", "adapt", "--device", "cpu", "--strategy", strategy,
                "--requests", "12", "--slots", "4", *extra])
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout)
    assert row["requests"] == 12 and row["strategy"] == strategy
    assert row["device"] == "cpu"
    assert row["kernel_launches"] == {"online_sgd": 0, "dfa_epoch_int8": 0,
                                      "meta_update": 0,
                                      "online_sgd_momentum": 0,
                                      "ssd_scan": 0, "flash_decode": 0,
                                      "client_mean": 0}
    assert set(row["latency_ms"]) == {"p50", "p95", "p99"}
    assert row["mean_query_loss"] == row["mean_query_loss"]     # finite


def test_without_cuda_the_entry_points_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["--mode", "adapt", "--requests", "2"])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    out = _run(["--strategy", "reptile", "--rounds", "1"], launcher="train")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_port_imports_without_jax():
    """Every module of the port imports with ``jax`` unimportable."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\nprint('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\.|"
                     r"from repro import|import repro$)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


@pytest.mark.parametrize("argv,msg", [
    ([], "--arch is required for the tinyreptile LM launcher"),
    (["--strategy", "tifed", "--arch", "mamba2"],
     "--strategy tifed runs TIFeD integer-only training"),
    (["--strategy", "reptile", "--arch", "tinyllama-1.1b"],
     "meta-trains a reduced LM family"),
    (["--strategy", "fedavg", "--pool-size", "10"],
     "--pool-size 10 cannot seat a cohort of --clients 64"),
    (["--strategy", "reptile", "--availability", "diurnal"],
     "--availability needs a persistent fleet"),
    (["--strategy", "reptile", "--buffer-size", "4"],
     "--buffer-size (FedBuff) needs persistent clients"),
    (["--strategy", "reptile", "--mesh", "clients:2,model:2",
      "--num-processes", "2", "--coordinator", "h:1"],
     "--num-processes 2: the port runs one process a rank, so the client "
     "mesh is those 2 ranks (got a mesh of 4)"),
    (["--strategy", "reptile", "--mesh", "clients:2", "--devices", "2"],
     "--mesh clients:2 already sizes the client mesh; drop --devices"),
    (["--strategy", "tifed", "--mesh", "clients:2,model:2"],
     "--strategy tifed uplinks NATIVE int8 trees whose quantization grids "
     "need each parameter tensor whole on every device; a model-sharded "
     "mesh splits them — use --mesh clients:K (no model axis)"),
    (["--arch", "mamba2", "--participation", "0.5", "--availability",
      "diurnal"], "--availability replaces the i.i.d. --participation"),
    (["--strategy", "reptile", "--resume"],
     "--resume restores from --ckpt-dir; pass both"),
    (["--strategy", "reptile", "--num-processes", "2"],
     "--num-processes > 1 is a cross-host run; pass the shared "
     "--coordinator"),
    (["--strategy", "reptile", "--participation", "0"], "participation"),
    (["--strategy", "reptile", "--device", "tpu"], "invalid choice"),
    (["--arch", "mamba2", "--resume"],
     "--resume restores from --ckpt-dir; pass both"),
    (["--arch", "mamba2", "--ckpt-every", "0"], "must be >= 1"),
    (["--strategy", "tifed", "--ckpt-every", "0"], "must be >= 1"),
])
def test_train_parse_rejects_unported_flags(argv, msg, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--strategy", "reptile", "--num-processes", "2"],
    ["--strategy", "reptile", "--coordinator", "h:1"],
    ["--strategy", "reptile", "--coordinator", "h:1", "--num-processes",
     "2", "--process-id", "2"],
    ["--strategy", "tinyreptile", "--arch", "mamba2-130m", "--coordinator",
     "h:1", "--num-processes", "2"],
    ["--arch", "mamba2-130m", "--devices", "2"],
    ["--arch", "mamba2-130m", "--mesh", "pod", "--buffer-size", "2"],
    ["--arch", "mamba2-130m", "--mesh", "clients:2"],
    ["--strategy", "reptile", "--mesh", "data"],
    ["--strategy", "reptile", "--mesh", "clients:0"],
    ["--strategy", "reptile", "--mesh", "model:2"],
    ["--strategy", "reptile", "--mesh", "clients:2,clients:2"],
    ["--strategy", "tifed", "--mesh", "clients:2,model:2"],
    ["--strategy", "reptile", "--mesh", "clients:2", "--devices", "2"],
])
def test_train_parse_rejects_what_the_jax_launcher_rejects(argv):
    """The JAX launcher's distributed and mesh parse checks
    (tests/test_distributed.py, tests/test_launch.py): both launchers
    refuse each of these at parse time."""
    from repro.launch import train as jtrain
    for parse in (jtrain.parse_args, train.parse_args):
        with pytest.raises(SystemExit):
            parse(argv)


@pytest.mark.parametrize("argv,ranks,mesh", [
    (["--strategy", "reptile", "--devices", "2"], 2, "none"),
    (["--strategy", "reptile", "--mesh", "clients:3"], 3,
     {"clients": 3}),
    (["--strategy", "tifed", "--num-processes", "2", "--coordinator",
      "h:1", "--process-id", "1"], 2, "none"),
    (["--arch", "mamba2", "--mesh", "pod", "--devices", "2"], 2, "pod"),
    (["--arch", "mamba2", "--mesh", "data", "--devices", "2", "--batch",
      "16", "--device", "cpu"], 2, "data"),
    (["--arch", "mamba2", "--mesh", "pod", "--device", "cpu"], 1, "pod"),
    (["--strategy", "reptile", "--arch", "transformer", "--mesh",
      "clients:2,model:2"], 4, {"clients": 2, "model": 2}),
    (["--strategy", "fedavg", "--mesh", "clients:1,model:2",
      "--num-processes", "2", "--coordinator", "h:1"], 2,
     {"clients": 1, "model": 2}),
])
def test_train_parse_takes_the_mesh_and_process_flags(argv, ranks, mesh):
    args = train.parse_args(argv)
    assert args.ranks == ranks and args.mesh == mesh


@pytest.mark.parametrize("argv", [
    ["--strategy", "reptile", "--rounds", "3", "--clients", "3",
     "--devices", "2"],
    ["--arch", "mamba2", "--reduced", "--rounds", "2", "--mesh", "pod",
     "--devices", "2"],
])
def test_train_starts_its_own_ranks_on_the_cpu(argv):
    """--devices N starts N gloo ranks; rank 0 alone prints."""
    out = _run(argv + ["--device", "cpu"], launcher="train", timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == (1 if "--strategy" in argv else 3)
    if "--mesh" in argv:
        assert rows[-1]["mesh"] == "pod"
        assert all(np.isfinite(r["loss"]) for r in rows[:-1])
    else:
        assert np.isfinite(rows[0]["query_loss"])


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2", "--ckpt-dir", "x"],
    ["--arch", "mamba2", "--ckpt-every", "5"],
    ["--arch", "mamba2", "--ckpt-dir", "x", "--resume"],
])
def test_train_parse_takes_the_lm_checkpoint_flags(argv):
    """The LM launcher's checkpoint flags parse (rejected until slice
    17)."""
    args = train.parse_args(argv)
    assert args.strategy == "tinyreptile" and args.arch == "mamba2-130m"
    assert args.ckpt_every == (5 if "--ckpt-every" in argv else 10)
    assert args.resume == ("--resume" in argv)


def test_train_parse_takes_the_vlm_config():
    """``--arch paligemma-3b`` parses (rejected until slice 16)."""
    args = train.parse_args(["--arch", "paligemma-3b"])
    assert args.arch == "paligemma-3b" and args.strategy == "tinyreptile"


def test_train_cpu_run_prints_the_json_row():
    out = _run(["--strategy", "fedavg", "--device", "cpu", "--rounds", "2",
                "--clients", "4"], launcher="train")
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout)
    assert row["strategy"] == "fedavg" and row["device"] == "cpu"
    assert row["comm_mb"] == round(2 * 4 * 2 * 4612 / 2 ** 20, 3)
    assert row["kernel_launches"] == {k: 0 for k in row["kernel_launches"]}
    assert row["query_loss"] == row["query_loss"]          # finite


@pytest.mark.parametrize("argv", [
    ["--strategy", "reptile", "--rounds", "5", "--clients", "16"],
    ["--strategy", "fedsgd", "--rounds", "6", "--clients", "8",
     "--participation", "0.5", "--seed", "3"],
    ["--strategy", "transfer", "--rounds", "8", "--clients", "4"],
])
def test_train_row_matches_the_jax_launcher(argv, capsys):
    """The port's row against the JAX launcher's, both from the JAX
    package's init at the same seed: comm_mb exact, query_loss within
    1e-4 (both rounded to 4 places, so one unit of the last place)."""
    import jax
    import numpy as np

    from repro.configs.paper_models import SINE_MLP
    from repro.launch import train as jtrain
    from repro.models.paper_nets import init_paper_model

    jargs = jtrain.parse_args(argv)
    jtrain.run_engine_strategy(jargs)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    init = {k: np.asarray(v) for k, v in init_paper_model(
        SINE_MLP, jax.random.PRNGKey(jargs.seed)).items()}
    got, out = train.run_engine_strategy(
        train.parse_args(argv + ["--device", "cpu"]), init_params=init)
    assert out["history"][-1]["round"] == got["rounds"]
    assert got.get("comm_mb") == want.get("comm_mb")
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12
    for key in ("strategy", "rounds", "clients"):
        assert got[key] == want[key]


@pytest.mark.parametrize("strategy", ["reptile", "fedavg", "fedsgd",
                                      "transfer", "tifed"])
def test_train_accepts_the_checkpoint_flags(strategy):
    args = train.parse_args(["--strategy", strategy, "--ckpt-dir", "d",
                             "--ckpt-every", "4", "--resume",
                             "--pool-size", "64", "--availability",
                             "markov"])
    assert (args.ckpt_dir, args.ckpt_every, args.resume) == ("d", 4, True)
    assert train.parse_args(["--strategy", strategy]).ckpt_every == 10


def test_train_resume_prints_the_uninterrupted_row(tmp_path):
    """``--strategy reptile --ckpt-dir D --ckpt-every 4 --rounds 8``,
    killed after its round-4 snapshot, then ``--resume``: the row of the
    run that was never killed."""
    from repro_torch.testing import faults

    argv = ["--strategy", "reptile", "--rounds", "8", "--clients", "8",
            "--device", "cpu"]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    want, ref = train.run_engine_strategy(train.parse_args(argv))
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(4):
            train.run_engine_strategy(train.parse_args(argv + ck))
    got, out = train.run_engine_strategy(
        train.parse_args(argv + ck + ["--resume"]))
    for key in set(want) - {"dt_s", "kernel_launches"}:
        assert got[key] == want[key], key
    for k, v in ref["params"].items():
        assert torch.equal(out["params"][k], v), k


def test_serve_adapt_serves_a_port_written_round_state(tmp_path):
    """``serve --mode adapt --ckpt-dir D`` serves the phi of a round
    state the port's train launcher wrote: the same requests as when
    serving those params from a bare snapshot, and not the init's."""
    from repro_torch.checkpoint import load_params, save_checkpoint

    d = str(tmp_path / "round")
    _, out = train.run_engine_strategy(train.parse_args(
        ["--strategy", "reptile", "--rounds", "4", "--clients", "4",
         "--device", "cpu", "--ckpt-dir", d, "--ckpt-every", "2"]))
    trained = {k: v.numpy() for k, v in out["params"].items()}
    got = load_params(d, trained)
    for k, v in trained.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    save_checkpoint(str(tmp_path / "bare"), trained, 4)
    base = ["--mode", "adapt", "--device", "cpu", "--requests", "8",
            "--slots", "4"]
    rows = [serve.run_adapt(serve.parse_args(base + extra)) for extra in (
        ["--ckpt-dir", d], ["--ckpt-dir", str(tmp_path / "bare")], [])]
    assert rows[0]["mean_query_loss"] == rows[1]["mean_query_loss"]
    assert rows[0]["mean_query_loss"] != rows[2]["mean_query_loss"]
    assert rows[0]["requests"] == 8


# the JAX launcher's 2-D route at the reduced transformer
MESH2D_ARGV = ["--strategy", "reptile", "--arch", "transformer", "--mesh",
               "clients:2,model:2", "--rounds", "2", "--clients", "4",
               "--seed", "2"]


def _mesh2d_rank(rank, init):
    """One of the four ranks of the port's ``--mesh clients:2,model:2``
    row, from the JAX launcher's init."""
    row, _ = train.run_engine_strategy(train.parse_args(
        MESH2D_ARGV + ["--num-processes", "4", "--coordinator",
                       "127.0.0.1:1", "--process-id", str(rank),
                       "--device", "cpu"]), init_params=init)
    return row


def test_train_2d_row_matches_the_jax_launchers(tmp_path):
    """The port's ``--mesh clients:2,model:2 --arch transformer`` row (four
    gloo ranks, each holding its shard of the reduced tinyllama) against
    the JAX launcher's on four forced host devices, from the JAX init:
    comm_mb exact, query_loss within one unit of its 4th place."""
    import jax

    from repro.configs import get_arch
    from repro.models import build_model
    from repro_torch.runtime.ranks import run_ranks

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train"] + MESH2D_ARGV,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        model = build_model(get_arch("tinyllama-1.1b").reduced())
        init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(2)))
        rows = run_ranks(_mesh2d_rank, 4, str(tmp_path), init, device="cpu")
        out, err = jax_proc.communicate(timeout=300)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        jax_proc.kill()
    want = json.loads(out.strip().splitlines()[-1])
    got = rows[0]
    for key in ("strategy", "rounds", "clients", "arch", "mesh", "comm_mb"):
        assert got[key] == want[key], (key, got, want)
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12
    for r in rows[1:]:
        assert {k: v for k, v in r.items() if k != "dt_s"} == {
            k: v for k, v in got.items() if k != "dt_s"}
