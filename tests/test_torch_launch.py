"""The port's serve and train launchers, its device rule, and its
isolation from JAX and from the JAX package."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("argv,msg", [
    (["--strategy", "fp32", "--k-max", "12", "--support", "10"], "support"),
    (["--strategy", "tifed", "--support", "10"], "power of two"),
    (["--slots", "0"], "slots"),
    (["--k-max", "0"], "k-max"),
    (["--steps-per-tick", "0"], "steps-per-tick"),
    (["--requests", "0"], "requests"),
    (["--mode", "decode"], "invalid choice"),
    (["--arch", "tinyllama-1.1b"], "unrecognized"),
    (["--device", "tpu"], "invalid choice"),
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
                                      "online_sgd_momentum": 0}
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
    ([], "--strategy tinyreptile is not ported yet"),
    (["--strategy", "tifed"], "--strategy tifed is not ported yet"),
    (["--strategy", "reptile", "--arch", "transformer"],
     "--arch is not ported yet"),
    (["--strategy", "reptile", "--reduced"], "--reduced is not ported yet"),
    (["--strategy", "fedavg", "--pool-size", "100"],
     "--pool-size is not ported yet"),
    (["--strategy", "reptile", "--availability", "diurnal"],
     "--availability is not ported yet"),
    (["--strategy", "reptile", "--buffer-size", "4"],
     "--buffer-size is not ported yet"),
    (["--strategy", "reptile", "--mesh", "clients:2"],
     "--mesh is not ported yet"),
    (["--strategy", "reptile", "--devices", "2"], "--devices is not ported"),
    (["--strategy", "reptile", "--ckpt-dir", "x"], "--ckpt-dir is not"),
    (["--strategy", "reptile", "--resume"], "--resume is not ported yet"),
    (["--strategy", "reptile", "--num-processes", "2"],
     "--num-processes is not ported yet"),
    (["--strategy", "reptile", "--participation", "0"], "participation"),
    (["--strategy", "reptile", "--device", "tpu"], "invalid choice"),
])
def test_train_parse_rejects_unported_flags(argv, msg, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(argv)
    assert msg in capsys.readouterr().err


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
