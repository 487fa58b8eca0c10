"""The port's Mamba2 LM meta-training path against the JAX package's, on
the CPU: configs, the model (loss, prefill logits, gradients), one
TinyReptile round (``make_meta_train_step``), the client stream, the
alpha schedule, the LM launcher's rows, and the bridge's layouts.

The JAX package's init (``jax.random``) is carried over with
``bridge.lm_params_from_jax``. Reduced fp32 config, both JAX routes
(``feature_scope(ssd_pallas=True)`` and the default jnp scan):
loss and prefill logits at 1e-5, every leaf's gradient and one round
with K = 2 at 1e-4. bf16 variant: the two frameworks round bf16 at
other places (matmul accumulation, elementwise fusion), so it is held
to 4 bf16 steps (rtol 2^-6) and the loss to 1e-3 relative.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import LMClientStream as JStream  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim.schedules import linear_anneal as jlinear_anneal  # noqa: E402
from repro.runtime.flags import feature_scope  # noqa: E402
from repro.runtime.steps import make_meta_train_step as jmeta_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.engine import CommChannel  # noqa: E402
from repro_torch.data import LMClientStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import Model, build_model  # noqa: E402
from repro_torch.optim.schedules import linear_anneal  # noqa: E402
from repro_torch.runtime.steps import (make_meta_train_step,  # noqa: E402
                                       microbatch)

ROUTES = ("default", "ssd_pallas")
BETA, ALPHA = 0.02, 0.7


def _cfgs(layers=2, dtype="float32"):
    j = dataclasses.replace(jget_arch("mamba2-130m").reduced(),
                            num_layers=layers, dtype=dtype)
    t = dataclasses.replace(get_arch("mamba2-130m").reduced(),
                            num_layers=layers, dtype=dtype)
    return j, t


def _batch(vocab, shape, seed):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, shape).astype(np.int32)
    lab = np.concatenate([tok[..., 1:], np.full(shape[:-1] + (1,), -1,
                                                np.int32)], axis=-1)
    return {"tokens": tok, "labels": lab}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


class _Case:
    """One config: the JAX model and init, the port's model and the init
    carried over, and the JAX results computed once per route."""

    def __init__(self, layers, dtype):
        jcfg, tcfg = _cfgs(layers, dtype)
        self.jm, self.tm = jbuild(jcfg), build_model(tcfg)
        self.phi = self.jm.init(jax.random.PRNGKey(0))
        self.batch = _batch(jcfg.vocab_size, (2, 40), 1)
        self.meta_batch = _batch(jcfg.vocab_size, (2, 2, 24), 2)
        self._jax = {}

    def port_params(self):
        return bridge.lm_params_from_jax(self.phi, self.tm.jax_layout,
                                         "cpu")

    def jax(self, route):
        if route not in self._jax:
            with feature_scope(ssd_pallas=route == "ssd_pallas"):
                loss, grads = jax.jit(jax.value_and_grad(self.jm.loss_fn))(
                    self.phi, _jb(self.batch))
                logits = jax.jit(self.jm.prefill_fn)(self.phi, _jb(self.batch))
                new_phi, metrics = jax.jit(jmeta_step(self.jm, beta=BETA))(
                    self.phi, _jb(self.meta_batch), jnp.float32(ALPHA))
            self._jax[route] = dict(
                loss=float(loss), logits=np.asarray(logits, np.float32),
                grads=bridge.flatten_tree(jax.tree.map(
                    lambda a: np.asarray(a, np.float32), grads)),
                new_phi=bridge.flatten_tree(jax.tree.map(
                    lambda a: np.asarray(a, np.float32), new_phi)),
                metrics={k: float(v) for k, v in metrics.items()})
        return self._jax[route]


@pytest.fixture(scope="module")
def fp32():
    return _Case(2, "float32")


@pytest.fixture(scope="module")
def bf16():
    return _Case(2, "bfloat16")


def _port_grads(case):
    leaves = {k: v.requires_grad_()
              for k, v in bridge.flatten_tree(case.port_params()).items()}
    loss = case.tm.loss_fn(bridge.unflatten_tree(leaves), _tb(case.batch))
    loss.backward()
    grads = bridge.lm_params_to_jax(
        bridge.unflatten_tree({k: v.grad for k, v in leaves.items()}),
        case.tm.jax_layout)
    return loss.item(), bridge.flatten_tree(grads)


def _port_round(case):
    step = make_meta_train_step(case.tm, beta=BETA)
    new_phi, metrics = step(case.port_params(), _tb(case.meta_batch), ALPHA)
    return (new_phi, bridge.flatten_tree(bridge.lm_params_to_jax(
        new_phi, case.tm.jax_layout)),
        {k: float(v) for k, v in metrics.items()})


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_a_copy_of_the_jax_package(reduced):
    j, t = jget_arch("mamba2-130m"), get_arch("mamba2-130m")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()


def test_full_width_param_shapes_match_the_jax_init():
    """mamba2-130m's tree, shape for shape and dtype for dtype, against
    jax.eval_shape of the JAX package's init (no allocation)."""
    jm, tm = jbuild(jget_arch("mamba2-130m")), build_model(
        get_arch("mamba2-130m"))
    assert tm.use_scan == jm.use_scan and tm.jax_layout == 1
    want = bridge.flatten_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    got = {}
    for path, (shape, dtype) in bridge.tree_leaves(tm.param_shapes()):
        if path[0] == "layers":          # JAX stacks the 24 layers
            key = ("layers", 0) + path[2:]
            prev = got.get(key, (0, shape, dtype))
            got[key] = (prev[0] + 1, shape, dtype)
        else:
            got[path] = (None, shape, dtype)
    assert set(got) == set(want)
    counts = {}
    for path, (n, shape, dtype) in got.items():
        w = want[path]
        assert w.shape == ((n,) if n else ()) + tuple(shape), path
        assert w.dtype.name == str(dtype).split(".")[1], path
        key = w.dtype.name
        counts[key] = counts.get(key, 0) + int(np.prod(w.shape))
    assert counts == {"bfloat16": 128_981_760, "float32": 1_728}


def test_other_families_are_not_ported_yet():
    """Every family builds and runs every path: a dense model trains,
    prefills and decodes, a Mamba2 model has a decode cache, and since
    slice 16 the encoder-decoder (with its frames and a cross cache) and
    the VLM (with its patch embeddings) do too, where they raised at
    construction before (the MoE and hybrid families are held in
    test_torch_moe.py and test_torch_hybrid.py, these two against the JAX
    package in test_torch_encdec_vlm.py)."""
    cfg = ArchConfig(name="dense", family="dense", source="-", num_layers=2,
                     d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                     vocab_size=64, head_dim=64, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cache = model.init_cache(2, 8, device="cpu")
    with torch.no_grad():
        logits, cache = model.decode_fn(params, {
            "tokens": torch.tensor([[3], [5]]), "cache": cache,
            "cache_len": 0})
    assert logits.shape == (2, 1, 64) and torch.isfinite(logits).all()
    assert cache["layers"][0]["k"][:, 0].abs().sum() > 0
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
             "labels": torch.zeros(2, 8, dtype=torch.int32)}
    with torch.no_grad():
        assert torch.isfinite(model.loss_fn(params, batch))
        assert model.prefill_fn(params, batch).shape == (2, 1, 64)
    for family, extra in (("audio", dict(encoder_layers=2,
                                         encoder_tokens=16)),
                          ("vlm", dict(frontend="vision",
                                       frontend_tokens=8))):
        other = Model(dataclasses.replace(cfg, name=family, family=family,
                                          **extra))
        p = other.init(torch.Generator().manual_seed(1), "cpu")
        b = dict(batch)
        if family == "audio":
            b["frames"] = torch.randn(2, 16, 64)
        else:
            b["patch_embeds"] = torch.randn(2, 8, 64)
        c = other.init_cache(2, 8, device="cpu")
        assert ("cross" in c) == (family == "audio")
        with torch.no_grad():
            assert torch.isfinite(other.loss_fn(p, b))
            assert other.prefill_fn(p, b).shape == (2, 1, 64)
            lg, _ = other.decode_fn(p, {"tokens": torch.tensor([[3], [5]]),
                                        "cache": c, "cache_len": 0})
        assert lg.shape == (2, 1, 64) and torch.isfinite(lg).all()
    ssm = Model(get_arch("mamba2-130m").reduced()).init_cache(2, 8,
                                                              device="cpu")
    assert set(ssm["layers"][0]) == {"conv", "ssm"}


# -- the model and one round, fp32 ------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_loss_and_prefill_match_jax(fp32, route):
    want = fp32.jax(route)
    params = fp32.port_params()
    with torch.no_grad():
        loss = fp32.tm.loss_fn(params, _tb(fp32.batch))
        logits = fp32.tm.prefill_fn(params, _tb(fp32.batch))
    assert abs(float(loss) - want["loss"]) <= 1e-5
    assert logits.dtype == torch.float32 and logits.shape == (2, 1, 512)
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_every_gradient_matches_jax(fp32, route):
    want = fp32.jax(route)["grads"]
    _, got = _port_grads(fp32)
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("route", ROUTES)
def test_meta_train_step_matches_jax(fp32, route):
    want = fp32.jax(route)
    _, got, metrics = _port_round(fp32)
    for k, v in want["metrics"].items():
        assert abs(metrics[k] - v) <= 1e-4, k
    for path, p in want["new_phi"].items():
        np.testing.assert_allclose(got[path], p, rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_scan_stacked_layout_maps_both_ways():
    """A 4-layer variant, which the JAX package stacks over layers: the
    bridge unstacks it into one dict per layer and stacks it back
    exactly, and the loss agrees at 1e-5."""
    case = _Case(4, "float32")
    assert case.jm.use_scan and case.tm.jax_layout == 1
    params = case.port_params()
    assert isinstance(params["layers"], list) and len(params["layers"]) == 4
    np.testing.assert_array_equal(
        params["layers"][2]["mamba"]["w_x"].numpy(),
        np.asarray(case.phi["layers"][0]["mamba"]["w_x"][2]))
    back = bridge.flatten_tree(bridge.lm_params_to_jax(params, 1))
    want = bridge.flatten_tree(jax.tree.map(np.asarray, case.phi))
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v)
    with torch.no_grad():
        loss = case.tm.loss_fn(params, _tb(case.batch))
    jloss = jax.jit(case.jm.loss_fn)(case.phi, _jb(case.batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5


# -- bf16: two dtype groups --------------------------------------------------

def test_bf16_round_keeps_dtypes_and_matches_jax(bf16, monkeypatch):
    """Mixed dtypes: one flat buffer and one online_sgd call per dtype
    group per step, one meta_update call per group per round, each leaf
    back in its own dtype; values at the bf16 tolerance."""
    calls = {"online_sgd": [], "meta_update": []}
    for name in calls:
        real = getattr(ops, name)

        def spy(p, *a, _real=real, _name=name):
            calls[_name].append(p.dtype)
            return _real(p, *a)
        monkeypatch.setattr(ops, name, spy)
    want = bf16.jax("default")
    new_phi, got, metrics = _port_round(bf16)
    assert calls["online_sgd"] == [torch.bfloat16, torch.float32] * 2
    assert calls["meta_update"] == [torch.bfloat16, torch.float32]
    for path, leaf in bridge.tree_leaves(new_phi):
        fp32_leaf = path[-1] in ("dt_bias", "A_log", "D")
        assert leaf.dtype == (torch.float32 if fp32_leaf else torch.bfloat16)
    for k, v in want["metrics"].items():
        assert abs(metrics[k] - v) <= 1e-3 * abs(v), k
    for path, p in want["new_phi"].items():
        np.testing.assert_allclose(got[path], p, rtol=2 ** -6, atol=2 ** -8,
                                   err_msg=str(path))


def test_bf16_loss_matches_jax(bf16):
    want = bf16.jax("default")
    loss, grads = _port_grads(bf16)
    assert abs(loss - want["loss"]) <= 1e-3 * abs(want["loss"])
    for path, g in want["grads"].items():
        np.testing.assert_allclose(grads[path], g, rtol=2 ** -6,
                                   atol=2 ** -6, err_msg=str(path))


# -- data, schedule, bridge, comm ----------------------------------------------

@pytest.mark.parametrize("vocab,cid,batch,seq", [
    (512, 0, 4, 32), (50_280, 7, 2, 64), (1000, 63, 8, 16)])
def test_client_stream_is_bit_equal(vocab, cid, batch, seq):
    j, t = JStream(vocab, cid), LMClientStream(vocab, cid)
    assert j.zipf_a == t.zipf_a and j.succ_p == t.succ_p
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        a, b = j.batch(rj, batch, seq), t.batch(rt, batch, seq)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_linear_anneal_is_float32_equal():
    for lr, total in ((1.0, 20), (0.37, 7), (2.5, 999)):
        j = jlinear_anneal(lr, total, floor=lr * 0.1)
        t = linear_anneal(lr, total, floor=lr * 0.1)
        for step in range(-1, total + 2):
            assert float(j(step)) == float(t(step))
            assert t(step).dtype == np.float32


def test_bridge_takes_nested_lists_and_bf16():
    import ml_dtypes
    tree = {"layers": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3)
                        .astype(ml_dtypes.bfloat16)},
                       {"w": np.ones((2, 3), ml_dtypes.bfloat16)}],
            "b": np.zeros(4, np.float32)}
    got = bridge.params_from_numpy(tree, "cpu")
    assert isinstance(got["layers"], list)
    assert got["layers"][0]["w"].dtype == torch.bfloat16
    assert got["b"].dtype == torch.float32
    back = bridge.params_to_numpy(got)
    np.testing.assert_array_equal(back["layers"][0]["w"],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert back["layers"][1]["w"].dtype == np.float32


def test_flat_layout_per_dtype_round_trips():
    """One flat buffer per leaf dtype (``GroupedLayout``, which took the
    place of ``FlatLayout.per_dtype``), groups in first-seen order."""
    tree = {"e": torch.randn(3, 2).bfloat16(),
            "layers": [{"A": torch.randn(2), "w": torch.randn(2, 2).bfloat16()}]}
    layout = bridge.GroupedLayout.of_tree(tree)
    assert layout.dtypes == (torch.bfloat16, torch.float32)
    flats = layout.pack(layout.named(tree))
    assert flats[0].shape == (10,) and flats[0].dtype == torch.bfloat16
    assert flats[1].dtype == torch.float32
    rebuilt = layout.tree_views(flats)
    for path, leaf in bridge.tree_leaves(tree):
        torch.testing.assert_close(bridge.flatten_tree(rebuilt)[path], leaf,
                                   rtol=0, atol=0)


def test_comm_channel_bills_a_nested_tree():
    tree = {"embed": np.zeros((10, 4)), "layers": [{"w": np.zeros((4, 4))},
                                                   {"w": np.zeros(3)}]}
    assert CommChannel().payload_bytes(tree) == (40 + 16 + 3) * 4
    assert CommChannel("int8").payload_bytes(tree) == 40 + 16 + 3


def test_microbatch_splits_the_leading_axis():
    b = {"tokens": np.arange(24).reshape(8, 3)}
    m = microbatch(b, 4)
    assert m["tokens"].shape == (4, 2, 3)
    np.testing.assert_array_equal(m["tokens"][1], b["tokens"][2:4])


# -- the launcher ------------------------------------------------------------------

def test_lm_launcher_rows_match_the_jax_launcher(monkeypatch):
    """Both launchers from the JAX package's init: every row's keys and
    client, alpha and comm_mb exact; the losses within 1e-4."""
    from repro.launch import train as jtrain
    argv = ["--arch", "mamba2", "--reduced", "--rounds", "2", "--seq", "32",
            "--batch", "4", "--k-inner", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    want = [json.loads(line) for line in out.getvalue().splitlines()]
    init = jbuild(jget_arch("mamba2-130m").reduced()).init(
        jax.random.PRNGKey(0))
    with contextlib.redirect_stdout(io.StringIO()):
        rows, summary, _ = train.run_lm(
            train.parse_args(argv + ["--device", "cpu"]), init_params=init)
    assert len(rows) == len(want) == 2
    for got, w in zip(rows, want):
        assert set(got) == set(w)
        for k in ("round", "client", "alpha", "comm_mb"):
            assert got[k] == w[k], k
        for k in ("loss", "inner_first", "inner_last"):
            assert abs(got[k] - w[k]) <= 1e-4, k
    assert summary["device"] == "cpu" and summary["comm_mb"] == want[-1][
        "comm_mb"]
    assert summary["kernel_launches"] == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("argv,msg", [
    (["--arch", "mamba2", "--participation", "0.5", "--availability",
      "markov"], "--availability replaces the i.i.d. --participation"),
    (["--arch", "mamba2", "--batch", "6", "--k-inner", "4"],
     "equal microbatches"),
    (["--arch", "mamba2", "--mesh", "pod", "--buffer-size", "2"],
     "--mesh pod runs the fused pod-client round"),
    (["--arch", "mamba2", "--resume"],
     "--resume restores from --ckpt-dir; pass both"),
    (["--arch", "nope"], "invalid choice"),
])
def test_lm_launcher_rejects_unported_routes(argv, msg, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2", "--participation", "0.5"],
    ["--arch", "mamba2", "--ckpt-dir", "x"],
])
def test_lm_launcher_takes_the_fleet_and_checkpoint_flags(argv):
    """``--participation`` and ``--ckpt-dir`` parse on the LM launcher
    (rejected until slice 17; their runs are held in
    test_torch_lm_launch_fleet.py)."""
    args = train.parse_args(argv)
    assert args.strategy == "tinyreptile" and args.arch == "mamba2-130m"


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_lm_launcher_takes_the_encdec_and_vlm_configs(arch):
    """The encoder-decoder and the VLM meta-train on the LM launcher
    (rejected until slice 16)."""
    args = train.parse_args(["--arch", arch])
    assert args.arch == arch and args.strategy == "tinyreptile"


def test_lm_launcher_takes_the_family_keyword():
    for arch in ("mamba2", "mamba2-130m"):
        args = train.parse_args(["--arch", arch])
        assert isinstance(args, argparse.Namespace)
        assert args.arch == "mamba2-130m" and args.strategy == "tinyreptile"
        assert (args.rounds, args.batch, args.seq, args.k_inner) == (20, 8,
                                                                     64, 4)
        assert args.device == "cuda"


def test_lm_launcher_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_lm(train.parse_args(["--arch", "mamba2", "--reduced",
                                       "--rounds", "1"]))
    model = build_model(get_arch("mamba2-130m").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert params["embed"].device.type == "cpu"
