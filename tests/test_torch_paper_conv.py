"""The port's convolutional paper nets (KWS and Omniglot, Table I) and
what runs on them, held against the JAX package on the CPU.

Inputs come from a NumPy seed; the JAX package's params cross with
``bridge.params_from_numpy`` (the leaf layout is the same, so nothing
else converts them). The model functions are held at rtol 1e-5 with an
absolute floor of 1e-5 for outputs and losses and 1e-6 for gradients
(fp32 sums of up to 576 products a conv output, in another order); the
training runs at the engine tests' 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import paper_models as jcfg  # noqa: E402
from repro.data import KWSTasks as JKWS  # noqa: E402
from repro.data import OmniglotTasks as JOmniglot  # noqa: E402
from repro.metering import algorithm_memory_report as j_memory  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import paper_models as tcfg  # noqa: E402
from repro_torch.data import KWSTasks, OmniglotTasks  # noqa: E402
from repro_torch.examples import \
    federated_keyword_spotting as kws  # noqa: E402
from repro_torch.metering import MemoryMeter  # noqa: E402
from repro_torch.metering import algorithm_memory_report  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402

from test_torch_engine import assert_same_run  # noqa: E402

MODELS = ("kws_conv", "omniglot_conv")
RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-5, 1e-6
B, N = 3, 5                    # slots, samples a slot


def _cfgs(name):
    return jcfg.PAPER_MODELS[name], tcfg.PAPER_MODELS[name]


def _jax_init(cfg, seed=0):
    return {k: np.asarray(v)
            for k, v in jnets.init_paper_model(cfg, jax.random.PRNGKey(seed))
            .items()}


def _batch(cfg, lead, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal(lead + cfg.input_shape).astype(np.float32)
    y = r.integers(0, cfg.num_outputs, lead).astype(np.int32)
    return x, y


def _slotted(init, seed):
    """B different models: the JAX init, scaled per slot and leaf."""
    r = np.random.default_rng(seed)
    return {k: np.stack([v * r.uniform(0.5, 1.5) for _ in range(B)])
            .astype(np.float32) for k, v in init.items()}


def _jax_fns(cfg):
    return (functools.partial(jnets.paper_model_apply, cfg),
            functools.partial(jnets.paper_model_loss, cfg),
            functools.partial(jnets.paper_model_accuracy, cfg))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("slotted", [False, True])
def test_conv_net_matches_jax(name, slotted):
    """Forward, loss, gradient and accuracy at full width, one model or
    B models on B batches at once."""
    jc, tc = _cfgs(name)
    init = _jax_init(jc)
    params = _slotted(init, 1) if slotted else init
    x, y = _batch(jc, (B, N) if slotted else (N,), 2)
    j_apply, j_loss, j_acc = _jax_fns(jc)

    def loss_of(p, xb, yb):
        return j_loss(p, {"x": xb, "y": yb})

    if slotted:
        split = [({k: v[b] for k, v in params.items()}, x[b], y[b])
                 for b in range(B)]
        want_out = np.stack([np.asarray(j_apply(p, xb)) for p, xb, _ in split])
        want_loss = np.array([float(loss_of(p, xb, yb))
                              for p, xb, yb in split])
        want_acc = np.array([float(j_acc(p, {"x": xb, "y": yb}))
                             for p, xb, yb in split])
        grads = [jax.grad(loss_of)(p, xb, yb) for p, xb, yb in split]
        want_grad = {k: np.stack([np.asarray(g[k]) for g in grads])
                     for k in params}
    else:
        want_out = np.asarray(j_apply(params, x))
        want_loss = float(loss_of(params, x, y))
        want_acc = float(j_acc(params, {"x": x, "y": y}))
        want_grad = {k: np.asarray(v) for k, v in
                     jax.grad(loss_of)(params, x, y).items()}

    tp = {k: v.requires_grad_() for k, v in
          params_from_numpy(params, "cpu").items()}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    out = tnets.paper_model_apply(tc, tp, batch["x"])
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=RTOL,
                               atol=ATOL)
    loss = tnets.paper_model_loss(tc, tp, batch)
    assert loss.shape == ((B,) if slotted else ())
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, rtol=RTOL,
                               atol=ATOL)
    loss.sum().backward()
    for k, v in want_grad.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), v, rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    acc = tnets.paper_model_accuracy(tc, tp, batch)
    np.testing.assert_array_equal(acc.numpy(), np.float32(want_acc))


@pytest.mark.parametrize("name", MODELS)
def test_each_layer_matches_jax(name):
    """Each conv layer's activation, the JAX package's conv (its
    ``lax.conv_general_dilated`` at SAME, stride 2, NHWC) against the
    port's net cut after that layer with an identity head: the same
    shape and values, which pins the SAME padding at stride 2 and the
    order of the flatten before the head. Biases are random here."""
    jc, tc = _cfgs(name)
    r = np.random.default_rng(6)
    init = {k: (r.standard_normal(v.shape).astype(np.float32) * 0.1
                if k.startswith("cb") else v)
            for k, v in _jax_init(jc).items()}
    x, _ = _batch(jc, (4,), 3)
    act = jnp.asarray(x)
    for i, (h, w, c) in enumerate(tnets.conv_shapes(tc)):
        act = jax.nn.relu(jax.lax.conv_general_dilated(
            act, init[f"conv{i}"], window_strides=(2, 2), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + init[f"cb{i}"])
        assert act.shape == (4, h, w, c)
        cut = dataclasses.replace(tc, channels=tc.channels[:i + 1],
                                  num_outputs=h * w * c)
        p = {f"{k}{j}": init[f"{k}{j}"] for k in ("conv", "cb")
             for j in range(i + 1)}
        p["head_w"] = np.eye(h * w * c, dtype=np.float32)
        p["head_b"] = np.zeros(h * w * c, np.float32)
        got = tnets.paper_model_apply(cut, params_from_numpy(p, "cpu"),
                                      torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(act).reshape(4, -1),
                                   rtol=RTOL, atol=ATOL)


def test_same_padding_is_jax_s():
    """The pads of each layer, as XLA's SAME gives them: a total of
    max((out - 1) * 2 + 3 - in, 0), the low side total // 2 (at in = 3,
    out = 2, that is (1, 1); test_each_layer_matches_jax holds these to
    the JAX package's own convolution)."""
    assert [tnets.same_pads(s) for s in (28, 14, 7, 4)] == [
        (0, 1), (0, 1), (1, 1), (0, 1)]
    assert [tnets.same_pads(s) for s in (49, 25, 13)] == [(1, 1)] * 3
    assert [tnets.same_pads(s) for s in (10, 5, 3)] == [(0, 1), (1, 1),
                                                        (1, 1)]
    assert [s[:2] for s in tnets.conv_shapes(tcfg.OMNIGLOT_CONV)] == [
        (14, 14), (7, 7), (4, 4), (2, 2)]
    assert [s[:2] for s in tnets.conv_shapes(tcfg.KWS_CONV)] == [
        (25, 5), (13, 3), (7, 2)]


@pytest.mark.parametrize("name,count", [("kws_conv", 20_612),
                                        ("omniglot_conv", 112_709),
                                        ("sine_mlp", 1_153)])
def test_init_has_the_jax_leaves(name, count):
    """Leaf names and shapes of the JAX init, fp32, zero biases, and the
    JAX init's He-normal scale (the numbers differ: other streams)."""
    jc, tc = jcfg.PAPER_MODELS[name], tcfg.PAPER_MODELS[name]
    want = _jax_init(jc)
    got = tnets.init_paper_model(tc, torch.Generator().manual_seed(0), "cpu")
    assert tnets.param_count(got) == jnets.param_count(want) == count
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    for k, v in got.items():
        assert v.dtype == torch.float32
        if k.startswith(("b", "cb", "head_b")):
            assert not v.any(), k
        elif v.numel() > 500:
            np.testing.assert_allclose(v.std().item(), want[k].std(),
                                       rtol=0.15, err_msg=k)


def test_conv_init_is_deterministic():
    a, b = (tnets.init_paper_model(tcfg.KWS_CONV,
                                   torch.Generator().manual_seed(7), "cpu")
            for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_conv_leaves_carry_jax_params():
    """params_from_numpy of a JAX conv init computes the JAX function:
    the same leaves on both sides, nothing converted."""
    jc, tc = _cfgs("omniglot_conv")
    init = _jax_init(jc, seed=3)
    tp = params_from_numpy(init, "cpu")
    assert set(tp) == set(init)
    x, _ = _batch(jc, (2,), 4)
    np.testing.assert_allclose(
        tnets.paper_model_apply(tc, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jnets.paper_model_apply(jc, init, x)), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("support", [8, 0])
def test_evaluate_init_metric_matches_jax(support):
    """``query_metric`` is the mean accuracy over the testing clients.
    The port's adapted logits are within about 1e-6 of the JAX
    package's, so an argmax can flip only at a near-tie: the metric is
    held within one sample, 1 / (num_tasks * query), and the loss at
    1e-4."""
    jc, tc = _cfgs("kws_conv")
    init = _jax_init(jc)
    kw = dict(num_tasks=3, support=support, query=16, k_steps=4, lr=0.01)
    want = jcore.evaluate_init(
        functools.partial(jnets.paper_model_loss, jc), init, JKWS(),
        np.random.default_rng(5),
        metric_fn=functools.partial(jnets.paper_model_accuracy, jc), **kw)
    got = tcore.evaluate_init(
        functools.partial(tnets.paper_model_loss, tc),
        params_from_numpy(init, "cpu"), KWSTasks(), np.random.default_rng(5),
        metric_fn=functools.partial(tnets.paper_model_accuracy, tc), **kw)
    assert set(got) == {"query_loss", "query_metric"} == set(want)
    np.testing.assert_allclose(got["query_loss"], want["query_loss"],
                               rtol=1e-4, atol=1e-4)
    assert abs(got["query_metric"] - want["query_metric"]) <= (
        1 / (kw["num_tasks"] * kw["query"]) + 1e-12)


# a reduced KWS net: the same 49x10 input, two narrow conv layers, so the
# JAX package's engine compiles quickly
J_SMALL = dataclasses.replace(jcfg.KWS_CONV, name="kws_small",
                              channels=(8, 8))
T_SMALL = dataclasses.replace(tcfg.KWS_CONV, name="kws_small",
                              channels=(8, 8))
EVAL = dict(num_tasks=3, support=8, k_steps=4, lr=0.01, query=16)
RUNS = {
    "tinyreptile": ("tinyreptile_train",
                    dict(rounds=4, beta=0.01, support=6, seed=21,
                         eval_every=2)),
    "reptile_serial": ("reptile_train",
                       dict(rounds=3, beta=0.01, support=6, epochs=3,
                            seed=22, eval_every=3)),
    "reptile_c4": ("reptile_train",
                   dict(rounds=3, beta=0.01, support=6, epochs=3,
                        clients_per_round=4, seed=23, eval_every=3)),
}


def _both(name, jc, tc, jdist, tdist, init, jkw=None, tkw=None, **kw):
    j_eval = dict(EVAL, metric_fn=functools.partial(
        jnets.paper_model_accuracy, jc))
    t_eval = dict(EVAL, metric_fn=functools.partial(
        tnets.paper_model_accuracy, tc))
    jout = getattr(jcore, name)(functools.partial(jnets.paper_model_loss, jc),
                                init, jdist, eval_kwargs=j_eval, **kw,
                                **(jkw or {}))
    tout = getattr(tcore, name)(functools.partial(tnets.paper_model_loss, tc),
                                init, tdist, eval_kwargs=t_eval,
                                device="cpu", **kw, **(tkw or {}))
    return jout, tout


@pytest.mark.parametrize("case", sorted(RUNS))
def test_conv_training_matches_jax(case):
    name, kw = RUNS[case]
    jout, tout = _both(name, J_SMALL, T_SMALL, JKWS(), KWSTasks(),
                       _jax_init(J_SMALL), **kw)
    assert_same_run(tout, jout)
    assert all("query_metric" in ev for ev in tout["history"])


def test_conv_partial_participation_matches_jax():
    """run_federated with an 8-slot PartialParticipation(0.5) cohort of
    TinyReptile clients, as the KWS example runs its fleet."""
    jc, tc = J_SMALL, T_SMALL
    init = _jax_init(jc)
    j_eval = dict(EVAL, metric_fn=functools.partial(
        jnets.paper_model_accuracy, jc))
    t_eval = dict(EVAL, metric_fn=functools.partial(
        tnets.paper_model_accuracy, tc))
    kw = dict(rounds=3, clients_per_round=8, alpha=1.0, beta=0.01,
              support=6, seed=24, eval_every=3)
    jout = jcore.run_federated(
        init, JKWS(), jcore.TinyReptileStrategy(
            functools.partial(jnets.paper_model_loss, jc)),
        sampling=jcore.PartialParticipation(0.5), eval_kwargs=j_eval, **kw)
    tout = tcore.run_federated(
        init, KWSTasks(), tcore.TinyReptileStrategy(
            functools.partial(tnets.paper_model_loss, tc)),
        sampling=tcore.PartialParticipation(0.5), eval_kwargs=t_eval,
        device="cpu", **kw)
    assert_same_run(tout, jout)
    assert tout["comm_bytes"] == 3 * 4 * 2 * 4 * tnets.param_count(
        params_from_numpy(init, "cpu"))


def test_omniglot_full_width_tinyreptile_matches_jax():
    jc, tc = _cfgs("omniglot_conv")
    jout, tout = _both("tinyreptile_train", jc, tc, JOmniglot(),
                       OmniglotTasks(), _jax_init(jc), rounds=3, beta=0.01,
                       support=4, seed=25, eval_every=3)
    assert_same_run(tout, jout)


@pytest.mark.parametrize("name", ["sine_mlp", "kws_conv", "omniglot_conv"])
@pytest.mark.parametrize("support", [0, 8, 32])
def test_memory_report_matches_jax(name, support):
    assert algorithm_memory_report(tcfg.PAPER_MODELS[name], support) == \
        j_memory(jcfg.PAPER_MODELS[name], support)


def test_memory_report_table2_reductions():
    got = {n: algorithm_memory_report(c, 32)["reduction_factor"]
           for n, c in tcfg.PAPER_MODELS.items()}
    assert {n: round(v, 2) for n, v in got.items()} == {
        "sine_mlp": 3.49, "kws_conv": 7.23, "omniglot_conv": 5.24}


def test_memory_meter_on_the_cpu():
    meter = MemoryMeter(device="cpu")
    keep = np.ones(1 << 20)         # 8 MB the meter may see
    rep = meter.report()
    del keep
    assert rep["device_peak_bytes"] == rep["device_max_allocated_bytes"] == 0
    assert rep["host_baseline_bytes"] > 0
    assert rep["host_current_bytes"] >= 0
    assert rep["host_peak_bytes"] >= rep["host_peak_growth_bytes"] >= 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MemoryMeter()


def test_kws_example_on_the_cpu(capsys):
    out = kws.main(["--rounds", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    fleet = out["fleet"]
    assert fleet["comm_bytes"] == 2 * 4 * 2 * 82_448
    assert sum(fleet["per_client_bytes"]) == fleet["comm_bytes"]
    assert out["tinyreptile"]["comm_bytes"] == 2 * 1 * 2 * 82_448
    assert out["memory"] == j_memory(jcfg.KWS_CONV, 16)
    for run in ("tinyreptile", "fleet"):
        assert [ev["round"] for ev in out[run]["history"]] == [1, 2]
        assert all(0.0 <= ev["query_metric"] <= 1.0
                   and np.isfinite(ev["query_loss"])
                   for ev in out[run]["history"])
    assert "transport accounting over 2 rounds" in text
    assert "(50% of a full-participation fleet)" in text


@pytest.mark.parametrize("flag", ["--pool-size", "--availability",
                                  "--buffer-size"])
def test_kws_example_refuses_pool_flags(flag, capsys):
    """The fleet flags run since the fleet slice (tests/test_torch_pool.py
    runs the pooled example); a bad value of each is still refused at
    parse time."""
    bad = {"--pool-size": ("4", "must seat the 8-slot cohort"),
           "--availability": ("4", "invalid choice"),
           "--buffer-size": ("0", "must be >= 1")}[flag]
    with pytest.raises(SystemExit):
        kws.parse_args([flag, bad[0]])
    assert bad[1] in capsys.readouterr().err


def test_kws_example_defaults_to_the_card():
    assert kws.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kws.main(["--rounds", "1"])
