"""TIFeD on the port's round engine (``TifedStrategy``, ``tifed_train``),
held against the JAX package's plain route (``use_pallas=False``) on the
CPU.

Both packages start from the JAX package's init, carried across as
NumPy. The integer grids are held exactly: params are int8 codes (and
int32 biases) times powers of two, so equal params are equal codes;
byte counts exactly; the fp32 losses, which the port sums in float64,
at rtol 1e-6; eval rows at 1e-4.

The JAX engine runs its round under ``jax.jit``, where XLA on the CPU
contracts the server interpolation phi + alpha (phi_hat - phi) into one
fused multiply-add. The port's ``meta_update`` computes that same FMA
(``kernels/ref.py::meta_update``), so the engine runs here are held at
annealed alphas, where the products round, and the server hooks are
held to the jitted JAX hooks, the arithmetic the engine actually runs.
Under jit XLA also contracts the weighted client mean (a multiply and a
reduction) into a chain of FMAs in client order up to 32 clients, and
sums windows of 32 rounded products above that; the port's
``client_mean`` follows both (``kernels/ref.py::client_mean``), so the
weighted hook and ``weighted_client_mean`` alone are held to the jitted
JAX functions exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.models.paper_nets import relu_mlp_loss as j_relu  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import FlatLayout, params_from_numpy  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.models.paper_nets import relu_mlp_loss  # noqa: E402

from test_torch_engine import init  # noqa: E402,F401

EVAL = dict(num_tasks=4, support=8, k_steps=4, lr=0.005, query=16)
LOSS_RTOL = 1e-6


def _runs(init, jkw=None, tkw=None, **kw):
    jout = jcore.tifed_train(init, JSine(), use_pallas=False, **kw,
                             **(jkw or {}))
    tout = tcore.tifed_train(init, SineTasks(), device="cpu", **kw,
                             **(tkw or {}))
    return jout, tout


def _assert_exact_run(tout, jout):
    for k, v in jout["params"].items():
        np.testing.assert_array_equal(tout["params"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert tout["comm_bytes"] == jout["comm_bytes"]
    assert tout["per_client_bytes"] == jout["per_client_bytes"]
    assert len(tout["history"]) == len(jout["history"])
    for ge, we in zip(tout["history"], jout["history"]):
        assert set(ge) == set(we)
        assert ge["round"] == we["round"]
        assert ge["comm_bytes"] == we["comm_bytes"]
        np.testing.assert_allclose(ge["inner_loss"], we["inner_loss"],
                                   rtol=LOSS_RTOL)
        for k in ("query_loss", "support_loss"):
            if k in we:
                np.testing.assert_allclose(ge[k], we[k], rtol=1e-4,
                                           atol=1e-4)


@pytest.mark.parametrize("case", ["uniform", "partial", "pooled_buffered"])
def test_tifed_matches_jax(init, case):
    """The whole integer trajectory equals the JAX package's at alpha 1
    annealed: the cohort uniform, half of it checking in (the masked
    hooks, every epoch live), and on a pool under Markov check-ins with a
    FedBuff buffer."""
    kw = dict(rounds=12, alpha=1.0, support=16, clients_per_round=4,
              seed=31, eval_every=6, eval_kwargs=EVAL)
    jkw, tkw = {}, {}
    if case == "partial":
        jkw["sampling"] = jcore.PartialParticipation(0.5)
        tkw["sampling"] = tcore.PartialParticipation(0.5)
    elif case == "pooled_buffered":
        jkw = dict(pool=jcore.ClientPool(JSine(), 30),
                   sampling=jcore.MarkovAvailability(),
                   buffered=jcore.BufferedAggregation(4))
        tkw = dict(pool=tcore.ClientPool(SineTasks(), 30),
                   sampling=tcore.MarkovAvailability(),
                   buffered=tcore.BufferedAggregation(4))
    jout, tout = _runs(init, jkw, tkw, **kw)
    _assert_exact_run(tout, jout)
    if case == "pooled_buffered":
        for k, v in jout["pool_state"].items():
            np.testing.assert_array_equal(np.asarray(tout["pool_state"][k]),
                                          np.asarray(v), err_msg=k)
        assert tout["pool_state"]["flushes"] >= 1


@pytest.mark.parametrize("alpha,steps", [(0.55, None), (0.6, (8, 3, 1, 6)),
                                         (1 / 3, (2, 8, 5, 8))])
def test_tifed_hooks_match_jax_at_annealed_alphas(init, alpha, steps):
    """One round's hooks on the same inputs, at alphas and straggler
    weights whose products round: int8 codes, exponents and losses from
    the client hook (with per-client epoch budgets, the straggler route:
    epochs past a budget pass the carry through and report 0), and the
    requantized server update, equal the JAX package's hooks, the server
    side under ``jax.jit`` as the engine runs it (see the module
    docstring)."""
    rng = np.random.default_rng(7)
    phi = {k: np.asarray(v) for k, v in jstrat.tifed_requantize(
        {k: jnp.asarray(v) for k, v in init.items()}).items()}
    x = rng.uniform(-5, 5, (4, 16, 1)).astype(np.float32)
    y = (2.0 * np.sin(x + 0.5)).astype(np.float32)
    js = jstrat.TifedStrategy(j_relu, use_pallas=False)
    ts = tcore.TifedStrategy(relu_mlp_loss)
    jphi = {k: jnp.asarray(v) for k, v in phi.items()}
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.tensor(x), "y": torch.tensor(y)}
    layout = FlatLayout.of(phi)
    tphi = layout.pack({k: torch.tensor(v) for k, v in phi.items()})
    if steps is None:
        jres, jloss = jax.jit(jax.vmap(
            lambda b: js.client_update(jphi, b, 0.0)))(jb)
        tres, tloss = ts.client_update(layout, tphi, tb, 0.0)
        w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    else:
        k = np.array(steps, np.int32)
        jres, jloss = jax.jit(jax.vmap(lambda b, kk: js.client_update_steps(
            jphi, b, 0.0, kk)))(jb, jnp.asarray(k))
        tres, tloss = ts.client_update_steps(layout, tphi, tb, 0.0,
                                             torch.tensor(k))
        assert (tloss.numpy()[np.arange(8) >= k[:, None]] == 0).all()
        w = (k / k.sum()).astype(np.float32)
    for part in ("q", "exp"):
        for k, v in jres[part].items():
            np.testing.assert_array_equal(tres[part][k].numpy(),
                                          np.asarray(v), err_msg=k)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                               rtol=LOSS_RTOL)
    a = jnp.float32(alpha)
    # the uniform route's whole hook under jit, as the engine runs it
    jnew = jax.jit(lambda p, r, a: js.server_aggregate(p, r, a, 0.0))(
        jphi, jres, a)
    tnew = layout.views(ts.server_aggregate(layout, tphi, tres,
                                            torch.tensor([alpha]), 0.0))
    for k, v in jnew.items():
        np.testing.assert_array_equal(tnew[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the weighted route: the whole hook under jit, as the engine runs it
    # (XLA contracts the weighted mean's multiply-reduce into a chain of
    # FMAs, and the interpolation into one FMA; the port follows both)
    jnew = jax.jit(lambda p, r, a, ww: js.server_aggregate_weighted(
        p, r, a, 0.0, ww))(jphi, jres, a, jnp.asarray(w))
    tnew = layout.views(ts.server_aggregate_weighted(
        layout, tphi, tres, torch.tensor([alpha]), 0.0, torch.tensor(w)))
    for k, v in jnew.items():
        np.testing.assert_array_equal(tnew[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_tifed_queue_c_run_matches_jax_exactly(init):
    """``tifed_train`` from the JAX package's sine init, 20 rounds, 4
    clients, support 16, seed 31, alpha 1 annealed: the run whose bias
    once ended one accumulator step apart when the port rounded the
    interpolation's product and sum separately."""
    jout, tout = _runs(init, rounds=20, alpha=1.0, support=16,
                       clients_per_round=4, seed=31, eval_every=10,
                       eval_kwargs=EVAL)
    _assert_exact_run(tout, jout)


def test_tifed_queue_c_launcher_case_matches_jax_exactly(init):
    """``--strategy tifed --rounds 6 --clients 4 --pool-size 30
    --availability markov --buffer-size 4``: the port's launcher against
    the JAX launcher's ``run_federated`` call at the same arguments;
    integer params, bills and pool state exact (their trajectories once
    parted here, the query loss 8.0886 against 7.4244)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    argv = ["--strategy", "tifed", "--rounds", "6", "--clients", "4",
            "--pool-size", "30", "--availability", "markov",
            "--buffer-size", "4"]
    a = jtrain.parse_args(argv)
    dist = JSine()
    jout = jcore.run_federated(
        init, dist, jstrat.TifedStrategy(j_relu, epochs=8),
        rounds=a.rounds, clients_per_round=a.clients, alpha=a.alpha,
        beta=a.beta, support=ttrain.SUPPORT, seed=a.seed,
        eval_every=a.rounds,
        eval_kwargs=dict(ttrain.EVAL_KWARGS, lr=ttrain.TIFED_EVAL_LR),
        channel=jcore.CommChannel("int8", quantize=False),
        sampling=jcore.MarkovAvailability(),
        pool=jcore.ClientPool(dist, a.pool_size, seed=a.seed),
        buffered=jcore.BufferedAggregation(a.buffer_size))
    row, tout = ttrain.run_engine_strategy(
        ttrain.parse_args(argv + ["--device", "cpu"]), init_params=init)
    for k, v in jout["params"].items():
        np.testing.assert_array_equal(tout["params"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert tout["comm_bytes"] == jout["comm_bytes"]
    assert tout["per_client_bytes"] == jout["per_client_bytes"]
    for k, v in jout["pool_state"].items():
        np.testing.assert_array_equal(np.asarray(tout["pool_state"][k]),
                                      np.asarray(v), err_msg=k)
    assert abs(row["query_loss"]
               - float(jout["history"][-1]["query_loss"])) <= 1e-4 + 5e-5


@pytest.mark.parametrize("alpha", [1.0, 0.95, 0.55, 1 / 3, 0.05])
def test_meta_update_is_the_jitted_fma(alpha):
    """The plain ``meta_update`` (what the kernel is held to on the card)
    equals the jitted JAX ``p + a * (q - p)`` bit for bit over a seeded
    2^16 sweep: phi_hat near phi, as a round's update leaves it, and
    far from it."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(22)
    n = 1 << 16
    p = rng.standard_normal(n).astype(np.float32)
    a = np.float32(alpha)
    jitted = jax.jit(lambda p, q, a: p + a * (q - p))
    for q in ((p + rng.normal(0, 1e-3, n)).astype(np.float32),
              rng.standard_normal(n).astype(np.float32)):
        want = np.asarray(jitted(p, q, a))
        got = ref.meta_update(torch.from_numpy(p), torch.from_numpy(q),
                              torch.tensor([a]))
        np.testing.assert_array_equal(got.numpy(), want)


def test_tifed_seeded_determinism(init):
    kw = dict(rounds=20, alpha=1.0, support=16, clients_per_round=4,
              seed=31, eval_every=10, eval_kwargs=EVAL, device="cpu")
    a = tcore.tifed_train(init, SineTasks(), **kw)
    b = tcore.tifed_train(init, SineTasks(), **kw)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    assert a["comm_bytes"] == b["comm_bytes"]
    assert a["history"] == b["history"] and len(a["history"]) == 2


def test_tifed_pipelined_matches_sync_bitwise(init):
    kw = dict(rounds=16, alpha=1.0, support=16, clients_per_round=4,
              seed=32, sampler="reference", device="cpu")
    sync = tcore.tifed_train(init, SineTasks(), prefetch=0, **kw)
    piped = tcore.tifed_train(init, SineTasks(), prefetch=2, max_block=4,
                              **kw)
    for k in sync["params"]:
        assert torch.equal(sync["params"][k], piped["params"][k])
    assert sync["comm_bytes"] == piped["comm_bytes"]


def test_tifed_single_trace_and_int8_billing(init):
    """One build per config, and the int8 bill: 1 byte a parameter both
    ways, a quarter of the fp32 bill."""
    rounds, clients = 12, 4
    out = tcore.tifed_train(init, SineTasks(), rounds=rounds, alpha=1.0,
                            support=16, clients_per_round=clients,
                            lr_shift=5, seed=33, device="cpu")
    runner = tengine._block_runner(
        tcore.TifedStrategy(relu_mlp_loss, epochs=8, lr_shift=5), 0.0,
        tcore.CommChannel("int8", quantize=False), scheduled=False)
    assert runner.trace_count == 1
    n_params = sum(int(np.prod(v.shape)) for v in init.values())
    assert out["comm_bytes"] == 2 * clients * rounds * n_params
    assert out["comm_bytes"] * 4 == 2 * clients * rounds * 4 * n_params
    # every phi the run hands back sits on the integer grids
    for k, v in tcore.strategies.tifed_requantize(out["params"]).items():
        assert torch.equal(v, out["params"][k]), k


@pytest.mark.parametrize("bad", [
    tcore.CommChannel(), tcore.CommChannel("int8"),
    tcore.CommChannel("float16", quantize=False),
    tcore.PartialCommChannel("int8", quantize=False, fraction=0.5)])
def test_tifed_rejects_incompatible_channels(init, bad):
    """The uplink is native int8: an fp32 wire, a simulating channel or
    another width would mis-bill or quantize twice."""
    with pytest.raises(ValueError, match="payload_dtype"):
        tcore.tifed_train(init, SineTasks(), rounds=2, support=4,
                          channel=bad, device="cpu")


def test_tifed_learns_sine(init):
    """Integer training lowers the query loss below the init's under the
    paper's eval protocol."""
    out = tcore.tifed_train(init, SineTasks(), rounds=40, alpha=1.0,
                            support=32, clients_per_round=4, seed=34,
                            eval_every=40, eval_kwargs=EVAL, device="cpu")
    ev0 = tcore.evaluate_init(relu_mlp_loss, params_from_numpy(init, "cpu"),
                              SineTasks(),
                              np.random.default_rng(10_039), **EVAL)
    assert np.isfinite(out["history"][-1]["query_loss"])
    assert out["history"][-1]["query_loss"] < ev0["query_loss"]


def test_tifed_launcher_row_matches_the_jax_launcher(init, capsys):
    """``--strategy tifed`` at 8 clients: the JAX launcher's row (comm_mb
    exact, query_loss to its 4th place)."""
    import json

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    argv = ["--strategy", "tifed", "--rounds", "6", "--clients", "8"]
    jtrain.run_engine_strategy(jtrain.parse_args(argv))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, out = ttrain.run_engine_strategy(
        ttrain.parse_args(argv + ["--device", "cpu"]), init_params=init)
    assert got["comm_mb"] == want["comm_mb"]
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12
    assert out["comm_bytes"] == 6 * 8 * 2 * 1153


def test_tifed_without_cuda_raises(init):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.tifed_train(init, SineTasks(), rounds=1)



@pytest.mark.parametrize("clients", [1, 2, 4, 8, 32, 33, 48, 64, 128])
def test_weighted_client_mean_matches_jitted_jax(clients):
    """``weighted_client_mean`` equals the jitted JAX function bit for bit
    over 2^16 seeded entries a client, some weights zero and a zeroed
    client's NaNs: the FMA chain up to 32 clients, the windows of 32
    above (the order found in XLA's compiled HLO at 33, 48, 64 and 128)."""
    rng = np.random.default_rng(clients)
    q = (rng.standard_normal((clients, 1 << 16))
         * rng.uniform(0.1, 10.0, (clients, 1))).astype(np.float32)
    w = rng.uniform(0.0, 1.0, clients).astype(np.float32)
    w[rng.uniform(size=clients) < 0.2] = 0.0
    if clients > 1:
        w[1], q[1, :5] = 0.0, np.nan
    w = (w / max(w.sum(), 1e-6)).astype(np.float32)
    want = np.asarray(jax.jit(lambda q, w: jstrat.weighted_client_mean(
        {"a": q}, w)["a"])(q, w))
    got = tcore.strategies.weighted_client_mean(torch.from_numpy(q),
                                                torch.from_numpy(w)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
