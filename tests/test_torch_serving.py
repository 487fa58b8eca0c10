"""The port's adaptation-serving slice, held against the JAX package.

A JAX phi (``init_paper_model(SINE_MLP, PRNGKey(0))``) is carried over
with ``bridge.params_from_numpy``; the same seeded request sets as
tests/test_serving.py go through the port's ``AdaptationServer`` /
``offline_adapt`` on the CPU and through JAX's ``offline_adapt`` (its
plain route, as on the CPU). fp32 is held to rtol = atol = 1e-5
(matmul and tanh come from different libraries); TIFeD weights are
exact, and the query loss is held to rtol 1e-6.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.core.strategies import tifed_requantize  # noqa: E402
from repro.models.paper_nets import init_paper_model as j_init  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro.serving import Fp32Adapter as JFp32  # noqa: E402
from repro.serving import TifedAdapter as JTifed  # noqa: E402
from repro.serving import offline_adapt as j_offline  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402
from repro_torch.serving import (AdaptationServer, Fp32Adapter,  # noqa: E402
                                 TifedAdapter, offline_adapt)

LOSS = functools.partial(paper_model_loss, SINE_MLP)
J_LOSS = functools.partial(j_loss, J_SINE)


@pytest.fixture(scope="module")
def jphi():
    return jax.tree.map(np.asarray, j_init(J_SINE, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jphi_q(jphi):
    return jax.tree.map(np.asarray, tifed_requantize(jphi))


def make_requests(n, support, query, ks, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        a, b = rng.uniform(0.1, 5.0), rng.uniform(0.0, np.pi)
        sx = rng.uniform(-5, 5, (support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (query, 1)).astype(np.float32)
        reqs.append({"sx": sx, "sy": np.float32(a * np.sin(sx + b)),
                     "qx": qx, "qy": np.float32(a * np.sin(qx + b)),
                     "k": ks[i % len(ks)]})
    return reqs


def serve_all(server, reqs):
    rids = [server.submit(r["sx"], r["sy"], r["qx"], r["qy"], r["k"])
            for r in reqs]
    done = {res.rid: res for res in server.drain()}
    assert len(done) == len(reqs)
    return [done[rid] for rid in rids]


FP32_REQS = dict(n=12, support=10, query=16,
                 ks=(3, 10, 7, 1, 5, 9, 2, 10, 4, 6, 8, 10))
TIFED_REQS = dict(n=10, support=8, query=16,
                  ks=(2, 6, 4, 1, 3, 6, 5, 2, 6, 1), seed=1)


def test_fp32_served_matches_jax_offline(jphi):
    """Ragged k, three refill waves over 4 slots, against JAX."""
    reqs = make_requests(**FP32_REQS)
    server = AdaptationServer(params_from_numpy(jphi, "cpu"),
                              Fp32Adapter(loss_fn=LOSS, lr=0.01), slots=4,
                              k_max=10, steps_per_tick=3, return_params=True,
                              device="cpu")
    got = serve_all(server, reqs)
    want = j_offline(jphi, JFp32(loss_fn=J_LOSS, lr=0.01), reqs, slots=4,
                     k_max=10)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.steps == w["steps"] == reqs[i]["k"]
        np.testing.assert_allclose(g.query_loss, w["query_loss"], rtol=1e-5,
                                   atol=1e-5)
        for leaf in w["params"]:
            np.testing.assert_allclose(
                g.params[leaf], w["params"][leaf], rtol=1e-5, atol=1e-5,
                err_msg=f"request {i}: params[{leaf}]")


def test_tifed_served_matches_jax_offline(jphi_q):
    """int8 route: adapted weights exactly JAX's, query loss to 1e-6."""
    reqs = make_requests(**TIFED_REQS)
    server = AdaptationServer(params_from_numpy(jphi_q, "cpu"),
                              TifedAdapter(support=8, k_max=6), slots=4,
                              k_max=6, steps_per_tick=2, return_params=True,
                              device="cpu")
    got = serve_all(server, reqs)
    want = j_offline(jphi_q, JTifed(support=8, k_max=6, use_pallas=False),
                     reqs, slots=4, k_max=6)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.steps == w["steps"]
        for leaf in w["params"]:
            np.testing.assert_array_equal(
                g.params[leaf], w["params"][leaf],
                err_msg=f"request {i}: params[{leaf}]")
        np.testing.assert_allclose(g.query_loss, w["query_loss"], rtol=1e-6)


@pytest.mark.parametrize("route", ["fp32", "tifed"])
def test_served_equals_port_offline_exactly(jphi, jphi_q, route):
    if route == "fp32":
        phi, adapter, spec, k_max, spt = jphi, Fp32Adapter(LOSS), FP32_REQS, 10, 3
    else:
        phi, adapter, spec, k_max, spt = (jphi_q, TifedAdapter(8, 6),
                                          TIFED_REQS, 6, 2)
    reqs = make_requests(**spec)
    server = AdaptationServer(phi, adapter, slots=4, k_max=k_max,
                              steps_per_tick=spt, return_params=True,
                              device="cpu")
    got = serve_all(server, reqs)
    want = offline_adapt(phi, adapter, reqs, slots=4, k_max=k_max,
                         device="cpu")
    for g, w in zip(got, want):
        assert g.steps == w["steps"]
        assert g.query_loss == w["query_loss"]
        for leaf in w["params"]:
            np.testing.assert_array_equal(g.params[leaf], w["params"][leaf])


def test_tifed_no_cross_slot_leakage(jphi_q):
    """A request served alone equals the same request inside a full
    ragged batch, exactly."""
    adapter = TifedAdapter(support=8, k_max=6)
    reqs = make_requests(8, support=8, query=16,
                         ks=(4, 6, 1, 3, 6, 2, 5, 4), seed=3)
    kw = dict(slots=4, k_max=6, steps_per_tick=2, return_params=True,
              device="cpu")
    together = serve_all(AdaptationServer(jphi_q, adapter, **kw), reqs)[0]
    alone = serve_all(AdaptationServer(jphi_q, adapter, **kw), reqs[:1])[0]
    assert alone.query_loss == together.query_loss
    for leaf in alone.params:
        np.testing.assert_array_equal(alone.params[leaf],
                                      together.params[leaf])


def test_launch_counts_stay_zero_on_cpu(jphi, jphi_q):
    ops.reset_launch_counts()
    for phi, adapter, spec in ((jphi, Fp32Adapter(LOSS), FP32_REQS),
                               (jphi_q, TifedAdapter(8, 6), TIFED_REQS)):
        reqs = make_requests(**spec)[:3]
        serve_all(AdaptationServer(phi, adapter, slots=2, k_max=10,
                                   device="cpu"), reqs)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_submit_validation(jphi):
    server = AdaptationServer(jphi, Fp32Adapter(LOSS), slots=2, k_max=5,
                              steps_per_tick=2, device="cpu")
    r = make_requests(1, support=5, query=4, ks=(5,))[0]
    with pytest.raises(ValueError, match="outside"):
        server.submit(r["sx"], r["sy"], r["qx"], r["qy"], k=6)
    with pytest.raises(ValueError, match="outside"):
        server.submit(r["sx"], r["sy"], r["qx"], r["qy"], k=0)
    short = make_requests(1, support=3, query=4, ks=(5,))[0]
    with pytest.raises(ValueError, match="support"):
        server.submit(short["sx"], short["sy"], short["qx"], short["qy"],
                      k=5)
    server.submit(r["sx"], r["sy"], r["qx"], r["qy"], k=5)
    server.drain()
    bad = make_requests(1, support=7, query=4, ks=(5,))[0]
    with pytest.raises(ValueError, match="shape"):
        server.submit(bad["sx"], bad["sy"], bad["qx"], bad["qy"], k=5)
    server.submit(r["sx"], r["sy"], r["qx"], r["qy"], k=5)
    with pytest.raises(RuntimeError, match="in flight"):
        server.set_params(jphi)
    server.reset()
    assert server.idle
    server.set_params(jphi)


def test_constructor_validation(jphi):
    adapter = Fp32Adapter(LOSS)
    with pytest.raises(ValueError, match="slots"):
        AdaptationServer(jphi, adapter, slots=0, k_max=5, device="cpu")
    with pytest.raises(ValueError, match="k_max"):
        AdaptationServer(jphi, adapter, slots=2, k_max=0, device="cpu")
    with pytest.raises(ValueError, match="steps_per_tick"):
        AdaptationServer(jphi, adapter, slots=2, k_max=5, steps_per_tick=0,
                         device="cpu")
    with pytest.raises(ValueError, match="paper MLP"):
        AdaptationServer({"w0": jphi["w0"]}, TifedAdapter(8, 6), slots=2,
                         k_max=5, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(jphi):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptationServer(jphi, Fp32Adapter(LOSS), slots=2, k_max=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline_adapt(jphi, Fp32Adapter(LOSS), make_requests(1, 5, 4, (2,)),
                      slots=2, k_max=5)
