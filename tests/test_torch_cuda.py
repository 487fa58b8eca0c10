"""The port's kernels, serving slice and training engine on a CUDA
device.

These tests need the card: each skips where there is none. They import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch (``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py``).
Each kernel is held to its plain PyTorch version on the same CUDA
tensors, and the served results and trained params on the card to the
port on the CPU.
"""
import contextlib
import functools
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphs  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import (BufferedAggregation,  # noqa: E402
                              ClientPool, CommChannel, DiurnalAvailability,
                              PartialCommChannel, StragglerSampling,
                              clear_runner_cache, engine, fedavg_train,
                              reptile_train, tifed_train, tinyreptile_train)
from repro_torch.core.strategies import tifed_requantize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.paper_nets import (init_paper_model,  # noqa: E402
                                           paper_model_loss)
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.serving import (AdaptationServer, Fp32Adapter,  # noqa: E402
                                 TifedAdapter)

LOSS = functools.partial(paper_model_loss, SINE_MLP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _case(dims, S, B, seed, dev, layers=(0, 1, 2), extreme=False):
    """B slots of random (or, ``extreme``, all-rails) integer operands;
    slot b trains ``layers[b % len(layers)]``."""
    rng = np.random.default_rng(seed)
    din, h1, h2, dout = dims

    def ints(lo, hi, shape, dtype):
        a = (rng.choice([lo, hi], shape) if extreme
             else rng.integers(lo, hi + 1, shape))
        return torch.from_numpy(a.astype(dtype)).to(dev)

    blim = 2 ** 22 if extreme else 2 ** 15
    ylim = 2 ** 21 if extreme else 2 ** 15
    ws = tuple(ints(-127, 127, (B,) + s, np.int8)
               for s in ((din, h1), (h1, h2), (h2, dout)))
    bs = tuple(ints(-blim, blim, (B, n), np.int32) for n in (h1, h2, dout))
    xq = ints(-127, 127, (B, S, din), np.int8)
    yal = ints(-ylim, ylim, (B, S, dout), np.int32)
    layer = torch.tensor([layers[i % len(layers)] for i in range(B)],
                         dtype=torch.int32, device=dev)
    fb = tuple(ints(-127, 127, (dout, h), np.int8) for h in (h1, h2))
    dither = tuple(torch.from_numpy(rng.random((B,) + s).astype(np.float32))
                   .to(dev) for s in ((din, h1), (h1, h2), (h2, dout)))
    scales = ref.pack_scales(
        {"f0": 2.0 ** -7, "f1": 2.0 ** -7, "fe": 2.0 ** -9,
         "floss": 2.0 ** -4 / S, "ftw": (2.0 ** -8, 2.0 ** -9, 2.0 ** -10),
         "ftb": (2.0 ** -6, 2.0 ** -7, 2.0 ** -8)}, device=dev)
    return ws, bs, xq, yal, layer, fb, dither, scales


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_online_sgd_kernel_matches_plain(cuda, dtype):
    """Exact: lr * g and the difference are rounded on their own, as the
    plain version's two tensor ops round them."""
    g = torch.Generator().manual_seed(0)
    p, grad = (torch.randn(64, 1153, generator=g).to(cuda, dtype)
               for _ in range(2))
    before = ops.online_sgd.launches
    out = ops.online_sgd(p, grad, 0.01)
    torch.cuda.synchronize()
    assert ops.online_sgd.launches == before + 1
    assert out.dtype == dtype
    assert torch.equal(out, ref.online_sgd(p, grad, 0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [
    (0, 0), (1, 0), (1153, 0), (73792, 0), ((1 << 20) + 3, 0),
    (1153, 1), (73792, 1), ((1 << 20) + 3, 1),
    (132 * 256 * 4 * 4 - 1, 0), (132 * 256 * 4 * 8 + 5, 0)])
def test_online_sgd_kernel_exact_at_ragged_sizes(cuda, dtype, n, offset):
    """Bit for bit at ragged sizes, across the small and the large launch
    shape (a full wave of 256 x 4 vectors), and at views one element off
    16-byte alignment (the scalar kernel); one launch a call, none for an
    empty tensor."""
    g = torch.Generator().manual_seed(n + offset)
    p, grad = (torch.randn(n + offset, generator=g).to(cuda, dtype)[offset:]
               for _ in range(2))
    for lr in (0.01, 0.0173, 0.5):
        before = ops.online_sgd.launches
        out = ops.online_sgd(p, grad, lr)
        torch.cuda.synchronize()
        assert ops.online_sgd.launches == before + (1 if n else 0)
        assert out.dtype == dtype and out.shape == p.shape
        assert torch.equal(out, ref.online_sgd(p, grad, lr))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,S", [((1, 32, 32, 1), 8), ((5, 16, 12, 3), 32)])
def test_dfa_epoch_kernel_matches_plain(cuda, dims, S):
    args = _case(dims, S, 6, 7, cuda)
    before = ops.dfa_epoch_int8.launches
    gw, gb, gl = ops.dfa_epoch_int8(*args)
    ww, wb, wl = ref.dfa_int8_epoch(*args)
    torch.cuda.synchronize()
    assert ops.dfa_epoch_int8.launches == before + 1
    for i in range(3):
        assert torch.equal(gw[i], ww[i]) and torch.equal(gb[i], wb[i])
    torch.testing.assert_close(gl, wl, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("dims", [(1, 32, 32, 1), (5, 16, 12, 3),
                                  (1, 8, 8, 1)])
def test_dfa_epoch_kernel_exact_by_layer(cuda, dims, S, layer):
    """Every slot trains one layer: weights and biases exact, the loss to
    1e-6; dims that are not multiples of 4 take the zero-padded K."""
    args = _case(dims, S, 5, 11 + layer, cuda, layers=(layer,))
    gw, gb, gl = ops.dfa_epoch_int8(*args)
    ww, wb, wl = ref.dfa_int8_epoch(*args)
    torch.cuda.synchronize()
    for i in range(3):
        assert torch.equal(gw[i], ww[i]) and torch.equal(gb[i], wb[i])
    torch.testing.assert_close(gl, wl, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("S", [8, 32, 512])
def test_dfa_epoch_kernel_exact_at_the_rails(cuda, S, layer):
    """Operands at the int8 and bias rails, up to S = 512: the envelope
    where every integer sum still stays below 2^24."""
    args = _case((1, 8, 8, 1), S, 4, 99, cuda, layers=(layer,),
                 extreme=True)
    gw, gb, gl = ops.dfa_epoch_int8(*args)
    ww, wb, wl = ref.dfa_int8_epoch(*args)
    torch.cuda.synchronize()
    for i in range(3):
        assert torch.equal(gw[i], ww[i]) and torch.equal(gb[i], wb[i])
    torch.testing.assert_close(gl, wl, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_dfa_epoch_kernel_rejects_oversized_shapes(cuda):
    args = _case((1, 256, 256, 1), 512, 1, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.dfa_epoch_int8(*args)


def _requests(n, support, query, k_max, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = rng.uniform(0.1, 5.0), rng.uniform(0.0, np.pi)
        sx = rng.uniform(-5, 5, (support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (query, 1)).astype(np.float32)
        out.append((sx, np.float32(a * np.sin(sx + b)), qx,
                    np.float32(a * np.sin(qx + b)),
                    int(rng.integers(1, k_max + 1))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fp32", "tifed"])
def test_served_on_card_matches_cpu(cuda, route):
    phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
    if route == "fp32":
        adapter = Fp32Adapter(functools.partial(paper_model_loss, SINE_MLP))
        reqs, k_max = _requests(20, 10, 8, 10, 0), 10
    else:
        phi, adapter = tifed_requantize(phi), TifedAdapter(8, 6)
        reqs, k_max = _requests(20, 8, 8, 6, 1), 6
    out = {}
    for dev in (cuda, "cpu"):
        server = AdaptationServer(phi, adapter, slots=8, k_max=k_max,
                                  steps_per_tick=3, return_params=True,
                                  device=dev)
        for r in reqs:
            server.submit(*r)
        out[str(dev)] = sorted(server.drain(), key=lambda r: r.rid)
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.steps == c.steps
        np.testing.assert_allclose(g.query_loss, c.query_loss, rtol=1e-5,
                                   atol=1e-5)
        for leaf in c.params:
            if route == "tifed":
                np.testing.assert_array_equal(g.params[leaf], c.params[leaf])
            else:
                np.testing.assert_allclose(g.params[leaf], c.params[leaf],
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [
    (1153, 0), (1 << 20, 0), (4099, 1),
    (3, 0), (13, 0),                     # below one thread's 4 vectors
    (4 * 4 * 256 - 1, 0), (4 * 4 * 256 + 1, 0),    # unroll x fp32 vector
    (4 * 8 * 256 - 1, 0), (4 * 8 * 256 + 1, 0),    # x threads, +- 1; bf16
    (4 * 8 * 256 + 1, 3), (1153, 3)])
def test_meta_update_kernel_matches_plain(cuda, dtype, n, offset):
    """Exact: the kernel's one fused multiply-add (``__fmaf_rn``) equals
    the plain version's FMA, taken exactly in float64 and rounded to
    odd, at alphas whose products round. Sizes around one block's work (4
    vectors of 16 bytes a thread, 256 threads) and below one thread's
    take the tail; ``offset`` 1 or 3 misaligns the buffers, which takes
    the scalar path."""
    g = torch.Generator().manual_seed(n)
    w, wh = (torch.randn(n + offset, generator=g).to(cuda, dtype)[offset:]
             for _ in range(2))
    for a in (0.0, 0.37, 0.55, 1 / 3, 1.0):
        alpha = torch.tensor([a], device=cuda)
        before = ops.meta_update.launches
        out = ops.meta_update(w, wh, alpha)
        torch.cuda.synchronize()
        assert ops.meta_update.launches == before + 1
        assert out.dtype == dtype
        assert torch.equal(out, ref.meta_update(w, wh, alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1153, 0), (1 << 20, 0), (4099, 1),
                                      (13, 0), (4 * 8 * 256 + 1, 0),
                                      (4 * 8 * 256 + 1, 3)])
def test_meta_update_bf16_with_fp32_target_matches_plain(cuda, n, offset):
    """The mixed instantiation (a bf16 w, an fp32 w_hat read unrounded,
    dtype code 2) equals the plain version bit for bit, vectorized (8
    bf16 of w, two float4 of w_hat a vector) and misaligned."""
    g = torch.Generator().manual_seed(n)
    w = torch.randn(n + offset, generator=g).to(cuda, torch.bfloat16)[
        offset:]
    wh = torch.randn(n + offset, generator=g).to(cuda)[offset:]
    for a in (0.0, 0.37, 1 / 3, 1.0):
        alpha = torch.tensor([a], device=cuda)
        before = ops.meta_update.launches
        out = ops.meta_update(w, wh, alpha)
        torch.cuda.synchronize()
        assert ops.meta_update.launches == before + 1
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, ref.meta_update(w, wh, alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("clients", [1, 8, 33, 64])
@pytest.mark.parametrize("shape", [(1153,), (1 << 20,), (257,)])
def test_client_mean_bf16_kernel_matches_plain(cuda, clients, shape):
    """Exact: bf16 rows read as they are and widened in registers give
    the fp32 kernel's sums on their fp32 widening, in both orders."""
    g = torch.Generator().manual_seed(clients)
    q = (torch.randn((clients,) + shape, generator=g) * 3).to(torch.bfloat16)
    w = torch.rand(clients, generator=g)
    if clients > 1:
        w[1] = 0.0
        q[1].view(-1)[:3] = float("nan")
    w = w / w.sum()
    q, w = q.to(cuda), w.to(cuda)
    before = ops.client_mean.launches
    out = ops.client_mean(q, w)
    torch.cuda.synchronize()
    assert ops.client_mean.launches == before + 1
    assert out.shape == shape and out.dtype == torch.float32
    assert torch.equal(out, ref.client_mean(q, w))
    assert torch.equal(out, ops.client_mean(q.float(), w))


@pytest.mark.cuda
@pytest.mark.parametrize("clients", [1, 4, 8, 32, 33, 48, 64, 1025])
@pytest.mark.parametrize("shape", [(1153,), (20612,), (32, 32), (257,)])
def test_client_mean_kernel_matches_plain(cuda, clients, shape):
    """Exact: the kernel's FMA chain (up to 32 clients) and its windows
    of 32 rounded products (above) equal the plain version's, with some
    weights zero and a zeroed client's NaNs left out of the sum."""
    g = torch.Generator().manual_seed(clients)
    q = torch.randn((clients,) + shape, generator=g) * 3
    w = torch.rand(clients, generator=g)
    w[torch.rand(clients, generator=g) < 0.2] = 0.0
    if clients > 1:
        w[1] = 0.0
        q[1].view(-1)[:3] = float("nan")
    w = w / w.sum().clamp_min(1e-6)
    q, w = q.to(cuda), w.to(cuda)
    before = ops.client_mean.launches
    out = ops.client_mean(q, w)
    torch.cuda.synchronize()
    assert ops.client_mean.launches == before + 1
    assert out.shape == shape and out.dtype == torch.float32
    assert not torch.isnan(out).any()
    assert torch.equal(out, ref.client_mean(q, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_online_sgd_momentum_kernel_matches_plain(cuda, dtype):
    """Exact: mu * m + g and p - lr * m' are rounded op by op, as the
    plain version's tensor ops round them; m' stays fp32."""
    g = torch.Generator().manual_seed(1)
    p, grad = (torch.randn(64, 1153, generator=g).to(cuda, dtype)
               for _ in range(2))
    m = torch.randn(64, 1153, generator=g).to(cuda)
    before = ops.online_sgd_momentum.launches
    gp, gm = ops.online_sgd_momentum(p, grad, m, 0.05, 0.9)
    torch.cuda.synchronize()
    assert ops.online_sgd_momentum.launches == before + 1
    wp, wm = ref.online_sgd(p, grad, 0.05, m=m, momentum=0.9)
    assert gp.dtype == dtype and gm.dtype == torch.float32
    assert gp.shape == gm.shape == p.shape
    assert torch.equal(gm, wm) and torch.equal(gp, wp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [
    ((1153,), 0), ((64, 1153), 0), ((1 << 24,), 0), ((0,), 0), ((1,), 0),
    ((4099,), 0), ((132 * 256 * 4 * 8 + 5,), 0),     # past a full wave
    ((1153,), 1), ((4099,), 3), ((73792,), 1)])
def test_online_sgd_momentum_kernel_exact_at_sizes(cuda, dtype, shape,
                                                   offset):
    """Bit for bit at the sine MLP's 1,153 and 64 x 1,153, flat 2^24, odd
    lengths (the tail), past the large launch shape's wave, and at views
    ``offset`` elements off 16-byte alignment (the scalar kernel); one
    launch a call, none for an empty tensor."""
    n = int(np.prod(shape))
    g = torch.Generator().manual_seed(n + offset)
    p, grad = (torch.randn(n + offset, generator=g).to(cuda, dtype)[offset:]
               .view(shape) for _ in range(2))
    m = torch.randn(n + offset, generator=g).to(cuda)[offset:].view(shape)
    for lr, mu in ((0.05, 0.9), (0.0173, 0.5), (0.5, 0.0)):
        before = ops.online_sgd_momentum.launches
        gp, gm = ops.online_sgd_momentum(p, grad, m, lr, mu)
        torch.cuda.synchronize()
        assert ops.online_sgd_momentum.launches == before + (1 if n else 0)
        wp, wm = ref.online_sgd(p, grad, lr, m=m, momentum=mu)
        assert torch.equal(gm, wm) and torch.equal(gp, wp)


def _train_case(name):
    """A small run of each route the captured round takes: TinyReptile,
    Reptile at 8 clients, FedAvg, a straggler schedule and the int8
    wire, with uneven blocks (the last one shorter than the pad)."""
    phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
    ev = dict(num_tasks=4, support=8, k_steps=4, lr=0.02, query=16)
    kw = dict(beta=0.02, support=8, eval_every=7, eval_kwargs=ev, seed=3)
    if name == "tinyreptile":
        return functools.partial(tinyreptile_train, LOSS, phi, SineTasks(),
                                 rounds=17, **kw)
    if name == "reptile_c8":
        return functools.partial(reptile_train, LOSS, phi, SineTasks(),
                                 rounds=10, epochs=4, clients_per_round=8,
                                 **kw)
    if name == "fedavg":
        return functools.partial(fedavg_train, LOSS, phi, SineTasks(),
                                 rounds=10, epochs=3, clients_per_round=4,
                                 **kw)
    if name == "straggler":
        return functools.partial(tinyreptile_train, LOSS, phi, SineTasks(),
                                 rounds=10, clients_per_round=4,
                                 sampling=StragglerSampling(0.5), **kw)
    if name in ("pooled_buffered", "pooled_host"):
        # a fresh pool each run: its clients' data streams advance
        def pooled(device):
            pool = ClientPool(SineTasks(), 60, sampler="vectorized",
                              residency="host" if name == "pooled_host"
                              else "device")
            return tinyreptile_train(
                LOSS, phi, SineTasks(), rounds=17, clients_per_round=4,
                sampling=DiurnalAvailability(period=6, sampler="vectorized"),
                pool=pool, buffered=BufferedAggregation(3, flush_staleness=2),
                device=device, **kw)
        return pooled
    if name == "tifed":
        return functools.partial(
            tifed_train, tifed_requantize(phi), SineTasks(), rounds=9,
            support=32, clients_per_round=8, sampling=StragglerSampling(0.5),
            eval_every=5, eval_kwargs=dict(ev, lr=0.005), seed=3)
    if name == "partial_rotating":
        return functools.partial(tinyreptile_train, LOSS, phi, SineTasks(),
                                 rounds=10, clients_per_round=2,
                                 channel=PartialCommChannel(
                                     "int8", fraction=0.25, rotate=True),
                                 **kw)
    return functools.partial(tinyreptile_train, LOSS, phi, SineTasks(),
                             rounds=10, channel=CommChannel("int8"), **kw)


def _uncaptured(monkeypatch):
    """Every GraphStep call runs its function eagerly on the card."""
    monkeypatch.setattr(graphs.GraphStep, "_warm_up_and_capture",
                        lambda self: self.fn())


@pytest.mark.cuda
def test_capture_survives_a_garbage_collection(cuda):
    """A graph left in a reference cycle is freed by Python's cyclic
    collector whenever it runs; destroying a graph during another capture
    would invalidate that capture. So the collector is off while a graph
    is captured (and only then), and a capture succeeds with the
    collector set to run at every allocation and such a graph waiting."""
    x = torch.zeros(64, device=cuda)
    seen = []

    class Holder:
        pass

    def orphan():
        h = Holder()
        h.x = x
        h.step = graphs.GraphStep(lambda: h.x.add_(1), cuda)  # h <-> step
        h.step()

    def fn():
        seen.append(gc.isenabled())
        junk = [[i] for i in range(2000)]       # allocations: collections
        x.mul_(2)
        del junk

    for _ in range(3):
        orphan()
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        step = graphs.GraphStep(fn, cuda)
        step()                                   # run, then capture
        step()                                   # replay
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert step.graph is not None
    gc.collect()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tinyreptile", "reptile_c8", "fedavg",
                                  "straggler", "int8_wire", "pooled_buffered",
                                  "pooled_host", "tifed", "partial_rotating"])
def test_captured_round_equals_uncaptured(cuda, name, monkeypatch):
    """The round captured once and replayed gives the params and history
    of the same round run eagerly every time, bit for bit; the launch
    counters count every replay; one capture per config."""
    run = _train_case(name)
    clear_runner_cache()
    ops.reset_launch_counts()
    got = run(device=cuda)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    (runner,) = engine._RUNNER_CACHE._entries.values()
    assert runner.trace_count == 1
    (prog,) = runner._programs.values()
    assert prog.step.graph is not None
    run(device=cuda)                           # a second run: no capture
    assert runner.trace_count == 1
    clear_runner_cache()
    with monkeypatch.context() as mp:
        _uncaptured(mp)
        ops.reset_launch_counts()
        want = run(device=cuda)
        torch.cuda.synchronize()
        assert ops.launch_counts() == counts
    clear_runner_cache()
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["history"] == want["history"]
    assert got["comm_bytes"] == want["comm_bytes"]
    if "pool_state" in want:
        for k, v in want["pool_state"].items():
            np.testing.assert_array_equal(got["pool_state"][k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fp32", "tifed"])
def test_captured_tick_equals_uncaptured(cuda, route, monkeypatch):
    """The tick captured once and replayed serves exactly what the same
    tick run eagerly serves (params, query losses, steps), counts the
    same launches, and is built once: also across ``reset`` and a
    ``set_params`` of the same shapes."""
    phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
    if route == "fp32":
        adapter = Fp32Adapter(functools.partial(paper_model_loss, SINE_MLP))
        reqs, k_max = _requests(20, 10, 8, 10, 0), 10
    else:
        phi, adapter = tifed_requantize(phi), TifedAdapter(8, 6)
        reqs, k_max = _requests(20, 8, 8, 6, 1), 6

    def serve():
        server = AdaptationServer(phi, adapter, slots=8, k_max=k_max,
                                  steps_per_tick=3, return_params=True,
                                  device=cuda)
        ops.reset_launch_counts()
        out = []
        for _ in range(2):
            for r in reqs:
                server.submit(*r)
            out += sorted(server.drain(), key=lambda r: r.rid)
            server.reset()
            server.set_params(phi)
        torch.cuda.synchronize()
        return server, out, ops.launch_counts()

    server, got, counts = serve()
    assert server.trace_count == 1
    assert server._tick_step.graph is not None
    with monkeypatch.context() as mp:
        _uncaptured(mp)
        _, want, eager_counts = serve()
    assert counts == eager_counts
    for g, w in zip(got, want):
        assert (g.rid, g.steps, g.query_loss) == (w.rid, w.steps,
                                                  w.query_loss)
        for leaf in w.params:
            np.testing.assert_array_equal(g.params[leaf], w.params[leaf])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pooled_buffered", "tifed",
                                  "partial_rotating"])
def test_fleet_on_card_matches_cpu(cuda, name):
    """The pooled and buffered round, TIFeD (every epoch one
    dfa_epoch_int8 launch for the cohort) and the rotating partial wire
    on the card against the port on the CPU: TIFeD's integer params and
    the pool state exactly, fp32 params within 1e-4, bytes exactly."""
    run = _train_case(name)
    ops.reset_launch_counts()
    got = run(device=cuda)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = run(device="cpu")
    if name == "tifed":
        assert counts["dfa_epoch_int8"] == 9 * 8
        assert counts["meta_update"] == 9
    for k, v in want["params"].items():
        g = got["params"][k].cpu()
        if name == "tifed":
            assert torch.equal(g, v), k
        else:
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4)
    assert got["comm_bytes"] == want["comm_bytes"]
    assert got["per_client_bytes"] == want["per_client_bytes"]
    for k, v in want.get("pool_state", {}).items():
        np.testing.assert_array_equal(got["pool_state"][k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tinyreptile", "reptile"])
def test_training_on_card_matches_cpu(cuda, name):
    phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
    if name == "tinyreptile":
        run = functools.partial(
            tinyreptile_train, LOSS, phi, SineTasks(), rounds=12, beta=0.02,
            support=8, clients_per_round=3, sampling=StragglerSampling(0.5),
            seed=1)
        inner = 12 * 8
    else:
        run = functools.partial(reptile_train, LOSS, phi, SineTasks(),
                                rounds=10, beta=0.02, support=8, epochs=4,
                                clients_per_round=5, seed=2)
        inner = 10 * 4
    kw = dict(eval_every=6 if name == "tinyreptile" else 5,
              eval_kwargs=dict(num_tasks=4, support=8, k_steps=4, lr=0.02,
                               query=16))
    ops.reset_launch_counts()
    got = run(device=cuda, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["meta_update"] == (12 if name == "tinyreptile" else 10)
    assert counts["online_sgd"] == inner + 2 * 4      # + two evals x k
    want = run(device="cpu", **kw)
    for k, v in want["params"].items():
        assert got["params"][k].device.type == "cuda"
        np.testing.assert_allclose(got["params"][k].cpu().numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert got["comm_bytes"] == want["comm_bytes"]
    for ge, we in zip(got["history"], want["history"]):
        for k, v in we.items():
            np.testing.assert_allclose(ge[k], v, rtol=1e-4, atol=1e-4)


def _ssd_inputs(shape, dev, decay=0.1):
    B, H, nc, Q, P, N = shape
    r = np.random.default_rng(sum(shape))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        r.standard_normal((B, H, nc, Q, P)),
        -np.abs(r.standard_normal((B, H, nc, Q))) * decay,
        r.standard_normal((B, nc, Q, N)) * 0.3,
        r.standard_normal((B, nc, Q, N)) * 0.3))


# the JAX tests' shapes, the LM path's, one chunk, and one 4,096-token
# sequence (16 chunks)
SSD_SHAPES = [(1, 2, 2, 16, 64, 16), (2, 3, 4, 32, 64, 32),
              (1, 24, 2, 64, 64, 128), (2, 24, 8, 256, 64, 128),
              (2, 24, 1, 256, 64, 128), (1, 24, 16, 256, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, shape):
    xd, dA, Bm, Cm = _ssd_inputs(shape, cuda)
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(xd, dA, Bm, Cm)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    torch.testing.assert_close(got, ref.ssd_scan(xd, dA, Bm, Cm), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 24, 16, 256, 64, 128),
                                   (1, 3, 4, 32, 64, 32)])
def test_ssd_scan_kernel_holds_slow_decay(cuda, shape):
    """dA about -1e-4: the carried state hardly decays and grows over
    every chunk, and the 2e-4 still holds."""
    xd, dA, Bm, Cm = _ssd_inputs(shape, cuda, decay=1e-4)
    got = ops.ssd_scan(xd, dA, Bm, Cm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.ssd_scan(xd, dA, Bm, Cm), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 4, 32, 64, 32),
                                   (2, 24, 8, 256, 64, 128)])
def test_ssd_scan_phase_kernels_match_plain(cuda, shape):
    """Each of the three kernels against its plain phase, on the plain
    version's inputs to it."""
    from repro_torch.kernels import ssd_scan as ssd

    xd, dA, Bm, Cm = _ssd_inputs(shape, cuda)
    st_want, cs_want = ref.ssd_chunk_states(xd, dA, Bm)
    s_in_want = ref.ssd_state_pass(st_want, cs_want)[0]
    before = ops.ssd_scan.launches
    st, cs = ssd.chunk_states(xd, dA, Bm)
    s_in = ssd.state_pass(st_want, cs_want)
    y = ssd.chunk_outputs(xd, cs_want, Bm, Cm, s_in_want)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before     # the phases count nothing
    torch.testing.assert_close(cs, cs_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st, st_want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_in, s_in_want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(
        y, ref.ssd_chunk_outputs(xd, cs_want, Bm, Cm, s_in_want), rtol=2e-4,
        atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hg", [1, 5, 7, 24])
def test_ssd_scan_kernel_any_head_group(cuda, hg):
    """The chunk-outputs kernel at other heads-per-block settings than
    the wrapper picks, a ragged last group included."""
    from repro_torch.kernels import ssd_scan as ssd

    xd, dA, Bm, Cm = _ssd_inputs((1, 24, 2, 256, 64, 128), cuda)
    st, cs = ref.ssd_chunk_states(xd, dA, Bm)
    s_in = ref.ssd_state_pass(st, cs)[0]
    got = ssd.chunk_outputs(xd, cs, Bm, Cm, s_in, hg=hg)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in), rtol=2e-4,
        atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", range(4))
def test_ssd_scan_kernel_rejects_misaligned_operands(cuda, operand):
    """A contiguous view that starts off a 16-byte boundary raises a
    ValueError before any launch (the kernels copy 16-byte vectors), and
    the next call still runs."""
    args = list(_ssd_inputs((1, 2, 2, 16, 64, 16), cuda))
    t = args[operand]
    args[operand] = torch.empty(t.numel() + 1, device=cuda)[1:].view(
        t.shape).copy_(t)
    before = ops.ssd_scan.launches
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(*args)
    assert ops.ssd_scan.launches == before
    args[operand] = t
    torch.testing.assert_close(ops.ssd_scan(*args), ref.ssd_scan(*args),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_lm_round_on_card_matches_cpu(cuda):
    """The reduced mamba2 LM launcher on the card against the CPU, from
    the same seeded init: rows within 1e-4, comm exact, launches as
    reckoned (2 layers x 2 steps x 2 rounds ssd_scan; one dtype group)."""
    import contextlib
    import io

    from repro_torch.bridge import flatten_tree
    from repro_torch.launch import train

    argv = ["--arch", "mamba2", "--reduced", "--rounds", "2", "--seq", "48",
            "--batch", "4", "--k-inner", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        rows, summary, phi = train.run_lm(train.parse_args(argv))
        want_rows, _, want_phi = train.run_lm(train.parse_args(
            argv + ["--device", "cpu"]))
    counts = summary["kernel_launches"]
    assert (counts["ssd_scan"], counts["online_sgd"],
            counts["meta_update"]) == (8, 4, 2)
    for got, want in zip(rows, want_rows):
        assert got["comm_mb"] == want["comm_mb"]
        for k in ("loss", "inner_first", "inner_last"):
            assert abs(got[k] - want[k]) <= 1e-4, k
    got_leaves = flatten_tree(phi)
    for path, v in flatten_tree(want_phi).items():
        np.testing.assert_allclose(got_leaves[path].cpu().numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4)


FD_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}


def _fd_inputs(shape, dtype, seed, dev):
    B, H, Kv, hd, S = shape
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 .to(dev, dtype)
                 for s in ((B, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 2, 64, 1024), torch.float32),     # the JAX tests' GQA, R = 4
    ((8, 32, 4, 64, 2048), torch.bfloat16),   # tinyllama's decode, R = 8
    ((2, 4, 4, 64, 512), torch.bfloat16),     # R = 1
    ((4, 8, 4, 64, 1024), torch.bfloat16),    # R = 2
    ((4, 8, 4, 64, 1024), torch.float32),
    ((2, 8, 2, 128, 512), torch.bfloat16),    # hd 128, R = 4
    ((2, 8, 2, 128, 512), torch.float32),
    ((1, 24, 2, 128, 640), torch.bfloat16),   # R = 12: two head groups
    ((1, 24, 2, 128, 640), torch.float32),
    ((8, 8, 1, 256, 2048), torch.bfloat16),   # paligemma's decode, hd 256
    ((8, 8, 1, 256, 2048), torch.float32),
    ((8, 6, 6, 64, 1500), torch.bfloat16),    # whisper's cross decode
    ((8, 6, 6, 64, 1500), torch.float32)])
def test_flash_decode_kernel_matches_plain(cuda, shape, dtype, monkeypatch):
    """L at 1, a tile's edges (63, 64, 65), mid-cache and S; windows that
    start mid-tile; one split and several (the plan's least tiles a block
    at 1 as well as its own, so that every shape splits somewhere)."""
    from repro_torch.kernels import flash_decode as fd

    B, H, Kv, hd, S = shape
    tol = FD_TOL[dtype]
    q, k, v = _fd_inputs(shape, dtype, S + H, cuda)
    splits = set()
    for min_tiles in (1, fd.MIN_TILES):
        monkeypatch.setattr(fd, "MIN_TILES", min_tiles)
        fd.plan.cache_clear()
        for L, window in ((1, 0), (63, 0), (64, 0), (65, 0), (S // 2 + 1, 0),
                          (S, 0), (S // 2, 128), (S, 100), (S - 3, 70)):
            before = ops.flash_decode.launches
            got = ops.flash_decode(q, k, v, L, window=window)
            torch.cuda.synchronize()
            assert ops.flash_decode.launches == before + 1
            assert got.dtype == dtype and got.shape == (B, H, hd)
            torch.testing.assert_close(
                got.float(), ref.flash_decode(q, k, v, L, window=window),
                rtol=tol, atol=tol)
            lo = max(0, L - window) if window else 0
            cap = (fd.CLUSTER_SPLITS if dtype == torch.bfloat16
                   else fd.MAX_SPLITS)
            splits.add(fd.plan(B, Kv, H // Kv, L - lo, cap)[0] > 1)
    fd.plan.cache_clear()
    assert splits == {False, True}


@pytest.mark.cuda
def test_flash_decode_back_to_back_calls(cuda, monkeypatch):
    """Calls queued without a sync between them, whose split counts differ
    and whose shapes alternate, each match the plain version: state left
    stale by one call would show in the next. One tile a block at least,
    so that the calls split in several ways."""
    from repro_torch.kernels import flash_decode as fd

    monkeypatch.setattr(fd, "MIN_TILES", 1)
    fd.plan.cache_clear()

    shapes = ((8, 32, 4, 64, 2048), (2, 24, 2, 128, 1024))
    ins = {s: _fd_inputs(s, torch.bfloat16, i, cuda)
           for i, s in enumerate(shapes)}
    calls = [(shapes[i % 2], L) for i, L in enumerate(
        (2048, 577, 1, 1024, 640, 130, 2048, 64, 1500, 900))]
    outs = [ops.flash_decode(*ins[s], L) for s, L in calls]
    torch.cuda.synchronize()
    seen = set()
    for (s, L), got in zip(calls, outs):
        B, H, Kv, hd, S = s
        seen.add(fd.plan(B, Kv, H // Kv, L, fd.CLUSTER_SPLITS)[0])
        torch.testing.assert_close(got.float(),
                                   ref.flash_decode(*ins[s], L),
                                   rtol=2e-2, atol=2e-2)
    fd.plan.cache_clear()
    assert len(seen) >= 3


# -- flash_decode with L on the device, and the decode step as a graph -------

FD_PATH = (8, 32, 4, 64, 2048)              # tinyllama's decode, bf16
FD_32K = (4, 8, 4, 64, 32768)               # benchmarks/kernels_bench.py's
FD_HD256 = (8, 8, 1, 256, 2048)             # paligemma-3b's decode


def _device_len_cases(shape, dtype):
    """(L, window) cases: a decode wave's every L (1 ... 640) and the
    cache's end at the path shape, with and without a window; at the 32k
    fp32 shape, L where fewer splits are active than the grid holds."""
    S = shape[-1]
    if dtype == torch.bfloat16:
        Ls = list(range(1, 641)) + [1023, 1024, 1500, S]
        return [(L, w) for w in (0, 256) for L in Ls]
    return [(L, w) for w in (0, 3000)
            for L in (1, 64, 255, 256, 257, 1000, 4096, 8191, 8448, 20000,
                      S) if L <= S]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [(FD_PATH, torch.bfloat16),
                                         (FD_32K, torch.float32),
                                         (FD_HD256, torch.bfloat16),
                                         (FD_HD256, torch.float32)])
def test_flash_decode_device_len_equals_host_int(cuda, shape, dtype):
    """The device-L route (cache_len an int32 on the card, never read on
    the host; one grid for every L) is bit-equal to the host-int call at
    every L, and within the kernel's tolerance of the plain version; its
    launches count as the host-int route's do."""
    from repro_torch.kernels import flash_decode as fd

    B, H, Kv, hd, S = shape
    tol = FD_TOL[dtype]
    q, k, v = _fd_inputs(shape, dtype, 70, cuda)
    cap = fd.CLUSTER_SPLITS if dtype == torch.bfloat16 else fd.MAX_SPLITS
    cases = _device_len_cases(shape, dtype)
    grids = set()
    for L, window in cases:
        length = torch.tensor([L], dtype=torch.int32, device=cuda)
        before = ops.flash_decode.launches
        got = ops.flash_decode(q, k, v, length, window=window)
        want = ops.flash_decode(q, k, v, L, window=window)
        assert ops.flash_decode.launches == before + 2
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, H, hd)
        assert torch.equal(got, want), (L, window)
        if L % 64 in (0, 1) or L > 640:
            torch.testing.assert_close(
                got.float(), ref.flash_decode(q, k, v, L, window=window),
                rtol=tol, atol=tol)
        n = L - (max(0, L - window) if window else 0)
        n_max = min(window, S) if window else S
        grids.add(fd.plan(B, Kv, H // Kv, n, cap)[0]
                  < fd.splits_for(B, Kv, H // Kv, n_max, cap))
    assert grids == {False, True}      # idle blocks in the grid, and none


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [(FD_PATH, torch.bfloat16),
                                         (FD_32K, torch.float32),
                                         (FD_HD256, torch.bfloat16),
                                         (FD_HD256, torch.float32)])
def test_flash_decode_device_len_in_a_captured_graph(cuda, shape, dtype):
    """One launch captured in a CUDA graph, replayed at several L set on
    the device between replays, equals the host-int call at each L bit
    for bit; each replay counts one launch."""
    q, k, v = _fd_inputs(shape, dtype, 71, cuda)
    S = shape[-1]
    length = torch.tensor([S // 2], dtype=torch.int32, device=cuda)
    out = torch.empty_like(q)
    for window in (0, 100):
        step = graphs.GraphStep(
            lambda w=window: out.copy_(ops.flash_decode(q, k, v, length,
                                                        window=w)), cuda)
        step()                                   # run, then capture
        assert step.graph is not None
        for L in (1, 2, 63, 64, 65, 577, 640, 2048, S - 1, S, 300):
            length.fill_(L)
            before = ops.flash_decode.launches
            step()
            assert ops.flash_decode.launches == before + 1
            want = ops.flash_decode(q, k, v, L, window=window)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (L, window)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [(FD_PATH, torch.bfloat16),
                                         (FD_PATH, torch.float32),
                                         (FD_HD256, torch.bfloat16),
                                         ((1, 24, 2, 128, 640),
                                          torch.float32)])
def test_flash_decode_slice_matches_plain(cuda, shape, dtype):
    """A slice of a cache split on its sequence (``offset``,
    ``return_lse``): each slice of four, at lengths and windows whose
    stretch covers it, cuts it, holds the window's edge or misses it, on
    the host-int and the device-L route (bit-equal), against the plain
    version; an empty slice gives 0 and -inf; the four merged equal the
    whole call within the kernel's tolerance; the split fp32 merge leaves
    its counters at 0 (a later call still matches)."""
    from repro_torch.kernels import flash_decode as fd

    B, H, Kv, hd, S = shape
    tol = FD_TOL[dtype]
    q, k, v = _fd_inputs(shape, dtype, 73, cuda)
    n = S // 4
    for L, window in ((S, 0), (S // 2 + 7, 0), (S - 5, n + 9), (1, 0),
                      (3 * n + 1, 2 * n)):
        outs, lses = [], []
        for j in range(4):
            kj, vj = k[:, j * n:(j + 1) * n].contiguous(), \
                v[:, j * n:(j + 1) * n].contiguous()
            got, lse = ops.flash_decode(q, kj, vj, L, window=window,
                                        offset=j * n, return_lse=True)
            length = torch.tensor([L], dtype=torch.int32, device=cuda)
            got_d, lse_d = ops.flash_decode(q, kj, vj, length,
                                            window=window, offset=j * n,
                                            return_lse=True)
            want, want_lse = ref.flash_decode(q, kj, vj, L, window=window,
                                              offset=j * n, return_lse=True)
            torch.cuda.synchronize()
            assert torch.equal(got_d, got) and torch.equal(lse_d, lse)
            lo, hi = fd.local_stretch(L, window, j * n, n)
            if hi == lo:
                assert not got.any() and bool((lse == -np.inf).all())
            else:
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=tol)
                torch.testing.assert_close(lse, want_lse, rtol=tol,
                                           atol=tol)
            outs.append(got.float())
            lses.append(lse)
        lse = torch.stack(lses)
        w = torch.exp(lse - lse.max(0).values)
        merged = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[
            ..., None]
        torch.testing.assert_close(
            merged, ref.flash_decode(q, k, v, L, window=window), rtol=tol,
            atol=tol)
    # the default call is unchanged after slices that split
    torch.testing.assert_close(ops.flash_decode(q, k, v, S).float(),
                               ref.flash_decode(q, k, v, S), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FD_PATH, FD_HD256])
def test_flash_decode_slice_partials_are_fp32(cuda, shape):
    """bf16 caches: a slice's partial comes out fp32 on both routes (the
    kernel's bf16 instantiation with an fp32 output), held to the plain
    version's unrounded partial, the device-L route bit-equal; a host-int
    L whose stretch misses the slice launches nothing and gives 0 and
    -inf; a real CUDA tensor never takes the shape-only route."""
    from repro_torch.kernels import costs

    B, H, Kv, hd, S = shape
    tol = FD_TOL[torch.bfloat16]
    q, k, v = _fd_inputs(shape, torch.bfloat16, 91, cuda)
    n = S // 4
    kj, vj = k[:, n:2 * n].contiguous(), v[:, n:2 * n].contiguous()
    assert not any(costs.shape_only(t) for t in (q, kj, vj))
    L = n + n // 2 + 3
    before = ops.flash_decode.launches
    got, lse = ops.flash_decode(q, kj, vj, L, offset=n, return_lse=True)
    got_d, lse_d = ops.flash_decode(
        q, kj, vj, torch.tensor([L], dtype=torch.int32, device=cuda),
        offset=n, return_lse=True)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 2
    want, want_lse = ref.flash_decode(q, kj, vj, L, offset=n,
                                      return_lse=True)
    assert got.dtype == got_d.dtype == torch.float32
    assert torch.equal(got_d, got) and torch.equal(lse_d, lse)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    # the fp32 partial keeps what a bf16 output would round away
    assert not torch.equal(got, got.bfloat16().float())
    before = ops.flash_decode.launches
    empty, empty_lse = ops.flash_decode(q, kj, vj, n, offset=3 * n,
                                        return_lse=True)
    assert ops.flash_decode.launches == before
    assert empty.dtype == torch.float32 and not empty.any()
    assert bool((empty_lse == -np.inf).all())


@pytest.mark.cuda
def test_flash_decode_device_len_rejects(cuda):
    q, k, v = _fd_inputs((2, 8, 2, 64, 128), torch.bfloat16, 72, cuda)
    with pytest.raises(TypeError, match="one int32"):
        ops.flash_decode(q, k, v, torch.tensor([5], device=cuda))
    with pytest.raises(TypeError, match="one int32"):
        ops.flash_decode(q, k, v, torch.tensor([5, 6], dtype=torch.int32,
                                               device=cuda))
    with pytest.raises(ValueError, match="cache_len on cpu"):
        ops.flash_decode(q, k, v, torch.tensor([5], dtype=torch.int32))


def _decode_wave(cuda, dtype, monkeypatch=None):
    """One wave of the reduced tinyllama through the decode runner on the
    card (captured, or with ``monkeypatch`` run eagerly): every step's
    logits, the tokens, the launches and the runner."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.steps import DecodeRunner

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                              dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), cuda)
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)))
    with (monkeypatch.context() if monkeypatch
          else contextlib.nullcontext()) as mp:
        if mp is not None:
            _uncaptured(mp)
        runner = DecodeRunner(model, params, batch=3, prompt_len=12,
                              cache_len=64, max_new=20, device=cuda)
        runner.build()
        ops.reset_launch_counts()
        logits = []
        tokens = [runner.wave(prompts, on_logits=logits.append)
                  for _ in range(2)]
        torch.cuda.synchronize()
    return logits, tokens, ops.launch_counts(), runner


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_wave_replayed_equals_eager(cuda, dtype, monkeypatch):
    """The decode step built once and replayed for two waves equals the
    same step function run eagerly on the card, bit for bit: every step's
    logits and the tokens, with equal launch counts (one flash_decode per
    layer per step)."""
    got, got_tokens, counts, runner = _decode_wave(cuda, dtype)
    assert runner.trace_count == 1 and runner.step.graph is not None
    assert runner.capture_s > 0
    want, want_tokens, eager, _ = _decode_wave(cuda, dtype, monkeypatch)
    assert counts == eager
    assert counts["flash_decode"] == 2 * (12 + 20) * 2
    assert got_tokens == want_tokens
    assert len(got) == len(want) == 2 * (12 + 20)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _conv_case(name, lead, seed=0):
    """A conv paper net's init, a batch of ``lead`` samples and labels."""
    from repro_torch.configs.paper_models import PAPER_MODELS
    cfg = PAPER_MODELS[name]
    params = init_paper_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal(lead + cfg.input_shape)
                         .astype(np.float32))
    y = torch.from_numpy(r.integers(0, cfg.num_outputs, lead)
                         .astype(np.int32))
    return cfg, params, {"x": x, "y": y}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kws_conv", "omniglot_conv"])
@pytest.mark.parametrize("slots", [0, 6])
def test_conv_net_on_card_matches_cpu(cuda, name, slots):
    """The conv nets' forward, loss and gradients on the card against the
    CPU within 1e-5, in full fp32 although the caller left cuDNN's TF32
    on (TF32 would be some 1e-3 off); the caller's flags come back."""
    from repro_torch.models.paper_nets import paper_model_apply
    cfg, params, batch = _conv_case(name, (slots, 16) if slots else (16,))
    if slots:
        params = {k: torch.stack([v * (1 + 0.1 * i) for i in range(slots)])
                  for k, v in params.items()}
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    cudnn.allow_tf32, cudnn.deterministic = True, False
    try:
        out = {}
        for dev in ("cpu", cuda):
            p = {k: v.detach().to(dev).requires_grad_()
                 for k, v in params.items()}
            b = {k: v.to(dev) for k, v in batch.items()}
            logits = paper_model_apply(cfg, p, b["x"])
            loss = paper_model_loss(cfg, p, b)
            loss.sum().backward()
            out[str(dev)] = (logits.detach().cpu(), loss.detach().cpu(),
                             {k: v.grad.cpu() for k, v in p.items()})
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved
    (lc, sc, gc_), (lg, sg, gg) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sg, sc, rtol=1e-5, atol=1e-5)
    for k in gc_:
        torch.testing.assert_close(gg[k], gc_[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["omniglot_tinyreptile", "kws_reptile_c4"])
def test_captured_conv_round_equals_uncaptured(cuda, name, monkeypatch):
    """A conv net's round captured once and replayed gives the params and
    history (accuracy included) of the same round run eagerly, bit for
    bit, with the same launch counts: cuDNN's algorithms are
    deterministic on both routes."""
    from repro_torch.configs.paper_models import KWS_CONV, OMNIGLOT_CONV
    from repro_torch.data import KWSTasks, OmniglotTasks
    from repro_torch.models.paper_nets import paper_model_accuracy
    cfg, dist = ((OMNIGLOT_CONV, OmniglotTasks()) if name.startswith("omni")
                 else (KWS_CONV, KWSTasks()))
    phi = init_paper_model(cfg, torch.Generator().manual_seed(0), "cpu")
    loss = functools.partial(paper_model_loss, cfg)
    kw = dict(beta=0.01, support=16, seed=4, eval_every=3,
              eval_kwargs=dict(num_tasks=6, support=16, k_steps=8, lr=0.01,
                               query=32, metric_fn=functools.partial(
                                   paper_model_accuracy, cfg)))
    if name.endswith("c4"):
        run = functools.partial(reptile_train, loss, phi, dist, rounds=6,
                                epochs=8, clients_per_round=4, **kw)
    else:
        run = functools.partial(tinyreptile_train, loss, phi, dist,
                                rounds=6, **kw)
    clear_runner_cache()
    ops.reset_launch_counts()
    got = run(device=cuda)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    (runner,) = engine._RUNNER_CACHE._entries.values()
    assert runner.trace_count == 1
    clear_runner_cache()
    with monkeypatch.context() as mp:
        _uncaptured(mp)
        ops.reset_launch_counts()
        want = run(device=cuda)
        torch.cuda.synchronize()
        assert ops.launch_counts() == counts
    clear_runner_cache()
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["history"] == want["history"]


def _ckpt_run(name, device, **ckpt):
    """A small run of each snapshot shape: fp32 phi, TIFeD's int8 codes,
    a pool in host slabs with a FedBuff buffer under Markov check-ins."""
    from repro_torch.core import MarkovAvailability, run_federated
    from repro_torch.core.strategies import TifedStrategy, TinyReptileStrategy
    from repro_torch.models.paper_nets import relu_mlp_loss

    phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
    kw = dict(rounds=12, clients_per_round=4, support=8, beta=0.02, seed=3,
              eval_every=6, eval_kwargs=dict(num_tasks=2, support=4,
                                             k_steps=2, lr=0.01, query=8),
              device=device, **ckpt)
    if name == "tifed":
        return run_federated(phi, SineTasks(), TifedStrategy(relu_mlp_loss),
                             channel=CommChannel("int8", quantize=False),
                             **kw)
    if name == "pool_host":
        kw.update(pool=ClientPool(SineTasks(), 64, seed=5,
                                  residency="host"),
                  buffered=BufferedAggregation(3),
                  sampling=MarkovAvailability())
    return run_federated(phi, SineTasks(), TinyReptileStrategy(LOSS), **kw)


def _assert_same_run(got, want):
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["history"] == want["history"]
    for key in ("comm_bytes", "per_client_bytes"):
        assert got.get(key) == want.get(key), key
    for k, v in want.get("pool_state", {}).items():
        np.testing.assert_array_equal(np.asarray(got["pool_state"][k]),
                                      np.asarray(v), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tinyreptile", "tifed", "pool_host"])
def test_ckpt_crash_resume_on_card(cuda, name, tmp_path):
    """On the card: a run crashed right after its round-4 snapshot and
    resumed equals the uninterrupted run (its snapshots written by the
    async writer while the next blocks run) exactly; the round is built
    once across the three runs."""
    from repro_torch.testing import faults

    clear_runner_cache()
    ck = dict(ckpt_every=4)
    ref = _ckpt_run(name, cuda, ckpt_dir=str(tmp_path / "ref"), **ck)
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(4):
            _ckpt_run(name, cuda, ckpt_dir=str(tmp_path / "ck"),
                      ckpt_async=False, **ck)
    res = _ckpt_run(name, cuda, ckpt_dir=str(tmp_path / "ck"), resume=True,
                    **ck)
    _assert_same_run(res, ref)
    (runner,) = engine._RUNNER_CACHE._entries.values()
    assert runner.trace_count == 1


@pytest.mark.cuda
def test_ckpt_async_snapshots_on_card_hold_their_round(cuda, tmp_path):
    """A snapshot every round, each block replayed right after the
    previous snapshot's clones: the async writer's files equal those of
    a synchronous run, round by round."""
    from repro_torch.checkpoint import list_checkpoints

    runs = {}
    for kind, ck in (("async", {}), ("sync", dict(ckpt_async=False))):
        _ckpt_run("pool_host", cuda, ckpt_dir=str(tmp_path / kind),
                  ckpt_every=1, ckpt_keep=12, **ck)
        runs[kind] = list_checkpoints(str(tmp_path / kind))
    assert len(runs["async"]) == len(runs["sync"]) == 12
    for a, b in zip(runs["async"], runs["sync"]):
        with np.load(a) as za, np.load(b) as zb:
            assert za.files == zb.files
            for k in zb.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_dropped_decode_runner_frees_the_card(cuda, arch):
    """With Python's cyclic collector off, dropping a decode runner whose
    step was captured gives its caches back at once: ``memory_allocated``
    falls by at least the caches' bytes, and a collection afterwards frees
    nothing more."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.steps import DecodeRunner

    model = build_model(get_arch(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), cuda)
    collecting = gc.isenabled()
    gc.disable()
    try:
        runner = DecodeRunner(model, params, batch=2, prompt_len=4,
                              cache_len=256, max_new=4, device=cuda)
        runner.wave(torch.zeros(2, 4, dtype=torch.int64))
        assert runner.step.graph is not None
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in tree_leaves(runner.cache))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        del runner
        torch.cuda.synchronize()
        dropped = torch.cuda.memory_allocated()
        assert held - dropped >= cache_bytes
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == dropped
    finally:
        if collecting:
            gc.enable()
