"""The port's kernels, serving slice and training engine on a CUDA
device.

These tests need the card: each skips where there is none. They import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch (``python -m pytest -q --noconftest tests/test_torch_cuda.py``).
Each kernel is held to its plain PyTorch version on the same CUDA
tensors, and the served results and trained params on the card to the
port on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import (StragglerSampling, reptile_train,  # noqa: E402
                              tinyreptile_train)
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


def _case(dims, S, B, seed, dev):
    rng = np.random.default_rng(seed)
    din, h1, h2, dout = dims

    def ints(lo, hi, shape, dtype):
        return torch.from_numpy(
            rng.integers(lo, hi + 1, shape).astype(dtype)).to(dev)

    ws = tuple(ints(-127, 127, (B,) + s, np.int8)
               for s in ((din, h1), (h1, h2), (h2, dout)))
    bs = tuple(ints(-2 ** 15, 2 ** 15, (B, n), np.int32)
               for n in (h1, h2, dout))
    xq = ints(-127, 127, (B, S, din), np.int8)
    yal = ints(-2 ** 15, 2 ** 15, (B, S, dout), np.int32)
    layer = torch.arange(B, dtype=torch.int32, device=dev) % 3
    fb = tuple(ints(-127, 127, (dout, h), np.int8) for h in (h1, h2))
    dither = tuple(torch.from_numpy(rng.random((B,) + s).astype(np.float32))
                   .to(dev) for s in ((din, h1), (h1, h2), (h2, dout)))
    scales = ref.pack_scales(
        {"f0": 2.0 ** -7, "f1": 2.0 ** -7, "fe": 2.0 ** -9,
         "floss": 2.0 ** -4 / S, "ftw": (2.0 ** -8, 2.0 ** -9, 2.0 ** -10),
         "ftb": (2.0 ** -6, 2.0 ** -7, 2.0 ** -8)}, device=dev)
    return ws, bs, xq, yal, layer, fb, dither, scales


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
def test_online_sgd_kernel_matches_plain(cuda, dtype, tol):
    g = torch.Generator().manual_seed(0)
    p, grad = (torch.randn(64, 1153, generator=g).to(cuda, dtype)
               for _ in range(2))
    before = ops.online_sgd.launches
    out = ops.online_sgd(p, grad, 0.01)
    torch.cuda.synchronize()
    assert ops.online_sgd.launches == before + 1
    torch.testing.assert_close(out.float(),
                               ref.online_sgd(p, grad, 0.01).float(),
                               rtol=tol, atol=tol)


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
@pytest.mark.parametrize("n,offset", [(1153, 0), (1 << 20, 0), (4099, 1)])
def test_meta_update_kernel_matches_plain(cuda, dtype, n, offset):
    """Exact: the kernel rounds each operation on its own, as the plain
    version's separate tensor ops do. ``offset`` 1 misaligns the
    buffers, which takes the scalar path."""
    g = torch.Generator().manual_seed(n)
    w, wh = (torch.randn(n + offset, generator=g).to(cuda, dtype)[offset:]
             for _ in range(2))
    for a in (0.0, 0.37, 1.0):
        alpha = torch.tensor([a], device=cuda)
        before = ops.meta_update.launches
        out = ops.meta_update(w, wh, alpha)
        torch.cuda.synchronize()
        assert ops.meta_update.launches == before + 1
        assert out.dtype == dtype
        assert torch.equal(out, ref.meta_update(w, wh, alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_online_sgd_momentum_kernel_matches_plain(cuda, dtype, tol):
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
    torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gp.float(), wp.float(), rtol=tol,
                               atol=tol if dtype == torch.bfloat16 else 1e-6)


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
