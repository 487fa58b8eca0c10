"""The port's kernels, held against the JAX package on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions, so
these tests pin the arithmetic the CUDA and Triton kernels are held to
on the GPU (``chip_smoke.py`` and tests/test_torch_cuda.py).
Both sides get the same seeded NumPy inputs; the JAX side is its plain
oracle ``repro.kernels.ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax.numpy as jnp  # noqa: E402

from repro.core import strategies as jstrat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", [(129,), (1153,), (1024, 33)])
def test_online_sgd_ref_matches_jax(shape, dtype, tol):
    rng = np.random.default_rng(0)
    p = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    lr = 0.0173
    want = np.asarray(jref.online_sgd(jnp.asarray(p, dtype),
                                      jnp.asarray(g, dtype), lr), np.float32)
    tdt = getattr(torch, dtype)
    got = tref.online_sgd(torch.tensor(p).to(tdt), torch.tensor(g).to(tdt), lr)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_online_sgd_momentum_ref_matches_jax():
    rng = np.random.default_rng(1)
    p, g, m = (rng.normal(size=(257,)).astype(np.float32) for _ in range(3))
    wp, wm = jref.online_sgd(jnp.asarray(p), jnp.asarray(g), 0.05,
                             m=jnp.asarray(m), momentum=0.9)
    gp, gm = tref.online_sgd(torch.tensor(p), torch.tensor(g), 0.05,
                             m=torch.tensor(m), momentum=0.9)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (1153,), (64, 64), (3, 5, 257),
                                   (8192,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_meta_update_matches_jax_kernel(shape, dtype, alpha):
    """The port's wrapper on the CPU (its plain version) against the JAX
    Pallas kernel in interpret mode, on tests/test_kernels.py's sweep."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=shape).astype(np.float32)
    wh = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jops.meta_update(jnp.asarray(w, dtype),
                                       jnp.asarray(wh, dtype), alpha),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = tops.meta_update(torch.tensor(w).to(tdt), torch.tensor(wh).to(tdt),
                           alpha)
    assert got.dtype == tdt and got.shape == shape
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_meta_update_takes_alpha_as_a_tensor():
    w, wh = torch.randn(1153), torch.randn(1153)
    a = torch.tensor([0.37])
    assert torch.equal(tops.meta_update(w, wh, a),
                       tops.meta_update(w, wh, 0.37))
    with pytest.raises(ValueError, match="alpha"):
        tops.meta_update(w, wh, torch.tensor([0.3, 0.4]))
    with pytest.raises(ValueError, match="alpha"):
        tops.meta_update(w, wh, torch.tensor([0.3], dtype=torch.float64))


def test_tree_meta_update_matches_jax():
    rng = np.random.default_rng(4)
    shapes = {"w0": (1, 32), "b0": (32,), "w1": (32, 32), "b1": (32,)}
    phi = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    hat = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    want = jops.tree_meta_update({k: jnp.asarray(v) for k, v in phi.items()},
                                 {k: jnp.asarray(v) for k, v in hat.items()},
                                 0.37)
    got = tops.tree_meta_update({k: torch.tensor(v) for k, v in phi.items()},
                                {k: torch.tensor(v) for k, v in hat.items()},
                                0.37)
    assert set(got) == set(want)
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_online_sgd_momentum_matches_jax_kernel(dtype, tol):
    """tests/test_kernels.py's momentum case (513 elements, m = 0.3)
    against the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    p, g = (rng.normal(size=(513,)).astype(np.float32) for _ in range(2))
    m = np.full((513,), 0.3, np.float32)
    wp, wm = jops.online_sgd_momentum(jnp.asarray(p, dtype),
                                      jnp.asarray(g, dtype), jnp.asarray(m),
                                      0.05, 0.9)
    tdt = getattr(torch, dtype)
    gp, gm = tops.online_sgd_momentum(torch.tensor(p).to(tdt),
                                      torch.tensor(g).to(tdt),
                                      torch.tensor(m), 0.05, 0.9)
    assert gp.dtype == tdt and gm.dtype == torch.float32
    np.testing.assert_allclose(gp.float().numpy(),
                               np.asarray(wp, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5,
                               atol=1e-7)


def _tifed_case(dims, S, seed, B, extreme=False):
    """B slots of random (or all-rails) integer TIFeD operands, NumPy,
    with a power-of-two scales dict (as tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    din, h1, h2, dout = dims

    def ints(lo, hi, shape):
        if extreme:
            return rng.choice([lo, hi], shape).astype(np.int64)
        return rng.integers(lo, hi + 1, shape)

    ws = tuple(ints(-127, 127, (B,) + s).astype(np.int8)
               for s in ((din, h1), (h1, h2), (h2, dout)))
    blim = 2 ** 22 if extreme else 2 ** 15
    bs = tuple(ints(-blim, blim, (B, n)).astype(np.int32)
               for n in (h1, h2, dout))
    xq = ints(-127, 127, (B, S, din)).astype(np.int8)
    ylim = 2 ** 21 if extreme else 2 ** 15
    yal = ints(-ylim, ylim, (B, S, dout)).astype(np.int32)
    fb = tuple(ints(-127, 127, (dout, h)).astype(np.int8) for h in (h1, h2))
    dither = tuple(rng.random((B,) + s).astype(np.float32)
                   for s in ((din, h1), (h1, h2), (h2, dout)))
    scales = {"f0": 2.0 ** -7, "f1": 2.0 ** -7, "fe": 2.0 ** -9,
              "floss": 2.0 ** -4 / S,
              "ftw": (2.0 ** -8, 2.0 ** -9, 2.0 ** -10),
              "ftb": (2.0 ** -6, 2.0 ** -7, 2.0 ** -8)}
    return ws, bs, xq, yal, fb, dither, scales


def _check_dfa_against_jax(case, layers):
    ws, bs, xq, yal, fb, dither, scales = case
    T = torch.from_numpy
    gw, gb, gl = tops.dfa_epoch_int8(
        tuple(T(w) for w in ws), tuple(T(b) for b in bs), T(xq), T(yal),
        torch.tensor(layers, dtype=torch.int32), tuple(T(f) for f in fb),
        tuple(T(d) for d in dither), tref.pack_scales(scales))
    f32 = jnp.float32
    jscales = {k: (tuple(f32(x) for x in v) if isinstance(v, tuple)
                   else f32(v)) for k, v in scales.items()}
    for b, layer in enumerate(layers):
        ww, wb, wl = jref.dfa_int8_epoch(
            tuple(jnp.asarray(w[b], f32) for w in ws),
            tuple(jnp.asarray(x[b], f32) for x in bs),
            jnp.asarray(xq[b], f32), jnp.asarray(yal[b], f32), layer,
            tuple(jnp.asarray(f, f32) for f in fb),
            tuple(jnp.asarray(d[b]) for d in dither), jscales)
        for i in range(3):
            assert gw[i].dtype == torch.int8 and gb[i].dtype == torch.int32
            np.testing.assert_array_equal(gw[i][b].numpy().astype(np.float32),
                                          np.asarray(ww[i]))
            np.testing.assert_array_equal(gb[i][b].numpy().astype(np.float32),
                                          np.asarray(wb[i]))
        # sum(err^2) passes 2^24, so the fp32 loss depends on summation
        # order: the loss is held to rtol 1e-6, not to equality
        np.testing.assert_allclose(gl[b].item(), float(wl), rtol=1e-6)


@pytest.mark.parametrize("dims", [(1, 32, 32, 1), (5, 16, 12, 3)])
@pytest.mark.parametrize("layer", [0, 1, 2])
def test_dfa_epoch_ref_matches_jax(dims, layer):
    """Three slots, every slot its own layer (the per-slot ``layer``),
    checked slot by slot against the JAX oracle: weights and biases
    exact, loss to rtol 1e-6."""
    layers = [layer, (layer + 1) % 3, (layer + 2) % 3]
    _check_dfa_against_jax(_tifed_case(dims, 32, 10 + layer, 3), layers)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_dfa_epoch_ref_accumulation_edge(layer):
    """S = 512 samples at the int8 / bias rails: the documented
    envelope, where every integer sum still stays below 2^24."""
    case = _tifed_case((1, 8, 8, 1), 512, 99, 2, extreme=True)
    _check_dfa_against_jax(case, [layer, layer])


def test_pow2_quantize_matches_jax_on_seeded_tensors():
    rng = np.random.default_rng(3)
    for scale in (1e-4, 0.02, 0.9, 3.7, 250.0):
        w = (rng.normal(size=(33, 17)) * scale).astype(np.float32)
        jq, je = jref.quantize_pow2(jnp.asarray(w))
        tq, te = tref.quantize_pow2(torch.tensor(w))
        assert int(te) == int(je)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    zero = tref.pow2_exponent(torch.tensor(0.0))
    assert int(zero) == int(jref.pow2_exponent(jnp.float32(0.0))) == -24


def test_pow2_exponent_exact_rule_at_boundary():
    """At maxabs = 127 * 2^-17 the smallest e with maxabs * 2^-e <= 127
    is -17; the JAX reference's ceil(log2(.)) form returns -16 there (a
    reference caveat, ROADMAP queue C). The port follows the contract."""
    maxabs = np.float32(127 * 2.0 ** -17)
    e = int(tref.pow2_exponent(torch.tensor(maxabs)))
    assert e == -17
    assert maxabs * 2.0 ** -e <= 127 < maxabs * 2.0 ** -(e - 1)
    assert int(jref.pow2_exponent(jnp.float32(maxabs))) == -16
    for k in range(-23, 23):
        m = np.float32(127 * 2.0 ** k)
        assert int(tref.pow2_exponent(torch.tensor(m))) == k
        above = np.nextafter(m, np.float32(np.inf))
        assert int(tref.pow2_exponent(torch.tensor(above))) == k + 1


def test_tifed_constants_bit_equal_to_jax():
    for seed, epochs, dims in ((0, 6, (1, 32, 32, 1)), (3, 4, (5, 16, 12, 3))):
        jfb, jd = jstrat._tifed_constants(seed, epochs, dims)
        tfb, td = tstrat._tifed_constants(seed, epochs, dims)
        for a, b in zip(jfb + jd, tfb + td):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ops_on_cpu_take_the_plain_path():
    tops.reset_launch_counts()
    p = torch.randn(64, 1153, generator=torch.Generator().manual_seed(0))
    g = torch.ones_like(p)
    out = tops.online_sgd(p, g, 0.5)
    torch.testing.assert_close(out, tref.online_sgd(p, g, 0.5), rtol=0,
                               atol=0)
    ws, bs, xq, yal, fb, dither, scales = _tifed_case((1, 32, 32, 1), 8, 5, 4)
    T = torch.from_numpy
    tops.dfa_epoch_int8(tuple(T(w) for w in ws), tuple(T(b) for b in bs),
                        T(xq), T(yal), torch.zeros(4, dtype=torch.int32),
                        tuple(T(f) for f in fb), tuple(T(d) for d in dither),
                        tref.pack_scales(scales))
    out = tops.meta_update(p, g, 0.37)
    torch.testing.assert_close(out, tref.meta_update(p, g, 0.37), rtol=0,
                               atol=0)
    tops.online_sgd_momentum(p, g, torch.zeros_like(p), 0.5, 0.9)
    assert tops.launch_counts() == {name: 0 for name in tops.KERNELS}


def test_wrappers_reject_bad_operands():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="shape"):
        tops.online_sgd(p, torch.zeros(9), 0.1)
    with pytest.raises(TypeError, match="dtype"):
        tops.online_sgd(p, torch.zeros(8, dtype=torch.float64), 0.1)
    with pytest.raises(ValueError, match="fp32"):
        tops.online_sgd_momentum(p, p, torch.zeros(8, dtype=torch.bfloat16),
                                 0.1, 0.9)
    with pytest.raises(ValueError, match="shape"):
        tops.meta_update(p, torch.zeros(9), 0.5)
    with pytest.raises(TypeError, match="float32"):
        tops.meta_update(p.double(), p.double(), 0.5)
    ws, bs, xq, yal, fb, dither, scales = _tifed_case((1, 4, 4, 1), 8, 6, 2)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="w0"):
        tops.dfa_epoch_int8((T(ws[0]).int(), T(ws[1]), T(ws[2])),
                            tuple(T(b) for b in bs), T(xq), T(yal),
                            torch.zeros(2, dtype=torch.int32),
                            tuple(T(f) for f in fb),
                            tuple(T(d) for d in dither),
                            tref.pack_scales(scales))
