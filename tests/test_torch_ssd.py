"""The port's chunked SSD scan against the JAX package's, on the CPU.

``kernels/ref.py::ssd_scan`` (the kernel's plain version, which the
``ssd_scan`` wrapper takes for CPU tensors), ``models/mamba2.py::
ssd_chunked``, the autograd function around the kernel
(``ssd_chunked_kernel``) and the plain versions of the kernel's three
phases (chunk states, state pass, chunk outputs) are held to
``repro``'s ``ref.ssd_scan``, its Pallas kernel in interpret mode,
``ssd_chunked`` (its y and final state) and the gradient of
``ssd_chunked_pallas``. Inputs come from NumPy seeds. Tolerances: 2e-4
for the scan, as the JAX package's own kernel test; 1e-4 for the
gradients (fp32 sums of up to a chunk's length in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

TOL = 2e-4
SHAPES = [(1, 2, 2, 16, 64, 16), (2, 3, 4, 32, 64, 32),
          (1, 24, 2, 64, 64, 128)]       # the last is mamba2-130m's geometry
# the kernel's three phases: the JAX tests' shapes, one chunk, 16 chunks
PHASE_SHAPES = SHAPES + [(2, 3, 1, 32, 64, 32), (1, 2, 16, 16, 64, 16)]


def _scan_inputs(shape, seed):
    B, H, nc, Q, P, N = shape
    r = np.random.default_rng(seed)
    return tuple(a.astype(np.float32) for a in (
        r.standard_normal((B, H, nc, Q, P)),
        -np.abs(r.standard_normal((B, H, nc, Q))) * 0.1,
        r.standard_normal((B, nc, Q, N)) * 0.3,
        r.standard_normal((B, nc, Q, N)) * 0.3))


def _model_inputs(B, S, H, P, N, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(r.standard_normal((B, S, H))))      # softplus
    A = -np.abs(r.standard_normal(H))
    Bm = r.standard_normal((B, S, N)) * 0.3
    Cm = r.standard_normal((B, S, N)) * 0.3
    return tuple(a.astype(np.float32) for a in (x, dt, A, Bm, Cm))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_ssd_scan_matches_jax_ref_and_pallas_kernel(shape):
    ins = _scan_inputs(shape, sum(shape))
    got = ref.ssd_scan(*_t(ins)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.ssd_scan(*ins)),
                               rtol=TOL, atol=TOL)
    pallas = jops.ssd_scan(*map(jnp.asarray, ins))           # interpret mode
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)
    # the wrapper hands a CPU tensor to the plain version: same numbers,
    # no kernel launch counted
    before = ops.ssd_scan.launches
    np.testing.assert_array_equal(ops.ssd_scan(*_t(ins)).numpy(), got)
    assert ops.ssd_scan.launches == before


def _phases(xd, dA, Bm, Cm):
    """ref's three phases of the kernel, composed: (y, final state)."""
    st, cs = ref.ssd_chunk_states(xd, dA, Bm)
    s_in, final = ref.ssd_state_pass(st, cs)
    return ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in), final


@pytest.mark.parametrize("shape", PHASE_SHAPES)
def test_ssd_phases_compose_to_jax_scan(shape):
    """Chunk states, state pass and chunk outputs (the kernel's split)
    give ref.ssd_scan, repro's ref.ssd_scan and its Pallas kernel in
    interpret mode; the phase wrappers take them for CPU tensors."""
    from repro_torch.kernels import ssd_scan as ssd

    ins = _scan_inputs(shape, sum(shape) + 1)
    xd, dA, Bm, Cm = _t(ins)
    y, _ = _phases(xd, dA, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), ref.ssd_scan(xd, dA, Bm, Cm),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.ssd_scan(*ins)),
                               rtol=TOL, atol=TOL)
    pallas = jops.ssd_scan(*map(jnp.asarray, ins))           # interpret mode
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), rtol=TOL,
                               atol=TOL)
    st, cs = ssd.chunk_states(xd, dA, Bm)
    assert st.shape == (*xd.shape[:3], Bm.shape[-1], xd.shape[-1])
    y_w = ssd.chunk_outputs(xd, cs, Bm, Cm, ssd.state_pass(st, cs))
    np.testing.assert_array_equal(y_w.numpy(), y.numpy())


@pytest.mark.parametrize("shape", PHASE_SHAPES)
def test_ssd_passed_states_match_jax_final_state(shape):
    """The model's inputs in the kernel's layout: the state after the
    pass's last chunk is jax ssd_chunked's final state (transposed), and
    the phases' y its y."""
    B, H, nc, Q, P, N = shape
    S = nc * Q
    ins = _model_inputs(B, S, H, P, N, sum(shape) + 2)
    y_j, st_j = jm.ssd_chunked(*map(jnp.asarray, ins), Q)
    x, dt, A, Bm, Cm = _t(ins)
    xd = (x * dt[..., None]).reshape(B, nc, Q, H, P).permute(
        0, 3, 1, 2, 4).contiguous()
    dA = (dt * A).reshape(B, nc, Q, H).permute(0, 3, 1, 2).contiguous()
    y, final = _phases(xd, dA, Bm.reshape(B, nc, Q, N),
                       Cm.reshape(B, nc, Q, N))
    np.testing.assert_allclose(final.transpose(-1, -2).numpy(),
                               np.asarray(st_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        y.permute(0, 2, 3, 1, 4).reshape(B, S, H, P).numpy(),
        np.asarray(y_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [128, 100])     # whole chunks, then ragged
def test_ssd_chunked_matches_jax(S):
    ins = _model_inputs(2, S, 4, 32, 16, S)
    y_j, st_j = jm.ssd_chunked(*map(jnp.asarray, ins), 32)
    y_t, st_t = tm.ssd_chunked(*_t(ins), 32)
    assert y_t.shape == (2, S, 4, 32)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=TOL,
                               atol=TOL)
    # the kernel route's forward (its plain version here) gives the same y
    y_k = tm.ssd_chunked_kernel(*_t(ins), 32)
    np.testing.assert_allclose(y_k.numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)


def test_ssd_chunked_with_initial_state_matches_jax():
    ins = _model_inputs(1, 64, 2, 16, 8, 7)
    init = np.random.default_rng(8).standard_normal((1, 2, 16, 8)).astype(
        np.float32)
    y_j, st_j = jm.ssd_chunked(*map(jnp.asarray, ins), 16,
                               initial_state=jnp.asarray(init))
    y_t, st_t = tm.ssd_chunked(*_t(ins), 16,
                               initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=TOL,
                               atol=TOL)


def test_ssd_kernel_layout_matches_model_path():
    """The kernel layout agrees with ssd_chunked (tests/test_kernels.py's
    identity, on the port)."""
    B, S, H, P, N, chunk = 2, 128, 4, 32, 16, 32
    x, dt, A, Bm, Cm = _t(_model_inputs(B, S, H, P, N, 5))
    y_model, _ = tm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    nc = S // chunk
    xd = (x * dt[..., None]).reshape(B, nc, chunk, H, P).permute(
        0, 3, 1, 2, 4).contiguous()
    dA = (dt * A).reshape(B, nc, chunk, H).permute(0, 3, 1, 2).contiguous()
    y_kernel = ops.ssd_scan(xd, dA, Bm.reshape(B, nc, chunk, N),
                            Cm.reshape(B, nc, chunk, N))
    y_kernel = y_kernel.permute(0, 2, 3, 1, 4).reshape(B, S, H, P)
    np.testing.assert_allclose(y_kernel.numpy(), y_model.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("S", [70])          # a ragged last chunk
def test_ssd_kernel_gradients_match_jax(S):
    """The autograd function (kernel forward, plain backward) against
    jax.grad of ssd_chunked_pallas, every input's gradient at 1e-4."""
    ins = _model_inputs(2, S, 3, 16, 8, 11 + S)
    w = np.random.default_rng(S).standard_normal((2, S, 3, 16)).astype(
        np.float32)

    def jloss(*a):
        return jnp.sum(jm.ssd_chunked_pallas(*a, 32) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    leaves = [t.requires_grad_() for t in _t(ins)]
    (tm.ssd_chunked_kernel(*leaves, 32) * torch.from_numpy(w)).sum().backward()
    for name, leaf, g in zip(("x", "dt", "A", "Bm", "Cm"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("bad", ["dA_shape", "dtype", "B_shape", "rank"])
def test_ssd_scan_wrapper_rejects_bad_operands(bad):
    xd, dA, Bm, Cm = _t(_scan_inputs((1, 2, 2, 16, 64, 16), 0))
    if bad == "dA_shape":            # a ragged chunk: not whole chunks
        dA = dA[..., :-1]
    elif bad == "dtype":
        xd = xd.double()
    elif bad == "B_shape":
        Bm = Bm[:, :1]
    else:
        xd = xd[0]
    with pytest.raises((ValueError, TypeError)):
        ops.ssd_scan(xd, dA, Bm, Cm)
