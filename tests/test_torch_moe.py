"""The port's MoE family against the JAX package's, on the CPU:
``models/moe.py``'s block (top-1 and top-2, with and without the shared
expert, capacity drops, a zero-row tie, the aux loss and the gradients),
the llama4 layer pattern, then the reduced mixtral-8x22b (2 layers, and
16 where the JAX package stacks the layers), llama4-maverick at 16
layers (``moe_every=2``: a period of dense and MoE blocks with its
global layer): ``loss_fn``, gradients,
``prefill_fn``, decode steps, one ``make_meta_train_step`` round and the
bridge's round trip of params and caches; the train launcher's ``--arch
moe`` engine route against the JAX launcher's row.

The JAX package's init (``jax.random``) is carried over with
``bridge.lm_params_from_jax``, and every input is a seeded NumPy array.
Routing is held exactly: every ``route`` call the port makes is replayed
through ``jax.lax.top_k`` on the same router input, the chosen experts
must agree, and the smallest gap between the k-th and (k+1)-th
probability is printed. Tolerances: fp32 at rtol 1e-5 (logits and
caches also within 1e-5 of the largest entry: at 16 layers the two
packages' fp32 sums part by 2e-5 on logits near 1); gradients within
1e-4 of each leaf's largest entry; one round at 1e-4; bf16 (the block,
with its fp32 router) at 4 bf16 steps.
"""
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
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.runtime.steps import make_meta_train_step as jmeta_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import (make_meta_train_step,  # noqa: E402
                                       make_prefill_step)

BETA, ALPHA = 0.02, 0.7
BF16_RTOL = 2 ** -6                           # 4 bf16 steps
DECODE_STEPS = 3


def _np(a):
    return np.asarray(a, np.float32)


@contextlib.contextmanager
def routes_seen():
    """Every port ``route`` call while open: (router input, router, k,
    chosen experts)."""
    real, seen = tmoe.route, []

    def tap(params, xf, k):
        probs, gate, idx = real(params, xf, k)
        seen.append((xf.detach().float().numpy(),
                     params["router"].detach().numpy(), k, idx.numpy()))
        return probs, gate, idx
    tmoe.route = tap
    try:
        yield seen
    finally:
        tmoe.route = real


def assert_routes_match_jax(seen):
    """Each port route call's chosen experts equal ``jax.lax.top_k`` of
    the JAX router on the same input; returns the smallest gap between
    the k-th and (k+1)-th probability (printed)."""
    assert seen
    gap = np.inf
    for xf, router, k, idx in seen:
        probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), -1)
        _, want = jax.lax.top_k(probs, k)
        np.testing.assert_array_equal(idx, np.asarray(want))
        top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
        if top.shape[1] > k:
            gap = min(gap, float((top[:, k - 1] - top[:, k]).min()))
    print(json.dumps({"route_calls": len(seen), "min_gap": gap}))
    return gap


# -- the block ---------------------------------------------------------------

def _block_params(seed, d, f, E, shared, dtype=np.float32):
    r = np.random.default_rng(seed)

    def mat(*s):
        return (r.standard_normal(s) / np.sqrt(s[0])).astype(dtype)
    p = {"router": mat(d, E).astype(np.float32), "w_gate": mat(E, d, f),
         "w_up": mat(E, d, f), "w_down": mat(E, f, d)}
    if shared:
        p["shared"] = {"w_gate": mat(d, f), "w_up": mat(d, f),
                       "w_down": mat(f, d)}
    return p


def _both(p):
    return (jax.tree.map(jnp.asarray, p),
            bridge.params_from_numpy(p, "cpu"))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_block_matches_jax(k, shared):
    """The output and the aux loss at 1e-5, the chosen experts exactly,
    and the gradients of a weighted output sum plus the aux loss with
    respect to the input and every leaf within 1e-4 of its largest
    entry. 2 x 24 tokens over 4 experts: no capacity drop at 1.25.

    At top-1 the router's gradient is held to the JAX package's in
    float64 instead: the gate is p / max(p, 1e-9) = 1, whose true
    gradient 0 both packages compute as the difference of two equal
    terms, so in fp32 each leaves a rounding residue (the JAX package's
    own 9.3e-4 of the leaf's largest entry from float64 here, the
    port's 1.7e-3); held at 1e-2 of it (ROADMAP "Known gaps")."""
    d, f, E = 32, 48, 4
    jp, tp = _both(_block_params(k * 10 + shared, d, f, E, shared))
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 24, d)).astype(np.float32)
    w = r.standard_normal((2, 24, d)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_block(p, xx, experts_per_token=k)
        return jnp.sum(y * w) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    leaves = {kk: v.requires_grad_() for kk, v in
              bridge.flatten_tree(tp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    with routes_seen() as seen:
        ty, taux = tmoe.moe_block(bridge.unflatten_tree(leaves), tx,
                                  experts_per_token=k)
    assert_routes_match_jax(seen)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(taux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum() + taux,
                                [tx] + list(leaves.values()))
    want = {("x",): _np(jgx), **bridge.flatten_tree(jax.tree.map(_np, jgp))}
    got = {("x",): grads[0].numpy(),
           **{kk: g.numpy() for kk, g in zip(leaves, grads[1:])}}
    assert set(got) == set(want)
    if k == 1:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
            want[("router",)] = _np(jax.grad(
                lambda p: jloss(p, jnp.asarray(x, jnp.float64))[0])(p64)[
                "router"])
    for path, g in want.items():
        tol = 1e-2 if k == 1 and path == ("router",) else 1e-4
        np.testing.assert_allclose(got[path], g, rtol=0,
                                   atol=tol * np.abs(g).max(),
                                   err_msg=str(path))


def test_capacity_drops_match_jax():
    """At capacity_factor 0.5 some choices overflow their expert's C rows
    and are dropped (their token gets less or nothing from the routed
    experts): the output, aux loss and gradients still equal the JAX
    package's."""
    d, f, E, k, T = 16, 24, 4, 2, 64
    jp, tp = _both(_block_params(7, d, f, E, False))
    x = np.random.default_rng(8).standard_normal((1, T, d)).astype(
        np.float32)
    C = tmoe.capacity(T, k, E, 0.5)
    assert C == jmoe.capacity(T, k, E, 0.5) == 16
    with routes_seen() as seen:
        ty, taux = tmoe.moe_block(tp, torch.from_numpy(x),
                                  experts_per_token=k, capacity_factor=0.5)
    assert_routes_match_jax(seen)
    counts = np.bincount(seen[0][3].reshape(-1), minlength=E)
    assert (counts > C).any() and counts.sum() == T * k
    jy, jaux = jmoe.moe_block(jp, jnp.asarray(x), experts_per_token=k,
                              capacity_factor=0.5)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    full, _ = tmoe.moe_block(tp, torch.from_numpy(x), experts_per_token=k,
                             capacity_factor=100.0)
    dropped = (ty - full).abs().amax(-1)[0] > 1e-6
    assert 0 < int(dropped.sum()) < T

    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_block(tp, tx, experts_per_token=k, capacity_factor=0.5)
    (gx,) = torch.autograd.grad(y.sum() + aux, [tx])

    def jloss(xx):
        jy, jaux = jmoe.moe_block(jp, xx, experts_per_token=k,
                                  capacity_factor=0.5)
        return jnp.sum(jy) + jaux
    jgx = _np(jax.grad(jloss)(jnp.asarray(x)))
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=0,
                               atol=1e-4 * np.abs(jgx).max())


@pytest.mark.parametrize("k", [1, 2])
def test_zero_rows_tie_like_jax(k):
    """A zero input row gives uniform router probabilities, a tie of all
    experts: both packages choose experts 0 ... k - 1 (``jax.lax.top_k``
    takes the lowest index first, the port a stable descending sort)."""
    d, f, E = 16, 24, 4
    jp, tp = _both(_block_params(11, d, f, E, True))
    x = np.random.default_rng(12).standard_normal((1, 6, d)).astype(
        np.float32)
    x[0, [1, 4]] = 0.0
    with routes_seen() as seen:
        ty, _ = tmoe.moe_block(tp, torch.from_numpy(x), experts_per_token=k)
    assert_routes_match_jax(seen)
    idx = seen[0][3]
    for row in (1, 4):
        assert idx[row].tolist() == list(range(k))
    jy, _ = jmoe.moe_block(jp, jnp.asarray(x), experts_per_token=k)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-5)


def test_bf16_moe_block_matches_jax():
    """The block in bf16 with its fp32 router, as ``init_moe`` keeps it:
    the output within 4 bf16 steps of its largest entry, the aux loss
    within 1e-5, the routing alike."""
    d, f, E, k = 32, 48, 4, 2
    p = _block_params(21, d, f, E, True)
    x = np.random.default_rng(22).standard_normal((2, 12, d)).astype(
        np.float32)

    def cast(path, a):
        return a if path[-1] == "router" else a.astype(jnp.bfloat16)
    jp = bridge.unflatten_tree({k_: jnp.asarray(cast(k_, v))
                                for k_, v in bridge.tree_leaves(p)})
    tp = bridge.unflatten_tree({
        k_: torch.from_numpy(v).to(torch.float32 if k_[-1] == "router"
                                   else torch.bfloat16)
        for k_, v in bridge.tree_leaves(p)})
    jy, jaux = jmoe.moe_block(jp, jnp.asarray(x, jnp.bfloat16),
                              experts_per_token=k)
    with routes_seen() as seen:
        ty, taux = tmoe.moe_block(tp, torch.from_numpy(x).to(torch.bfloat16),
                                  experts_per_token=k)
    assert_routes_match_jax(seen)
    assert ty.dtype == torch.bfloat16
    want = _np(jy)
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max())
    assert abs(taux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_bf16_round_keeps_the_router_fp32(monkeypatch):
    """A bf16 MoE model mixes dtypes (the fp32 router): one online_sgd
    call per dtype group per inner step and one meta_update per group,
    the router back in fp32, every other leaf in bf16, finite losses."""
    calls = {"online_sgd": [], "meta_update": []}
    for name in calls:
        real = getattr(ops, name)

        def spy(p, *a, _real=real, _name=name):
            calls[_name].append(p.dtype)
            return _real(p, *a)
        monkeypatch.setattr(ops, name, spy)
    tm = build_model(dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                                         dtype="bfloat16"))
    phi = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = _tb(_batch(tm.cfg.vocab_size, (2, 2, 16), 5))
    new_phi, metrics = make_meta_train_step(tm, beta=BETA)(phi, batch, ALPHA)
    assert calls["online_sgd"] == [torch.bfloat16, torch.float32] * 2
    assert calls["meta_update"] == [torch.bfloat16, torch.float32]
    for path, leaf in bridge.tree_leaves(new_phi):
        assert leaf.dtype == (torch.float32 if path[-1] == "router"
                              else torch.bfloat16), path
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_moe_shapes_match_init_moe():
    """The port's leaf shapes and dtypes are the JAX ``init_moe``'s; the
    router stays fp32 in a bf16 block."""
    want = jax.eval_shape(lambda key: jmoe.init_moe(
        key, 32, 48, 8, True, jnp.bfloat16), jax.random.PRNGKey(0))
    got = tmoe.moe_shapes(32, 48, 8, True, torch.bfloat16)
    w = bridge.flatten_tree(jax.tree.map(lambda a: (a.shape, a.dtype.name),
                                         want))
    g = {k: (s, str(dt).split(".")[1])
         for k, (s, dt) in bridge.tree_leaves(got)}
    assert g == w
    assert g[("router",)][1] == "float32"


def test_llama4_pattern():
    """maverick's layer pattern as the JAX package's ``layer_specs``:
    ``moe_every=2`` alternates dense and MoE blocks, ``global_attn_every
    =4`` makes every 4th attention layer global (window 0); at 16
    layers the period is those 4 blocks, stacked 4 times."""
    cfg = dataclasses.replace(get_arch("llama4-maverick-400b-a17b"),
                              num_layers=16)
    jcfg = dataclasses.replace(jget_arch("llama4-maverick-400b-a17b"),
                               num_layers=16)
    specs = ttransformer.layer_specs(cfg)
    assert specs == jtransformer.layer_specs(jcfg)
    assert [k for k, _ in specs[:4]] == ["attn", "moe", "attn", "moe"]
    assert [w for _, w in specs[:4]] == [8192, 8192, 8192, 0]
    assert ttransformer.find_period(specs) == 4
    m = build_model(cfg)
    assert m.use_scan and m.jax_layout == 4
    shapes = m.param_shapes()["layers"]
    assert "mlp" in shapes[0] and "moe" in shapes[1]
    assert shapes[1]["moe"]["shared"]["w_gate"][0] == (5120, 8192)
    assert shapes[1]["moe"]["w_gate"][0] == (128, 5120, 8192)


# -- the models --------------------------------------------------------------

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


#: name -> (arch, overrides of .reduced(), sequence length)
CASES = {
    "mixtral_2l": ("mixtral-8x22b", {}, 16),
    "mixtral_16l": ("mixtral-8x22b", {"num_layers": 16}, 16),
    "maverick_16l": ("llama4-maverick-400b-a17b",
                     {"num_layers": 16, "moe_every": 2}, 16),
}


class LmCase:
    """One config: the JAX model, its init and results, computed once;
    the port's model and the init carried over."""

    def __init__(self, arch, over, S):
        self.jm = jbuild(dataclasses.replace(jget_arch(arch).reduced(),
                                             **over))
        self.tm = build_model(dataclasses.replace(get_arch(arch).reduced(),
                                                  **over))
        cfg = self.jm.cfg
        self.bf16 = cfg.dtype == "bfloat16"
        self.phi = self.jm.init(jax.random.PRNGKey(0))
        self.batch = _batch(cfg.vocab_size, (2, S), 1)
        self.meta_batch = _batch(cfg.vocab_size, (2, 2, S), 2)
        self.decode_tokens = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, DECODE_STEPS))
        loss, grads = jax.jit(jax.value_and_grad(self.jm.loss_fn))(
            self.phi, _jb(self.batch))
        logits = jax.jit(self.jm.prefill_fn)(self.phi, _jb(self.batch))
        new_phi, metrics = jax.jit(jmeta_step(self.jm, beta=BETA))(
            self.phi, _jb(self.meta_batch), jnp.float32(ALPHA))
        decode = jax.jit(self.jm.decode_fn)
        cache, steps = self.jm.init_cache(2, DECODE_STEPS), []
        for t in range(DECODE_STEPS):
            lg, cache = decode(self.phi, {
                "tokens": jnp.asarray(self.decode_tokens[:, t:t + 1],
                                      jnp.int32),
                "cache": cache, "cache_len": jnp.int32(t)})
            steps.append(_np(lg))
        self.want = dict(
            loss=float(loss), logits=_np(logits),
            grads=bridge.flatten_tree(jax.tree.map(_np, grads)),
            new_phi=bridge.flatten_tree(jax.tree.map(_np, new_phi)),
            metrics={k: float(v) for k, v in metrics.items()},
            decode=steps, cache=cache)

    def port_params(self):
        return bridge.lm_params_from_jax(self.phi, self.tm.jax_layout, "cpu")

    def close(self, got, want):
        tol = BF16_RTOL if self.bf16 else 1e-5
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return LmCase(*CASES[request.param])


def check_loss_and_prefill(case):
    params = case.port_params()
    with torch.no_grad(), routes_seen() as seen:
        loss = case.tm.loss_fn(params, _tb(case.batch))
    logits = make_prefill_step(case.tm)(params, _tb(case.batch))
    if not case.bf16 and case.tm.cfg.family == "moe":
        assert_routes_match_jax(seen)
    want = case.want
    tol = (1e-3 if case.bf16 else 1e-5) * abs(want["loss"])
    assert abs(float(loss) - want["loss"]) <= tol
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 1, case.tm.cfg.vocab_size)
    case.close(logits.numpy(), want["logits"])


def check_gradients(case):
    """Each leaf's gradient within 1e-4 of its largest entry (4 bf16
    steps in bf16); the loss includes 0.01 times the summed aux loss."""
    leaves = {k: v.requires_grad_()
              for k, v in bridge.flatten_tree(case.port_params()).items()}
    loss = case.tm.loss_fn(bridge.unflatten_tree(leaves), _tb(case.batch))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    got = bridge.flatten_tree(bridge.lm_params_to_jax(
        bridge.unflatten_tree(grads), case.tm.jax_layout))
    want = case.want["grads"]
    assert set(got) == set(want)
    for path, g in want.items():
        top = float(np.abs(g).max())
        tol = (BF16_RTOL if case.bf16 else 1e-4) * top
        np.testing.assert_allclose(got[path], g, rtol=0, atol=tol,
                                   err_msg=str(path))


def check_meta_round(case):
    """One TinyReptile round (K = 2 streaming SGD steps, then the
    interpolation); each leaf back in its own dtype (the router fp32)."""
    step = make_meta_train_step(case.tm, beta=BETA)
    new_phi, metrics = step(case.port_params(), _tb(case.meta_batch), ALPHA)
    for path, leaf in bridge.tree_leaves(new_phi):
        want_dt = (torch.float32 if not case.bf16 or path[-1] in (
            "router", "dt_bias", "A_log", "D") else torch.bfloat16)
        assert leaf.dtype == want_dt, path
    for k, v in case.want["metrics"].items():
        assert abs(float(metrics[k]) - v) <= (
            1e-3 * abs(v) if case.bf16 else 1e-4), k
    got = bridge.flatten_tree(bridge.lm_params_to_jax(new_phi,
                                                      case.tm.jax_layout))
    for path, p in case.want["new_phi"].items():
        if case.bf16:
            np.testing.assert_allclose(got[path], p, rtol=BF16_RTOL,
                                       atol=2 ** -8, err_msg=str(path))
        else:
            np.testing.assert_allclose(got[path], p, rtol=1e-4, atol=1e-4,
                                       err_msg=str(path))


def check_decode_and_round_trips(case):
    """DECODE_STEPS decode steps at batch 2 from the JAX init: each
    step's logits; the final cache carried to the JAX layout equals the
    JAX cache, and back; the params' round trip is exact."""
    tm = case.tm
    params = case.port_params()
    cache = tm.init_cache(2, DECODE_STEPS, device="cpu")
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            lg, cache = tm.decode_fn(params, {
                "tokens": torch.from_numpy(case.decode_tokens[:, t:t + 1]),
                "cache": cache, "cache_len": t})
            case.close(lg.numpy(), case.want["decode"][t])
    got = bridge.flatten_tree(bridge.lm_cache_to_jax(cache, tm.jax_layout))
    want = bridge.flatten_tree(jax.tree.map(_np, case.want["cache"]))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        case.close(got[path], w)
    back = bridge.lm_cache_from_jax(case.want["cache"], tm.jax_layout,
                                    "cpu")
    for (pa, a), (pb, b) in zip(bridge.tree_leaves(back),
                                bridge.tree_leaves(cache)):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype
    round_trip = bridge.flatten_tree(bridge.lm_params_to_jax(
        params, tm.jax_layout))
    phi = bridge.flatten_tree(jax.tree.map(_np, case.phi))
    assert set(round_trip) == set(phi)
    for path, w in phi.items():
        np.testing.assert_array_equal(round_trip[path], w, err_msg=str(path))


def test_loss_and_prefill_match_jax(case):
    check_loss_and_prefill(case)


def test_every_gradient_matches_jax(case):
    check_gradients(case)


def test_meta_train_step_matches_jax(case):
    check_meta_round(case)


def test_decode_and_round_trips_match_jax(case):
    check_decode_and_round_trips(case)


# -- the launchers -----------------------------------------------------------

def test_engine_moe_row_matches_the_jax_launcher(capsys):
    """``--strategy fedsgd --arch moe`` (the reduced mixtral on the round
    engine; FedSGD compiles fastest in the JAX package, and ``chip_smoke.
    py`` runs Reptile) from the JAX package's init: the row's keys,
    comm_mb exact, query_loss within 1e-4."""
    from repro.launch import train as jtrain
    argv = ["--strategy", "fedsgd", "--arch", "moe", "--rounds", "2",
            "--clients", "2", "--batch", "2", "--seq", "16"]
    jargs = jtrain.parse_args(argv)
    jtrain.run_engine_strategy(jargs)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jm = jbuild(jget_arch("mixtral-8x22b").reduced())
    init = bridge.lm_params_from_jax(jm.init(jax.random.PRNGKey(jargs.seed)),
                                     None, "cpu")
    got, out = train.run_engine_strategy(
        train.parse_args(argv + ["--device", "cpu"]), init_params=init)
    assert set(want) <= set(got) and got["arch"] == want["arch"] == "moe"
    for key in ("strategy", "rounds", "clients"):
        assert got[key] == want[key], key
    assert got["comm_mb"] == want["comm_mb"]
    assert abs(got["query_loss"] - want["query_loss"]) <= 1e-4 + 1e-12


def test_lm_launcher_rows_match_the_jax_launcher(monkeypatch):
    """2 rounds of the tinyreptile LM launcher on the reduced maverick
    from the JAX init: every row's keys and client, alpha and comm_mb
    exact; the losses within 1e-4."""
    from repro.launch import train as jtrain
    argv = ["--arch", "llama4-maverick-400b-a17b", "--reduced", "--rounds",
            "2", "--seq", "16", "--batch", "4", "--k-inner", "2"]
    init = jbuild(jget_arch("llama4-maverick-400b-a17b").reduced()).init(
        jax.random.PRNGKey(0))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    want = [json.loads(line) for line in out.getvalue().splitlines()]
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
    assert summary["kernel_launches"] == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("arch", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b", "moe"])
def test_launchers_take_the_moe_family(arch):
    args = train.parse_args(["--arch", arch])
    assert args.arch in ALL_ARCHS
    assert train.parse_args(["--strategy", "fedavg", "--arch",
                             "moe"]).arch == "moe"
    if arch != "moe":
        assert arch in serve.decode_archs()
        assert serve.parse_args(["--arch", arch]).mode == "decode"
