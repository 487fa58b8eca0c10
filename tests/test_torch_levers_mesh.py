"""The mesh levers' routes (``runtime/flags.py``: ``gqa_flat``, ``seqpar``,
``moe2d``, ``moelocal``) on the production mesh's meta, prefill, decode
and joint steps (``runtime/steps.py``), four gloo ranks on the CPU on a
(2, 2) ``("data", "model")`` mesh, against the JAX package's steps jitted
on four forced host devices under the same ``feature_scope``.

One module fixture starts, once for every case, the four ranks
(``runtime/ranks.py``), the JAX side in three subprocesses under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, and the dry run's
fake (2, 2) group in another (``launch/dryrun.py``). Every side lowers
``FSDP_THRESHOLD_BYTES`` to 100,000 bytes, as
``tests/test_torch_production_step.py`` does. The configs are reduced, 4
layers, fp32, from the port's init of seed 0 (carried to the JAX side in
its layout); each case runs where its lever acts:

- ``gqa_flat``: the reduced tinyllama with one kv head, which 2 model
  ranks do not split (``wk``/``wv`` split on head_dim, ``wq``/``wo`` on
  heads): meta, prefill, joint (the decode never reads it);
- ``seqpar``: the reduced tinyllama, 24 positions over 2 model ranks:
  meta, prefill, joint;
- ``moe2d``: the reduced mixtral with 3 experts, which 2 model ranks do
  not split: every step;
- ``moe2d`` and ``moelocal`` both on: the groups dispatch alone and the
  experts are gathered, as with ``moelocal`` alone (prefill);
- ``moelocal``: the reduced mixtral, every step. In the meta case data
  rank 0's rows (its token group) are one repeated token, so that group
  sends all its choices to two experts and drops a third of them at its
  capacity of 32, where the whole batch's capacity of 64 keeps more; the
  joint case of batch 3 has B S divisible by the 2 groups and B not, so
  every rank holds both groups, which cross a row.

Held, for each case:

- the step's result (phi and the losses, the logits, the decode cache)
  within 1e-3 of the JAX step under the same lever;
- ``gqa_flat``, ``seqpar`` and ``moe2d`` within 1e-5 of the port's
  single-rank step, since they compute the same function; ``moelocal``
  within 1e-5 of a single-rank step whose MoE block runs ``moe_block``
  once per JAX chunk, and (the drop case) apart from the levers-off step;
- every rank the same, bit for bit;
- the route taken, by the counters: no MoE row gathered under
  ``moelocal``; no expert leaf gathered under ``moe2d``; ``wq`` and
  ``wo`` never gathered over ``model`` and scores for H / 2 heads under
  ``gqa_flat``; scores for S / 2 query rows and one row gather a layer
  under ``seqpar``; each against the same step with the lever off;
- the fake (2, 2) trace's collectives, kernel records and FLOPs equal
  to every rank's, where the lever is on (the meta, prefill and decode
  steps: the joint step's route is the meta step's inner step);
- at full width, tinyllama-1.1b traced as rank 0 of the fake 16 x 16
  group: scores for 2 of 32 heads under ``gqa_flat``, for 32 of 512
  query rows under ``seqpar``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

from repro_torch import bridge  # noqa: E402
from repro_torch.runtime.ranks import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 100_000
BETA, ALPHA, LR = 0.02, 0.5, 0.05
K, S = 1, 24                       # meta: K microbatches of S tokens
SEQ, START, STEPS = 32, 13, 3      # decode: cache, its fill, the steps
TOL = 1e-3                         # the 2-D route's (test_torch_mesh2d_engine)
ONE_RANK_TOL = 1e-5
MESH = ((2, 2), ("data", "model"))
GROUPS = 2                         # moelocal's groups: the data ranks
REPEATED = 7                       # the drop case's token
# name -> (arch, overrides)
CONFIGS = {"tinyllama_kv1": ("tinyllama-1.1b", {"num_kv_heads": 1}),
           "tinyllama": ("tinyllama-1.1b", {}),
           "mixtral_e3": ("mixtral-8x22b", {"num_experts": 3}),
           "mixtral": ("mixtral-8x22b", {})}
# name -> (config, lever, step, rows: mb for meta, B otherwise)
CASES = {
    "gqa_flat_meta": ("tinyllama_kv1", "gqa_flat", "meta", 4),
    "gqa_flat_prefill": ("tinyllama_kv1", "gqa_flat", "prefill", 4),
    "gqa_flat_joint": ("tinyllama_kv1", "gqa_flat", "joint", 4),
    "seqpar_meta": ("tinyllama", "seqpar", "meta", 4),
    "seqpar_prefill": ("tinyllama", "seqpar", "prefill", 4),
    "seqpar_joint": ("tinyllama", "seqpar", "joint", 4),
    "moe2d_meta": ("mixtral_e3", "moe2d", "meta", 4),
    "moe2d_prefill": ("mixtral_e3", "moe2d", "prefill", 4),
    "moe2d_decode": ("mixtral_e3", "moe2d", "decode", 4),
    "moe2d_joint": ("mixtral_e3", "moe2d", "joint", 4),
    "moelocal_meta": ("mixtral", "moelocal", "meta", 4),
    "moelocal_prefill": ("mixtral", "moelocal", "prefill", 4),
    "moelocal_decode": ("mixtral", "moelocal", "decode", 2),
    "moelocal_joint": ("mixtral", "moelocal", "joint", 4),
    "moelocal_joint_b3": ("mixtral", "moelocal", "joint", 3),
    # both MoE levers: the groups dispatch alone, the experts gathered
    "moe2d_moelocal_prefill": ("mixtral_e3", "moe2d+moelocal", "prefill", 4),
}
DROP_CASE = "moelocal_meta"
FULL_WIDTH_SEQ = 512               # the full-width trace's tokens a row
SAME_FUNCTION = ("gqa_flat", "seqpar", "moe2d")
TRACED = tuple(n for n, c in CASES.items() if c[2] != "joint")
# a case of each lever that also runs with the lever off: the counters'
# baseline, and the drop case's levers-off result
OFF_CASES = ("gqa_flat_prefill", "seqpar_prefill", "moe2d_prefill",
             DROP_CASE)


def _levers(lever):
    """A case's levers as ``feature_scope`` takes them."""
    return {name: True for name in lever.split("+")}


def _cfg(get_arch, config):
    arch, over = CONFIGS[config]
    return dataclasses.replace(get_arch(arch).reduced(), num_layers=4,
                               dtype="float32", **over)


def _inputs(name, vocab):
    """The case's batch (NumPy, from a seed): meta (K, mb, S) tokens and
    labels, prefill (B, S) tokens, joint (B, S) tokens and labels, decode
    (STEPS, B, 1) tokens."""
    _, _, step, rows = CASES[name]
    r = np.random.default_rng(3)
    if step == "decode":
        return r.integers(0, vocab, (STEPS, rows, 1)).astype(np.int32)
    shape = (K, rows, S) if step == "meta" else (rows, S)
    tok = r.integers(0, vocab, shape).astype(np.int32)
    if name == DROP_CASE:                 # group 0: data rank 0's rows
        tok[:, :rows // GROUPS] = REPEATED
    if step == "prefill":
        return {"tokens": tok}
    lab = np.concatenate([tok[..., 1:], np.full(shape[:-1] + (1,), -1,
                                                np.int32)], axis=-1)
    return {"tokens": tok, "labels": lab}


def _seeded_cache(model, B):
    """A whole decode cache, K and V drawn below START."""
    cache = model.init_cache(B, SEQ, device="cpu")
    gen = torch.Generator().manual_seed(11)
    for _, leaf in bridge.tree_leaves(cache):
        leaf[:, :START].copy_(torch.randn(leaf[:, :START].shape,
                                          generator=gen))
    return cache


def _flat(tree):
    return {"/".join(map(str, k)): np.asarray(v, np.float32)
            for k, v in bridge.flatten_tree(tree).items()}


# the JAX side's three processes, the cases shared by their compile time
JAX_SPLIT = (("gqa_flat_meta", "moelocal_meta", "seqpar_prefill",
              "moe2d_prefill", "moelocal_prefill"),
             ("moe2d_meta", "seqpar_meta", "gqa_flat_joint", "seqpar_joint",
              "gqa_flat_prefill", "moe2d_moelocal_prefill"),
             ("moe2d_joint", "moelocal_joint", "moelocal_joint_b3",
              "moe2d_decode", "moelocal_decode"))


def jax_side(in_path, out_path, names):
    """The cases ``names`` through the JAX package's step on four forced
    host devices, each under its lever."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro import optim
    from repro.configs import get_arch
    from repro.configs.shapes import InputShape
    from repro.launch.specs import decode_batch_specs
    from repro.models import build_model
    from repro.runtime import sharding as jsh
    from repro.runtime.flags import feature_scope
    from repro.runtime.shardctx import mesh_context
    from repro.runtime.steps import (make_decode_step, make_joint_train_step,
                                     make_meta_train_step, make_prefill_step)

    jsh.FSDP_THRESHOLD_BYTES = THRESHOLD
    with open(in_path, "rb") as f:
        inits, inputs = pickle.load(f)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    res = {}
    for name in names:
        config, lever, step, rows = CASES[name]
        model = build_model(_cfg(get_arch, config))
        phi = jax.tree.map(jnp.asarray, inits[config])
        batch = inputs[name]["batch"]

        def put(b, leading=0):
            return {k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, jsh.token_spec(mesh, rows, extra_dims=v.ndim - 1 -
                                     leading, leading=leading)))
                    for k, v in b.items()}

        with mesh_context(mesh), feature_scope(**_levers(lever)):
            p = jax.device_put(phi, jsh.param_shardings(phi, mesh))
            if step == "meta":
                new, m = jax.jit(make_meta_train_step(
                    model, beta=BETA, alpha=ALPHA))(p, put(batch, 1),
                                                    jnp.float32(ALPHA))
                out = (_flat(jax.tree.map(np.asarray, new)),
                       {k: float(v) for k, v in m.items()})
            elif step == "prefill":
                out = np.asarray(jax.jit(make_prefill_step(model))(
                    p, put(batch)))
            elif step == "joint":
                opt = optim.sgd()
                new, _, _, m = jax.jit(make_joint_train_step(
                    model, opt, optim.constant(LR)))(
                    p, opt.init(phi), jnp.int32(0), put(batch))
                out = (_flat(jax.tree.map(np.asarray, new)),
                       {"loss": float(m["loss"])})
            else:
                specs = decode_batch_specs(model.cfg, InputShape(
                    "t", SEQ, rows, "decode"), mesh)
                held = jax.tree.map(lambda s: s.sharding, specs["cache"])
                cache = jax.device_put(jax.tree.map(
                    jnp.asarray, inputs[name]["cache"]), held)
                fn, logits = jax.jit(make_decode_step(model)), []
                for t in range(STEPS):
                    lg, cache = fn(p, {"tokens": put({"t": batch[t]})["t"],
                                       "cache": cache,
                                       "cache_len": jnp.int32(START + t)})
                    cache = jax.device_put(cache, held)
                    logits.append(np.asarray(lg))
                out = (np.stack(logits),
                       _flat(jax.tree.map(np.asarray, cache)))
        res[name] = out
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _cell(name):
    """(InputShape, k_inner, kind) of a case for ``dryrun``."""
    from repro_torch.configs import InputShape
    _, _, step, rows = CASES[name]
    return {"meta": (InputShape("meta", S, K * rows, "train"), K, "meta"),
            "prefill": (InputShape("prefill", S, rows, "prefill"), None,
                        "meta"),
            "decode": (InputShape("decode", SEQ, rows, "decode"), None,
                       "meta")}[step]


def fake_side(out_path):
    """Each ``TRACED`` case's step traced on a fake (2, 2) group under its
    lever: its collectives, kernel records and FLOPs. Then tinyllama-1.1b
    at full width traced as rank 0 of the fake 16 x 16 production group
    (a meta step of 16 rows of ``FULL_WIDTH_SEQ`` tokens, ``meta``
    tensors) under ``gqa_flat`` and ``seqpar``: the q of each attention
    call."""
    from repro_torch.configs import InputShape, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.flags import feature_scope
    threshold = sh.FSDP_THRESHOLD_BYTES
    sh.FSDP_THRESHOLD_BYTES = THRESHOLD
    res = {}
    with D.fake_group(4):
        mesh = sh.make_mesh(*MESH, "cpu")
        for name in TRACED:
            config, lever, _, _ = CASES[name]
            shape, k, kind = _cell(name)
            with feature_scope(**_levers(lever)):
                t = D.trace(_cfg(get_arch, config), shape, mesh, kind, k)
            res[name] = {"flops": t["flops"], "kernels": t["kernels"],
                         "calls": t["calls"]}
    sh.FSDP_THRESHOLD_BYTES = threshold
    res["full_width"] = {}
    with D.fake_group(256), _Recorder() as rec:
        mesh = make_production_mesh(multi_pod=False, device="cpu")
        for lever in ("gqa_flat", "seqpar"):
            rec.queries.clear()
            with feature_scope(**{lever: True}):
                D.trace(get_arch("tinyllama-1.1b"), InputShape(
                    "t", FULL_WIDTH_SEQ, 16, "train"), mesh, "meta", 1)
            res["full_width"][lever] = set(rec.queries)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


class _Recorder:
    """What a step gathers and attends: each gather's output shape, its
    group and kind (``sharding._gather_along``), and each
    ``flash_attention`` call's q shape."""

    def __init__(self):
        from repro_torch.models import attention as attn_lib
        from repro_torch.runtime import sharding as sh
        self.gathers, self.queries = [], []
        self._sh, self._attn = sh, attn_lib
        self._gather, self._flash = sh._gather_along, attn_lib.flash_attention

    def __enter__(self):
        def gather(local, d, group, parts, index, calls, kind="gather"):
            out = self._gather(local, d, group, parts, index, calls, kind)
            self.gathers.append((tuple(out.shape), "model" if calls is
                                 self._sh.MODEL_CALLS else "data", kind))
            return out

        def flash(q, k, v, **kw):
            self.queries.append(tuple(q.shape))
            return self._flash(q, k, v, **kw)
        self._sh._gather_along, self._attn.flash_attention = gather, flash
        return self

    def __exit__(self, *exc):
        self._sh._gather_along = self._gather
        self._attn.flash_attention = self._flash


def _run_case(name, model, init, inputs, mesh, counted):
    """One case's step on this rank's shards, its first call recorded
    (collectives, gathers, queries; with ``counted`` also the kernel
    records and FLOPs, as the dry run's trace counts them). Returns its
    result made whole and the counts."""
    from repro_torch import optim
    from repro_torch.kernels.costs import CostMode
    from repro_torch.launch import dryrun as D
    from repro_torch.runtime.steps import (batch_rows, make_decode_step,
                                           make_joint_train_step,
                                           make_meta_train_step,
                                           make_prefill_step)
    _, _, step, rows = CASES[name]
    layout = model.jax_layout
    batch = inputs["batch"]
    if step == "decode":
        fn = make_decode_step(model, mesh=mesh, batch_size=rows,
                              seq_len=SEQ)
    elif step == "meta":
        fn = make_meta_train_step(model, beta=BETA, alpha=ALPHA, mesh=mesh)
    elif step == "prefill":
        fn = make_prefill_step(model, mesh=mesh)
    else:
        opt = optim.sgd()
        fn = make_joint_train_step(model, opt, optim.constant(LR), mesh=mesh)
    local = bridge.lm_shards_from_jax(init, layout, fn.shards, "cpu")
    if step == "decode":
        cs = fn.cache_shards
        cache = bridge.lm_cache_shards_from_jax(inputs["cache"], layout, cs,
                                                "cpu")
        calls = [lambda t=t: fn(local, {
            "tokens": batch_rows({"t": torch.from_numpy(batch[t])}, mesh,
                                 leading=0)[0]["t"], "cache": cache,
            "cache_len": torch.tensor([START + t], dtype=torch.int32)})
            for t in range(STEPS)]
    else:
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        args = {"meta": (local, b, ALPHA), "prefill": (local, b),
                "joint": (local, optim.sgd().init(local), 0, b)}[step]
        calls = [lambda: fn(*args)]
    counts = None
    outs = []
    for i, call in enumerate(calls):
        if i:
            outs.append(call())
            continue
        before = D.collective_counters()
        with _Recorder() as rec, (CostMode() if counted else _Nothing()) as cm:
            outs.append(call())
        counts = {"calls": D.collectives_since(before),
                  "gathers": rec.gathers, "queries": rec.queries}
        if counted:
            counts["trace"] = {"flops": cm.flops, "kernels": cm.kernels,
                               "calls": counts["calls"]}
    if step == "meta":
        new, m = outs[0]
        res = (_flat(bridge.lm_params_to_jax(bridge.whole_tree(
            new, fn.shards), layout)), {k: float(v) for k, v in m.items()})
    elif step == "prefill":
        res = outs[0].numpy()
    elif step == "joint":
        new, _, _, m = outs[0]
        res = (_flat(bridge.lm_params_to_jax(bridge.whole_tree(
            new, fn.shards), layout)), {"loss": float(m["loss"])})
    else:
        res = (np.stack([o[0].numpy() for o in outs]),
               _flat(bridge.lm_cache_to_jax(bridge.whole_cache(
                   outs[-1][1], cs), layout)))
    return res, counts


class _Chunked:
    """``moe_block`` run once per JAX chunk (``GROUPS`` equal runs of the
    B S tokens, each with its capacity, the aux losses' mean), with the
    choices each chunk drops at its capacity."""

    def __init__(self):
        from repro_torch.models import moe as moe_lib
        self.moe, self.block = moe_lib, moe_lib.moe_block
        self.drops = []

    def __call__(self, params, x, *, experts_per_token, **kw):
        B, S_, d = x.shape
        T = B * S_
        if T % GROUPS:
            return self.block(params, x, experts_per_token=experts_per_token,
                              **kw)
        runs = x.reshape(GROUPS, T // GROUPS, 1, d)
        ys, auxes, drops = [], [], []
        for g in range(GROUPS):
            y, aux = self.block(params, runs[g],
                                experts_per_token=experts_per_token, **kw)
            ys.append(y)
            auxes.append(aux)
            _, _, idx = self.moe.route(params, runs[g].reshape(-1, d),
                                       experts_per_token)
            cap = self.moe.capacity(T // GROUPS, experts_per_token,
                                    params["w_gate"].shape[0])
            counts = torch.bincount(idx.reshape(-1),
                                    minlength=params["w_gate"].shape[0])
            drops.append(int((counts - cap).clamp(min=0).sum()))
        self.drops.append(drops)
        return torch.stack(ys).reshape(B, S_, d), torch.stack(auxes).mean()

    def __enter__(self):
        self.moe.moe_block = self
        return self

    def __exit__(self, *exc):
        self.moe.moe_block = self.block


def _one_rank(name, model, init, inputs):
    """The port's single-rank step of a case (no mesh: its lever is
    inert), ``moelocal``'s with ``moe_block`` run per JAX chunk; and that
    case's drops, chunk by chunk."""
    from repro_torch import optim
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_joint_train_step,
                                           make_meta_train_step,
                                           make_prefill_step)
    _, lever, step, _ = CASES[name]
    layout = model.jax_layout
    params = bridge.lm_params_from_jax(init, layout, "cpu")
    batch = inputs["batch"]
    chunked = _Chunked()
    with chunked if "moelocal" in lever else _Nothing():
        if step == "meta":
            new, m = make_meta_train_step(model, beta=BETA, alpha=ALPHA)(
                params, {k: torch.from_numpy(v) for k, v in batch.items()},
                ALPHA)
            res = (_flat(bridge.lm_params_to_jax(new, layout)),
                   {k: float(v) for k, v in m.items()})
        elif step == "prefill":
            res = make_prefill_step(model)(params, {
                "tokens": torch.from_numpy(batch["tokens"])}).numpy()
        elif step == "joint":
            opt = optim.sgd()
            new, _, _, m = make_joint_train_step(
                model, opt, optim.constant(LR))(
                params, opt.init(params), 0,
                {k: torch.from_numpy(v) for k, v in batch.items()})
            res = (_flat(bridge.lm_params_to_jax(new, layout)),
                   {"loss": float(m["loss"])})
        else:
            cache = bridge.lm_cache_from_jax(inputs["cache"], layout, "cpu")
            fn, logits = make_decode_step(model), []
            with torch.no_grad():
                for t in range(STEPS):
                    lg, cache = fn(params, {
                        "tokens": torch.from_numpy(batch[t]),
                        "cache": cache, "cache_len": START + t})
                    logits.append(lg.numpy())
            res = (np.stack(logits),
                   _flat(bridge.lm_cache_to_jax(cache, layout)))
    return res, chunked.drops


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _rank(rank, inits, inputs):
    """Every case on this rank under its lever (counted), each lever's
    meta case again with the lever off, and a quarter of the cases'
    single-rank references."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.flags import feature_scope

    sh.FSDP_THRESHOLD_BYTES = THRESHOLD
    mesh = sh.make_mesh(*MESH, "cpu")
    res = {"on": {}, "off": {}, "one_rank": {}}
    for i, (name, (config, lever, _, _)) in enumerate(CASES.items()):
        model = build_model(_cfg(get_arch, config))
        with feature_scope(**_levers(lever)):
            res["on"][name] = _run_case(name, model, inits[config],
                                        inputs[name], mesh, name in TRACED)
        if name in OFF_CASES:
            res["off"][name] = _run_case(name, model, inits[config],
                                         inputs[name], mesh, False)
        if i % 4 == rank:
            with feature_scope(**_levers(lever)):
                res["one_rank"][name] = _one_rank(name, model, inits[config],
                                                  inputs[name])
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    root = tmp_path_factory.mktemp("levers_mesh")
    # the port's init from a seed, in the JAX layout: both sides start
    # from it
    inits = {}
    for c in CONFIGS:
        model = build_model(_cfg(get_arch, c))
        inits[c] = bridge.lm_params_to_jax(
            model.init(torch.Generator().manual_seed(0), "cpu"),
            model.jax_layout)
    inputs = {}
    for name, (config, _, step, rows) in CASES.items():
        model = build_model(_cfg(get_arch, config))
        inputs[name] = {"batch": _inputs(name, model.cfg.vocab_size)}
        if step == "decode":
            inputs[name]["cache"] = bridge.lm_cache_to_jax(
                _seeded_cache(model, rows), model.jax_layout)
    in_path = str(root / "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump((inits, inputs), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    jax_outs = [str(root / f"jax{i}.pkl") for i in range(len(JAX_SPLIT))]
    fake_out = str(root / "fake.pkl")
    calls = [f"t.jax_side({in_path!r}, {out!r}, {names!r})"
             for out, names in zip(jax_outs, JAX_SPLIT)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_levers_mesh as t; {call}"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for call in calls + [f"t.fake_side({fake_out!r})"]]
    try:
        ranks = run_ranks(_rank, 4, str(root / "ranks"), inits, inputs,
                          device="cpu", timeout=600)
        for proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            proc.kill()
    want = {}
    for out in jax_outs:
        with open(out, "rb") as f:
            want.update(pickle.load(f))
    with open(fake_out, "rb") as f:
        traced = pickle.load(f)
    one_rank = {}
    for r in ranks:
        one_rank.update(r["one_rank"])
    return {"ranks": ranks, "jax": want, "fake": traced,
            "one_rank": one_rank}


def _close(got, want, tol, name):
    """Two results of a case's step: (phi, losses), logits, or (logits,
    cache); each entry within ``tol`` of the largest entry of its leaf."""
    if isinstance(want, np.ndarray):
        got, want = {"logits": got}, {"logits": want}
    elif isinstance(want[1], dict) and not isinstance(
            next(iter(want[1].values())), float):
        got, want = ({"logits": got[0], **got[1]},
                     {"logits": want[0], **want[1]})
    else:
        for k, v in want[1].items():
            assert abs(got[1][k] - v) <= tol * max(1.0, abs(v)), (name, k)
        got, want = got[0], want[0]
    assert set(got) == set(want), name
    for k, v in want.items():
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol * scale,
                                   err_msg=f"{name} {k}")


def _own_rows(name, want):
    """Rank 0's rows of a whole result's logits (data rank 0's half of
    the batch where the data ranks split it), the rest as it is."""
    _, _, step, rows = CASES[name]
    if step not in ("prefill", "decode") or rows % GROUPS:
        return want
    if step == "prefill":
        return want[:rows // GROUPS]
    return (want[0][:, :rows // GROUPS], want[1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_lever_matches_the_jax_step(runs, name):
    _close(runs["ranks"][0]["on"][name][0],
           _own_rows(name, runs["jax"][name]), TOL, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lever_matches_the_single_rank_function(runs, name):
    """``gqa_flat``, ``seqpar`` and ``moe2d`` compute the single-rank
    step's function; ``moelocal`` the single-rank step with its MoE block
    run per JAX chunk."""
    want, _ = runs["one_rank"][name]
    _close(runs["ranks"][0]["on"][name][0], _own_rows(name, want),
           ONE_RANK_TOL, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_holds_the_same_result(runs, name):
    first = runs["ranks"][0]["on"][name][0]
    for r in runs["ranks"][1:]:
        got = r["on"][name][0]
        if isinstance(first, np.ndarray):
            continue                       # each rank's rows of logits
        whole = first[1] if isinstance(first[1], dict) else {}
        for k, v in (first[0] if isinstance(first[0], dict) else {}).items():
            np.testing.assert_array_equal(got[0][k], v)
        for k, v in whole.items():
            np.testing.assert_array_equal(got[1][k], v)


def test_moelocal_changes_the_function_where_a_group_drops(runs):
    """The drop case: data rank 0's group drops choices at its capacity
    in every layer (the single-rank reference counts them per chunk),
    and the step lands apart from the levers-off step."""
    _, drops = runs["one_rank"][DROP_CASE]
    assert drops and all(d[0] > 0 for d in drops), drops
    on, _ = runs["ranks"][0]["on"][DROP_CASE]
    off, _ = runs["ranks"][0]["off"][DROP_CASE]
    gap = max(float(np.abs(on[0][k] - off[0][k]).max()) for k in on[0])
    assert gap > 10 * TOL, gap


def _counts(runs, name, side="on"):
    return [r[side][name][1] for r in runs["ranks"]]


@pytest.mark.parametrize("name", [n for n in CASES
                                  if "moelocal" in CASES[n][1]
                                  and CASES[n][3] % GROUPS == 0])
def test_moelocal_gathers_no_rows(runs, name):
    """No MoE row moves; with ``moe2d`` on too the experts are gathered
    (the groups' route)."""
    for c in _counts(runs, name):
        assert not any(kind == "rows" for _, _, kind in c["gathers"]), name
        assert c["calls"]["data"]["rows"] == 0
        if "moe2d" in CASES[name][1]:
            assert any(_expert(s) for s, _, k in c["gathers"]
                       if k == "gather")
    if name in OFF_CASES:
        for c in _counts(runs, name, "off"):
            assert c["calls"]["data"]["rows"] > 0


def _expert(shape):
    return len(shape) == 3 and shape[0] == 3   # mixtral_e3's (E, ., .)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][1] == "moe2d"])
def test_moe2d_gathers_no_expert_leaf(runs, name):
    """Only the experts' (E, C, d) activations move: no gather of an
    expert leaf, over either group; the lever off gathers them."""
    for c in _counts(runs, name):
        leaves = [g for g in c["gathers"] if g[2] == "gather"]
        assert leaves and not any(_expert(s) for s, _, _ in leaves), name
        assert any(_expert(s) and kind == "activation"
                   for s, _, kind in c["gathers"])
        assert c["calls"]["data"]["activation"] > 0
    if name in OFF_CASES:
        for c in _counts(runs, name, "off"):
            assert any(_expert(s) for s, _, k in c["gathers"]
                       if k == "gather")


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][1] == "gqa_flat"])
def test_gqa_flat_keeps_wq_wo_and_attends_its_heads(runs, name):
    from repro_torch.configs import get_arch
    cfg = _cfg(get_arch, "tinyllama_kv1")
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    whole = {(d, H, hd), (H, hd, d)}          # wq, wo gathered over model
    for c in _counts(runs, name):
        assert c["queries"] and all(q[2] == H // 2 for q in c["queries"])
        assert not any(s in whole for s, group, k in c["gathers"]
                       if group == "model")
    if name in OFF_CASES:
        for c in _counts(runs, name, "off"):
            assert all(q[2] == H for q in c["queries"])
            assert any(s in whole for s, group, _ in c["gathers"]
                       if group == "model")


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][1] == "seqpar"])
def test_seqpar_attends_its_rows_and_gathers_them(runs, name):
    from repro_torch.configs import get_arch
    cfg = _cfg(get_arch, "tinyllama")
    for c in _counts(runs, name):
        assert c["queries"] and all(q[1] == S // 2 and q[2] == cfg.num_heads
                                    for q in c["queries"])
        rows = [g for g in c["gathers"] if g[2] == "rows"]
        assert rows and all(g[1] == "model" and g[0][1] == S for g in rows)
        if CASES[name][2] == "prefill":      # one row gather a layer
            assert len(rows) == cfg.num_layers
    if name in OFF_CASES:
        for c in _counts(runs, name, "off"):
            assert all(q[1] == S for q in c["queries"])
            assert c["calls"]["model"]["rows"] == 0


@pytest.mark.parametrize("name", TRACED)
def test_trace_counts_what_four_real_ranks_count(runs, name):
    want = runs["fake"][name]
    assert want["flops"] > 0
    for rank, c in enumerate(_counts(runs, name)):
        assert c["trace"] == want, (name, rank)


def test_full_width_ranks_attend_their_heads_or_rows(runs):
    """tinyllama-1.1b on the 16 x 16 production mesh (32 heads, 4 kv heads,
    which 16 model ranks do not split): under ``gqa_flat`` each attention
    call of rank 0 takes 2 of the 32 heads, under ``seqpar`` 512 / 16
    query rows of all 32 heads."""
    from repro_torch.configs import get_arch
    cfg = get_arch("tinyllama-1.1b")
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    full = runs["fake"]["full_width"]
    assert full["gqa_flat"] == {(1, FULL_WIDTH_SEQ, H // 16, hd)}
    assert full["seqpar"] == {(1, FULL_WIDTH_SEQ // 16, H, hd)}
