"""The production prefill, decode and joint steps,
``runtime/steps.py::make_prefill_step(model, mesh=)``,
``make_decode_step(model, mesh=, batch_size=, seq_len=)`` and
``make_joint_train_step(model, adamw(), schedule, mesh=)`` on a
``("data", "model")`` or ``("pod", "data", "model")`` ``ProcessMesh`` of
four gloo ranks on the CPU, against the JAX package's steps jitted on
four forced host devices (params placed by its ``param_shardings``, the
cache by ``decode_batch_specs``' shardings, the batch by ``token_spec``)
and against the port's own single-rank steps.

One module fixture starts the four ranks once (``runtime/ranks.py``) and,
at the same time, the JAX side in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``. Both sides lower
``FSDP_THRESHOLD_BYTES`` to 100,000 bytes (as
``tests/test_torch_production_step.py`` does), so that the reduced
leaves split on ``data`` too. Every case is fp32 at 4 layers (the JAX
package stacks them), from the JAX package's init:

- tinyllama on (2, 2) with batch 4: the batch splits on ``data``, the
  KV cache's sequence on ``model``;
- tinyllama with batch 1: the sequence splits over ``("data",
  "model")``, merged one axis at a time;
- tinyllama on (2, 1, 2) ``("pod", "data", "model")``;
- mixtral (MoE: the experts dispatch the whole batch's tokens);
- zamba2 (hybrid: the Mamba2 ``ssm`` state split on heads, ``ssd_scan``
  in its prefill, the shared block's cache at each application);
- whisper-tiny (the cross cache split on its encoder tokens);
- starcoder2 under ``ringkv`` with its window cut to 16, a ring of 16
  rows split over ``model``.

Decode runs from a seeded cache (K and V drawn up to position 13, and
the Mamba2 states and the cross cache) over 6 steps, 13 ... 18, across
the slice boundary at 16 (and the ring's wrap), the cursor an int at
even steps and an int32 tensor at odd ones. Held:

- each step's logits and the whole cache at the end within
  ``ONE_RANK_TOL`` (1e-5) of the largest entry against the port's
  single-rank step: the slices' merge is not bit-equal to one call over
  the whole cache (``models/attention.py::merge_partials``);
- the same within ``TOL`` (1e-3), the 2-D route's tolerance
  (``tests/test_torch_mesh2d_engine.py``), against the JAX step;
- prefill logits (4 x 24 tokens, 1 x 24 at batch 1) alike;
- the joint step's params after 3 AdamW steps under ``cosine(3e-4, 3,
  warmup=1)``, and its losses, as ``tests/test_torch_optim.py`` holds
  the one-rank joint step: 1e-5, where at most 1 entry in 10^4 may
  differ by at most 2 lr a step (AdamW's step sign near a zero
  gradient), against both;
- each rank's cache exactly its specs' local shape and bytes
  (``launch/specs.py``), never the whole;
- the plain ``ref.flash_decode``'s ``offset`` and ``return_lse`` against
  a slice of the whole call, its empty slice (0 and -inf), and
  ``merge_partials`` of 2 and 4 slices on the ranks against the whole
  call;
- the slices' partials fp32 whatever the cache's dtype, so that a bf16
  decode's attention output is rounded once, after the merge: merged
  over four ranks it is within one bf16 step of each entry of the JAX
  package's ``decode_attention`` over the whole cache, computed in fp32
  on the same bf16 values and rounded once to bf16 (the JAX bf16 route
  also rounds p and the scaled q to bf16 on the way, a gap of its own,
  held at 4 bf16 steps in ``tests/test_torch_decode.py``).
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.runtime.ranks import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 100_000
TOL = 1e-3                 # the 2-D route's (test_torch_mesh2d_engine)
ONE_RANK_TOL = 1e-5        # the merge's rounding against one whole call
SEQ = 32                   # the decode cache's positions
START, STEPS = 13, 6       # the seeded cache's fill, the decode steps
PREFILL_LEN = 24
JOINT_LEN = 24
LR = 3e-4
RING_WINDOW = 16
# name -> (arch, mesh sizes, mesh axes, batch, ringkv)
CASES = {
    "tinyllama_b4": ("tinyllama-1.1b", (2, 2), ("data", "model"), 4, False),
    "tinyllama_b1": ("tinyllama-1.1b", (2, 2), ("data", "model"), 1, False),
    "tinyllama_pod": ("tinyllama-1.1b", (2, 1, 2), ("pod", "data", "model"),
                      4, False),
    "mixtral": ("mixtral-8x22b", (2, 2), ("data", "model"), 4, False),
    "zamba2": ("zamba2-1.2b", (2, 2), ("data", "model"), 4, False),
    "whisper": ("whisper-tiny", (2, 2), ("data", "model"), 4, False),
    "starcoder2_ring": ("starcoder2-15b", (2, 2), ("data", "model"), 4,
                        True),
}
# the JAX side's two processes
JAX_SPLIT = (("whisper", "tinyllama_b4", "tinyllama_b1", "starcoder2_ring"),
             ("zamba2", "mixtral", "tinyllama_pod"))
# the joint step on a batch the data axis splits (or not: batch 1)
JOINT_CASES = ("tinyllama_b4", "tinyllama_b1", "tinyllama_pod", "mixtral",
               "zamba2", "whisper")


def _cfg(get_arch, name):
    arch = CASES[name][0]
    cfg = dataclasses.replace(get_arch(arch).reduced(), num_layers=4,
                              dtype="float32")
    if CASES[name][4]:
        cfg = dataclasses.replace(cfg, sliding_window=RING_WINDOW)
    return cfg


def _batches(name, cfg):
    """The case's prefill, joint and decode inputs, NumPy, from a seed."""
    B = CASES[name][3]
    r = np.random.default_rng(7)
    out = {}
    for kind, S in (("prefill", PREFILL_LEN), ("joint", JOINT_LEN)):
        tok = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        b = {"tokens": tok}
        if kind == "joint":
            b["labels"] = np.concatenate(
                [tok[:, 1:], np.full((B, 1), -1, np.int32)], 1)
        if cfg.encoder_tokens:
            b["frames"] = r.standard_normal(
                (B, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
        out[kind] = b
    out["decode"] = r.integers(0, cfg.vocab_size,
                               (STEPS, B, 1)).astype(np.int32)
    return out


def _seeded_cache(model, B):
    """The port's whole decode cache with K and V drawn at rows below
    START (the ring's slots), the Mamba2 states and the cross cache drawn
    whole, as torch tensors on the CPU."""
    cache = model.init_cache(B, SEQ, device="cpu")
    gen = torch.Generator().manual_seed(11)
    for path, leaf in bridge.tree_leaves(cache):
        if path[0] == "cross" or path[-1] in ("conv", "ssm"):
            leaf.copy_(0.5 * torch.randn(leaf.shape, generator=gen))
        else:
            leaf[:, :START].copy_(torch.randn(leaf[:, :START].shape,
                                              generator=gen))
    return cache


def _flat(tree):
    return {"/".join(map(str, k)): np.asarray(v, np.float32)
            for k, v in bridge.flatten_tree(tree).items()}


def jax_side(in_path, out_path, names):
    """The JAX package's steps on four forced host devices, for the cases
    ``names``."""
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
    from repro.runtime.steps import (make_decode_step,
                                     make_joint_train_step,
                                     make_prefill_step)

    jsh.FSDP_THRESHOLD_BYTES = THRESHOLD
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    res = {}
    for name in names:
        _, sizes, axes, B, ring = CASES[name]
        cfg = _cfg(get_arch, name)
        model = build_model(cfg)
        phi = model.init(jax.random.PRNGKey(0))
        batches, jcache = inputs[name]["batches"], inputs[name]["cache"]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes), axes)

        def put(b):
            return {k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, jsh.token_spec(mesh, B, extra_dims=v.ndim - 1)))
                for k, v in b.items()}

        out = {}
        with mesh_context(mesh), feature_scope(ringkv=ring):
            p = jax.device_put(phi, jsh.param_shardings(phi, mesh))
            out["prefill"] = np.asarray(jax.jit(make_prefill_step(model))(
                p, put(batches["prefill"])))
            specs = decode_batch_specs(cfg, InputShape("t", SEQ, B,
                                                       "decode"), mesh)
            # each step's cache placed back on the specs' shardings, so
            # that one executable serves every step
            held = jax.tree.map(lambda s: s.sharding, specs["cache"])
            cache = jax.device_put(jax.tree.map(jnp.asarray, jcache), held)
            step = jax.jit(make_decode_step(model))
            logits = []
            for t in range(STEPS):
                lg, cache = step(p, {"tokens": put({"t": batches["decode"][
                    t]})["t"], "cache": cache,
                    "cache_len": jnp.int32(START + t)})
                cache = jax.device_put(cache, held)
                logits.append(np.asarray(lg))
            out["decode"] = np.stack(logits)
            out["cache"] = _flat(jax.tree.map(np.asarray, cache))
            if name in JOINT_CASES:
                opt = optim.adamw()
                joint = jax.jit(make_joint_train_step(
                    model, opt, optim.cosine(LR, 3, warmup=1)))
                psh = jsh.param_shardings(phi, mesh)
                state = opt.init(phi)
                ssh = type(state)(psh, psh, NamedSharding(
                    mesh, jax.sharding.PartitionSpec()))
                state = jax.device_put(state, ssh)
                n, losses = jax.device_put(jnp.int32(0), ssh.count), []
                jb = put(batches["joint"])
                for _ in range(3):
                    p, state, n, m = joint(p, state, n, jb)
                    p, state, n = jax.device_put((p, state, n),
                                                 (psh, ssh, ssh.count))
                    losses.append(float(m["loss"]))
                out["joint"] = (_flat(jax.tree.map(np.asarray, p)), losses)
        res[name] = out
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# the bf16 merge's cases: (L, window)
BF16_MERGES = ((50, 0), (64, 0), (9, 0), (33, 20))


def _bf16_merge_inputs():
    """q (B, 1, H, hd), k and v (B, 64, Kv, hd), bf16, from a seed."""
    gen = torch.Generator().manual_seed(5)
    B, H, Kv, hd, S = 2, 8, 2, 64, 64
    return (torch.randn(B, 1, H, hd, generator=gen).bfloat16(),
            torch.randn(B, S, Kv, hd, generator=gen).bfloat16(),
            torch.randn(B, S, Kv, hd, generator=gen).bfloat16())


def _merge_rank(rank):
    """``merge_partials`` of 2 slices (over ``model``) and of 4 (over
    ``data``, then ``model``) of one cache, each rank attending its own,
    against the whole call; a window whose edge falls in a slice and a
    length that leaves slices empty. Then bf16 slices of 4 merged into
    bf16 (``BF16_MERGES``), for the test against the JAX package."""
    from repro_torch.models.attention import decode_attention, merge_partials
    from repro_torch.runtime import sharding as sh

    mesh = sh.make_mesh((2, 2), ("data", "model"), "cpu")
    gen = torch.Generator().manual_seed(3)
    B, H, Kv, hd, S = 2, 8, 2, 64, 64
    q = torch.randn(B, 1, H, hd, generator=gen)
    k = torch.randn(B, S, Kv, hd, generator=gen)
    v = torch.randn(B, S, Kv, hd, generator=gen)
    out = {}
    for L, window in ((50, 0), (50, 20), (9, 0)):
        want = decode_attention(q, k, v, L, window=window)
        for parts, axes in ((2, ("model",)), (4, ("data", "model"))):
            i = 0
            for ax in axes:
                i = i * mesh.shape[ax] + mesh.coordinate(ax)
            n = S // parts
            o, lse = decode_attention(
                q, k[:, i * n:(i + 1) * n].contiguous(),
                v[:, i * n:(i + 1) * n].contiguous(), L, window=window,
                offset=i * n, lse=True)
            got, _ = merge_partials(o, lse, [mesh.group(ax) for ax in axes])
            out[(L, window, parts)] = float((got - want).abs().max())
    q, k, v = _bf16_merge_inputs()
    i, n = rank, k.shape[1] // 4
    groups = [mesh.group("data"), mesh.group("model")]
    bf16 = {}
    for L, window in BF16_MERGES:
        o, lse = decode_attention(
            q, k[:, i * n:(i + 1) * n].contiguous(),
            v[:, i * n:(i + 1) * n].contiguous(), L, window=window,
            offset=i * n, lse=True)
        assert o.dtype == torch.float32
        got, _ = merge_partials(o, lse, groups, q.dtype)
        bf16[(L, window)] = got.float().numpy()
    return {"f32": out, "bf16": bf16}


def _rank_steps(rank, inits, inputs):
    """Each rank: every case's prefill, decode and joint steps on its
    shards, and one case in four also its single-rank steps. Then the
    merge alone."""
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.specs import cache_chip_bytes, local_cache_shapes
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.flags import feature_scope
    from repro_torch.runtime.steps import (batch_rows, make_decode_step,
                                           make_joint_train_step,
                                           make_prefill_step)

    sh.FSDP_THRESHOLD_BYTES = THRESHOLD
    res = {}
    for name, (_, sizes, axes, B, ring) in CASES.items():
        model = build_model(_cfg(get_arch, name))
        layout = model.jax_layout
        mesh = sh.make_mesh(sizes, axes, "cpu")
        batches = {k: ({n: torch.from_numpy(a) for n, a in v.items()}
                       if isinstance(v, dict) else torch.from_numpy(v))
                   for k, v in inputs[name]["batches"].items()}
        jcache = inputs[name]["cache"]
        out = {}
        with feature_scope(ringkv=ring):
            prefill = make_prefill_step(model, mesh=mesh)
            local = bridge.lm_shards_from_jax(inits[name], layout,
                                              prefill.shards, "cpu")
            out["prefill"] = prefill(local, batches["prefill"]).numpy()
            decode = make_decode_step(model, mesh=mesh, batch_size=B,
                                      seq_len=SEQ)
            cs = decode.cache_shards
            cache = bridge.lm_cache_shards_from_jax(jcache, layout, cs,
                                                    "cpu")
            shape = InputShape("t", SEQ, B, "decode")
            meshshape = sh.MeshShape(axes, sizes)
            out["cache_bytes"] = sum(
                v.numel() * v.element_size()
                for _, v in bridge.tree_leaves(cache))
            out["specs_cache_bytes"] = cache_chip_bytes(model.cfg, shape,
                                                        meshshape)
            out["whole_cache_bytes"] = sum(
                math.prod(s) * cs.dtypes[k].itemsize
                for k, s in cs.shapes.items())
            want_shapes = local_cache_shapes(model.cfg, shape, meshshape)
            out["shapes_match"] = all(
                tuple(v.shape) == want_shapes[k] == cs.local_shape(k)
                for k, v in bridge.tree_leaves(cache))
            out["seq_split"] = sum(cs.seq(k) is not None for k in cs.specs
                                   if k[-1] == "k")
            logits = []
            for t in range(STEPS):
                rows, _ = batch_rows({"t": batches["decode"][t]}, mesh,
                                     leading=0)
                at = (START + t if t % 2 == 0 else
                      torch.tensor([START + t], dtype=torch.int32))
                lg, cache = decode(local, {"tokens": rows["t"],
                                           "cache": cache, "cache_len": at})
                logits.append(lg.numpy())
            out["decode"] = np.stack(logits)
            out["cache"] = _flat(bridge.lm_cache_to_jax(
                bridge.whole_cache(cache, cs), layout))
            if name in JOINT_CASES:
                opt = optim.adamw()
                joint = make_joint_train_step(
                    model, opt, optim.cosine(LR, 3, warmup=1), mesh=mesh)
                state = bridge.adam_shards_from_jax(
                    inputs[name]["adam"], layout, joint.shards, "cpu")
                p, n, losses = local, 0, []
                for _ in range(3):
                    p, state, n, m = joint(p, state, n, batches["joint"])
                    losses.append(float(m["loss"]))
                out["joint"] = (_flat(bridge.lm_params_to_jax(
                    bridge.whole_tree(p, joint.shards), layout)), losses)
            if _ref_rank(name) == rank:
                out["one_rank"] = _one_rank(model, inits[name], jcache,
                                            batches, name)
        res[name] = out
    res["merge"] = _merge_rank(rank)
    return res


def _ref_rank(name):
    """The rank that also runs a case's single-rank steps (spread over
    the ranks)."""
    return list(CASES).index(name) % 4


def _one_rank(model, init, jcache, batches, name):
    """The port's single-rank steps on the whole params and cache."""
    from repro_torch import optim
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_joint_train_step,
                                           make_prefill_step)
    layout = model.jax_layout
    params = bridge.lm_params_from_jax(init, layout, "cpu")
    out = {"prefill": make_prefill_step(model)(params,
                                               batches["prefill"]).numpy()}
    cache = bridge.lm_cache_from_jax(jcache, layout, "cpu")
    step = make_decode_step(model)
    logits = []
    with torch.no_grad():
        for t in range(STEPS):
            lg, cache = step(params, {"tokens": batches["decode"][t],
                                      "cache": cache,
                                      "cache_len": START + t})
            logits.append(lg.numpy())
    out["decode"] = np.stack(logits)
    out["cache"] = _flat(bridge.lm_cache_to_jax(cache, layout))
    if name in JOINT_CASES:
        opt = optim.adamw()
        joint = make_joint_train_step(model, opt,
                                      optim.cosine(LR, 3, warmup=1))
        p, state, n, losses = params, opt.init(params), 0, []
        for _ in range(3):
            p, state, n, m = joint(p, state, n, batches["joint"])
            losses.append(float(m["loss"]))
        out["joint"] = (_flat(bridge.lm_params_to_jax(p, layout)), losses)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro import optim as joptim
    from repro.configs import get_arch as jget_arch
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.flags import feature_scope

    root = tmp_path_factory.mktemp("production_serve")
    inits, inputs = {}, {}
    for name, (_, _, _, B, ring) in CASES.items():
        phi = jbuild(_cfg(jget_arch, name)).init(jax.random.PRNGKey(0))
        inits[name] = jax.tree.map(np.asarray, phi)
        model = build_model(_cfg(get_arch, name))
        with feature_scope(ringkv=ring):
            cache = _seeded_cache(model, B)
        inputs[name] = {
            "batches": _batches(name, model.cfg),
            "cache": bridge.lm_cache_to_jax(cache, model.jax_layout),
            "adam": jax.tree.map(np.asarray, joptim.adamw().init(phi))}
    in_path = str(root / "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    # the JAX side in two processes, the cases shared by their compile time
    procs = []
    for i, names in enumerate(JAX_SPLIT):
        out = str(root / f"jax{i}.pkl")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", "import test_torch_production_serve as "
             f"t; t.jax_side({in_path!r}, {out!r}, {names!r})"], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    try:
        ranks = run_ranks(_rank_steps, 4, str(root / "ranks"), inits,
                          inputs, device="cpu", timeout=600)
        for _, proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for _, proc in procs:
            proc.kill()
    want = {}
    for out, _ in procs:
        with open(out, "rb") as f:
            want.update(pickle.load(f))
    return {"ranks": ranks, "jax": want}


def _rows(mesh_sizes, axes, B, rank):
    """The batch rows rank ``rank`` holds (``token_spec``'s split)."""
    coords = np.unravel_index(rank, mesh_sizes)
    bax = [a for a in ("pod", "data") if a in axes]
    n = math.prod(mesh_sizes[axes.index(a)] for a in bax)
    if B % n:
        return slice(0, B)
    i = 0
    for a in bax:
        i = i * mesh_sizes[axes.index(a)] + int(coords[axes.index(a)])
    return slice(i * (B // n), (i + 1) * (B // n))


def _near(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("against", ["jax", "one_rank"])
def test_decode_logits_and_cache(runs, name, against):
    _, sizes, axes, B, _ = CASES[name]
    tol = TOL if against == "jax" else ONE_RANK_TOL
    want = (runs["jax"][name] if against == "jax"
            else runs["ranks"][_ref_rank(name)][name]["one_rank"])
    for rank, r in enumerate(runs["ranks"]):
        got = r[name]
        rows = _rows(sizes, axes, B, rank)
        _near(got["decode"], want["decode"][:, rows], tol,
              f"{name} rank {rank} decode logits")
        assert set(got["cache"]) == set(want["cache"]), name
        for k, v in want["cache"].items():
            _near(got["cache"][k], v, tol, f"{name} rank {rank} cache {k}")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("against", ["jax", "one_rank"])
def test_prefill_logits(runs, name, against):
    _, sizes, axes, B, _ = CASES[name]
    tol = TOL if against == "jax" else ONE_RANK_TOL
    want = (runs["jax"][name] if against == "jax"
            else runs["ranks"][_ref_rank(name)][name]["one_rank"])
    for rank, r in enumerate(runs["ranks"]):
        _near(r[name]["prefill"], want["prefill"][_rows(sizes, axes, B,
                                                        rank)],
              tol, f"{name} rank {rank} prefill logits")


@pytest.mark.parametrize("name", JOINT_CASES)
@pytest.mark.parametrize("against", ["jax", "one_rank"])
def test_joint_step_adamw(runs, name, against):
    """3 AdamW steps, held as ``tests/test_torch_optim.py`` holds the
    one-rank joint step."""
    want_p, want_losses = (runs["jax"][name]["joint"] if against == "jax"
                           else runs["ranks"][_ref_rank(name)][name][
                               "one_rank"]["joint"])
    for r in runs["ranks"]:
        got_p, got_losses = r[name]["joint"]
        for a, b in zip(got_losses, want_losses):
            assert abs(a - b) <= 1e-5 * abs(b), (name, got_losses,
                                                 want_losses)
        assert set(got_p) == set(want_p), name
        for path, w in want_p.items():
            diff = np.abs(got_p[path] - w)
            off = diff > 1e-5 + 1e-5 * np.abs(w)
            assert off.sum() <= max(1, w.size // 10_000), (name, path)
            assert diff.max() <= 3 * 2 * LR, (name, path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_its_specs_cache_bytes(runs, name):
    """Each rank's cache is exactly its specs' local shapes and bytes a
    chip, a part of the whole (never the whole), its KV sequence split."""
    for r in runs["ranks"]:
        got = r[name]
        assert got["shapes_match"], name
        assert got["cache_bytes"] == got["specs_cache_bytes"], name
        assert got["cache_bytes"] < got["whole_cache_bytes"], name
        assert got["seq_split"] > 0, name


def test_merge_of_2_and_4_slices_matches_the_whole_call(runs):
    for r in runs["ranks"]:
        for key, err in r["merge"]["f32"].items():
            assert err <= 1e-5, (key, err)


def _bf16_step(x):
    """One bf16 step (8 significant bits) at the magnitude of each entry
    of ``x``."""
    a = np.maximum(np.abs(x).astype(np.float64), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("case", BF16_MERGES)
def test_bf16_merge_rounds_once_as_the_jax_attention(runs, case):
    """The production decode's bf16 attention output, its four slices'
    fp32 partials merged over the ranks and rounded once, within one bf16
    step of each entry of the JAX ``decode_attention`` over the whole
    cache in fp32, rounded once to bf16. (Partials rounded to bf16 before
    the merge miss it at up to 100 of the 1,024 entries.)"""
    import jax.numpy as jnp

    from repro.models.attention import decode_attention as jax_decode
    L, window = case
    q, k, v = (jnp.asarray(t.float().numpy())
               for t in _bf16_merge_inputs())
    want = np.asarray(jax_decode(q, k, v, L, window=window).astype(
        jnp.bfloat16)).astype(np.float32)
    for r in runs["ranks"]:
        got = r["merge"]["bf16"][case]
        assert got.shape == want.shape
        assert (np.abs(got - want) <= _bf16_step(want)).all(), (
            case, float(np.abs(got - want).max()))


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("L", [1, 17, 40])
def test_ref_flash_decode_slice_matches_the_whole_call(L, window):
    """Each slice's ``offset`` call attends what of the whole call's
    stretch falls in it; the slices' log-sum-exps merge to the whole
    call."""
    gen = torch.Generator().manual_seed(L + window)
    B, H, Kv, hd, S = 2, 6, 2, 64, 40
    q = torch.randn(B, H, hd, generator=gen)
    k = torch.randn(B, S, Kv, hd, generator=gen)
    v = torch.randn(B, S, Kv, hd, generator=gen)
    want, want_lse = ref.flash_decode(q, k, v, L, window=window,
                                      return_lse=True)
    assert torch.equal(want, ref.flash_decode(q, k, v, L, window=window))
    outs, lses = [], []
    for off in range(0, S, 8):
        o, lse = ref.flash_decode(q, k[:, off:off + 8], v[:, off:off + 8],
                                  L, window=window, offset=off,
                                  return_lse=True)
        lo, hi = max(0, L - window) if window else 0, L
        if min(hi, off + 8) <= max(lo, off):
            assert torch.equal(o, torch.zeros_like(o))
            assert bool((lse == -math.inf).all())
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    m = lse.max(0).values
    w = torch.exp(lse - m)
    merged = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
    torch.testing.assert_close(merged, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m + torch.log(w.sum(0)), want_lse,
                               rtol=1e-5, atol=1e-5)


def test_ref_flash_decode_empty_slice_gives_zero_and_minus_inf():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 64, generator=gen)
    k = torch.randn(1, 8, 2, 64, generator=gen)
    o, lse = ref.flash_decode(q, k, k, 5, offset=8, return_lse=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool((lse == -math.inf).all())
    # the window's edge past the slice: empty too
    o, lse = ref.flash_decode(q, k, k, 30, window=4, offset=8,
                              return_lse=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool((lse == -math.inf).all())


def test_wrapper_slice_on_the_cpu_is_the_plain_version():
    """``kernels/flash_decode.py`` on CPU tensors: the plain version, its
    output and its log-sum-exp fp32 (a bf16 slice's partial unrounded), a
    tensor L read as an int; the slice's range rules."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 64, generator=gen).bfloat16()
    k = torch.randn(2, 16, 2, 64, generator=gen).bfloat16()
    o, lse = fd.flash_decode(q, k, k, torch.tensor([20], dtype=torch.int32),
                             window=8, offset=16, return_lse=True)
    wo, wl = ref.flash_decode(q, k, k, 20, window=8, offset=16,
                              return_lse=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.equal(o, wo) and torch.equal(lse, wl)
    assert fd.local_stretch(20, 8, 16, 16) == (0, 4)
    assert fd.local_stretch(20, 0, 24, 16) == (0, 0)
    assert fd.local_stretch(50, 4, 16, 16) == (16, 16)
    fd.flash_decode(q, k, k, 40, offset=16)          # L past the slice
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, k, 40)                 # L > S, no slice
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, k, 4, offset=-1)
