"""The production plan of the port, ``configs/shapes.py``,
``launch/specs.py``, ``launch/describe.py`` and ``launch/dryrun.py::
skip_reason``, against the JAX package's.

The JAX side runs in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (its
``input_specs`` attaches ``NamedSharding``s of the real production meshes)
and dumps JSON: every non-skipped (arch x shape) cell's params and batch
leaves on the 16 x 16 and 2 x 16 x 16 meshes (name, shape, dtype, spec),
and ``describe``'s text for every arch on both meshes, with and without
``--params``. The port builds the same from ``MeshShape``s, with nothing
allocated. Held exactly:

- each leaf in the JAX layout (stacked names and shapes): its name,
  shape, dtype and spec; and each port leaf's spec is its JAX leaf's
  without the stack dim;
- ``describe``'s printed text, character for character;
- the skip matrix, and the four shapes.

Also held: FSDP is decided on the stacked leaf, not per layer (a leaf the
per-layer rule keeps whole on ``data`` splits there), and the bytes a
chip that ``describe`` gives.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, SHAPES, InputShape,  # noqa: E402
                                 get_arch, get_shape)
from repro_torch.launch import describe as tdescribe  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.dryrun import skip_reason  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": tdescribe.SINGLE_POD, "multi": tdescribe.MULTI_POD}
FLAGS = {"plain": (False, False), "params": (True, False),
         "multi_pod": (False, True), "params_multi_pod": (True, True)}

JAX_SIDE = r"""
import contextlib, io, json, sys
import jax
import numpy as np
from repro.configs import ALL_ARCHS, SHAPES, get_arch, get_shape
from repro.launch import describe
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import input_specs
from repro.launch.dryrun import skip_reason
from repro.runtime.sharding import _path_str
import repro.launch.specs as jspecs
import types

# each model's abstract params traced once (input_specs and describe
# trace them again for every cell and every call)
_traced = {}
def eval_shape(fn, *args):
    model = getattr(fn, "__self__", None)          # a Model's bound init
    if model is None:
        return jax.eval_shape(fn, *args)
    key = model.cfg.name
    if key not in _traced:
        _traced[key] = jax.eval_shape(fn, *args)
    return _traced[key]
describe.jax = types.SimpleNamespace(eval_shape=eval_shape,
                                     random=jax.random,
                                     tree_util=jax.tree_util)
jspecs.jax = types.SimpleNamespace(eval_shape=eval_shape,
                                   random=jax.random, tree=jax.tree,
                                   tree_util=jax.tree_util,
                                   ShapeDtypeStruct=jax.ShapeDtypeStruct)

def norm(spec):
    return [list(a) if isinstance(a, tuple) and len(a) > 1 else
            (a[0] if isinstance(a, tuple) else a) for a in spec]

def leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = leaf.sharding.spec
        out[_path_str(path)] = [list(leaf.shape), np.dtype(leaf.dtype).name,
                                norm(list(spec) + [None] * (len(leaf.shape)
                                                            - len(spec)))]
    return out

res = {"cells": {}, "describe": {}, "skips": []}
for mesh_name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ALL_ARCHS:
        for s in SHAPES:
            cfg, shape = get_arch(arch), get_shape(s)
            if skip_reason(cfg, shape):
                if mesh_name == "single":
                    res["skips"].append([arch, s])
                continue
            params, batch = input_specs(cfg, shape, mesh)
            res["cells"]["|".join((mesh_name, arch, s))] = {
                "params": leaves(params), "batch": leaves(batch)}
for arch in ALL_ARCHS:
    for show, multi in ((False, False), (True, False), (False, True),
                        (True, True)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            describe.describe(arch, show, multi)
        res["describe"]["|".join((arch, str(show), str(multi)))] = buf.getvalue()
json.dump(res, open(sys.argv[1], "w"))
"""


def _norm(spec):
    return [list(a) if isinstance(a, tuple) and len(a) > 1 else
            (a[0] if isinstance(a, tuple) else a) for a in spec]


def _row(leaf):
    return [list(leaf.shape), str(leaf.dtype).replace("torch.", ""),
            _norm(leaf.spec)]


def _batch_leaves(batch):
    """A port batch's leaves but the decode cache, by their names."""
    return {k: _row(v) for k, v in batch.items() if k != "cache"}


@pytest.fixture(scope="module")
def jax_plan(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("specs") / "jax.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, out], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _cells():
    return [(m, a, s) for m in MESHES for a in ALL_ARCHS for s in SHAPES
            if not skip_reason(get_arch(a), get_shape(s))]


def test_input_specs_cover_all_arch_shape_pairs():
    """input_specs builds, with nothing allocated, every cell of the
    matrix on both production meshes: each leaf a LeafSpec whose spec has
    one entry a dim."""
    n = 0
    for mesh in MESHES.values():
        for arch in ALL_ARCHS:
            for s in SHAPES:
                cfg, shape = get_arch(arch), get_shape(s)
                if skip_reason(cfg, shape):
                    continue
                params, batch = tspecs.input_specs(cfg, shape, mesh)
                for _, leaf in (list(bridge.tree_leaves(params))
                                + list(bridge.tree_leaves(batch))):
                    assert isinstance(leaf, tspecs.LeafSpec)
                    assert len(leaf.spec) == len(leaf.shape)
                n += 1
    assert n == 2 * 35


def test_skip_matrix_documented():
    """Exactly the documented cells skip, all others run."""
    skips = {(a, s) for a in ALL_ARCHS for s in SHAPES
             if skip_reason(get_arch(a), get_shape(s))}
    expected = {(a, "long_500k") for a in
                ("tinyllama-1.1b", "glm4-9b", "minicpm-2b", "paligemma-3b",
                 "whisper-tiny")}
    assert skips == expected, skips ^ expected


def test_skip_matrix_and_shapes_equal_the_jax_packages(jax_plan):
    from repro.configs import SHAPES as JSHAPES
    from repro.launch.dryrun import skip_reason as jskip
    from repro.configs import get_arch as jget_arch
    skips = sorted([a, s] for a in ALL_ARCHS for s in SHAPES
                   if skip_reason(get_arch(a), get_shape(s)))
    assert skips == sorted(jax_plan["skips"])
    for a in ALL_ARCHS:
        for s in SHAPES:
            assert skip_reason(get_arch(a), get_shape(s)) == jskip(
                jget_arch(a), JSHAPES[s])
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert isinstance(get_shape("train_4k"), InputShape)
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_the_jax_input_specs(jax_plan, mesh_name, arch):
    """Every leaf of every cell of ``arch`` in the JAX layout: name,
    shape, dtype and spec; each port leaf's spec is its JAX leaf's
    without the stack dim."""
    mesh = MESHES[mesh_name]
    cfg = get_arch(arch)
    model = build_model(cfg)
    jparams = {k: _row(v) for k, v in
               tspecs.jax_param_specs(cfg, mesh).items()}
    port = bridge.flatten_tree(tspecs.param_specs(cfg, mesh))
    lay = bridge.jax_layout_map(list(port), model.jax_layout)
    for jpath, (stacked, members) in lay.items():
        want = jparams["/".join(map(str, jpath))][2]
        for m in members:
            assert _norm(port[m].spec) == (want[1:] if stacked else want), m
    cells = [c for c in _cells() if c[:2] == (mesh_name, arch)]
    assert cells
    for _, _, s in cells:
        want = jax_plan["cells"]["|".join((mesh_name, arch, s))]
        assert jparams == want["params"], s
        shape = get_shape(s)
        _, batch = tspecs.input_specs(cfg, shape, mesh)
        got = _batch_leaves(batch)
        if shape.kind == "decode":
            got.update({"cache/" + k: _row(v) for k, v in
                        tspecs.jax_cache_specs(cfg, shape, mesh).items()})
            cache = bridge.flatten_tree(batch["cache"])
            jcache = tspecs.jax_cache_specs(cfg, shape, mesh)
            for jpath, (stacked, members) in bridge.jax_layout_map(
                    list(cache), model.jax_layout, True).items():
                want_spec = jcache["/".join(map(str, jpath))].spec
                for m in members:
                    assert cache[m].spec == (want_spec[1:] if stacked
                                             else want_spec), m
        assert got == want["batch"], s


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_describe_prints_the_jax_packages_text(jax_plan, flags):
    show, multi = FLAGS[flags]
    for arch in ALL_ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tdescribe.describe(arch, show, multi)
        assert buf.getvalue() == jax_plan["describe"][
            "|".join((arch, str(show), str(multi)))], arch


def test_describe_main_prints_every_arch(capsys):
    tdescribe.main(["--params", "--multi-pod"])
    out = capsys.readouterr().out
    assert out.count("\n# ") + out.startswith("# ") == len(ALL_ARCHS)
    with pytest.raises(SystemExit):
        tdescribe.main(["--arch", "gpt-5"])


def test_fsdp_is_decided_on_the_stacked_leaf():
    """tinyllama-1.1b's wq is 4.2 MB a model shard a layer, 92 MB
    stacked over its 22 layers on a (2, 2) mesh: the JAX rule splits the
    stack's d on data, so every layer's wq splits there too."""
    cfg = get_arch("tinyllama-1.1b")
    mesh = sh.MeshShape(("data", "model"), (2, 2))
    layer = sh.param_spec("layers/0/attn/wq", (2048, 32, 64), mesh)
    assert layer == (None, "model", None)
    port = bridge.flatten_tree(tspecs.param_specs(cfg, mesh))
    assert {port[("layers", i, "attn", "wq")].spec for i in range(22)} == {
        ("data", "model", None)}
    jax_leaf = tspecs.jax_param_specs(cfg, mesh)["layers/0/attn/wq"]
    assert jax_leaf.shape == (22, 2048, 32, 64)
    assert jax_leaf.spec == (None, "data", "model", None)
    # the bytes a chip: every leaf's part; the norms (and wk, wv, under
    # the threshold) whole on data
    whole = sum(v.nbytes for v in port.values())
    assert whole == 2 * 1_100_048_384
    assert tdescribe.chip_bytes(cfg, mesh) == sum(
        v.chip_bytes(mesh) for v in port.values()) == 561_696_768


def test_layout_map_round_trips_every_arch():
    """``jax_layout_map`` both ways: every port leaf in exactly one JAX
    leaf, and the JAX leaves those of the JAX init's tree, for params and
    decode caches."""
    import jax
    from repro.configs import get_arch as jget_arch
    from repro.models import build_model as jbuild
    from repro.runtime.sharding import _path_str
    for arch in ALL_ARCHS:
        cfg = get_arch(arch)
        model = build_model(cfg)
        paths = [p for p, _ in bridge.tree_leaves(model.param_shapes())]
        lay = bridge.jax_layout_map(paths, model.jax_layout)
        assert sorted(m for _, ms in lay.values() for m in ms) == sorted(paths)
        jshapes = jax.eval_shape(jbuild(jget_arch(arch)).init,
                                 jax.random.PRNGKey(0))
        want = {_path_str(p): tuple(v.shape) for p, v in
                jax.tree_util.tree_flatten_with_path(jshapes)[0]}
        assert {k: v.shape for k, v in
                tspecs.jax_param_specs(cfg, tdescribe.SINGLE_POD).items()} \
            == want, arch
