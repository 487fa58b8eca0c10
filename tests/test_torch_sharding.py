"""The port's sharding rules (``runtime/sharding.py``), ambient mesh
(``runtime/shardctx.py``) and production meshes (``launch/mesh.py``)
against the JAX package's.

The rules are pure functions of a leaf's path and shape and of a mesh's
axis names and sizes, so both packages' rules take the same duck-typed
``MeshShape`` (no process, no device) and must return the same spec (the
JAX package's ``PartitionSpec`` as a tuple). Held at every full-width
parameter leaf of every config (``jax.eval_shape`` of the JAX init: no
allocation), on the (16, 16) ``data/model`` and (2, 16, 16)
``pod/data/model`` production meshes, a (4,) ``clients`` mesh and a
(2, 2) ``clients/model`` mesh, with the ``moe2d`` lever off and on; the
input and cache rules on a grid of shapes.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ALL_ARCHS, get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime import flags as jflags  # noqa: E402
from repro.runtime import shardctx as jctx  # noqa: E402
from repro.runtime import sharding as jsh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.runtime import flags  # noqa: E402
from repro_torch.runtime import shardctx as ctx  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

MESHES = {
    "data16_model16": sh.MeshShape(("data", "model"), (16, 16)),
    "pod2_data16_model16": sh.MeshShape(("pod", "data", "model"),
                                        (2, 16, 16)),
    "clients4": sh.MeshShape(("clients",), (4,)),
    "clients2_model2": sh.MeshShape(("clients", "model"), (2, 2)),
}


def _norm(spec):
    """A spec with one-axis tuples written as the axis, as JAX's
    ``PartitionSpec`` writes them (the same placement either way)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@contextlib.contextmanager
def _moe2d(on):
    with jflags.feature_scope(moe2d=on), flags.feature_scope(moe2d=on):
        yield


@pytest.fixture(scope="module")
def leaves():
    """Every config's full-width parameter leaves, (path, shape)."""
    out = {}
    for arch in ALL_ARCHS:
        model = jbuild(jget_arch(arch))
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        out[arch] = [(jsh._path_str(p), tuple(x.shape)) for p, x in
                     jax.tree_util.tree_flatten_with_path(shapes)[0]]
    return out


@pytest.mark.parametrize("moe2d", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_spec_matches_the_jax_rules(leaves, arch, mesh, moe2d):
    m = MESHES[mesh]
    with _moe2d(moe2d):
        for path, shape in leaves[arch]:
            want = _norm(jsh.param_spec(path, shape, m))
            got = _norm(sh.param_spec(path, shape, m))
            assert got == want, (path, shape, got, want)
            assert _norm(sh.partitioner_for("moe").spec(path, shape,
                                                        m)) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_and_cache_specs_match_the_jax_rules(mesh):
    m = MESHES[mesh]
    for b in (1, 2, 3, 8, 32, 64):
        for extra, lead in ((1, 0), (2, 1)):
            assert _norm(sh.token_spec(m, b, extra, lead)) == _norm(
                jsh.token_spec(m, b, extra, lead))
        for ndim in (4, 5):
            for s in (1, 7, 64, 4096):
                assert _norm(sh.attn_cache_spec(m, ndim, b, s)) == _norm(
                    jsh.attn_cache_spec(m, ndim, b, s))
        for leaf, ndim in (("ssm", 4), ("ssm", 5), ("conv", 3)):
            for heads in (3, 16, 24):
                assert _norm(sh.mamba_cache_spec(m, leaf, ndim, b, heads)) \
                    == _norm(jsh.mamba_cache_spec(m, leaf, ndim, b, heads))
        assert sh.batch_axes(m) == jsh.batch_axes(m)


def test_partitioners_and_param_bytes():
    assert sh.FSDP_THRESHOLD_BYTES == jsh.FSDP_THRESHOLD_BYTES
    for name in ("default", "transformer", "mamba2", "moe"):
        assert sh.partitioner_for(name).name == name
    assert sh.register_partitioner("default") is sh.DEFAULT_PARTITIONER
    with pytest.raises(ValueError, match="different rules"):
        sh.register_partitioner("default", rules=lambda *a: ())
    with pytest.raises(KeyError, match="no ModelPartitioner"):
        sh.partitioner_for("nope")
    tree = {"embed": torch.zeros(32, 16), "layers": [
        {"attn": {"wq": torch.zeros(16, 4, 4, dtype=torch.bfloat16)}}]}
    assert sh.per_device_param_bytes(tree) == 32 * 16 * 4 + 16 * 16 * 2
    m = MESHES["data16_model16"]
    specs = sh.param_shardings(tree, m)
    assert specs["embed"] == ("model", None)        # the vocab, 32 of 16
    assert _norm(specs["layers"][0]["attn"]["wq"]) == _norm(
        jsh.param_spec("layers/0/attn/wq", (16, 4, 4), m))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_axis_and_spec_match_under_manual_axes(mesh):
    m = MESHES[mesh]
    logical = (None, "batch", "model", "expert", "seq", "fsdp")
    for manual in ((), ("pod",), ("clients",), ("data", "model")):
        with jctx.manual_axes(*manual), ctx.manual_axes(*manual):
            for name in logical:
                assert ctx.resolve_axis(name, m) == jctx.resolve_axis(name,
                                                                      m)
            with jctx.mesh_context(m), ctx.mesh_context(m):
                assert _norm(ctx.spec(*logical)) == _norm(
                    jctx.spec(*logical))
    with pytest.raises(ValueError, match="unknown logical axis"):
        ctx.resolve_axis("nope", m)


def test_shard_is_the_identity_without_a_model_axis():
    """Each rank holds its own part of a tensor, on every mesh: under the
    2-D route a dim split over ``model`` is already this rank's heads."""
    x = torch.zeros(4, 8)
    assert ctx.shard(x, "batch", "model") is x                 # no mesh
    for mesh in ("clients4", "pod2_data16_model16", "clients2_model2"):
        m = MESHES[mesh]
        with ctx.mesh_context(m):
            y = torch.zeros(4, 16)
            assert ctx.shard(y, "batch", "model") is y
            with ctx.manual_axes(*m.axis_names):
                assert ctx.shard(x, "batch", "model") is x
            with pytest.raises(ValueError, match="unknown logical axis"):
                ctx.shard(x, "nope")
    assert ctx.current_mesh() is None


def test_production_mesh_needs_its_ranks():
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            make_production_mesh(multi_pod=multi_pod)


def test_one_rank_mesh_needs_no_process_group():
    m = sh.make_mesh((1,), ("clients",), "cpu")
    assert m.group("clients") is None and m.coordinate("clients") == 0
    assert m.backend is None and m.capturable
    with pytest.raises(ValueError, match="needs 2 ranks"):
        sh.make_mesh((2,), ("clients",), "cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        sh.client_model_mesh(2, 2, "cpu")
    assert sh.choose_backend(["a", "a"], ["cpu", "cpu"]) == "gloo"
    with pytest.raises(ValueError, match="out of range"):
        sh.init_distributed("127.0.0.1:1", 2, 2)
    t = torch.arange(3)
    assert sh.all_reduce(t, None) is t
    np.testing.assert_array_equal(sh.gather_rows(t, None, 0, 1).numpy(),
                                  t[None].numpy())


def _published(hosts, cards, device=None):
    return [{"host": h, "device": device, "cards": c}
            for h, c in zip(hosts, cards)]


@pytest.mark.parametrize("hosts,cards,want_devices,want", [
    # the launcher's cross-host form: 2 hosts x 8 cards, one card a rank
    (["a"] * 8 + ["b"] * 8, [8] * 16,
     [f"cuda:{i}" for i in range(8)] * 2, "nccl"),
    # ranks interleaved over two hosts: still one card each
    (["a", "b", "a", "b"], [2] * 4,
     ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], "nccl"),
    # two ranks on one card share it through gloo
    (["a", "a"], [1, 1], ["cuda:0", "cuda:0"], "gloo"),
    # one host with more ranks than cards, beside one that has enough
    (["a", "a", "a", "b"], [2, 2, 2, 1],
     ["cuda:0", "cuda:1", "cuda:0", "cuda:0"], "gloo"),
    # a host without a card puts its ranks on the CPU
    (["a", "b"], [1, 0], ["cuda:0", "cpu"], "gloo"),
    (["a"], [1], ["cuda:0"], "nccl"),
])
def test_backend_follows_the_ranks_topology(hosts, cards, want_devices,
                                            want):
    devices = sh.place_ranks(_published(hosts, cards))
    assert list(devices) == want_devices
    assert sh.choose_backend(hosts, devices) == want


def test_ranks_asking_for_a_device_are_placed_there():
    ranks = (_published(["a", "a"], [2, 2], "cpu")
             + _published(["a", "a"], [2, 2], "cuda:1"))
    assert sh.place_ranks(ranks) == ("cpu", "cpu", "cuda:1", "cuda:1")
    assert sh.choose_backend(["a"] * 4, sh.place_ranks(ranks)) == "gloo"


def test_one_rank_group_meets_in_its_own_store():
    import torch.distributed as dist
    try:
        backend, dev = sh.init_distributed(None, 1, 0, device="cpu")
        assert (backend, dev) == ("gloo", torch.device("cpu"))
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        m = sh.make_mesh((1,), ("clients",), "cpu")
        assert m.backend == "gloo" and not m.capturable
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- the shard holder and the model group's collectives (2-D route) ----------

def _holder_rank(rank):
    """On a (1, 2) clients x model mesh: gather, the gathered leaf's
    gradient, copy_to_model / reduce_from_model and their gradients, the
    maximum, and the int8 wire's scales over the group."""
    from repro_torch.bridge import GroupedLayout
    from repro_torch.core.engine import CommChannel

    mesh = sh.client_model_mesh(1, 2, "cpu")
    group = mesh.group("model")
    gen = torch.Generator().manual_seed(0)
    full = torch.randn(6, 4, generator=gen)
    full[0, 0] = -0.0
    out = {}
    spec = (None, "model")
    local = sh.shard_of(full, spec, 2, rank)
    out["local_shape"] = tuple(local.shape) == sh.local_shape(full.shape,
                                                              spec, 2)
    whole = sh.gather(local.contiguous(), spec, group, 2, rank)
    out["gather_bits"] = torch.equal(whole.view(torch.int32),
                                     full.view(torch.int32))
    bf = full.to(torch.bfloat16)
    out["gather_bf16"] = torch.equal(sh.gather(
        sh.shard_of(bf, ("model", None), 2, rank).contiguous(),
        ("model", None), group, 2, rank), bf)
    # the gathered leaf's gradient is this rank's slice of the whole one
    shards = sh.ModelShards({("w",): spec}, {("w",): (6, 4)}, mesh)
    w = local.clone().requires_grad_()
    weight = torch.arange(24.0).reshape(6, 4)
    (shards.gather(("w",), w) * weight).sum().backward()
    out["gather_grad"] = torch.equal(w.grad, sh.shard_of(weight, spec, 2,
                                                         rank))
    # copy_to: identity forward, the gradients summed backward
    x = torch.ones(3, requires_grad=True)
    y = sh.copy_to_model(x, group)
    out["copy_fwd"] = y is not x and torch.equal(y, x)
    (y * (rank + 1.0)).sum().backward()
    out["copy_grad"] = x.grad.tolist()
    # reduce_from: the partial sums added in fp32, cast; identity backward
    p = torch.full((3,), 1.0 + rank, requires_grad=True)
    z = sh.reduce_from_model(p, group, torch.bfloat16)
    out["reduce_fwd"] = (z.dtype, z.tolist())
    (z.float() * 2.0).sum().backward()
    out["reduce_grad"] = p.grad.tolist()
    out["max"] = sh.max_over_model(torch.tensor([1.0 + rank, 5.0 - rank]),
                                   group).tolist()
    # the int8 wire of a leaf split over the ranks: the whole leaf's
    # scale, so each rank's part is the part of the whole leaf's wire
    tree = {"a": full * (1 + 9 * (rank == 1)), "b": torch.ones(2)}
    lay = GroupedLayout.of_tree({"a": local, "b": tree["b"]})
    mine = lay.pack({"a": sh.shard_of(tree["a"], spec, 2, rank)
                     .contiguous(), "b": tree["b"]})
    got = CommChannel("int8")._wire_flat(lay, mine, group)
    whole_a = sh.gather(sh.shard_of(tree["a"], spec, 2, rank).contiguous(),
                        spec, group, 2, rank)
    want = CommChannel("int8")._wire(whole_a)
    out["wire"] = torch.equal(lay.views(got)["a"],
                              sh.shard_of(want, spec, 2, rank))
    return out


def test_shard_holder_and_model_group_collectives(tmp_path):
    from repro_torch.runtime.ranks import run_ranks
    outs = run_ranks(_holder_rank, 2, str(tmp_path), device="cpu")
    for r in outs:
        for key in ("local_shape", "gather_bits", "gather_bf16",
                    "gather_grad", "copy_fwd", "wire"):
            assert r[key], key
        assert r["copy_grad"] == [3.0, 3.0, 3.0]
        assert r["reduce_fwd"] == (torch.bfloat16, [3.0, 3.0, 3.0])
        assert r["reduce_grad"] == [2.0, 2.0, 2.0]
        assert r["max"] == [2.0, 5.0]


def test_shard_holder_rules_and_refusals():
    assert sh.split_dim((None, "model", None)) == 1
    assert sh.split_dim((None, None)) is None
    assert sh.local_shape((8, 6), ("model", None), 2) == (4, 6)
    with pytest.raises(ValueError, match="'model' only"):
        sh.split_dim(("data", None))
    with pytest.raises(ValueError, match="more than one dim"):
        sh.split_dim(("model", "model"))
    full = np.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(sh.shard_of(full, (None, "model"), 2, 1),
                                  full[:, 2:])
    np.testing.assert_array_equal(
        sh.shard_of(full[None], (None, "model"), 2, 0, batch_dims=1),
        full[None, :, :2])
    m = sh.client_model_mesh(1, 1, "cpu")
    shards = sh.ModelShards.of(sh.DEFAULT_PARTITIONER,
                               {("embed",): (8, 4), ("final_norm",): (4,)},
                               m)
    assert shards.dim(("embed",)) == 0 and shards.dim(("final_norm",)) is None
    assert shards.local_shape(("embed",)) == (8, 4)      # model extent 1
    with pytest.raises(ValueError, match="needs 4 ranks"):
        sh.client_model_mesh(2, 2, "cpu")
