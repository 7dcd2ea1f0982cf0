"""The port's partition rules (``repro_torch.sharding``) and meshes against
the JAX package's: every parameter, batch and cache leaf of all ten archs
at their published widths gets the JAX ``PartitionSpec`` entry for entry,
on device-free meshes of 2x2, 2x2x2, 16x16 and 2x16x16 (JAX's
``AbstractMesh``, the port's ``launch.mesh.Mesh``); the dry run's
activation hints and the node placement too. Shapes only: the JAX trees
come from ``jax.eval_shape``, the port's are ``meta`` tensors."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from torch_jax_dryrun import jdry  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serve.steps import cache_specs as jcache_specs  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train import decentral as jdec  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.steps import cache_specs  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.rules import (P, local_shape,  # noqa: E402
                                        to_placements)
from repro_torch.train import decentral  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    sizes, names = MESHES[name]
    return jax.sharding.AbstractMesh(sizes, names), Mesh(sizes, names)


_PARAMS = {}


def params(arch):
    """(JAX eval_shape tree, the port's meta tree) of ``arch``'s published
    width, built once per module."""
    if arch not in _PARAMS:
        cfg = jget(arch).config
        jp = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
        with FakeTensorMode():
            tp = init_params(get(arch).config, torch.Generator().manual_seed(0),
                             device="cpu")
        tp = pytree.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), tp)
        _PARAMS[arch] = jp, tp
    return _PARAMS[arch]


def with_nodes(jp, tp, K):
    return (jax.tree.map(lambda s: jax.ShapeDtypeStruct((K,) + s.shape,
                                                        s.dtype), jp),
            pytree.tree_map(lambda t: torch.empty(
                (K,) + tuple(t.shape), dtype=t.dtype, device="meta"), tp))


def jax_specs(tree):
    """(path, spec entries) of every leaf of a JAX spec tree, by path (JAX
    flattens dicts in key order, torch in insertion order)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return sorted((jrules._path_str(p), tuple(s)) for p, s in flat)


def port_specs(tree):
    flat = pytree.tree_flatten_with_path(tree, is_leaf=rules._is_spec)[0]
    return sorted((rules._path_str(p), tuple(s)) for p, s in flat)


@pytest.fixture
def embed_data():
    """Sets both packages' ``_EMBED_DATA`` toggle; restores it after."""
    def set_(v):
        jrules._EMBED_DATA[0] = rules._EMBED_DATA[0] = v
    yield set_
    set_(True)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_pspecs_equal_reference(arch, mesh_name, embed_data):
    """Every parameter leaf, with and without the node axis, the arch's
    own train_mode's fsdp, ``_EMBED_DATA`` on and off."""
    jm, tm = meshes(mesh_name)
    spec = get(arch)
    fsdp = spec.train_mode == "fsdp_gt"
    jp, tp = params(arch)
    node_axes, K = dryrun._node_axes(spec, tm)
    assert (node_axes, K) == jdry._node_axes(jget(arch), jm)
    jpk, tpk = with_nodes(jp, tp, K)
    cfg, jcfg = spec.config, jget(arch).config
    for embed in (True, False):
        embed_data(embed)
        for node_axis, (j, t) in ((None, (jp, tp)),
                                  (node_axes, (jpk, tpk))):
            want = jax_specs(jrules.param_pspecs(jcfg, j, jm,
                                                 node_axis=node_axis,
                                                 fsdp=fsdp))
            got = port_specs(rules.param_pspecs(cfg, t, tm,
                                                node_axis=node_axis,
                                                fsdp=fsdp))
            assert got == want, (embed, node_axis)
            assert len(got) > 5


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_cache_pspecs_equal_reference(arch, mesh_name):
    """The trainer's step batch (node axis, and the data axis under
    fsdp_gt), the prefill batch and the decode cache at decode_32k (and
    long_500k's batch of 1 where the arch runs it)."""
    jm, tm = meshes(mesh_name)
    spec, jspec = get(arch), jget(arch)
    fsdp = spec.train_mode == "fsdp_gt"
    node_axes, K = dryrun._node_axes(spec, tm)
    batch_axes = ("data",) if fsdp else ()
    tc, jtc = decentral.TrainerConfig(), jdec.TrainerConfig()
    got = port_specs(rules.batch_pspecs(
        decentral.step_batch_specs(spec.config, tc, K, 32, 64), tm,
        node_axis=node_axes, batch_axes=batch_axes))
    want = jax_specs(jrules.batch_pspecs(
        jdec.step_batch_specs(jspec.config, jtc, K, 32, 64), jm,
        node_axis=node_axes, batch_axes=batch_axes))
    assert got == want
    serve_axes = tuple(a for a in ("pod", "data") if a in tm.axis_names)
    cfg = spec.config
    tb = {"tokens": torch.empty((32, 4096), dtype=torch.int32,
                                device="meta"),
          **dryrun._batch_extra_specs(cfg, 32, 4096)}
    jb = {"tokens": jax.ShapeDtypeStruct((32, 4096), jnp.int32),
          **jdry._batch_extra_specs(jspec.config, 32, 4096)}
    assert port_specs(rules.batch_pspecs(
        tb, tm, node_axis=None, batch_axes=serve_axes)) == jax_specs(
        jrules.batch_pspecs(jb, jm, node_axis=None, batch_axes=serve_axes))
    shapes = ["decode_32k"] + (["long_500k"] if spec.long_ctx != "skip"
                               else [])
    for name in shapes:
        shape = SHAPES[name]
        mcfg, jmcfg = spec.model_for_shape(name), jspec.model_for_shape(name)
        B = shape.global_batch
        cap = min(shape.seq_len, mcfg.window or shape.seq_len)
        if mcfg.family == "hybrid":
            cap = min(cap, max(mcfg.local_window, 1))
        want = jax_specs(jrules.cache_pspecs(jcache_specs(jmcfg, B, cap),
                                             jm, batch=B))
        got = port_specs(rules.cache_pspecs(cache_specs(mcfg, B, cap), tm,
                                            batch=B))
        assert got == want, name
        assert ("idx", ()) in got


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_hints_and_node_placement_equal_reference(mesh_name):
    jm, tm = meshes(mesh_name)
    for arch in ARCHS:
        spec, jspec = get(arch), jget(arch)
        for serve in (False, True):
            want = {k: tuple(v) for k, v in jdry._activation_hints(
                jspec, jspec.config, jm, serve=serve).items()}
            got = {k: tuple(v) for k, v in dryrun._activation_hints(
                spec, spec.config, tm, serve=serve).items()}
            assert got == want, (arch, serve)
        assert decentral.n_nodes(spec, tm) == jdec.n_nodes(jspec, jm)
        assert decentral.node_axis_name(spec) == jdec.node_axis_name(jspec)


def test_meshes():
    m = make_production_mesh()
    assert (m.axis_names, m.shape, m.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    m = make_production_mesh(multi_pod=True)
    assert (list(m.shape.items()), m.size) == (
        [("pod", 2), ("data", 16), ("model", 16)], 512)
    assert make_debug_mesh(data=1, model=1).size == 1
    assert make_debug_mesh(multi_pod=True).shape == {"pod": 2, "data": 2,
                                                     "model": 2}
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data", "data"))


def test_partition_spec_normalises_as_jax_does():
    for entries in [(("data",), None), ((), "model"), (("pod", "data"),),
                    ()]:
        assert tuple(P(*entries)) == tuple(
            jax.sharding.PartitionSpec(*entries))


def test_placements_and_local_shape():
    m = Mesh((2, 4, 8), ("pod", "data", "model"))
    spec = P(("pod", "data"), None, "model")
    assert to_placements(spec, m) == (Shard(0), Shard(0), Shard(2))
    assert to_placements({"a": P(None, "data")}, m) == {
        "a": (Replicate(), Shard(1), Replicate())}
    assert local_shape((16, 3, 64, 5), spec, m) == (2, 3, 8, 5)
    assert local_shape((7,), P(None), m) == (7,)
    with pytest.raises(ValueError):
        local_shape((6, 8), P("data", "model"), m)
