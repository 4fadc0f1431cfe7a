"""The port's sharding rules (`repro_torch.parallel.sharding`) against the
reference's (`repro.parallel.sharding`), with no devices: every leaf's
partition spec of params, AdamW state and decode caches, for all ten arches
x their shapes x both production meshes; the meta parameter tree against
`jax.eval_shape` of the reference's init; and `ParamSet.publish(rules=)`."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.parallel.sharding import make_rules as jax_make_rules  # noqa: E402
from repro_torch.bridge import param_shapes  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


class FakeMesh:
    """tests/test_infra.py's stand-in: axis names and sizes, no devices."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.shape = mesh.shape


MESHES = {"single": mesh_lib.make_production_mesh(),
          "multi": mesh_lib.make_production_mesh(multi_pod=True)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(jax_build_model(jreg.get_config(arch)).init,
                          jax.random.PRNGKey(0))


def _ref_specs(tree, spec_fn):
    """path -> str(spec) of every leaf, paths as the reference's
    `param_shardings` joins them."""
    out = {}

    def one(path, leaf):
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        out[p] = str(spec_fn(p, leaf.shape))
        return leaf

    jax.tree_util.tree_map_with_path(one, tree)
    return out


def _port_specs(tree, specs):
    out = {}

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (str(k),))
        elif isinstance(t, (tuple, list)):
            for i, (a, b) in enumerate(zip(t, s)):
                walk(a, b, path + (str(i),))
        else:
            assert isinstance(s, sharding.PartitionSpec)
            out["/".join(path)] = str(s)

    walk(tree, specs, ())
    return out


def test_partition_spec_prints_as_the_reference():
    from jax.sharding import PartitionSpec as JP
    for axes in [(), (None,), ("data", "model"), (None, ("pod", "data"), None),
                 ("model", None, "data")]:
        assert str(sharding.PartitionSpec(*axes)) == str(JP(*axes))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_equal_the_reference_for_every_leaf(arch):
    """Params, AdamW state and every cell's decode cache, on both
    production meshes: the same spec string for every leaf."""
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    ref_params = _ref_params(arch)
    ref_opt = jax.eval_shape(functools.partial(
        jax_adamw_init, state_dtype=jcfg.opt_state_dtype), ref_params)
    params = param_shapes(cfg)
    opt = adamw_init(params, cfg.opt_state_dtype)
    n_leaves = 0
    for mk, mesh in MESHES.items():
        for shape, jshape in zip(base.shapes_for(cfg),
                                 jbase.shapes_for(jcfg)):
            rules = sharding.make_rules(mesh, cfg, shape)
            jrules = jax_make_rules(FakeMesh(mesh), jcfg, jshape)
            got = _port_specs(params, rules.param_shardings(params))
            assert got == _ref_specs(ref_params, jrules._param_spec), \
                (arch, mk, shape.name)
            got = _port_specs(opt, rules.opt_shardings(opt))
            assert got == _ref_specs(ref_opt, jrules._param_spec), \
                (arch, mk, shape.name)
            n_leaves += len(got)
            if shape.kind != "decode":
                continue
            b, s = shape.global_batch, shape.seq_len
            ref_cache = jax.eval_shape(
                lambda: jax_build_model(jcfg).init_cache(b, s))
            cache = build_model(cfg).init_cache(b, s, device="meta")
            got = _port_specs(cache, rules.cache_shardings(cache))
            assert got == _ref_specs(ref_cache, jrules._cache_spec), \
                (arch, mk, shape.name)
            n_leaves += len(got)
    assert n_leaves > 0


def test_sharding_rules_divisibility_never_invalid():
    """The port of tests/test_infra.py's check: every spec divides the dim
    it shards (`shard_shape` raises otherwise), on both meshes."""
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        params = param_shapes(cfg)
        for mesh in MESHES.values():
            rules = sharding.make_rules(mesh, cfg, base.TRAIN_4K)
            specs = sharding.tree_leaves_specs(rules.param_shardings(params))
            for leaf, spec in zip(tree_leaves(params), specs):
                shard = sharding.shard_shape(tuple(leaf.shape), spec, mesh)
                for dim, axes, n in zip(leaf.shape, spec, shard):
                    assert n * sharding._axis_size(mesh, axes) == dim


def test_shard_shape_and_bytes_per_device():
    mesh = MESHES["multi"]
    P = sharding.PartitionSpec
    assert sharding.shard_shape((64, 32, 7), P(("pod", "data"), "model"),
                                mesh) == (2, 2, 7)
    with pytest.raises(ValueError):
        sharding.shard_shape((24,), P("model"), mesh)
    t = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    assert sharding.shard_bytes(t, P("data", None), mesh) == 4 * 32 * 2
    tree = {"a": t, "b": (torch.empty(16, dtype=torch.float32,
                                      device="meta"),)}
    specs = {"a": P(None, "model"), "b": (P(),)}
    assert sharding.bytes_per_device(tree, specs, mesh) == 64 * 2 * 2 + 64


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_meta_params_equal_reference_eval_shape(arch):
    """`param_shapes` (meta, no generator) against `jax.eval_shape` of the
    reference's init at full width: paths, shapes, dtypes; and n_params of
    every cell of the arch."""
    got = param_shapes(registry.get_config(arch))
    want = _ref_params(arch)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    flat_got = _ref_specs_shapes(got)
    flat_want = {}

    def one(path, leaf):
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        flat_want[p] = (tuple(leaf.shape), str(leaf.dtype))
        return leaf

    jax.tree_util.tree_map_with_path(one, want)
    assert flat_got == flat_want
    # every cell of the arch records this count (`dryrun.trace_cell`)
    from repro_torch.launch import dryrun
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    assert dryrun.n_params(registry.get_config(arch)) == n


def test_the_34_cells_are_the_reference_cells():
    got = [(a, s.name) for a, s in registry.all_cells()]
    want = [(a, s.name) for a in jreg.ARCH_IDS
            for s in jbase.shapes_for(jreg.get_config(a))]
    assert got == want and len(got) == 34


def _ref_specs_shapes(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (str(k),))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = (tuple(t.shape),
                                   str(t.dtype).removeprefix("torch."))

    walk(tree, ())
    return out


def test_paramset_publish_records_the_reference_specs():
    """`ParamSet.publish(rules=)` records each leaf's spec string where the
    reference's does, on both packages, for stablelm's smoke params."""
    from repro import compute as jax_compute
    from repro import core as jax_core
    from repro_torch import core
    from repro_torch.bridge import init_params
    from repro_torch.compute import ParamSet
    cfg = registry.get_smoke_config("stablelm-1.6b")
    jcfg = jreg.get_smoke_config("stablelm-1.6b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mesh = MESHES["single"]
    rules = sharding.make_rules(mesh, cfg, base.TRAIN_4K)
    jrules = jax_make_rules(FakeMesh(mesh), jcfg, jbase.TRAIN_4K)
    core.init(num_nodes=1, workers_per_node=1)
    try:
        ps = ParamSet.publish("lm", params, num_shards=2, rules=rules)
        got = {path: spec for path, *_, spec in ps.layout}
        plain = ParamSet.publish("plain", params)
        assert all(entry[-1] is None for entry in plain.layout)
    finally:
        core.shutdown()
    jax_core.init(num_nodes=1, workers_per_node=1)
    try:
        np_params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
            jax.random.PRNGKey(0)))
        jps = jax_compute.ParamSet.publish("lm", np_params, num_shards=2,
                                           rules=jrules)
        want = {path: spec for path, *_, spec in jps.layout}
    finally:
        jax_core.shutdown()
    assert got == want
    assert any(s and "model" in s for s in got.values())
