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


# ----------------------------------------------------- the executing rules

def _executing(arch, mesh_shape=(2, 2), smoke=True, seq_len=64,
               kind="train", **over):
    """The executing rules of rank 0 of `mesh_shape` (a `PlanComm`: no
    process group) for `arch`'s smoke (or full) config with `over`, at a
    step of `kind` (a train step by default) of 4 x `seq_len`."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.collectives import PlanComm
    cfg = (registry.get_smoke_config(arch) if smoke
           else registry.get_config(arch)).scaled(**over)
    mesh = Mesh(mesh_shape, ("data", "model"))
    return sharding.make_rules(mesh, cfg, base.ShapeConfig(
        "test", kind, seq_len, 4), comm=PlanComm(mesh))


def test_leaf_specs_resolve_by_path_not_by_name():
    """jamba's dense-FFN `w_gate` (2-D, column-parallel) and its MoE
    `w_gate` (3-D, experts over `model`) share a name; each layer's product
    gathers the block its own leaf's spec describes. Keyed by the last
    name, the first leaf of a name would answer for both."""
    rules = _executing("jamba-1.5-large-398b")
    P = sharding.P
    for path, spec, fsdp_dim in (
            ("groups/0/ffn/w_gate", P("data", "model"), 0),
            ("groups/1/ffn/w_gate", P("model", "data", None), 1),
            ("groups/0/ffn/w_down", P("model", "data"), 1),
            ("groups/1/ffn/w_down", P("model", None, "data"), 2),
            ("groups/0/mixer/x_proj", P("data", "model"), 0),
            ("groups/4/mixer/w_q", P("data", "model"), 0),
            ("embed/table", P("model", "data"), 1)):
        assert rules._leaf_spec(path) == spec, path
        assert rules._fsdp_dim(path) == (fsdp_dim, ("data",)), path
    scoped = rules.at("groups/1").at("ffn")
    assert scoped.gather_dim("w_gate") == (1, ("data",))
    assert scoped.at("shared", inner=True).inner
    # the router's gradient is summed over `model` without SP too; a norm's
    # scale then is not (each model rank holds the whole stream)
    assert not rules.sequence_parallel
    assert rules.sync_axes("groups/1/ffn/router") == ("data", "model")
    assert rules.sync_axes("groups/1/pre_norm/scale") == ("data",)


@pytest.mark.parametrize("arch, over", [
    ("mixtral-8x22b", {}),
    ("mixtral-8x22b", {"moe": base.MoEConfig(num_experts=3, top_k=2,
                                             d_ff_expert=256)}),
    ("jamba-1.5-large-398b", {})])
def test_the_executing_rules_run_mixtral_and_jamba(arch, over):
    rules = _executing(arch, **over)
    assert rules.executing


@pytest.mark.parametrize("arch, over", [
    ("deepseek-v2-236b", {}),
    ("xlstm-125m", {}),
    ("gemma3-12b", {})])
def test_the_executing_rules_run_mla_xlstm_and_the_tied_head(arch, over):
    rules = _executing(arch, **over)
    assert rules.executing


@pytest.mark.parametrize("arch, over", [
    ("seamless-m4t-medium", {}),
    ("internvl2-2b", {}),
    ("internvl2-2b", {"mesh_shape": (1, 4)}),
    # the chunked loss (vocab >= Model.CHUNKED_LOSS_VOCAB, S > 1024) over
    # an untied head
    ("stablelm-1.6b", {"vocab_size": 131_072, "seq_len": 2048}),
    ("seamless-m4t-medium", {"seq_len": 2048, "smoke": False})])
def test_the_executing_rules_run_the_encoder_decoder_and_image_inputs(
        arch, over):
    rules = _executing(arch, **over)
    assert rules.executing


@pytest.mark.parametrize("arch, kind", [
    ("seamless-m4t-medium", "single"), ("seamless-m4t-medium", "multi"),
    ("internvl2-2b", "single"), ("internvl2-2b", "multi")])
def test_the_production_plans_of_seamless_and_internvl2_execute(arch, kind):
    """Both train cells run as rank 0 runs them: seamless's untied head
    of 256,512 padded entries under the chunked loss at 4096 positions,
    16,032 columns a rank; internvl2's 256 image rows exactly rank 0's
    block of the sequence over model = 16."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model, padded_vocab
    from repro_torch.parallel.collectives import PlanComm
    cfg = registry.get_config(arch)
    mesh = MESHES[kind]
    shape = next(s for s in base.shapes_for(cfg) if s.kind == "train")
    assert dryrun.executes(sharding.make_rules(mesh, cfg, shape))
    rules = sharding.make_rules(mesh, cfg, shape, comm=PlanComm(mesh))
    assert rules.sequence_parallel
    if arch == "seamless-m4t-medium":
        assert padded_vocab(cfg) >= Model.CHUNKED_LOSS_VOCAB
        assert not cfg.tie_embeddings
        assert rules._leaf_spec("lm_head")[1] == "model"
        assert padded_vocab(cfg) // rules.tp_size == 16_032
    else:
        assert shape.seq_len // rules.tp_size == cfg.num_image_tokens


@pytest.mark.parametrize("arch, over, item", [
    ("internvl2-2b", {"kind": "prefill"}, "a prefill step"),
    ("seamless-m4t-medium", {"kind": "decode"}, "a decode step")])
def test_the_executing_rules_name_what_they_do_not_run(arch, over, item):
    with pytest.raises(NotImplementedError, match="ROADMAP A18") as err:
        _executing(arch, **over)
    assert item in str(err.value)


@pytest.mark.parametrize("arch, mesh_shape", [
    ("stablelm-1.6b", (4, 1)), ("seamless-m4t-medium", (2, 2))])
def test_the_executing_rules_run_softcapping(arch, mesh_shape):
    """Attention logit softcapping runs over many ranks: a rank's local
    heads take the softcap as they are (the flash kernels carry it), so
    the executing rules accept it, at the production plan's widths too."""
    from repro_torch.launch import dryrun
    rules = _executing(arch, mesh_shape, attn_logit_softcap=50.0)
    assert rules.cfg.attn_logit_softcap == 50.0
    full = _executing(arch, mesh_shape, smoke=False, seq_len=4096,
                      attn_logit_softcap=50.0)
    assert dryrun.executes(full)


@pytest.mark.parametrize("arch, over", [
    ("mixtral-8x22b", {"moe": base.MoEConfig(num_experts=4, top_k=2,
                                             d_ff_expert=256,
                                             dispatch="ragged")}),
    ("mixtral-8x22b", {"mesh_shape": (1, 4),
                       "moe": base.MoEConfig(num_experts=4, top_k=2,
                                             d_ff_expert=256,
                                             dispatch="ragged")}),
    ("jamba-1.5-large-398b", {"sequence_parallel": True})])
def test_the_executing_rules_run_ragged_dispatch_and_mamba_under_sp(
        arch, over):
    """The ragged dispatch (expert parallel over (2, 2) and (1, 4)) and
    Mamba under sequence parallelism pass `check_executable`: a Mamba
    mixer takes the whole sequence (`enter`), so no scan passes its state
    between ranks, and under SP every leaf `model` does not split sums
    its gradient over `model`."""
    rules = _executing(arch, **over)
    sharding.check_executable(rules)
    assert rules.executing
    if arch.startswith("jamba"):
        assert rules.sequence_parallel
        for leaf in ("groups/0/pre_norm/scale", "final_norm/scale",
                     "groups/1/mixer/x_proj", "groups/1/post_norm/scale"):
            assert "model" in rules.sync_axes(leaf) or "model" in \
                sharding._flat_axes(rules._leaf_spec(leaf)[-1]), leaf


def _compressing_run(rules, how):
    """Rank 0's compressing step under `rules` on `meta` (a `PlanComm`: its
    collectives move nothing), under the dry run's cost trace (the kernels
    record their cost there), from blocks of the params' shapes and the
    rank's rows of the cell's inputs: the reference's
    `make_compressing_train_step`, or `make_train_step` with a hook that
    compresses the rank's blocks (`compress_grads(..., rules=)`). Returns
    (the residual, the blocks, the shapes `quantize_int8` took)."""
    from repro_torch.analysis.trace import Trace
    from repro_torch.bridge import param_shapes
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import compression
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_map
    model = build_model(rules.cfg, rules)
    blocks = tree_map(lambda t, s: torch.empty(
        sharding.shard_shape(t.shape, s, rules.mesh), dtype=t.dtype,
        device="meta"), param_shapes(rules.cfg), rules.param_specs())
    efb = compression.init_error_feedback(blocks)
    batch = rules.local_batch(model.input_specs(rules.shape))
    seen, real = [], compression.quantize_int8

    def quantize(x, top=None):
        seen.append(tuple(x.shape))
        return real(x, top)
    compression.quantize_int8 = quantize
    opt = adamw_init(blocks)
    try:
        with Trace(rules, args=(blocks, opt, batch)):
            if how == "make_compressing_train_step":
                _, _, efb, metrics = compression.make_compressing_train_step(
                    model, AdamWConfig())(blocks, opt, efb, batch)
            else:
                def hook(g):
                    g, hook.efb = compression.compress_grads(g, efb,
                                                             rules=rules)
                    return g
                _, _, metrics = make_train_step(
                    model, AdamWConfig(), grad_compression=hook)(
                        blocks, opt, batch)
                efb = hook.efb
    finally:
        compression.quantize_int8 = real
    assert "loss" in metrics and "grad_norm" in metrics
    return efb, blocks, seen


@pytest.mark.parametrize("how", ["make_train_step",
                                 "make_compressing_train_step"])
def test_int8_compression_runs_on_shards(how):
    """Both compressing steps build under executing rules and run rank 0's
    step of stablelm's smoke config over (2, 2): the residual comes back in
    fp32 blocks of the params' shapes; the reference's hook compresses
    every leaf, its step every leaf of 4096 elements and up, each scale
    one all-reduce (max) over the axes its leaf's spec splits."""
    from repro_torch.bridge import param_shapes
    rules = _executing("stablelm-1.6b")
    efb, blocks, seen = _compressing_run(rules, how)
    assert [tuple(e.shape) for e in tree_leaves(efb)] == \
        [tuple(b.shape) for b in tree_leaves(blocks)]
    assert all(e.dtype == torch.float32 for e in tree_leaves(efb))
    want = [tuple(b.shape) for b, w in zip(tree_leaves(blocks),
                                           tree_leaves(param_shapes(
                                               rules.cfg)))
            if how == "make_train_step" or w.numel() >= 4096]
    assert seen == want
    assert rules.comm.stats.snapshot()["all-reduce"] > 0


@pytest.mark.parametrize("arch, mesh_shape", [
    ("seamless-m4t-medium", (2, 4)), ("internvl2-2b", (2, 4))])
def test_int8_compression_runs_on_the_modal_configs(arch, mesh_shape):
    """The encoder-decoder and the image inputs take the compressing step
    over many ranks too, and its threshold counts a whole leaf's elements:
    over 8 ranks `frame_proj`'s or `img_proj`'s block holds fewer than
    4096, the whole leaf more, and it is compressed."""
    from repro_torch.bridge import param_shapes
    rules = _executing(arch, mesh_shape)
    sharding.check_executable(rules)
    _, blocks, seen = _compressing_run(rules,
                                       "make_compressing_train_step")
    name = "frame_proj" if arch.startswith("seamless") else "img_proj"
    whole, block = param_shapes(rules.cfg)[name], blocks[name]
    assert block.numel() < 4096 <= whole.numel()
    assert seen == [tuple(b.shape) for b, w in zip(
        tree_leaves(blocks), tree_leaves(param_shapes(rules.cfg)))
        if w.numel() >= 4096]
    assert tuple(block.shape) in seen


def test_the_per_head_leaves_sum_their_gradient_over_model():
    """Without SP (xlstm) a rank's xLSTM cells read only their heads'
    slices of the recurrence, the gate biases and the head norms: those
    gradients are summed over `model`; a block norm's scale, whole on
    every model rank, is not. MLA's latent norms feed only a rank's
    heads: summed over `model` with or without SP."""
    rules = _executing("xlstm-125m")
    assert not rules.sequence_parallel
    for leaf in ("groups/0/mixer/r_rec", "groups/0/mixer/b",
                 "groups/0/mixer/norm_scale", "groups/1/mixer/b_if",
                 "groups/1/mixer/norm_scale"):
        assert rules.sync_axes(leaf) == ("data", "model"), leaf
    for leaf in ("groups/0/pre_norm/scale", "final_norm/scale"):
        assert rules.sync_axes(leaf) == ("data",), leaf
    # gathered whole from its FSDP and model blocks: reduce-scattered back
    assert rules.sync_axes("groups/1/mixer/w_if") == ()
    mla = _executing("deepseek-v2-236b", sequence_parallel=False)
    for leaf in ("groups/0/mixer/q_norm/scale",
                 "groups/0/mixer/kv_norm/scale"):
        assert mla.sync_axes(leaf) == ("data", "model"), leaf
    assert mla.sync_axes("groups/0/pre_norm/scale") == ("data",)


def test_a_mesh_that_cuts_a_head_is_a_value_error():
    """An xLSTM cell's heads split over `model` or are cut over a multiple
    of them (the sLSTM's 4 of xlstm's config over 8 ranks); other counts
    are refused. MLA's latents must split over `model`."""
    assert _executing("xlstm-125m", (1, 8), num_heads=8,
                      num_kv_heads=8).executing
    with pytest.raises(ValueError, match="4 slstm heads over model=3"):
        _executing("xlstm-125m", (1, 3), num_heads=3, num_kv_heads=3)
    with pytest.raises(ValueError, match="w_kr not split over model"):
        _executing("deepseek-v2-236b", (1, 4), mla=base.MLAConfig(
            kv_lora_rank=32, q_lora_rank=48, rope_head_dim=2,
            nope_head_dim=32, v_head_dim=32))


def test_the_production_plans_of_mixtral_and_jamba_execute():
    """mixtral's 8 experts on model = 16 take the expert-internal TP
    fallback, jamba's 16 one expert a rank (expert parallel); the dry run
    traces both train cells as rank 0 runs them, on either plan."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel.collectives import PlanComm
    P = sharding.P
    want = {("mixtral-8x22b", "single"): P(None, "data", "model"),
            ("mixtral-8x22b", "multi"): P(None, ("pod", "data"), "model"),
            ("jamba-1.5-large-398b", "single"): P("model", "data", None),
            ("jamba-1.5-large-398b", "multi"): P("model", ("pod", "data"),
                                                 None)}
    for (arch, kind), spec in want.items():
        cfg = registry.get_config(arch)
        mesh = MESHES[kind]
        shape = next(s for s in base.shapes_for(cfg) if s.kind == "train")
        assert dryrun.executes(sharding.make_rules(mesh, cfg, shape))
        rules = sharding.make_rules(mesh, cfg, shape, comm=PlanComm(mesh))
        moe_layer = cfg.ffn_pattern.index(base.MOE)
        assert rules._leaf_spec(f"groups/{moe_layer}/ffn/w_gate") == spec
