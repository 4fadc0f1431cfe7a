"""The port's cost trace on `meta` (`repro_torch.analysis.trace`) against
what it counts by hand and against the reference's `analyze_hlo` of XLA's
program: loops and products, the ring model, each kernel wrapper on
`meta`, the sLSTM loop folded, one-device dot FLOPs of decode, prefill and
a train step, and the (2, 2, 2) decode cells' argument and all-gather
bytes (8 host devices in a subprocess, as tests/test_dryrun.py runs
them)."""
import json
import os
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import hlo  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.analysis import trace  # noqa: E402
from repro_torch.bridge import param_shapes  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.cost import KernelCost, valid_pairs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.train_step import (make_train_step,  # noqa: E402
                                          value_and_grad)

ROOT = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_a_loop_of_matmuls_counts_each_and_a_product_exactly():
    a, b = meta(64, 48), meta(48, 32)
    one, _ = trace.analyze_trace(lambda: a @ b)
    assert one.dot_flops == 2 * 64 * 48 * 32 == one.flops
    assert one.hbm_bytes == 4 * (64 * 48 + 48 * 32 + 64 * 32)

    def loop():
        x = a
        for _ in range(8):
            x = (x @ b) @ b.T
        return x

    eight, _ = trace.analyze_trace(loop)
    assert eight.dot_flops == 8 * (2 * 64 * 48 * 32 + 2 * 64 * 32 * 48)
    x, w = meta(3, 5, 7), meta(3, 7, 2)
    bmm, _ = trace.analyze_trace(torch.bmm, x, w)
    assert bmm.dot_flops == 2 * 3 * 5 * 7 * 2
    assert trace.TraceAnalysis().unknown_trip_loops == 0
    # views move nothing; an elementwise op counts one a result element
    ew, _ = trace.analyze_trace(lambda: (a.reshape(-1)[None].T + 1.0))
    assert ew.flops == 64 * 48 and ew.ops == 1


def test_peak_counts_live_temporaries_not_arguments():
    x = meta(1000, 1000)

    def f():
        y = x * 2          # 4 MB live
        z = y * 2          # 8 MB
        del y
        w = z * 2          # 8 MB again
        return w

    res, _ = trace.analyze_trace(f)
    assert res.peak_bytes == 8_000_000


@pytest.mark.parametrize("op,n,inb,outb,want", [
    ("all-reduce", 4, 1000, 1000, 1500.0),
    ("all-gather", 4, 250, 1000, 750.0),
    ("reduce-scatter", 8, 800, 100, 700.0),
    ("all-to-all", 2, 600, 600, 300.0),
    ("collective-permute", 8, 16, 16, 16.0),
    ("all-reduce", 1, 1000, 1000, 0.0),
])
def test_ring_model_bytes_equal_the_reference(op, n, inb, outb, want):
    assert trace.collective_transfer(op, n, inb, outb) == want == \
        hlo._collective_transfer(op, n, inb, outb)


def test_off_node_groups_of_the_production_mesh():
    multi = Mesh((2, 16, 16), ("pod", "data", "model"))
    assert trace._off_node(multi, ("model",), 8)     # 16 cards: two nodes
    assert trace._off_node(multi, ("data",), 8)
    assert not trace._off_node(Mesh((4, 8), ("data", "model")),
                               ("model",), 8)
    assert not trace._off_node(Mesh((2, 2, 2), ("pod", "data", "model")),
                               ("pod", "data", "model"), 8)


def _recorded(fn):
    res, out = trace.analyze_trace(fn)
    return res.kernels, out


def test_flash_wrapper_on_meta_records_its_cost():
    q = meta(2, 8, 64, 64, dtype=torch.bfloat16)
    k = meta(2, 2, 96, 64, dtype=torch.bfloat16)
    before = flash_ops.flash_attention.launches
    kernels, out = _recorded(lambda: flash_ops.flash_attention(
        q, k, k, causal=True, window=16))
    assert (out.shape, out.dtype, out.device.type) == (
        q.shape, q.dtype, "meta")
    assert out.transpose(1, 2).is_contiguous()        # the card's layout
    assert flash_ops.flash_attention.launches == before
    pairs = valid_pairs(64, 96, True, 16)
    want = KernelCost(4 * 2 * 8 * 64 * pairs,
                      2 * (2 * 8 * 64 * 64 * 2 + 2 * 2 * 96 * 64 * 2))
    assert flash_ops.cost(q, k, k, causal=True, window=16) == want
    call = kernels["flash_attention"]
    assert (call.calls, call.flops, call.bytes) == (1, want.flops, want.bytes)
    # MLA's values padded from 128 to 192: the cost counts 128 of them
    q = meta(1, 4, 32, 192)
    c = flash_ops.cost(q, q, q, causal=True, v_head_dim=128)
    assert c.flops == 2 * 4 * (192 + 128) * valid_pairs(32, 32, True, 0)


def test_meta_outside_a_trace_is_a_tensor_off_the_cpu(monkeypatch):
    """Without a trace a meta tensor goes to the launch, as the tests that
    stand it in for the card rely on (here the launch is stubbed)."""
    monkeypatch.setattr(flash_ops, "_launch",
                        lambda *a, **k: "launched")
    q = meta(1, 2, 8, 64)
    assert flash_ops.flash_attention(q, q, q) == "launched"


def test_flash_wrapper_on_meta_refuses_what_the_card_refuses():
    # head_dim 320 has no kernel; 48 is padded to 64 as on the card
    for bad in [(meta(1, 2, 8, 320), meta(1, 2, 8, 320)),
                (meta(1, 3, 8, 64), meta(1, 2, 8, 64)),
                (meta(1, 2, 8, 64, dtype=torch.float16),) * 2]:
        with pytest.raises((ValueError, TypeError)), trace.Trace():
            flash_ops.flash_attention(bad[0], bad[1], bad[1])
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_ops._check(meta(1, 2, 8, 48), meta(1, 2, 8, 48),
                         meta(1, 2, 8, 48), 0)
    kernels, out = _recorded(lambda: flash_ops.flash_attention(
        meta(1, 2, 8, 48), meta(1, 2, 8, 48), meta(1, 2, 8, 48)))
    assert out.shape == (1, 2, 8, 48)
    assert kernels["flash_attention"].bytes == flash_ops.cost(
        meta(1, 2, 8, 64), meta(1, 2, 8, 64), meta(1, 2, 8, 64)).bytes
    # a 16-byte misaligned bf16 row start, as the card refuses it
    x = meta(1, 2, 8, 72, dtype=torch.bfloat16)[..., 4:68]
    with pytest.raises(ValueError, match="alignment"), trace.Trace():
        flash_ops.flash_attention(x, x, x)


def test_mlstm_wrapper_on_meta():
    q = meta(2, 4, 100, 64, dtype=torch.bfloat16)
    g = meta(2, 4, 100)
    kernels, (y, (c, n, m)) = _recorded(
        lambda: mlstm_ops.mlstm_scan(q, q, q, g, g))
    assert (y.shape, y.dtype) == (q.shape, q.dtype)
    assert (c.shape, n.shape, m.shape) == ((2, 4, 64, 64), (2, 4, 64),
                                           (2, 4))
    pairs = 64 * 65 // 2 + 36 * 37 // 2
    want = KernelCost(2 * 4 * (4 * 64 * pairs + 4 * 100 * 64 * 64),
                      4 * q.numel() * 2 + 2 * 4 * 2 * 4 * 100
                      + 4 * 2 * 4 * (64 * 64 + 64 + 1))
    assert mlstm_ops.cost(q) == want
    assert kernels["mlstm_scan"].calls == 1
    assert kernels["mlstm_scan"].flops == want.flops
    # head_dim 48 is no kernel's and is not padded: refused, as on the card
    with pytest.raises(ValueError, match="head_dim 48"), trace.Trace():
        mlstm_ops.mlstm_scan(meta(1, 2, 8, 48), meta(1, 2, 8, 48),
                             meta(1, 2, 8, 48), meta(1, 2, 8), meta(1, 2, 8))


def test_ssm_wrapper_on_meta():
    b, s, di, ds = 2, 16, 64, 16
    x = meta(b, s, di, dtype=torch.bfloat16)
    dt, bt = meta(b, s, di), meta(b, s, ds)
    a, d = meta(di, ds), meta(di)
    kernels, (y, h) = _recorded(lambda: ssm_ops.ssm_scan(x, dt, bt, bt, a, d))
    assert (y.shape, y.dtype, h.shape, h.dtype) == (
        x.shape, x.dtype, (b, di, ds), torch.float32)
    updates = b * s * di * ds
    want = KernelCost(6 * updates + 2 * b * s * di,
                      2 * x.numel() * 2 + 4 * (dt.numel() + 2 * bt.numel()
                                               + a.numel() + d.numel())
                      + 4 * b * di * ds, updates)
    assert ssm_ops.cost(x, dt, bt, bt, a, d) == want
    assert (kernels["ssm_scan"].calls, kernels["ssm_scan"].exps) == (
        1, updates)
    with pytest.raises(ValueError, match="d_state 32"), trace.Trace():
        ssm_ops.ssm_scan(x, dt, meta(b, s, 32), meta(b, s, 32),
                         meta(di, 32), d)


def test_int8_wrapper_on_meta():
    x, wq = meta(16, 256, dtype=torch.bfloat16), meta(256, 96,
                                                       dtype=torch.int8)
    kernels, out = _recorded(lambda: int8_ops.int8_matmul(x, wq, meta(96)))
    assert (out.shape, out.dtype) == ((16, 96), torch.bfloat16)
    want = KernelCost(2 * 16 * 256 * 96, 16 * 256 * 2 + 256 * 96 + 4 * 96
                      + 16 * 96 * 2)
    assert int8_ops.cost(x, wq) == want
    assert kernels["int8_matmul"].flops == want.flops
    with pytest.raises(TypeError, match="int8"), trace.Trace():
        int8_ops.int8_matmul(x, meta(256, 96), meta(96))


def test_slstm_loop_folded_equals_the_full_trace():
    """xlstm smoke at S=8: the folded sLSTM loop (one step counted S times)
    against the unrolled one. A prefill counts the same FLOPs, bytes and
    peak; a train step's products differ by one step's gradient of the
    carry, which the unrolled first step does not take (its carry is the
    initial state): the folded step stands for a later one."""
    cfg = registry.get_smoke_config("xlstm-125m")
    model, params = build_model(cfg), param_shapes(cfg)
    s = 8
    tok = {"tokens": meta(2, s, dtype=torch.int32)}
    got = []
    for fold in (True, False):
        with torch.no_grad():
            pre, _ = trace.analyze_trace(model.prefill, params, tok, fold=fold)
        grad, _ = trace.analyze_trace(value_and_grad, model, params, tok,
                                      fold=fold)
        got.append((pre, grad))
    (pf, gf), (pu, gu) = got
    assert (pf.flops, pf.dot_flops, pf.hbm_bytes, pf.peak_bytes) == (
        pu.flops, pu.dot_flops, pu.hbm_bytes, pu.peak_bytes)
    assert pf.ops < pu.ops
    _, h, hd = cfg.xlstm.num_heads_slstm, cfg.xlstm.num_heads_slstm, \
        cfg.d_model // cfg.xlstm.num_heads_slstm
    carry_grad = 2 * 2 * h * hd * 4 * hd          # dh_prev of one step
    assert gf.dot_flops - gu.dot_flops == carry_grad
    assert abs(gf.flops - gu.flops) <= gu.flops / s
    assert gf.kernels["mlstm_scan"].calls == gu.kernels["mlstm_scan"].calls


def _port_dots(arch, kind, b, s):
    cfg = registry.get_smoke_config(arch).scaled(train_microbatch=0)
    model, params = build_model(cfg), param_shapes(cfg)
    if kind == "decode":
        cache = model.init_cache(b, s, device="meta")
        with torch.no_grad():
            res, _ = trace.analyze_trace(model.decode_step, params, cache,
                                         meta(b, 1, dtype=torch.int32), s - 1)
    elif kind == "prefill":
        with torch.no_grad():
            res, _ = trace.analyze_trace(model.prefill, params, {
                "tokens": meta(b, s, dtype=torch.int32)}, s)
    else:
        opt = adamw_init(params, cfg.opt_state_dtype)
        res, _ = trace.analyze_trace(
            make_train_step(model, AdamWConfig()), params, opt,
            {"tokens": meta(b, s, dtype=torch.int32)})
    return cfg, res


def _ref_dots(arch, kind, b, s):
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro.train.train_step import make_train_step as jmake
    cfg = jreg.get_smoke_config(arch).scaled(train_microbatch=0)
    model = jax_build_model(cfg)
    ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if kind == "decode":
        cs = jax.eval_shape(lambda: model.init_cache(b, s))
        low = jax.jit(model.decode_step).lower(
            ps, cs, jax.ShapeDtypeStruct((b, 1), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32))
    else:
        toks = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        if kind == "prefill":
            low = jax.jit(partial(model.prefill, max_seq=s)).lower(ps, toks)
        else:
            opt = jax.eval_shape(partial(
                jadamw_init, state_dtype=cfg.opt_state_dtype), ps)
            low = jax.jit(jmake(model, JAdamW())).lower(ps, opt, toks)
    return hlo.analyze_hlo(low.compile().as_text()).dot_flops


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mixtral-8x22b"])
def test_decode_dot_flops_equal_the_reference_one_device(arch):
    """Decode runs no kernel: every product is plain in both programs."""
    _, res = _port_dots(arch, "decode", 8, 64)
    assert not res.kernels
    want = _ref_dots(arch, "decode", 8, 64)
    assert abs(res.dot_flops - want) <= 0.01 * want, (res.dot_flops, want)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dot_flops_outside_the_kernels_equal_the_reference(kind):
    """stablelm smoke, 2 x 64 tokens, one device. The reference computes
    attention in plain products (below 2,048 positions `naive_sdpa`: the
    scores and the value product, each 2 B H S T hd over the whole S x T
    square, `u` below); the port's flash calls are the kernels', forward
    and backward. So the port's plain products equal the reference's less
    its attention products: 2 a layer in a prefill; in a train step 8 a
    layer (the forward, its recompute under remat "nothing", and the
    backward's 4), against none of the port's outside its kernels (a
    forward call a layer and its recompute, one backward call a layer)."""
    b, s = 2, 64
    cfg, res = _port_dots("stablelm-1.6b", kind, b, s)
    want = _ref_dots("stablelm-1.6b", kind, b, s)
    u = 2 * b * cfg.num_heads * s * s * cfg.head_dim
    layers = cfg.num_layers
    if kind == "prefill":
        got, ref = res.dot_flops, want - 2 * u * layers
    else:
        got, ref = res.dot_flops, want - 8 * u * layers
        assert res.kernels["flash_attention_bwd"].calls == layers
    assert res.kernels["flash_attention"].calls == layers * (
        1 if kind == "prefill" else 2)
    assert abs(got - ref) <= 0.01 * ref, (got, ref)


REF_222 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.models import build_model
    from repro.parallel.sharding import make_rules
    from repro.analysis.hlo import analyze_hlo
    out = {}
    for arch in ("stablelm-1.6b", "mixtral-8x22b"):
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        shape = ShapeConfig("t", "decode", 64, 8)
        cfg = get_smoke_config(arch).scaled(train_microbatch=0)
        rules = make_rules(mesh, cfg, shape)
        model = build_model(cfg, rules)
        specs = model.input_specs(shape)
        in_sh = rules.input_shardings(specs)
        ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        cs = jax.eval_shape(lambda: model.init_cache(8, 64))
        c_sh = rules.cache_shardings(cs)
        fn = jax.jit(model.decode_step,
                     in_shardings=(rules.param_shardings(ps), c_sh,
                                   in_sh["tokens"], rules.scalar_sharding()),
                     out_shardings=(None, c_sh))
        comp = fn.lower(ps, cs, specs["tokens"],
                        jax.ShapeDtypeStruct((), jnp.int32)).compile()
        out[arch] = {"args": comp.memory_analysis().argument_size_in_bytes,
                     "kinds": analyze_hlo(comp.as_text(),
                                          total_devices=8).by_kind()}
    print(json.dumps(out))
""")


def test_222_decode_cells_against_xla_plan():
    """The reference's (2, 2, 2) decode smoke cells (8 host devices, B=8,
    S=64): the port's arguments per device within 1% of XLA's
    `argument_size_in_bytes`, its all-gather bytes within 10% of XLA's.
    XLA's plan also moves a few hundred bytes by all-reduce, all-to-all and
    collective-permute that the port's plan does not model (ROADMAP C):
    printed beside the port's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", REF_222], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    for arch, want in ref.items():
        cfg = registry.get_smoke_config(arch).scaled(train_microbatch=0)
        got = dryrun.trace_cell(cfg, ShapeConfig("t", "decode", 64, 8), mesh)
        print(arch, "port", got["arg_bytes_per_dev"],
              got["collective_by_kind"], "reference", want)
        assert abs(got["arg_bytes_per_dev"] - want["args"]) <= \
            0.01 * want["args"]
        ag = want["kinds"]["all-gather"]
        assert abs(got["collective_by_kind"]["all-gather"] - ag) <= 0.1 * ag
