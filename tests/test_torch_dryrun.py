"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU: records of
every kind on the host mesh and both production plans, the CLI and its
cache, state bytes and kernel calls at world size 1 against the step the
CPU runs, a full-width cell without a card, and the model under rules
(nothing changes at world size 1; KV expanded for a model axis that divides
H but not Kv gives the same logits)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K,  # noqa: E402
                                      TRAIN_4K, ShapeConfig)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.parallel.sharding import make_rules  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# the reference's record keys whose meaning carries over
KEYS = ("n_params", "hlo_flops", "hlo_dot_flops", "hlo_bytes",
        "collective_bytes_total", "collective_bytes_dcn",
        "collective_by_kind", "unknown_trip_loops", "arg_bytes_per_dev",
        "out_bytes_per_dev", "temp_bytes_per_dev", "alias_bytes_per_dev",
        "hbm_per_dev_gb", "fits_80gb")
SMOKE_SHAPES = (ShapeConfig("t", "train", 64, 4),
                ShapeConfig("p", "prefill", 64, 2),
                ShapeConfig("d", "decode", 64, 2))


MESHES = {"host": make_host_mesh(), "single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m",
                                  "deepseek-v2-236b", "seamless-m4t-medium"])
def test_records_of_every_kind_and_mesh(arch):
    cfg = registry.get_smoke_config(arch)
    for shape in SMOKE_SHAPES:
        for mk, mesh in MESHES.items():
            rec = dryrun.trace_cell(cfg, shape, mesh)
            assert all(k in rec for k in KEYS)
            assert "fits_16gb" not in rec and "xla_flops" not in rec
            assert rec["unknown_trip_loops"] == 0
            assert rec["hlo_dot_flops"] > 0 and rec["fits_80gb"]
            if mk == "host":
                assert rec["collective_bytes_total"] == 0
                assert rec["divisor"] == 1
            else:
                assert rec["collective_by_kind"]["all-gather"] > 0
                # the 16-wide model axis leaves an 8-card node
                assert rec["collective_bytes_off_node"] > 0
            if mk == "multi" and shape.kind == "train" \
                    and not cfg.fsdp_over_pod:
                # params replicated over `pod`: their gradients' all-reduce
                assert rec["collective_bytes_dcn"] > 0
            if shape.kind == "train":
                assert rec["alias_bytes_per_dev"] == \
                    rec["state_bytes_per_dev"]
    assert not torch.cuda.is_initialized()


def test_state_bytes_and_kernel_calls_at_world_size_one(monkeypatch):
    """The host mesh: the state's bytes are those of the params and AdamW
    state the launcher builds, exactly; each kernel's calls in the traced
    step are the calls the same step makes on the CPU (counted by wrapping
    the wrappers the model calls), flash's backward ("flash_attention_bwd")
    as the gradients that reach a flash output (once a layer, whatever the
    remat recomputes)."""
    for arch in ("jamba-1.5-large-398b", "xlstm-125m", "stablelm-1.6b"):
        cfg = registry.get_smoke_config(arch).scaled(train_microbatch=0)
        shape = ShapeConfig("t", "train", 32, 2)
        rec = dryrun.trace_cell(cfg, shape, make_host_mesh())
        params = init_params(cfg, torch.Generator().manual_seed(0))
        opt = adamw_init(params, cfg.opt_state_dtype)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves(params) + tree_leaves(opt))
        assert rec["state_bytes"] == rec["state_bytes_per_dev"] == held
        calls = {}

        def bump(name):
            calls[name] = calls.get(name, 0) + 1

        def counting(name, fn):
            def wrapped(*a, **k):
                bump(name)
                out = fn(*a, **k)
                if name == "flash_attention" and out.requires_grad:
                    out.register_hook(lambda g: bump("flash_attention_bwd"))
                return out
            return wrapped

        with monkeypatch.context() as m:
            for mod, name in ((attention, "flash_attention"),
                              (xlstm, "mlstm_scan"), (ssm, "ssm_scan")):
                m.setattr(mod, name, counting(name, getattr(mod, name)))
            from repro_torch.launch.train import train
            train(cfg, steps=1, batch=2, seq_len=32, device="cpu",
                  params=params, log_every=1)
        assert {k: v["calls"] for k, v in rec["kernel_calls"].items()} == \
            calls, arch


@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_the_trace_records_the_flash_backward(softcap):
    """On `meta` under the trace, a flash call that needs gradients records
    its forward ("flash_attention", `cost`) and, when the gradient reaches
    it, one backward ("flash_attention_bwd", `bwd_cost`, softcap's tanh in
    its exps); the gradients come back empty in the inputs' shapes, and
    nothing launches."""
    from repro_torch.analysis import trace
    from repro_torch.kernels.flash_attention import ops
    q = torch.empty(2, 8, 64, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k, v = (torch.empty(2, 2, 96, 64, device="meta", dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    before = (ops.flash_attention.launches, ops.flash_attention.bwd_launches)

    def step():
        out = ops.flash_attention(q, k, v, window=16, softcap=softcap)
        return torch.autograd.grad(out.float().sum(), (q, k, v))
    res, grads = trace.analyze_trace(step)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    mask = {"causal": True, "window": 16, "softcap": softcap}
    fwd, bwd = ops.cost(q, k, v, **mask), ops.bwd_cost(q, k, v, **mask)
    pairs = 2 * 8 * ops.valid_pairs(64, 96, True, 16)
    assert bwd.flops == 2 * pairs * (3 * 64 + 2 * 64)
    # q, out, dout, dq and k, v, dk, dv in bf16; lse and delta in fp32
    assert bwd.bytes == 2 * (4 * 2 * 8 * 64 * 64 + 4 * 2 * 2 * 96 * 64) \
        + 4 * 2 * 2 * 8 * 64
    assert fwd.exps == bwd.exps == (pairs if softcap else 0)
    for name, c in (("flash_attention", fwd), ("flash_attention_bwd", bwd)):
        call = res.kernels[name]
        assert (call.calls, call.flops, call.bytes, call.exps) == (
            1, c.flops, c.bytes, c.exps), name
    assert (ops.flash_attention.launches,
            ops.flash_attention.bwd_launches) == before


def test_cli_writes_one_record_a_cell_and_skips_cached(tmp_path, monkeypatch,
                                                       capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    argv = ["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--mesh",
            "both"]
    assert dryrun.main(argv) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["stablelm-1.6b__decode_32k__multi__baseline.json",
                     "stablelm-1.6b__decode_32k__single__baseline.json"]
    rec = json.loads((tmp_path / files[1]).read_text())
    assert rec["ok"] and rec["devices"] == 256
    assert rec["n_params"] == 1_644_267_520
    assert dryrun.main(argv) == 0
    assert "[skip]" in capsys.readouterr().out
    assert dryrun.main(argv + ["--force", "--tag", "x"]) == 0
    assert len(list(tmp_path.iterdir())) == 4
    capsys.readouterr()
    assert dryrun.main(["--table"]) == 0
    row = next(line for line in capsys.readouterr().out.splitlines()
               if line.startswith("| stablelm-1.6b |"))
    cells = row.strip("| ").split(" | ")
    assert cells[1:3] == ["-", "-"] and cells[4] == "-"
    assert f"{rec['hbm_per_dev_gb']:.3g} / " in cells[3]


def test_full_width_cell_without_a_card():
    """gemma3-12b decode_32k on the single-pod plan: 128 sequences over
    16 data shards, a 32k cache, no device."""
    rec = dryrun.run_cell("gemma3-12b", DECODE_32K, "single")
    assert rec["ok"], rec.get("traceback")
    assert rec["batch_per_device"] == 8 and rec["divisor"] == 16
    assert rec["n_params"] == 11_765_395_200
    assert not rec["cuda_initialized"] and not torch.cuda.is_initialized()
    assert 0 < rec["hbm_per_dev_gb"] < 80


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-2b"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_modal_train_cells_trace_the_executed_step(arch, mesh):
    """seamless's and internvl2's train cells are traced as rank 0 runs
    the executed step (its blocks, its collectives, `divisor` 1), without
    a card."""
    rec = dryrun.run_cell(arch, TRAIN_4K, mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["collectives_from"] == "executed step"
    assert rec["divisor"] == 1 and rec["fits_80gb"]
    assert rec["collective_by_kind"]["all-gather"] > 0
    assert not rec["cuda_initialized"] and not torch.cuda.is_initialized()


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_phi3_train_cells_trace_the_executed_step(mesh):
    """phi3's 40 heads over model = 16 split their columns, 320 a rank
    (2.5 heads): its train cells are traced as rank 0 runs the executed
    step, flash on the 3 whole heads its columns reach into, and fit a
    card."""
    from repro_torch.parallel.collectives import PlanComm
    cfg = registry.get_config("phi3-medium-14b")
    plan = make_production_mesh(multi_pod=mesh == "multi")
    assert dryrun.executes(make_rules(plan, cfg, TRAIN_4K))
    rank0 = make_rules(plan, cfg, TRAIN_4K, comm=PlanComm(plan))
    assert rank0.heads_cut and rank0.head_span() == (0, 3)
    rec = dryrun.run_cell("phi3-medium-14b", TRAIN_4K, mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["collectives_from"] == "executed step"
    assert rec["divisor"] == 1 and rec["fits_80gb"]
    assert rec["collective_by_kind"]["all-gather"] > 0
    assert not rec["cuda_initialized"] and not torch.cuda.is_initialized()


def test_a_failed_cell_is_recorded_with_its_error():
    """A shape the card's kernel refuses is refused by the trace too."""
    rec = dryrun.run_cell("stablelm-1.6b", PREFILL_32K, "single",
                          opt_overrides={"head_dim": 320})
    assert not rec["ok"] and "head_dim 320" in rec["error"]
    assert "traceback" in rec and rec["total_s"] >= 0


def _logits(cfg, rules, params, tokens):
    with torch.no_grad():
        return build_model(cfg, rules).forward(params, {"tokens": tokens})[0]


def test_model_under_rules():
    """World size 1: the same logits bit for bit as without rules. A model
    axis of 4 over mixtral smoke's 4 query heads and 2 KV heads expands KV
    to 4 heads (`_group_for_tp`): the same logits to fp32 rounding."""
    cfg = registry.get_smoke_config("mixtral-8x22b").scaled(
        param_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    plain = _logits(cfg, None, params, tokens)
    host = make_rules(make_host_mesh(), cfg, SMOKE_SHAPES[1])
    assert torch.equal(_logits(cfg, host, params, tokens), plain)
    tp4 = make_rules(Mesh((1, 4), ("data", "model")), cfg, SMOKE_SHAPES[1])
    assert build_model(cfg, tp4)._attn_tp()[0]
    torch.testing.assert_close(_logits(cfg, tp4, params, tokens), plain,
                               rtol=1e-5, atol=1e-5)
