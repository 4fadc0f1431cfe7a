"""The port's sharded train step over many ranks, on the CPU over gloo:
`launch.train.train` on a mesh of 4 ranks (`parallel.collectives.Comm`, the
reference's `ShardingRules` executing) against the port's single-process
step from the same weights and batches; each rank's collective bytes a step
against the dry run's (`launch.dryrun.trace_cell`) for the same mesh and
shape; the dry run's model of the plan against its trace of the executed
step where no remat recomputes; a sharded run's checkpoint against a
single-process run's files, gathered to rank 0, and every Comm closed;
`python -m torch.distributed.run` on the launcher. The cases hold the
executed plan's parts: query
heads cut over `model`, the int8 compressing step (its residual too),
Mamba under sequence parallelism and the ragged MoE dispatch.

The ranks are this file run as a script, one process each, with one CPU
thread, meeting through a `file://` rendezvous under the test's tmp_path
(no port); each writes its results for the tests to read. Every process
has a timeout and is killed at its end."""
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, BATCH, SEQ_LEN = 4, 2, 4, 32
# AdamW's default clip; the smoke steps' gradient norms are 11-13, so it
# scales every update
CLIP = 1.0
# fp32 throughout: sums over ranks and a rank's columns round in another
# order than the one-process step's (1e-7 seen), carried through two AdamW
# updates
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
# the error feedback residual, a share of its largest entry: an entry is
# its gradient's int8 rounding error, so it carries the gradient's own
# error (LEAF_TOL of the leaf's largest gradient), and the largest entry
# is half a quantization step, 1/254 of that gradient: 1e-4 of it is 2.5%
# of the residual's largest entry.
RESIDUAL_TOL = 5e-2
# Under int8 compression a gradient entry within its rounding error of the
# half-way point between two int8 levels takes either: that entry's
# residual then moves by a whole quantization step and its AdamW moments
# by a step's share. Two sums in other orders put 1 or 2 entries of a
# 65,536-entry leaf on another level; a leaf may hold this share of such
# entries past its tolerance. A scale taken over a rank's block instead of
# the whole leaf moves every entry of the blocks that lack the leaf's
# largest.
LEVEL_CHANGES = 1e-3
RANK_TIMEOUT_S = 180
# case -> (arch, mesh shape, axis names, config overrides)
CASES = {
    "fsdp (4, 1)": ("stablelm-1.6b", (4, 1), ("data", "model"), {}),
    "tp (1, 4), KV heads expanded": ("phi3-medium-14b", (1, 4),
                                     ("data", "model"), {}),
    "pod (2, 1, 2)": ("stablelm-1.6b", (2, 1, 2), ("pod", "data", "model"),
                      {}),
    "microbatch 2 (2, 2)": ("stablelm-1.6b", (2, 2), ("data", "model"),
                            {"train_microbatch": 2}),
    "no sequence parallel (2, 2)": ("stablelm-1.6b", (2, 2),
                                    ("data", "model"),
                                    {"sequence_parallel": False}),
    "dots remat, fsdp and tp (2, 2)": ("phi3-medium-14b", (2, 2),
                                       ("data", "model"), {}),
    "moe dropping, expert parallel, window (2, 2)": (
        "mixtral-8x22b", (2, 2), ("data", "model"),
        {"moe": {"dispatch": "dropping"}}),
    "moe 3 experts dense, expert-internal TP (2, 2)": (
        "mixtral-8x22b", (2, 2), ("data", "model"),
        {"moe": {"num_experts": 3}}),
    "moe shared expert, a dense first layer (1, 4)": (
        "mixtral-8x22b", (1, 4), ("data", "model"),
        {"moe": {"num_shared_experts": 1}, "first_k_dense": 1}),
    "mamba and moe, no sequence parallel (2, 2)": (
        "jamba-1.5-large-398b", (2, 2), ("data", "model"), {}),
    "mla and moe, sequence parallel (2, 2)": (
        "deepseek-v2-236b", (2, 2), ("data", "model"), {}),
    "mla, moe dropping with shared experts (1, 4)": (
        "deepseek-v2-236b", (1, 4), ("data", "model"),
        {"moe": {"dispatch": "dropping"}}),
    "xlstm cells, tied head (2, 2)": ("xlstm-125m", (2, 2),
                                      ("data", "model"), {}),
    "xlstm heads cut over model (1, 4)": (
        "xlstm-125m", (1, 4), ("data", "model"),
        {"xlstm": {"num_heads_slstm": 2}}),
    "tied head, windowed, KV heads gathered (1, 4)": (
        "gemma3-12b", (1, 4), ("data", "model"), {}),
    "encoder, cross-attention, frames (2, 2)": (
        "seamless-m4t-medium", (2, 2), ("data", "model"), {}),
    "image rows before the tokens (1, 4)": ("internvl2-2b", (1, 4),
                                            ("data", "model"), {}),
    # 10 heads of 32 over 4 ranks: 80 columns, 2.5 heads and half a KV
    # head a rank (phi3's 40 over 16 in small)
    "query heads cut over model (1, 4)": (
        "phi3-medium-14b", (1, 4), ("data", "model"),
        {"num_heads": 10, "num_kv_heads": 2, "head_dim": 32}),
    "int8 gradient compression (2, 2)": ("stablelm-1.6b", (2, 2),
                                         ("data", "model"),
                                         {"grad_compression": True}),
    "mamba under sequence parallel (2, 2)": (
        "jamba-1.5-large-398b", (2, 2), ("data", "model"),
        {"sequence_parallel": True}),
    "moe ragged, expert parallel (1, 4)": (
        "mixtral-8x22b", (1, 4), ("data", "model"),
        {"moe": {"dispatch": "ragged"}}),
    "moe ragged 3 experts, expert-internal TP (2, 2)": (
        "mixtral-8x22b", (2, 2), ("data", "model"),
        {"moe": {"dispatch": "ragged", "num_experts": 3}}),
}
CKPT_CASE = ("stablelm-1.6b", (2, 2), ("data", "model"))
# cases whose executed layout the plan's model does not describe: query
# heads cut over `model` gather their columns (`ShardingRules.q_heads`),
# which the plan leaves to the compiler's choice ("bshd" constrains only
# heads that split whole)
PLAN_LAYS_OUT_OTHERWISE = ("query heads cut over model (1, 4)",)
def _config(arch, over):
    """The smoke config with `over`; its "moe" and "xlstm" entries
    override fields of the config's MoE and xLSTM configs, and a
    "grad_compression" entry is the launcher's (`_compressing`)."""
    import dataclasses
    from repro_torch.launch.train import launch_config
    cfg = launch_config(arch, True)
    over = {k: v for k, v in over.items() if k != "grad_compression"}
    for sub in ("moe", "xlstm"):
        if sub in over:
            over[sub] = dataclasses.replace(getattr(cfg, sub), **over[sub])
    return cfg.scaled(**over)


def _compressing(over) -> bool:
    return bool(over.get("grad_compression"))


def _init(cfg):
    from repro_torch.bridge import init_params
    return init_params(cfg, torch.Generator().manual_seed(0))


def _saved(ckpt, state, specs=None):
    """`state` saved at step STEPS (AdamW returns a new step counter each
    step: `on_state` held the first)."""
    ckpt.save(STEPS, {"params": state["params"],
                      "opt": dict(state["opt"], step=torch.tensor(
                          STEPS, dtype=torch.int32))}, specs=specs)


# ----------------------------------------------------------------- a rank

def _rank(rank: int, work: Path) -> None:
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    from repro_torch.parallel import collectives
    from repro_torch.parallel.collectives import Comm
    from repro_torch.parallel.sharding import gather_tree, make_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    shape = ShapeConfig("test", "train", SEQ_LEN, BATCH)

    def run(cfg, mesh, ckpt_dir=None, compress=False):
        comm = Comm(mesh)
        held, per_step = {}, []

        def on_step(step, metrics):
            per_step.append(comm.stats.snapshot())
            comm.stats.reset()

        def on_state(p, o, *residual):
            held.update(params=p, opt=o, residual=residual)
        losses = train(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ_LEN,
                       device="cpu", params=_init(cfg), mesh=mesh, comm=comm,
                       log_every=STEPS, on_step=on_step, on_state=on_state,
                       grad_compression=compress)
        rules = make_rules(mesh, cfg, shape, comm)
        saved = None
        if ckpt_dir:
            comm.stats.reset()
            _saved(Checkpointer(ckpt_dir, comm=comm), held, specs={
                "params": rules.param_specs(),
                "opt": rules.state_specs(held["opt"])})
            saved = comm.stats.snapshot()
        state = {"params": gather_tree(held["params"], rules.param_specs(),
                                       comm),
                 "opt": gather_tree(held["opt"],
                                    rules.state_specs(held["opt"]), comm),
                 "residual": [gather_tree(e, rules.param_specs(), comm)
                              for e in held["residual"]]}
        comm.close()
        return {"losses": losses, "bytes": per_step, "saved": saved,
                "state": state if rank == 0 else None}

    out = {}
    for name, (arch, mesh_shape, axes, over) in CASES.items():
        out[name] = run(_config(arch, over), Mesh(mesh_shape, axes),
                        compress=_compressing(over))
    arch, mesh_shape, axes = CKPT_CASE
    out["checkpoint"] = run(_config(arch, {}), Mesh(mesh_shape, axes),
                            ckpt_dir=str(work / "ckpt_sharded"))
    out["registry"] = len(collectives._GROUPS)
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def _spawn_ranks(work: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} rc {p.returncode}:\n{logs[r]}"
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def ranks(work):
    """The 4 ranks' results of every case, from one launch."""
    return _spawn_ranks(work)


def _single(arch, over):
    """(losses, grad norms, final state) of the port's single-process
    step, from the same weights and batches."""
    from repro_torch.launch.train import train
    cfg = _config(arch, over)
    held, norms = {}, []

    def on_state(p, o, *residual):
        held.update(params=p, opt=o, residual=residual)
    losses = train(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ_LEN,
                   device="cpu", params=_init(cfg), log_every=STEPS,
                   on_step=lambda s, m: norms.append(float(m["grad_norm"])),
                   on_state=on_state, grad_compression=_compressing(over))
    return losses, norms, held


def _leaves_close(got, want, tol=LEAF_TOL, changed=0.0):
    """Every leaf within `tol` of its largest entry, but for at most a
    `changed` share of its entries (LEVEL_CHANGES)."""
    from repro_torch.tree import tree_leaves
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = float(w.float().abs().max()) or 1.0
        off = (g.float() - w.float()).abs() > tol * scale
        assert int(off.sum()) <= changed * off.numel()


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_single_process_step(ranks, case):
    arch, _, _, over = CASES[case]
    want, norms, held = _single(arch, over)
    assert min(norms) > CLIP            # the clip bites on every step
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"], want, rtol=LOSS_RTOL)
    changed = LEVEL_CHANGES if _compressing(over) else 0.0
    _leaves_close(ranks[0][case]["state"]["params"], held["params"])
    _leaves_close(ranks[0][case]["state"]["opt"]["m"], held["opt"]["m"],
                  changed=changed)
    # the error feedback residual, where the step compresses
    residual = ranks[0][case]["state"]["residual"]
    assert len(residual) == len(held["residual"]) == int(_compressing(over))
    for got, want in zip(residual, held["residual"]):
        _leaves_close(got, want, RESIDUAL_TOL, changed)


@pytest.mark.parametrize("case", list(CASES))
def test_collective_bytes_equal_the_dry_run(ranks, case):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import Mesh
    arch, mesh_shape, axes, over = CASES[case]
    cfg, mesh = _config(arch, over), Mesh(mesh_shape, axes)
    want = trace_cell(cfg, ShapeConfig("test", "train", SEQ_LEN, BATCH),
                      mesh)["collective_by_kind"]
    assert want                          # the plan moves something
    if _compressing(over):
        want["all-reduce"] += _scale_bytes(cfg, mesh)
    for r in ranks:
        for step in r[case]["bytes"]:
            assert step.keys() == want.keys()
            for kind, n in want.items():
                assert step[kind] == pytest.approx(n, rel=1e-12), kind


def _scale_bytes(cfg, mesh) -> float:
    """The ring-model bytes a step of the compressing step's scales: an
    fp32 all-reduce (max) of one element for each leaf of 4096 elements
    and up, over the axes of size above 1 its spec splits it over."""
    import math
    from repro_torch.bridge import param_shapes
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.analysis.trace import collective_transfer
    from repro_torch.parallel.sharding import leaf_specs, make_rules
    rules = make_rules(mesh, cfg, ShapeConfig("test", "train", SEQ_LEN,
                                              BATCH))
    total = 0.0
    for leaf, spec in leaf_specs(param_shapes(cfg), rules.param_specs()):
        n = math.prod(mesh.shape[a] for axes in spec if axes
                      for a in ((axes,) if isinstance(axes, str) else axes))
        if leaf.numel() >= 4096 and n > 1:
            total += collective_transfer("all-reduce", n, 4, 4)
    return total


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c not in PLAN_LAYS_OUT_OTHERWISE])
def test_without_remat_the_plan_model_is_the_executed_step(case,
                                                           monkeypatch):
    """The dry run traces a step the rules execute as rank 0 runs it
    (`collectives.PlanComm`); its model of the plan, which the steps the
    rules do not execute take (prefill, decode), moves the same bytes by
    kind wherever no remat recomputes (with one, the recompute's early
    stop ends at other points: see ROADMAP C) and it lays the step out as
    the rules do (PLAN_LAYS_OUT_OTHERWISE)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    arch, mesh_shape, axes, over = CASES[case]
    cfg = _config(arch, dict(over, remat_policy="full"))
    shape = ShapeConfig("test", "train", SEQ_LEN, BATCH)
    executed = dryrun.trace_cell(cfg, shape, Mesh(mesh_shape, axes))
    monkeypatch.setattr(dryrun, "executes", lambda rules: False)
    plan = dryrun.trace_cell(cfg, shape, Mesh(mesh_shape, axes))
    assert (executed["collectives_from"], plan["collectives_from"]) == \
        ("executed step", "plan")
    assert executed["collective_by_kind"] == plan["collective_by_kind"]


def test_sharded_checkpoint_is_the_single_process_layout(ranks, work,
                                                          tmp_path):
    """The files, keys, shapes and dtypes of a single-process run's
    checkpoint; the values the sharded run's gathered leaves, bit for
    bit."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _flatten
    _saved(Checkpointer(str(tmp_path / "one")), _single(CKPT_CASE[0], {})[2])
    sharded, one = work / "ckpt_sharded", tmp_path / "one"
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(one)) \
        == [f"step_{STEPS}"]
    sharded, one = sharded / f"step_{STEPS}", one / f"step_{STEPS}"
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(one))
    assert json.loads((sharded / "manifest.json").read_text()) == \
        json.loads((one / "manifest.json").read_text())
    arrays = np.load(sharded / "arrays.npz")
    flat = dict(_flatten(params_to_numpy(ranks[0]["checkpoint"]["state"])))
    flat["opt/step"] = np.array(STEPS, dtype=np.int32)
    assert sorted(arrays.files) == sorted(flat)
    for key, arr in flat.items():
        assert np.array_equal(arrays[key], arr), key


def test_checkpoint_gathers_to_rank_zero_and_comms_close(ranks):
    """A sharded save gathers each leaf to the rank that writes it (no
    all-gather: the other ranks hold no whole leaf), and every Comm a rank
    made, its own or the launcher's, has left `gathered_mm`'s registry."""
    for r in ranks:
        assert set(r["checkpoint"]["saved"]) == {"gather"}, r["checkpoint"]
        assert r["registry"] == 0


class _ThreadComm:
    """The model axis of `m` ranks as threads of one process: each
    collective hands this rank's tensor to the others at a barrier
    (`collectives.Comm`'s calls that the vocab-parallel loss makes)."""

    def __init__(self, mesh, rank, slots, barrier):
        self.mesh, self.rank, self.backend = mesh, rank, "threads"
        self.coords = {"data": 0, "model": rank}
        self._slots, self._barrier = slots, barrier

    def _all(self, x):
        self._slots[self.rank] = x
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got

    def size(self, axes):
        return self.mesh.shape["model"] if "model" in (axes or ()) else 1

    def index(self, axes):
        return self.rank if "model" in (axes or ()) else 0

    def all_reduce(self, x, axes, op="sum"):
        if self.size(axes) == 1:
            return x
        got = torch.stack(self._all(x))
        return got.amax(0) if op == "max" else got.sum(0)

    def all_gather(self, x, dim, axes):
        return x if self.size(axes) == 1 else torch.cat(self._all(x), dim)

    def reduce_scatter(self, x, dim, axes):
        if self.size(axes) == 1:
            return x
        return sum(self._all(x)).chunk(self.size(axes), dim)[self.rank]


def test_vocab_parallel_chunked_loss_equals_the_whole_vocabulary():
    """`Model._vocab_parallel_xent` on 4 model ranks (threads of this
    process, each with its rows of the tied table) against the
    whole-vocabulary loss of one model (`softmax_xent` over the padded
    logits): the summed parts, and each rank's gradients of the hidden
    states (summed) and of its head columns, fp32 to 1e-6. gemma3's smoke
    config at 2 x 2048 (two chunks), its vocabulary cut to 500 of 512
    padded entries so the last rank's columns hold pad entries, the
    softcap on."""
    import threading
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import softmax_xent
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import make_rules
    m, b, s = 4, 2, 2048
    cfg = _config("gemma3-12b", {"vocab_size": 500, "logit_softcap": 30.0})
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(b, s, cfg.d_model, generator=gen)
    head = torch.randn(512, cfg.d_model, generator=gen) * 0.3
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    # the whole-vocabulary loss, summed over the positions that predict
    hw, ww = h.clone().requires_grad_(), head.clone().requires_grad_()
    logits = torch.where(torch.arange(512) >= cfg.vocab_size, -1e30,
                         (hw @ ww.T).float())
    want = softmax_xent(logits[:, :-1], tokens[:, 1:],
                        logit_softcap=cfg.logit_softcap) * b * (s - 1)
    want.backward()
    want = want.detach()
    mesh = Mesh((1, m), ("data", "model"))
    slots, barrier = [None] * m, threading.Barrier(m)
    out, errors = [None] * m, []

    def rank(r):
        try:
            rules = make_rules(mesh, cfg, ShapeConfig("t", "train", s, b),
                               comm=_ThreadComm(mesh, r, slots, barrier))
            model = Model(cfg, rules)
            hr = h.clone().requires_grad_()
            block = head[r * 128:(r + 1) * 128].clone().requires_grad_()
            labels, mask = model._labels_and_mask({"tokens": tokens}, s)
            part = model._vocab_parallel_xent(hr, labels, mask, block)
            part.backward()
            out[r] = (part.detach(), hr.grad, block.grad)
        except BaseException as e:          # a failed rank breaks the rest
            errors.append(e)
            barrier.abort()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RANK_TIMEOUT_S)
    assert not errors, errors
    got = sum(o[0] for o in out)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for g, w in ((sum(o[1] for o in out), hw.grad),
                 (torch.cat([o[2] for o in out]), ww.grad)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("arch", [
    "stablelm-1.6b", "phi3-medium-14b", "mistral-large-123b",
    "mixtral-8x22b", "jamba-1.5-large-398b", "deepseek-v2-236b",
    "xlstm-125m", "gemma3-12b", "seamless-m4t-medium", "internvl2-2b"])
def test_blockwise_init_is_the_whole_draw_sharded(arch):
    """A rank that draws only its blocks (`init_params(..., keep=
    block_keeper(...))`, as `launch.train` draws them over many ranks)
    holds the blocks `shard_tree` cuts from the whole seeded tree, bit for
    bit, on every rank of (2, 2) and (1, 4) (query heads cut for phi3)."""
    from repro_torch.bridge import init_params
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.collectives import rank_coords
    from repro_torch.parallel.sharding import (block_keeper, make_rules,
                                               shard_tree)
    from repro_torch.tree import tree_leaves
    over = ({"num_heads": 10, "num_kv_heads": 2, "head_dim": 32}
            if arch.startswith("phi3") else {})
    cfg = _config(arch, over)
    whole = init_params(cfg, torch.Generator().manual_seed(7))
    for shape in ((2, 2), (1, 4)):
        mesh = Mesh(shape, ("data", "model"))
        specs = make_rules(mesh, cfg, ShapeConfig(
            "test", "train", SEQ_LEN, BATCH)).param_specs()
        for rank in range(mesh.size):
            coords = rank_coords(mesh, rank)
            want = shard_tree(whole, specs, mesh, coords)
            got = init_params(cfg, torch.Generator().manual_seed(7),
                              keep=block_keeper(specs, mesh, coords))
            pairs = list(zip(tree_leaves(got), tree_leaves(want)))
            assert len(pairs) == len(tree_leaves(whole))
            for g, w in pairs:
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_world_size_one_builds_no_rules(monkeypatch):
    """Without a process group the launcher is the one-card path: host
    mesh (1, 1), the model without rules."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    built = []
    real = launch_train.build_model
    monkeypatch.setattr(launch_train, "build_model",
                        lambda cfg, rules=None: built.append(rules)
                        or real(cfg, rules))
    assert mesh_lib.make_host_mesh().shape == {"data": 1, "model": 1}
    launch_train.train(_config("stablelm-1.6b", {}), steps=1, batch=2,
                       seq_len=16, device="cpu")
    assert built == [None]


def test_torch_distributed_run_prints_the_single_process_losses():
    from repro_torch.launch.train import launch_config, train
    want = train(launch_config("stablelm-1.6b", True), steps=STEPS,
                 batch=BATCH, seq_len=SEQ_LEN, device="cpu", log_every=STEPS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "stablelm-1.6b", "--smoke", "--steps", str(STEPS),
         "--batch", str(BATCH), "--seq-len", str(SEQ_LEN), "--device",
         "cpu"], env=env, capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("losses")]
    assert len(lines) == 1, out.stdout           # rank 0 prints
    np.testing.assert_allclose(json.loads(lines[0].split(" ", 1)[1]), want,
                               rtol=LOSS_RTOL)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), Path(sys.argv[2]))
