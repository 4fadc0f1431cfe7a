"""The port's training slice on the CPU against the JAX package: the data
pipeline copy, AdamW and the cosine schedule, the train step with and
without microbatches, and the `--sync` loop of `examples/train_lm.py`,
from the same JAX-initialized xlstm weights (smoke config, fp32); then
its task-graph mode against the `--sync` loop, also after a node loss."""
import importlib.util
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel processes on one host, where torch's default
# of a thread per core in each of them oversubscribes it
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import lm  # noqa: E402
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# AdamW alone, on the same fp32 grads: the same fp32 ops in one order.
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
# Losses of the model on either side: one algorithm summed in other orders.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# Params after training steps. The first AdamW steps move a weight by about
# lr * sign(g); where |g| is at the level of the two sides' rounding (a few
# 1e-7), its sign and so the move can differ. 2e-5 holds that at the lr of
# 3e-4 * cosine warm-up the train step runs with.
STEP_TOL = dict(rtol=1e-4, atol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _by_path(tree, path=()):
    """(path, leaf) pairs with dict keys sorted, JAX's order of leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _by_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _by_path(v, path + (i,))]
    return [(path, tree)]


def _close_trees(ttree, jtree, **tol):
    tl, jl = _by_path(ttree), _by_path(_np(jtree))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(tl, jl):
        assert tuple(a.shape) == b.shape, path
        _close(a, b, err_msg=str(path), **tol)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("cfg", [
    dict(vocab_size=50_304, seq_len=64, global_batch=8, num_shards=2,
         shard_id=1),
    dict(vocab_size=256, seq_len=16, global_batch=4, seed=7, zipf_a=1.5),
    dict(vocab_size=512, seq_len=8, global_batch=2, input_mode="frames",
         d_model=16),
    dict(vocab_size=512, seq_len=12, global_batch=2,
         input_mode="tokens+image", d_model=16, num_image_tokens=4),
])
def test_batch_for_step_equals_jax_bit_for_bit(cfg):
    for step in (0, 1, 17):
        want = jax_pipeline.batch_for_step(jax_pipeline.DataConfig(**cfg), step)
        got = pipeline.batch_for_step(pipeline.DataConfig(**cfg), step)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_prefetcher_yields_the_steps_in_order():
    cfg = pipeline.DataConfig(vocab_size=256, seq_len=8, global_batch=2)
    pf = pipeline.Prefetcher(cfg, start_step=3)
    try:
        for step in (3, 4, 5):
            np.testing.assert_array_equal(
                pf.next()["tokens"], pipeline.batch_for_step(cfg, step)["tokens"])
    finally:
        pf.close()


# ----------------------------------------------------------------- AdamW

def _tree(seed, scale):
    """A nested params-like tree: a dict with a tuple of dicts, fp32 leaves
    of several shapes."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s, dtype=np.float32) * scale)  # noqa: E731
    return {"a": r(4, 3), "groups": ({"w": r(2, 5, 3), "b": r(3)},
                                     {"w": r(2, 3)}), "s": r(7)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_and_cosine_match_jax_over_three_steps(state_dtype):
    """Grads with global norm far above `grad_clip` (clipping active), the
    schedule's warm-up scale, and moments kept in `state_dtype`."""
    cfg_kw = dict(lr=1e-2, grad_clip=0.5, state_dtype=state_dtype)
    jcfg, tcfg = jax_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    params = _tree(0, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    jst = jax_adamw.adamw_init(jp, state_dtype)
    tst = adamw.adamw_init(tp, state_dtype)
    for step in range(3):
        grads = _tree(10 + step, 3.0)
        jsc = jax_adamw.cosine_schedule(jst["step"], warmup=2, total=10)
        tsc = adamw.cosine_schedule(tst["step"], warmup=2, total=10)
        _close(tsc, jsc, **OPT_TOL)
        jp, jst, jm = jax.jit(jax_adamw.adamw_update, static_argnums=0)(
            jcfg, jax.tree.map(jnp.asarray, grads), jst, jp, jsc)
        tp, tst, tm = adamw.adamw_update(
            tcfg, params_from_numpy(grads, "cpu"), tst, tp, tsc)
        assert float(tm["grad_norm"]) > 10 * tcfg.grad_clip
        _close(tm["grad_norm"], jm["grad_norm"], **OPT_TOL)
        _close_trees(tp, jp, **OPT_TOL)
        for key in ("m", "v"):
            assert all(t.dtype == getattr(torch, state_dtype)
                       for t in tree_leaves(tst[key]))
            _close_trees(tst[key], jst[key], **OPT_TOL)
        assert int(tst["step"]) == int(jst["step"]) == step + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_a_chunk_at_a_time_equals_whole_leaves(monkeypatch, dtype):
    """The update and the norm in chunks of 4 elements (across leaf shapes
    of 3 to 30 elements) give the whole-leaf step: the same elementwise
    math, the norm's sum in another order (fp32 to 1e-6; bf16 params and
    moments to one bf16 ulp, 2^-8)."""
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2 ** -8, atol=2 ** -8)
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=0.5, state_dtype=dtype)
    dt = getattr(torch, dtype)
    out = []
    for chunk in (adamw.CHUNK, 4):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        tp = tree_map(lambda t: t.to(dt), params_from_numpy(_tree(0, 1.0),
                                                            "cpu"))
        st = adamw.adamw_init(tp, dtype)
        for step in range(2):
            grads = tree_map(lambda t: t.to(dt),
                             params_from_numpy(_tree(10 + step, 3.0), "cpu"))
            tp, st, m = adamw.adamw_update(cfg, grads, st, tp, 1.0)
        out.append((tp, st, m["grad_norm"]))
    (p0, s0, n0), (p1, s1, n1) = out
    torch.testing.assert_close(n1, n0, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves((p1, s1["m"], s1["v"])),
                    tree_leaves((p0, s0["m"], s0["v"]))):
        torch.testing.assert_close(a, b, **tol)


def test_adamw_updates_in_place():
    tp = params_from_numpy(_tree(0, 1.0), "cpu")
    before = [t.data_ptr() for t in tree_leaves(tp)]
    st = adamw.adamw_init(tp)
    out, st, _ = adamw.adamw_update(adamw.AdamWConfig(),
                                    params_from_numpy(_tree(1, 1.0), "cpu"),
                                    st, tp)
    assert out is tp and [t.data_ptr() for t in tree_leaves(out)] == before


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 5000, 10_000, 20_000])
def test_cosine_schedule_matches_jax(step):
    _close(adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32)),
           jax_adamw.cosine_schedule(jnp.int32(step)), **OPT_TOL)


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model), xlstm smoke
    fp32 with the JAX model's init."""
    jcfg = get_smoke_config("xlstm-125m").scaled(param_dtype="float32")
    tcfg = registry.get_smoke_config("xlstm-125m").scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    return (jcfg, jm, jax.jit(jm.init)(jax.random.PRNGKey(0)), tcfg,
            build_model(tcfg))


def _batch(cfg, step, b=4, s=16):
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                             global_batch=b)
    return pipeline.batch_for_step(dc, step)["tokens"]


@pytest.mark.parametrize("micro", [0, 2])
def test_make_train_step_matches_jax(pair, micro):
    """Two steps of fwd + bwd + clip + AdamW at the cosine `lr_scale`,
    without and with microbatch accumulation (2 microbatches of 2)."""
    jcfg, _, jp, tcfg, _ = pair
    jm = jax_build_model(jcfg.scaled(train_microbatch=micro))
    tm = build_model(tcfg.scaled(train_microbatch=micro))
    jstep = jax.jit(jax_make_train_step(jm, jax_adamw.AdamWConfig()))
    tstep = make_train_step(tm, adamw.AdamWConfig())
    tp = params_from_numpy(_np(jp), "cpu")
    jst, tst = jax_adamw.adamw_init(jp), adamw.adamw_init(tp)
    for step in range(2):
        tok = _batch(tcfg, step)
        jp, jst, jmet = jstep(jp, jst, {"tokens": jnp.asarray(tok)})
        tp, tst, tmet = tstep(tp, tst, {"tokens": torch.from_numpy(tok).long()})
        for key in ("loss", "xent", "grad_norm"):
            _close(tmet[key], jmet[key], **LOSS_TOL)
    _close_trees(tp, jp, **STEP_TOL)
    _close_trees(tst["m"], jst["m"], rtol=1e-3, atol=1e-6)


def test_eval_step_is_the_loss(pair):
    _, jm, jp, _, tm = pair
    tok = _batch(registry.get_smoke_config("xlstm-125m"), 5)
    tp = params_from_numpy(_np(jp), "cpu")
    got = make_eval_step(tm)(tp, {"tokens": torch.from_numpy(tok).long()})
    want, _ = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(tok)})
    assert not got["loss"].requires_grad
    _close(got["loss"], want, **LOSS_TOL)


def test_microbatch_must_divide_the_batch(pair):
    *_, tcfg, _ = pair
    tm = build_model(tcfg.scaled(train_microbatch=3))
    tp = params_from_numpy(_np(pair[2]), "cpu")
    with pytest.raises(ValueError, match="multiple of train_microbatch 3"):
        make_train_step(tm, adamw.AdamWConfig())(
            tp, adamw.adamw_init(tp),
            {"tokens": torch.from_numpy(_batch(tcfg, 0)).long()})


# ------------------------------------------------------------ train loop

def _jax_train_lm_example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_matches_the_jax_sync_loop(pair):
    """Three steps of `train_lm` (2 data shards, AdamW lr 1e-3, lr_scale 1)
    against `examples/train_lm.py`'s `--sync` step function, from the same
    init on the same `batch_for_step` data."""
    jcfg, jm, jp, tcfg, _ = pair
    batch, seq_len, shards = 4, 16, 2
    ex = _jax_train_lm_example()
    grad_shard, reduce_fn, apply_fn = ex.build_step_fns(
        jm, jax_adamw.AdamWConfig(lr=1e-3))
    step_fn = jax.jit(lambda p, o, *bs: (
        lambda lg: apply_fn(p, o, reduce_fn(*[g for _, g in lg]))
        + (sum(l for l, _ in lg) / len(lg),)
    )([grad_shard(p, b) for b in bs]))
    dc = jax_pipeline.DataConfig(vocab_size=jcfg.vocab_size, seq_len=seq_len,
                                 global_batch=batch, num_shards=shards)
    jst, jlosses = jax_adamw.adamw_init(jp), []
    for step in range(3):
        bs = [jax_pipeline.batch_for_step(
            jax_pipeline.DataConfig(**{**dc.__dict__, "shard_id": s}), step)
            for s in range(shards)]
        jp, jst, loss = step_fn(jp, jst, *bs)
        jlosses.append(float(loss))

    init = _by_path(_np(pair[2]))
    res = lm.train_lm(tcfg, 3, batch, seq_len, shards, "cpu",
                      params=params_from_numpy(_np(pair[2]), "cpu"), sync=True)
    np.testing.assert_allclose(res.losses, jlosses, **LOSS_TOL)
    assert len(res.step_ms) == 3 and int(res.opt_state["step"]) == 3
    # What the 3 steps moved, leaf by leaf. AdamW's first steps move a
    # weight by about lr * sign(g), and a gradient whose sign is set by the
    # two sides' rounding moves it the other way, so the moves are held in
    # norm: within 1% of the JAX move.
    for (path, w0), (_, a), (_, b) in zip(init, _by_path(res.params),
                                          _by_path(_np(jp))):
        dt, dj = a.numpy() - w0, np.asarray(b) - w0
        err = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
        assert err < 1e-2, path


def test_train_lm_main(capsys):
    """`python -m repro_torch.train.lm --sync --device cpu` at the reduced
    config: the exit code follows the printed losses, as train_lm.py's."""
    rc = lm.main(["--sync", "--device", "cpu", "--steps", "3", "--batch", "2",
                  "--seq-len", "16"])
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"^loss (\S+) -> (\S+) ",
                                       out, re.M).groups())
    assert rc == (0 if last < first else 1)
    assert "trained 3 steps" in out


def test_train_lm_main_runs_the_task_graph(capsys):
    """`python -m repro_torch.train.lm --device cpu --steps 2` needs no
    `--sync`: without it, it trains through the compiled task graph, and
    the loss falls (at 2 x 16 tokens a step it does not, in either mode)."""
    rc = lm.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                  "--seq-len", "32", "--publish-every", "1"])
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"^loss (\S+) -> (\S+) ",
                                       out, re.M).groups())
    assert last < first and rc == 0
    assert "kernel tasks: 4," in out and "param publishes 2" in out


# ------------------------------------------------------------ task graph

def _reduced():
    """train_lm.py's reduced config, as `lm.main` builds it."""
    return registry.get_smoke_config("xlstm-125m").scaled(
        num_layers=4, d_model=256, param_dtype="float32",
        vocab_size=2048).scaled(train_microbatch=0)


# The task graph runs the `--sync` loop's ops on the same inputs, but on a
# device lane's thread rather than the caller's (the plan co-locates the
# graph's nodes, so the two grad shards run in turn on one lane), where the
# CPU's intra-op work may split otherwise, so sums come out in other orders.
GRAPH_RTOL = 1e-6
BATCH, SEQ, SHARDS, STEPS = 4, 32, 2, 4


@pytest.fixture(scope="module")
def reduced_sync():
    """The reduced model's init and its `--sync` run of STEPS steps."""
    from repro_torch.bridge import init_params
    cfg = _reduced()
    init = init_params(cfg, torch.Generator().manual_seed(0))
    copy = {"params": lm.tree_map(torch.clone, init)}
    sync = lm.train_lm(cfg, STEPS, BATCH, SEQ, SHARDS, "cpu",
                       params=copy["params"], sync=True)
    return cfg, init, sync


def test_task_graph_matches_the_sync_loop(reduced_sync):
    """train_lm.py without --sync: the same losses as the --sync loop, a
    ParamSet published every 2 steps, one kernel task a shard and step,
    and the caller's params left as they were."""
    cfg, init, sync = reduced_sync
    before = lm.tree_map(torch.clone, init)
    res = lm.train_lm(cfg, STEPS, BATCH, SEQ, SHARDS, "cpu", params=init,
                      publish_every=2)
    np.testing.assert_allclose(res.losses, sync.losses, rtol=GRAPH_RTOL)
    assert res.losses[-1] < res.losses[0]
    assert res.stats["kernel_tasks"] == SHARDS * STEPS
    assert res.stats["param_publishes"] == STEPS // 2
    assert res.stats["graph_invocations"] == STEPS
    assert int(res.opt_state["step"]) == STEPS
    for a, b in zip(tree_leaves(init), tree_leaves(before)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _drain_runtime_threads(timeout=10.0):
    """The cluster's threads end after `shutdown()` (a replayed task may
    still be finishing a torch op)."""
    def left():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(("worker-", "lane-", "heartbeat-"))]
    deadline = time.monotonic() + timeout
    while left() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not left(), left()


def _shard_batches(cfg, step):
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, num_shards=SHARDS)
    return [{"tokens": torch.from_numpy(pipeline.batch_for_step(
        pipeline.DataConfig(**{**dc.__dict__, "shard_id": s}), step)
        ["tokens"]).long()} for s in range(SHARDS)]


def test_task_graph_survives_losing_the_newest_params(reduced_sync):
    """Kill every node that holds the newest params after step 2: lineage
    replays the step's reduce and AdamW apply from the inputs still in the
    object store, and the losses equal the undisturbed run's. An apply that
    updated its inputs in place would apply step 2 twice here."""
    from repro_torch import core
    cfg, init, sync = reduced_sync
    cluster = core.init(node_resources=(
        [{"cpu": 2.0, "gpu": 1.0}] * SHARDS + [{"cpu": 2.0}]))
    try:
        graph = lm.StepGraph(build_model(cfg), adamw.AdamWConfig(lr=1e-3),
                             init, adamw.adamw_init(init), SHARDS)
        losses = []
        for step in range(STEPS):
            losses.append(graph.step(_shard_batches(cfg, step)))
            if step == 1:
                core.get(graph.params_ref, timeout=60)
                victims = cluster.gcs.locations(graph.params_ref.id)
                assert victims
                for node in victims:
                    cluster.kill_node(node)
        kinds = [e[1] for e in cluster.gcs.events()]
    finally:
        core.shutdown()
        _drain_runtime_threads()
    assert {"node_failure", "reconstruct"} <= set(kinds)
    np.testing.assert_allclose(losses, sync.losses, rtol=GRAPH_RTOL)


def test_train_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.train_lm(registry.get_smoke_config("xlstm-125m"), 1, 2, 8, 1)
