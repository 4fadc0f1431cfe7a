#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:
  1. build    compile every CUDA C++ kernel of the port from the sources in
              this checkout (nvcc, sm_90a) into build/.
  2. kernels  hold each kernel against its plain PyTorch version on the card
              at the shapes of the serve path, and time kernel, plain
              version and the PyTorch library call that computes the same
              function (a yardstick only; the port never calls it).
  3. parity   stablelm-1.6b at full width, 2 layers, fp32: the port on the
              card against the port on the CPU (the CPU path is the one the
              tests hold against the JAX reference).
  4. serve    stablelm-1.6b at full width and depth (24 layers, bf16,
              random weights from a seed) serves requests drawn from the
              load module's length mix plus two 2048-token prompts through
              `ServingEngine`, the port's main path; every kernel must have
              launched there. Then torch.profiler over its shortest and its
              longest wave says where their time goes.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a card it exits 1.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Kernel vs plain version, compared in fp32: |a - b| <= tol + tol * |b|.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Port on the card vs port on the CPU, fp32 prefill logits.
PARITY_TOL = 1e-3
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2

def _attn_inputs(gen, b, h, hkv, s, t, hd, dtype):
    """q (B,H,S,hd), k/v (B,Hkv,T,hd) as views of (B,S,H,hd) tensors, the
    layout the model hands the kernel."""
    def mk(n, heads):
        x = torch.randn(b, n, heads, hd, generator=gen, device="cuda")
        return x.to(dtype).transpose(1, 2)
    return mk(s, h), mk(t, hkv), mk(t, hkv)


def _valid_pairs(s: int, t: int, causal: bool, window: int) -> int:
    qi = torch.arange(s)[:, None]
    kj = torch.arange(t)[None, :]
    valid = torch.ones(s, t, dtype=torch.bool)
    if causal:
        valid &= kj <= qi
    if window > 0:
        valid &= (qi - kj) < window
    return int(valid.sum())


def check_flash_attention(gen):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    cases = [  # (label, B, H, Hkv, S, T, hd, causal, window, dtypes)
        *[(f"stablelm prefill S={s}", 2, 32, 32, s, s, 64, True, 0,
           (torch.bfloat16,)) for s in (8, 64, 2048)],
        ("GQA 4:1 window 64", 2, 8, 2, 256, 256, 64, True, 64,
         (torch.float32, torch.bfloat16)),
        ("non-causal S!=T", 1, 2, 2, 64, 256, 64, False, 0,
         (torch.float32, torch.bfloat16)),
        ("MQA hd=128", 2, 4, 1, 128, 128, 128, True, 0,
         (torch.float32, torch.bfloat16)),
        ("ragged S=40 hd=32", 2, 4, 4, 40, 40, 32, True, 0,
         (torch.float32, torch.bfloat16)),
        ("one row S=1", 1, 4, 4, 1, 1, 64, True, 0, (torch.float32,)),
        ("odd S=129 GQA 2:1 window 100", 1, 4, 2, 129, 129, 64, True, 100,
         (torch.float32,)),
        ("non-causal window 64 S<T", 1, 4, 4, 100, 160, 32, False, 64,
         (torch.float32,)),
    ]
    main = None
    for label, b, h, hkv, s, t, hd, causal, window, dtypes in cases:
        for dt in dtypes:
            q, k, v = _attn_inputs(gen, b, h, hkv, s, t, hd, dt)
            out = flash_attention(q, k, v, causal=causal, window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"{label}: {out.shape}/{out.dtype} vs "
                                     f"{ref.shape}/{ref.dtype}")
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            bad = diff > TOL[dt] + TOL[dt] * ref.float().abs()
            if not torch.isfinite(out).all() or bool(bad.any()):
                raise AssertionError(f"flash_attention {label} {dt}: max abs "
                                     f"err {err} beyond tol {TOL[dt]}")
            log(f"[kernels] flash_attention {label} {str(dt)[6:]} "
                f"B={b} H={h} Hkv={hkv} S={s} T={t} hd={hd} causal={causal} "
                f"window={window}: max_abs_err={err} (tol {TOL[dt]}) ok")
            if label == "stablelm prefill S=2048":
                main = (q, k, v, err)

    q, k, v, err = main
    b, h, s, hd = q.shape
    t = k.shape[2]
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True), 10)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    flops = 4 * b * h * hd * _valid_pairs(s, t, True, 0)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "shape": f"bf16 B={b} H={h} S={s} T={t} hd={hd} causal",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "flops": flops,
        "bytes": nbytes,
    }
    log(f"[kernels] flash_attention at {entry['shape']}: kernel {kernel_ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}: {flops} flop, "
        f"{nbytes} bytes)")
    return entry


# ------------------------------------------------------------------ phase 3

def check_card_vs_cpu():
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import load
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("stablelm-1.6b").scaled(num_layers=2,
                                              param_dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cpu_params = params_to(params, "cpu")

    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 32)))
    with torch.inference_mode():
        card_logits, _ = model.prefill(params, {"tokens": tokens.cuda()},
                                       max_seq=40)
        cpu_logits, _ = model.prefill(cpu_params, {"tokens": tokens},
                                      max_seq=40)
    err = float((card_logits.cpu() - cpu_logits).abs().max())
    if not err <= PARITY_TOL:
        raise AssertionError(f"prefill logits card vs cpu: {err} > {PARITY_TOL}")

    trace = load.poisson_trace(50.0, 10.0, seed=SEED, max_new_tokens=8)[:4]
    requests = [r for _, r in load.materialize(trace, SEED, cfg.vocab_size)]
    card = ServingEngine(model, params, max_seq=128).serve(requests, 4)
    cpu = ServingEngine(model, cpu_params, max_seq=128,
                        device="cpu").serve(requests, 4)
    card_tok = {r.request_id: r.tokens for r in card}
    cpu_tok = {r.request_id: r.tokens for r in cpu}
    if card_tok != cpu_tok:
        raise AssertionError(f"greedy tokens differ: card {card_tok} "
                             f"cpu {cpu_tok}")
    log(f"[parity] stablelm-1.6b d={cfg.d_model} 2 layers fp32: prefill "
        f"logits max "
        f"abs err card vs cpu {err} (tol {PARITY_TOL}); greedy tokens equal "
        f"for prompt lengths {[len(r.prompt) for r in requests]}")


# ------------------------------------------------------------------ phase 4

def _numel(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_numel(x) for x in items)


class _TimedModel:
    """Delegates to the model, timing each prefill and decode step on the
    host clock between synchronizations and checking the logits."""

    def __init__(self, model, vocab):
        self.model, self.vocab = model, vocab
        self.prefill_ms, self.decode_ms = [], []

    def _timed(self, out_ms, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args, **kw)
        torch.cuda.synchronize()
        out_ms.append((time.perf_counter() - t0) * 1e3)
        if logits.shape[-1] != self.vocab or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        return logits, cache

    def prefill(self, params, batch, max_seq=0):
        return self._timed(self.prefill_ms, self.model.prefill, params, batch,
                           max_seq=max_seq)

    def decode_step(self, params, cache, tokens, pos):
        return self._timed(self.decode_ms, self.model.decode_step, params,
                           cache, tokens, pos)


def serve_full_model(card: str):
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model, padded_vocab
    from repro_torch.serving import load
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            length_aligned_waves)

    cfg = get_config("stablelm-1.6b")
    new_tokens, long_prompt, max_wave = 16, 2048, 4
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 1))
    torch.cuda.synchronize()
    n_params = _numel(params)
    log(f"[serve] stablelm-1.6b {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.param_dtype}: {n_params} params initialized in "
        f"{time.perf_counter() - t0:.1f} s")
    timed = _TimedModel(build_model(cfg), padded_vocab(cfg))
    engine = ServingEngine(timed, params, max_seq=long_prompt + new_tokens)

    trace = load.poisson_trace(50.0, 10.0, seed=SEED, max_new_tokens=new_tokens)
    rng = np.random.default_rng(SEED)
    requests = [r for _, r in load.materialize(trace[:8], SEED, cfg.vocab_size)]
    requests += [Request(8 + i, rng.integers(0, cfg.vocab_size, long_prompt)
                         .astype(np.int32), new_tokens) for i in range(2)]
    waves = length_aligned_waves(requests, max_wave)

    engine.serve([Request(99, requests[0].prompt, 2)], max_wave)  # warm-up
    timed.prefill_ms.clear()
    timed.decode_ms.clear()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    t0 = time.perf_counter()
    responses = engine.serve(requests, max_wave)
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches

    if sorted(r.request_id for r in responses) != \
            sorted(r.request_id for r in requests):
        raise AssertionError("not every request was answered")
    budget = {r.request_id: r.max_new_tokens for r in requests}
    for r in responses:
        if len(r.tokens) != budget[r.request_id] or not all(
                0 <= tok < padded_vocab(cfg) for tok in r.tokens):
            raise AssertionError(f"request {r.request_id}: tokens {r.tokens}")
    if launches != cfg.num_layers * len(waves) or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"want {cfg.num_layers} x {len(waves)} waves")
    generated = sum(len(r.tokens) for r in responses)
    wave_desc = [f"{len(w)}x{len(w[0].prompt)}" for w in waves]
    log(f"[serve] card: {card}")
    log(f"[serve] {len(responses)} requests in {len(waves)} waves "
        f"(batch x prompt: {wave_desc}), {new_tokens} new tokens each, "
        f"max_wave {max_wave}: flash_attention launches {launches} "
        f"= {cfg.num_layers} x {len(waves)}")
    for w, ms in zip(wave_desc, timed.prefill_ms):
        log(f"[serve] prefill wave {w}: {ms:.3f} ms")
    log(f"[serve] decode per token (one step of the wave batch): median "
        f"{statistics.median(timed.decode_ms):.3f} ms over "
        f"{len(timed.decode_ms)} steps")
    log(f"[serve] wall {wall_s:.3f} s, {generated} tokens, "
        f"{generated / wall_s:.1f} tokens/s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    profile_waves(ServingEngine(timed.model, params, engine.max_seq),
                  [waves[0], waves[-1]])
    return launches


def profile_waves(engine, waves) -> None:
    """Where a wave's time goes: torch.profiler over one served wave, device
    busy time (sum of kernel times on the one stream) against the wall
    time, and the kernels that take most of it. The profiler's own host
    cost inflates the wall time, so the idle share here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    for wave in waves:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.serve(wave, len(wave))
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        desc = f"{len(wave)}x{len(wave[0].prompt)}+{wave[0].max_new_tokens}"
        if not kernels:
            log(f"[profile] wave {desc}: the profiler saw no device time")
            continue
        log(f"[profile] wave {desc}: wall {wall_ms:.3f} ms under the "
            f"profiler, device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}, "
            f"{sum(e.count for e in kernels)} kernel launches")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry = check_flash_attention(gen)
    check_card_vs_cpu()
    entry["launches"] = serve_full_model(card)

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
