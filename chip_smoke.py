#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:
  1. build    compile every CUDA C++ kernel of the port from the sources in
              this checkout (nvcc, sm_90a) into build/, and print each
              kernel's registers, shared memory and spills as ptxas
              reported them.
  2. kernels  hold each kernel against its plain PyTorch version on the card
              at the shapes of the serve and train paths (flash_attention at
              stablelm's and jamba's prefill, every case in bf16 on the
              tensor-core path and most in fp32 on the CUDA-core path;
              mixtral-8x22b's 1x8192 prefill past its 4096 window and its
              2x2048, against the plain version a chunk of query rows at a
              time; the backward kernels through `_FlashAttention` (dq, dk,
              dv and the forward's lse) against the plain blockwise
              backward and autograd through the plain version, at every
              head_dim on both dtypes, with and without softcap, windows,
              S != T cross-attention, gemma3's, MLA's and mixtral's
              training shapes, timed at mixtral's 2x2048 beside its bound,
              SDPA's forward + backward and the recompute backward it
              replaced, and its peak memory at 1x8192; gemma3-12b's bf16
              2x16(8)x2048 at head_dim 256, windowed to 1024 and global,
              and its 1x8192 windowed; deepseek-v2's MLA prefill, bf16
              2x128x2048 at head_dim 192 with the values zero-padded from
              128, beside the SDPA backends that take 192/128 heads; fp32
              and bf16 cases at 192 and 256; the other bf16 shapes phases
              4e-4g hand flash, and every shape phase 5c's training steps
              and deepseek's smoke serve hand it (head_dim 48, padded by the
              wrapper), each beside its bound and SDPA; mlstm_scan at
              xlstm's training steps, ssm_scan at jamba's prefill and
              decode), and
              time kernel, plain version and, where there is one, the
              PyTorch library call that computes the same function (a
              yardstick only; the port never calls it).
  3. parity   the port on the card against the port on the CPU (the CPU
              path is the one the tests hold against the JAX reference), in
              fp32: stablelm-1.6b at full width, 2 layers, prefill, greedy
              tokens, loss and every gradient leaf (flash's backward);
              xlstm-125m at full width, 2 layers (one sLSTM, one mLSTM),
              loss and every gradient leaf, prefill logits and 4 decode
              steps; mixtral-8x22b at its smoke widths (window 16) for each
              MoE dispatch (dense, dropping, ragged), loss and every
              gradient leaf, prefill and 8 decode steps past the window,
              greedy tokens; jamba at its smoke config (MoE layers
              included), prefill logits, 4 decode steps and greedy tokens;
              phi3-medium-14b, mistral-large-123b, gemma3-12b, internvl2-2b
              (image embeddings before the tokens), seamless-m4t-medium
              (encoder frames, cross-attention) at their smoke configs and
              deepseek-v2-236b's with MLA's full head dims (192 for the
              kernel; a dense first layer, MoE after): loss, prefill and 8
              decode steps, greedy tokens, flash launched once a
              full-sequence attention; gemma3's chunked loss over 2x2048
              tokens and every gradient leaf, card vs CPU, and chunked vs
              unchunked on the card; stablelm-1.6b's smoke config with its
              attention logits softcapped at 2.0 (fp32): prefill logits,
              loss and every gradient leaf, the flash kernels' tanh forward
              and backward.
  4. serve    stablelm-1.6b at full width and depth (24 layers, bf16,
              random weights from a seed) serves requests drawn from the
              load module's length mix plus two 2048-token prompts through
              `ServingEngine`, the port's serving path; flash_attention must
              have launched there. Then torch.profiler over its shortest and
              its longest wave says where their time goes.
  4c. serve   on phase 4's stablelm-1.6b weights (no second init), through
              the open-loop FrontDoor: (a) `repro_torch.serving.serve_llm`
              with its defaults and `--full` (2 replica actors, waves of at
              most 2, Poisson 20 req/s for 3 s, deadline 2 s, 8 new tokens);
              every ticket resolves, none is dispatched past its deadline,
              the ledger balances, some are served, every token is valid,
              and flash_attention launches 24 times a wave the replicas
              served after the probes; it prints the ledger, latency
              p50/p99, goodput, prefill by prompt length and the decode step
              inside the replicas beside phase 4's, and the runtime's cost a
              wave (dispatch-to-reap minus the engine's own serve); then the
              same with `--replicas 1`. Beside them, the decode step of one
              engine alone against two engines on two plain threads at once,
              and one engine's wave must end while another engine's stream
              sleeps (each engine waits for its own stream). (b) the
              reference's replica-kill test at full width: 2 replicas (max
              4), 60 requests 2 ms apart, deadline 2 s, the node of replica
              0 killed at the 31st: every ticket resolves, a hot spare
              brings the count to 3, some are served, the ledger balances,
              and the card's allocated memory comes back.
  4b. serve   jamba-1.5-large-398b cut to one 8-layer group (7 Mamba layers,
              1 attention layer) at full width, dense SwiGLU FFNs in place of
              the experts, bf16, 8,999,034,880 random parameters: the same
              kind of traffic through `ServingEngine`, with flash_attention
              launched once a wave and ssm_scan 7 times a prefill and a
              decode step; then the same profile.
  4d. serve   mixtral-8x22b cut to 8 of its 56 layers at full width
              (20,435,146,752 random bf16 parameters, `dropping` dispatch)
              through `ServingEngine`: short trace prompts, 2x2048 and
              1x8192 (past the 4096 window, ring caches of 4096 slots), 16
              new tokens each; flash_attention launched 8 times a prefill
              wave; the decode step beside its weight-read bound; then the
              profile of the 1x8192 wave and of one decode step.
  4e. serve   gemma3-12b whole (48 layers, 11,765,395,200 random bf16
              parameters, head_dim 256, five of six layers windowed to 1024)
              through `ServingEngine`: short trace prompts, 2x2048 and
              1x8192 (past the window), 16 new tokens each; flash launched
              48 times a prefill wave; the decode step beside its read
              bound (tied embeddings: the table is the LM head); the
              profile of the 1x8192 wave.
  4f. serve   deepseek-v2-236b cut to its dense first layer and 4 MoE layers
              (`num_layers=5`, 17,243,571,200 parameters, MLA with 128
              heads, 160 experts top-6 and 2 shared, `dropping`) through
              `ServingEngine`: waves 3x8, 1x32, 2x2048; flash at head_dim
              192 launched 5 times a wave; the absorbed decode beside its
              read bound.
  4g. serve   internvl2-2b whole (256 random image embeddings before a 2x32
              prompt) and seamless-m4t-medium whole (2x512 random frames, a
              2x32 prompt, max_seq 512: the cross cache neither padded nor
              cropped) through `Model.prefill` and 16 greedy
              `decode_step`s, as the ServingEngine takes tokens only (flash
              24 and 36 times a prefill, never in decode); then
              phi3-medium-14b whole and mistral-large-123b cut to 8 of 88
              layers through `ServingEngine`, a trace wave and a 2x2048
              wave each. Every new serve phase prints prefill ms a wave,
              decode ms a step beside its bound, tokens/s,
              max_memory_allocated and launches.
  5. train    xlstm-125m at full width cut to 6 of its 12 layers (bf16
              params, fp32 AdamW moments, random weights from a seed) trains
              through
              `repro_torch.train.lm.train_lm`, the port's training path, with
              train_lm.py's settings (global batch 8 in 2 shards, lr 1e-3) at
              seq_len 512: 1 warm-up step, then 4 timed steps whose losses
              must be finite and fall, with mlstm_scan launched twice per
              mLSTM layer, shard and step (the config's remat_policy
              "nothing": the forward again in the backward). Then, at
              seq_len 128, steps under "full" and "nothing" timed in the
              order full, nothing, nothing, full, one of each traced by
              torch.profiler, beside one shard's forward: what the remat's
              recompute costs and what else it adds.
  5b. train   mixtral-8x22b cut to 1 layer at full width (2,906,720,256
              bf16 parameters, bf16 AdamW moments, `dropping`), global batch
              2 x 2048, through `repro_torch.train.trainer`: (a) `Trainer`,
              4 steps, async checkpoints at steps 2 and 4, finite losses;
              (b) a fresh `Trainer` restores step 2 and repeats steps 2-3
              with (a)'s losses; (c) `AsyncTrainer` on a cluster of the
              port's runtime with a gpu node, 4 steps, backup loads and a
              checkpoint task, with (a)'s losses. Each save's and restore's
              bytes and MB/s; the checkpoints go to build/ and are deleted.
  5c. launch  the launchers' paths (`repro_torch.launch`): (a)
              `launch.train.train`, 1 warm-up and 3 timed steps at each
              config's own remat_policy, at full width: stablelm-1.6b,
              internvl2-2b and seamless-m4t-medium whole, gemma3-12b cut to
              one 6-layer group, phi3-medium-14b to 4 layers, mistral-large
              to 2, deepseek-v2 to 2 (its dense first layer and one MoE
              layer), xlstm-125m to 2 at 2x128; stablelm-1.6b again with its
              attention logits softcapped at 50.0; jamba at its smoke
              config (a full-width group does not fit). Finite losses, and
              each kernel launched once a layer a step, twice inside the
              remat, flash's backward once a layer a step.
              (b) `_SSMScan` at jamba's full-width layer (B=1 S=2048
              di=16,384, x bf16): y against the plain version, every
              gradient against autograd through `ssm_scan_ref` on the card;
              jamba smoke's loss and gradients card vs CPU. (c) gemma3's cut
              group at 1x2048 under "full", "dots" and "nothing": every
              gradient leaf against "full"'s, each policy's peak memory.
              (d) `make_compressing_train_step`, 3 steps on stablelm-1.6b
              cut to 2 layers: finite losses and error feedback;
              `quantize_int8` on the card bit-equal to the CPU's. (e)
              `launch.serve --smoke` for all ten arches on the card (the
              two modal ones raise KeyError as the reference's do),
              stablelm-1.6b and xlstm-125m at full size, and `python -m
              repro_torch.launch.serve` once. Step ms, losses, peak memory
              and launches printed for each.
  6. compute  the port's runtime and compute plane on a cluster of one
              gpu-typed and one cpu node (`repro_torch.core`,
              `repro_torch.compute`): int8_matmul against its plain version
              at compute_bench.py's shape, tests/test_kernels.py's shapes and
              stablelm-1.6b's MLP up-projection (K 2048, N 5632) at M 1, 4,
              16, 17, 64 and 4096 on each of its paths (split-K GEMV at
              M <= 16, tensor cores for bf16 above, fp32 tiles for fp32
              above), timed at a 4-row decode step and the 2 x 2048-token
              prefill wave beside dequantize + torch.matmul; int8_matmul run
              as a `kernel_task`
              on the gpu node (max abs err < 1e-3, its launch counted, the
              profiler counting the task); the kernel-task round trip against
              the bare call of tanh(x @ x.T) at dim 384, its ratio against
              compute_bench.py's OVERHEAD_MULT (printed, not gated: not met
              on the H100) and the microseconds it adds beside the
              reference's 487 (printed, not gated), the trip hop by hop, the bare call made right
              after its thread slept and right after it spun as long, and a
              handoff between two threads through a threading.Event and
              through a spin; `ParamSet`
              publish/fetch of xlstm-125m's parameters from the card
              (zero-copy views, bit-exact round trip).
  7. train graph  xlstm-125m at full width cut to 6 of its 12 layers
              trains through the
              task-graph mode of `train_lm` (one `kernel_task` grad shard a
              data shard on its own gpu-typed node, reduce and AdamW apply
              on a cpu node, one compiled graph a step, a `ParamSet`
              published every 2 steps) with train_lm.py's defaults (global
              batch 8 in 2 shards, seq_len 128, lr 1e-3): 1 warm-up step,
              then 3 timed steps; the losses must be finite, fall and equal
              the `--sync` loop's over the same 4 steps to 1e-5 of their
              value, with mlstm_scan launched 3 x 2 x 3 x 2 times (the
              remat's second forward) and 6 kernel tasks counted by the
              profiler.
  8. examples the port's quickstart (`repro_torch.examples.quickstart`) runs
              to its end: a value lost with its node comes back by lineage
              replay.
  8b. stream  the port's streaming plane (`repro_torch.streaming`) through
              benchmarks/stream_bench.py's four scenarios at its full sizes
              (churn_plateau at its smoke length of 6 s), held to its gates,
              reproduced here: drift recovery beats the frozen arm by 0.05
              and reaches 0.75, swaps happen and cost the p99 no more than
              1.5x + 5 ms, store residency plateaus, and after the learner's
              node is killed publishes resume with a version lag of at most
              64; in every run no ticket hangs, none is dispatched past its
              deadline, and the source produces and acks exactly the batches
              the run took. Each hot-swap arm's timeline is logged (waves,
              latencies by wall time, collections, swaps, the stalls and
              what they follow), and the threads and heap when 8b starts.
  8c. rl      `repro_torch.examples.rl_pipeline` at its defaults and with
              `--kill-node`: the learner's weights live on the card, the
              policy improves, the ParamSet fetch round-trips; then
              `repro_torch.examples.rl_workload.run()`, the paper's §4.2
              serial, BSP (2.5 and 10 ms a task) and hybrid runs with the
              policy update on the card, printed beside the paper's ratios.
  8d. des     each scenario of `repro_torch.core.simulator` at its defaults,
              `heterogeneous_fleet` with phase 6's kernel-task round trip
              p50 as its device step: no device task misplaced, the diurnal
              serving ledger balances, the streaming scenario recovers.
              Phases 8-8d run no kernel of the port; their launches are
              logged.
  9. dryrun   the dry run (`repro_torch.launch.dryrun.trace_cell`) at world
              size 1 of every config phase 5c trained, held to its steps
              (state bytes and kernel calls a step exact; predicted peak and
              the FLOPs share of peak printed), and `python -m
              repro_torch.launch.dryrun` on four full-width cells of the
              single-pod plan, none of which may initialize CUDA.
  10. sharded the sharded training step (`launch.train.train` over a
              process group, the reference's ShardingRules executing), the
              thirteen cases of SHARDED_TRAIN, cut by depth:
              stablelm-1.6b cut to 2 of its 24 layers over a (2, 2) mesh,
              batch 2 x 2048; phi3-medium-14b cut to 1 layer over (1, 16),
              16 ranks, batch 1 x 2048 (40 heads over 16: 320 columns, flash
              on 3 whole heads a rank; each rank draws only its blocks, its
              peak during the init printed); mixtral-8x22b cut to 1
              layer over (1, 4), batch 2 x 2048 (2 of its 8 experts and
              12(2) heads a rank, the `dropping` dispatch, window 4096,
              "dots"); jamba at its smoke config in fp32 over (2, 2), batch
              2 x 64 (Mamba on 128 of 256 channels a rank, ssm_scan on them,
              experts over model, no sequence parallelism); deepseek-v2 cut
              to 2 layers over (1, 4) (MLA heads and experts over model);
              gemma3-12b cut to 6 over (1, 4) (the tied table's chunked
              loss); xlstm-125m cut to 2 over (2, 2) (sLSTM and mLSTM
              heads); seamless-m4t-medium cut to 2 encoder and 2 decoder
              layers over (2, 2), batch 2 x 2048 (the encoder, cross-
              attention, the untied head's chunked loss); internvl2-2b cut
              to 2 layers over (1, 4), batch 1 x 2048 (the image rows rank
              0's); stablelm-1.6b cut to 2 layers in fp32 over (2, 2)
              through the int8 compressing step (each leaf's scale, and the
              error feedback residual's blocks, held to the one card's); jamba smoke fp32 over (2, 2) with
              sequence parallelism; mixtral smoke fp32 over (1, 4) with the
              `ragged` dispatch; stablelm smoke fp32 over (2, 2) with its
              attention logits softcapped at 2.0. 1 warm-up + 2 steps
              each, as
              gloo ranks spawned on this card (their collectives through
              host memory: no measure of the plan's speed). Each rank held
              to the one-card step from the same weights and batches, at
              the gates of its dtype (bf16: losses and every updated leaf
              to 1e-3, gradient norms 2e-2, AdamW m 5e-2 of the leaf's
              largest entry, the embedding table's 0.25; fp32 no looser),
              flash launched on its local heads (with the layer's window),
              its backward once a layer a step, and ssm_scan on its
              channels as often as the remat implies,
              its bytes a step by kind equal to the dry run's at the same
              mesh; the top-k assignments of the first forward that differ
              from the one card's counted and printed; backend, ranks,
              cards, each rank's peak memory and step ms printed. With 2
              cards or more, stablelm also over nccl, one rank a card.
The line before the last is a JSON object with one entry per kernel (flash's
backward under flash's entry, "backward"); the last line is {"ok": true,
"device": {...}}. Without a card it exits 1.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores, HBM3 bandwidth; the port keeps them in `launch.mesh`.
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32  # noqa: E402

PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: PEAK_FLOPS_FP32}
PEAK_BYTES_PER_S = HBM_BW
# Kernel vs plain version, compared in fp32: |a - b| <= tol + tol * |b|.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ssm_scan: fp32 1e-4, as the fp32 state runs through 2,048 sequential
# steps whose fma contractions and exps differ from the plain version's by
# an ulp each; bf16 2e-2, tests/test_kernels.py's TOL (y rounded to bf16).
# The state out is fp32 whatever x's type, and held at fp32's 1e-4.
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The exps of a selective scan run on the special function units: 16 per SM
# per clock on the H100's 132 SMs.
SFU_PER_SM_CLOCK, SMS = 16, 132
# jamba-1.5-large-398b cut to one group without experts: its parameters by
# `jax.eval_shape` of the reference's init (tests/test_torch_jamba.py).
JAMBA_CUT_PARAMS = 8_999_034_880
# mlstm_scan: fp32 1e-4, as the kernel and the plain version sum in other
# orders (fma chains vs einsum) through the exp-weighted state over many
# chunks; bf16 5e-2, the bound of tests/test_kernels.py:95 (y rounded to
# bf16). The state out is fp32 whatever q's type, and held at fp32's 1e-4.
MLSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# The bf16 kernels against `mlstm_scan_two_pass_ref`, the plain version that
# rounds to bf16 where they do (chunk-start C, P as hi + lo parts, y) and
# forms P in their order and base (exp2 of the log2-scaled exponent): y to
# 1e-2 + 1e-2 |y|, an ulp of bf16 y (2^-8 of |y|) and the fp32 sums' order
# beside it; the state at MLSTM_TOL's fp32 1e-4.
MLSTM_TWO_PASS_TOL = 1e-2
# Phase 2's bf16 mlstm_scan cases again on the draws of these seeds
# (`sweep_mlstm_seeds`): gated against the fp32 plain version at
# MLSTM_TOL and against the two-pass plain version at MLSTM_TWO_PASS_TOL.
MLSTM_SWEEP_SEEDS = tuple(range(1, 17))
# Phase 5's loss at the initial weights, the kernel against the plain
# version in the same run: to 1e-3 of its value.
MLSTM_LOSS_RTOL = 1e-3
# Port on the card vs port on the CPU, fp32 prefill logits.
PARITY_TOL = 1e-3
# xlstm card vs CPU, fp32: the loss to 1e-5 of its value; each gradient leaf
# to 1e-3 of its largest entry. The two sides differ only in the order of
# sums (the kernel's fma chains, cuBLAS against the CPU's GEMMs), which the
# backward carries through 2 layers and a 50,688-wide softmax.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
SEED = 0
# extra columns of the wider tensor whose views one bf16 flash case reads
FLASH_PAD = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(phase: str, fn, *args):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {phase}: {time.perf_counter() - t0:.1f} s")
    return out


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


def release_memory() -> None:
    """Free what the last phase left (its params and caches are garbage
    once it returns) before the next phase allocates."""
    gc.collect()
    torch.cuda.empty_cache()


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"flash_attention": flash_attention, "int8_matmul": int8_matmul,
            "mlstm_scan": mlstm_scan, "ssm_scan": ssm_scan}


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0, flash's backward launches
    too, just before a main path."""
    wrappers = _wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    wrappers["flash_attention"].bwd_launches = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, and flash's backward launches
    ("flash_attention_bwd")."""
    wrappers = _wrappers()
    return {**{name: w.launches for name, w in wrappers.items()},
            "flash_attention_bwd": wrappers["flash_attention"].bwd_launches}


def remat_runs(cfg) -> int:
    """Forwards a training step runs of each layer inside the remat: one,
    and under `"dots"` or `"nothing"` one more in the backward's
    recompute."""
    return 1 if cfg.remat_policy == "full" else 2


# ------------------------------------------------------------------ phase 1

def _demangle(names):
    """C++ names of the mangled kernel symbols, where c++filt is at hand."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else names


def build_report() -> None:
    """Build every kernel (one nvcc a source, all at once) and print what
    ptxas reported for each: registers, static shared memory, spills, and
    any note that it serialized the kernel's wgmma, on which it raises
    (each such kernel loses the overlap its design is for)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} built in {time.perf_counter() - t0:.1f} s")
    serialized = []
    for name in sorted(libs):
        report = _build.ptxas_report(name)
        if not report:
            raise AssertionError(f"no ptxas report for {name}")
        names = _demangle([k["kernel"] for k in report])
        for k, pretty in zip(report, names):
            pretty = pretty.replace("(anonymous namespace)::", "")
            log(f"[build] {name}: {pretty[:110]}: {k['registers']} registers, "
                f"{k['smem_bytes']} bytes static smem, spill stores "
                f"{k['spill_stores']} / loads {k['spill_loads']} bytes, wgmma "
                f"serialized {k['wgmma_serialized'] or 'no'}")
            if k["wgmma_serialized"]:
                serialized.append(f"{name}: {pretty[:110]} "
                                  f"{k['wgmma_serialized']}")
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma in {serialized}")


# ------------------------------------------------------------------ phase 2

def _attn_inputs(gen, b, h, hkv, s, t, hd, dtype, pad=0):
    """q (B,H,S,hd), k/v (B,Hkv,T,hd) as views of (B,S,H,hd) tensors, the
    layout the model hands the kernel; with `pad`, of the first H*hd
    columns of (B,S,H*hd+pad) tensors (an S stride of H*hd+pad)."""
    def mk(n, heads):
        x = torch.randn(b, n, heads * hd + pad, generator=gen, device="cuda")
        x = x.to(dtype)[..., :heads * hd].unflatten(-1, (heads, hd))
        return x.transpose(1, 2)
    return mk(s, h), mk(t, hkv), mk(t, hkv)


def _valid_pairs(s: int, t: int, causal: bool, window: int) -> int:
    from repro_torch.kernels.cost import valid_pairs
    return valid_pairs(s, t, causal, window)


def _err_within(label, got, want, tol) -> float:
    """Max abs error; raises where |a - b| > tol + tol |b| or a is not
    finite."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got).all() or \
            bool((diff > tol + tol * want.float().abs()).any()):
        raise AssertionError(f"{label}: max abs err {float(diff.max())} "
                             f"beyond tol {tol}")
    return float(diff.max())


def check_flash_attention(gen):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import ops
    bf16 = (torch.bfloat16,)
    cases = [  # (label, B, H, Hkv, S, T, hd, causal, window, softcap, dtypes)
        *[(f"stablelm prefill S={s}", 2, 32, 32, s, s, 64, True, 0, 0.0,
           bf16) for s in (8, 64, 2048)],
        ("GQA 4:1 window 64", 2, 8, 2, 256, 256, 64, True, 64, 0.0,
         (torch.float32, torch.bfloat16)),
        ("non-causal S!=T", 1, 2, 2, 64, 256, 64, False, 0, 0.0,
         (torch.float32, torch.bfloat16)),
        ("MQA hd=128", 2, 4, 1, 128, 128, 128, True, 0, 0.0,
         (torch.float32, torch.bfloat16)),
        ("ragged S=40 hd=32", 2, 4, 4, 40, 40, 32, True, 0, 0.0,
         (torch.float32, torch.bfloat16)),
        ("one row S=1", 1, 4, 4, 1, 1, 64, True, 0, 0.0,
         (torch.float32, torch.bfloat16)),
        ("odd S=129 GQA 2:1 window 100", 1, 4, 2, 129, 129, 64, True, 100,
         0.0, (torch.float32, torch.bfloat16)),
        ("non-causal window 64 S<T", 1, 4, 4, 100, 160, 32, False, 64, 0.0,
         (torch.float32, torch.bfloat16)),
        (f"S stride H*hd+{FLASH_PAD} (views)", 2, 8, 2, 200, 200, 64, True, 0,
         0.0, bf16),
        ("jamba prefill GQA 8:1 hd=128", 2, 64, 8, 2048, 2048, 128, True, 0,
         0.0, bf16),
    ]
    # the edges of the wgmma forward's 64-key tiles at hd 192 and 256, from
    # a generator of their own: the checks after this one keep their draws
    edges = [case for hd in (192, 256) for case in (
            (f"odd S=129 GQA 2:1 window 100 hd={hd}", 1, 4, 2, 129, 129, hd,
             True, 100, 0.0, bf16),
            (f"non-causal S<T 100 over 160 hd={hd}", 1, 4, 4, 100, 160, hd,
             False, 0, 0.0, bf16),
            (f"one row S=1 hd={hd}", 1, 4, 4, 1, 1, hd, True, 0, 0.0, bf16),
            (f"softcap 50 S=300 hd={hd}", 1, 4, 2, 300, 300, hd, True, 0,
             50.0, bf16))]
    edge_gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    main = jamba = None
    for label, b, h, hkv, s, t, hd, causal, window, cap, dtypes, g in [
            *((*c, gen) for c in cases), *((*c, edge_gen) for c in edges)]:
        for dt in dtypes:
            pad = FLASH_PAD if label.startswith("S stride") else 0
            q, k, v = _attn_inputs(g, b, h, hkv, s, t, hd, dt, pad)
            if pad and q.stride(2) != h * hd + pad:
                raise AssertionError(f"{label}: q strides {q.stride()}")
            mask = {"causal": causal, "window": window, "softcap": cap}
            out = flash_attention(q, k, v, **mask)
            ref, ref_lse = attention_ref(q, k, v, return_lse=True, **mask)
            what = f"flash_attention {label} {dt}"
            err = _err_within(what, out, ref, TOL[dt])
            lse_err = _err_within(f"{what} lse",
                                  ops._launch(q, k, v, with_lse=True,
                                              **mask)[1],
                                  ref_lse, FLASH_LSE_TOL)
            log(f"[kernels] flash_attention {label} {str(dt)[6:]} "
                f"({ops.fwd_path(dt, hd)}) B={b} H={h} Hkv={hkv} S={s} T={t} "
                f"hd={hd} causal={causal} window={window} softcap={cap:g}: "
                f"max_abs_err={err} (tol {TOL[dt]}), lse {lse_err} (tol "
                f"{FLASH_LSE_TOL}) ok")
            if label == "stablelm prefill S=2048":
                main = (q, k, v, err)
            elif label.startswith("jamba"):
                jamba = (q, k, v, err)

    q, k, v, err = main
    csrc = "src/repro_torch/kernels/flash_attention/csrc/"
    designs = {f"{str(dt)[6:]} {hd}": ops.fwd_path(dt, hd)
               for dt in (torch.float32, torch.bfloat16)
               for hd in ops.HEAD_DIMS}
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": csrc + "flash_attention_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "path": ops.fwd_path(q.dtype, q.shape[-1]),
        # the forward's two sources and the design of each (dtype, head_dim)
        "sources": {
            csrc + "flash_attention_fwd_sm90.cu": [ops.SM90_PATH],
            csrc + "flash_attention.cu": list(ops.PATHS.values())},
        "designs": designs,
        "launches": None,
        "max_abs_err": err,
        **_flash_times(q, k, v),
    }
    q, k, v, err = jamba
    entry["at_jamba_shape"] = dict(_flash_times(q, k, v), max_abs_err=err)
    return entry


def _flash_times(q, k, v) -> dict:
    """Kernel, plain and SDPA ms of one causal call, its bound, the achieved
    rate and share of the bound, and the kernel/SDPA ratio."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import cost as flash_cost
    from repro_torch.kernels.flash_attention.ops import fwd_path
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True), 10)
    gqa = {"enable_gqa": True} if hkv != h else {}
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, **gqa), 20)
    flops, nbytes, _ = flash_cost(q, k, v, causal=True)
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    times = {
        "shape": f"{str(q.dtype)[6:]} B={b} H={h} Hkv={hkv} S={s} T={t} "
                 f"hd={hd} causal",
        "path": fwd_path(q.dtype, hd),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "flops": flops,
        "bytes": nbytes,
        "tflops": flops / kernel_ms / 1e9,
        "share_of_bound": bound_ms / kernel_ms,
        "kernel_over_library": kernel_ms / library_ms,
    }
    log(f"[kernels] flash_attention ({times['path']}) at {times['shape']}: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({times['bound_by']}: "
        f"{flops} flop, {nbytes} bytes); {times['tflops']:.1f} TFLOP/s, "
        f"{times['share_of_bound']:.3f} of the bound, kernel / sdpa "
        f"{times['kernel_over_library']:.3f}")
    return times


# mixtral-8x22b's attention: 48 heads over 8 KV heads, head_dim 128, a
# sliding window of 4096 keys.
MIXTRAL_HEADS, MIXTRAL_WINDOW = (48, 8), 4096
# Query rows a chunk of the plain version at mixtral's shapes: the whole
# 8192 x 8192 fp32 score matrix of 48 heads would take 12.9 GB.
PLAIN_ROW_CHUNK = 1024
# The backward kernels' dq, dk, dv against the plain blockwise backward and
# against autograd through `attention_ref`, |a - b| <= tol + tol |b|: fp32
# to 1e-5 (full fp32 on both sides, sums in other orders), bf16 to 2e-2 (P
# and dS rounded to bf16 as product operands, the grads to bf16 once).
FLASH_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The forward's lse (fp32 whatever the inputs) against the plain version's.
FLASH_LSE_TOL = 1e-5
# Forward + backward at mixtral's 1x48(8)x8192, above its tensors: 1/16 of
# one fp32 (B,H,S,T) score matrix (12.9 GB).
FLASH_BWD_PEAK_MAX = 0.8e9


def check_flash_mixtral(gen) -> dict:
    """flash_attention at mixtral-8x22b's shapes, bf16, window 4096: the
    1x8192 prefill (past the window) and 2x2048 (the serve waves and the
    training step), each against the plain version computed a chunk of
    query rows at a time; their times, bound and SDPA yardstick; whether
    the kernel skips the key tiles outside the window."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import fwd_path
    h, hkv = MIXTRAL_HEADS
    out = {}
    for label, b, s in (("1x8192", 1, 8192), ("2x2048", 2, 2048)):
        q, k, v = _attn_inputs(gen, b, h, hkv, s, s, 128, torch.bfloat16)
        got = flash_attention(q, k, v, causal=True, window=MIXTRAL_WINDOW)
        ref = attention_ref(q, k, v, causal=True, window=MIXTRAL_WINDOW,
                            row_chunk=PLAIN_ROW_CHUNK)
        err = _err_within(f"flash_attention mixtral {label}", got, ref,
                          TOL[torch.bfloat16])
        log(f"[kernels] flash_attention mixtral {label} bf16 "
            f"({fwd_path(torch.bfloat16, 128)}) B={b} H={h} "
            f"Hkv={hkv} S=T={s} hd=128 causal window={MIXTRAL_WINDOW}: "
            f"max_abs_err={err} (tol {TOL[torch.bfloat16]}) ok")
        out[label] = dict(_flash_window_times(q, k, v, MIXTRAL_WINDOW),
                          max_abs_err=err)
        del q, k, v, got, ref
    long = out["1x8192"]
    log(f"[kernels] flash_attention skips the key tiles outside the window: "
        f"each q-tile's key range starts at max(0, q0 - window + 1) "
        f"(flash_attention_fwd_sm90.cu, kv_lo); at 1x8192 window 4096 takes "
        f"{long['ms']:.4f} ms against {long['no_window_ms']:.4f} ms causal "
        f"without one ({long['ms'] / long['no_window_ms']:.3f}; valid pairs "
        f"{long['valid_pairs'] / long['no_window_pairs']:.3f})")
    return out


def _flash_window_times(q, k, v, window: int) -> dict:
    """Kernel ms a call and on the card alone, plain ms (row chunks), SDPA
    ms with the window as an explicit boolean mask (k, v expanded to every
    query head beforehand), the bound over the window's valid pairs, and
    the kernel without the window beside SDPA causal without a mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]

    def call():
        return flash_attention(q, k, v, causal=True, window=window)

    kernel_ms = cuda_ms(call, 20)
    alone_ms = queued_ms(call)
    no_window_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True,
                                             window=window,
                                             row_chunk=PLAIN_ROW_CHUNK),
                       3, warmup=1)
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(t, device="cuda")[None, :]
    mask = (kj <= qi) & ((qi - kj) < window)
    kx, vx = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=mask), 10)
    # a mask keeps SDPA off its flash backend: causal without the window
    # is the yardstick of the kernel without the window
    library_causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, is_causal=True), 10)
    del mask, kx, vx
    from repro_torch.kernels.flash_attention.ops import cost as flash_cost
    pairs = _valid_pairs(s, t, True, window)
    flops, nbytes, _ = flash_cost(q, k, v, causal=True, window=window)
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    times = {
        "shape": f"{str(q.dtype)[6:]} B={b} H={h} Hkv={hkv} S={s} T={t} "
                 f"hd={hd} causal window={window}",
        "ms": kernel_ms, "alone_ms": alone_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "flops": flops, "bytes": nbytes,
        "valid_pairs": pairs, "no_window_ms": no_window_ms,
        "library_causal_ms": library_causal_ms,
        "no_window_pairs": _valid_pairs(s, t, True, 0),
        "tflops": flops / kernel_ms / 1e9,
        "share_of_bound": bound_ms / kernel_ms,
        "kernel_over_library": kernel_ms / library_ms,
    }
    log(f"[kernels] flash_attention at {times['shape']}: kernel "
        f"{kernel_ms:.4f} ms a call, {alone_ms:.4f} ms on the card alone, "
        f"plain {plain_ms:.4f} ms (rows {PLAIN_ROW_CHUNK} a chunk), sdpa "
        f"with the window as a mask {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({times['bound_by']}: {flops} flop over {pairs} "
        f"valid pairs, {nbytes} bytes); {times['tflops']:.1f} TFLOP/s, "
        f"{times['share_of_bound']:.3f} of the bound, kernel / sdpa "
        f"{times['kernel_over_library']:.3f}; without the window kernel "
        f"{no_window_ms:.4f} ms, sdpa causal without a mask "
        f"{library_causal_ms:.4f} ms")
    return times


MIXTRAL_TRAIN_LABEL = "mixtral training 2x2048"


# The backward's training shapes beside mixtral's (phase 5c's attention
# calls): (label, B, H, Hkv, S = T, q/k hd, v hd, window), all causal bf16.
BWD_TRAIN_SHAPES = (
    ("stablelm 2x32x2048x64", 2, 32, 32, 2048, 64, 64, 0),
    ("gemma3 1x16(8)x2048x256 window 1024", 1, 16, 8, 2048, 256, 256, 1024),
    ("gemma3 1x16(8)x2048x256 global", 1, 16, 8, 2048, 256, 256, 0),
    ("MLA 1x128x2048x192, v padded from 128", 1, 128, 128, 2048, 192, 128,
     0),
    ("phi3 1x40(10)x2048x128", 1, 40, 10, 2048, 128, 128, 0),
)


def _sdpa_bwd(q, k, v, dout, window: int) -> dict:
    """SDPA's backward alone on the backward's inputs, the library call
    nearest the function: one forward (causal; a window shorter than S as
    an explicit boolean mask, which computes the same function), then
    `torch.autograd.grad` of its output with the graph kept, timed (CUDA
    events), and the device kernels it ran (`_bwd_kernel_split`)."""
    import torch.nn.functional as F
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    kw = {"enable_gqa": True} if hkv != h else {}
    if 0 < window < s:
        qi = torch.arange(s, device=q.device)[:, None]
        kj = torch.arange(t, device=q.device)[None, :]
        kw["attn_mask"] = (kj <= qi) & ((qi - kj) < window)
    else:
        kw["is_causal"] = True
    out = F.scaled_dot_product_attention(*xs, **kw)

    def bwd():
        return torch.autograd.grad(out, xs, dout, retain_graph=True)
    return {"ms": cuda_ms(bwd, 10), "kernels_ms": _bwd_kernel_split(bwd)}


def _bwd_cases() -> list:
    """The shapes `check_flash_backward` holds the backward at: (label, B,
    H, Hkv, S, T, q/k hd, v hd, causal, window, softcap, dtypes)."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    f32, bf16 = torch.float32, torch.bfloat16
    h, hkv = MIXTRAL_HEADS
    gh, ghkv = GEMMA3_HEADS
    cases = [
        ("GQA 4:1 window 64", 1, 8, 2, 256, 256, 64, 64, True, 64, 0.0,
         (f32,)),
        *[(f"head_dim {hd}, GQA 2:1, ragged S=200", 1, 4, 2, 200, 200, hd,
           hd, True, 0, 0.0, (f32, bf16)) for hd in HEAD_DIMS],
        *[(f"head_dim {hd}, softcap 2, window 50, S=130", 1, 4, 2, 130, 130,
           hd, hd, True, 50, 2.0, (f32, bf16)) for hd in HEAD_DIMS],
        ("non-causal window 64 S=100 T=160", 1, 4, 4, 100, 160, 32, 32,
         False, 64, 0.0, (f32, bf16)),
        ("seamless cross 2x16x32 over 512 frames", 2, 16, 16, 32, 512, 64,
         64, False, 0, 0.0, (f32, bf16)),
        ("seamless cross 2048 over 2048", 1, 16, 16, 2048, 2048, 64, 64,
         False, 0, 0.0, (bf16,)),
        *[(f"gemma3 1x16(8)x2048x256 {what}, softcap {cap:g}", 1, gh, ghkv,
           2048, 2048, GEMMA3_HD, GEMMA3_HD, True, window, cap, (bf16,))
          for what, window in (("window 1024", GEMMA3_WINDOW),
                               ("global", 0))
          for cap in (LAUNCH_SOFTCAP, 0.0)],
        (f"MLA 1x128x2048x192, v padded from {MLA_V}", 1, MLA_HEADS,
         MLA_HEADS, 2048, 2048, MLA_QK, MLA_V, True, 0, 0.0, (bf16,)),
        ("deepseek smoke hd 48 through the wrapper's padding", 2, 4, 4, 64,
         64, 48, 48, True, 0, 0.0, (f32, bf16)),
        (MIXTRAL_TRAIN_LABEL, 2, h, hkv, 2048, 2048, 128, 128, True,
         MIXTRAL_WINDOW, 0.0, (bf16,)),
    ]
    return cases


def _bwd_case_inputs(gen, b, h, hkv, s, t, hd, v_hd, dt):
    """q, k, v as `_attn_inputs` makes them (v zero-padded from v_hd to hd,
    as MLA pads it) and dout (B,H,S,hd), 0 in the padded columns as the
    cropped output gives it."""
    import torch.nn.functional as F
    q, k, v = _attn_inputs(gen, b, h, hkv, s, t, hd, dt)
    if v_hd != hd:
        v = F.pad(v[..., :v_hd], (0, hd - v_hd))
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
    dout[..., v_hd:] = 0
    return q, k, v, dout


def _flash_bwd_times(q, k, v, dout, window: int) -> dict:
    """At one training shape: the forward, forward + backward and the
    backward alone (a call, and on the card alone) through the kernels;
    the plain backward; SDPA's forward + backward causal without the
    window (the library call nearest the function; it takes no window);
    the recompute backward the port ran before the kernel (the forward
    kernel, then autograd through `attention_ref`), once; the backward's
    bound (`ops.bwd_cost`); each of its three kernels' device time in one
    call (`torch.profiler`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref, ops)
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    mask = {"causal": True, "window": window, "softcap": 0.0}
    xs = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        return torch.autograd.grad(
            ops.flash_attention(*xs, **mask), xs, dout)
    out, lse = ops._launch(q, k, v, with_lse=True, **mask)

    def bwd():
        return ops._launch_bwd(q, k, v, out, lse, dout, **mask)
    ref_out, ref_lse = attention_ref(q, k, v, return_lse=True,
                                     row_chunk=PLAIN_ROW_CHUNK, **mask)

    def recompute():
        ops._launch(q, k, v, **mask)
        ys = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(attention_ref(*ys, **mask), ys, dout)
    gqa = {"enable_gqa": True} if hkv != h else {}

    def sdpa():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            *xs, is_causal=True, **gqa), xs, dout)
    times = {
        "path": ops.bwd_path(q.dtype, hd),
        "fwd_ms": cuda_ms(lambda: ops.flash_attention(q, k, v, **mask), 10),
        "fwd_bwd_ms": cuda_ms(fwd_bwd, 10),
        "ms": cuda_ms(bwd, 10),
        "alone_ms": queued_ms(bwd),
        "plain_ms": cuda_ms(lambda: attention_bwd_ref(
            q, k, v, ref_out, ref_lse, dout, **mask), 3, warmup=1),
        "sdpa_fwd_bwd_ms": cuda_ms(sdpa, 10),
        "recompute_fwd_bwd_ms": cuda_ms(recompute, 1, warmup=1),
    }
    times["kernels_ms"] = _bwd_kernel_split(bwd)
    sdpa_bwd = _sdpa_bwd(q, k, v, dout, window)
    times["library_ms"] = sdpa_bwd["ms"]
    times["library_kernels_ms"] = sdpa_bwd["kernels_ms"]
    flops, nbytes, _ = ops.bwd_cost(q, k, v, **mask)
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    times.update(
        shape=f"{str(q.dtype)[6:]} B={b} H={h} Hkv={hkv} S=T={s} hd={hd} "
              f"causal window={window}",
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, bytes=nbytes)
    times["share_of_bound"] = times["bound_ms"] / times["ms"]
    log(f"[kernels] flash_attention backward ({times['path']}) at "
        f"{times['shape']}: forward "
        f"{times['fwd_ms']:.4f} ms, forward + backward "
        f"{times['fwd_bwd_ms']:.4f} ms, backward alone {times['ms']:.4f} ms "
        f"a call and {times['alone_ms']:.4f} ms on the card alone, bound "
        f"{times['bound_ms']:.4f} ms ({times['bound_by']}: {flops} flop, "
        f"{nbytes} bytes; {times['share_of_bound']:.3f} of it); plain "
        f"backward {times['plain_ms']:.4f} ms; SDPA forward + backward "
        f"causal without the window {times['sdpa_fwd_bwd_ms']:.4f} ms; the "
        f"recompute backward (forward kernel + autograd through "
        f"attention_ref) {times['recompute_fwd_bwd_ms']:.4f} ms once; its "
        f"kernels' device ms in one call {times['kernels_ms']}; SDPA's "
        f"backward alone {times['library_ms']:.4f} ms, its kernels "
        f"{times['library_kernels_ms']}")
    return times


def _bwd_train_shape_times(gen) -> dict:
    """The backward at each BWD_TRAIN_SHAPES shape: its design
    (`ops.bwd_path`), ms a call and on the card alone, each kernel's device
    ms, the bound (`ops.bwd_cost`) and its share, and SDPA's backward
    alone (`_sdpa_bwd`)."""
    from repro_torch.kernels.flash_attention import ops
    out = {}
    for label, b, h, hkv, s, hd, v_hd, window in BWD_TRAIN_SHAPES:
        q, k, v, dout = _bwd_case_inputs(gen, b, h, hkv, s, s, hd, v_hd,
                                         torch.bfloat16)
        mask = {"causal": True, "window": window, "softcap": 0.0}
        o, lse = ops._launch(q, k, v, with_lse=True, **mask)

        def bwd():
            return ops._launch_bwd(q, k, v, o, lse, dout, **mask)
        flops, nbytes, _ = ops.bwd_cost(q, k, v, v_head_dim=v_hd, **mask)
        t_ops = flops / PEAK_FLOPS[torch.bfloat16]
        t_bytes = nbytes / PEAK_BYTES_PER_S
        r = {"path": ops.bwd_path(q.dtype, hd), "ms": cuda_ms(bwd, 10),
             "alone_ms": queued_ms(bwd), "kernels_ms": _bwd_kernel_split(bwd),
             "bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "flops": flops, "bytes": nbytes}
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        sdpa_bwd = _sdpa_bwd(q, k, v, dout, window)
        r["library_ms"] = sdpa_bwd["ms"]
        r["library_kernels_ms"] = sdpa_bwd["kernels_ms"]
        log(f"[kernels] flash_attention backward ({r['path']}) at {label}: "
            f"{r['ms']:.4f} ms a call, {r['alone_ms']:.4f} on the card "
            f"alone, bound {r['bound_ms']:.4f} ({r['bound_by']}: {flops} "
            f"flop, {nbytes} bytes; {r['share_of_bound']:.3f} of it); "
            f"kernels {r['kernels_ms']}; SDPA's backward alone "
            f"{r['library_ms']:.4f} ms, its kernels "
            f"{r['library_kernels_ms']}")
        out[label] = r
        del q, k, v, dout, o, lse
        release_memory()
    return out


def _bwd_kernel_split(call) -> dict:
    """Device ms of each CUDA kernel `call` launches, by the name's
    `flash_bwd_*` part (one profiled call after a synchronize)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            m = re.search(r"flash_bwd_\w+", e.key)
            name = m.group(0) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def _bwd_peak_8192(gen) -> dict:
    """Forward + backward at mixtral's 1x48(8)x8192x128, window 4096: the
    peak of `max_memory_allocated` above the bytes of q, k, v, dout, out
    and the three grads, at most FLASH_BWD_PEAK_MAX."""
    from repro_torch.kernels.flash_attention import flash_attention
    h, hkv = MIXTRAL_HEADS
    q, k, v, dout = _bwd_case_inputs(gen, 1, h, hkv, 8192, 8192, 128, 128,
                                     torch.bfloat16)
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    del q, k, v
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = flash_attention(*xs, causal=True, window=MIXTRAL_WINDOW)
    grads = torch.autograd.grad(out, xs, dout)
    torch.cuda.synchronize()
    own = sum(x.numel() * x.element_size() for x in (out, *grads))
    extra = torch.cuda.max_memory_allocated() - base - own
    tensors = own + sum(x.numel() * x.element_size() for x in (*xs, dout))
    score_bytes = 4 * h * 8192 * 8192
    log(f"[kernels] flash_attention forward + backward at bf16 B=1 H={h} "
        f"Hkv={hkv} S=T=8192 hd=128 window {MIXTRAL_WINDOW}: "
        f"max_memory_allocated {extra} bytes above q, k, v, dout, out and "
        f"the grads ({tensors} bytes; one fp32 (B,H,S,T) score matrix "
        f"{score_bytes}); limit {FLASH_BWD_PEAK_MAX}")
    if not extra <= FLASH_BWD_PEAK_MAX:
        raise AssertionError(f"flash forward + backward at 1x8192 took "
                             f"{extra} bytes beside its tensors")
    return {"peak_above_tensors": extra, "tensor_bytes": tensors,
            "score_matrix_bytes": score_bytes}


def check_flash_backward(gen) -> dict:
    """`_FlashAttention` on the card at every `_bwd_cases` shape: a call
    that needs grads launches the forward kernel once, its output carries
    the function's grad_fn, and its backward launches the backward kernels
    once; dq, dk, dv against `attention_bwd_ref` (from the plain version's
    out and lse) and against autograd through `attention_ref`
    (FLASH_GRAD_TOL), the output against the plain version (TOL), and the
    forward's lse against the plain version's (FLASH_LSE_TOL; for the
    shapes the wrapper does not pad); at bf16 hd 192 and 256, two backward
    calls bit-equal. At mixtral's training shape the
    times (`_flash_bwd_times`); at its 1x8192 the peak memory
    (`_bwd_peak_8192`). Returns the backward's entry of the kernels line
    (its launches are the main paths', filled in by `main`)."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention, ops)
    res = {}
    main = None
    for (label, b, h, hkv, s, t, hd, v_hd, causal, window, cap,
         dtypes) in _bwd_cases():
        for dt in dtypes:
            q, k, v, dout = _bwd_case_inputs(gen, b, h, hkv, s, t, hd, v_hd,
                                             dt)
            mask = {"causal": causal, "window": window, "softcap": cap}
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            before = (flash_attention.launches, flash_attention.bwd_launches)
            out = flash_attention(*xs, **mask)
            own_grad_fn = (hd not in ops.HEAD_DIMS or   # padded: cropped
                           type(out.grad_fn).__name__
                           == "_FlashAttentionBackward")
            if flash_attention.launches != before[0] + 1 or not own_grad_fn:
                raise AssertionError(f"flash backward {label}: launches "
                                     f"{flash_attention.launches - before[0]}"
                                     f", grad_fn {out.grad_fn}")
            grads = torch.autograd.grad(out, xs, dout)
            torch.cuda.synchronize()
            if flash_attention.bwd_launches != before[1] + 1:
                raise AssertionError(
                    f"flash backward {label}: backward launches "
                    f"{flash_attention.bwd_launches - before[1]}")
            ref_out, ref_lse = attention_ref(q, k, v, return_lse=True,
                                             row_chunk=PLAIN_ROW_CHUNK,
                                             **mask)
            blockwise = attention_bwd_ref(q, k, v, ref_out, ref_lse, dout,
                                          **mask)
            ys = [x.detach().requires_grad_() for x in (q, k, v)]
            autograd = torch.autograd.grad(attention_ref(*ys, **mask), ys,
                                           dout)
            what = f"flash backward {label} {str(dt)[6:]}"
            errs = {"out": _err_within(f"{what} out", out.detach(), ref_out,
                                       TOL[dt])}
            for name, g, w1, w2 in zip(("dq", "dk", "dv"), grads, blockwise,
                                       autograd):
                errs[name] = _err_within(f"{what} {name}", g, w1,
                                         FLASH_GRAD_TOL[dt])
                errs[f"{name} vs autograd"] = _err_within(
                    f"{what} {name} vs autograd", g, w2, FLASH_GRAD_TOL[dt])
            if hd in ops.HEAD_DIMS:
                out1, lse = ops._launch(q, k, v, with_lse=True, **mask)
                errs["lse"] = _err_within(f"{what} lse", lse, ref_lse,
                                          FLASH_LSE_TOL)
            if dt == torch.bfloat16 and hd in (192, 256):
                # the wide design adds dQ into a q tile in key-tile order:
                # two calls give the same bits
                first, again = (ops._launch_bwd(q, k, v, out1, lse, dout,
                                                **mask) for _ in range(2))
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    raise AssertionError(f"{what}: two backward calls differ")
                errs["two calls bit-equal"] = True
                del first, again
            res[f"{label} {str(dt)[6:]}"] = errs
            log(f"[kernels] flash_attention backward {label} {str(dt)[6:]} "
                f"B={b} H={h} Hkv={hkv} S={s} T={t} hd={hd} v hd={v_hd} "
                f"causal={causal} window={window} softcap={cap:g}: max abs "
                f"err {errs} (out tol {TOL[dt]}, grads tol "
                f"{FLASH_GRAD_TOL[dt]}, lse tol {FLASH_LSE_TOL}) ok")
            if label == MIXTRAL_TRAIN_LABEL:
                main = (q, k, v, dout, window,
                        max(errs[n] for n in ("dq", "dk", "dv")))
            del q, k, v, dout, xs, ys, out, grads, blockwise, autograd
            del ref_out, ref_lse
        release_memory()
    q, k, v, dout, window, err = main
    csrc = "src/repro_torch/kernels/flash_attention/csrc/"
    entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        # the design of every bf16 head_dim but 32; the source of each
        # design by name in "sources"
        "source": csrc + "flash_attention_bwd_sm90.cu",
        "sources": {ops.SM90_PATH: csrc + "flash_attention_bwd_sm90.cu",
                    **{path: csrc + "flash_attention_bwd.cu"
                       for path in ops.PATHS.values()}},
        # the Pallas kernel is a forward only; the reference differentiates
        # `blockwise_sdpa` by this custom VJP
        "replaces": "src/repro/models/attention.py:153",
        "launches": None,
        "max_abs_err": err,
        **_flash_bwd_times(q, k, v, dout, window),
        "cases": res,
        # which design serves each dtype and head_dim on the card
        "designs": {f"{str(dt)[6:]} {hd}": ops.bwd_path(dt, hd)
                    for dt in (torch.float32, torch.bfloat16)
                    for hd in ops.HEAD_DIMS},
    }
    del q, k, v, dout
    release_memory()
    entry["at_train_shapes"] = _bwd_train_shape_times(gen)
    entry["at_1x8192"] = _bwd_peak_8192(gen)
    return entry


# gemma3-12b's attention: 16 heads over 8 KV heads, head_dim 256, five
# layers of six windowed to 1024 keys.
GEMMA3_HEADS, GEMMA3_HD, GEMMA3_WINDOW = (16, 8), 256, 1024
# deepseek-v2's MLA in prefill: 128 heads, queries and keys of nope 128 +
# rope 64 = 192 channels, values of 128 zero-padded to 192 for the kernel.
MLA_HEADS, MLA_QK, MLA_V = 128, 192, 128
# The rest of the bf16 shapes the served models hand flash in phases 4e-4g:
# (label, B, H, Hkv, S, T, hd, causal). The trace waves' prompts are shorter
# than gemma3's window of 1024, which then masks nothing.
MAIN_PATH_FLASH_SHAPES = (
    ("gemma3 trace 3x8", 3, 16, 8, 8, 8, 256, True),
    ("gemma3 trace 1x32", 1, 16, 8, 32, 32, 256, True),
    ("MLA trace 3x8", 3, 128, 128, 8, 8, 192, True),
    ("MLA 1x32", 1, 128, 128, 32, 32, 192, True),
    ("seamless encoder", 2, 16, 16, 512, 512, 64, False),
    ("seamless decoder self", 2, 16, 16, 32, 32, 64, True),
    ("seamless cross 32 over 512 frames", 2, 16, 16, 32, 512, 64, False),
    ("internvl2 256 image + 32 tokens", 2, 16, 8, 288, 288, 128, True),
    ("phi3 trace", 1, 40, 10, 32, 32, 128, True),
    ("phi3 2x2048", 2, 40, 10, 2048, 2048, 128, True),
    ("mistral-large trace", 1, 96, 8, 32, 32, 128, True),
    ("mistral-large 2x2048", 2, 96, 8, 2048, 2048, 128, True),
)
# The SDPA backends tried one at a time beside the default's choice.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def _sdpa_backends(q, k, v) -> dict:
    """Which SDPA backends take a causal call on these inputs, and each
    one's ms; and the CUDA kernels of the default call (the backend it
    picked), from the profiler."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name in SDPA_BACKENDS:
        try:
            # a refusing backend warns why before it raises: the error
            # line is kept instead
            with sdpa_kernel([getattr(SDPBackend, name)]), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 5, warmup=1)
        except RuntimeError as e:
            out[name] = f"refused: {str(e).splitlines()[0][:80]}"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    out["default_kernels"] = [e.key[:100] for e in kernels[:3]]
    return out


def check_flash_new_head_dims(gen) -> dict:
    """flash_attention at head_dim 256 and 192, each against the
    plain version: gemma3-12b's bf16 2x16(8)x2048x256 prefill windowed to
    1024 and global, and its 1x8192 windowed (the plain version a chunk of
    query rows at a time); deepseek-v2's MLA prefill, bf16 2x128x2048 at
    192 with the values zero-padded from 128 (the output's last 64 columns
    must be 0); an fp32 case at each new head dim on the CUDA-core path;
    and every other bf16 shape phases 4e-4g hand the kernel
    (MAIN_PATH_FLASH_SHAPES: seamless's encoder and cross-attention,
    internvl2, phi3, mistral-large, the trace waves). Times beside the bound
    and SDPA (the backends that take MLA's 192/128 heads named)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import cost as flash_cost
    from repro_torch.kernels.flash_attention.ops import fwd_path
    import torch.nn.functional as F
    bf16 = torch.bfloat16
    h, hkv = GEMMA3_HEADS
    out = {}
    for label, b, s, window in (("2x2048 window 1024", 2, 2048, GEMMA3_WINDOW),
                                ("2x2048 global", 2, 2048, 0),
                                ("1x8192 window 1024", 1, 8192,
                                 GEMMA3_WINDOW)):
        q, k, v = _attn_inputs(gen, b, h, hkv, s, s, GEMMA3_HD, bf16)
        got = flash_attention(q, k, v, causal=True, window=window)
        ref = attention_ref(q, k, v, causal=True, window=window,
                            row_chunk=PLAIN_ROW_CHUNK)
        err = _err_within(f"flash_attention gemma3 {label}", got, ref,
                          TOL[bf16])
        log(f"[kernels] flash_attention gemma3 {label} bf16 "
            f"({fwd_path(bf16, GEMMA3_HD)}) "
            f"B={b} H={h} Hkv={hkv} S=T={s} hd={GEMMA3_HD} causal "
            f"window={window}: max_abs_err={err} (tol {TOL[bf16]}) ok")
        times = (_flash_window_times(q, k, v, window) if window
                 else _flash_times(q, k, v))
        out[f"gemma3 {label}"] = dict(times, max_abs_err=err)
        del q, k, v, got, ref

    b, s = 2, 2048
    q, k, _ = _attn_inputs(gen, b, MLA_HEADS, MLA_HEADS, s, s, MLA_QK, bf16)
    v = _attn_inputs(gen, b, MLA_HEADS, MLA_HEADS, s, s, MLA_V, bf16)[2]
    vp = F.pad(v.transpose(1, 2), (0, MLA_QK - MLA_V)).transpose(1, 2)
    got = flash_attention(q, k, vp, causal=True)
    if not bool((got[..., MLA_V:] == 0).all()):
        raise AssertionError("MLA flash: the padded output columns are not 0")
    ref = attention_ref(q, k, vp, causal=True, row_chunk=PLAIN_ROW_CHUNK)
    err = _err_within("flash_attention MLA", got, ref, TOL[bf16])
    log(f"[kernels] flash_attention MLA bf16 ({fwd_path(bf16, MLA_QK)}) B={b} "
        f"H=Hkv={MLA_HEADS} S=T={s} q,k hd={MLA_QK} v {MLA_V} zero-padded "
        f"to {MLA_QK}: max_abs_err={err} (tol {TOL[bf16]}), padded columns "
        f"0 ok")
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, vp, causal=True), 10)
    pad_ms = cuda_ms(lambda: F.pad(v.transpose(1, 2), (0, MLA_QK - MLA_V)), 10)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, vp, causal=True,
                                             row_chunk=PLAIN_ROW_CHUNK),
                       3, warmup=1)
    backends = _sdpa_backends(q, k, v)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    # the function MLA needs: q.k over 192 channels, P.v over 128
    pairs = _valid_pairs(s, s, True, 0)
    flops, nbytes, _ = flash_cost(q, k, vp, causal=True, v_head_dim=MLA_V)
    t_ops, t_bytes = flops / PEAK_FLOPS[bf16], nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    out["MLA 2x2048"] = {
        "shape": f"bf16 B={b} H=Hkv={MLA_HEADS} S=T={s} q,k hd={MLA_QK} v "
                 f"hd={MLA_V} (padded to {MLA_QK}) causal",
        "ms": kernel_ms, "pad_ms": pad_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "sdpa_backends": backends,
        "flops": flops, "bytes": nbytes, "max_abs_err": err,
        "share_of_bound": bound_ms / kernel_ms,
        "kernel_over_library": kernel_ms / library_ms}
    log(f"[kernels] flash_attention MLA at {out['MLA 2x2048']['shape']}: "
        f"kernel {kernel_ms:.4f} ms (+ {pad_ms:.4f} ms for the pad), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms on v of {MLA_V}, bound "
        f"{bound_ms:.4f} ms ({out['MLA 2x2048']['bound_by']}: {flops} flop "
        f"for q.k over {MLA_QK} and P.v over {MLA_V}, {nbytes} bytes); "
        f"{bound_ms / kernel_ms:.3f} of the bound, kernel / sdpa "
        f"{kernel_ms / library_ms:.3f}; sdpa backends one at a time: "
        f"{backends}")
    del q, k, v, vp, got, ref

    f32 = torch.float32
    for label, b, h_, hkv_, s, t, hd, causal, window in (
            ("gemma3 GQA 2:1 window 100", 1, 4, 2, 300, 300, 256, True, 100),
            ("non-causal S!=T", 1, 4, 4, 40, 130, 256, False, 0),
            ("MLA causal ragged", 2, 4, 4, 77, 77, 192, True, 0),
            ("non-causal S!=T", 1, 2, 2, 64, 200, 192, False, 0)):
        for dt in (f32, bf16):
            q, k, v = _attn_inputs(gen, b, h_, hkv_, s, t, hd, dt)
            got = flash_attention(q, k, v, causal=causal, window=window)
            err = _err_within(f"flash_attention {label} hd={hd} {dt}", got,
                              attention_ref(q, k, v, causal=causal,
                                            window=window), TOL[dt])
            log(f"[kernels] flash_attention {label} {str(dt)[6:]} "
                f"({fwd_path(dt, hd)}) B={b} H={h_} Hkv={hkv_} S={s} T={t} hd={hd} "
                f"causal={causal} window={window}: max_abs_err={err} (tol "
                f"{TOL[dt]}) ok")
            if dt == f32:
                out[f"fp32 hd={hd} {label}"] = {
                    "max_abs_err": err, "ms": cuda_ms(
                        lambda: flash_attention(q, k, v, causal=causal,
                                                window=window), 10)}

    # the other bf16 shapes phases 4f-4g hand the kernel
    for label, b, h_, hkv_, s, t, hd, causal in MAIN_PATH_FLASH_SHAPES:
        q, k, v = _attn_inputs(gen, b, h_, hkv_, s, t, hd, bf16)
        got = flash_attention(q, k, v, causal=causal)
        err = _err_within(f"flash_attention {label}", got, attention_ref(
            q, k, v, causal=causal, row_chunk=PLAIN_ROW_CHUNK), TOL[bf16])
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), 10)
        gqa = {"enable_gqa": True} if hkv_ != h_ else {}
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, **gqa), 10)
        flops, nbytes, _ = flash_cost(q, k, v, causal=causal)
        t_ops, t_bytes = flops / PEAK_FLOPS[bf16], nbytes / PEAK_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernels] flash_attention {label} bf16 ({fwd_path(bf16, hd)}) B={b} "
            f"H={h_} Hkv={hkv_} S={s} T={t} hd={hd} causal={causal}: "
            f"max_abs_err={err} (tol {TOL[bf16]}) ok; kernel {ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms (kernel / sdpa "
            f"{ms / library_ms:.3f}), bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops} flop, {nbytes} bytes), {bound_ms / ms:.3f} of it")
        out[label] = {"max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms,
                      "share_of_bound": bound_ms / ms}
        del q, k, v, got
    return out


def _launch_flash_shapes() -> list:
    """The flash calls of phase 5c: each LAUNCH_TRAIN arch's training step
    at its batch (self-attention causal, windowed where the layer is SWA,
    MLA at nope + rope with the values zero-padded; the encoder non-causal
    and cross-attention over as many frames as tokens), jamba's smoke step,
    and deepseek's smoke serve waves in 5c(e), whose MLA head_dim of 48 the
    wrapper pads to 64; and each phase 10 case's rank (its rows and heads,
    an encoder's and cross-attention's calls too). (label, dtype, B, H,
    Hkv, S, T, q/k hd, v hd, causal, window)."""
    from repro_torch.configs.base import MLA, SWA
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import launch_config
    runs = [(arch, get_config(arch), b, s)
            for arch, _, b, s, _ in LAUNCH_TRAIN]
    runs += [("jamba smoke", launch_config("jamba-1.5-large-398b", True),
              *JAMBA_SMOKE_TRAIN),
             ("deepseek smoke serve", launch_config("deepseek-v2-236b", True),
              8, 32)]
    out = []
    # a rank's heads in phase 10: its rows of the batch, its query heads
    # (each count the ranks of the model axis take), its own KV heads or
    # those expanded to its query heads, the layer's window
    for sc in SHARDED_TRAIN:
        cfg = _sharded_config(sc)
        (data, model), s = sc.mesh, sc.seq_len
        dt, b = getattr(torch, cfg.param_dtype), sc.batch // data
        for heads, hkv in dict.fromkeys(_rank_heads(cfg, model, m)
                                        for m in range(model)):
            out += _rank_flash_shapes(sc, cfg, dt, b, heads, hkv, s)
    for what, cfg, b, s in runs:

        dt = getattr(torch, cfg.param_dtype)
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        for kind in dict.fromkeys(cfg.pattern):
            if kind == MLA:
                m = cfg.mla
                qk = m.nope_head_dim + m.rope_head_dim
                out.append((f"{what} MLA", dt, b, h, h, s, s, qk,
                            m.v_head_dim, True, 0))
            elif kind == SWA:
                out.append((f"{what} SWA", dt, b, h, hkv, s, s, hd, hd, True,
                            cfg.window_size))
            elif kind == "attn":
                out.append((f"{what} self", dt, b, h, hkv, s, s, hd, hd,
                            True, 0))
        if cfg.encoder_layers:
            out += [(f"{what} encoder", dt, b, h, hkv, s, s, hd, hd, False, 0),
                     (f"{what} cross {s} over {s} frames", dt, b, h, hkv, s,
                      s, hd, hd, False, 0)]
    # a shape two cases hand flash is held once
    seen = set()
    return [c for c in out if c[1:] not in seen and not seen.add(c[1:])]


def _rank_flash_shapes(sc, cfg, dt, b: int, heads: int, hkv: int,
                       s: int) -> list:
    """The flash calls of a phase 10 rank of `heads` query heads over
    `hkv` KV heads, in `_launch_flash_shapes`' form."""
    from repro_torch.configs.base import MLA, SWA
    out = []
    label = f"{sc.arch} rank of {sc.mesh}, {heads} heads (phase 10)"
    for kind in dict.fromkeys(cfg.pattern):
        if kind == MLA:
            m = cfg.mla
            out.append((f"{label} MLA", dt, b, heads, heads, s, s,
                        m.nope_head_dim + m.rope_head_dim, m.v_head_dim,
                        True, 0))
        elif kind in (SWA, "attn"):
            window = cfg.window_size if kind == SWA else 0
            out.append((label + (f" window {window}" if window else ""),
                        dt, b, heads, hkv, s, s, cfg.head_dim,
                        cfg.head_dim, True, window))
    if cfg.encoder_layers:
        out += [(f"{label} encoder", dt, b, heads, hkv, s, s,
                 cfg.head_dim, cfg.head_dim, False, 0),
                (f"{label} cross {s} over {s} frames", dt, b, heads, hkv,
                 s, s, cfg.head_dim, cfg.head_dim, False, 0)]
    return out


def check_flash_launch_shapes(gen) -> dict:
    """flash_attention against the plain version (TOL of the dtype, the
    plain version a chunk of query rows at a time) at every shape of
    `_launch_flash_shapes`; the MLA output's padded columns must be 0.
    Each beside its bound and SDPA (on the unpadded values, causal; a
    window as a boolean mask)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import cost as flash_cost
    from repro_torch.kernels.flash_attention.ops import fwd_path
    out = {}
    for label, dt, b, h, hkv, s, t, hd, v_hd, causal, window in \
            _launch_flash_shapes():
        q, k, v = _attn_inputs(gen, b, h, hkv, s, t, hd, dt)
        v_own = v[..., :v_hd]
        if v_hd != hd:
            v = F.pad(v_own, (0, hd - v_hd))

        def call():
            return flash_attention(q, k, v, causal=causal, window=window)
        got = call()
        if v_hd != hd and not bool((got[..., v_hd:] == 0).all()):
            raise AssertionError(f"flash {label}: padded columns not 0")
        err = _err_within(f"flash_attention {label}", got, attention_ref(
            q, k, v, causal=causal, window=window,
            row_chunk=PLAIN_ROW_CHUNK), TOL[dt])
        ms = cuda_ms(call, 10)
        if not window:
            gqa = {"enable_gqa": True} if hkv != h else {}
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v_own, is_causal=causal, **gqa), 10)
        else:
            # the window as a boolean mask (k, v expanded to the query
            # heads), as for mixtral's window in phase 2
            qi = torch.arange(s, device="cuda")[:, None]
            kj = torch.arange(t, device="cuda")[None, :]
            mask = (qi - kj) < window
            if causal:
                mask &= kj <= qi
            kx, vx = (x.repeat_interleave(h // hkv, dim=1)
                      for x in (k, v_own))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kx, vx, attn_mask=mask), 10)
            del mask, kx, vx
        flops, nbytes, _ = flash_cost(q, k, v, causal=causal, window=window,
                                      v_head_dim=v_hd)
        t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernels] flash_attention {label} {str(dt)[6:]} "
            f"({fwd_path(dt, hd)}) B={b} H={h} "
            f"Hkv={hkv} S={s} T={t} hd={hd} v hd={v_hd} causal={causal} "
            f"window={window}: max_abs_err={err} (tol {TOL[dt]}) ok; kernel "
            f"{ms:.4f} ms, sdpa" + (" (the window as a mask)" if window
                                    else "")
            + f" {library_ms:.4f} ms (kernel / sdpa {ms / library_ms:.3f})"
            + f", bound {bound_ms:.4f} ms ({bound_by}: {flops} flop, "
            f"{nbytes} bytes), {bound_ms / ms:.3f} of it")
        out[label] = {"max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v, v_own, got
    return out


def _mlstm_inputs(gen, b, h, s, hd, dtype, with_state=False):
    """q, k, v (B,H,S,hd) and gates (B,H,S) as views of (B,S,H,..) tensors,
    the layout the model hands the kernel; gates as the kernel tests make
    them; optionally a non-zero state (C [k, v], n, m)."""
    def mk(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    q, k, v = (mk(b, s, h, hd).to(dtype).transpose(1, 2) for _ in range(3))
    log_i = (mk(b, s, h) * 0.5).transpose(1, 2)
    log_f = torch.nn.functional.logsigmoid(mk(b, s, h) + 2.0).transpose(1, 2)
    state = None
    if with_state:
        state = (mk(b, h, hd, hd) * 0.3, mk(b, h, hd) * 0.3, mk(b, h))
    return (q, k, v, log_i, log_f), state


def _mlstm_err(label, dt, got, want, y_tol=None) -> float:
    """Max abs error of y and the state out; raises beyond the tolerance
    (y's: MLSTM_TOL of its dtype unless `y_tol` is given)."""
    (y, st), (ry, rst) = got, want
    err = 0.0
    for name, a, b in zip(("y", "C", "n", "m"), (y, *st), (ry, *rst)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"mlstm_scan {label} {name}: "
                                 f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        diff = (a.float() - b.float()).abs()
        tol = MLSTM_TOL[dt if name == "y" else torch.float32]
        if name == "y" and y_tol is not None:
            tol = y_tol
        bad = diff > tol + tol * b.float().abs()
        if not torch.isfinite(a).all() or bool(bad.any()):
            raise AssertionError(f"mlstm_scan {label} {dt} {name}: max abs err "
                                 f"{float(diff.max())} beyond tol {tol}")
        err = max(err, float(diff.max()))
    return err


def _mlstm_work(q, state) -> tuple:
    """Useful flops and bytes of one call: `mlstm_scan.ops.cost`, the count
    the dry run's trace adds up."""
    from repro_torch.kernels.mlstm_scan.ops import cost
    return cost(q, state)[:2]


_F32, _BF16 = torch.float32, torch.bfloat16
MLSTM_CASES = [  # (label, B, H, S, hd, dtypes, with_state)
    ("xlstm-125m training shape", 4, 4, 512, 384, (_BF16,), False),
    ("xlstm-125m task-graph shape", 4, 4, 128, 384, (_BF16,), False),
    *[(f"hd={hd}", 2, 4, 256, hd, (_F32, _BF16), False)
      for hd in (32, 64, 256, 384)],
    ("ragged S=40", 2, 4, 40, 64, (_F32, _BF16), False),
    ("ragged S=77 with state", 1, 4, 77, 384, (_F32, _BF16), True),
    ("ragged S=130 with state hd=32", 2, 4, 130, 32, (_F32, _BF16), True),
    *[(f"decode S=1 with state hd={hd}", 4, 4, 1, hd, (_F32, _BF16), True)
      for hd in (32, 64, 256, 384)],
    ("xlstm-125m launcher shape (phase 5c)", 2, 4, 128, 384, (_BF16,), False),
    ("xlstm-125m rank of (2, 2) (phase 10)", 1, 2, 128, 384, (_BF16,), False),
]
# the case timed beside the main shape: phase 10's rank shape
MLSTM_RANK_CASE = "xlstm-125m rank of (2, 2) (phase 10)"


def check_mlstm_scan(gen):
    from repro_torch.kernels.mlstm_scan import (mlstm_scan, mlstm_scan_ref,
                                                mlstm_scan_two_pass_ref)
    from repro_torch.kernels.mlstm_scan.ops import PATHS
    f32, bf16 = torch.float32, torch.bfloat16
    main = rank = None
    for label, b, h, s, hd, dtypes, with_state in MLSTM_CASES:
        for dt in dtypes:
            args, state = _mlstm_inputs(gen, b, h, s, hd, dt, with_state)
            got = mlstm_scan(*args, state)
            want = mlstm_scan_ref(*args, state)
            torch.cuda.synchronize()
            err = _mlstm_err(label, dt, got, want)
            two_pass = ""
            if dt == bf16:
                # the plain version that rounds where the kernels round
                err_tp = _mlstm_err(f"{label} vs the two-pass plain version",
                                    dt, got, mlstm_scan_two_pass_ref(
                                        *args, state),
                                    y_tol=MLSTM_TWO_PASS_TOL)
                two_pass = (f"; vs the two-pass plain version {err_tp} (tol "
                            f"{MLSTM_TWO_PASS_TOL})")
            log(f"[kernels] mlstm_scan {label} {str(dt)[6:]} ({PATHS[dt]}) "
                f"B={b} H={h} S={s} hd={hd}: max_abs_err={err} (tol "
                f"{MLSTM_TOL[dt]}, state {MLSTM_TOL[f32]}){two_pass} ok")
            if main is None:
                main = (args, err, err_tp)
            if label == MLSTM_RANK_CASE:
                rank = (args, err, err_tp)

    # chained: the state out of one call feeds the next, against one call
    # over the whole sequence
    for dt in (f32, bf16):
        args, _ = _mlstm_inputs(gen, 2, 4, 200, 384, dt)
        y1, st1 = mlstm_scan(*(x[:, :, :72] for x in args))
        y2, st2 = mlstm_scan(*(x[:, :, 72:] for x in args), st1)
        got = (torch.cat([y1, y2], dim=2), st2)
        want = mlstm_scan_ref(*args)
        torch.cuda.synchronize()
        err = _mlstm_err("chained 72+128", dt, got, want)
        two_pass = ""
        if dt == bf16:
            # the two-pass plain version chained at the same split
            ty1, tst1 = mlstm_scan_two_pass_ref(*(x[:, :, :72] for x in args))
            ty2, tst2 = mlstm_scan_two_pass_ref(*(x[:, :, 72:] for x in args),
                                                tst1)
            err_tp = _mlstm_err("chained 72+128 vs the two-pass plain "
                                "version", dt, got,
                                (torch.cat([ty1, ty2], dim=2), tst2),
                                y_tol=MLSTM_TWO_PASS_TOL)
            two_pass = f"; vs the two-pass plain version {err_tp}"
        log(f"[kernels] mlstm_scan chained 72+128 vs one call S=200 hd=384 "
            f"{str(dt)[6:]} ({PATHS[dt]}): max_abs_err={err}{two_pass} ok")

    # results repeat: two calls on each path give the same bits
    for dt, shape in ((bf16, (4, 4, 512, 384)), (f32, (2, 4, 77, 384))):
        args, state = _mlstm_inputs(gen, *shape, dt, with_state=True)
        first = mlstm_scan(*args, state)
        second = mlstm_scan(*args, state)
        torch.cuda.synchronize()
        for name, a, b in zip(("y", "C", "n", "m"), (first[0], *first[1]),
                              (second[0], *second[1])):
            if not torch.equal(a, b):
                raise AssertionError(f"mlstm_scan {PATHS[dt]}: two calls "
                                     f"differ in {name}")
        log(f"[kernels] mlstm_scan {str(dt)[6:]} ({PATHS[dt]}) B, H, S, hd = "
            f"{shape} with state: two calls bit-equal in y, C, n, m")

    args, err, err_two_pass = main
    q = args[0]
    b, h, s, hd = q.shape
    kernel_ms = cuda_ms(lambda: mlstm_scan(*args), 20)
    device_ms = queued_ms(lambda: mlstm_scan(*args))
    plain_ms = cuda_ms(lambda: mlstm_scan_ref(*args), 10)
    flops, nbytes = _mlstm_work(q, None)
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    entry = {
        "name": "mlstm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan/kernel.py:22",
        "path": PATHS[q.dtype],
        "paths": {str(dt)[6:]: path for dt, path in PATHS.items()},
        "cuda_launches_per_call": {"bfloat16": 2, "float32": 1},
        "shape": f"bf16 B={b} H={h} S={s} hd={hd}",
        "launches": None,
        "max_abs_err": err,
        "max_abs_err_vs_two_pass_plain": err_two_pass,
        "ms": kernel_ms,
        # the card alone, without the call's host cost (`queued_ms`)
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # no single PyTorch call computes a chunkwise mLSTM
        "library_ms": None,
        "flops": flops,
        "bytes": nbytes,
        "tflops": flops / device_ms / 1e9,
    }
    log(f"[kernels] mlstm_scan ({entry['path']}) at {entry['shape']}: kernel "
        f"{kernel_ms:.4f} ms a call, {device_ms:.4f} ms on the card alone, "
        f"plain {plain_ms:.4f} ms, no library call, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}: {flops} flop, "
        f"{nbytes} bytes); {entry['tflops']:.1f} TFLOP/s useful on the card; "
        f"max_abs_err vs the two-pass plain version {err_two_pass}")
    args, err, err_two_pass = rank
    q = args[0]
    flops, nbytes = _mlstm_work(q, None)
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    entry["at_rank_shape"] = r = {
        "shape": f"bf16 B, H, S, hd = {tuple(q.shape)} ({MLSTM_RANK_CASE})",
        "max_abs_err": err, "max_abs_err_vs_two_pass_plain": err_two_pass,
        "ms": cuda_ms(lambda: mlstm_scan(*args), 20),
        "device_ms": queued_ms(lambda: mlstm_scan(*args)),
        "plain_ms": cuda_ms(lambda: mlstm_scan_ref(*args), 10),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}
    log(f"[kernels] mlstm_scan at {r['shape']}: kernel {r['ms']:.4f} ms a "
        f"call, {r['device_ms']:.4f} ms on the card alone, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}: {flops} flop, {nbytes} bytes); max_abs_err "
        f"{err}, vs the two-pass plain version {err_two_pass}")
    return entry


def sweep_mlstm_seeds(seeds=MLSTM_SWEEP_SEEDS) -> dict:
    """Every bf16 case of phase 2 on the draws of other seeds. Each is
    held, as in phase 2, against the fp32 plain version at MLSTM_TOL's
    bf16 5e-2 and against the two-pass plain version at
    MLSTM_TWO_PASS_TOL; past the latter it logs, for each case, the worst
    element and the distance of the kernel and of the two-pass version
    from the truth (the fp32 plain version of the same inputs upcast, y
    not rounded) as a multiple of 1 + |truth|, then raises with every such
    case. Until the kernel and the two-pass version split P into two bf16
    parts for P v, a P entry that their fp32 sums left near a bf16 tie
    rounded either way, and 8-9 of the 240 draws were past 1e-2 where the
    denominator nearly cancels (ROADMAP C7)."""
    from repro_torch.kernels.mlstm_scan import (mlstm_scan, mlstm_scan_ref,
                                                mlstm_scan_two_pass_ref)
    from repro_torch.kernels.mlstm_scan.ops import CHUNK
    over = []
    worst_k = worst_tp = worst_ratio = 0.0
    cases = 0
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for label, b, h, s, hd, dtypes, with_state in MLSTM_CASES:
            if _BF16 not in dtypes:
                continue
            args, state = _mlstm_inputs(gen, b, h, s, hd, _BF16, with_state)
            got = mlstm_scan(*args, state)
            _mlstm_err(f"{label} seed {seed}", _BF16, got,
                       mlstm_scan_ref(*args, state))
            y = got[0].float()
            tp = mlstm_scan_two_pass_ref(*args, state)[0].float()
            truth = mlstm_scan_ref(*(x.float() for x in args), state)[0]
            torch.cuda.synchronize()
            cases += 1
            scale = 1.0 + truth.abs()
            rel_k = ((y - truth).abs() / scale).max().item()
            rel_tp = ((tp - truth).abs() / scale).max().item()
            worst_k, worst_tp = max(worst_k, rel_k), max(worst_tp, rel_tp)
            ratio = (y - tp).abs() / (MLSTM_TWO_PASS_TOL * (1.0 + tp.abs()))
            i = int(ratio.argmax())
            worst_ratio = max(worst_ratio, ratio.flatten()[i].item())
            if ratio.flatten()[i] <= 1.0:
                continue
            bi, hi, si, di = (int(x) for x in np.unravel_index(i, y.shape))
            at = (bi, hi, si, di)
            row = {"seed": seed, "case": label,
                   "diff": abs(y[at] - tp[at]).item(),
                   "over_tol": ratio.flatten()[i].item(),
                   "truth": truth[at].item(),
                   "kernel_err": abs(y[at] - truth[at]).item(),
                   "two_pass_err": abs(tp[at] - truth[at]).item(),
                   "chunk": int(si) // CHUNK, "row": int(si) % CHUNK,
                   "kernel_rel_max": rel_k, "two_pass_rel_max": rel_tp}
            over.append(row)
            log(f"[kernels] mlstm_scan sweep seed {seed} {label}: y differs "
                f"from the two-pass plain version by {row['diff']} "
                f"({row['over_tol']:.3f} x its tolerance) at b={bi} h={hi} "
                f"s={si} (chunk {row['chunk']} row {row['row']}) d={di}: "
                f"truth {row['truth']}, kernel off by {row['kernel_err']}, "
                f"two-pass off by {row['two_pass_err']}; over the case, "
                f"most off the truth per 1 + |truth|: kernel {rel_k}, "
                f"two-pass {rel_tp}")
    log(f"[kernels] mlstm_scan sweep: {cases} bf16 cases over seeds "
        f"{list(seeds)} within {MLSTM_TOL[_BF16]} of the fp32 plain "
        f"version; {len(over)} beyond the two-pass tolerance "
        f"{MLSTM_TWO_PASS_TOL} (seeds {sorted({r['seed'] for r in over})}), "
        f"the largest |kernel - two-pass| {worst_ratio:.3f} x it; most off "
        f"the truth per 1 + |truth|: kernel {worst_k}, two-pass {worst_tp}")
    if over:
        raise AssertionError(
            f"mlstm_scan: {len(over)} of {cases} bf16 sweep cases differ "
            f"from the two-pass plain version beyond {MLSTM_TWO_PASS_TOL} + "
            f"{MLSTM_TWO_PASS_TOL} |y|: "
            f"{[(r['seed'], r['case'], r['over_tol']) for r in over]}")
    return {"seeds": list(seeds), "cases": cases, "over_two_pass_tol": over,
            "two_pass_ratio_max": worst_ratio,
            "kernel_rel_max": worst_k, "two_pass_rel_max": worst_tp}


def _ssm_case(gen, b, s, di, ds, x_dtype, p_dtype, with_state=False,
                views=False):
    """x, dt (B,S,di), B, C (B,S,ds), A (di,ds), D (di,) as
    tests/test_kernels.py makes them (x, B, C scaled by 0.5, dt =
    softplus(0.3 n - 1), A = -exp(0.3 n), D = 0.1 n); x in `x_dtype`, dt, B,
    C in `p_dtype`; optionally a non-zero state h0 (B,di,ds), and B and C as
    column views of one (B,S,2ds+8) tensor, as the model's x_proj gives
    them."""
    def mk(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = (mk(b, s, di) * 0.5).to(x_dtype)
    dt = torch.nn.functional.softplus(mk(b, s, di) * 0.3 - 1.0).to(p_dtype)
    if views:
        x_db = (mk(b, s, 2 * ds + 8) * 0.5).to(p_dtype)
        b_t, c_t = x_db[..., 8:8 + ds], x_db[..., 8 + ds:]
    else:
        b_t, c_t = ((mk(b, s, ds) * 0.5).to(p_dtype) for _ in range(2))
    a = -torch.exp(mk(di, ds) * 0.3)
    d = mk(di) * 0.1
    h0 = mk(b, di, ds) * 0.3 if with_state else None
    return (x, dt, b_t, c_t, a, d), h0


def _ssm_err(label, got, want) -> float:
    """Max abs error of y and the state out; raises beyond the tolerance."""
    err = 0.0
    for name, a, b in zip(("y", "h_last"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"ssm_scan {label} {name}: "
                                 f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        diff = (a.float() - b.float()).abs()
        tol = SSM_TOL[a.dtype]
        bad = diff > tol + tol * b.float().abs()
        if not torch.isfinite(a).all() or bool(bad.any()):
            raise AssertionError(f"ssm_scan {label} {name}: max abs err "
                                 f"{float(diff.max())} beyond tol {tol}")
        err = max(err, float(diff.max()))
    return err


def _sm_clock_mhz() -> float:
    """The card's highest SM clock, the one its peak rates assume."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


SSM_PATH = "fp32, two lanes a channel, ex2.approx"


def check_ssm_scan(gen):
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, B, S, di, ds, x dtype, dt/B/C dtype, state, views)
        ("jamba prefill", 2, 2048, 16_384, 16, bf16, f32, False, False),
        ("jamba decode S=1 with state", 4, 1, 16_384, 16, bf16, f32, True,
         False),
        *[(f"S={s} di={di} ds={ds}", 2, s, di, ds, dt, dt, False, False)
          for s, di, ds in ((64, 128, 16), (128, 256, 16), (256, 128, 8),
                            (50, 200, 16), (33, 100, 8))
          for dt in (f32, bf16)],
        *[("ragged S=77 di=384 with state, B/C views", 1, 77, 384, ds, x_dt,
           f32, True, True) for ds in (8, 16) for x_dt in (f32, bf16)],
        *[(f"decode S=1 with state di=200 ds={ds}", 4, 1, 200, ds, bf16, f32,
           True, False) for ds in (8, 16)],
        # a rank's block of jamba smoke's channels in phase 10: 1 row of 2,
        # 128 of 256 channels, B and C views of x_proj's sum
        ("jamba smoke rank of (2, 2) (phase 10)", 1, 64, 128, 8, f32, f32,
         False, True),
    ]
    main = decode = rank = None
    for label, b, s, di, ds, x_dt, p_dt, with_state, views in cases:
        args, h0 = _ssm_case(gen, b, s, di, ds, x_dt, p_dt, with_state,
                               views)
        got = ssm_scan(*args, h0)
        want = ssm_scan_ref(*args, h0)
        torch.cuda.synchronize()
        err = _ssm_err(label, got, want)
        log(f"[kernels] ssm_scan {label} x {str(x_dt)[6:]} dt/B/C "
            f"{str(p_dt)[6:]} B={b} S={s} di={di} ds={ds}: max_abs_err={err} "
            f"(tol {SSM_TOL[x_dt]}, h_last {SSM_TOL[f32]}) ok")
        if main is None:
            main = (args, None, err)
        elif label.startswith("jamba decode"):
            decode = (args, h0, err)
        elif label.startswith("jamba smoke rank"):
            rank = (args, h0, err)

    # chained: the state out of one call feeds the next, against one call
    # over the whole sequence
    for x_dt in (f32, bf16):
        args, _ = _ssm_case(gen, 2, 200, 384, 16, x_dt, f32)
        y1, h1 = ssm_scan(*(t[:, :72] for t in args[:4]), *args[4:])
        y2, h2 = ssm_scan(*(t[:, 72:] for t in args[:4]), *args[4:], h1)
        want = ssm_scan_ref(*args)
        torch.cuda.synchronize()
        err = _ssm_err("chained 72+128", (torch.cat([y1, y2], dim=1), h2),
                       want)
        log(f"[kernels] ssm_scan chained 72+128 vs one call S=200 di=384 x "
            f"{str(x_dt)[6:]}: max_abs_err={err} ok")

    clock_mhz = _sm_clock_mhz()
    entry = {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:21",
        "path": SSM_PATH,
        "launches": None,
        **_ssm_times(*main, clock_mhz),
        # the 315 decode launches of phase 4b run at this shape
        "at_decode": _ssm_times(*decode, clock_mhz),
        # a jamba smoke rank's calls in phase 10, with and without SP
        "at_phase10_rank": _ssm_times(*rank, clock_mhz),
    }
    return entry


def _ssm_times(args, h0, err, clock_mhz) -> dict:
    """Kernel and plain ms of one call and its bound: the larger of the
    exps on the special function units, the fp32 flop and the bytes."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    x, dt, b_t, c_t, a, d = args
    b, s, di = x.shape
    ds = a.shape[1]
    kernel_ms = cuda_ms(lambda: ssm_scan(*args, h0), 20)
    device_ms = queued_ms(lambda: ssm_scan(*args, h0))
    plain_ms = cuda_ms(lambda: ssm_scan_ref(*args, h0), 3, warmup=1)
    # per state update: dt*A, dt*B*x (2), the fma into h (2), the fma of
    # C.h (2); per channel and step D*x and its add (`ssm_scan.ops.cost`)
    from repro_torch.kernels.ssm_scan.ops import cost
    flops, nbytes, updates = cost(*args, h0)
    t_exp = updates / (SMS * SFU_PER_SM_CLOCK * clock_mhz * 1e6)
    t_ops = max(flops / PEAK_FLOPS[torch.float32], t_exp)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    times = {
        "shape": f"x {str(x.dtype)[6:]}, dt/B/C {str(dt.dtype)[6:]}, B={b} "
                 f"S={s} di={di} ds={ds}"
                 + (", state in" if h0 is not None else ""),
        "max_abs_err": err,
        "ms": kernel_ms,
        # the card alone, without the call's host cost (`queued_ms`)
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # no single PyTorch call computes a selective scan
        "library_ms": None,
        "flops": flops,
        "exps": updates,
        "bytes": nbytes,
        "sm_clock_max_mhz": clock_mhz,
        "exp_ms": t_exp * 1e3,
        "flop_ms": flops / PEAK_FLOPS[torch.float32] * 1e3,
        "bytes_ms": t_bytes * 1e3,
    }
    log(f"[kernels] ssm_scan ({SSM_PATH}) at {times['shape']}: kernel "
        f"{kernel_ms:.4f} ms a call, {device_ms:.4f} ms on the card alone, "
        f"plain {plain_ms:.4f} ms, no library call, bound "
        f"{times['bound_ms']:.4f} ms ({times['bound_by']}: {updates} exps at "
        f"{SFU_PER_SM_CLOCK}/SM/clock x {SMS} SMs x {clock_mhz} MHz = "
        f"{times['exp_ms']:.4f} ms; {flops} fp32 flop = "
        f"{times['flop_ms']:.4f} ms; {nbytes} bytes = "
        f"{times['bytes_ms']:.4f} ms)")
    return times


# ------------------------------------------------------------------ phase 3

def check_card_vs_cpu():
    """stablelm-1.6b at full width, 2 layers, fp32: prefill logits, greedy
    tokens, and loss_fn with every gradient leaf, card vs CPU."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

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

    lengths = _greedy_card_vs_cpu("stablelm", model, params, cpu_params,
                                  cfg.vocab_size)
    # training through flash: its forward on the card, its recompute
    # backward, every gradient leaf against the CPU's
    figures = _grads_card_vs_cpu("stablelm", model, params, cpu_params,
                                 _train_tokens(cfg.vocab_size, 64))
    log(f"[parity] stablelm-1.6b d={cfg.d_model} 2 layers fp32: prefill "
        f"logits max "
        f"abs err card vs cpu {err} (tol {PARITY_TOL}); greedy tokens equal "
        f"for prompt lengths {lengths}; 2x64 tokens: {figures}")


SOFTCAP_PARITY = 2.0


def check_softcap_card_vs_cpu():
    """stablelm-1.6b's smoke config in fp32 with its attention logits
    softcapped at SOFTCAP_PARITY: prefill logits (PARITY_TOL), the loss and
    every gradient leaf (`_grads_card_vs_cpu`), card vs CPU; the loss runs
    flash's forward and backward kernels on the card, once a layer each."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model

    cfg = get_smoke_config("stablelm-1.6b").scaled(
        param_dtype="float32", attn_logit_softcap=SOFTCAP_PARITY)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 3))
    cpu_params = params_to(params, "cpu")
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 32)))
    with torch.inference_mode():
        card_logits, _ = model.prefill(params, {"tokens": tokens.cuda()},
                                       max_seq=40)
        cpu_logits, _ = model.prefill(cpu_params, {"tokens": tokens},
                                      max_seq=40)
    err = float((card_logits.cpu() - cpu_logits).abs().max())
    if not err <= PARITY_TOL:
        raise AssertionError(f"softcap prefill logits card vs cpu: {err} > "
                             f"{PARITY_TOL}")
    before = (flash_attention.launches, flash_attention.bwd_launches)
    figures = _grads_card_vs_cpu("stablelm softcap", model, params,
                                 cpu_params, _train_tokens(cfg.vocab_size, 64))
    launched = (flash_attention.launches - before[0],
                flash_attention.bwd_launches - before[1])
    want = (_train_launches(cfg)["flash_attention"],
            _train_launches(cfg)["flash_attention_bwd"])
    if launched != want:
        raise AssertionError(f"softcap loss: flash launched {launched} "
                             f"(forward, backward), want {want}")
    log(f"[parity] stablelm-1.6b smoke d={cfg.d_model} {cfg.num_layers} "
        f"layers fp32, attn_logit_softcap {SOFTCAP_PARITY}: prefill logits "
        f"max abs err card vs cpu {err} (tol {PARITY_TOL}); 2x64 tokens: "
        f"{figures}; flash launches (forward, backward) {launched}")


def _grads_card_vs_cpu(what: str, model, params, cpu_params, tokens) -> str:
    """loss_fn and every gradient leaf on the card against the CPU, fp32:
    the loss to LOSS_RTOL of its value, each leaf to GRAD_RTOL of its
    largest entry. Returns the log line's figures."""
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves
    (card_loss, _), card_grads = value_and_grad(model, params,
                                                {"tokens": tokens.cuda()})
    (cpu_loss, _), cpu_grads = value_and_grad(model, cpu_params,
                                              {"tokens": tokens})
    loss_err = abs(float(card_loss) - float(cpu_loss))
    if not (math.isfinite(float(card_loss))
            and loss_err <= LOSS_RTOL * abs(float(cpu_loss))):
        raise AssertionError(f"{what} loss card {float(card_loss)} vs cpu "
                             f"{float(cpu_loss)}")
    grad_err = 0.0
    leaves = list(zip(tree_leaves(card_grads), tree_leaves(cpu_grads)))
    for i, (a, b) in enumerate(leaves):
        rel = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                      1e-30)
        if not (torch.isfinite(a).all() and rel <= GRAD_RTOL):
            raise AssertionError(f"{what} grad leaf {i} {tuple(a.shape)}: "
                                 f"max err / max |g| = {rel} > {GRAD_RTOL}")
        grad_err = max(grad_err, rel)
    return (f"loss card {float(card_loss)} cpu {float(cpu_loss)} (abs err "
            f"{loss_err}); {len(leaves)} gradient leaves, max err / max |g| "
            f"{grad_err} (tol {GRAD_RTOL})")


def _to(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def _prefix(cfg) -> int:
    """Positions before the first token: the image's."""
    return cfg.num_image_tokens if cfg.input_mode == "tokens+image" else 0


def _decode_card_vs_cpu(model, params, cpu_params, batch: dict, prompt: int,
                        max_seq: int) -> float:
    """Max abs error of the prefill logits of `batch` cut to its first
    `prompt` tokens (its modality input whole) and of each decode step fed
    the rest of its tokens, card vs CPU."""
    tokens, prefix = batch["tokens"], _prefix(model.cfg)
    pre = dict(batch, tokens=tokens[:, :prompt])
    outs = []
    with torch.inference_mode():
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            logits, cache = model.prefill(p, _to(pre, dev), max_seq=max_seq)
            steps = [logits]
            for t in range(prompt, tokens.shape[1]):
                logits, cache = model.decode_step(
                    p, cache, tokens[:, t:t + 1].to(dev), prefix + t)
                steps.append(logits)
            outs.append(steps)
    return max(float((a.cpu() - b).abs().max()) for a, b in zip(*outs))


def _greedy_card_vs_cpu(what: str, model, params, cpu_params, vocab) -> list:
    """Greedy tokens of 4 trace requests, card vs CPU; their prompt
    lengths."""
    from repro_torch.serving import load
    from repro_torch.serving.engine import ServingEngine
    trace = load.poisson_trace(50.0, 10.0, seed=SEED, max_new_tokens=8)[:4]
    requests = [r for _, r in load.materialize(trace, SEED, vocab)]
    card = ServingEngine(model, params, max_seq=128).serve(requests, 4)
    cpu = ServingEngine(model, cpu_params, max_seq=128,
                        device="cpu").serve(requests, 4)
    card_tok = {r.request_id: r.tokens for r in card}
    cpu_tok = {r.request_id: r.tokens for r in cpu}
    if card_tok != cpu_tok:
        raise AssertionError(f"{what} greedy tokens differ: card {card_tok} "
                             f"cpu {cpu_tok}")
    return [len(r.prompt) for r in requests]


def _train_tokens(vocab: int, seq_len: int) -> torch.Tensor:
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    return torch.from_numpy(batch_for_step(DataConfig(
        vocab_size=vocab, seq_len=seq_len, global_batch=2), 0)["tokens"]
    ).long()


def check_xlstm_card_vs_cpu():
    """xlstm-125m at full width, 2 layers (sLSTM, mLSTM), fp32: loss_fn and
    every gradient leaf (the card's mLSTM: the kernel forward and its
    recompute backward), prefill logits and 4 decode steps, card vs CPU."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config("xlstm-125m").scaled(num_layers=2, param_dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cpu_params = params_to(params, "cpu")
    tokens = _train_tokens(cfg.vocab_size, 64)
    figures = _grads_card_vs_cpu("xlstm", model, params, cpu_params, tokens)
    logit_err = _decode_card_vs_cpu(model, params, cpu_params,
                                    {"tokens": tokens}, 60, 64)
    if not logit_err <= PARITY_TOL:
        raise AssertionError(f"xlstm prefill/decode logits card vs cpu: "
                             f"{logit_err} > {PARITY_TOL}")
    log(f"[parity] xlstm-125m d={cfg.d_model} 2 layers (sLSTM, mLSTM) fp32, "
        f"2x64 tokens: {figures}; prefill 60 + 4 decode steps logits max "
        f"abs err {logit_err} (tol {PARITY_TOL})")


def check_mixtral_card_vs_cpu():
    """mixtral-8x22b at its smoke widths (2 layers, window 16, 4 experts
    top-2), fp32, once for each MoE dispatch: loss_fn and every gradient
    leaf over 2x40 tokens, a 20-token prefill and 8 decode steps past the
    window, greedy tokens; card vs CPU."""
    import dataclasses
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import build_model
    smoke = get_smoke_config("mixtral-8x22b")
    for dispatch in ("dense", "dropping", "ragged"):
        cfg = smoke.scaled(param_dtype="float32", moe=dataclasses.replace(
            smoke.moe, dispatch=dispatch))
        model = build_model(cfg)
        params = init_params(cfg,
                             torch.Generator(device="cuda").manual_seed(SEED))
        cpu_params = params_to(params, "cpu")
        tokens = _train_tokens(cfg.vocab_size, 40)
        figures = _grads_card_vs_cpu(f"mixtral {dispatch}", model, params,
                                     cpu_params, tokens)
        logit_err = _decode_card_vs_cpu(model, params, cpu_params,
                                        {"tokens": tokens[:, :28]}, 20, 28)
        if not logit_err <= PARITY_TOL:
            raise AssertionError(f"mixtral {dispatch} prefill/decode logits "
                                 f"card vs cpu: {logit_err} > {PARITY_TOL}")
        lengths = _greedy_card_vs_cpu(f"mixtral {dispatch}", model, params,
                                      cpu_params, cfg.vocab_size)
        log(f"[parity] mixtral-8x22b smoke d={cfg.d_model} window "
            f"{cfg.window_size} {cfg.moe.num_experts} experts top-"
            f"{cfg.moe.top_k}, dispatch {dispatch}, fp32, 2x40 tokens: "
            f"{figures}; prefill 20 + 8 decode steps past the window, logits "
            f"max abs err {logit_err} (tol {PARITY_TOL}); greedy tokens "
            f"equal for prompt lengths {lengths}")


def _jamba_cut(base):
    """jamba-1.5-large-398b cut to one 8-layer group with dense FFNs: its
    four MoE layers of 16 experts would take about 77 GB of the card."""
    from repro_torch.configs.base import DENSE
    return base.scaled(num_layers=8, ffn_pattern=(DENSE,) * 8, moe=None)


def check_jamba_card_vs_cpu():
    """jamba at its smoke config, fp32: one 8-layer group of 7 Mamba layers
    (the ssm_scan kernel at d_state 8) and one GQA attention layer (flash
    at hd 32), MoE FFNs (4 experts, top-2) in every other layer: prefill
    logits, 4 decode steps and greedy tokens, card vs CPU."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(
        param_dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cpu_params = params_to(params, "cpu")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 36)))
    logit_err = _decode_card_vs_cpu(model, params, cpu_params,
                                    {"tokens": tokens}, 32, 40)
    if not logit_err <= PARITY_TOL:
        raise AssertionError(f"jamba prefill/decode logits card vs cpu: "
                             f"{logit_err} > {PARITY_TOL}")
    lengths = _greedy_card_vs_cpu("jamba", model, params, cpu_params,
                                  cfg.vocab_size)
    log(f"[parity] jamba smoke d={cfg.d_model} d_state={cfg.mamba.d_state} 8 "
        f"layers (7 Mamba, 1 GQA attention; {cfg.ffn_pattern.count('moe')} "
        f"MoE FFNs of {cfg.moe.num_experts} experts, {cfg.moe.dispatch}) "
        f"fp32: prefill 32 + 4 decode steps logits max abs err card vs cpu "
        f"{logit_err} (tol {PARITY_TOL}); greedy tokens equal for prompt "
        f"lengths {lengths}")


def _modal_batch(cfg, b: int, s: int, frames: int, seed: int) -> dict:
    """`s` tokens, and for the modality inputs `frames` encoder frames or
    the config's image embeddings, in the param dtype, from a seed."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, cfg.param_dtype)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).long()}
    if cfg.input_mode == "frames":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, frames, cfg.frame_dim or cfg.d_model),
            dtype=np.float32)).to(dt)
    elif cfg.input_mode == "tokens+image":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)).to(dt)
    return batch


def _greedy(model, params, batch: dict, steps: int, max_seq: int):
    """Model.prefill of `batch`, then `steps` greedy decode steps: the
    tokens (B, steps + 1) and each step's logits. The ServingEngine takes
    tokens only, so the modality inputs are driven through the model."""
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, max_seq=max_seq)
        pos = _prefix(model.cfg) + batch["tokens"].shape[1]
        toks, out = [logits.argmax(-1)], [logits]
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, toks[-1],
                                              pos + i)
            toks.append(logits.argmax(-1))
            out.append(logits)
    return torch.cat(toks, dim=1), out


def _arch_card_vs_cpu(what: str, cfg, prompt: int = 32, steps: int = 8,
                      frames: int = 36) -> dict:
    """One arch in fp32, card vs CPU: loss_fn over 2 x (prompt + steps)
    tokens (LOSS_RTOL); a prefill of `prompt` tokens (and the modality
    input) and `steps` decode steps fed the same tokens, logits to
    PARITY_TOL (`_decode_card_vs_cpu`); greedy tokens equal, through the
    ServingEngine for a token-only arch, else through the model; flash
    launched once a full-sequence attention of the prefill."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.base import ATTN, MLA, SWA
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cpu_params = params_to(params, "cpu")
    batch = _modal_batch(cfg, 2, prompt + steps, frames, SEED)
    with torch.inference_mode():
        card_loss = float(model.loss_fn(params, _to(batch, "cuda"))[0])
        cpu_loss = float(model.loss_fn(cpu_params, batch)[0])
    if not (math.isfinite(card_loss)
            and abs(card_loss - cpu_loss) <= LOSS_RTOL * abs(cpu_loss)):
        raise AssertionError(f"{what} loss card {card_loss} vs cpu {cpu_loss}")
    max_seq = _prefix(cfg) + prompt + steps
    before = flash_attention.launches      # decode never launches flash
    logit_err = _decode_card_vs_cpu(model, params, cpu_params, batch, prompt,
                                    max_seq)
    launches = flash_attention.launches - before
    if not logit_err <= PARITY_TOL:
        raise AssertionError(f"{what} prefill/decode logits card vs cpu: "
                             f"{logit_err} > {PARITY_TOL}")
    if cfg.input_mode == "tokens":
        lengths = _greedy_card_vs_cpu(what, model, params, cpu_params,
                                      cfg.vocab_size)
        greedy = f"through the ServingEngine for prompt lengths {lengths}"
    else:
        pre = dict(batch, tokens=batch["tokens"][:, :prompt])
        card_tok, _ = _greedy(model, params, _to(pre, "cuda"), steps, max_seq)
        cpu_tok, _ = _greedy(model, cpu_params, pre, steps, max_seq)
        if not torch.equal(card_tok.cpu(), cpu_tok):
            raise AssertionError(f"{what} greedy tokens differ: card "
                                 f"{card_tok.tolist()} cpu {cpu_tok.tolist()}")
        greedy = f"through the model ({card_tok.shape[1]} a row)"
    attn_layers = sum(k in (ATTN, SWA, MLA) for k in cfg.pattern) \
        * cfg.num_groups + cfg.first_k_dense
    want = attn_layers * (2 if cfg.encoder_layers else 1) + cfg.encoder_layers
    if launches != want:
        raise AssertionError(f"{what}: flash launched {launches} times in a "
                             f"prefill, want {want}")
    log(f"[parity] {what} fp32: loss card {card_loss} cpu {cpu_loss}; "
        f"prefill {prompt} + {steps} decode steps logits max abs err "
        f"{logit_err} (tol {PARITY_TOL}); greedy tokens equal {greedy}; "
        f"flash launched {launches} times a prefill")
    return {"loss_err": abs(card_loss - cpu_loss), "logit_err": logit_err,
            "flash_per_prefill": launches}


# deepseek-v2's MLA head dims at the smoke config's widths: queries and keys
# of 128 + 64 = 192 channels (a kernel head dim; the smoke's 32 + 16 is not)
DEEPSEEK_WIDE_MLA = dict(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=64,
                         nope_head_dim=128, v_head_dim=128)


def check_new_archs_card_vs_cpu() -> dict:
    """phi3, mistral-large, gemma3, internvl2, seamless and deepseek-v2 at
    their smoke configs (deepseek's with MLA's full head dims), fp32, card
    vs CPU (`_arch_card_vs_cpu`)."""
    from repro_torch.configs.base import MLAConfig
    from repro_torch.configs.registry import get_smoke_config
    out = {}
    for arch in ("phi3-medium-14b", "mistral-large-123b", "gemma3-12b",
                 "internvl2-2b", "seamless-m4t-medium"):
        cfg = get_smoke_config(arch).scaled(param_dtype="float32")
        out[arch] = _arch_card_vs_cpu(
            f"{arch} smoke d={cfg.d_model} {cfg.num_layers} layers "
            f"({cfg.input_mode})", cfg)
    cfg = get_smoke_config("deepseek-v2-236b").scaled(
        param_dtype="float32", mla=MLAConfig(**DEEPSEEK_WIDE_MLA))
    out["deepseek-v2-236b"] = _arch_card_vs_cpu(
        f"deepseek-v2-236b smoke with MLA at hd {128 + 64} (dense first "
        f"layer, {cfg.moe.num_experts} experts {cfg.moe.dispatch})", cfg)
    return out


def check_gemma3_chunked_loss() -> None:
    """gemma3's chunked loss (CHUNKED_LOSS_VOCAB lowered to 1, as
    tests/test_models.py does) at its smoke config over 2 x 2048 tokens,
    fp32: card vs CPU, the loss and every gradient leaf; and on the card
    the chunked loss against the unchunked one in value and gradients."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import Model, build_model
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config("gemma3-12b").scaled(param_dtype="float32")
    chunked = type("Chunked", (Model,), {"CHUNKED_LOSS_VOCAB": 1})(cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    tokens = _train_tokens(cfg.vocab_size, 2048)
    figures = _grads_card_vs_cpu("gemma3 chunked loss", chunked, params,
                                 params_to(params, "cpu"), tokens)
    batch = {"tokens": tokens.cuda()}
    (l_chunk, _), g_chunk = value_and_grad(chunked, params, batch)
    (l_full, _), g_full = value_and_grad(build_model(cfg), params, batch)
    if abs(float(l_chunk) - float(l_full)) > LOSS_RTOL * abs(float(l_full)):
        raise AssertionError(f"gemma3 chunked loss {float(l_chunk)} vs "
                             f"unchunked {float(l_full)} on the card")
    worst = 0.0
    for a, b in zip(tree_leaves(g_chunk), tree_leaves(g_full)):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > GRAD_RTOL:
            raise AssertionError(f"gemma3 chunked grad {tuple(a.shape)}: "
                                 f"{rel} > {GRAD_RTOL}")
        worst = max(worst, rel)
    log(f"[parity] gemma3-12b smoke chunked loss, 2x2048 tokens in chunks of "
        f"1024, fp32: {figures}; on the card chunked {float(l_chunk)} vs "
        f"unchunked {float(l_full)}, gradient leaves max err / max |g| "
        f"{worst} (tol {GRAD_RTOL})")


# ------------------------------------------------------------------ phase 4

def _numel(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_numel(x) for x in items)


class _TimedModel:
    """Delegates to the model, timing each prefill and decode step on the
    host clock between synchronizations of the calling thread's stream (the
    engine's own, so engines on other threads do not enter the time) and
    checking the logits. Safe to share between threads: each record is one
    list append."""

    def __init__(self, model, vocab):
        self.model, self.vocab = model, vocab
        self.prefill_ms, self.decode_ms = [], []
        self.prefill_log = []      # ((batch, prompt length), ms)

    def clear(self) -> None:
        self.prefill_ms, self.decode_ms, self.prefill_log = [], [], []

    def _timed(self, fn, *args, **kw):
        stream = torch.cuda.current_stream()
        stream.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args, **kw)
        stream.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if logits.shape[-1] != self.vocab or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        return logits, cache, ms

    def prefill(self, params, batch, max_seq=0):
        logits, cache, ms = self._timed(self.model.prefill, params, batch,
                                        max_seq=max_seq)
        self.prefill_ms.append(ms)
        self.prefill_log.append((tuple(batch["tokens"].shape), ms))
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        logits, cache, ms = self._timed(self.model.decode_step, params,
                                        cache, tokens, pos)
        self.decode_ms.append(ms)
        return logits, cache


def _serve(cfg, params, n_short: int, card: str,
           long_prompts=(2048, 2048)):
    """Serve `n_short` requests from the load module's trace (seed 0) and
    one prompt of each of `long_prompts` tokens, 16 new tokens each,
    max_wave 4, through `ServingEngine`, after a warm-up wave. Every
    request must be answered in full. Returns the timed model, the waves
    and each kernel's launches in the served set."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import build_model, padded_vocab
    from repro_torch.serving import load
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            length_aligned_waves)

    new_tokens, max_wave = 16, 4
    timed = _TimedModel(build_model(cfg), padded_vocab(cfg))
    engine = ServingEngine(timed, params,
                           max_seq=max(long_prompts) + new_tokens)
    trace = load.poisson_trace(50.0, 10.0, seed=SEED, max_new_tokens=new_tokens)
    rng = np.random.default_rng(SEED)
    requests = [r for _, r in load.materialize(trace[:n_short], SEED,
                                               cfg.vocab_size)]
    requests += [Request(n_short + i, rng.integers(0, cfg.vocab_size, n)
                         .astype(np.int32), new_tokens)
                 for i, n in enumerate(long_prompts)]
    waves = length_aligned_waves(requests, max_wave)

    engine.serve([Request(99, requests[0].prompt, 2)], max_wave)  # warm-up
    timed.clear()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    responses = engine.serve(requests, max_wave)
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssm_scan": ssm_scan.launches}

    if sorted(r.request_id for r in responses) != \
            sorted(r.request_id for r in requests):
        raise AssertionError("not every request was answered")
    budget = {r.request_id: r.max_new_tokens for r in requests}
    for r in responses:
        if len(r.tokens) != budget[r.request_id] or not all(
                0 <= tok < padded_vocab(cfg) for tok in r.tokens):
            raise AssertionError(f"request {r.request_id}: tokens {r.tokens}")
    if len(timed.prefill_ms) != len(waves):
        raise AssertionError(f"{len(timed.prefill_ms)} prefills for "
                             f"{len(waves)} waves")
    generated = sum(len(r.tokens) for r in responses)
    wave_desc = [f"{len(w)}x{len(w[0].prompt)}" for w in waves]
    log(f"[serve] card: {card}")
    log(f"[serve] {len(responses)} requests in {len(waves)} waves "
        f"(batch x prompt: {wave_desc}), {new_tokens} new tokens each, "
        f"max_wave {max_wave}: launches {launches}")
    for w, ms in zip(wave_desc, timed.prefill_ms):
        log(f"[serve] prefill wave {w}: {ms:.3f} ms")
    log(f"[serve] decode per token (one step of the wave batch): median "
        f"{statistics.median(timed.decode_ms):.3f} ms over "
        f"{len(timed.decode_ms)} steps")
    log(f"[serve] wall {wall_s:.3f} s, {generated} tokens, "
        f"{generated / wall_s:.1f} tokens/s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    return timed, engine, waves, launches


def _init_full(cfg, seed: int):
    from repro_torch.bridge import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = _numel(params)
    log(f"[serve] {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.param_dtype}: {n_params} params initialized in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, n_params


def serve_full_model(card: str) -> dict:
    """stablelm-1.6b at full size; returns flash_attention's launches, and
    the config, model, weights and timings that phase 4c goes on with."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("stablelm-1.6b")
    params, _ = _init_full(cfg, SEED + 1)
    timed, engine, waves, launches = _serve(cfg, params, 8, card)
    flash = launches["flash_attention"]
    if flash != cfg.num_layers * len(waves) or flash == 0:
        raise AssertionError(f"flash_attention launched {flash} times, "
                             f"want {cfg.num_layers} x {len(waves)} waves")
    log(f"[serve] flash_attention launches {flash} = {cfg.num_layers} "
        f"layers x {len(waves)} waves")
    profile_waves(ServingEngine(timed.model, params, engine.max_seq),
                  [waves[0], waves[-1]])
    return {"flash": flash, "cfg": cfg, "model": timed.model,
            "params": params, "prefill_log": timed.prefill_log,
            "decode_ms": statistics.median(timed.decode_ms)}


# ----------------------------------------------------------------- phase 4c

# Phase 4c (b): after the kill run, memory allocated on the card must come
# back to within this many bytes of its level before it.
KILL_MEMORY_SLACK = 256 << 20
# Runtime threads whose end phase 4c (b) waits for before it reads memory
# (the killed incarnation's wave runs on to its end on its thread).
RUNTIME_THREADS = ("worker-", "lane-", "heartbeat-", "actor-",
                   "failure-detector", "mm-reclaimer", "frontdoor-ctl")


def _runtime_threads_drained(timeout: float) -> None:
    import threading
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(RUNTIME_THREADS)]
        if not alive:
            return
        time.sleep(0.05)
    raise AssertionError(f"runtime threads still alive: {alive}")


def _by_bucket(prefill_log) -> dict:
    """Median prefill ms by prompt length, with the batches seen."""
    out = {}
    for (b, s), ms in prefill_log:
        out.setdefault(s, ([], set()))
        out[s][0].append(ms)
        out[s][1].add(b)
    return {s: (statistics.median(v), len(v), sorted(bs))
            for s, (v, bs) in sorted(out.items())}


def _runtime_us_a_wave(events, since: float) -> list:
    """For each wave reaped after `since`: its dispatch-to-reap time (the
    FrontDoor's `serve_reap`) minus the engine's own serve time inside the
    actor (the replica's `serve_engine`, logged by the same task), in us."""
    engine_ms = {tid: extra["ms"] for _, kind, tid, _, extra in events
                 if kind == "serve_engine"}
    out = []
    for ts, kind, ref_id, _, extra in events:
        if kind == "serve_reap" and ts >= since:
            out.append((extra["wave_ms"]
                        - engine_ms[ref_id.rsplit(".", 1)[0]]) * 1e3)
    return out


def _check_ledger(st: dict, what: str) -> None:
    if st["admitted"] != (st["completed_ok"] + st["completed_late"]
                          + st["shed"] + st["failed"]):
        raise AssertionError(f"{what}: ledger does not balance: {st}")
    if st["dispatched_past_deadline"] != 0:
        raise AssertionError(f"{what}: {st['dispatched_past_deadline']} "
                             f"dispatched past their deadline")


def _serve_llm_full(stablelm: dict, card: str, argv: list) -> dict:
    """4c (a): `serve_llm --full` with `argv` over its defaults, on phase
    4's weights; returns the run's figures and flash_attention's
    launches after the probes."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import padded_vocab
    from repro_torch.serving import serve_llm
    from repro_torch.serving.slo import percentile

    cfg = stablelm["cfg"]
    args = serve_llm.parse_args(["--full", *argv])
    what = " ".join(["serve_llm --full", *argv])
    timed = _TimedModel(stablelm["model"], padded_vocab(cfg))
    clock = {}

    def on_clock_start():
        timed.clear()
        reset_launch_counts()
        clock["t0"] = time.perf_counter()

    run = serve_llm.serve(args, model=timed, params=stablelm["params"],
                          on_clock_start=on_clock_start)
    flash = flash_attention.launches
    wall_s = time.perf_counter() - clock["t0"]
    st = run.stats
    if run.ok + run.shed != run.tickets or run.ok == 0:
        raise AssertionError(f"{what}: ok {run.ok} shed {run.shed} of "
                             f"{run.tickets} tickets")
    _check_ledger(st, what)
    vocab = padded_vocab(cfg)
    for r in run.responses:
        if len(r.tokens) != args.max_new or not all(
                0 <= tok < vocab for tok in r.tokens):
            raise AssertionError(f"request {r.request_id}: tokens {r.tokens}")
    served = sum(1 for ts, kind, *_ in run.events
                 if kind == "serve_engine" and ts >= clock["t0"])
    if served != run.waves or flash != cfg.num_layers * run.waves \
            or flash == 0:
        raise AssertionError(f"{what}: flash_attention launched {flash} "
                             f"times; {run.waves} waves dispatched, {served} "
                             f"served, want {cfg.num_layers} x waves")
    runtime_us = _runtime_us_a_wave(run.events, clock["t0"])
    if len(runtime_us) != run.waves:
        raise AssertionError(f"{what}: {len(runtime_us)} reaped waves timed, "
                             f"{run.waves} dispatched")
    probes = 2 * args.replicas
    lat = [r.latency_s * 1e3 for r in run.responses]
    decode = statistics.median(timed.decode_ms)
    log(f"[frontdoor] {what}: card {card}; offered {run.offered} @ "
        f"{args.rate:g}/s for {args.duration:g} s, deadline "
        f"{args.deadline_ms:g} ms, {args.max_new} new tokens; admitted "
        f"{st['admitted']} ({probes} probes among them) rejected "
        f"{st['rejected']} ok {st['completed_ok']} late "
        f"{st['completed_late']} shed {st['shed']} failed {st['failed']}; "
        f"of the trace's {run.tickets} tickets {run.ok} fulfilled "
        f"({st['completed_ok'] - probes} within the deadline), {run.shed} "
        f"raised")
    log(f"[frontdoor] {what}: latency p50 {st['latency_p50_ms']:.1f} ms p99 "
        f"{st['latency_p99_ms']:.1f} ms (the SLO window, probes included), "
        f"of the trace's fulfilled p50 {percentile(lat, 0.5):.1f} ms p99 "
        f"{percentile(lat, 0.99):.1f} ms; goodput {run.goodput:.3f}/s; replicas "
        f"{st['replicas']} batch_limits {st['batch_limits']}, {run.waves} "
        f"waves of mean width {run.wave_width:.3f}; {wall_s:.3f} s from the "
        f"clock's start to the cluster's shutdown")
    mine, theirs = _by_bucket(timed.prefill_log), _by_bucket(
        stablelm["prefill_log"])
    for s_len, (ms, n, bs) in mine.items():
        ref = theirs.get(s_len)
        beside = (f"; phase 4: {ref[0]:.3f} ms (batch {ref[2]})" if ref
                  else "; phase 4: none at this length")
        log(f"[frontdoor] {what}: prefill prompt {s_len}: median {ms:.3f} ms "
            f"over {n} waves (batch {bs}) inside the replicas{beside}")
    log(f"[frontdoor] {what}: decode step inside the replicas: median "
        f"{decode:.3f} ms over {len(timed.decode_ms)} steps; phase 4's bare "
        f"engine: {stablelm['decode_ms']:.3f} ms "
        f"({decode / stablelm['decode_ms']:.2f}x)")
    log(f"[frontdoor] {what}: the runtime's cost a wave (dispatch-to-reap "
        f"minus the engine's serve inside the actor), {len(runtime_us)} "
        f"waves: median {statistics.median(runtime_us):.1f} us, min "
        f"{min(runtime_us):.1f}, max {max(runtime_us):.1f}")
    log(f"[frontdoor] {what}: flash_attention launches {flash} = "
        f"{cfg.num_layers} layers x {run.waves} waves")
    return {"flash": flash, "decode_ms": decode,
            "runtime_us_p50": statistics.median(runtime_us)}


def _two_threads(stablelm: dict) -> None:
    """4c: the same 2x8+16 wave on one engine alone, then on two engines on
    two plain threads at once (no runtime, no FrontDoor): the decode step's
    median, what one more launching thread costs under the GIL."""
    import threading
    from repro_torch.models import padded_vocab
    from repro_torch.serving.engine import Request, ServingEngine

    timed = _TimedModel(stablelm["model"], padded_vocab(stablelm["cfg"]))
    engines = [ServingEngine(timed, stablelm["params"], max_seq=32)
               for _ in range(2)]
    prompt = (np.arange(8, dtype=np.int32) % 7) + 1
    wave = [Request(i, prompt, 16) for i in range(2)]
    for e in engines:
        e.serve(wave, 2)                                     # warm
    timed.clear()
    engines[0].serve(wave, 2)
    alone = statistics.median(timed.decode_ms)
    timed.clear()
    threads = [threading.Thread(target=e.serve, args=(wave, 2))
               for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if any(t.is_alive() for t in threads) or len(timed.decode_ms) != 30:
        raise AssertionError(f"two threads: {len(timed.decode_ms)} decode "
                             f"steps, want 30")
    both = statistics.median(timed.decode_ms)
    log(f"[frontdoor] a 2x8+16 wave's decode step: median {alone:.3f} ms on "
        f"one engine alone, {both:.3f} ms on each of two engines on two "
        f"plain threads at once ({both / alone:.2f}x)")


def _own_stream_check(stablelm: dict) -> None:
    """4c: an engine waits for its own stream, not the card: a wave of one
    engine ends while a 1.5 s sleep queued on another engine's stream still
    runs."""
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, params = stablelm["cfg"], stablelm["params"]
    busy = ServingEngine(stablelm["model"], params, max_seq=32)
    free = ServingEngine(stablelm["model"], params, max_seq=32)
    if busy._stream == free._stream:
        raise AssertionError("two engines share one stream")
    prompt = (np.arange(8, dtype=np.int32) % 7) + 1
    free.serve([Request(0, prompt, 2)], 1)                   # warm
    cycles = int(1.5 * _sm_clock_mhz() * 1e6)
    with torch.cuda.stream(busy._stream):
        torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    free.serve([Request(1, prompt, 2)], 1)
    wave_ms = (time.perf_counter() - t0) * 1e3
    still_busy = not busy._stream.query()
    busy._stream.synchronize()
    if not still_busy:
        raise AssertionError(f"the wave took {wave_ms:.1f} ms and returned "
                             f"only after the other stream's sleep ended")
    log(f"[frontdoor] own stream: a 1x8+2 wave took {wave_ms:.3f} ms while "
        f"another engine's stream slept 1.5 s ({cycles} cycles); "
        f"{cfg.name} engines do not wait for each other")


def _allocated() -> int:
    """Bytes allocated on the card once garbage and cuBLAS's workspaces
    (32 MiB for each thread's handle and stream, kept until cleared) are
    gone."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def _replica_kill(stablelm: dict) -> int:
    """4c (b), in the shape of the reference's replica-kill test: 2
    replicas (max 4) of a plain engine over phase 4's weights, 60 requests
    of 8 prompt and 8 new tokens 2 ms apart with deadline 2 s, the node of
    replica 0 killed at the 31st; every ticket resolves, the hot spare
    brings the count to 3, some are served, the ledger balances, and the
    card's allocated memory comes back. As in the reference test, idle
    scale-down waits 60 s: with its default of 3 s it may retire a replica
    while a wave of the killed incarnation is still replayed, before the
    count is read. A thread reads the count every 2 ms from the kill on.
    Returns flash_attention's launches."""
    import threading

    from repro_torch import core
    from repro_torch.core.api import _cluster
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.frontdoor import DeadlineShedError, FrontDoor

    cfg, model, params = stablelm["cfg"], stablelm["model"], stablelm["params"]
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (60, 8)).astype(np.int32)
    mem0 = _allocated()
    t_start = time.perf_counter()
    core.init(num_nodes=2, workers_per_node=2)
    try:
        cluster = _cluster()
        fd = FrontDoor(lambda: ServingEngine(model, params, max_seq=32),
                       num_replicas=2, max_replicas=4, max_queue=256,
                       default_deadline_s=2.0, target_wave_s=1.0,
                       max_batch=2, scale_down_idle_s=60.0,
                       resources={"cpu": 0.25})
        counts, watching = [], threading.Event()

        def watch():
            while not watching.wait(0.002):
                counts.append(fd.replica_count())
        watcher = threading.Thread(target=watch, name="smoke-watch")
        try:
            for t in [fd.submit(prompts[i], 8, deadline_s=600.0)
                      for i in range(4)]:
                t.result(timeout=600)                        # ready
            reset_launch_counts()
            tickets, killed = [], None
            for i in range(60):
                tickets.append(fd.submit(prompts[i], 8))
                if i == 30:
                    killed = cluster.gcs.actor_node(
                        fd._replicas[0].handle.actor_id)
                    watcher.start()
                    t_kill = time.perf_counter()
                    cluster.kill_node(killed)
                time.sleep(0.002)
            ok = raised = 0
            for t in tickets:
                try:
                    t.result(timeout=120)
                    ok += 1
                except (DeadlineShedError, core.TaskError, TimeoutError):
                    raised += 1
            deadline = time.perf_counter() + 20.0
            while (max(counts, default=0) < 3
                   and time.perf_counter() < deadline):
                time.sleep(0.02)
            watching.set()
            watcher.join()
            most = max(counts + [fd.replica_count()])
            st = fd.stats()
            scaling = [(round((ts - t_kill) * 1e3, 1), kind,
                        extra.get("why"))
                       for ts, kind, _, _, extra in cluster.gcs.events()
                       if ts >= t_kill and kind in ("serve_replica_spawn",
                                                    "serve_scale_down")]
        finally:
            watching.set()
            if watcher.is_alive():
                watcher.join()
            fd.close()
    finally:
        core.shutdown()
    flash = flash_attention.launches
    _runtime_threads_drained(60.0)
    mem1 = _allocated()
    log(f"[frontdoor] replica kill: node {killed} killed at the 31st of 60 "
        f"requests; admitted {st['admitted']} (4 probes among them) "
        f"rejected {st['rejected']} ok {st['completed_ok']} late "
        f"{st['completed_late']} shed {st['shed']} failed {st['failed']} "
        f"retried {st['retried']}; tickets {len(tickets)}: fulfilled {ok}, "
        f"raised {raised}; replicas at most {most}, at the end "
        f"{st['replicas']}; after the kill (ms, event, why): {scaling}; "
        f"flash_attention launches {flash}; "
        f"memory_allocated {mem0} bytes before, {mem1} after; "
        f"{time.perf_counter() - t_start:.1f} s")
    if ok + raised != len(tickets) or ok == 0:
        raise AssertionError(f"4c replica kill: ok {ok} raised {raised} of "
                             f"{len(tickets)} tickets")
    _check_ledger(st, "4c replica kill")
    if most < 3 or ("serve_replica_spawn", "hot_spare") not in [
            (kind, why) for _, kind, why in scaling]:
        raise AssertionError(f"4c replica kill: replicas reached {most}, "
                             f"want 3 (the hot spare); after the kill: "
                             f"{scaling}")
    if abs(mem1 - mem0) > KILL_MEMORY_SLACK:
        raise AssertionError(f"4c replica kill: memory_allocated {mem1} "
                             f"after, {mem0} before")
    if flash == 0:
        raise AssertionError("4c replica kill: flash_attention never "
                             "launched")
    return flash


def serve_frontdoor(stablelm: dict, card: str) -> dict:
    """Phase 4c on phase 4's stablelm-1.6b weights: `serve_llm --full` at
    its defaults and with one replica, two engines on two plain threads,
    an engine's own stream, then a replica lost mid-trace. Returns
    flash_attention's launches on each path."""
    out = _serve_llm_full(stablelm, card, [])
    out["flash_one"] = _serve_llm_full(stablelm, card,
                                       ["--replicas", "1"])["flash"]
    _two_threads(stablelm)
    _own_stream_check(stablelm)
    release_memory()
    out["flash_kill"] = _replica_kill(stablelm)
    return out


def serve_jamba(card: str) -> dict:
    """The jamba cut at full width; returns flash_attention's and
    ssm_scan's launches."""
    from repro_torch.configs.base import ATTN, MAMBA
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import ServingEngine

    cfg = _jamba_cut(get_config("jamba-1.5-large-398b"))
    params = _init_checked(cfg, SEED + 3, JAMBA_CUT_PARAMS)
    timed, engine, waves, launches = _serve(cfg, params, 4, card)
    n_attn, n_mamba = cfg.pattern.count(ATTN), cfg.pattern.count(MAMBA)
    steps = len(timed.prefill_ms) + len(timed.decode_ms)
    want = {"flash_attention": n_attn * len(waves), "ssm_scan": n_mamba * steps}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    log(f"[serve] jamba launches: flash_attention {want['flash_attention']} "
        f"= {n_attn} attention layer x {len(waves)} waves; ssm_scan "
        f"{want['ssm_scan']} = {n_mamba} Mamba layers x ({len(timed.prefill_ms)} "
        f"prefills + {len(timed.decode_ms)} decode steps)")
    profile_waves(ServingEngine(timed.model, params, engine.max_seq),
                  [waves[0], waves[-1]])
    return launches


# gemma3-12b, deepseek-v2-236b, phi3-medium-14b, mistral-large-123b,
# internvl2-2b and seamless-m4t-medium as phases 4e-4g serve them, whole or
# cut by depth only: parameters by `jax.eval_shape` of the reference's init
# (tests/test_torch_archs.py).
GEMMA3_PARAMS = 11_765_395_200
DEEPSEEK_CUT_LAYERS, DEEPSEEK_CUT_PARAMS = 5, 17_243_571_200
PHI3_PARAMS = 14_659_507_200
MISTRAL_CUT_LAYERS, MISTRAL_CUT_PARAMS = 8, 11_878_477_824
INTERNVL2_PARAMS = 1_893_828_608
SEAMLESS_PARAMS = 979_433_472


def _init_checked(cfg, seed: int, want: int):
    params, n_params = _init_full(cfg, seed)
    if n_params != want:
        raise AssertionError(f"{cfg.name}: {n_params} params, want {want}")
    return params


def _decode_read_bound(cfg, params) -> tuple:
    """Bytes of the weights one decode step reads, and their time at the
    card's memory rate: every leaf but the embedding table (a decode step
    gathers B of its rows; with tied embeddings it is the LM head and
    counts), the encoder and the modality projections (prefill only).
    The `dropping` dispatch multiplies every expert."""
    from repro_torch.tree import tree_leaves
    skip = {"encoder", "frame_proj", "img_proj"}
    if not cfg.tie_embeddings:
        skip.add("embed")
    nbytes = sum(x.numel() * x.element_size()
                 for key, sub in params.items() if key not in skip
                 for x in tree_leaves(sub))
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def _serve_bounded(cfg, params, n_short: int, card: str, long_prompts,
               want_flash_per_wave: int) -> tuple:
    """`_serve`, then flash's launches held to `want_flash_per_wave` a
    prefill wave and the decode step printed beside its read bound."""
    timed, engine, waves, launches = _serve(cfg, params, n_short, card,
                                            long_prompts=long_prompts)
    flash = launches["flash_attention"]
    if flash != want_flash_per_wave * len(waves):
        raise AssertionError(f"{cfg.name}: flash_attention launched {flash} "
                             f"times, want {want_flash_per_wave} x "
                             f"{len(waves)} waves")
    nbytes, bound_ms = _decode_read_bound(cfg, params)
    decode_ms = statistics.median(timed.decode_ms)
    log(f"[serve] {cfg.name} flash_attention launches {flash} = "
        f"{want_flash_per_wave} x {len(waves)} waves; a decode step reads "
        f"{nbytes} bytes of weights, bound {bound_ms:.3f} ms at 3.35 TB/s; "
        f"measured median {decode_ms:.3f} ms ({decode_ms / bound_ms:.2f}x)")
    return timed, engine, waves, {"flash": flash, "decode_ms": decode_ms,
                                  "decode_bound_ms": bound_ms,
                                  "prefill_log": timed.prefill_log}


# mixtral-8x22b cut to 8 of its 56 layers at full width (serve, phase 4d)
# and to 1 (train, phase 5b): their parameters by `jax.eval_shape` of the
# reference's init (tests/test_torch_moe.py).
MIXTRAL_SERVE_PARAMS = 20_435_146_752
MIXTRAL_TRAIN_PARAMS = 2_906_720_256


def serve_mixtral(card: str) -> dict:
    """mixtral-8x22b cut to 8 layers at full width (bf16, random weights,
    `dropping` dispatch) through `ServingEngine`: short trace prompts,
    2x2048 and 1x8192 (past the 4096 window: ring caches of 4096 slots), 16
    new tokens each; flash launched once a layer a prefill wave. Prints the
    decode step's weight-read bound, and profiles the 1x8192 wave and one
    decode step after it. Returns flash_attention's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("mixtral-8x22b").scaled(num_layers=8)
    params = _init_checked(cfg, SEED + 5, MIXTRAL_SERVE_PARAMS)
    timed, engine, waves, out = _serve_bounded(cfg, params, 4, card,
                                           (2048, 2048, 8192), cfg.num_layers)
    long_wave = [w for w in waves if len(w[0].prompt) == 8192]
    profile_waves(ServingEngine(timed.model, params, engine.max_seq),
                  long_wave)
    model = build_model(cfg)
    prompt = torch.from_numpy(long_wave[0][0].prompt).long()[None].cuda()
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      max_seq=engine.max_seq)
        tok = logits[:, -1:].argmax(-1)
        profiled("decode step 1x1 at position 8192",
                 lambda: model.decode_step(params, cache, tok, 8192))
    return out


def serve_gemma3(card: str) -> dict:
    """Phase 4e: gemma3-12b whole (48 layers, bf16, head_dim 256, five of
    six layers windowed to 1024) through `ServingEngine`: short trace
    prompts, 2x2048 and 1x8192 (past the window: ring caches of 1024 slots
    in the windowed layers), 16 new tokens each; flash launched 48 times a
    prefill wave; then the profile of the 1x8192 wave."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("gemma3-12b")
    params = _init_checked(cfg, SEED + 7, GEMMA3_PARAMS)
    timed, engine, waves, out = _serve_bounded(cfg, params, 4, card,
                                           (2048, 2048, 8192), cfg.num_layers)
    long_wave = [w for w in waves if len(w[0].prompt) == 8192]
    profile_waves(ServingEngine(timed.model, params, engine.max_seq),
                  long_wave)
    return out


def serve_deepseek(card: str) -> dict:
    """Phase 4f: deepseek-v2-236b cut to its dense first layer and 4 MoE
    layers at full width (bf16, MLA with 128 heads, 160 experts top-6 and
    2 shared, `dropping`) through `ServingEngine`: waves 3x8, 1x32 and
    2x2048, 16 new tokens each; flash at head_dim 192 launched 5 times a
    prefill wave; the absorbed decode beside its read bound."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("deepseek-v2-236b").scaled(num_layers=DEEPSEEK_CUT_LAYERS)
    if cfg.moe.dispatch != "dropping" or not cfg.mla.absorb_decode:
        raise AssertionError(f"deepseek: {cfg.moe}, {cfg.mla}")
    params = _init_checked(cfg, SEED + 9, DEEPSEEK_CUT_PARAMS)
    _, _, _, out = _serve_bounded(cfg, params, 0, card,
                              (8, 8, 8, 32, 2048, 2048), cfg.num_layers)
    return out


def _serve_modal(cfg, params, batch: dict, steps: int, max_seq: int,
                 card: str, want_flash: int) -> dict:
    """A modality model through `Model.prefill` and `decode_step` (the
    ServingEngine takes tokens only, as the reference's does): a warm-up,
    then the timed prefill and `steps` greedy steps; tokens valid, flash
    launched `want_flash` times in the prefill and never in decode."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model, padded_vocab
    model = build_model(cfg)
    batch = _to(batch, "cuda")
    _greedy(model, params, batch, 2, max_seq)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prefix = _prefix(cfg) + batch["tokens"].shape[1]
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_flash = flash_attention.launches
        tok, toks, decode_ms = logits.argmax(-1), [], []
        for i in range(steps):
            toks.append(tok)
            t1 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok, prefix + i)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t1) * 1e3)
        wall_s = time.perf_counter() - t0
    toks = torch.cat(toks, dim=1)
    if not (torch.isfinite(logits).all() and bool((toks >= 0).all())
            and bool((toks < padded_vocab(cfg)).all())):
        raise AssertionError(f"{cfg.name}: bad logits or tokens")
    launches = launch_counts()
    if prefill_flash != want_flash or launches["flash_attention"] != want_flash:
        raise AssertionError(f"{cfg.name}: flash launched {prefill_flash} "
                             f"in the prefill, {launches['flash_attention']} "
                             f"in all; want {want_flash} and none in decode")
    nbytes, bound_ms = _decode_read_bound(cfg, params)
    decode = statistics.median(decode_ms)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    log(f"[serve] card: {card}")
    log(f"[serve] {cfg.name} through Model.prefill/decode_step, inputs "
        f"{shapes}, max_seq {max_seq}: prefill {prefill_ms:.3f} ms, decode "
        f"median {decode:.3f} ms over {steps} steps against a read bound of "
        f"{bound_ms:.3f} ms ({nbytes} bytes of weights; "
        f"{decode / bound_ms:.2f}x); {toks.numel()} tokens in {wall_s:.3f} "
        f"s, {toks.numel() / wall_s:.1f} tokens/s; launches {launches}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return {"flash": prefill_flash, "prefill_ms": prefill_ms,
            "decode_ms": decode, "decode_bound_ms": bound_ms}


def serve_modality_models(card: str) -> dict:
    """Phase 4g (a): internvl2-2b whole, 256 random image embeddings before a
    2x32 prompt, then 16 greedy steps (flash 24 times a prefill); and
    seamless-m4t-medium whole, 2x512 random frames and a 2x32 prompt at
    max_seq 512, so the cross cache is neither padded nor cropped, then 16
    greedy steps (flash 36 times a prefill: 12 encoder, 12 self and 12
    cross layers)."""
    from repro_torch.configs.registry import get_config
    out = {}
    cfg = get_config("internvl2-2b")
    params = _init_checked(cfg, SEED + 13, INTERNVL2_PARAMS)
    out["internvl2-2b"] = _serve_modal(
        cfg, params, _modal_batch(cfg, 2, 32, 0, SEED), 16,
        cfg.num_image_tokens + 32 + 16, card, cfg.num_layers)
    del params
    release_memory()
    cfg = get_config("seamless-m4t-medium")
    params = _init_checked(cfg, SEED + 15, SEAMLESS_PARAMS)
    out["seamless-m4t-medium"] = _serve_modal(
        cfg, params, _modal_batch(cfg, 2, 32, 512, SEED), 16, 512, card,
        cfg.encoder_layers + 2 * cfg.num_layers)
    return out


def serve_dense_models(card: str) -> dict:
    """Phase 4g (b): phi3-medium-14b whole and mistral-large-123b cut to 8
    of its 88 layers at full width, bf16, through `ServingEngine`: one
    trace wave and a 2x2048 wave, 16 new tokens each; flash launched once
    a layer a wave."""
    from repro_torch.configs.registry import get_config
    out = {}
    for cfg, seed, want in (
            (get_config("phi3-medium-14b"), SEED + 17, PHI3_PARAMS),
            (get_config("mistral-large-123b").scaled(
                num_layers=MISTRAL_CUT_LAYERS), SEED + 19,
             MISTRAL_CUT_PARAMS)):
        params = _init_checked(cfg, seed, want)
        out[cfg.name] = _serve_bounded(cfg, params, 1, card, (2048, 2048),
                                   cfg.num_layers)[3]
        del params
        release_memory()
    return out


def profile_waves(engine, waves) -> None:
    """Where a wave's time goes (`profiled`), for each of `waves`."""
    for wave in waves:
        desc = f"{len(wave)}x{len(wave[0].prompt)}+{wave[0].max_new_tokens}"
        profiled(f"wave {desc}", lambda: engine.serve(wave, len(wave)))


def profiled(desc: str, fn) -> None:
    """torch.profiler over one call of `fn`: device busy time (sum of kernel
    times on the one stream) against the wall time, and the kernels that
    take most of it. The profiler's own host cost inflates the wall time,
    so the idle share here is an upper bound. It records the device's
    activity alone (nothing here reads the host's ops): recording those too
    took stablelm's 35,000 launches a wave 23.7-24.0 s to trace, gemma3's
    some 82,000 about a minute."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log(f"[profile] {desc}: the profiler saw no device time")
        return
    log(f"[profile] {desc}: wall {wall_ms:.3f} ms under the "
        f"profiler, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches; tracing took "
        f"{time.perf_counter() - t_trace:.1f} s")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    for name, tag in PORT_KERNELS.items():
        mine = [e for e in kernels if tag in e.key]
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            log(f"[profile]   {name}: {ms:.3f} ms in "
                f"{sum(e.count for e in mine)} launches, {ms / busy_ms:.4f} "
                f"of the device busy time")


# each port kernel's wrapper -> a substring of its CUDA kernels' names
PORT_KERNELS = {"flash_attention": "flash_fwd",
                "flash_attention_bwd": "flash_bwd", "mlstm_scan": "mlstm_fwd",
                "ssm_scan": "ssm_scan_kernel", "int8_matmul": "int8_"}


# ------------------------------------------------------------------ phase 5

# Phase 5's profiled step runs at this sequence length: the eager sLSTM
# loop launches a kernel set a time step, and tracing a step at 512 (619,010
# launches under remat) took 148.4 s of the run.
PROFILE_SEQ_LEN = 128


def _plain_mlstm_loss(cfg, params, batch, seq_len, shards) -> float:
    """The loss at `params` on the first batch, as phase 5 takes it, with
    the model's mLSTM layers on the plain version (`mlstm_scan_ref` in
    bf16) in place of the kernel. Trains `params` in place."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan_ref
    from repro_torch.models import xlstm
    from repro_torch.train.lm import train_lm
    kernel = xlstm.mlstm_scan
    xlstm.mlstm_scan = mlstm_scan_ref
    try:
        return train_lm(cfg, 1, batch, seq_len, shards, params=params,
                        sync=True).losses[0]
    finally:
        xlstm.mlstm_scan = kernel


def _remat_breakdown(cfg, params, batch: int, shards: int) -> None:
    """Where remat's time goes in phase 5's step, at the profiled shape
    (batch x PROFILE_SEQ_LEN, not the timed steps' seq_len): steps under
    "full" and under the config's policy in the order full, policy,
    policy, full (host clock, synced, untraced), then one of each traced
    (device busy time, launches, top kernels); and one shard's forward
    under autograd, what the remat's recompute runs again a shard. The
    policy's extra ms beyond `shards` such forwards is host time the
    recompute's forward does not explain."""
    from repro_torch.models import build_model
    from repro_torch.train.lm import train_lm
    from repro_torch.tree import tree_map
    tokens = torch.randint(1, cfg.vocab_size - 1,
                           (batch // shards, PROFILE_SEQ_LEN),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 3), device="cuda")
    model = build_model(cfg.scaled(remat_policy="full"))

    def forward():
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            model.loss_fn(leaves, {"tokens": tokens})
        torch.cuda.synchronize()

    forward()
    t0 = time.perf_counter()
    forward()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    cfgs = {p: cfg.scaled(remat_policy=p) for p in ("full", cfg.remat_policy)}
    step = {p: [] for p in cfgs}
    for policy in ("full", cfg.remat_policy, cfg.remat_policy, "full"):
        step[policy] += train_lm(cfgs[policy], 1, batch, PROFILE_SEQ_LEN,
                                 shards, params=params, sync=True).step_ms
    for policy, c in cfgs.items():
        profiled(f"train step {batch}x{PROFILE_SEQ_LEN} in {shards} shards, "
                 f"remat_policy {policy!r}",
                 lambda: train_lm(c, 1, batch, PROFILE_SEQ_LEN, shards,
                                  params=params, sync=True))
    mean = {p: statistics.mean(ms) for p, ms in step.items()}
    extra = mean[cfg.remat_policy] - mean["full"]
    log(f"[train] remat at {batch}x{PROFILE_SEQ_LEN} in {shards} shards "
        f"(host clock, synced, untraced, in the order full, "
        f"{cfg.remat_policy}, {cfg.remat_policy}, full): step ms {step}, "
        f"means {mean}; {cfg.remat_policy!r} adds {extra:.1f} ms; one "
        f"shard's forward under autograd {fwd_ms:.1f} ms, x {shards} shards "
        f"= {shards * fwd_ms:.1f} ms of recompute; the rest "
        f"{extra - shards * fwd_ms:.1f} ms")


# Phases 5 and 7 train xlstm-125m cut from 12 layers to 2 at full width
# for the run's time: to 6 once phase 10 held the MoE and hybrid decoders
# (the whole run passed 850 s), to 2 (one sLSTM and one mLSTM layer) once
# it held MLA, the xLSTM cells and the tied, chunked head.
TRAIN_XLSTM_LAYERS = 2


def train_full_model() -> int:
    """xlstm-125m cut to TRAIN_XLSTM_LAYERS through `train_lm`; returns
    mlstm_scan's launches in the 4 timed steps. Then the loss at the
    initial weights with the plain version in place of the kernel
    (`_plain_mlstm_loss`): it must agree to MLSTM_LOSS_RTOL."""
    from repro_torch.bridge import init_params
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.train.lm import train_lm
    from repro_torch.tree import tree_map

    cfg = get_config("xlstm-125m").scaled(num_layers=TRAIN_XLSTM_LAYERS)
    batch, shards, seq_len, steps = 8, 2, 512, 4
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 2))
    torch.cuda.synchronize()
    log(f"[train] xlstm-125m {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.param_dtype} params, {cfg.opt_state_dtype} moments: "
        f"{_numel(params)} params initialized in "
        f"{time.perf_counter() - t0:.1f} s")
    initial = tree_map(torch.clone, params)
    warm = train_lm(cfg, 1, batch, seq_len, shards, params=params, sync=True)
    log(f"[train] warm-up step: {warm.step_ms[0]:.1f} ms, loss "
        f"{warm.losses[0]}")
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    res = train_lm(cfg, steps, batch, seq_len, shards, params=params,
                   sync=True)
    launches = mlstm_scan.launches

    want = cfg.pattern.count(MLSTM) * cfg.num_groups * shards * steps \
        * remat_runs(cfg)
    if launches != want:
        raise AssertionError(f"mlstm_scan launched {launches} times, want "
                             f"{want} (mLSTM layers x shards x steps x "
                             f"forwards a step under remat)")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"loss did not fall: {res.losses}")
    step_ms = statistics.median(res.step_ms)
    log(f"[train] {steps} steps, global batch {batch} x {seq_len} tokens in "
        f"{shards} shards: losses {res.losses}")
    log(f"[train] mlstm_scan launches {launches} = "
        f"{want // (shards * steps * remat_runs(cfg))} mLSTM layers x "
        f"{shards} shards x {steps} steps x {remat_runs(cfg)} forwards "
        f"(remat_policy {cfg.remat_policy!r})")
    log(f"[train] step ms (host clock, synced): median {step_ms:.3f}, all "
        f"{[round(x, 3) for x in res.step_ms]}; "
        f"{batch * seq_len / (step_ms / 1e3):.1f} tokens/s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    _remat_breakdown(cfg, params, batch, shards)
    plain = _plain_mlstm_loss(cfg, initial, batch, seq_len, shards)
    got = warm.losses[0]
    log(f"[train] the plain mlstm_scan_ref (bf16) in place of the kernel, "
        f"from the same initial weights: loss {plain} at them (kernel "
        f"{got}, rel diff {abs(got - plain) / abs(plain):.3g}, gate "
        f"{MLSTM_LOSS_RTOL})")
    if not abs(got - plain) <= MLSTM_LOSS_RTOL * abs(plain):
        raise AssertionError(f"loss at the initial weights: kernel {got}, "
                             f"plain version {plain}")
    return launches


# ----------------------------------------------------------------- phase 5b

# Phase 5b's losses of the resumed Trainer and of the AsyncTrainer against
# the uninterrupted Trainer's, each to this share of its value: the same
# kernels on the same inputs, but the card's embedding backward sums
# gradients by atomics in no fixed order, and the bf16 params can round
# an ulp apart after the first step.
TRAIN_RESUME_RTOL = 1e-3
CKPT_DIR = ROOT / "build" / "chip_smoke_checkpoints"


def _ckpt_log(what: str, timings: list) -> None:
    for t in timings:
        if t["op"] == "save":
            log(f"[train mixtral] {what} save of step {t['step']}: "
                f"{t['bytes']} bytes, snapshot to host {t['snapshot_s']:.2f} "
                f"s ({t['bytes'] / t['snapshot_s'] / 1e6:.1f} MB/s), write "
                f"{t['write_s']:.2f} s ({t['bytes'] / t['write_s'] / 1e6:.1f} "
                f"MB/s)")
        else:
            log(f"[train mixtral] {what} restore of step {t['step']}: "
                f"{t['bytes']} bytes in {t['read_s']:.2f} s "
                f"({t['bytes'] / t['read_s'] / 1e6:.1f} MB/s)")


def _check_losses(what: str, got: list, want: dict) -> float:
    rel = 0.0
    for step, loss in got:
        rel = max(rel, abs(loss - want[step]) / abs(want[step]))
    if not rel <= TRAIN_RESUME_RTOL:
        raise AssertionError(f"{what} losses {got} vs the Trainer's {want}: "
                             f"rel err {rel} > {TRAIN_RESUME_RTOL}")
    return rel


def train_mixtral() -> dict:
    """mixtral-8x22b cut to 1 layer at full width (bf16 params and AdamW
    moments, `dropping`), global batch 2 x 2048: (a) `Trainer`, 4 steps,
    async checkpoints at steps 2 and 4; (b) a fresh `Trainer` restores
    step 2 and runs steps 2-3, with (a)'s losses; (c) `AsyncTrainer` on a
    cluster of a cpu node and a gpu node, 4 steps, backup loads and one
    checkpoint task, with (a)'s losses. flash_attention must launch in each,
    forward and backward. Returns its launches by run: {"flash": ...,
    "flash_bwd": ...}."""
    from repro_torch import core
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import AsyncTrainer, Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = get_config("mixtral-8x22b").scaled(num_layers=1)
    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                      global_batch=2)
    opt = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    seed, steps = SEED + 6, 4
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    launches, bwd = {}, {}

    # (a) the Trainer, uninterrupted
    trainer = Trainer(model, data, TrainerConfig(
        steps=steps, checkpoint_every=2, checkpoint_dir=str(CKPT_DIR / "a"),
        log_every=1, opt=opt))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = trainer.run(seed=seed)
    launches["Trainer"] = flash_attention.launches
    bwd["Trainer"] = flash_attention.bwd_launches
    n_params = sum(x.numel() for x in tree_leaves(res["params"]))
    state_bytes = sum(x.numel() * x.element_size() for x in
                      tree_leaves((res["params"], res["opt"])))
    want = dict(res["losses"])
    if n_params != MIXTRAL_TRAIN_PARAMS or \
            not all(math.isfinite(x) for x in want.values()) or \
            sorted(want) != list(range(steps)):
        raise AssertionError(f"{n_params} params, losses {res['losses']}")
    log(f"[train mixtral] {cfg.name} 1 layer d={cfg.d_model} "
        f"{cfg.moe.num_experts} experts ({cfg.moe.dispatch}), "
        f"{cfg.param_dtype} params, {opt.state_dtype} moments: {n_params} "
        f"params, state {state_bytes} bytes; global batch 2 x 2048")
    log(f"[train mixtral] (a) Trainer, {steps} steps: losses "
        f"{res['losses']}; step ms (host clock, each step waits for its "
        f"loss) {[round(x, 3) for x in res['step_ms']]}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
        f"flash_attention launches {launches['Trainer']}, backward "
        f"{bwd['Trainer']}")
    _ckpt_log("(a)", trainer.ckpt.timings)
    del res, trainer
    release_memory()

    # (b) a fresh Trainer resumes from step 2
    shutil.rmtree(CKPT_DIR / "a" / f"step_{steps}")
    trainer = Trainer(model, data, TrainerConfig(
        steps=steps, checkpoint_every=100, checkpoint_dir=str(CKPT_DIR / "a"),
        log_every=1, opt=opt))
    reset_launch_counts()
    res = trainer.run(seed=seed + 1)
    launches["Trainer resumed"] = flash_attention.launches
    bwd["Trainer resumed"] = flash_attention.bwd_launches
    rel = _check_losses("(b) resumed", res["losses"], want)
    if [s for s, _ in res["losses"]] != [2, 3]:
        raise AssertionError(f"resumed at {res['losses']}")
    log(f"[train mixtral] (b) Trainer resumed from step 2: losses "
        f"{res['losses']}, max rel err against (a) {rel} (tol "
        f"{TRAIN_RESUME_RTOL}); step ms {[round(x, 3) for x in res['step_ms']]}")
    _ckpt_log("(b)", trainer.ckpt.timings)
    del res, trainer
    shutil.rmtree(CKPT_DIR / "a")
    release_memory()

    # (c) the AsyncTrainer: two states on the card (the step's copy)
    cluster = core.init(node_resources=[{"cpu": 2.0},
                                        {"cpu": 2.0, "gpu": 1.0}])
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = AsyncTrainer(model, data, TrainerConfig(
            steps=steps, checkpoint_every=steps,
            checkpoint_dir=str(CKPT_DIR / "c"), log_every=1, opt=opt),
            backup_tasks=True).run(seed=seed)
        wall_s = time.perf_counter() - t0
        launches["AsyncTrainer"] = flash_attention.launches
        bwd["AsyncTrainer"] = flash_attention.bwd_launches
        # the run ends waiting for its checkpoint task, the last to finish
        events = cluster.gcs.events()
        end = [e for e in events if e[1] == "finish"][-1]
        start = next(e for e in events if e[1] == "start" and e[2] == end[2])
        save_s = end[0] - start[0]
        del res["state_ref"]
    finally:
        core.shutdown()
    rel = _check_losses("(c) AsyncTrainer", res["losses"], want)
    saved = Checkpointer(str(CKPT_DIR / "c")).steps()
    if saved != [steps]:
        raise AssertionError(f"AsyncTrainer checkpoints {saved}")
    log(f"[train mixtral] (c) AsyncTrainer, {steps} steps, backup loads, one "
        f"checkpoint task: losses {res['losses']}, max rel err against (a) "
        f"{rel} (tol {TRAIN_RESUME_RTOL}); wall {wall_s:.2f} s; the save "
        f"task (snapshot and write) {save_s:.2f} s for {state_bytes} bytes "
        f"({state_bytes / save_s / 1e6:.1f} MB/s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    shutil.rmtree(CKPT_DIR)
    for what, n in launches.items():
        if n < 1 or bwd[what] < 1:
            raise AssertionError(f"flash_attention launched {n} times, its "
                                 f"backward {bwd[what]}, in {what}")
    log(f"[train mixtral] flash_attention launches {launches}, backward "
        f"{bwd}")
    return {"flash": launches, "flash_bwd": bwd}


# ----------------------------------------------------------------- phase 5c

# 5c(a): each arch through `launch.train.train` at its config's own
# remat_policy: (arch, depth cut or None, global batch, seq_len, params).
# Widths are never cut. B x S is chosen to fit the card beside the state
# (flash's backward kernel holds only O(S) beside a layer's activations,
# where autograd through the plain version held (B,H,S,S) fp32 scores);
# xlstm runs short (its eager sLSTM loop, A4), and
# is cut from 12 layers to 2 (one sLSTM, one mLSTM) for the run's time, as
# phases 5 and 7 are: whole, its 4 steps took about 10 s.
LAUNCH_TRAIN = (
    ("stablelm-1.6b", None, 2, 2048, 1_644_267_520),
    ("internvl2-2b", None, 2, 2048, 1_893_828_608),
    ("seamless-m4t-medium", None, 2, 1024, 979_433_472),
    ("gemma3-12b", 6, 1, 2048, 2_351_481_600),
    ("phi3-medium-14b", 4, 1, 2048, 2_390_799_360),
    ("mistral-large-123b", 2, 1, 2048, 3_573_608_448),
    ("deepseek-v2-236b", 2, 1, 2048, 5_327_221_760),
    ("xlstm-125m", 2, 2, 128, 56_064_776),
)
# 5c(a) also trains stablelm-1.6b whole at 2x2048 with its attention
# logits softcapped at Gemma 2's published `attn_logit_softcapping`, 50.0:
# the flash kernels' tanh in both directions.
LAUNCH_SOFTCAP = 50.0
# 1 warm-up step, then the timed ones
LAUNCH_STEPS = 4
# jamba-1.5-large-398b trains at its smoke config: one full-width group
# with dense FFNs is JAMBA_CUT_PARAMS, 72 GB of bf16 params and grads and
# bf16 moments before any activation.
JAMBA_SMOKE_TRAIN = (2, 64)
# 5c(b): ssm_scan at jamba's full-width layer, B=1 S=2048 di=16,384 ds=16.
SSM_TRAIN_SHAPE = (1, 2048, 16_384, 16)
# 5c(c): gemma3-12b's cut group at 2048 positions under each policy. The
# grads of a policy against "full"'s, each leaf to GRAD_RTOL of its largest
# entry: the recompute runs the same kernels on the same inputs, but the
# card's embedding backward adds by atomics in no fixed order.
REMAT_POLICIES = ("full", "dots", "nothing")
# 5c(d): stablelm-1.6b cut to 2 layers at full width, 3 compressed steps.
COMPRESS_LAYERS, COMPRESS_STEPS = 2, 3
STABLELM_CUT2_PARAMS = 513_812_480


def _train_launches(cfg) -> dict:
    """Each kernel's launches a training step: one a layer the forward
    runs, the layers inside the remat (the groups, the encoder) twice
    under `"dots"` and `"nothing"`; the `first` layers once. Cross-
    attention is one more flash call a decoder layer. Flash's backward
    ("flash_attention_bwd") runs once a flash call of the forward, whatever
    the remat recomputes."""
    from repro_torch.configs.base import ATTN, MAMBA, MLA, MLSTM, SWA
    r = remat_runs(cfg)
    attn, cross = (ATTN, SWA, MLA), int(cfg.encoder_layers > 0)
    first = cfg.first_k_dense * (int(cfg.pattern[0] in attn) + cross)
    group = cfg.num_groups * (sum(k in attn for k in cfg.pattern)
                              + cross * len(cfg.pattern))
    return {"flash_attention": first + r * (group + cfg.encoder_layers),
            "flash_attention_bwd": first + group + cfg.encoder_layers,
            "mlstm_scan": r * cfg.num_groups * cfg.pattern.count(MLSTM),
            "ssm_scan": r * cfg.num_groups * cfg.pattern.count(MAMBA),
            "int8_matmul": 0}


def _launch_train_one(what: str, cfg, params, batch: int, seq_len: int,
                      n_params: int) -> dict:
    """`launch.train.train` for LAUNCH_STEPS steps from `params`: finite
    losses, each kernel launched as `_train_launches` says; step ms of the
    timed steps, peak memory."""
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends, held = [], {}

    def on_step(step, metrics):   # an event at each step's end, no sync
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()

    def on_state(params, opt_state):   # what the loop holds: phase 9 (a)
        leaves = tree_leaves(params) + tree_leaves(opt_state)
        held["devices"] = sorted({t.device.type for t in leaves})
        held["bytes"] = sum(t.numel() * t.element_size() for t in leaves)

    reset_launch_counts()
    t0 = time.perf_counter()
    losses = train(cfg, steps=LAUNCH_STEPS, batch=batch, seq_len=seq_len,
                   params=params, log_every=LAUNCH_STEPS, on_step=on_step,
                   on_state=on_state)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    want = {k: n * LAUNCH_STEPS for k, n in _train_launches(cfg).items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    moments = 2 * (4 if cfg.opt_state_dtype == "float32" else 2)
    out = {"params": n_params, "remat_policy": cfg.remat_policy,
           "batch": f"{batch}x{seq_len}", "losses": losses,
           "step_ms": statistics.median(step_ms), "all_step_ms": step_ms,
           "wall_ms": wall_ms,
           "state_bytes": n_params * (2 + 2 + moments),
           "held_state_bytes": held["bytes"],
           "held_state_devices": held["devices"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches}
    log(f"[launch] {what}: {n_params} params ({cfg.param_dtype}, "
        f"{cfg.opt_state_dtype} moments; params, grads and moments "
        f"{out['state_bytes']} bytes), remat_policy {cfg.remat_policy!r}, "
        f"global batch {batch} x {seq_len}: losses {losses}; step ms "
        f"(CUDA events between step ends) median of {LAUNCH_STEPS - 1} "
        f"after a warm-up {out['step_ms']:.3f}, all "
        f"{[round(x, 3) for x in step_ms]}; train() {wall_ms:.1f} ms on the "
        f"host clock, set-up and warm-up included; "
        f"{batch * seq_len / (out['step_ms'] / 1e3):.1f} tokens/s; "
        f"max_memory_allocated {out['max_memory_allocated']} bytes; "
        f"launches {launches} = a step's {_train_launches(cfg)} x "
        f"{LAUNCH_STEPS} steps")
    return out


def _softcap_train_config() -> tuple:
    """(name in phase 5c's record, config, global batch, seq_len) of
    stablelm-1.6b whole with its attention logits softcapped at
    LAUNCH_SOFTCAP, at LAUNCH_TRAIN's stablelm batch."""
    from repro_torch.configs.registry import get_config
    arch, _, batch, seq_len, _ = LAUNCH_TRAIN[0]
    return (f"{arch} softcap {LAUNCH_SOFTCAP:g}",
            get_config(arch).scaled(attn_logit_softcap=LAUNCH_SOFTCAP),
            batch, seq_len)


def launch_train_zoo() -> dict:
    """5c(a): every arch but mixtral (phase 5b) through the launcher's
    loop at full width, cut by depth where LAUNCH_TRAIN says, and
    stablelm-1.6b again with softcapped attention logits
    (`_softcap_train_config`); jamba at its smoke config
    (`launch_config(..., smoke=True)`, fp32)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import launch_config
    out = {}
    for i, (arch, layers, batch, seq_len, want) in enumerate(LAUNCH_TRAIN):
        cfg = get_config(arch)
        if layers:
            cfg = cfg.scaled(num_layers=layers)
        what = f"{arch}" + (f" cut to {layers} layers" if layers else
                            " whole")
        params = _init_checked(cfg, SEED + 20 + i, want)
        out[arch] = _launch_train_one(what, cfg, params, batch, seq_len,
                                      want)
        del params
        release_memory()
    name, cfg, batch, seq_len = _softcap_train_config()
    want = LAUNCH_TRAIN[0][4]
    params = _init_checked(cfg, SEED + 28, want)
    out[name] = _launch_train_one(
        f"stablelm-1.6b whole, attn_logit_softcap {LAUNCH_SOFTCAP}", cfg,
        params, batch, seq_len, want)
    del params
    release_memory()
    cfg = launch_config("jamba-1.5-large-398b", smoke=True)
    params, n = _init_full(cfg, SEED + 30)
    out["jamba-1.5-large-398b smoke"] = _launch_train_one(
        f"jamba-1.5-large-398b smoke (d={cfg.d_model}, {cfg.num_layers} "
        f"layers, fp32; a full-width group does not fit: {JAMBA_CUT_PARAMS} "
        f"params)", cfg, params, *JAMBA_SMOKE_TRAIN, n)
    return out


def check_ssm_scan_backward(gen) -> dict:
    """5c(b): `_SSMScan` at jamba's full-width layer shape (x bf16, dt, B,
    C fp32): y against the plain version (SSM_TOL) and every gradient
    against autograd through `ssm_scan_ref` on the card (both run the same
    plain backward on the same inputs); the forward + backward's ms. Then
    jamba's smoke model, fp32, card vs CPU: loss and every gradient leaf."""
    from repro_torch.bridge import init_params, params_to
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    from repro_torch.models import build_model
    b, s, di, ds = SSM_TRAIN_SHAPE
    args, h0 = _ssm_case(gen, b, s, di, ds, torch.bfloat16, torch.float32)
    cot = torch.randn(b, s, di, generator=gen, device="cuda")

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True) for t in args]
        y, h1 = fn(*leaves)
        grads = torch.autograd.grad((y.float() * cot).sum(), leaves)
        return (y.detach(), h1.detach()), grads

    reset_launch_counts()
    y, grads = fwd_bwd(ssm_scan)
    if ssm_scan.launches != 1:
        raise AssertionError(f"ssm_scan launched {ssm_scan.launches} times "
                             "in one forward + backward")
    y_ref, grads_ref = fwd_bwd(ssm_scan_ref)
    err = _ssm_err("through _SSMScan at the train shape", y, y_ref)
    grad_err = 0.0
    for name, a, r in zip(("x", "dt", "B", "C", "A", "D"), grads, grads_ref):
        rel = float((a.float() - r.float()).abs().max()) / max(
            float(r.float().abs().max()), 1e-30)
        if not (torch.isfinite(a).all() and rel <= GRAD_RTOL):
            raise AssertionError(f"ssm_scan d{name}: {rel} > {GRAD_RTOL}")
        grad_err = max(grad_err, rel)
    del y, y_ref, grads, grads_ref
    ms = cuda_ms(lambda: fwd_bwd(ssm_scan), 2, warmup=0)
    plain_ms = cuda_ms(lambda: fwd_bwd(ssm_scan_ref), 2, warmup=0)
    log(f"[launch] ssm_scan through _SSMScan at B={b} S={s} di={di} ds={ds} "
        f"(x bf16, dt/B/C fp32): y max_abs_err {err} (tol "
        f"{SSM_TOL[torch.bfloat16]}, h_last {SSM_TOL[torch.float32]}); dx, ddt, dB, dC, dA, dD against "
        f"autograd through ssm_scan_ref on the card: max err / max |g| "
        f"{grad_err} (tol {GRAD_RTOL}); forward + backward {ms:.3f} ms "
        f"(kernel forward, plain recompute backward), all plain "
        f"{plain_ms:.3f} ms")
    release_memory()

    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(
        param_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    figures = _grads_card_vs_cpu("jamba smoke", build_model(cfg), params,
                                 params_to(params, "cpu"),
                                 _train_tokens(cfg.vocab_size, 64))
    log(f"[launch] jamba-1.5-large-398b smoke (MoE {cfg.moe.dispatch}), "
        f"fp32, 2x64 tokens, card vs CPU: {figures}")
    return {"shape": f"B={b} S={s} di={di} ds={ds} x bf16",
            "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms,
            "y_max_abs_err": err, "grad_rel_err": grad_err}


def check_remat_on_the_card() -> dict:
    """5c(c): gemma3-12b cut to one 6-layer group, bf16, 1 x 2048 tokens:
    every gradient leaf under "dots" and "nothing" against "full"'s, and
    each policy's peak memory above what the step started with."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves
    cfg = get_config("gemma3-12b").scaled(num_layers=6)
    params = _init_checked(cfg, SEED + 40, LAUNCH_TRAIN[3][4])
    batch = {"tokens": _train_tokens(cfg.vocab_size, 2048)[:1].cuda()}
    out, full = {}, None
    for policy in REMAT_POLICIES:
        model = build_model(cfg.scaled(remat_policy=policy))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        (loss, _), grads = value_and_grad(model, params, batch)
        grads = tree_leaves(grads)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        flash = launch_counts()["flash_attention"]
        flash_bwd = launch_counts()["flash_attention_bwd"]
        want = _train_launches(model.cfg)
        if (flash, flash_bwd) != (want["flash_attention"],
                                  want["flash_attention_bwd"]):
            raise AssertionError(f"remat {policy}: flash launched {flash}, "
                                 f"its backward {flash_bwd}")
        if full is None:
            full, equal, worst = (float(loss), grads), len(grads), 0.0
        else:
            if float(loss) != full[0]:
                raise AssertionError(f"remat {policy}: loss {float(loss)} vs "
                                     f"full {full[0]}")
            equal, worst = 0, 0.0
            for a, r in zip(grads, full[1]):
                equal += bool(torch.equal(a, r))
                rel = float((a.float() - r.float()).abs().max()) / max(
                    float(r.float().abs().max()), 1e-30)
                if not rel <= GRAD_RTOL:
                    raise AssertionError(f"remat {policy} grad "
                                         f"{tuple(a.shape)}: {rel}")
                worst = max(worst, rel)
            del grads
        out[policy] = {"peak_bytes": peak, "leaves_bit_equal": equal,
                       "leaves": len(full[1]), "max_rel_err": worst,
                       "flash_launches": flash,
                       "flash_bwd_launches": flash_bwd}
        log(f"[launch] remat {policy!r}, gemma3-12b cut to 6 layers, 1x2048 "
            f"bf16: loss {float(loss)}; peak memory above the params "
            f"{peak} bytes; {equal} of {len(full[1])} gradient leaves "
            f"bit-equal to 'full''s, max err / max |g| {worst} (tol "
            f"{GRAD_RTOL}); flash launches {flash}, backward {flash_bwd}")
        release_memory()
    return out


def check_compression() -> dict:
    """5c(d): `make_compressing_train_step` for COMPRESS_STEPS steps on
    stablelm-1.6b cut to 2 layers at full width (bf16, every leaf of 4096
    elements and up through int8 with error feedback): finite losses, a
    finite error feedback; `quantize_int8` on the card against the CPU, bit
    for bit, on a stablelm-sized leaf."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.compression import (
        init_error_feedback, make_compressing_train_step, quantize_int8)
    from repro_torch.tree import tree_leaves
    cfg = get_config("stablelm-1.6b").scaled(num_layers=COMPRESS_LAYERS)
    params = _init_checked(cfg, SEED + 50, STABLELM_CUT2_PARAMS)
    opt = adamw_init(params, cfg.opt_state_dtype)
    efb = init_error_feedback(params)
    step = make_compressing_train_step(
        build_model(cfg), AdamWConfig(state_dtype=cfg.opt_state_dtype))
    batch = {"tokens": _train_tokens(cfg.vocab_size, 2048).cuda()}
    losses, step_ms = [], []
    reset_launch_counts()
    for _ in range(COMPRESS_STEPS):
        t0 = time.perf_counter()
        params, opt, efb, m = step(params, opt, efb, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    efb_max = max(float(e.abs().max()) for e in tree_leaves(efb))
    if not (all(math.isfinite(x) for x in losses) and math.isfinite(efb_max)
            and efb_max > 0):
        raise AssertionError(f"compression: losses {losses}, error feedback "
                             f"max {efb_max}")
    want = COMPRESS_STEPS * _train_launches(cfg)["flash_attention"]
    if launches["flash_attention"] != want:
        raise AssertionError(f"compression: launches {launches}")
    x = torch.randn(*STABLELM_UP, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 51), device="cuda")
    q, s = quantize_int8(x)
    q_cpu, s_cpu = quantize_int8(x.cpu())
    if not (torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)):
        raise AssertionError("quantize_int8 on the card differs from the CPU")
    log(f"[launch] make_compressing_train_step, stablelm-1.6b cut to "
        f"{COMPRESS_LAYERS} layers ({STABLELM_CUT2_PARAMS} params, bf16), "
        f"2x2048 tokens: losses {losses}; error feedback max |e| {efb_max}; "
        f"step ms {[round(t, 3) for t in step_ms]}; launches {launches}; "
        f"quantize_int8 of a {STABLELM_UP} fp32 leaf on the card equal to "
        f"the CPU's bit for bit (scale {float(s)})")
    return {"losses": losses, "step_ms": step_ms, "launches": launches}


LAUNCH_SERVE_MODAL = {"seamless-m4t-medium": "frames",
                      "internvl2-2b": "image_embeds"}


def launch_serve_zoo() -> dict:
    """5c(e): `repro_torch.launch.serve` with `--smoke` for each of the ten
    arches on the card (its default device): the two modal arches raise
    KeyError as the reference's do; stablelm-1.6b and xlstm-125m at full
    size; and the module itself once as `python -m`."""
    import contextlib
    import io
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import serve
    out = {}
    runs = [(a, ["--arch", a, "--smoke"]) for a in ARCH_IDS] + [
        (f"{a} full", ["--arch", a]) for a in ("stablelm-1.6b", "xlstm-125m")]
    for what, argv in runs:
        reset_launch_counts()
        buf = io.StringIO()
        arch = argv[1]
        try:
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
        except KeyError as e:
            if arch not in LAUNCH_SERVE_MODAL or \
                    e.args != (LAUNCH_SERVE_MODAL[arch],):
                raise
            line = f"KeyError {e} (the engine takes tokens only)"
        else:
            if arch in LAUNCH_SERVE_MODAL:
                raise AssertionError(f"{what}: served without its modality")
            line = buf.getvalue().strip().splitlines()[-1]
            if not line.startswith("8 requests, 64 tokens"):
                raise AssertionError(f"{what}: {line}")
        out[what] = {"line": line, "launches": launch_counts()}
        log(f"[launch] serve {what}: {line}; launches {out[what]['launches']}")
        release_memory()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-1.6b", "--smoke"], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env={**os.environ,
                                    "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode != 0 or "8 requests, 64 tokens" not in proc.stdout:
        raise AssertionError(f"python -m repro_torch.launch.serve: rc "
                             f"{proc.returncode}\n{proc.stdout}\n"
                             f"{proc.stderr[-2000:]}")
    log(f"[launch] python -m repro_torch.launch.serve --arch stablelm-1.6b "
        f"--smoke: {proc.stdout.strip()}")
    return out


def launch_phase(gen) -> dict:
    """Phase 5c: the launchers' paths, (a) to (e)."""
    out = {"train": timed("launch train", launch_train_zoo)}
    out["ssm_backward"] = timed("launch ssm_scan backward",
                                check_ssm_scan_backward, gen)
    release_memory()
    out["remat"] = timed("launch remat", check_remat_on_the_card)
    release_memory()
    out["compression"] = timed("launch compression", check_compression)
    release_memory()
    out["serve"] = timed("launch serve", launch_serve_zoo)
    release_memory()
    return out


# ------------------------------------------------------------------ phase 9

# 9(b): one full-width cell of each kind through the dry run's entry point
# on the single-pod plan (16 x 16), which needs no card
DRYRUN_CELLS = (("deepseek-v2-236b", "train_4k"),
                ("mixtral-8x22b", "prefill_32k"),
                ("gemma3-12b", "decode_32k"),
                ("jamba-1.5-large-398b", "long_500k"))


def _phase_5c_configs():
    """(name in phase 5c's record, config, global batch, seq_len) of every
    config phase 5c(a) trains, as it builds them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import launch_config
    out = []
    for arch, layers, batch, seq_len, _ in LAUNCH_TRAIN:
        cfg = get_config(arch)
        out.append((arch, cfg.scaled(num_layers=layers) if layers else cfg,
                    batch, seq_len))
    out.append(_softcap_train_config())
    out.append(("jamba-1.5-large-398b smoke",
                launch_config("jamba-1.5-large-398b", smoke=True),
                *JAMBA_SMOKE_TRAIN))
    return out


def _dryrun_entry_point() -> list:
    """Starts `python -m repro_torch.launch.dryrun` for each DRYRUN_CELLS
    cell, all at once; returns the processes."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--tag", "chip_smoke",
         "--force"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for arch, shape in DRYRUN_CELLS]


def dryrun_phase(trained: dict) -> dict:
    """Phase 9: (a) the dry run at world size 1 (`make_host_mesh()`) of
    every config phase 5c(a) trained, against that config's steps on the
    card: the state's bytes equal the params and AdamW state the launcher
    held, exactly; each kernel's calls a step equal `_train_launches` and
    the launches counted on the card, exactly; the predicted peak (args +
    temp) beside `max_memory_allocated`, and the step's FLOPs share of the
    card's peak (the trace's FLOPs, recompute included, over the median
    step). (b) `python -m repro_torch.launch.dryrun` on DRYRUN_CELLS: every
    record ok, and the process never initialized CUDA."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    procs = _dryrun_entry_point()
    out = {"world_size_1": {}, "entry_point": {}}
    for name, cfg, batch, seq_len in _phase_5c_configs():
        card = trained[name]
        t0 = time.perf_counter()
        rec = dryrun.trace_cell(cfg, ShapeConfig("5c", "train", seq_len,
                                                 batch), make_host_mesh())
        trace_s = time.perf_counter() - t0
        if card["held_state_devices"] != ["cuda"] or \
                rec["state_bytes"] != card["held_state_bytes"]:
            raise AssertionError(f"dry run {name}: state {rec['state_bytes']}"
                                 f" bytes, the launcher held "
                                 f"{card['held_state_bytes']} on "
                                 f"{card['held_state_devices']}")
        calls = {k: v["calls"] for k, v in rec["kernel_calls"].items()}
        per_step = {k: n // LAUNCH_STEPS for k, n in card["launches"].items()
                    if n}
        want = {k: n for k, n in _train_launches(cfg).items() if n}
        if not calls == want == per_step:
            raise AssertionError(f"dry run {name}: kernel calls a step "
                                 f"{calls}, _train_launches {want}, the "
                                 f"card's {per_step}")
        peak = rec["arg_bytes_per_dev"] + rec["temp_bytes_per_dev"]
        rate = PEAK_FLOPS[torch.float32 if cfg.param_dtype == "float32"
                          else torch.bfloat16]
        share = rec["hlo_flops"] / (card["step_ms"] / 1e3 * rate)
        out["world_size_1"][name] = entry = {
            "batch": f"{batch}x{seq_len}", "state_bytes": rec["state_bytes"],
            "kernel_calls_per_step": calls,
            "predicted_peak_bytes": peak,
            "max_memory_allocated": card["max_memory_allocated"],
            "peak_ratio": peak / card["max_memory_allocated"],
            "flops": rec["hlo_flops"], "dot_flops": rec["hlo_dot_flops"],
            "step_ms": card["step_ms"], "peak_flops": rate,
            "flops_share_of_peak": share, "trace_s": trace_s}
        log(f"[dryrun] {name} {batch}x{seq_len} at world size 1: state "
            f"{rec['state_bytes']} bytes = the launcher's on the card; "
            f"kernel calls a step {calls} = _train_launches = the card's; "
            f"predicted peak (args {rec['arg_bytes_per_dev']} + temp "
            f"{rec['temp_bytes_per_dev']}) {peak} bytes, "
            f"max_memory_allocated {card['max_memory_allocated']}, ratio "
            f"{entry['peak_ratio']:.3f}; {rec['hlo_flops']:.6g} flop a step "
            f"({rec['hlo_dot_flops']:.6g} in products) over the median step "
            f"{card['step_ms']:.3f} ms = {share:.4g} of {rate:.3g} flop/s; "
            f"traced in {trace_s:.2f} s")
    for arch, shape, proc in procs:
        text, _ = proc.communicate(timeout=600)
        path = dryrun.RESULTS_DIR / f"{arch}__{shape}__single__chip_smoke.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode != 0 or not rec.get("ok") or \
                rec.get("cuda_initialized") is not False:
            raise AssertionError(f"python -m repro_torch.launch.dryrun "
                                 f"{arch} {shape}: rc {proc.returncode}, "
                                 f"record {rec.get('error')}, cuda "
                                 f"initialized {rec.get('cuda_initialized')}"
                                 f"\n{text[-2000:]}")
        out["entry_point"][f"{arch} {shape}"] = keep = {
            k: rec[k] for k in ("n_params", "hbm_per_dev_gb", "fits_80gb",
                                "hlo_flops", "collective_bytes_total",
                                "collective_bytes_off_node", "kernel_calls",
                                "total_s")}
        log(f"[dryrun] python -m repro_torch.launch.dryrun --arch {arch} "
            f"--shape {shape} --mesh single: ok, CUDA never initialized; "
            f"{json.dumps(keep)}")
    return out


# ----------------------------------------------------------------- phase 10

class ShardedCase(NamedTuple):
    """A sharded training step of phase 10: `arch` at full width (or its
    smoke config in fp32, as `launch.train --smoke` takes it), cut to
    `layers` (None: whole), over `mesh` (data, model) at `batch` x
    `seq_len`."""
    label: str
    arch: str
    layers: Optional[int]     # the decoder's and an encoder's alike
    mesh: tuple
    batch: int
    seq_len: int
    smoke: bool = False
    # the one-card step runs once the ranks have trained and freed the
    # card, and takes their expert choices (`_route`'s top-k, every call in
    # order), its own logged beside them
    routes_from_ranks: bool = False
    # config overrides, (field, value) pairs ("moe": pairs of MoEConfig's)
    over: tuple = ()
    # the int8 compressing step (`launch.train(grad_compression=True)`)
    compress: bool = False


# Widths are never cut. stablelm is cut from 24 layers to 2 for the phase's
# time: whole, its four gloo ranks on one H100 took 13.7-16.0 s a step,
# and the phase 138.6 s (PERF.md, section 5); 6 layers took 47.0-51.6 s
# of the phase, to 2 for the three cases after jamba. mixtral is cut from
# 56 layers to 1, as phase 5b trains it on one card: over (1, 4) a rank
# holds 2 of its 8 experts and 12 query heads over 2 KV heads; the
# `dropping` dispatch, `"dots"` remat, bf16. Not (2, 2): gathering its 1.2
# GB expert blocks over `data` through gloo would take about 16 s a step.
# jamba runs at its smoke config (a full-width group is 72 GB of training
# state): Mamba on each rank's 128 of 256 channels, its residual stream
# without sequence parallelism. deepseek-v2 is cut from 60 layers to 2, as
# phase 5c trains it on one card (its dense first layer and one MoE
# layer): a rank holds 32 of 128 MLA heads, 40 of 160 experts (`dropping`,
# top-6) and the 2 shared experts' columns; its one-card step peaks at
# 51.9 GB, so it runs after the ranks, and takes their expert choices:
# its own differ in 69 of 12,288 top-k assignments (bf16 near ties in the
# router's input, which tensor parallelism rounds otherwise), and at its
# capacity factor of 1.0 each changed choice moves the capacity's cut
# through the expert's queue, which put AdamW `m` up to 8.6% of a leaf's
# largest entry apart (one H100, PERF.md, section 6). The ranks' own
# choices must stay within ROUTES_APART_MAX of the one-card step's.
# gemma3 is cut from
# 48 layers to 6 (one group: 5 windowed at 1024, 1 global), as 5c trains
# it: a rank holds 4 of 16 query heads over 2 of 8 KV heads at head_dim
# 256 and 65,536 rows of the tied table, and the loss at 2048 positions is
# the chunked one.
# xlstm-125m is cut from 12 layers to 2 (one sLSTM, one mLSTM): a rank
# holds 2 of 4 heads of each cell (mlstm_scan at 2 heads of 384).
# seamless-m4t-medium is cut from 12 encoder and 12 decoder layers to 2 and
# 2: a rank holds 8 of 16 heads of the encoder's self-attention, the
# decoder's and its cross-attention (flash non-causal, 2048 decoder rows
# over 2048 encoder keys), 128,256 columns of the untied head, whose
# padded 256,512 entries take the chunked loss at 2048 positions.
# internvl2-2b is cut from 24 layers to 2: over (1, 4) a rank holds 4 of
# 16 query heads over 2 of 8 KV heads, and rank 0's 512 positions of the
# 2048 hold the 256 image rows and the first 256 tokens.
# phi3-medium-14b runs over the production plan's model = 16, cut from 40
# layers to 1 (1,368,407,040 params): its 40 heads of 128 split 320
# columns a rank, 2.5 heads, so each of the 16 ranks runs flash on the 3
# whole heads its columns reach into over 3 KV heads expanded from the 10,
# and draws only its blocks of the seeded weights (the (1, 4) KV-expand
# layout stays with the CPU tests).
# The compressing step runs stablelm cut to 2 layers in fp32: in bf16 the
# two sides' whole-leaf scales differ by the rounding of the leaf's
# largest gradient (about 0.4%), which moves an entry at int8 level k by k
# times that, up to half a quantization step, so a residual could not be
# held entry by entry. In fp32 an entry within its rounding of a half-way
# point still takes either level (COMPRESS_GATES). jamba (sequence
# parallel) and mixtral (ragged dispatch) run their smoke configs in fp32,
# as does stablelm with its attention logits softcapped (each rank's heads
# through the flash kernels' tanh, forward and backward).
SHARDED_TRAIN = (
    ShardedCase("stablelm-1.6b cut to 2 layers", "stablelm-1.6b", 2, (2, 2),
                2, 2048),
    ShardedCase("phi3-medium-14b cut to 1 layer, 40 heads over model = 16",
                "phi3-medium-14b", 1, (1, 16), 1, 2048),
    ShardedCase("mixtral-8x22b cut to 1 layer, experts over model",
                "mixtral-8x22b", 1, (1, 4), 2, 2048),
    ShardedCase("jamba smoke fp32, Mamba and experts over model",
                "jamba-1.5-large-398b", None, (2, 2), 2, 64, smoke=True),
    ShardedCase("deepseek-v2 cut to 2 layers, MLA heads and experts over "
                "model", "deepseek-v2-236b", 2, (1, 4), 1, 2048,
                routes_from_ranks=True),
    ShardedCase("gemma3-12b cut to 6 layers, the tied table's chunked loss",
                "gemma3-12b", 6, (1, 4), 1, 2048),
    ShardedCase("xlstm-125m cut to 2 layers, sLSTM and mLSTM heads over "
                "model", "xlstm-125m", 2, (2, 2), 2, 128),
    ShardedCase("seamless-m4t-medium cut to 2 encoder and 2 decoder layers, "
                "the untied chunked loss", "seamless-m4t-medium", 2, (2, 2),
                2, 2048),
    ShardedCase("internvl2-2b cut to 2 layers, image tokens on rank 0",
                "internvl2-2b", 2, (1, 4), 1, 2048),
    ShardedCase("stablelm-1.6b cut to 2 layers fp32, int8 gradient "
                "compression", "stablelm-1.6b", 2, (2, 2), 2, 2048,
                over=(("param_dtype", "float32"),), compress=True),
    ShardedCase("jamba smoke fp32, Mamba under sequence parallelism",
                "jamba-1.5-large-398b", None, (2, 2), 2, 64, smoke=True,
                over=(("sequence_parallel", True),)),
    ShardedCase("mixtral smoke fp32, the ragged dispatch, experts over "
                "model", "mixtral-8x22b", None, (1, 4), 2, 64, smoke=True,
                over=(("moe", (("dispatch", "ragged"),)),)),
    ShardedCase("stablelm smoke fp32, attention logits softcapped at 2.0",
                "stablelm-1.6b", None, (2, 2), 2, 64, smoke=True,
                over=(("attn_logit_softcap", 2.0),)),
)
# 1 warm-up step, then the timed ones, on both sides
SHARDED_STEPS = 3
# where the one-card step takes the ranks' expert choices, the share of
# the first forward's top-k assignments of a rank's rows that may differ
# from the one-card step's own: deepseek-v2's read 69 of 12,288 (0.56%)
# on every rank in every run on one H100 (PERF.md, section 6)
ROUTES_APART_MAX = 0.015
# The sharded step against the one-card step, by the config's dtype. bf16:
# the loss to 1e-3 of its value, each updated leaf to 1e-3 of its largest
# entry (sums over ranks and a rank's columns round in another order).
# Over 3 steps from step 0 the warm-up's learning rate (0, then 3e-6 and
# 6e-6) leaves the bf16 weights within about an ulp of where they began,
# so the leaves above hold the forward only. The backward, the gradients'
# sync over ranks and the clip are held by each step's gradient norm and
# by AdamW's first moment `m` (the clipped gradients' running mean).
# In bf16 these cannot be held to 1e-3: tensor parallelism rounds each
# rank's partial product to bf16 before the sum, which the one-card
# product rounds once (on the card: `m` within 0.9% of each leaf's largest
# entry, norms up to 5.3e-3 apart). The embedding table's gradient is
# further off on both sides: the lookup's backward (`table[tokens]`) sums
# a frequent token's rows in bf16, and the whole batch and the data ranks'
# rows summed apart differ by about 5% of its largest entry
# (`_embed_grad_rounding` measures it each run). A gradient that misses
# its sync, or a norm summed on one rank only, is off by 55% or more
# (PERF.md, section 6, the planted faults). A bf16 leaf block that starts
# at 0 everywhere (xlstm-125m's conv biases) has no forward to hold: after
# the steps it is AdamW's updates alone, lr x m / sqrt(v) an entry, so it
# carries m's error magnified by the leaf's largest m over the entry's own:
# on one H100 its entries were 0.053-0.298 of the leaf's largest apart
# (40-4,186 bf16 steps of the entry) where the one-card m is at least 1% of
# the leaf's largest, 0.026-0.096 at 10%, 0.013-0.026 at 50% (PERF.md,
# section 6). Such a block is held through m, at the m gate, its own
# reading logged. fp32 (jamba smoke): every leaf held, its conv biases
# too; no gate looser than bf16's; the CPU holds the same step to JAX's at
# 1e-5 (loss, norm) and 1e-4 (leaves, moments), and the card's products
# and the scan's sums run in other orders than the one-card step's.
SHARDED_GATES = {
    torch.bfloat16: {"loss": 1e-3, "leaf": 1e-3, "norm": 2e-2, "m": 5e-2,
                     "m_table": 0.25},
    torch.float32: {"loss": 1e-4, "leaf": 1e-4, "norm": 1e-3, "m": 1e-3,
                    "m_table": 1e-3},
}
# The compressing step (fp32) against the one-card compressing step: the
# losses and every updated leaf to 1e-3, each compressed leaf's scale
# (max |g + e| / 127 over the whole leaf) to 1e-3 of the one card's; the
# residual's blocks to 5e-2 of the leaf's largest residual entry but for
# LEVEL_CHANGES_MAX of a block's entries: a gradient entry within its
# rounding of the half-way point between two int8 levels takes either on
# the two sides (1 or 2 entries of 65,536 in the CPU tests), which moves
# its residual by a whole step (and the next step's by that step over the
# next one's scale, no whole number of steps) and AdamW's m by a step's
# share, up to 1/127 of the leaf's largest gradient over m's largest
# entry (hence m at bf16's 5e-2). A scale taken over a rank's block
# instead of the whole leaf is off by far more than 1e-3 on every block
# that lacks the leaf's largest entry, and moves every entry of its
# residual.
COMPRESS_GATES = {"loss": 1e-3, "leaf": 1e-3, "norm": 1e-3, "m": 5e-2,
                  "m_table": 5e-2, "scale": 1e-3, "residual": 5e-2}
LEVEL_CHANGES_MAX = 1e-3
# the compressing step's size threshold (`make_compressing_train_step`'s
# default), in whole-leaf elements
COMPRESS_THRESHOLD = 4096
# the leaf whose gradient the lookup accumulates in bf16
EMBED_TABLE = "embed/table"
# a bf16 leaf block that starts at 0, logged where the one-card step's m
# is at least these shares of the leaf's largest m
ZERO_M_SHARES = (0.01, 0.1, 0.5)
SHARDED_TIMEOUT_S = 300
SHARDED_DIR = ROOT / "build" / "chip_smoke_sharded"


def _sharded_config(case: ShardedCase):
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import launch_config
    cfg = launch_config(case.arch, True) if case.smoke \
        else get_config(case.arch)
    for field, value in case.over:
        if field == "moe":
            value = dataclasses.replace(cfg.moe, **dict(value))
        cfg = cfg.scaled(**{field: value})
    if not case.layers:
        return cfg
    if cfg.encoder_layers:
        cfg = cfg.scaled(encoder_layers=case.layers)
    return cfg.scaled(num_layers=case.layers)


def _rank_heads(cfg, model: int, m: int = 0) -> tuple:
    """(query heads, KV heads) of the flash calls of the rank at `m` on
    the model axis: the whole heads its block of `w_q`'s columns reaches
    into (H / model where `model` divides them; 3 for phi3's 40 over 16),
    over its own KV heads, or over KV heads expanded to its query heads
    where `model` does not divide them (`ShardingRules.head_span`)."""
    cols = cfg.num_heads * cfg.head_dim
    c0, c1 = m * cols // model, (m + 1) * cols // model
    heads = -(-c1 // cfg.head_dim) - c0 // cfg.head_dim
    return heads, (heads if cfg.num_kv_heads % model
                   else cfg.num_kv_heads // model)


def _recording_routes(moe_mod, replay=None) -> list:
    """Wraps `moe._route` to keep the experts (T, k) each MoE layer of a
    step chose, on the host; returns the list it fills (the first
    forward's layers come first). With `replay` (a list of (T, k) experts,
    one a call in order) each call then takes those experts instead, their
    gates its own probabilities at them, renormalized as `_route` does."""
    real, seen = moe_mod._route, []

    def route(params, mc, x2d):
        out = real(params, mc, x2d)
        seen.append(out[3].detach().cpu())
        if replay is None:
            return out
        logits, probs, _, _ = out
        top_i = replay[len(seen) - 1].to(probs.device)
        top_p = probs.gather(-1, top_i)
        return (logits, probs, top_p / torch.clamp_min(
            top_p.sum(-1, keepdim=True), 1e-9), top_i)
    moe_mod._route = route
    return seen


def _sharded_rank(rank: int, world: int, backend: str, case: int,
                  mesh_shape: tuple, work: str) -> None:
    """One rank of phase 10: the launcher's loop (`launch.train.train`) on
    the case's mesh over `backend` from the seeded weights, its blocks
    held to the one-card step's (`ref.pt`), its flash, ssm_scan and
    mlstm_scan calls, the experts its first forward routed each token to,
    bytes, memory and step ms written to `rank<r>.json`. Ranks over gloo
    share the cards (host memory carries their collectives); over nccl each
    has its own. A rank trains once the one-card step has freed the card
    (`go`) and compares once its state is written (`ref_done`); where the
    one-card step runs after the ranks (`routes_from_ranks`), a rank trains
    at once, moves its blocks to the host, frees the card and says so
    (`trained<r>`) before it waits for `ref_done`. A rank draws only its
    blocks of the seeded weights (`launch.train`'s init over many ranks);
    its peak during the init is written too. Where the case compresses,
    its residual's blocks and every compressed leaf's scale are held to
    the one card's (COMPRESS_GATES)."""
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    from repro_torch.models import attention, moe, ssm, xlstm
    from repro_torch.parallel.collectives import Comm
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel.sharding import _block, leaf_specs, make_rules
    from repro_torch.tree import tree_map
    sc = SHARDED_TRAIN[case]
    work = Path(work)
    # wall times of this rank's steps for the log: imported (spawned during
    # the case before), the case started, the group up, the card free
    marks = {"imported": time.time()}

    def wait_for(name: str, what: str, timeout: float = SHARDED_TIMEOUT_S
                 ) -> None:
        deadline = time.monotonic() + timeout
        while not (work / name).exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"the phase did not {what}")
            time.sleep(0.05)
    # spawned while the case before runs: nothing touches the card or the
    # group until this case starts
    wait_for("start", "start this case", SHARDED_TIMEOUT_S * len(
        SHARDED_TRAIN))
    marks["started"] = time.time()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{work}/rdv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SHARDED_TIMEOUT_S))
    marks["group"] = time.time()
    if not sc.routes_from_ranks:
        # started beside the one-card step: train once it has finished
        wait_for("go", "finish the one-card step")
    marks["go"] = time.time()
    cfg = _sharded_config(sc)
    mesh = Mesh(mesh_shape, ("data", "model"))
    comm = Comm(mesh)
    wrapper, seen = attention.flash_attention, []
    scan, scan_seen = ssm.ssm_scan, []
    mlstm, mlstm_seen = xlstm.mlstm_scan, []

    def flash(q, k, v, **kw):      # the heads of each call, then the kernel
        seen.append((q.shape[1], k.shape[1], kw.get("window", 0)))
        return wrapper(q, k, v, **kw)

    def ssm_scan(x, *args):        # the channels of each call
        scan_seen.append(tuple(x.shape))
        return scan(x, *args)

    def mlstm_scan(q, *args, **kw):    # (B, H, S, hd) of each call
        mlstm_seen.append(tuple(q.shape))
        return mlstm(q, *args, **kw)
    attention.flash_attention, ssm.ssm_scan = flash, ssm_scan
    xlstm.mlstm_scan = mlstm_scan
    routes = _recording_routes(moe)
    q_scales = _recording_scales() if sc.compress else []
    wrapper.launches = wrapper.bwd_launches = 0
    wrapper.launches_by_design = dict.fromkeys(wrapper.launches_by_design, 0)
    wrapper.bwd_launches_by_design = dict.fromkeys(
        wrapper.bwd_launches_by_design, 0)
    scan.launches = mlstm.launches = 0
    ends, per_step, held, norms = [], [], {}, []

    def on_step(step, metrics):
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        norms.append(metrics["grad_norm"])
        per_step.append(comm.stats.snapshot())
        comm.stats.reset()
        marks.setdefault("first step queued", time.time())
    # the blocks that start at 0 everywhere (SHARDED_GATES)
    zero = set()

    def on_state(p, o, *residual):
        marks["initialized"] = time.time()
        # the peak of this rank's init: the largest part of the tree drawn
        # whole, beside the blocks kept
        marks["init_peak"] = torch.cuda.max_memory_allocated()
        held.update(params=p, m=o["m"])
        if residual:
            held["residual"] = residual[0]
        zero.update(path for path, t in zip(_paths(p), _tree_leaves(p))
                    if not bool(t.any()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train(cfg, steps=SHARDED_STEPS, batch=sc.batch,
                   seq_len=sc.seq_len, seed=SEED + 40 + case,
                   mesh=mesh, comm=comm, log_every=SHARDED_STEPS,
                   on_step=on_step, on_state=on_state,
                   grad_compression=sc.compress)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    marks["trained"] = time.time()
    if sc.routes_from_ranks and comm.coords["model"] == 0:
        # every call's experts of this data block, for the one-card step
        torch.save(routes, work / f"calls{comm.coords['data']}.pt")
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    if sc.routes_from_ranks:
        held = tree_map(lambda t: t.cpu(), held)
        norms = [float(n) for n in norms]
        ends.clear()
        release_memory()
        (work / f"trained{rank}").touch()
    wait_for("ref_done", "write the one-card step's state")
    marks["ref"] = time.time()
    # this rank's block of each updated leaf and of AdamW's first moment
    # against the one-card step's
    ref = torch.load(work / "ref.pt", mmap=True, weights_only=True)
    scales = json.loads((work / "ref_max.json").read_text())
    rules = make_rules(mesh, cfg, ShapeConfig("10", "train", sc.seq_len,
                                              sc.batch), comm)
    worst = {"params": (0.0, ""), "m": (0.0, ""), "m_table": (0.0, ""),
             "params_from_zero": (0.0, "")}
    bf16, zero_m = cfg.param_dtype == "bfloat16", {}
    for part in ("params", "m"):
        paths = _paths(held[part])
        for (block, spec), path, whole in zip(
                leaf_specs(held[part], rules.param_specs()), paths,
                _ref_leaves(ref[part], paths)):
            idx = _block(spec, comm.coords, mesh, whole.shape)
            diff = (block.cuda().float() - whole[idx].cuda().float()).abs()
            scale = scales[part][path] or 1.0
            err = float(diff.max()) / scale
            key = "m_table" if part == "m" and path == EMBED_TABLE else part
            if part == "params" and path in zero and bf16:
                key = "params_from_zero"        # held through m
                share = next(_ref_leaves(ref["m"], [path]))[idx].cuda() \
                    .float().abs() / (scales["m"][path] or 1.0)
                zero_m[path] = [float(torch.where(share >= s, diff, 0).max())
                                / scale for s in ZERO_M_SHARES]
            elif part == "m" and path in zero and bf16:
                zero_m[path].append(err)
            worst[key] = max(worst[key], (err, path))
    compressed = (_compressed_against(held["residual"], q_scales, ref,
                                      scales["residual"], json.loads(
                                          (work / "ref_scales.json")
                                          .read_text()), rules)
                  if sc.compress else {})
    # the experts the first forward's MoE layers chose for this rank's rows
    rows, n_rows = rules.batch_split()
    moe_layers = cfg.num_groups * cfg.ffn_pattern.count("moe")
    if routes:
        torch.save([r.reshape(sc.batch // n_rows, sc.seq_len, -1)
                    for r in routes[:moe_layers]],
                   work / f"routes{rank}.pt")
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "card": torch.cuda.current_device(),
        "backend": dist.get_backend(), "losses": losses,
        "grad_norms": [float(n) for n in norms],
        "worst_leaf": worst["params"], "worst_m": worst["m"],
        "worst_m_table": worst["m_table"],
        "worst_leaf_from_zero": worst["params_from_zero"],
        "flash_launches": wrapper.launches,
        "flash_by_design": wrapper.launches_by_design,
        "flash_bwd_launches": wrapper.bwd_launches,
        "flash_bwd_by_design": wrapper.bwd_launches_by_design,
        "flash_heads": sorted(set(seen)), "flash_calls": len(seen),
        "ssm_launches": scan.launches, "ssm_calls": len(scan_seen),
        "ssm_shapes": sorted(set(scan_seen)),
        "mlstm_launches": mlstm.launches, "mlstm_calls": len(mlstm_seen),
        "mlstm_shapes": sorted(set(mlstm_seen)), "batch_block": rows,
        "bytes": per_step, "step_ms": step_ms, "wall_s": wall_s,
        "zero_m": zero_m, "max_memory_allocated": peak,
        "init_peak": marks.pop("init_peak"), "compressed": compressed,
        "marks": dict(marks, compared=time.time())}))
    dist.destroy_process_group()


def _recording_scales() -> list:
    """Wraps `compression.quantize_int8` to keep every scale it returns,
    on the host, in call order: a compressing step's leaves of
    COMPRESS_THRESHOLD elements and up, in `tree_leaves` order."""
    from repro_torch.parallel import compression
    real, seen = compression.quantize_int8, []

    def quantize(x, top=None):
        q, scale = real(x, top)
        seen.append(float(scale))
        return q, scale
    compression.quantize_int8 = quantize
    return seen


def _last_scales(scales: list, paths: list, wholes: list) -> dict:
    """path -> the last step's scale of each leaf the step compressed (the
    leaves of COMPRESS_THRESHOLD whole elements and up, in order)."""
    done = [p for p, n in zip(paths, wholes) if n >= COMPRESS_THRESHOLD]
    return dict(zip(done, scales[len(scales) - len(done):]))


def _compressed_against(residual, scales: list, ref, ref_max: dict,
                        ref_scales: dict, rules) -> dict:
    """A rank's compressing step against the one card's: each compressed
    leaf's scale (relative); each block of the residual against the one
    card's, the share of its entries more than COMPRESS_GATES["residual"]
    of the leaf's largest residual entry (`ref_max`) apart (entries on
    another int8 level), and the largest difference as a share of that
    entry. The worst of each, with its leaf."""
    from repro_torch.parallel.sharding import _block, leaf_specs
    paths = _paths(residual)
    wholes = [t.numel() for t in _ref_leaves(ref["residual"], paths)]
    mine = _last_scales(scales, paths, wholes)
    worst = {"scale": (0.0, ""), "level_changes": (0.0, ""),
             "residual_max": (0.0, "")}
    for path in mine:
        err = abs(mine[path] - ref_scales[path]) / ref_scales[path]
        worst["scale"] = max(worst["scale"], (err, path))
    for (block, spec), path, whole in zip(
            leaf_specs(residual, rules.param_specs()), paths,
            _ref_leaves(ref["residual"], paths)):
        want = whole[_block(spec, rules.comm.coords, rules.mesh,
                            whole.shape)].cuda()
        diff = (block.float() - want.float()).abs()
        top = ref_max[path] or 1.0
        past = (diff > COMPRESS_GATES["residual"] * top).float().mean()
        worst["level_changes"] = max(worst["level_changes"],
                                     (float(past), path))
        worst["residual_max"] = max(worst["residual_max"],
                                    (float(diff.max()) / top, path))
    return {k: list(v) for k, v in worst.items()}


def _paths(tree, prefix=""):
    """The leaf paths of a tree, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _ref_leaves(ref, paths):
    for path in paths:
        node = ref
        for key in path.split("/"):
            node = node[int(key)] if isinstance(node, (tuple, list)) \
                else node[key]
        yield node


def _sharded_reference(case: int, work: Path) -> dict:
    """The one-card step (world size 1, `launch.train.train` without
    rules) from the same seeded weights and batches: its losses, gradient
    norms, step ms and launches; the experts its first forward routed each
    token to (`routes.pt`); its updated params and AdamW first moment
    moved to the host, the card freed for the ranks (`go`), then saved to
    `ref.pt` for them (`ref_done`; each leaf's largest entry in
    `ref_max.json`)."""
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    from repro_torch.parallel import compression
    from repro_torch.tree import tree_map
    sc = SHARDED_TRAIN[case]
    cfg = _sharded_config(sc)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = _init_full(cfg, SEED + 40 + case)
    ends, norms, held = [], [], {}

    def on_state(p, o, *residual):
        held.update(m=o["m"])
        if residual:
            held["residual"] = residual[0]

    def on_step(step, metrics):
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        norms.append(metrics["grad_norm"])
    real_route = moe._route
    replay = None
    if sc.routes_from_ranks:
        blocks = [torch.load(work / f"calls{d}.pt")
                  for d in range(sc.mesh[0])]
        replay = [torch.cat(calls) for calls in zip(*blocks)]
    routes = _recording_routes(moe, replay)
    real_quantize = compression.quantize_int8
    q_scales = _recording_scales() if sc.compress else []
    reset_launch_counts()
    try:
        losses = train(cfg, steps=SHARDED_STEPS, batch=sc.batch,
                       seq_len=sc.seq_len, params=params,
                       log_every=SHARDED_STEPS, on_step=on_step,
                       on_state=on_state, grad_compression=sc.compress)
    finally:
        moe._route = real_route
        compression.quantize_int8 = real_quantize
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = launch_counts()
    want = {k: n * SHARDED_STEPS for k, n in _train_launches(cfg).items()}
    if launches != want:
        raise AssertionError(f"{sc.label} on one card: launches {launches}, "
                             f"want {want}")
    if replay is not None and len(routes) != len(replay):
        raise AssertionError(f"{sc.label} on one card: {len(routes)} "
                             f"routings, the ranks' {len(replay)}")
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    moe_layers = cfg.num_groups * cfg.ffn_pattern.count("moe")
    torch.save([r.reshape(sc.batch, sc.seq_len, -1)
                for r in routes[:moe_layers]], work / "routes.pt")
    both = {"params": params, "m": held.pop("m")}
    if sc.compress:
        both["residual"] = held.pop("residual")
        paths = _paths(both["residual"])
        (work / "ref_scales.json").write_text(json.dumps(_last_scales(
            q_scales, paths, [t.numel() for t in
                              _tree_leaves(both["residual"])])))
    (work / "ref_max.json").write_text(json.dumps({
        part: {path: float(t.float().abs().max())
               for path, t in zip(_paths(tree), _tree_leaves(tree))}
        for part, tree in both.items()}))
    host = tree_map(lambda t: t.cpu(), both)
    out = {"losses": losses, "grad_norms": [float(n) for n in norms],
           "step_ms": step_ms, "params": n_params,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "flash_launches": launches["flash_attention"],
           "flash_bwd_launches": launches["flash_attention_bwd"],
           "ssm_launches": launches["ssm_scan"],
           "mlstm_launches": launches["mlstm_scan"]}
    del params, both
    release_memory()
    # the card is the ranks': they train while ref.pt is written
    (work / "go").touch()
    t2 = time.perf_counter()
    torch.save(host, work / "ref.pt")
    (work / "ref_done").touch()
    log(f"[sharded] {sc.label}, the one-card step: init and "
        f"{SHARDED_STEPS} steps {t1 - t0:.1f} s, its state to the host "
        f"{t2 - t1:.1f} s, to ref.pt {time.perf_counter() - t2:.1f} s"
        + ("; it took the ranks' expert choices" if replay else ""))
    return out


def _tree_leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _routes_apart(work: Path, ranks: list) -> dict:
    """Top-k assignments of the first forward that differ between each
    rank and the one-card step, over the rank's rows: for each token and
    MoE layer, the one-card step's experts the rank did not choose.
    Every model rank routes the same whole rows."""
    ref = torch.load(work / "routes.pt")
    if not ref:
        return {}
    out = {}
    for r in ranks:
        got = torch.load(work / f"routes{r['rank']}.pt")
        n = sum(g.numel() for g in got)
        differ = 0
        for g, w in zip(got, ref):
            rows = w[r["batch_block"] * g.shape[0]:
                     (r["batch_block"] + 1) * g.shape[0]]
            hit = (g[..., :, None] == rows[..., None, :]).any(-2)
            differ += int((~hit).sum())
        out[r["rank"]] = {"differ": differ, "of": n}
    return out


def _embed_grad_rounding(cfg, ranks: int, batch: int, seq_len: int) -> dict:
    """The embedding table's gradient at the case's first batch as the
    lookup's backward (`table[tokens]`) sums it in bf16 on the card, from
    seeded bf16 upstream gradients: the whole batch at once (the one-card
    step) and each of `ranks` data ranks' rows apart, summed; each against
    the float64 sum, and the two against each other, as shares of the
    float64 sum's largest entry."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    v, d = cfg.vocab_size, cfg.d_model
    tokens = torch.from_numpy(batch_for_step(DataConfig(
        vocab_size=v, seq_len=seq_len, global_batch=batch), 0)["tokens"]
    ).long().cuda()
    dy = torch.randn(batch, seq_len, d, device="cuda", generator=torch.
                     Generator(device="cuda").manual_seed(SEED + 45)
                     ).to(torch.bfloat16)

    def grad(t, g):
        table = torch.zeros(v, d, dtype=torch.bfloat16, device="cuda",
                            requires_grad=True)
        table[t].backward(g)
        return table.grad.double()
    truth = torch.zeros(v, d, dtype=torch.float64, device="cuda")
    truth.index_add_(0, tokens.flatten(), dy.reshape(-1, d).double())
    whole = grad(tokens, dy)
    parts = sum(grad(t, g) for t, g in zip(tokens.chunk(ranks),
                                            dy.chunk(ranks)))
    top = float(truth.abs().max())
    out = {"top_token_hits": int(torch.bincount(tokens.flatten()).max()),
           "whole": float((whole - truth).abs().max()) / top,
           "ranks": float((parts - truth).abs().max()) / top,
           "whole_vs_ranks": float((whole - parts).abs().max()) / top}
    del truth, whole, parts
    release_memory()
    return out


def _start_ranks(case: int, mesh_shape: tuple, backend: str,
                 work: Path) -> list:
    """Starts the case's ranks (spawn), each on card `rank % count`; once
    `work/start` exists they join their group and train once `work/go`
    exists, or at once where the case's one-card step runs after them
    (`routes_from_ranks`)."""
    import torch.multiprocessing as tmp
    for pattern in ("rank*.json", "routes*.pt", "trained*"):
        for f in work.glob(pattern):
            f.unlink()
    (work / "rdv").unlink(missing_ok=True)
    ctx = tmp.get_context("spawn")
    world = math.prod(mesh_shape)
    procs = [ctx.Process(target=_sharded_rank, args=(
        r, world, backend, case, mesh_shape, str(work)))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _wait_trained(case: int, procs: list, work: Path) -> None:
    """Until every rank has trained and freed the card (`trained<r>`); a
    rank that fails, or the timeout, fails the phase."""
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    while not all((work / f"trained{r}").exists()
                  for r in range(len(procs))):
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode is not None]
        if bad or time.monotonic() > deadline:
            raise AssertionError(f"phase 10 {SHARDED_TRAIN[case].label}: "
                                 f"ranks (rank, exit code) {bad} before "
                                 "all had trained")
        time.sleep(0.1)


def _stop(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


def _join_ranks(case: int, procs: list, backend: str, work: Path) -> list:
    """The ranks' results. A rank that fails, or outlasts the timeout,
    fails the phase, and the others are stopped at once; every rank has
    ended before this returns."""
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while time.monotonic() < deadline and any(p.is_alive()
                                                  for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        _stop(procs)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"phase 10 {SHARDED_TRAIN[case].label} over "
                             f"{backend}: ranks (rank, exit code) {bad}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(len(procs))]


def _check_sharded(case: int, ref: dict, ranks: list, mesh_shape: tuple,
                   backend: str, work: Path) -> dict:
    """Each rank against the one-card step at the gates of the config's
    dtype (SHARDED_GATES): the losses, each step's gradient norm, its
    blocks of every updated leaf and of AdamW's first moment (the
    embedding table's apart) to a share of the leaf's largest entry;
    flash on its local heads (with the layer's window) and ssm_scan on
    its channels as many times as the remat implies; its bytes a step by
    kind equal to the dry run's at the same mesh and shape. Logs what
    every rank showed, the top-k assignments that differ from the one-card
    step's among them, then raises with every check that failed."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    sc = SHARDED_TRAIN[case]
    cfg = _sharded_config(sc)
    gates = COMPRESS_GATES if sc.compress \
        else SHARDED_GATES[getattr(torch, cfg.param_dtype)]
    mesh = Mesh(mesh_shape, ("data", "model"))
    world = mesh.size
    shape = ShapeConfig("10", "train", sc.seq_len, sc.batch)
    plan = dryrun.trace_cell(cfg, shape, mesh)["collective_by_kind"]
    if sc.compress:
        plan["all-reduce"] = plan.get("all-reduce", 0.0) + _scale_bytes(
            cfg, shape, mesh)
    launches = {k: n * SHARDED_STEPS for k, n in _train_launches(cfg).items()}
    calls, scans = launches["flash_attention"], launches["ssm_scan"]
    bwds = launches["flash_attention_bwd"]
    mlstms = launches["mlstm_scan"]
    windows = sorted({cfg.window_size if k == "swa" else 0
                      for k in cfg.pattern if k in ("attn", "swa", "mla")})

    def want_heads(r):       # (q heads, k heads, window) of rank r's calls
        heads = _rank_heads(cfg, mesh.shape["model"],
                            r["rank"] % mesh.shape["model"])
        return [[*heads, w] for w in windows]
    channels = (cfg.mamba.expand * cfg.d_model // mesh.shape["model"]
                if cfg.mamba else 0)
    # mlstm_scan on the rank's rows and heads: (B, H, S, hd)
    mlstm_shape = ([[sc.batch // mesh.shape["data"],
                     cfg.num_heads // mesh.shape["model"], sc.seq_len,
                     int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
                     // cfg.num_heads]] if mlstms else [])
    cards = sorted({r["card"] for r in ranks})
    failed = []
    routes = _routes_apart(work, ranks)

    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))
    for r in ranks:
        what = f"phase 10 {sc.label} over {backend}, rank {r['rank']}"
        r["loss_rel"] = rel(r["losses"], ref["losses"])
        r["norm_rel"] = rel(r["grad_norms"], ref["grad_norms"])
        if r["loss_rel"] > gates["loss"]:
            failed.append(f"{what}: losses {r['losses']}, one card "
                          f"{ref['losses']}")
        if r["norm_rel"] > gates["norm"]:
            failed.append(f"{what}: gradient norms {r['grad_norms']}, one "
                          f"card {ref['grad_norms']}")
        for key, tol in (("worst_leaf", gates["leaf"]),
                         ("worst_m", gates["m"]),
                         ("worst_m_table", gates["m_table"])):
            if r[key][0] > tol:
                failed.append(f"{what}: {key} {r[key][1]} off by "
                              f"{r[key][0]} of its largest entry (> {tol})")
        if r["flash_launches"] != calls or r["flash_calls"] != calls or \
                r["flash_heads"] != want_heads(r):
            failed.append(f"{what}: flash launched {r['flash_launches']} "
                          f"times on (q, k heads, window) "
                          f"{r['flash_heads']}, want {calls} on "
                          f"{want_heads(r)}")
        if r["flash_bwd_launches"] != bwds:
            failed.append(f"{what}: flash's backward launched "
                          f"{r['flash_bwd_launches']} times, want {bwds}")
        for key, tol in ((("scale", gates["scale"]),
                          ("level_changes", LEVEL_CHANGES_MAX))
                         if sc.compress else ()):
            err, path = r["compressed"][key]
            if err > tol:
                failed.append(f"{what}: compression {key} {path} "
                              f"{err} (> {tol})")
        if r["ssm_launches"] != scans or r["ssm_calls"] != scans or (
                scans and {s[-1] for s in r["ssm_shapes"]} != {channels}):
            failed.append(f"{what}: ssm_scan launched {r['ssm_launches']} "
                          f"times on {r['ssm_shapes']}, want {scans} on "
                          f"{channels} channels")
        if r["mlstm_launches"] != mlstms or r["mlstm_calls"] != mlstms or \
                r["mlstm_shapes"] != mlstm_shape:
            failed.append(f"{what}: mlstm_scan launched "
                          f"{r['mlstm_launches']} times on (B, H, S, hd) "
                          f"{r['mlstm_shapes']}, want {mlstms} on "
                          f"{mlstm_shape}")
        for step in r["bytes"]:
            if step.keys() != plan.keys() or any(
                    not math.isclose(step[k], v, rel_tol=1e-9)
                    for k, v in plan.items()):
                failed.append(f"{what}: bytes a step {step}, the dry run's "
                              f"{plan}")
    log(f"[sharded] {sc.label}: gradient norms a step, rank 0 "
        f"{ranks[0]['grad_norms']}, one card {ref['grad_norms']}; worst "
        f"over ranks: loss {max(r['loss_rel'] for r in ranks)}, norm "
        f"{max(r['norm_rel'] for r in ranks)} of the one card's; AdamW m "
        f"{max(r['worst_m'] for r in ranks)}, the embedding table's "
        f"{max(r['worst_m_table'] for r in ranks)} of its largest entry "
        f"(gates {gates})")
    zero = max(r["worst_leaf_from_zero"] for r in ranks)
    if zero[1]:
        log(f"[sharded] {sc.label}: bf16 leaf blocks that start at 0, "
            f"held through m: worst {zero}; each rank's, where the one-card "
            f"m is at least {ZERO_M_SHARES} of the leaf's largest, then "
            f"their m: {[r['zero_m'] for r in ranks]}")
    if routes:
        log(f"[sharded] {sc.label}: top-k assignments of the first forward "
            f"that differ from the one-card step's, each rank over its rows "
            f"(experts the one card chose and the rank did not): {routes}")
        if sc.routes_from_ranks and any(v["differ"] > ROUTES_APART_MAX
                                    * v["of"] for v in routes.values()):
            failed.append(f"phase 10 {sc.label}: top-k assignments apart "
                          f"{routes} past {ROUTES_APART_MAX} of them")
    log(f"[sharded] {sc.label}: {backend}, {world} ranks on {len(cards)} of "
        f"{torch.cuda.device_count()} card(s) ({world // len(cards)} a "
        f"card), mesh {mesh.shape}, global batch {sc.batch} x {sc.seq_len}, "
        f"{SHARDED_STEPS} steps: losses {ranks[0]['losses']}, one card "
        f"{ref['losses']}; worst leaf {max(r['worst_leaf'] for r in ranks)} "
        f"of its largest entry; flash {calls} launches a rank on (q, k "
        f"heads, window) {want_heads(ranks[0])} ({ref['flash_launches']} "
        f"on one card), its backward {bwds} ({ref['flash_bwd_launches']} "
        f"on one card); ssm_scan {scans} a rank on {channels} channels "
        f"({ref['ssm_launches']} on one card); mlstm_scan {mlstms} a rank "
        f"on (B, H, S, hd) {mlstm_shape} ({ref['mlstm_launches']} on one "
        f"card)")
    if sc.compress:
        log(f"[sharded] {sc.label}: the compressing step against the one "
            f"card's, worst over ranks (share, leaf): scale "
            f"{max(r['compressed']['scale'] for r in ranks)}; residual "
            f"entries more than {gates['residual']} of the leaf's largest "
            f"apart (on another int8 level) "
            f"{max(r['compressed']['level_changes'] for r in ranks)} of a "
            f"block (gate {LEVEL_CHANGES_MAX}); the residual's largest "
            f"difference {max(r['compressed']['residual_max'] for r in ranks)}"
            f" of the leaf's largest entry")
    start = (work / "start").stat().st_mtime
    for r in ranks:
        marks = {k: round(t - start, 1) for k, t in r["marks"].items()}
        log(f"[sharded]   rank {r['rank']} card {r['card']}: "
            f"max_memory_allocated {r['max_memory_allocated']} bytes, "
            f"{r['init_peak']} by the end of its init; step "
            f"ms (CUDA events between step ends) {r['step_ms']}; train() "
            f"{r['wall_s']:.1f} s; s from the case's start {marks}")
    log(f"[sharded]   bytes a step a rank by kind (ring model), each rank: "
        f"{ranks[0]['bytes'][-1]}; the dry run at this mesh and shape: "
        f"{plan}; the one-card step's ms {ref['step_ms']}, peak "
        f"{ref['max_memory_allocated']} bytes")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"backend": backend, "ranks": world, "cards": len(cards),
            "mesh": mesh.shape, "losses": ranks[0]["losses"],
            "one_card_losses": ref["losses"],
            "grad_norms": ranks[0]["grad_norms"],
            "one_card_grad_norms": ref["grad_norms"],
            "worst_norm_rel": max(r["norm_rel"] for r in ranks),
            "worst_m": max(r["worst_m"] for r in ranks),
            "worst_m_table": max(r["worst_m_table"] for r in ranks),
            "one_card_step_ms": ref["step_ms"],
            "one_card_max_memory": ref["max_memory_allocated"],
            "worst_leaf": max(r["worst_leaf"] for r in ranks),
            "flash_launches": sum(r["flash_launches"] for r in ranks),
            "flash_by_design": {d: sum(r["flash_by_design"][d] for r in ranks)
                                for d in ranks[0]["flash_by_design"]},
            "one_card_flash_launches": ref["flash_launches"],
            "flash_bwd_launches": sum(r["flash_bwd_launches"]
                                      for r in ranks),
            "flash_bwd_by_design": {
                d: sum(r["flash_bwd_by_design"][d] for r in ranks)
                for d in ranks[0]["flash_bwd_by_design"]},
            "one_card_flash_bwd_launches": ref["flash_bwd_launches"],
            "ssm_launches": sum(r["ssm_launches"] for r in ranks),
            "one_card_ssm_launches": ref["ssm_launches"],
            "mlstm_launches": sum(r["mlstm_launches"] for r in ranks),
            "one_card_mlstm_launches": ref["mlstm_launches"],
            "routes_apart": routes,
            "bytes_by_kind": ranks[0]["bytes"][-1], "dry_run_bytes": plan,
            "step_ms": {r["rank"]: r["step_ms"] for r in ranks},
            "max_memory_allocated": {r["rank"]: r["max_memory_allocated"]
                                     for r in ranks},
            "init_peak": {r["rank"]: r["init_peak"] for r in ranks},
            "compressed": {r["rank"]: r["compressed"] for r in ranks}}


def _scale_bytes(cfg, shape, mesh) -> float:
    """The ring-model bytes a step of the compressing step's scales: an
    fp32 all-reduce (max) of one element for each leaf of
    COMPRESS_THRESHOLD elements and up over the axes of size above 1 its
    spec splits it over (`compression._compress`)."""
    from repro_torch.analysis.trace import collective_transfer
    from repro_torch.bridge import param_shapes
    from repro_torch.parallel.sharding import (_flat_axes, leaf_specs,
                                               make_rules)
    total = 0.0
    specs = make_rules(mesh, cfg, shape).param_specs()
    for leaf, spec in leaf_specs(param_shapes(cfg), specs):
        n = math.prod(mesh.shape[a] for axes in spec
                      for a in _flat_axes(axes))
        if leaf.numel() >= COMPRESS_THRESHOLD and n > 1:
            total += collective_transfer("all-reduce", n, 4, 4)
    return total


def _spawn_case(case: int) -> tuple:
    """The case's work directory, made anew, and its gloo ranks, spawned:
    they import while the case before runs, and wait for `start`."""
    work = SHARDED_DIR / str(case)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    return work, _start_ranks(case, SHARDED_TRAIN[case].mesh, "gloo", work)


def sharded_phase() -> dict:
    """Phase 10: each SHARDED_TRAIN case over its mesh of gloo ranks on
    this machine's cards (phase 1 built the kernels: the ranks load them),
    held to the one-card step; where there are 2 cards or more, the first
    case also over nccl, one rank a card. A case's ranks are spawned when
    the case before starts: their start-up overlaps it."""
    out = {}
    count = torch.cuda.device_count()
    nxt = _spawn_case(0)
    try:
        for case, sc in enumerate(SHARDED_TRAIN):
            work, procs = nxt
            t0 = time.perf_counter()
            (work / "start").touch()
            nxt = (_spawn_case(case + 1) if case + 1 < len(SHARDED_TRAIN)
                   else None)
            out.update(_sharded_case(case, work, procs, count, t0))
    finally:
        if nxt is not None:
            _stop(nxt[1])
    return out


def _sharded_case(case: int, work: Path, procs: list, count: int,
                  t0: float) -> dict:
    """One case of phase 10 from its started ranks: the one-card step, the
    ranks joined and checked; the first case over nccl too where there are
    2 cards or more."""
    sc = SHARDED_TRAIN[case]
    out = {}
    try:
        if sc.routes_from_ranks:
            _wait_trained(case, procs, work)
        ref = _sharded_reference(case, work)
    except BaseException:
        _stop(procs)
        raise
    ranks = _join_ranks(case, procs, "gloo", work)
    out[sc.label] = _check_sharded(case, ref, ranks, sc.mesh, "gloo",
                                   work)
    if sc.mesh[0] > 1 and _sharded_config(sc).param_dtype == "bfloat16":
        out[sc.label]["embed_grad_rounding"] = r = _embed_grad_rounding(
            _sharded_config(sc), sc.mesh[0], sc.batch, sc.seq_len)
        log(f"[sharded] {sc.label}: the embedding table's bf16 gradient "
            f"(top token {r['top_token_hits']} times), shares of its "
            f"largest entry: the whole batch {r['whole']} and the "
            f"{sc.mesh[0]} data ranks' rows summed {r['ranks']} from "
            f"the float64 sum, {r['whole_vs_ranks']} apart")
    log(f"[time] sharded {sc.label}: {time.perf_counter() - t0:.1f} s")
    if case == 0 and count >= 2:
        nccl = ((2, 2) if count >= 4 else (1, 2))
        ranks = _join_ranks(case, _start_ranks(case, nccl, "nccl", work),
                            "nccl", work)
        out[f"{sc.label} nccl"] = _check_sharded(case, ref, ranks, nccl,
                                                 "nccl", work)
    elif case == 0:
        log(f"[sharded] nccl: {count} card on this machine; one rank a "
            "card needs 2 or more, not run")
    shutil.rmtree(work, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phase 6

# stablelm-1.6b's MLP up-projection: d_model 2048 -> d_ff 5632.
STABLELM_UP = (2048, 5632)
# int8_matmul as a kernel task, the reference's gate (compute_bench.py:130).
KERNEL_TASK_TOL = 1e-3



# fp32 int8_matmul: the kernel's max error against the float64 product is at
# most this many times the plain version's, plus TOL's fp32 2e-5
INT8_F64_FACTOR = 2


def int8_tol(dtype, k: int) -> float:
    """tests/test_kernels.py's TOL: bf16 2e-2; fp32 2e-5, set there for K
    up to 256. The rounding of an fp32 sum grows with its length (its worst
    case as K times the unit roundoff), and two fp32 sums of the same 2,048
    products in other orders differ by more than 2e-5 near zero: at larger K
    the fp32 tolerance is 2e-5 * K / 256. The kernel's own error against
    the float64 product is gated beside it (INT8_F64_FACTOR)."""
    if dtype == torch.float32:
        return 2e-5 * max(1.0, k / 256)
    return TOL[dtype]


def _int8_case(gen, m, k, n, dtype, row_stride=None):
    """x (m,k) in `dtype`, optionally a column slice of a wider tensor, and
    w (k,n) randn quantized by the port's `quantize_weights`, on the card."""
    from repro_torch.kernels.int8_matmul import quantize_weights
    width = row_stride or k
    x = torch.randn(m, width, generator=gen, device="cuda").to(dtype)[:, :k]
    wq, scales = quantize_weights(torch.randn(k, n, generator=gen,
                                              device="cuda"))
    return x, wq, scales


def _int8_work(x, wq) -> tuple:
    """flop (2 M K N) and bytes (x, wq, scales read once, out written once)
    of one call: `int8_matmul.ops.cost`."""
    from repro_torch.kernels.int8_matmul.ops import cost
    return cost(x, wq)[:2]


def queued_ms(fn, calls: int = 20) -> float:
    """Device time of one call of `fn` without its host cost: the card
    first sleeps (`torch.cuda._sleep`) while the host queues `calls` calls,
    then runs them back to back between two events. Raises if the host
    took longer to queue them than the card slept."""
    fn()
    torch.cuda.synchronize()
    sleep_s = 0.05
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * _sm_clock_mhz() * 1e6))
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    end.synchronize()
    if queued_s >= sleep_s:
        raise AssertionError(f"queueing {calls} calls took {queued_s} s, "
                             f"longer than the card's {sleep_s} s sleep")
    return start.elapsed_time(end) / calls


def _int8_times(x, wq, scales) -> dict:
    """Kernel, plain and dequantize + cuBLAS ms of one call, its bound, the
    achieved rate (GB/s at M <= 16, TFLOP/s above) and the kernel/library
    ratio. At M <= 16 the call is host-bound, so its device time alone
    (`queued_ms`) and that time's GB/s are given beside."""
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref
    from repro_torch.kernels.int8_matmul.ops import GEMV_MAX_M, _plan
    m, k = x.shape
    n = wq.shape[1]
    reps = 20 if m * k * n < 1e10 else 10
    kernel_ms = cuda_ms(lambda: int8_matmul(x, wq, scales), reps)
    plain_ms = cuda_ms(lambda: int8_matmul_ref(x, wq, scales), reps)
    library_ms = cuda_ms(lambda: torch.matmul(x, wq.to(x.dtype)) * scales,
                         reps)
    flops, nbytes = _int8_work(x, wq)
    t_ops, t_bytes = flops / PEAK_FLOPS[x.dtype], nbytes / PEAK_BYTES_PER_S
    times = {
        "shape": f"{str(x.dtype)[6:]} M={m} K={k} N={n}",
        "path": _plan(m, n, k, x.dtype).path,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # a yardstick of three calls, not one: wq.to(x.dtype), torch.matmul
        # (cuBLAS) and the scale
        "library_ms": library_ms,
        "library": "wq.to(x.dtype), torch.matmul, * scales (3 calls)",
        "flops": flops,
        "bytes": nbytes,
        "kernel_over_library": kernel_ms / library_ms,
    }
    if m <= GEMV_MAX_M:
        device_ms = queued_ms(lambda: int8_matmul(x, wq, scales))
        times.update(gbps=nbytes / kernel_ms / 1e6, device_ms=device_ms,
                     device_gbps=nbytes / device_ms / 1e6)
        rate = (f"{times['gbps']:.1f} GB/s a call; on the card alone "
                f"{device_ms:.4f} ms = {times['device_gbps']:.1f} GB/s")
    else:
        times["tflops"] = flops / kernel_ms / 1e9
        rate = f"{times['tflops']:.1f} TFLOP/s"
    log(f"[compute] int8_matmul ({times['path']}) at {times['shape']}: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, dequantize + "
        f"torch.matmul {library_ms:.4f} ms (3 calls), kernel / library "
        f"{times['kernel_over_library']:.3f}, bound {times['bound_ms']:.4f} "
        f"ms ({times['bound_by']}: {flops} flop, {nbytes} bytes); {rate}")
    return times


def check_int8_matmul(gen) -> dict:
    """int8_matmul against its plain version at every listed shape; times at
    stablelm's up-projection. Returns the entry of the kernels line."""
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref
    from repro_torch.kernels.int8_matmul.ops import GEMV, MMA, TILES, _plan
    f32, bf16 = torch.float32, torch.bfloat16
    k_up, n_up = STABLELM_UP
    cases = [  # (label, M, K, N, dtypes, row stride of x, timed)
        ("compute_bench", 8, 128, 128, (f32,), None, False),
        ("test_kernels", 64, 256, 128, (f32, bf16), None, False),
        ("test_kernels", 128, 128, 256, (f32, bf16), None, False),
        ("stablelm up-proj decode", 4, k_up, n_up, (bf16, f32), None, True),
        ("stablelm up-proj prefill", 4096, k_up, n_up, (bf16,), None, True),
        *[(f"stablelm up-proj M={m}", m, k_up, n_up, (bf16, f32), None,
           False) for m in (1, 16, 17, 64)],
        # K = 2004: the GEMV's last split is short; x's rows are not
        # 16-byte aligned, so the tensor-core path stages x element-wise
        *[("K not a multiple of the split", m, 2004, n_up, (bf16, f32), None,
           False) for m in (4, 64)],
        ("ragged, x a column slice", 77, 200, 333, (f32, bf16), 256, False),
    ]
    timed_at = []
    for label, m, k, n, dtypes, stride, timed in cases:
        for dt in dtypes:
            x, wq, scales = _int8_case(gen, m, k, n, dt, stride)
            path = _plan(m, n, k, dt).path
            out = int8_matmul(x, wq, scales)
            ref = int8_matmul_ref(x, wq, scales)
            exact = (x.double() @ wq.double()) * scales.double()
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"int8_matmul {label}: {out.shape}/"
                                     f"{out.dtype} vs {ref.shape}/{ref.dtype}")
            tol = int8_tol(dt, k)
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            bad = diff > tol + tol * ref.float().abs()
            if not torch.isfinite(out).all() or bool(bad.any()):
                raise AssertionError(f"int8_matmul {label} {dt} M={m} K={k} "
                                     f"N={n}: max abs err {err} beyond tol "
                                     f"{tol} at {int(bad.sum())} entries")
            k_err = float((out.double() - exact).abs().max())
            p_err = float((ref.double() - exact).abs().max())
            # the scaled fp32 limit above allows for the plain version's own
            # rounding; this holds the kernel to fp32 accuracy itself
            if dt == f32 and k_err > INT8_F64_FACTOR * p_err + TOL[f32]:
                raise AssertionError(
                    f"int8_matmul {label} fp32 M={m} K={k} N={n}: kernel "
                    f"{k_err} from the float64 product, more than "
                    f"{INT8_F64_FACTOR} x the plain version's {p_err} + "
                    f"{TOL[f32]}")
            log(f"[compute] int8_matmul {label} {str(dt)[6:]} ({path}) "
                f"M={m} K={k} N={n}: max_abs_err={err} (tol {tol}); against "
                f"the float64 product: kernel {k_err}, plain {p_err} ok")
            if timed:
                timed_at.append(dict(_int8_times(x, wq, scales),
                                     max_abs_err=err))
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul/kernel.py:18",
        "paths": {"M<=16": GEMV, "bfloat16 M>16": MMA, "float32 M>16": TILES},
        "launches": None,
        "at_stablelm_up_proj": timed_at,
    }


def _kernel_task_smoke(entry: dict) -> None:
    """compute_bench.py's pallas smoke: int8_matmul at 8 x 128 x 128 fp32 as
    a `kernel_task` on the gpu node, against its plain version. The launch
    count of this run is the kernel's on its main path."""
    from repro_torch import core
    from repro_torch.compute import kernel_task
    from repro_torch.core import profiler
    from repro_torch.core.api import _cluster
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref
    from repro_torch.kernels.int8_matmul.ops import _plan

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x, wq, scales = _int8_case(gen, 8, 128, 128, torch.float32)
    kt = kernel_task(lambda xx: int8_matmul(xx, wq, scales),
                     resources={"gpu": 1.0})
    reset_launch_counts()
    t0 = time.perf_counter()
    out = core.get(kt.submit(x), timeout=120)
    ms = (time.perf_counter() - t0) * 1e3
    launches = int8_matmul.launches
    ref = int8_matmul_ref(x, wq, scales)
    err = float((out.float() - ref.float()).abs().max())
    stats = profiler.summarize(_cluster().gcs)
    if not (out.is_cuda and out.shape == (8, 128) and err < KERNEL_TASK_TOL):
        raise AssertionError(f"kernel task: {out.device} {tuple(out.shape)}, "
                             f"max abs err {err}")
    if launches != 1 or stats["kernel_tasks"] != 1:
        raise AssertionError(f"kernel task: {launches} launches, "
                             f"{stats['kernel_tasks']} kernel tasks, want 1")
    log(f"[compute] int8_matmul as a kernel_task on the gpu node, fp32 M=8 "
        f"K=128 N=128 ({_plan(8, 128, 128, torch.float32).path}): {ms:.3f} "
        f"ms round trip, max_abs_err {err} (gate "
        f"{KERNEL_TASK_TOL}), launches {launches}, profiler kernel_tasks "
        f"{stats['kernel_tasks']}, kernel_time_ms_mean "
        f"{stats['kernel_time_ms_mean']:.3f}")
    entry.update(_int8_times(x, wq, scales), launches=launches,
                 max_abs_err=err,
                 launches_by_path={"kernel_task (compute_bench smoke)":
                                   launches})


def _host_percentiles(fn, n: int, warmup: int = 3) -> dict:
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return {"p50_us": statistics.median(ts),
            "p90_us": ts[min(n - 1, int(0.9 * n))]}


# The reference's limit on a kernel task's round trip: at most this many
# times the bare call, p50 against p50 (benchmarks/compute_bench.py:51,
# gate at :217-234). The port does not meet it on the H100 (ROADMAP D1):
# phase 6 prints the ratio against it and does not gate on it.
OVERHEAD_MULT = 6.0
# What the reference's round trip added over its bare call, in us: p50
# 1,909.6 against 1,422.9 (BENCH_compute.json "pr9"). Printed beside the
# port's, not a gate.
REFERENCE_ADDED_US = 1909.6015003015054 - 1422.9065000108676
# The hops of one kernel-task round trip, from the driver's clock and the
# control plane's event log ("submit", "start", "kernel" with its ms,
# "finish"), all on one perf_counter clock.
ROUND_TRIP_HOPS = (
    "submit: ids, pins, registration",      # driver: submit() -> "submit"
    "submit: placement, lane handoff",      # "submit" -> submit() returns
    "lane wake, driver parks in get",       # submit() returns -> "start"
    "lane: state, args",                    # "start" -> the function starts
    "function + wait for the card",         # the "kernel" event's ms
    "lane: store, done, notify",            # the "kernel" event -> "finish"
    "driver wakes, get returns",            # "finish" -> get() returns
)


def _round_trip_hops(kt, x_ref, n: int) -> dict:
    """`n` kernel-task round trips of `kt` on `x_ref`, each stamped by the
    driver around `submit` and `get`; with the event log's stamps of each
    task, the p50 of every hop of ROUND_TRIP_HOPS and of the whole trip,
    in us."""
    from repro_torch import core
    from repro_torch.core.api import _cluster
    gcs = _cluster().gcs
    for _ in range(3):
        core.get(kt.submit(x_ref), timeout=60)
    stamps = []
    for _ in range(n):
        t0 = time.perf_counter()
        ref = kt.submit(x_ref)
        t1 = time.perf_counter()
        core.get(ref, timeout=60)
        t2 = time.perf_counter()
        stamps.append((ref.id.rsplit(".", 1)[0], t0, t1, t2))
    wanted = {tid for tid, *_ in stamps}
    ev: dict = {}
    for ts, kind, tid, _, extra in gcs.events():
        if tid in wanted:
            ev.setdefault(tid, {})[kind] = (ts, extra)
    hops = {name: [] for name in (*ROUND_TRIP_HOPS, "round trip")}
    for tid, t0, t1, t2 in stamps:
        e = ev[tid]
        k_ts, k_extra = e["kernel"]
        f0 = k_ts - k_extra["ms"] / 1e3
        marks = (t0, e["submit"][0], t1, e["start"][0], f0, k_ts,
                 e["finish"][0], t2)
        for name, a, b in zip(ROUND_TRIP_HOPS, marks, marks[1:]):
            hops[name].append((b - a) * 1e6)
        hops["round trip"].append((t2 - t0) * 1e6)
    return {name: statistics.median(v) for name, v in hops.items()}


def _spin(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def _after_wait_p50(fn, n: int, wait) -> float:
    """p50 host time of `fn` (us) right after the calling thread ran
    `wait()`: a sleep, as a lane thread has slept when a task wakes it and
    a driver when a result wakes it, or a spin as long, which keeps the
    thread on its core."""
    ts = []
    for _ in range(n + 3):
        wait()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(ts[3:])


def _handoff_p50(n: int, spin: bool) -> float:
    """p50 (us) of a token passed to a second thread and back, each side
    waiting on a threading.Event (`spin` False: parked in the kernel, as
    the lane and `get` wait) or polling it with `os.sched_yield` between
    reads (`spin` True: never parked). The driver sleeps 100 us between
    passes, as it does between round trips."""
    import os
    import threading
    there, back = threading.Event(), threading.Event()

    def wait(ev):
        if spin:
            while not ev.is_set():
                os.sched_yield()
        else:
            ev.wait()
        ev.clear()

    def other():
        for _ in range(n):
            wait(there)
            back.set()

    t = threading.Thread(target=other)
    t.start()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        there.set()
        wait(back)
        ts.append((time.perf_counter() - t0) * 1e6)
        time.sleep(1e-4)
    t.join()
    return statistics.median(ts)


def _dispatch_round_trip() -> dict:
    """compute_bench.py's dispatch section: the same tanh(x @ x.T) at dim
    384, a bare call against a kernel-task round trip (host clock, each
    waited for on the card), 200 calls each, p50 against p50, and the
    ratio against OVERHEAD_MULT. Then the round trip hop by hop
    (`_round_trip_hops`), the bare call made right after the calling
    thread slept and right after it spun as long (what the lane's call
    pays for its wake), and a thread handoff parked and spinning (what
    each of the trip's two wakes, the lane's and the driver's, costs)."""
    from repro_torch import core
    from repro_torch.compute import kernel_task

    def mm(x):
        return torch.tanh(x @ x.T)

    def bare():
        mm(x)
        torch.cuda.synchronize()

    x = torch.randn(384, 384, generator=torch.Generator(device="cuda")
                    .manual_seed(SEED), device="cuda")
    n = 200
    raw = _host_percentiles(bare, n)
    kt = kernel_task(mm, resources={"gpu": 1.0}, warmup_args=(x,))
    x_ref = core.put(x)
    e2e = _host_percentiles(lambda: core.get(kt.submit(x_ref), timeout=60), n)
    ratio = e2e["p50_us"] / raw["p50_us"]
    log(f"[compute] tanh(x @ x.T) dim 384 fp32, {n} calls each: bare call "
        f"p50 {raw['p50_us']:.1f} us p90 {raw['p90_us']:.1f} us; kernel_task "
        f"round trip p50 {e2e['p50_us']:.1f} us p90 {e2e['p90_us']:.1f} us; "
        f"ratio of p50s {ratio:.2f} (compute_bench.py's OVERHEAD_MULT "
        f"{OVERHEAD_MULT}: {'met' if ratio <= OVERHEAD_MULT else 'not met'})")
    added_us = e2e["p50_us"] - raw["p50_us"]
    log(f"[compute] the round trip adds {added_us:.1f} us over the bare call "
        f"(p50 minus p50; the reference's record adds "
        f"{REFERENCE_ADDED_US:.1f} us over a bare call of 1,422.9 us, "
        f"BENCH_compute.json pr9; printed, not gated)")
    hops = _round_trip_hops(kt, x_ref, n)
    log(f"[compute] kernel_task round trip hop by hop, p50 of {n} (us): "
        + "; ".join(f"{name} {us:.1f}" for name, us in hops.items()))
    slept = _after_wait_p50(bare, n, lambda: time.sleep(4e-4))
    spun = _after_wait_p50(bare, n, lambda: _spin(4e-4))
    parked, polled = _handoff_p50(n, spin=False), _handoff_p50(n, spin=True)
    log(f"[compute] the bare call right after its thread slept 400 us: p50 "
        f"{slept:.1f} us ({slept / raw['p50_us']:.2f}x the bare call); "
        f"right after it spun 400 us: p50 {spun:.1f} us "
        f"({spun / raw['p50_us']:.2f}x); a token to a second thread and "
        f"back, p50 of {n}: {parked:.1f} us parked on threading.Event, "
        f"{polled:.1f} us spinning on os.sched_yield")
    return {"bare_p50_us": raw["p50_us"], "round_trip_p50_us": e2e["p50_us"],
            "ratio": ratio, "added_us": added_us, "hops_p50_us": hops, "bare_after_sleep_p50_us":
            slept, "bare_after_spin_p50_us": spun,
            "handoff_parked_p50_us": parked, "handoff_spin_p50_us": polled}


def _paramset_round_trip() -> None:
    """`ParamSet.publish`/`fetch` of xlstm-125m's parameters from the card:
    bytes, ms, MB/s; fetched leaves are zero-copy views of their shard and
    equal the card's weights bit for bit."""
    from repro_torch.bridge import init_params
    from repro_torch.compute import ParamSet
    from repro_torch.compute.params import _flatten
    from repro_torch.configs.registry import get_config

    cfg = get_config("xlstm-125m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps = ParamSet.publish("xlstm", params, num_shards=2)
    publish_s = time.perf_counter() - t0
    fresh = ParamSet.latest("xlstm")       # cold handle: no cached buffers
    t0 = time.perf_counter()
    fetched = fresh.fetch()
    fetch_s = time.perf_counter() - t0
    got, want = dict(_flatten(fetched)), dict(_flatten(params))
    if sorted(got) != sorted(want):
        raise AssertionError("ParamSet fetch: leaf paths differ")
    exact = all(got[p].dtype == want[p].dtype
                and got[p].shape == want[p].shape
                and np.array_equal(got[p].view(np.uint8),
                                   want[p].view(np.uint8)) for p in want)
    zero_copy = all(
        np.shares_memory(got[path], fresh._shard(s, timeout=10))
        and not got[path].flags.writeable
        for path, _, _, s, *_ in fresh.layout)
    ParamSet.drop("xlstm")
    if not (exact and zero_copy):
        raise AssertionError(f"ParamSet round trip exact {exact}, zero_copy "
                             f"{zero_copy}")
    mb = ps.total_bytes / 1e6
    log(f"[compute] ParamSet xlstm-125m ({len(got)} leaves, "
        f"{ps.total_bytes} bytes, {len(ps.shard_ids)} shards): publish from "
        f"the card {publish_s * 1e3:.3f} ms ({mb / publish_s:.1f} MB/s), "
        f"fetch {fetch_s * 1e3:.3f} ms ({mb / fetch_s:.1f} MB/s); zero_copy "
        f"{zero_copy}, round trip bit-exact {exact}")


def compute_plane(gen) -> tuple:
    """Phase 6 on a cluster of one gpu-typed and one cpu node; returns the
    int8_matmul entry of the kernels line and the kernel-task round trip's
    p50 in us (phase 8d's device step)."""
    from repro_torch import core
    entry = check_int8_matmul(gen)
    core.init(node_resources=[{"cpu": 4.0, "gpu": 1.0}, {"cpu": 4.0}])
    try:
        _kernel_task_smoke(entry)
        trip = _dispatch_round_trip()
        _paramset_round_trip()
    finally:
        core.shutdown()
    return entry, trip["round_trip_p50_us"]


# ------------------------------------------------------------------ phase 7

def train_graph() -> int:
    """xlstm-125m cut to TRAIN_XLSTM_LAYERS through `train_lm`'s task-graph
    mode, held against the `--sync` loop; returns mlstm_scan's launches in
    the timed steps."""
    from repro_torch.bridge import init_params
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.train.lm import train_lm

    cfg = get_config("xlstm-125m").scaled(num_layers=TRAIN_XLSTM_LAYERS)
    batch, shards, seq_len, steps, every = 8, 2, 128, 3, 2
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 4))
    warm = train_lm(cfg, 1, batch, seq_len, shards, params=params,
                    publish_every=every)
    log(f"[train graph] warm-up step: {warm.step_ms[0]:.1f} ms, loss "
        f"{warm.losses[0]}")
    reset_launch_counts()
    res = train_lm(cfg, steps, batch, seq_len, shards, params=warm.params,
                   publish_every=every)
    launches = mlstm_scan.launches
    stats = res.stats

    # the --sync loop from the same weights over the same 1 + 3 steps
    # (the task graph left `params` as they were)
    sync_warm = train_lm(cfg, 1, batch, seq_len, shards, params=params,
                         sync=True)
    sync = train_lm(cfg, steps, batch, seq_len, shards, params=params,
                    sync=True)
    graph_losses = warm.losses + res.losses
    sync_losses = sync_warm.losses + sync.losses

    want = cfg.pattern.count(MLSTM) * cfg.num_groups * shards * steps \
        * remat_runs(cfg)
    if launches != want:
        raise AssertionError(f"mlstm_scan launched {launches} times, want "
                             f"{want} (mLSTM layers x shards x steps x "
                             f"forwards a step under remat)")
    if stats["kernel_tasks"] != shards * steps:
        raise AssertionError(f"{stats['kernel_tasks']} kernel tasks, want "
                             f"{shards * steps}")
    if stats["param_publishes"] != steps // every:
        raise AssertionError(f"{stats['param_publishes']} ParamSet "
                             f"publishes, want {steps // every}")
    if not all(math.isfinite(x) for x in graph_losses):
        raise AssertionError(f"non-finite loss: {graph_losses}")
    if not graph_losses[-1] < graph_losses[0]:
        raise AssertionError(f"loss did not fall: {graph_losses}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(graph_losses, sync_losses))
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"task graph losses {graph_losses} vs --sync "
                             f"{sync_losses}: rel err {rel} > {LOSS_RTOL}")
    step_ms = statistics.median(res.step_ms)
    sync_ms = statistics.median(sync.step_ms)
    log(f"[train graph] {steps} steps, global batch {batch} x {seq_len} "
        f"tokens in {shards} kernel-task shards: losses {res.losses}")
    log(f"[train graph] losses of the 1 + {steps} steps vs --sync: max rel "
        f"err {rel} (tol {LOSS_RTOL}); --sync {sync_losses}")
    log(f"[train graph] mlstm_scan launches {launches} = "
        f"{want // (shards * steps * remat_runs(cfg))} mLSTM layers x "
        f"{shards} shards x {steps} steps x {remat_runs(cfg)} forwards; "
        f"profiler: kernel_tasks {stats['kernel_tasks']}, "
        f"kernel_time_ms_mean {stats['kernel_time_ms_mean']:.3f}, "
        f"device_waits {stats['device_waits']}, param_publishes "
        f"{stats['param_publishes']}, graph_invocations "
        f"{stats.get('graph_invocations')}")
    log(f"[train graph] step ms (host clock): task graph median "
        f"{step_ms:.3f}, all {[round(x, 3) for x in res.step_ms]}; --sync "
        f"median {sync_ms:.3f}, all {[round(x, 3) for x in sync.step_ms]}; "
        f"ratio {step_ms / sync_ms:.3f}; "
        f"{batch * seq_len / (step_ms / 1e3):.1f} tokens/s")
    return launches

# ------------------------------------------------------------------ phase 8

def runtime_examples() -> None:
    """Phase 8: the port's quickstart to its end (futures, wait, a
    compiled graph, a value lost with its node replayed by lineage)."""
    from repro_torch.examples import quickstart
    rc = quickstart.main()
    if rc != 0:
        raise AssertionError("quickstart: the value lost with its node did "
                             "not come back by lineage replay")


# ----------------------------------------------------------------- phase 8b

# benchmarks/stream_bench.py's gates, reproduced (not imported): the online
# arm beats the frozen one by this margin after the drift and reaches at
# least RECOVERED_ACC (`:102`); the hot-swap arm's p99 within
# SWAP_P99_SLACK of the arm without swaps (`:145`); the churn plateau's late
# peak within PLATEAU_SLACK of its early peak (`:201`); the version lag
# after the learner's node is killed at most LAG_BOUND (`:242`).
RECOVERY_MARGIN, RECOVERED_ACC = 0.05, 0.75
SWAP_P99_SLACK = (1.5, 5.0)            # p99_on <= p99_off * 1.5 + 5.0 ms
PLATEAU_SLACK = (1.25, 262144)         # late <= early * 1.25 + 256 KiB
LAG_BOUND = 64
# The churn scenario's length: stream_bench.py's smoke length, cut from its
# full 60 s to keep the phase short (PERF.md section 4).
CHURN_S = 6.0
# stream_bench.py's seed in CI (`--smoke --seed 42`) and by default.
STREAM_SEED = 42
# Requests the FrontDoor may shed at the dispatch in one stream run: those
# that expired after their wave was formed, while the control thread
# stalled before dispatching it (the reference dispatches them late). One
# stall there expires at most the wave it holds, the pipeline's max_batch
# of 16; more means the control thread stalled in that window again.
SHED_AT_DISPATCH_MAX = 16


def _stream_pipeline(cfg, **kw):
    """stream_bench.py's `_pipeline`: its defaults over the pipeline's."""
    from repro_torch.streaming.pipeline import StreamingPipeline
    kw.setdefault("publish_every", 4)
    kw.setdefault("serve_per_batch", 8)
    kw.setdefault("deadline_s", 0.5)
    kw.setdefault("engine_base_s", 0.0005)
    kw.setdefault("engine_per_req_s", 0.0001)
    return StreamingPipeline(cfg, **kw)


def _window_acc(samples, lo: int, hi: int):
    win = [s for s in samples if lo <= s[0] < hi]
    if not win:
        return 0.0, 0.0, 0
    return (sum(s[1] for s in win) / len(win),
            sum(s[2] for s in win) / len(win), len(win))


def _check_stream_run(what: str, rep: dict, batches: int) -> None:
    """Every run: no hung ticket, none dispatched past its deadline, at
    most SHED_AT_DISPATCH_MAX shed at the dispatch, and the source produced
    and acked exactly the batches the run took. Logs the requests' ledger."""
    src, slo = rep["source"], rep["slo"]
    log(f"[stream] {what}: requests admitted {slo['admitted']}, ok "
        f"{slo['completed_ok']}, late {slo['completed_late']}, shed "
        f"{slo['shed']} ({slo['shed_at_dispatch']} at the dispatch, the "
        f"worst {slo['shed_at_dispatch_late_ms_max']:.3f} ms past its "
        f"deadline), failed {slo['failed']}, dispatched past the deadline "
        f"{slo['dispatched_past_deadline']}")
    if rep["unresolved"] != 0:
        raise AssertionError(f"{what}: {rep['unresolved']} hung ticket(s)")
    if slo["dispatched_past_deadline"] != 0:
        raise AssertionError(f"{what}: {slo['dispatched_past_deadline']} "
                             "request(s) dispatched past their deadline")
    if slo["shed_at_dispatch"] > SHED_AT_DISPATCH_MAX:
        raise AssertionError(f"{what}: {slo['shed_at_dispatch']} requests "
                             "expired between their wave's formation and "
                             f"its dispatch, over {SHED_AT_DISPATCH_MAX}")
    if not src["produced"] == src["acked"] == batches:
        raise AssertionError(f"{what}: source produced {src['produced']}, "
                             f"acked {src['acked']}, want {batches} each")
    if src["outstanding"] != 0:
        raise AssertionError(f"{what}: source still holds "
                             f"{src['outstanding']} batch refs")


def _drift_recovery(seed: int) -> None:
    from repro_torch import core
    from repro_torch.core.profiler import summarize
    from repro_torch.streaming.sources import DriftSpec, StreamConfig
    num = 400
    drift_at = num // 2
    cfg = StreamConfig(dim=16, batch=32, seed=seed, interval_s=0.01,
                       drifts=(DriftSpec(at_step=drift_at, kind="abrupt",
                                         target="label"),))
    cluster = core.init(num_nodes=3, workers_per_node=2)
    try:
        p = _stream_pipeline(cfg)
        t0 = time.perf_counter()
        rep = p.run(num)
        wall = time.perf_counter() - t0
        s = summarize(cluster.gcs)
        p.close()
    finally:
        core.shutdown()
    tail = drift_at + (num - drift_at) // 2
    pre, _, _ = _window_acc(p.samples, drift_at // 2, drift_at)
    on, fr, n = _window_acc(p.samples, tail, num)
    slo = rep["slo"]
    log(f"[stream] drift_recovery: {num} batches in {wall:.2f} s, drift at "
        f"{drift_at}: accuracy before {pre:.3f}; after (steps >= {tail}, "
        f"{n} served) online {on:.3f}, frozen {fr:.3f}; swaps "
        f"{slo['weight_swaps']}, drift events {s['drift_events']}, resets "
        f"{s['learner_resets']}; p50/p99 {slo['latency_p50_ms']:.2f}/"
        f"{slo['latency_p99_ms']:.2f} ms; source {rep['source']}")
    _check_stream_run("drift_recovery", rep, num)
    if not (on > fr + RECOVERY_MARGIN and on > RECOVERED_ACC):
        raise AssertionError(f"drift_recovery: online {on:.3f} did not beat "
                             f"frozen {fr:.3f} by {RECOVERY_MARGIN} and reach "
                             f"{RECOVERED_ACC}")
    if slo["weight_swaps"] <= 0:
        raise AssertionError("drift_recovery: replicas never hot-swapped")
    if s["stream_batches"] < num:
        raise AssertionError(f"drift_recovery: stream_batches "
                             f"{s['stream_batches']} < {num}")


# A replica's wave interval (the end of its last wave to the end of this
# one) at least this long is a stall; the runs' intervals are 2-6 ms.
STALL_MS = 20.0
# the latency timeline's bins
TIMELINE_BIN_S = 0.1


class _StreamTimeline:
    """What a stream run's replicas did against wall time, for the log:
    each wave's start, end and its requests' latencies (`OnlineServingEngine.
    serve`), each swap's ms (`maybe_swap`, inside its wave), each Python
    collection's generation, ms and the objects it freed and could not
    free (`gc.callbacks`). Installed around one run, removed after it."""

    def __enter__(self):
        from repro_torch.streaming import pipeline as pl
        self._cls = pl.OnlineServingEngine
        self._real = (self._cls.serve, self._cls.maybe_swap)
        serve, swap = self._real
        self.waves, self.swaps, self.gcs = [], [], []
        self._gc_start = None

        def timed_serve(eng, requests, max_wave=8):
            a = time.perf_counter()
            out = serve(eng, requests, max_wave)
            self.waves.append((id(eng), a, time.perf_counter(),
                               [r.latency_s for r in out]))
            return out

        def timed_swap(eng):
            a = time.perf_counter()
            ok = swap(eng)
            self.swaps.append((a, time.perf_counter() - a, ok))
            return ok
        self._cls.serve, self._cls.maybe_swap = timed_serve, timed_swap
        gc.callbacks.append(self._on_gc)
        self.t0 = time.perf_counter()
        return self

    def _on_gc(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._gc_start = now
        elif self._gc_start is not None:
            self.gcs.append((self._gc_start, now - self._gc_start,
                             info["generation"], info["collected"],
                             info["uncollectable"]))

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self._cls.serve, self._cls.maybe_swap = self._real
        gc.callbacks.remove(self._on_gc)

    def summary(self) -> dict:
        """The stalls (a replica's wave interval of STALL_MS or more), each
        put down to the collections that overlap it where they took half of
        it, else to a swap of its wave that took half of it, else to
        neither; the collections and
        swaps; and per TIMELINE_BIN_S of wall time the requests completed,
        their largest latency, the collections' ms."""
        t0, ms = self.t0, 1e3
        stalls = {"collection": [], "swap": [], "neither": []}
        last = {}
        for eng, a, b, _ in sorted(self.waves, key=lambda w: w[2]):
            prev = last.get(eng, a)
            last[eng] = b
            if (b - prev) * ms < STALL_MS:
                continue
            gcs = [g for g in self.gcs if g[0] < b and g[0] + g[1] > prev]
            swaps = [s for s in self.swaps if a <= s[0] <= b]
            # [from, interval, of it the wave's own] ms
            entry = [round((prev - t0) * ms, 1), round((b - prev) * ms, 1),
                     round((b - a) * ms, 1)]
            if sum(g[1] for g in gcs) * 2 >= b - prev:
                stalls["collection"].append(entry + [
                    [(g[2], round(g[1] * ms, 1)) for g in gcs]])
            elif swaps and max(s[1] for s in swaps) * 2 >= b - prev:
                stalls["swap"].append(entry + [
                    round(max(s[1] for s in swaps) * ms, 1)])
            else:
                stalls["neither"].append(entry)
        bins = {}
        for _, _, b, lat in self.waves:
            k = int((b - t0) / TIMELINE_BIN_S)
            n, top = bins.get(k, (0, 0.0))
            bins[k] = (n + len(lat), max([top] + [x * ms for x in lat]))
        gc_bins = {}
        for a, d, *_ in self.gcs:
            k = int((a - t0) / TIMELINE_BIN_S)
            gc_bins[k] = gc_bins.get(k, 0.0) + d * ms
        swap_ms = sorted(s[1] * ms for s in self.swaps)
        return {
            "wall_ms": round((self.t1 - t0) * ms, 1),
            "waves": len(self.waves),
            "stalls": {k: len(v) for k, v in stalls.items()},
            "stall_ms": {k: round(sum(e[1] for e in v), 1)
                         for k, v in stalls.items()},
            "stall_list": stalls,
            # (generation, at ms, ms, freed, not freeable)
            "collections": [(g[2], round((g[0] - t0) * ms, 1),
                             round(g[1] * ms, 2), g[3], g[4])
                            for g in self.gcs if g[2] > 0 or g[1] * ms >= 1.0],
            "gen0_collections": sum(1 for g in self.gcs if g[2] == 0),
            "collection_ms": round(sum(g[1] for g in self.gcs) * ms, 1),
            "swaps": len(self.swaps),
            "swap_ms_p50_max_sum": (
                [round(statistics.median(swap_ms), 3),
                 round(swap_ms[-1], 3), round(sum(swap_ms), 1)]
                if swap_ms else []),
            "timeline": [(round(k * TIMELINE_BIN_S, 1), n, round(top, 1),
                          round(gc_bins.get(k, 0.0), 1))
                         for k, (n, top) in sorted(bins.items())]}


def _heap_and_threads(what: str) -> None:
    """Logs the threads alive and the heap the collector tracks: objects,
    the generations' counts, the frozen count, the commonest types."""
    import collections
    import threading
    names = collections.Counter(
        t.name.rstrip("0123456789").rstrip("-_") or t.name
        for t in threading.enumerate())
    objs = gc.get_objects()
    kinds = collections.Counter(type(o).__name__ for o in objs)
    log(f"[stream] {what}: threads {len(threading.enumerate())} "
        f"{dict(names)}; tracked objects {len(objs)}, gc counts "
        f"{gc.get_count()}, thresholds {gc.get_threshold()}, frozen "
        f"{gc.get_freeze_count()}; commonest types "
        f"{kinds.most_common(12)}")
    del objs


def _hotswap_overhead(seed: int) -> None:
    from repro_torch import core
    from repro_torch.streaming.sources import StreamConfig
    num = 300
    arms = {}
    for arm, swap in (("swap", True), ("no swap", False)):
        core.init(num_nodes=3, workers_per_node=2)
        try:
            p = _stream_pipeline(StreamConfig(dim=16, batch=32, seed=seed,
                                              interval_s=0.01), swap=swap)
            with _StreamTimeline() as tl:
                rep = p.run(num)
            p.close()
        finally:
            core.shutdown()
        log(f"[stream] hotswap_overhead ({arm}) timeline: "
            f"{json.dumps(tl.summary())}")
        _check_stream_run(f"hotswap_overhead ({arm})", rep, num)
        slo = rep["slo"]
        if slo["completed_ok"] <= 0:
            raise AssertionError(f"hotswap_overhead ({arm}): nothing "
                                 "completed")
        arms[arm] = slo
    on, off = arms["swap"], arms["no swap"]
    mult, add = SWAP_P99_SLACK
    log(f"[stream] hotswap_overhead: {num} batches an arm; p50/p99 ms with "
        f"swaps {on['latency_p50_ms']:.3f}/{on['latency_p99_ms']:.3f} "
        f"({on['weight_swaps']} swaps), without "
        f"{off['latency_p50_ms']:.3f}/{off['latency_p99_ms']:.3f}; limit "
        f"{off['latency_p99_ms'] * mult + add:.3f}")
    if on["weight_swaps"] <= 0:
        raise AssertionError("hotswap_overhead: no swaps in the swap arm")
    if not on["latency_p99_ms"] <= off["latency_p99_ms"] * mult + add:
        raise AssertionError(f"hotswap_overhead: p99 {on['latency_p99_ms']} "
                             f"ms with swaps past {mult} x "
                             f"{off['latency_p99_ms']} + {add} ms")


def _churn_plateau(seed: int) -> None:
    import threading
    from repro_torch import core
    from repro_torch.core.profiler import summarize
    from repro_torch.streaming.sources import StreamConfig
    chunk = 150
    cfg = StreamConfig(dim=32, batch=64, seed=seed, interval_s=0.005)
    cluster = core.init(num_nodes=3, workers_per_node=2)
    samples: list = []
    stop = threading.Event()
    try:
        p = _stream_pipeline(cfg, publish_every=2, serve_per_batch=4)
        t0 = time.perf_counter()

        def sampler():
            while not stop.is_set():
                samples.append(sum(n.store.used_bytes
                                   for n in cluster.nodes if n.alive))
                stop.wait(0.1)

        st = threading.Thread(target=sampler, name="churn-sampler",
                              daemon=True)
        st.start()
        batches, rep = 0, None
        while time.perf_counter() - t0 < CHURN_S:
            rep = p.run(chunk)
            batches += chunk
            _check_stream_run(f"churn_plateau (run of {chunk})", rep,
                              batches)
        stop.set()
        st.join(2.0)
        wall = time.perf_counter() - t0
        p.close()
        s = summarize(cluster.gcs)
    finally:
        stop.set()
        core.shutdown()
    third = max(1, len(samples) // 3)
    early, late = max(samples[:third]), max(samples[-third:])
    mult, add = PLATEAU_SLACK
    log(f"[stream] churn_plateau: {batches} batches in {wall:.2f} s "
        f"({CHURN_S} s cut of 60 s); store bytes early peak {early}, late "
        f"peak {late} (limit {early * mult + add:.0f}), last {samples[-1]}; "
        f"reclaims {s['reclaims']}, publishes {s['param_publishes']}; "
        f"source {rep['source']}")
    if not late <= early * mult + add:
        raise AssertionError(f"churn_plateau: late peak {late} B past "
                             f"{mult} x early {early} + {add} B")
    if s["reclaims"] <= 0:
        raise AssertionError("churn_plateau: the GC reclaimed nothing")


def _learner_kill(seed: int) -> None:
    from repro_torch import core
    from repro_torch.core.profiler import summarize
    from repro_torch.streaming.sources import DriftSpec, StreamConfig
    num = 500
    kill_at = num // 3
    cfg = StreamConfig(dim=16, batch=32, seed=seed, interval_s=0.01,
                       drifts=(DriftSpec(at_step=num // 2, kind="abrupt",
                                         target="label"),))
    cluster = core.init(num_nodes=4, workers_per_node=2,
                        failure_detection=True)
    state = {"killed": None, "version_at_kill": 0, "slo_at_kill": None}
    try:
        p = _stream_pipeline(cfg, checkpoint_interval=8, deadline_s=0.5)

        def inject(consumed):
            if consumed >= kill_at and state["killed"] is None:
                nid = cluster.gcs.actor_node(p.learner.actor_id)
                if nid is not None:
                    state["version_at_kill"] = \
                        p.frontdoor.slo.published_version
                    state["slo_at_kill"] = p.frontdoor.slo.snapshot()
                    cluster.kill_node(nid)
                    state["killed"] = nid

        t0 = time.perf_counter()
        rep = p.run(num, mid_run=inject)
        wall = time.perf_counter() - t0
        s = summarize(cluster.gcs)
        p.close()
    finally:
        core.shutdown()
    slo = rep["slo"]
    log(f"[stream] learner_kill: {num} batches in {wall:.2f} s, node "
        f"{state['killed']} killed at batch {kill_at}: published version "
        f"{state['version_at_kill']} at the kill, {slo['published_version']} "
        f"after; version lag max {slo['version_lag_max']} (limit "
        f"{LAG_BOUND}); lost steps {rep['lost_steps']}; node failures "
        f"{s['node_failures']}; source {rep['source']}")
    if state["killed"] is None or s["node_failures"] < 1:
        raise AssertionError("learner_kill: no node was killed")
    before = state["slo_at_kill"]
    log(f"[stream] learner_kill: after the kill, requests admitted "
        f"{slo['admitted'] - before['admitted']}, shed "
        f"{slo['shed'] - before['shed']} (at the dispatch "
        f"{slo['shed_at_dispatch'] - before['shed_at_dispatch']}), late "
        f"{slo['completed_late'] - before['completed_late']}")
    _check_stream_run("learner_kill", rep, num)
    if not slo["published_version"] > state["version_at_kill"]:
        raise AssertionError("learner_kill: publishes never resumed")
    if slo["version_lag_max"] > LAG_BOUND:
        raise AssertionError(f"learner_kill: version lag "
                             f"{slo['version_lag_max']} > {LAG_BOUND}")


def streaming() -> None:
    """Phase 8b: stream_bench.py's four scenarios on the port's plane, at
    its CI seed."""
    _heap_and_threads("phase 8b starts")
    for name, fn in (("drift_recovery", _drift_recovery),
                     ("hotswap_overhead", _hotswap_overhead),
                     ("churn_plateau", _churn_plateau),
                     ("learner_kill", _learner_kill)):
        timed(f"stream {name}", fn, STREAM_SEED)
    _runtime_threads_drained(15.0)


# ----------------------------------------------------------------- phase 8c

def _policy_update_us(device: str, n: int = 200) -> float:
    """p50 host us of one policy update at the example's batch of 8 on
    `device`, waited for (each update takes the last one's weights)."""
    from repro_torch.examples.rl_pipeline import make_policy
    w, _, update = make_policy(device)
    rng = np.random.default_rng(SEED)
    obs, acts, rews = (torch.as_tensor(a, dtype=torch.float32, device=device)
                       for a in (rng.standard_normal((8, 8)),
                                 np.tanh(rng.standard_normal((8, 2))),
                                 rng.standard_normal(8)))

    def one():
        nonlocal w
        w = update(w, obs, acts, rews)
        if w["w1"].is_cuda:
            torch.cuda.synchronize()

    return _host_percentiles(one, n)["p50_us"]


def rl_on_the_card(device_type: str = "cuda") -> None:
    """Phase 8c: the RL example at its defaults and with its learner's node
    killed, its learner's update on the card; then the §4.2 runs."""
    from repro_torch.examples import rl_pipeline, rl_workload
    log(f"[rl] one policy update (batch 8, 8 -> 32 -> 2), p50 of 200: "
        f"{_policy_update_us(device_type):.1f} us on {device_type}, "
        f"{_policy_update_us('cpu'):.1f} us on the host's CPU (a rollout "
        f"sleeps 2-6 ms)")
    for kill in (False, True):
        what = "rl_pipeline" + (" --kill-node" if kill else "")
        t0 = time.perf_counter()
        out = rl_pipeline.run(kill_node=kill)
        wall = time.perf_counter() - t0
        rets = out["returns"]
        log(f"[rl] {what}: {wall:.2f} s; learner on {out['device']}, "
            f"{out['learner_updates']} updates on its weights, "
            f"{len(rets)} applied; mean return first 5 "
            f"{np.mean(rets[:5]):+.3f}, last 5 {np.mean(rets[-5:]):+.3f}; "
            f"policy improved {out['improved']}; ParamSet fetch round trip "
            f"{out['fetch_ok']}")
        if not out["device"].startswith(device_type):
            raise AssertionError(f"{what}: the learner's weights are on "
                                 f"{out['device']}, not {device_type}")
        if not out["improved"]:
            raise AssertionError(f"{what}: the policy did not improve")
        if out["fetch_ok"] is not True:
            raise AssertionError(f"{what}: the ParamSet fetch did not "
                                 "round-trip")
    t0 = time.perf_counter()
    w = rl_workload.run()
    paper = w["paper"]
    log(f"[rl] rl_workload ({time.perf_counter() - t0:.2f} s; "
        f"{w['config']}): serial {w['serial_s']:.4f} s, BSP at 2.5 ms "
        f"{w['bsp_s']:.4f} s, BSP at 10 ms {w['bsp10_s']:.4f} s, hybrid "
        f"{w['hybrid_s']:.4f} s; serial/BSP {w['bsp_vs_serial']:.3f} (paper "
        f"{paper['bsp_vs_serial']:.3f}), serial/BSP at 10 ms "
        f"{w['bsp10_vs_serial']:.3f}, serial/hybrid "
        f"{w['hybrid_vs_serial']:.3f} (paper {paper['hybrid_vs_serial']}), "
        f"BSP/hybrid {w['hybrid_vs_bsp']:.3f} (paper "
        f"{paper['hybrid_vs_bsp']}), BSP at 10 ms/hybrid "
        f"{w['hybrid_vs_bsp10']:.3f}; printed, not gated")


# ----------------------------------------------------------------- phase 8d

def simulator(round_trip_us: float) -> None:
    """Phase 8d: each DES scenario at its defaults; the device step of
    `heterogeneous_fleet` is phase 6's kernel-task round trip p50 on the
    card. Virtual-time figures, computed from that one measured cost."""
    from repro_torch.core import simulator as des
    kernel_s = round_trip_us * 1e-6
    t0 = time.perf_counter()
    fleet = des.heterogeneous_fleet(
        kernel_s=kernel_s, costs=des.SimCosts(kernel_step_s=kernel_s))
    log(f"[des] heterogeneous_fleet, kernel step {round_trip_us:.1f} us "
        f"(phase 6's round trip p50 on the card): {fleet}")
    if fleet["device_misplaced"] != 0:
        raise AssertionError(f"heterogeneous_fleet: "
                             f"{fleet['device_misplaced']} misplaced")
    diurnal = des.serving_diurnal()
    log("[des] serving_diurnal: " + str(
        {k: v for k, v in diurnal.items() if k != "replica_timeline"}))
    if not diurnal["ledger_balanced"]:
        raise AssertionError("serving_diurnal: the ledger does not balance")
    drift = des.streaming_drift()
    log(f"[des] streaming_drift: {drift}")
    if not drift["recovered"]:
        raise AssertionError("streaming_drift: did not recover")
    log(f"[des] chaos_mass_failure: {des.chaos_mass_failure()}")
    log(f"[des] chaos_rolling_restart: {des.chaos_rolling_restart()}")
    log(f"[des] host wall {time.perf_counter() - t0:.2f} s")


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
    t0 = time.perf_counter()
    build_report()
    log(f"[time] build: {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = timed("kernels flash_attention", check_flash_attention, gen)
    mlstm = timed("kernels mlstm_scan", check_mlstm_scan, gen)
    mlstm["seed_sweep"] = timed("kernels mlstm_scan seed sweep",
                                sweep_mlstm_seeds)
    ssm = timed("kernels ssm_scan", check_ssm_scan, gen)
    # a generator of its own: the other kernels' checks keep the draws they
    # were held to before this one; other draws of the mlstm_scan cases are
    # the seed sweep's (ROADMAP C3)
    flash["at_mixtral_shapes"] = timed(
        "kernels flash_attention mixtral", check_flash_mixtral,
        torch.Generator(device="cuda").manual_seed(SEED + 7))
    release_memory()
    flash_bwd = timed(
        "kernels flash_attention backward", check_flash_backward,
        torch.Generator(device="cuda").manual_seed(SEED + 19))
    flash["backward"] = flash_bwd
    release_memory()
    flash["at_new_head_dims"] = timed(
        "kernels flash_attention hd 256 and 192", check_flash_new_head_dims,
        torch.Generator(device="cuda").manual_seed(SEED + 11))
    release_memory()
    flash["at_launch_shapes"] = timed(
        "kernels flash_attention 5c shapes", check_flash_launch_shapes,
        torch.Generator(device="cuda").manual_seed(SEED + 17))
    release_memory()
    timed("parity stablelm", check_card_vs_cpu)
    timed("parity stablelm softcap", check_softcap_card_vs_cpu)
    timed("parity xlstm", check_xlstm_card_vs_cpu)
    timed("parity mixtral", check_mixtral_card_vs_cpu)
    timed("parity jamba", check_jamba_card_vs_cpu)
    timed("parity new arches", check_new_archs_card_vs_cpu)
    timed("parity gemma3 chunked loss", check_gemma3_chunked_loss)
    release_memory()
    # the forward's and the backward's launches by design (`ops.fwd_path`,
    # `ops.bwd_path`) over the main paths of phases 4-10 in this process;
    # the ranks of phase 10 count their own
    by_design = _wrappers()["flash_attention"].launches_by_design
    by_design.update(dict.fromkeys(by_design, 0))
    bwd_by_design = _wrappers()["flash_attention"].bwd_launches_by_design
    bwd_by_design.update(dict.fromkeys(bwd_by_design, 0))
    stablelm = timed("serve stablelm", serve_full_model, card)
    frontdoor = timed("serve frontdoor", serve_frontdoor, stablelm, card)
    stablelm_flash = stablelm["flash"]
    del stablelm
    release_memory()   # stablelm's engine and params, before jamba's 18 GB
    jamba = timed("serve jamba", serve_jamba, card)
    release_memory()
    mixtral = timed("serve mixtral", serve_mixtral, card)
    release_memory()
    gemma3 = timed("serve gemma3", serve_gemma3, card)
    release_memory()
    deepseek = timed("serve deepseek", serve_deepseek, card)
    release_memory()
    modal = timed("serve internvl2 and seamless", serve_modality_models, card)
    release_memory()
    dense = timed("serve phi3 and mistral-large", serve_dense_models, card)
    release_memory()
    mlstm_sync = timed("train", train_full_model)
    release_memory()
    mixtral_train = timed("train mixtral", train_mixtral)
    release_memory()
    launch = timed("launch", launch_phase,
                   torch.Generator(device="cuda").manual_seed(SEED + 13))
    release_memory()
    launch_paths = {
        **{f"launch.train {a} (phase 5c a)": r["launches"]
           for a, r in launch["train"].items()},
        **{f"remat {p} (phase 5c c)": {
            "flash_attention": r["flash_launches"],
            "flash_attention_bwd": r["flash_bwd_launches"]}
           for p, r in launch["remat"].items()},
        "compressing step (phase 5c d)": launch["compression"]["launches"],
        **{f"launch.serve {a} (phase 5c e)": r["launches"]
           for a, r in launch["serve"].items()}}
    flash["launches_by_path"] = {
        "serve stablelm-1.6b": stablelm_flash,
        "serve_llm --full through the FrontDoor (phase 4c)":
            frontdoor["flash"],
        "serve_llm --full --replicas 1 (phase 4c)": frontdoor["flash_one"],
        "FrontDoor replica kill (phase 4c)": frontdoor["flash_kill"],
        "serve jamba cut": jamba["flash_attention"],
        "serve mixtral-8x22b cut (phase 4d)": mixtral["flash"],
        "serve gemma3-12b (phase 4e)": gemma3["flash"],
        "serve deepseek-v2-236b cut (phase 4f)": deepseek["flash"],
        **{f"prefill and decode {name} (phase 4g)": r["flash"]
           for name, r in modal.items()},
        **{f"serve {name} (phase 4g)": r["flash"]
           for name, r in dense.items()},
        **{f"train mixtral-8x22b cut, {what} (phase 5b)": n
           for what, n in mixtral_train["flash"].items()},
        **{p: n["flash_attention"] for p, n in launch_paths.items()
           if n["flash_attention"]}}
    flash["launches"] = sum(flash["launches_by_path"].values())
    flash_bwd["launches_by_path"] = {
        **{f"train mixtral-8x22b cut, {what} (phase 5b)": n
           for what, n in mixtral_train["flash_bwd"].items()},
        **{p: n["flash_attention_bwd"] for p, n in launch_paths.items()
           if n.get("flash_attention_bwd")}}
    ssm["launches_by_path"] = {
        "serve jamba cut (phase 4b)": jamba["ssm_scan"],
        "_SSMScan at the train shape (phase 5c b)": 1,
        **{p: n["ssm_scan"] for p, n in launch_paths.items()
           if n.get("ssm_scan")}}
    ssm["launches"] = sum(ssm["launches_by_path"].values())
    int8, round_trip_us = timed("compute", compute_plane, gen)
    release_memory()
    mlstm_graph = timed("train graph", train_graph)
    mlstm["launches_by_path"] = {
        "train --sync (phase 5)": mlstm_sync,
        "train task graph (phase 7)": mlstm_graph,
        **{p: n["mlstm_scan"] for p, n in launch_paths.items()
           if n.get("mlstm_scan")}}
    mlstm["launches"] = sum(mlstm["launches_by_path"].values())
    release_memory()

    # phases 8-8d run no Pallas kernel's counterpart: their launches are
    # read and logged, beside the main paths' above
    reset_launch_counts()
    timed("runtime examples", runtime_examples)
    timed("streaming", streaming)
    timed("rl", rl_on_the_card)
    timed("simulator", simulator, round_trip_us)
    log(f"[slice] kernel launches in phases 8-8d: {launch_counts()}")
    timed("dryrun", dryrun_phase, launch["train"])
    release_memory()
    sharded = timed("sharded", sharded_phase)
    for label, r in sharded.items():
        for entry, key in ((flash, "flash_launches"),
                           (flash_bwd, "flash_bwd_launches"),
                           (ssm, "ssm_launches"), (mlstm, "mlstm_launches")):
            if r[key]:
                entry["launches_by_path"][
                    f"sharded train {label}, {r['backend']} {r['ranks']} "
                    "ranks (phase 10)"] = r[key]
                entry["launches_by_path"][
                    f"one-card step of {label} (phase 10)"] = \
                    r[f"one_card_{key}"]
    for entry in (flash, flash_bwd, ssm, mlstm):
        entry["launches"] = sum(entry["launches_by_path"].values())
    flash["launches_by_design"] = {
        d: n + sum(r["flash_by_design"][d] for r in sharded.values()
                   if "flash_by_design" in r)
        for d, n in by_design.items()}
    flash_bwd["launches_by_design"] = {
        d: n + sum(r["flash_bwd_by_design"][d] for r in sharded.values()
                   if "flash_bwd_by_design" in r)
        for d, n in bwd_by_design.items()}
    log(f"[slice] flash_attention forward launches by design over phases "
        f"4-10 (this process and the phase 10 ranks): "
        f"{flash['launches_by_design']}; backward "
        f"{flash_bwd['launches_by_design']}")
    from repro_torch.kernels.flash_attention.ops import SM90_PATH
    if not flash["launches_by_design"][SM90_PATH]:
        raise AssertionError("flash's wgmma forward never launched on a "
                             "main path")
    if not flash_bwd["launches_by_design"][SM90_PATH]:
        raise AssertionError("flash's wgmma backward never launched on a "
                             "main path")
    if not flash_bwd["launches"]:
        raise AssertionError("flash's backward kernels never launched on a "
                             "main path")

    print(json.dumps({"kernels": [flash, mlstm, ssm, int8]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
