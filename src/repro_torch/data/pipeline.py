"""Deterministic synthetic data pipeline with per-DP-rank sharding and
background prefetch: the port's own copy of `repro.data.pipeline`, the same
numpy code, so it gives the same tokens bit for bit.

Produces Zipf-distributed token streams (a reasonable LM-token surrogate)
seeded per (epoch, step, shard) so any batch is reproducible — which is
what lineage replay needs: a `load_batch` task re-executed after a failure
must return identical data. The prefetcher overlaps host data generation
with device compute (double buffering). A sharded run draws the same
global batch on every rank and each rank takes its rows (`shard_rows`).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    shard_id: int = 0
    seed: int = 1234
    zipf_a: float = 1.2
    input_mode: str = "tokens"      # tokens | frames | tokens+image
    d_model: int = 0
    num_image_tokens: int = 0


def batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (cfg, step): replay-safe."""
    assert cfg.global_batch % cfg.num_shards == 0
    b = cfg.global_batch // cfg.num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_id]))
    zipf = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len)).astype(np.int64)
    tokens = (zipf % (cfg.vocab_size - 2) + 1).astype(np.int32)
    out: Dict[str, np.ndarray] = {"tokens": tokens}
    if cfg.input_mode == "frames":
        out["frames"] = rng.standard_normal(
            (b, cfg.seq_len, cfg.d_model)).astype(np.float32)
    elif cfg.input_mode == "tokens+image":
        p = cfg.num_image_tokens
        out["tokens"] = tokens[:, :cfg.seq_len - p]
        out["image_embeds"] = rng.standard_normal(
            (b, p, cfg.d_model)).astype(np.float32)
    return out


def shard_rows(x, index: int, count: int):
    """Block `index` of `count` equal blocks of rows of `x` (a numpy array
    or a tensor): a data rank's rows of the global batch that every rank
    draws, as the sharding rules' `input_shardings` split it."""
    b = x.shape[0]
    if b % count:
        raise ValueError(f"batch {b} does not split into {count} blocks")
    return x[index * b // count:(index + 1) * b // count]


class Prefetcher:
    """Background thread that keeps `depth` batches ready."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
