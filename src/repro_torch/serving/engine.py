"""Serving engine: batched prefill + iteration-batched greedy decode. The
port of `repro.serving.engine` (Request, Response, length_aligned_waves,
ServingEngine).

Requests are grouped into *waves* of equal prompt length. A wave's prompts
share one batched prefill, then all lanes decode in lock-step with one
`decode_step` per token (one shared position clock, so the KV-cache write
slot is uniform across lanes). Lanes that reach their token budget are
masked out but keep riding the batch until the wave drains.

The engine runs on the card unless `device="cpu"` is passed. On the card,
prefill's attention is the Hopper flash attention kernel, and a Mamba
layer's scan (jamba) is the Hopper ssm_scan kernel in prefill and decode;
an mLSTM layer runs the mlstm_scan kernel likewise.
`ServingReplica` and `ReplicaPool` wait for the runtime slice.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bridge import params_to
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    created: float = field(default_factory=time.perf_counter)
    # orders requests within a deadline bucket in the reference's front
    # door (higher first); carried for the runtime slice
    priority: int = 0


@dataclass
class Response:
    request_id: int
    tokens: List[int]
    latency_s: float


def length_aligned_waves(requests: List[Request], max_wave: int
                         ) -> List[List[Request]]:
    """Group requests by prompt length and chunk into waves of at most
    `max_wave` (equal lengths per wave keep prefill and decode one batch)."""
    by_len: Dict[int, List[Request]] = defaultdict(list)
    for r in requests:
        by_len[len(r.prompt)].append(r)
    waves = []
    for _, group in sorted(by_len.items()):
        for i in range(0, len(group), max_wave):
            waves.append(group[i:i + max_wave])
    return waves


class ServingEngine:
    def __init__(self, model: Model, params, max_seq: int = 512,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to(params, self.device)
        self.max_seq = max_seq

    @torch.inference_mode()
    def _run_wave(self, wave: List[Request]) -> List[Response]:
        prompts = np.stack([r.prompt for r in wave])        # equal lengths
        b, s = prompts.shape
        budgets = np.array([r.max_new_tokens for r in wave])
        tokens = torch.from_numpy(prompts.astype(np.int64)).to(self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           max_seq=self.max_seq)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        outs: List[List[int]] = [[] for _ in wave]
        for step in range(int(budgets.max())):
            alive = step < budgets
            host_tok = tok[:, 0].cpu().numpy()
            for i in range(b):
                if alive[i]:
                    outs[i].append(int(host_tok[i]))
            if step == budgets.max() - 1 or s + step >= self.max_seq - 1:
                break
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   s + step)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        return [Response(r.request_id, o, now - r.created)
                for r, o in zip(wave, outs)]

    def serve(self, requests: List[Request], max_wave: int = 8
              ) -> List[Response]:
        """Run length-aligned waves sequentially on this engine."""
        responses: List[Response] = []
        for wave in length_aligned_waves(requests, max_wave):
            responses.extend(self._run_wave(wave))
        return responses

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 16
                 ) -> List[int]:
        r = Request(0, np.asarray(prompt, np.int32), max_new_tokens)
        return self._run_wave([r])[0].tokens
