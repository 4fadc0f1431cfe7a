"""The work of one kernel call, counted from shapes: what a bound in
`chip_smoke.py` divides by and what the dry run's trace adds up
(`analysis.trace`). Each kernel's `ops.cost` returns one."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class KernelCost(NamedTuple):
    """Useful FLOPs, the bytes a call must move (each input read once,
    each output written once) and, for a kernel whose time the special
    function units may bound, its exps."""
    flops: int
    bytes: int
    exps: int = 0


def valid_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs an attention mask lets through: row i (of S)
    sees key j (of T) where j <= i if causal and i - j < window if
    window > 0, the masks of `attention_ref`."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())
