"""Typed device resources.

The resource ledger (`Node.capacity`/`_avail`) always supported arbitrary
keys, but only ``"cpu"`` (worker slots) and ``"mem"`` (placement hint)
carried meaning. This module names the *device* keys — accelerator
capacity a node physically holds — so the scheduler, the dispatch path,
and the compute plane agree on which requests are hard placement
constraints with a dedicated executor lane behind them.

Pure-constant leaf module: imported by the scheduler, the runtime, and
the compute package, so it must not import any of them.
"""
from typing import Dict, Tuple

# Resource keys that denote accelerator devices. A task requesting any of
# these (a) can only land on a node whose declared capacity covers the
# request — the ledger enforced that already — and (b) executes on the
# node's dedicated device lane (thread backend), so two kernel tasks
# never contend for one device even when worker threads outnumber it.
DEVICE_RESOURCE_KEYS: Tuple[str, ...] = ("gpu", "tpu", "accel")


def device_keys(resources: Dict[str, float]) -> Tuple[str, ...]:
    """The device-typed subset of a resource request (amount > 0)."""
    return tuple(k for k in DEVICE_RESOURCE_KEYS
                 if resources.get(k, 0.0) > 0.0)


def device_subset(resources: Dict[str, float]) -> Dict[str, float]:
    return {k: resources[k] for k in device_keys(resources)}
