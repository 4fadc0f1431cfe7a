"""Launch counters of the port's kernel wrappers under concurrent callers.

Device lanes and their callers may launch at once, and chip_smoke.py checks
each main path's count exactly, so every wrapper adds to its count under a
lock. Here each wrapper's launch path runs on `meta` tensors from 8 threads
with its library replaced by a launcher that does nothing, and the count
must come out exact. The count is an int whose addition yields the GIL, so
an increment outside the lock loses updates."""
import contextlib
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan import mlstm_scan  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402

THREADS, CALLS = 8, 200
META = dict(device="meta")


class SlowCount(int):
    """An int whose `+` sleeps first: another thread runs between the read
    and the write of an unlocked `launches += 1`."""

    def __add__(self, other):
        time.sleep(1e-5)
        return SlowCount(int(self) + other)


def _noop(*args):
    return 0   # cudaSuccess


def _err_str(err):
    return b"no error"


def _flash_call():
    q = torch.empty(1, 2, 8, 32, **META)
    flash_attention(q, q, q)


def _ssm_call():
    x = torch.empty(1, 4, 8, **META)
    bc = torch.empty(1, 4, 16, **META)
    ssm_scan(x, x, bc, bc, torch.empty(8, 16, **META),
             torch.empty(8, **META))


def _mlstm_call():
    q = torch.empty(1, 2, 8, 32, **META)
    gate = torch.empty(1, 2, 8, **META)
    mlstm_scan(q, q, q, gate, gate)


def _int8_call():
    int8_matmul(torch.empty(4, 16, **META),
                torch.empty(16, 8, dtype=torch.int8, **META),
                torch.empty(8, **META))


WRAPPERS = {  # name: (wrapper, its ops module, one call, the no-op entry)
    "flash_attention": (flash_attention, flash_ops, _flash_call,
                        (_noop, _err_str)),
    "ssm_scan": (ssm_scan, ssm_ops, _ssm_call, (_noop, _err_str)),
    "mlstm_scan": (mlstm_scan, mlstm_ops, _mlstm_call,
                   ({dtype: _noop for dtype in mlstm_ops.PATHS}, _err_str)),
    "int8_matmul": (int8_matmul, int8_ops, _int8_call,
                    ({path: _noop for path in (int8_ops.GEMV, int8_ops.MMA,
                                                int8_ops.TILES)},
                     _err_str)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_count_is_exact_under_threads(name, monkeypatch):
    wrapper, ops, call, entry = WRAPPERS[name]
    monkeypatch.setattr(ops, "_entry", lambda: entry)
    # no card here: the launch path's device and stream lookups answer as
    # for one card
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(wrapper, "launches", SlowCount(0))
    call()
    assert wrapper.launches == 1

    barrier = threading.Barrier(THREADS)
    errors = []

    def worker():
        try:
            barrier.wait()
            for _ in range(CALLS):
                call()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert wrapper.launches == 1 + THREADS * CALLS
