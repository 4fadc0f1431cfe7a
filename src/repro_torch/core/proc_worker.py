"""Worker-process entry point for the process execution backend.

Spawned once per worker at cluster start (`ProcessBackend.start`), this
module must stay import-light and spawn-safe: the child re-imports it by
name, attaches to the two instruction rings it was handed, and serves
task instructions until a ``stop`` record (or the parent's death — the
process is a daemon).

Zero-copy argument path: an instruction carries object *descriptors*,
not values. A segment descriptor names a shared-memory segment owned by
the parent's ``SharedMemoryStore``; the child attaches once (an LRU
cache of mappings bounds fd usage), and an array argument materializes
as a read-only ``np.frombuffer`` view over the very bytes the parent
wrote — no copy, no pickle. Results flow back the same way: a large
result is serialized straight into a fresh segment whose *name* rides
the completion ring; the parent adopts the segment into its store.

The child never unlinks anything: segment lifetime is owned by the
parent store (see ``create_segment``), and a child-created result
segment is either adopted or explicitly discarded by the parent.
"""
from __future__ import annotations

import pickle
import traceback
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

from repro_torch.core.object_store import (SEGMENT_THRESHOLD, attach_segment,
                                     create_segment)
from repro_torch.core.serialization import PICKLE_PROTO, Payload

#: Max cached segment mappings per worker (fd bound). Beyond it, the
#: least-recently-used mapping is closed — unless a live view still
#: references it, in which case it is retried later.
_SEG_CACHE_CAP = 64


def _attach_cached(name: str, cache: "OrderedDict[str, Any]"):
    shm = cache.get(name)
    if shm is None:
        shm = attach_segment(name)
        cache[name] = shm
    else:
        cache.move_to_end(name)
    return shm


def _trim_cache(cache: "OrderedDict[str, Any]") -> None:
    if len(cache) <= _SEG_CACHE_CAP:
        return
    for name in list(cache):
        if len(cache) <= _SEG_CACHE_CAP:
            return
        shm = cache[name]
        try:
            shm.close()
        except BufferError:  # a view from this task is still alive
            cache.move_to_end(name)
            continue
        del cache[name]


def _payload_value(sdesc: Tuple, cache: "OrderedDict[str, Any]") -> Any:
    """Store descriptor -> live value (zero-copy view for segments)."""
    if sdesc[0] == "seg":
        _tag, kind, meta, name, nbytes = sdesc
        shm = _attach_cached(name, cache)
        return Payload.from_buffer(kind, meta, shm.buf[:nbytes]).value()
    _tag, kind, meta, raw = sdesc
    return Payload.from_buffer(kind, meta, raw).value()


def _materialize(desc: Tuple, cache: "OrderedDict[str, Any]") -> Any:
    tag = desc[0]
    if tag == "obj":
        return _payload_value(desc[1], cache)
    if tag == "lit":
        return pickle.loads(desc[1])
    # ("seq", "list"|"tuple", [descs...]) — refs one level inside plain
    # containers, mirroring Node.resolve
    _tag, typ, items = desc
    seq = [_materialize(d, cache) for d in items]
    return seq if typ == "list" else tuple(seq)


def _encode_result(value: Any) -> Tuple:
    """Value -> result descriptor. Large buffers go into a fresh
    segment (the parent store adopts and owns it); small ones ride the
    completion ring inline. Unpicklable results raise SpawnSafetyError,
    which surfaces to the caller as a TaskError naming the object."""
    payload = Payload.wrap(value)
    buf = payload.ensure_buffer(strict=True)
    if payload.nbytes >= SEGMENT_THRESHOLD:
        shm = create_segment(payload.nbytes)
        shm.buf[:payload.nbytes] = buf
        desc = ("seg", payload.kind, payload.meta, shm.name,
                payload.nbytes)
        shm.close()  # the parent adopts the mapping; the name persists
        return desc
    return ("inl", payload.kind, payload.meta, bytes(buf))


def worker_main(instr: Any, comp: Any, node_id: int, widx: int) -> None:
    """Serve the instruction ring until stopped. Records:

      in:  ("fn", name, bytes) | ("task", tid, fname, args, kwargs,
           return_ids) | ("stop",)
      out: ("done", tid, [result_desc, ...])
           | ("err", tid, pickled_exc | None, repr, traceback_str)
    """
    funcs: Dict[str, Any] = {}
    cache: "OrderedDict[str, Any]" = OrderedDict()
    while True:
        rec = instr.pop(timeout=1.0)
        if rec is None:
            continue
        msg = pickle.loads(rec)
        op = msg[0]
        if op == "stop":
            return
        if op == "fn":
            obj = pickle.loads(msg[2])
            if hasattr(obj, "load"):  # _ByName reference
                obj = obj.load()
            funcs[msg[1]] = obj
            continue
        _op, task_id, func_name, args_d, kwargs_d, return_ids = msg
        try:
            fn = funcs[func_name]
            args = [_materialize(d, cache) for d in args_d]
            kwargs = {k: _materialize(d, cache)
                      for k, d in kwargs_d.items()}
            out = fn(*args, **kwargs)
            rets: Tuple = (out,) if len(return_ids) == 1 else tuple(out)
            descs: List[Tuple] = [_encode_result(v) for v in rets]
            comp.push(pickle.dumps(("done", task_id, descs),
                                   protocol=PICKLE_PROTO))
        except BaseException as exc:  # noqa: BLE001 - report, keep serving
            tb = traceback.format_exc()
            try:
                exc_bytes = pickle.dumps(exc, protocol=PICKLE_PROTO)
            except Exception:  # noqa: BLE001
                exc_bytes = None
            comp.push(pickle.dumps(
                ("err", task_id, exc_bytes, repr(exc), tb),
                protocol=PICKLE_PROTO))
        finally:
            # drop argument/result views before trimming so their
            # segment mappings become closable
            args = kwargs = out = rets = descs = None  # noqa: F841
            _trim_cache(cache)
