"""Buffer-first value serialization for the object stores.

Every stored value is classified once into a ``Payload``: a small header
(kind + dtype/shape metadata) plus one contiguous buffer. Array-likes
travel through the buffer protocol (no pickling, no copy at
classification time); everything else falls back to pickle protocol 5.
Values that cannot be pickled at all (locally-defined classes, closures)
are held *by reference* (``RAW``) — legal inside one process (the thread
backend), rejected with an actionable error the moment they would have
to cross a process boundary (the process backend's dispatch path).

The split between classification and materialization matters for the
thread hot path: ``Payload.wrap`` computes the kind and the exact buffer
byte count without serializing anything (``ndarray.nbytes``,
``len(bytes)``); the buffer itself is produced lazily — and exactly
once — by ``ensure_buffer()`` when a shared-memory store or a
cross-process instruction actually needs the bytes.

Decoding a buffer back into a value is zero-copy for arrays:
``np.frombuffer`` over the (possibly shared-memory) buffer, with the
``writeable`` flag cleared — a view handed out by the store is
read-only; mutation requires a fresh ``put()``.

A ``torch.Tensor`` is classified ``PKL`` with its exact ``nbytes`` (the
attribute ``memory.sizeof`` reads), and this module never imports torch.
The in-process store of the thread backend never serializes a ``PKL``
payload, so ``get()`` returns the very tensor that was stored and a CUDA
tensor stays on the card between tasks, with no host copy. Crossing into
a process-backend child would pickle it, and unpickling a CUDA tensor
would initialise CUDA in the child: device tasks run on the thread
backend, and only CPU data goes through the process backend.
"""
from __future__ import annotations

import pickle
from typing import Any, Optional, Tuple

try:  # numpy is a core dependency of the repo, but keep the gate cheap
    import numpy as _np
except Exception:  # pragma: no cover - numpy ships in the image
    _np = None

# payload kinds
ND = "nd"        # C-contiguous numpy array; meta = (dtype.str, shape)
BYTES = "bytes"  # bytes/bytearray; buffer is the value itself
PKL = "pkl"      # pickle protocol-5 fallback
RAW = "raw"      # unpicklable: held by reference, same-process only

#: Pickle protocol used everywhere (out-of-band-buffer capable).
PICKLE_PROTO = 5


class SpawnSafetyError(TypeError):
    """A value needed to cross a process boundary but cannot be
    pickled. The message names the offending object so the fix (move
    the function/class to module level, or pass plain data) is
    actionable."""


def _describe(value: Any) -> str:
    qual = getattr(value, "__qualname__", None) or type(value).__qualname__
    mod = getattr(value, "__module__", None) \
        or getattr(type(value), "__module__", "?")
    return f"{mod}.{qual}"


class Payload:
    """One stored value in (header, buffer) form.

    ``nbytes`` is the store-accounting footprint: the exact buffer
    length for array-likes and already-pickled values, a ``sizeof``
    estimate for RAW references (there is no buffer to measure).
    ``value`` keeps the live decoded object — the original on the
    producing side, the decode-once cache on the consuming side.
    """

    __slots__ = ("kind", "meta", "nbytes", "_buffer", "_value",
                 "segment", "_shm")

    def __init__(self, kind: str, meta: Optional[Tuple], nbytes: int,
                 buffer: Optional[Any] = None, value: Any = None,
                 segment: Optional[str] = None, shm: Any = None):
        self.kind = kind
        self.meta = meta
        self.nbytes = nbytes
        self._buffer = buffer
        self._value = value
        self.segment = segment   # shared-memory segment name, if any
        self._shm = shm          # owning SharedMemory handle, if any

    # ------------------------------------------------------------ creation

    @classmethod
    def wrap(cls, value: Any) -> "Payload":
        """Classify a value without serializing it. Exact byte counts
        for buffer-protocol types; pickling is deferred to
        ``ensure_buffer`` (and the unpicklable case is deferred with
        it — ``RAW`` is decided there, not here)."""
        if _np is not None and isinstance(value, _np.ndarray):
            dt = value.dtype
            # object/structured dtypes have no flat buffer — pickle them
            if dt.hasobject or _np.dtype(dt.str) != dt:
                return cls(PKL, None, _estimate(value), value=value)
            return cls(ND, (dt.str, value.shape), int(value.nbytes),
                       value=value)
        if isinstance(value, (bytes, bytearray)):
            return cls(BYTES, None, len(value), buffer=value, value=value)
        return cls(PKL, None, _estimate(value), value=value)

    @classmethod
    def from_buffer(cls, kind: str, meta: Optional[Tuple], buffer: Any,
                    segment: Optional[str] = None,
                    shm: Any = None) -> "Payload":
        """Wrap an already-serialized buffer (a transferred copy, a
        shared-memory mapping, an inline ring record)."""
        return cls(kind, meta, len(buffer), buffer=buffer,
                   segment=segment, shm=shm)

    # ------------------------------------------------------- serialization

    def ensure_buffer(self, strict: bool = False) -> Optional[Any]:
        """Produce (once) and return the serialized buffer. For ``PKL``
        payloads this is where pickling actually happens; an unpicklable
        value downgrades the payload to ``RAW`` and returns ``None`` —
        unless ``strict``, which raises ``SpawnSafetyError`` naming the
        offending object."""
        if self._buffer is not None:
            return self._buffer
        if self.kind == ND:
            arr = self._value
            if not arr.flags.c_contiguous:
                arr = _np.ascontiguousarray(arr)
            self._buffer = arr.data.cast("B")
        elif self.kind == PKL:
            try:
                buf = pickle.dumps(self._value, protocol=PICKLE_PROTO)
            except Exception as exc:
                if strict:
                    raise SpawnSafetyError(
                        f"value {_describe(self._value)} cannot be "
                        f"pickled and therefore cannot cross a process "
                        f"boundary: {exc}. Define the function/class at "
                        f"module level (not inside another function) or "
                        f"pass plain data instead.") from exc
                self.kind = RAW
                return None
            self._buffer = buf
            self.nbytes = len(buf)   # estimate -> exact
        elif self.kind == RAW:
            if strict:
                raise SpawnSafetyError(
                    f"value {_describe(self._value)} is held by "
                    f"reference (unpicklable) and cannot cross a "
                    f"process boundary.")
            return None
        return self._buffer

    # ------------------------------------------------------------ decoding

    def value(self) -> Any:
        """The live Python value: the original object when this payload
        was produced in-process, else a decode-once (cached) view over
        the buffer — zero-copy for arrays."""
        if self._value is None and self._buffer is not None:
            self._value = self._decode()
        return self._value

    def _decode(self) -> Any:
        if self.kind == ND:
            dtype_str, shape = self.meta
            arr = _np.frombuffer(self._buffer,
                                 dtype=_np.dtype(dtype_str)).reshape(shape)
            arr.flags.writeable = False
            return arr
        if self.kind == BYTES:
            buf = self._buffer
            return buf if isinstance(buf, bytes) else bytes(buf)
        if self.kind == PKL:
            return pickle.loads(self._buffer)
        raise TypeError(f"cannot decode payload kind {self.kind!r}")

    # -------------------------------------------------------------- misc

    def detach_value(self) -> None:
        """Drop the cached live object (keep the buffer) — used after a
        shared-memory put so the authoritative bytes are the segment's
        and a later get() decodes the same view a worker process sees."""
        if self._buffer is not None:
            self._value = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        seg = f" seg={self.segment}" if self.segment else ""
        return f"<Payload {self.kind} {self.nbytes}B{seg}>"


def _estimate(value: Any) -> int:
    from repro_torch.core.memory import sizeof
    return sizeof(value)
