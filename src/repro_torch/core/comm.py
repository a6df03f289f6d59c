"""Communication tasks, transports, and the background progress thread
(paper §4.4): the port's own copy of ``repro.core.comm``, carrying torch
tensors that may live on the card.

Specx integrates MPI into the task graph: send/recv become *communication
tasks* whose execution is delegated to a dedicated background thread that
starts non-blocking operations, polls them (MPI ``test``-style), and
releases dependencies as soon as a request completes — "the progression is
done as early as possible".

Transport architecture (the peer-to-peer data plane)
====================================================

* :class:`SpTransport` is the wire abstraction: ``post(key, msg)`` /
  ``poll(key)`` mailboxes keyed by ``(src, dst, tag)``.  ``poll`` is
  **non-blocking by contract** — the comm thread's start/test loop calls it
  on every request tick and must never sleep inside a transport.

* :class:`ChannelHub` is the in-process transport: rank-tagged Specx
  *instances* inside one process exchange live Python objects through
  locked deques.  Drained mailboxes are pruned on ``poll`` so per-step
  tags do not accumulate across a training run.

* :class:`SocketTransport` is the cross-process TCP transport — a true
  peer-to-peer data plane.  Payload bytes move over *direct* per-pair
  connections; rank 0 is only special during rendezvous and as a
  control-plane relay, never on the data path.

Address-exchange rendezvous
---------------------------
Every rank — including rank 0 — binds its **own data listener** on an
OS-assigned port, then dials rank 0's rendezvous socket (:class:`_Router`,
demoted from the old frame switch to an address server) and sends an
8-byte hello ``[u32 rank][u32 data_port]``.  Once all ``size`` hellos have
landed, the router broadcasts the **address book** — ``(rank, ip,
data_port)`` triples — to each rank over its rendezvous connection, which
stays open afterwards as that rank's *control link*.  Data connections are
dialed **lazily**: the first ``post`` to a peer dials its listener (a
4-byte hello carries the dialer's rank), and the connection is cached in a
per-peer link table for the life of the transport, so an N-rank job opens
only the links its communication pattern actually uses.

Frame wire format
-----------------
Every link — control or data — carries length-prefixed frames::

    [u32 len][u32 src][u32 dst][u32 taglen][tag bytes][payload bytes]

``tag`` is the canonical :func:`encode_message` spelling of the mailbox
tag; ``dst == _CTRL_RANK`` marks control frames (heartbeats, byes, death
gossip, the address book), whose tag tuple ``("__spctrl__", kind, ...)``
carries the whole message.  Senders never concatenate payload bytes:
:class:`SpSerializer` keeps a **scatter-gather segment list** (header
``bytes`` interleaved with zero-copy ``memoryview`` s of large array
buffers) and the transport hands the whole list to ``socket.sendmsg`` —
writev-style vectored I/O, batched at ``IOV_MAX`` entries with partial
sends resumed mid-segment (:func:`_sendv`).  Large tensors are *chunk
pipelined* one level up: ``dist.collectives.ring_all_reduce(...,
chunk_bytes=...)`` splits each ring step into fixed-size pieces that
travel as independent frames, so step *k+1* of one piece overlaps the
reduction of step *k* of another (transfer/compute overlap across the
ring, paper §4.4's comm-as-tasks made load-bearing).

Peer heartbeat / gossip contract
--------------------------------
Failure detection is **peer-observed**; no router sits on the data path
to observe it for you:

* Every transport's heartbeat thread sends ``hb`` control frames on *all*
  of its live links — the control link (so the rank-0 relay can watch
  ranks nobody has dialed) and every direct data link (so peers watch
  each other).  Each transport runs its own staleness monitor over its
  data links; the router runs one over the control links.
* **EOF without a goodbye** on any link (a SIGKILLed process's kernel
  closes its sockets) declares the peer dead at whichever endpoint saw it
  — in milliseconds, independent of heartbeat knobs.  A refused direct
  dial to a non-departed peer is the same signal.
* A locally-declared death is **gossiped**: a ``("dead", rank)`` control
  frame goes out on the control link and every data link; receivers mark
  the rank dead and forward once (the dead-set makes gossip idempotent,
  so storms terminate).  The router re-broadcasts to all control links,
  guaranteeing delivery even to pairs that never dialed each other.
  Graceful ``close()`` sends ``bye`` on every link first, and the router
  relays byes, so planned departures are never declared deaths.

Detection-latency knobs
-----------------------
``SocketTransport(heartbeat=interval, staleness_factor=k)`` declares a
silent rank dead after ``interval * k`` seconds (default ``0.5 s × 20 =
10 s``; ``REPRO_HB_INTERVAL`` overrides the interval fleet-wide, and
``heartbeat_timeout=`` pins the window directly).  Smaller windows
tighten elastic-recovery latency but risk false positives on loaded
hosts — a declared-dead rank is permanently evicted (its dials and
hellos are refused), so keep ``interval * k`` several times the worst
GC/GIL pause you expect.  EOF detection needs no tuning and dominates in
practice (SIGKILL → a few ms); heartbeats only
bound detection of alive-but-wedged (SIGSTOP'd) ranks.  Per-request
*recv* patience is a separate axis: ``timeout=`` on
``mpi_recv``/``mpi_broadcast`` or ``SpCommGroup(default_timeout=...)``.

:class:`RouterTransport` preserves the old hub-and-spoke star (every
frame forwarded through rank 0) purely as a measured baseline; new code
should never use it.

Wire format payload encoding: :func:`encode_message` / :func:`decode_message`
are the single canonical encoding used whenever a message must leave the
process — a typed, self-describing byte stream (``SpSerializer.append_obj``)
covering arrays, scalars, strings/bytes, pytrees (tuple/list/dict), and
tagged ``sp_serialize`` / ``comm_buffer`` objects.  Classes cross the wire
as *registered type names* (``register_wire_type``; auto-registered at pack
time and resolved by import on the receiving side), never as pickled
``type`` objects.

Tensors on the wire
-------------------
Payloads are torch tensors (numpy arrays are still accepted).  A CPU
tensor of a dtype numpy has (f16/f32/f64, i8–i64, u8, bool) goes out as
the same ``A`` frame ``repro`` writes for the equal numpy array — byte
for byte — and stays a zero-copy ``memoryview`` segment at or above
``_SEGMENT_MIN_BYTES``.  bf16, which numpy lacks, goes out as a ``W``
frame: the same header with the dtype *name* (``bfloat16``) and the raw
2-byte records, as ``checkpoint/manager.py`` stores bf16; ``repro``'s
decoder cannot read that frame.  A CUDA tensor is copied to the host
once, on the sending thread's current stream (the default stream every
worker launches on, so the copy is ordered after the kernels that wrote
it), and then travels as a CPU tensor.  Decoding gives writable CPU
tensors (``torch.frombuffer`` over a writable frame buffer, else over a
private copy); :class:`SpCommGroup` ``device=`` moves what a receive
delivers onto the group's device.

Timeout semantics: ``mpi_recv`` / ``mpi_broadcast`` accept ``timeout=``
(seconds, default :attr:`SpCommGroup.default_timeout`); a request whose
peer never posts fails with :class:`SpCommTimeoutError` *as the task's
exception* — observable via ``TaskView.exception()`` and re-raised by
``wait_all_tasks`` — instead of spinning the comm thread forever.
``CommThread.stop()`` likewise no longer abandons in-flight requests: after
a grace period it aborts them with :class:`SpCommAbortedError` and reports
the affected task names.

Once a rank is dead: ``post`` to it and
``poll`` of an empty mailbox whose source is dead raise
:class:`SpRankDeadError` — so every *pending* receive fails on its next
comm-thread tick and every *future* request fails immediately, and
dependent tasks cancel transitively exactly as timeouts do.
:class:`SpCommTransientError` marks retryable link faults (used by the
fault-injection harness in ``repro_torch.dist.fault``, which wraps per-peer
streams; retry/backoff lives there in ``RetryingTransport``).  All
communication failures derive from :class:`SpCommError`, so callers can
catch one type.

Note on access modes: the paper's prose says a send "does a write access"
and a receive "performs a read access"; that is logically inverted (a recv
must order subsequent readers after it).  We implement send=READ,
recv=WRITE, which matches the paper's *behavioural* description of
dependency release.

Speculation is refused on communication (paper §4.4 last paragraph).
"""
from __future__ import annotations

import collections
import functools
import importlib
import os
import socket
import struct
import threading
import time
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .access import AccessMode, SpAccess, SpData
from .graph import SpSpeculativeModel, SpTaskGraph
from .task import Task, TaskState, TaskView


class SpCommError(RuntimeError):
    """Base class for communication-layer failures."""


class SpCommTimeoutError(SpCommError):
    """A receive's deadline passed with no matching message posted."""


class SpCommAbortedError(SpCommError):
    """The comm thread was stopped while this request was still in flight."""


class SpRankDeadError(SpCommError):
    """A peer rank died (EOF without goodbye, missed heartbeats, or a retry
    budget exhausted) — requests addressed to it will never complete."""


class SpCommTransientError(SpCommError):
    """A retryable link fault: a send that failed in a way a bounded
    retry-with-backoff may recover from (injected drops, flaky links)."""


# ---------------------------------------------------------------------------
# Registered-type table: classes cross the wire as names, not type objects.
# ---------------------------------------------------------------------------

_WIRE_TYPES: dict[str, type] = {}


def register_wire_type(cls: type | None = None, *, name: str | None = None):
    """Register ``cls`` for tagged (``sp_serialize`` / ``comm_buffer``)
    transfer.  Usable as a decorator.  Registration is automatic at pack
    time; the receiving process resolves unknown names by importing
    ``module:qualname``, so explicit registration is only needed for names
    that are not importable (e.g. classes defined inside a function)."""

    def reg(c: type):
        key = name or f"{c.__module__}:{c.__qualname__}"
        _WIRE_TYPES[key] = c
        c._sp_wire_name_ = key
        return c

    return reg if cls is None else reg(cls)


def _wire_name(cls: type) -> str:
    key = cls.__dict__.get("_sp_wire_name_")
    if key is None or _WIRE_TYPES.get(key) is not cls:
        register_wire_type(cls)
        key = cls.__dict__["_sp_wire_name_"]
    return key


def resolve_wire_type(name: str) -> type:
    """Name → class: registry first, then ``module:qualname`` import."""
    cls = _WIRE_TYPES.get(name)
    if cls is None:
        modname, _, qual = name.partition(":")
        obj: Any = importlib.import_module(modname)
        for part in qual.split("."):
            obj = getattr(obj, part)
        cls = obj
        _WIRE_TYPES[name] = cls
    return cls


# ---------------------------------------------------------------------------
# Serialization (paper §4.4 rules 1–3) — the canonical wire codec.
# ---------------------------------------------------------------------------

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# Arrays at or above this many bytes travel as zero-copy memoryview
# segments; below it a tobytes() copy is cheaper than an extra iovec.
_SEGMENT_MIN_BYTES = 1024


# numpy dtype string <-> torch dtype: the A frame's header speaks numpy's
# spelling, so a CPU tensor and the equal numpy array encode alike
_NP_TO_TORCH = {
    np.dtype(n).str: t
    for n, t in (
        ("float16", torch.float16), ("float32", torch.float32),
        ("float64", torch.float64), ("int8", torch.int8),
        ("int16", torch.int16), ("int32", torch.int32),
        ("int64", torch.int64), ("uint8", torch.uint8),
        ("bool", torch.bool), ("complex64", torch.complex64),
        ("complex128", torch.complex128),
    )
}
_TORCH_TO_NP = {t: s for s, t in _NP_TO_TORCH.items()}
# dtypes numpy lacks travel by name in a W frame (raw records)
_NAMED = {"bfloat16": torch.bfloat16}
_NAMED_INV = {t: n for n, t in _NAMED.items()}


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` detached, on the host and contiguous.  A CUDA tensor costs one
    device-to-host copy on this thread's current stream of its device —
    ordered after every kernel already queued there, so a producer's
    pending write lands before the bytes are read."""
    return t.detach().to("cpu").contiguous()


def _frame_code(arr) -> bytes:
    """``W`` for a tensor of a dtype numpy lacks, else ``A``."""
    return b"W" if isinstance(arr, torch.Tensor) and arr.dtype in _NAMED_INV else b"A"


def _tensor_frame(t: torch.Tensor) -> tuple[bytes, bytes | memoryview]:
    """(header chunk, payload) of a tensor's array frame."""
    t = _host_tensor(t)
    token = _TORCH_TO_NP.get(t.dtype) or _NAMED_INV.get(t.dtype)
    if token is None:
        raise TypeError(f"cannot serialize a tensor of dtype {t.dtype} for the wire")
    header = f"{token}|{','.join(map(str, t.shape))}|".encode()
    nbytes = t.numel() * t.element_size()
    raw = t.reshape(-1).view(torch.uint8) if t.numel() else t.new_empty(0, dtype=torch.uint8)
    if nbytes >= _SEGMENT_MIN_BYTES:
        payload = memoryview(raw.numpy()).cast("B")  # zero-copy view of t
    else:
        payload = raw.numpy().tobytes()
    return len(header).to_bytes(4, "little") + header, payload


class SpSerializer:
    """Packs values into one flat byte buffer — the paper's "single array
    suitable for communication".

    ``append_array`` / ``append_scalar`` write the legacy raw array frame
    (header + bytes), used by ``sp_serialize`` implementations.
    ``append_obj`` writes the typed, self-describing encoding used for
    whole messages (:func:`encode_message`).

    Scatter-gather: the serializer holds a *segment list*, not one
    growing buffer.  Small fields are ``bytes``; array payloads at or
    above ``_SEGMENT_MIN_BYTES`` stay as zero-copy ``memoryview`` s of
    the source buffer (kept alive by the view; for a CUDA tensor, of its
    host copy).  :meth:`segments` hands the list to vectored sends
    (``socket.sendmsg``); :meth:`buffer` joins it for callers that need
    one contiguous ``bytes``."""

    def __init__(self):
        self._chunks: list[bytes | memoryview] = []

    def append_array(self, arr) -> None:
        """Header and payload of ``arr``: a tensor, or anything numpy can
        view (a numpy dtype torch lacks keeps numpy's own header)."""
        t = arr
        if not isinstance(arr, torch.Tensor):
            a = np.asarray(arr)
            if not a.flags["C_CONTIGUOUS"]:
                a = np.ascontiguousarray(a)
            if a.dtype.str not in _NP_TO_TORCH:
                header = f"{a.dtype.str}|{','.join(map(str, a.shape))}|".encode()
                self._chunks.append(len(header).to_bytes(4, "little") + header)
                self._chunks.append(
                    memoryview(a).cast("B") if a.nbytes >= _SEGMENT_MIN_BYTES else a.tobytes()
                )
                return
            t = torch.from_numpy(a)  # shares a's buffer
        head, payload = _tensor_frame(t)
        self._chunks.append(head)
        self._chunks.append(payload)

    def append_scalar(self, x) -> None:
        self.append_array(x if isinstance(x, torch.Tensor) else np.asarray(x))

    def append_obj(self, obj: Any) -> None:
        """Typed encoding: 1-byte tag, then a tag-specific payload.  Covers
        None/bool/int/float/str/bytes, tuples/lists/dicts (pytrees), torch
        tensors, numpy and numpy-convertible arrays, and tagged
        serializable objects."""
        c = self._chunks
        if obj is None:
            c.append(b"N")
        elif isinstance(obj, bool):
            c.append(b"b\x01" if obj else b"b\x00")
        elif isinstance(obj, int):
            if _I64_MIN <= obj <= _I64_MAX:
                c.append(b"I" + _I64.pack(obj))
            else:
                enc = str(obj).encode()
                c.append(b"J" + _U32.pack(len(enc)) + enc)
        elif isinstance(obj, float):
            c.append(b"F" + _F64.pack(obj))
        elif isinstance(obj, str):
            enc = obj.encode()
            c.append(b"S" + _U32.pack(len(enc)) + enc)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            raw = bytes(obj)
            c.append(b"B" + _U32.pack(len(raw)) + raw)
        elif isinstance(obj, tuple):
            c.append(b"T" + _U32.pack(len(obj)))
            for v in obj:
                self.append_obj(v)
        elif isinstance(obj, list):
            c.append(b"L" + _U32.pack(len(obj)))
            for v in obj:
                self.append_obj(v)
        elif isinstance(obj, dict):
            c.append(b"D" + _U32.pack(len(obj)))
            for k, v in obj.items():
                self.append_obj(k)
                self.append_obj(v)
        elif isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
            self._frame(obj)
        elif hasattr(obj, "sp_serialize"):
            inner = SpSerializer()
            obj.sp_serialize(inner)
            self._append_tagged(b"O", _wire_name(type(obj)), inner.buffer())
        elif hasattr(obj, "comm_buffer"):
            self._append_tagged(b"C", _wire_name(type(obj)), bytes(obj.comm_buffer()))
        else:
            # last resort: anything numpy can view as a numeric array
            # (array-likes) travels as an array
            a = np.asarray(obj)
            if a.dtype == object:
                raise TypeError(
                    f"cannot serialize {type(obj).__name__!r} for the wire; "
                    "use arrays/scalars/pytrees or implement sp_serialize/"
                    "comm_buffer"
                )
            self._frame(a)

    def _frame(self, arr) -> None:
        self._chunks.append(_frame_code(arr))
        self.append_array(arr)

    def _append_tagged(self, code: bytes, name: str, buf: bytes) -> None:
        enc = name.encode()
        self._chunks.append(
            code + _U32.pack(len(enc)) + enc + _U32.pack(len(buf)) + buf
        )

    def buffer(self) -> bytes:
        return b"".join(self._chunks)

    def segments(self) -> list[bytes | memoryview]:
        """The scatter-gather segment list, in wire order (empty chunks
        dropped: a zero-length iovec at the end would stall ``_sendv``)."""
        return [c for c in self._chunks if len(c)]

    @property
    def nbytes(self) -> int:
        return sum(len(c) for c in self._chunks)


class SpDeserializer:
    """Decodes a wire stream from ``bytes`` *or* any buffer (``bytearray``,
    ``memoryview``) — the receive path hands in the recv buffer directly so
    array payloads are sliced without an intermediate ``bytes`` copy."""

    def __init__(self, buf):
        self._buf = buf if isinstance(buf, (bytes, memoryview)) else memoryview(buf)
        self._pos = 0

    def _take_view(self, n: int):
        """A zero-copy slice of the stream (bytes or memoryview)."""
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def _take(self, n: int) -> bytes:
        return bytes(self._take_view(n))

    def _take_u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def next_array(self):
        """The next array frame as a writable CPU tensor (a numpy array for
        a numpy dtype torch lacks)."""
        hlen = self._take_u32()
        header = self._take(hlen).decode()
        # rsplit: one-byte dtypes spell their byte order "|" ("|b1", "|u1"),
        # which a plain split mistakes for the field separator
        dtype_str, shape_str, _ = header.rsplit("|", 2)
        shape = tuple(int(s) for s in shape_str.split(",") if s)
        tdt = _NAMED.get(dtype_str) or _NP_TO_TORCH.get(dtype_str)
        if tdt is None:
            dt = np.dtype(dtype_str)
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            return np.frombuffer(self._take_view(n), dtype=dt).copy().reshape(shape)
        itemsize = torch.empty((), dtype=tdt).element_size()
        n = int(np.prod(shape, dtype=np.int64)) * itemsize
        view = self._take_view(n)
        if not n:
            return torch.empty(shape, dtype=tdt)
        if isinstance(view, bytes) or view.readonly:
            # immutable source (a bytes frame): consumers own mutable
            # tensors, so pay for a private copy.  The p2p receive path
            # hands us a per-frame writable buffer nobody else holds —
            # there frombuffer's view is already exclusively ours and the
            # copy is skipped (zero-copy decode).
            view = bytearray(view)
        return torch.frombuffer(view, dtype=tdt).reshape(shape)

    def next_obj(self) -> Any:
        code = self._take(1)
        if code == b"N":
            return None
        if code == b"b":
            return self._take(1) == b"\x01"
        if code == b"I":
            return _I64.unpack(self._take(8))[0]
        if code == b"J":
            return int(self._take(self._take_u32()).decode())
        if code == b"F":
            return _F64.unpack(self._take(8))[0]
        if code == b"S":
            return self._take(self._take_u32()).decode()
        if code == b"B":
            return self._take(self._take_u32())
        if code == b"T":
            n = self._take_u32()
            return tuple(self.next_obj() for _ in range(n))
        if code == b"L":
            n = self._take_u32()
            return [self.next_obj() for _ in range(n)]
        if code == b"D":
            n = self._take_u32()
            return {self.next_obj(): self.next_obj() for _ in range(n)}
        if code in (b"A", b"W"):
            return self.next_array()
        if code == b"O":
            name = self._take(self._take_u32()).decode()
            inner = self._take_view(self._take_u32())
            return resolve_wire_type(name).sp_deserialize(SpDeserializer(inner))
        if code == b"C":
            name = self._take(self._take_u32()).decode()
            buf = self._take(self._take_u32())
            return resolve_wire_type(name).from_comm_buffer(buf)
        raise ValueError(f"corrupt wire stream: unknown type code {code!r}")


def encode_message(obj: Any) -> bytes:
    """Canonical wire encoding of one message (any :meth:`append_obj`-able
    value, including :func:`pack`'s tagged tuples)."""
    s = SpSerializer()
    s.append_obj(obj)
    return s.buffer()


def encode_segments(obj: Any) -> tuple[list[bytes | memoryview], int]:
    """Scatter-gather encoding of one message: ``(segments, total_bytes)``.
    Large array payloads stay zero-copy ``memoryview`` s of their source
    buffers — valid until the next mutation of those arrays, so send
    before releasing the message."""
    s = SpSerializer()
    s.append_obj(obj)
    segs = s.segments()
    return segs, sum(len(c) for c in segs)


def decode_message(buf) -> Any:
    """Decode one message from ``bytes`` or any readable buffer."""
    return SpDeserializer(buf).next_obj()


def pack(obj: Any) -> Any:
    """Apply the paper's three rules: (1) trivially-copyable values (arrays,
    scalars, pytrees of them) pass through; (2) objects exposing
    ``comm_buffer()`` send that buffer; (3) objects with ``sp_serialize``
    use the serializer.  Tagged payloads carry the *registered type name*
    (a string), so they survive :func:`encode_message` across processes."""
    if hasattr(obj, "sp_serialize"):
        s = SpSerializer()
        obj.sp_serialize(s)
        return ("__serialized__", _wire_name(type(obj)), s.buffer())
    if hasattr(obj, "comm_buffer"):
        return ("__buffer__", _wire_name(type(obj)), obj.comm_buffer())
    # rule 1: in-process the live object travels, uncopied.  Tensors are
    # mutable, so the receiver aliases what was sent: senders must not
    # write a sent tensor in place (the ring collectives never do)
    return obj


def _resolve(cls_or_name) -> type:
    # raw type objects still accepted for in-process backward compatibility
    return resolve_wire_type(cls_or_name) if isinstance(cls_or_name, str) else cls_or_name


def unpack(msg: Any) -> Any:
    if isinstance(msg, tuple) and len(msg) == 3 and msg[0] == "__serialized__":
        _, cls, buf = msg
        return _resolve(cls).sp_deserialize(SpDeserializer(buf))
    if isinstance(msg, tuple) and len(msg) == 3 and msg[0] == "__buffer__":
        _, cls, buf = msg
        return _resolve(cls).from_comm_buffer(buf)
    return msg


# ---------------------------------------------------------------------------
# Transports.
# ---------------------------------------------------------------------------

class SpTransport:
    """Abstract wire: mailboxes keyed by ``(src, dst, tag)``.

    ``poll`` must be non-blocking — it is called from the comm thread's
    test loop on every tick."""

    def post(self, key: tuple, msg: Any) -> None:
        raise NotImplementedError

    def post_all(self, keys: list, msg: Any) -> None:
        """Post one message to many keys (broadcast fan-out).  Encoding
        transports override this to serialize the payload once."""
        for key in keys:
            self.post(key, msg)

    def poll(self, key: tuple) -> tuple[bool, Any]:
        """Return ``(True, msg)`` if a message is queued for ``key``, else
        ``(False, None)`` — immediately, never waiting on a peer.  May
        raise :class:`SpRankDeadError` when the key's source rank is known
        dead and nothing is queued."""
        raise NotImplementedError

    # -- failure detection (no-ops on transports without a notion of ranks)

    @property
    def dead_ranks(self) -> frozenset:
        """Ranks this transport knows to be dead."""
        return frozenset()

    def mark_dead(self, rank: int) -> None:
        """Record ``rank`` as dead (idempotent)."""

    def is_dead(self, rank: int) -> bool:
        return rank in self.dead_ranks

    def death_detected_at(self, rank: int) -> Optional[float]:
        """``time.monotonic()`` of the moment ``rank`` was marked dead
        here, or None — the detection-latency probe for benchmarks."""
        return None

    def stats(self) -> dict:
        return {}

    def reset(self) -> None:
        pass

    def close(self) -> None:
        pass


class _LockedMailboxes(SpTransport):
    """Shared mailbox half of both transports: locked deques keyed by the
    transport's spelling of ``(src, dst, tag)`` (:meth:`_box_key`), with
    prune-on-drain — per-step tags (every ring collective step mints fresh
    ones) must not leak across a training run."""

    def __init__(self):
        self._boxes: dict[tuple, collections.deque] = {}
        self._lock = threading.Lock()
        self._posted = 0
        self._delivered = 0
        self._dead: set[int] = set()
        self._dead_at: dict[int, float] = {}

    def _box_key(self, key: tuple) -> tuple:
        return key

    @property
    def dead_ranks(self) -> frozenset:
        with self._lock:
            return frozenset(self._dead)

    def mark_dead(self, rank: int) -> None:
        with self._lock:
            if rank in self._dead:
                return
            self._dead.add(rank)
            self._dead_at[rank] = time.monotonic()

    def death_detected_at(self, rank: int) -> Optional[float]:
        with self._lock:
            return self._dead_at.get(rank)

    def _deposit(self, boxkey: tuple, msg: Any, counter: str | None = None) -> None:
        with self._lock:
            self._boxes.setdefault(boxkey, collections.deque()).append(msg)
            if counter is not None:  # counted under the lock: stats must not
                setattr(self, counter, getattr(self, counter) + 1)  # drop updates

    def poll(self, key: tuple):
        boxkey = self._box_key(key)
        with self._lock:
            box = self._boxes.get(boxkey)
            if box:
                msg = box.popleft()
                if not box:  # prune: drained keys must not accumulate
                    del self._boxes[boxkey]
                self._delivered += 1
                return True, msg
            # already-queued messages from a now-dead rank stay deliverable;
            # an *empty* mailbox whose source is dead will never fill — fail
            # the poller fast instead of letting it wait out its timeout
            src = key[0]
            if src in self._dead:
                raise SpRankDeadError(
                    f"rank {src} is dead; nothing further will arrive"
                )
        return False, None

    def stats(self) -> dict:
        with self._lock:
            return {
                "boxes": len(self._boxes),
                "queued": sum(len(b) for b in self._boxes.values()),
                "posted": self._posted,
                "delivered": self._delivered,
            }

    def reset(self) -> None:
        """Drop all queued messages, counters, and dead-rank state
        (fresh-run hygiene for shared hubs, notably the module default)."""
        with self._lock:
            self._boxes.clear()
            self._posted = 0
            self._delivered = 0
            self._dead.clear()
            self._dead_at.clear()


class ChannelHub(_LockedMailboxes):
    """In-process transport: messages are live Python objects (rule 1: no
    copy inside one process) dropped straight into the local mailboxes.

    A tensor is *not* copied: the receiver aliases the sender's storage.
    Torch tensors are mutable, so a sender must not write a tensor in place
    after posting it (the ring codelets allocate every sum and rebind
    cells instead).  A receiving :class:`SpCommGroup` with ``device=``
    moves a tensor from another device onto its own; one already there
    passes through uncopied."""

    def post(self, key: tuple, msg: Any) -> None:
        dst = key[1]
        with self._lock:
            dead = dst in self._dead
        if dead:
            raise SpRankDeadError(f"cannot send to rank {dst}: rank is dead")
        self._deposit(key, msg, "_posted")


_default_hub = ChannelHub()


def default_hub() -> ChannelHub:
    """The module-wide fallback hub used by :class:`SpCommGroup` when no
    transport is passed.  Call :func:`reset_default_hub` between runs that
    share it — undelivered messages otherwise survive into the next run."""
    return _default_hub


def reset_default_hub() -> None:
    _default_hub.reset()


# --------------------------------------------------------------- TCP star

_FRAME_HDR = struct.Struct("<III")  # src, dst, len(tag_bytes)

# control-plane pseudo-rank: frames to/from the router itself.  Transports
# send ("__spctrl__", "hb") / ("__spctrl__", "bye") frames *to* it; the
# router sends ("__spctrl__", "dead", rank) frames *from* it.
_CTRL_RANK = 0xFFFFFFFF


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        buf += chunk
    return bytes(buf)


@functools.lru_cache(maxsize=4096)
def _tag_bytes(tag: Any) -> bytes:
    """Canonical on-wire spelling of a tag (int / str / tuple / ...) —
    both ends derive mailbox keys from this, so any encodable tag matches.
    Memoized: the comm thread re-polls pending receives every tick, and
    re-encoding the same tag thousands of times per second is pure waste
    (tags are hashable by construction — they already key mailbox dicts)."""
    return encode_message(tag)


def _recv_into(sock: socket.socket, n: int) -> memoryview:
    """Receive exactly ``n`` bytes into one fresh buffer (no per-chunk
    joins).  The buffer is ``np.empty`` rather than ``bytearray(n)`` —
    malloc without the memset: a ``bytearray`` zero-fills every frame
    before ``recv_into`` overwrites it, a full extra pass over large
    tensor payloads.  Returned as a writable memoryview so the zero-copy
    decode path (``SpDeserializer``) can hand out views instead of
    copies."""
    buf = memoryview(np.empty(n, dtype=np.uint8)).cast("B")
    got = 0
    while got < n:
        r = sock.recv_into(buf[got:])
        if r == 0:
            raise ConnectionError("peer closed the connection")
        got += r
    return buf


# Linux's writev/sendmsg vector-count ceiling; longer segment lists are
# sent in batches of this many iovecs.
_IOV_MAX = 1024


def _sendv(sock: socket.socket, segments: Sequence) -> None:
    """Vectored (writev-style) send of a scatter-gather segment list via
    ``socket.sendmsg`` — no join, no payload copy.  Handles partial sends
    by resuming mid-segment and batches at :data:`_IOV_MAX` entries."""
    views = [s if isinstance(s, memoryview) else memoryview(s) for s in segments]
    if not hasattr(sock, "sendmsg"):  # pragma: no cover - non-POSIX fallback
        sock.sendall(b"".join(views))
        return
    i = 0
    while i < len(views):
        n = sock.sendmsg(views[i : i + _IOV_MAX])
        while n > 0:
            first = views[i]
            if n >= len(first):
                n -= len(first)
                i += 1
            else:
                views[i] = first[n:]
                n = 0


def _close_listener(sock: socket.socket) -> None:
    """Close a listening socket and wake the thread blocked in its
    ``accept()``: on Linux ``close()`` alone leaves that call blocked (the
    thread then outlives the transport), ``shutdown()`` makes it fail."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # not connected / already closed: nothing blocked on it
    try:
        sock.close()
    except OSError:  # pragma: no cover - already closed
        pass


def _ctrl_frame(src: int, dst: int, tag_b: bytes) -> bytes:
    body = _FRAME_HDR.pack(src, dst, len(tag_b)) + tag_b
    return _U32.pack(len(body)) + body


def _resolve_hb_knobs(
    heartbeat: float | None,
    staleness_factor: float | None,
    heartbeat_interval: float | None,
    heartbeat_timeout: float | None,
) -> tuple[float, float]:
    """Resolve the detection-latency knobs.  ``heartbeat`` is the
    short spelling, ``heartbeat_interval`` the original one — passing both
    is ambiguous.  Precedence: explicit kwarg > REPRO_HB_INTERVAL env >
    0.5 s default.  The staleness window defaults to 20 heartbeats so the
    historical 0.5 s → 10 s pairing is preserved; an explicit
    ``heartbeat_timeout`` wins over ``staleness_factor``."""
    if heartbeat is not None and heartbeat_interval is not None:
        raise ValueError("pass heartbeat= or heartbeat_interval=, not both")
    if heartbeat_timeout is not None and staleness_factor is not None:
        raise ValueError("pass heartbeat_timeout= or staleness_factor=, not both")
    interval = heartbeat if heartbeat is not None else heartbeat_interval
    if interval is None:
        env = os.environ.get("REPRO_HB_INTERVAL", "").strip()
        interval = float(env) if env else 0.5
    if interval <= 0.0:
        raise ValueError(f"heartbeat interval must be > 0, got {interval}")
    if heartbeat_timeout is None:
        factor = 20.0 if staleness_factor is None else staleness_factor
        if factor <= 1.0:
            raise ValueError(f"staleness_factor must be > 1, got {factor}")
        heartbeat_timeout = interval * factor
    return interval, heartbeat_timeout


class _Router(threading.Thread):
    """Rank 0's *address-exchange* rendezvous and control-plane relay —
    demoted from the old frame switch; it never touches payload bytes.

    Accepts one connection per rank (hello = ``[u32 rank][u32
    data_port]``), and once all ``size`` ranks are in, sends each the
    address book — ``(rank, ip, data_port)`` triples, the ip observed on
    the rendezvous connection — over that same connection, which then
    stays open as the rank's *control link*.  Afterwards it only relays
    control gossip: ``hb`` refreshes the sender's last-seen stamp (its
    monitor declares staleness deaths for ranks nobody dialed), ``bye``
    marks a graceful leave and is re-broadcast, and ``dead`` declarations
    — local EOF, staleness, or peer-reported — are re-broadcast to every
    control link so death news reaches pairs with no direct link."""

    def __init__(self, host: str, port: int, size: int, *, heartbeat_timeout: float = 10.0):
        super().__init__(name="sprendezvous", daemon=True)
        self._size = size
        self._hb_timeout = heartbeat_timeout
        self._listener = socket.create_server((host, port), backlog=size)
        self.port = self._listener.getsockname()[1]
        self._conns: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._lock = threading.Lock()  # conns / ports / last_seen / dead / graceful
        self._ports: dict[int, tuple[str, int]] = {}  # rank -> (ip, data_port)
        self._all_in = threading.Event()
        self._closing = False
        self._last_seen: dict[int, float] = {}
        self._graceful: set[int] = set()
        self.dead: set[int] = set()
        self._readers: list[threading.Thread] = []

    def run(self) -> None:
        try:
            while not self._closing:
                conn, addr = self._listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                rank, data_port = struct.unpack("<II", _recv_exact(conn, 8))
                with self._lock:
                    refuse = rank in self.dead or rank in self._conns
                    if not refuse:
                        self._conns[rank] = conn
                        self._send_locks[rank] = threading.Lock()
                        self._last_seen[rank] = time.monotonic()
                        self._ports[rank] = (addr[0], data_port)
                        n_in = len(self._conns)
                if refuse:  # protocol breach: duplicate hello / dead rank
                    warnings.warn(
                        f"router: refusing hello for rank {rank} "
                        "(duplicate or already declared dead)",
                        RuntimeWarning,
                    )
                    conn.close()
                    continue
                if self._all_in.is_set():
                    # late joiner (elastic rejoin): refresh everyone's book
                    self._broadcast_book()
                    self._start_reader(rank, conn)
                elif n_in == self._size:
                    self._all_in.set()
                    self._broadcast_book()
                    with self._lock:
                        ready = list(self._conns.items())
                    for r, c in ready:
                        self._start_reader(r, c)
                    threading.Thread(
                        target=self._monitor, name="sprendezvous-hb", daemon=True
                    ).start()
        except (ConnectionError, OSError) as e:
            if not self._closing and not self._all_in.is_set():
                # a rank died mid-rendezvous: the job cannot form — fail
                # loudly instead of leaving a half-dead router thread behind
                warnings.warn(
                    f"router: rendezvous failed ({e!r}); closing all connections",
                    RuntimeWarning,
                )
                with self._lock:
                    conns = list(self._conns.values())
                for c in conns:
                    c.close()
        finally:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover - already closed
                pass
        for t in list(self._readers):
            t.join()

    def _start_reader(self, rank: int, conn: socket.socket) -> None:
        t = threading.Thread(
            target=self._ctrl_from, args=(rank, conn),
            name=f"sprendz-{rank}", daemon=True,
        )
        self._readers.append(t)
        t.start()

    def soft_close(self) -> None:
        """Stop accepting and monitoring; control links stay up until each
        peer hangs up (rank 0 may finish first)."""
        self._closing = True
        _close_listener(self._listener)

    # -- control plane -------------------------------------------------------

    def _broadcast_book(self) -> None:
        with self._lock:
            book = [[r, ip, p] for r, (ip, p) in sorted(self._ports.items())]
            targets = [
                (r, self._conns[r], self._send_locks[r]) for r in self._conns
            ]
        tag_b = encode_message(("__spctrl__", "book", book))
        for r, c, lk in targets:
            try:
                with lk:
                    c.sendall(_ctrl_frame(_CTRL_RANK, r, tag_b))
            except OSError:  # pragma: no cover - peer already gone
                pass

    def _broadcast_ctrl(self, ctrl: tuple) -> None:
        with self._lock:
            targets = [
                (r, self._conns[r], self._send_locks[r]) for r in self._conns
            ]
        tag_b = encode_message(ctrl)
        for r, c, lk in targets:
            try:
                with lk:
                    c.sendall(_ctrl_frame(_CTRL_RANK, r, tag_b))
            except OSError:  # pragma: no cover - survivor also going away
                pass

    def _ctrl_from(self, rank: int, conn: socket.socket) -> None:
        try:
            while True:
                (n,) = _U32.unpack(_recv_exact(conn, 4))
                body = _recv_exact(conn, n)
                _src, dst, taglen = _FRAME_HDR.unpack_from(body, 0)
                if dst != _CTRL_RANK:
                    continue  # no data forwarding on the control plane
                off = _FRAME_HDR.size
                ctrl = decode_message(body[off : off + taglen])
                kind = ctrl[1]
                if kind == "hb":
                    with self._lock:
                        self._last_seen[rank] = time.monotonic()
                elif kind == "bye":
                    with self._lock:
                        self._graceful.add(rank)
                    self._broadcast_ctrl(("__spctrl__", "bye", rank))
                elif kind == "dead":
                    self._declare_dead(
                        int(ctrl[2]), f"reported dead by rank {rank}"
                    )
        except (ConnectionError, OSError):
            pass  # rank hung up
        finally:
            with self._lock:
                graceful = rank in self._graceful
                current = self._conns.get(rank) is conn
                if current:
                    del self._conns[rank]
                    self._send_locks.pop(rank, None)
            try:
                conn.close()
            except OSError:  # pragma: no cover - already closed
                pass
            if current and not graceful and not self._closing:
                # EOF without a goodbye: the process died under us
                self._declare_dead(rank, "connection lost without goodbye")

    # -- failure detector ----------------------------------------------------

    def _monitor(self) -> None:
        interval = max(self._hb_timeout / 4.0, 0.02)
        while not self._closing:
            time.sleep(interval)
            now = time.monotonic()
            with self._lock:
                stale = [
                    r
                    for r, seen in self._last_seen.items()
                    if r in self._conns
                    and r not in self._graceful
                    and r not in self.dead
                    and now - seen > self._hb_timeout
                ]
            for r in stale:
                self._declare_dead(
                    r, f"no heartbeat for more than {self._hb_timeout}s"
                )

    def _declare_dead(self, rank: int, why: str) -> None:
        with self._lock:
            if rank in self.dead:
                return
            self.dead.add(rank)
            conn = self._conns.pop(rank, None)
            self._send_locks.pop(rank, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:  # pragma: no cover - already closed
                pass
        warnings.warn(
            f"router: declaring rank {rank} dead ({why})", RuntimeWarning
        )
        self._broadcast_ctrl(("__spctrl__", "dead", rank))


class _PeerLink:
    """One cached direct connection to a peer: socket, write lock, and the
    reader thread draining it into the local mailboxes."""

    __slots__ = ("rank", "sock", "wlock", "reader")

    def __init__(self, rank: int, sock: socket.socket):
        self.rank = rank
        self.sock = sock
        self.wlock = threading.Lock()
        self.reader: Optional[threading.Thread] = None


class SocketTransport(_LockedMailboxes):
    """Cross-process TCP transport — the peer-to-peer data plane.

    Rendezvous is address-exchange only (see the module docstring): every
    rank binds its own data listener, rank 0's :class:`_Router` hands out
    the address book, and ``post`` lazily dials the destination's listener
    and caches the connection.  Frames are written with vectored I/O from
    the serializer's scatter-gather segment list; a reader thread per link
    drains frames into local mailboxes, so ``poll`` is a pure dict lookup
    — non-blocking, as the comm thread's test loop requires.  Failure
    detection is peer-observed (EOF / heartbeat staleness on each link)
    with death gossip relayed over the control plane."""

    def __init__(
        self,
        rank: int,
        size: int,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        connect_timeout: float = 10.0,
        max_dial_retries: int = 100,
        heartbeat: float | None = None,
        staleness_factor: float | None = None,
        heartbeat_interval: float | None = None,
        heartbeat_timeout: float | None = None,
    ):
        super().__init__()
        interval, hb_timeout = _resolve_hb_knobs(
            heartbeat, staleness_factor, heartbeat_interval, heartbeat_timeout
        )
        self.rank, self.size, self.host = rank, size, host
        self._received = 0
        self._closed = False
        self._connect_timeout = connect_timeout
        self._hb_interval = interval
        self._hb_timeout = hb_timeout
        self._router: Optional[_Router] = None
        if rank == 0:
            self._router = _Router(host, port, size, heartbeat_timeout=hb_timeout)
            self._router.start()
            port = self._router.port
        elif port == 0:
            raise ValueError("non-root ranks must be told the rendezvous port")
        self.port = port

        # the p2p plane: every rank is a server for its peers
        self._listener = socket.create_server((host, 0), backlog=max(size, 8))
        self.data_port = self._listener.getsockname()[1]

        # the rendezvous may not be listening yet — dial with a bounded
        # retry count and exponential backoff
        deadline = time.monotonic() + connect_timeout
        delay, attempts = 0.01, 0
        while True:
            try:
                self._sock = socket.create_connection((host, port), timeout=connect_timeout)
                break
            except OSError as e:
                attempts += 1
                if attempts >= max_dial_retries or time.monotonic() + delay > deadline:
                    self._listener.close()
                    raise SpCommError(
                        f"rank {rank}: rendezvous at {host}:{port} unreachable "
                        f"after {attempts} dial attempts over "
                        f"{connect_timeout}s ({e})"
                    ) from e
                time.sleep(delay)
                delay = min(delay * 2.0, 0.5)
        # create_connection leaves connect_timeout armed on the socket;
        # clear it or an idle gap longer than that kills the reader thread
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.sendall(struct.pack("<II", rank, self.data_port))  # hello

        self._wlock = threading.Lock()  # control-link writes
        self._plock = threading.RLock()  # links / book / graceful / last_seen
        self._links: dict[int, _PeerLink] = {}
        self._extra_links: list[_PeerLink] = []  # simultaneous-dial duplicates
        self._dial_locks: dict[int, threading.Lock] = {}
        self._dials = 0
        self._graceful: set[int] = set()
        self._last_seen: dict[int, float] = {}
        self._book: dict[int, tuple[str, int]] = {}
        self._book_ready = threading.Event()
        self._book_failed: Optional[str] = None
        self._hb_stop = threading.Event()

        self._reader = threading.Thread(
            target=self._ctrl_loop, name=f"sprecv-{rank}", daemon=True
        )
        self._reader.start()
        self._acceptor = threading.Thread(
            target=self._accept_loop, name=f"spaccept-{rank}", daemon=True
        )
        self._acceptor.start()
        self._hb = threading.Thread(
            target=self._hb_loop, name=f"sphb-{rank}", daemon=True
        )
        self._hb.start()
        self._mon = threading.Thread(
            target=self._monitor_loop, name=f"spmon-{rank}", daemon=True
        )
        self._mon.start()

    # -- control link (rank-0 relay) -----------------------------------------

    def _ctrl_loop(self) -> None:
        try:
            while True:
                (n,) = _U32.unpack(_recv_exact(self._sock, 4))
                body = _recv_exact(self._sock, n)
                src, dst, taglen = _FRAME_HDR.unpack_from(body, 0)
                if dst != _CTRL_RANK and src != _CTRL_RANK:
                    continue  # the control link carries no data frames
                off = _FRAME_HDR.size
                ctrl = decode_message(body[off : off + taglen])
                kind = ctrl[1]
                if kind == "book":
                    with self._plock:
                        self._book = {
                            int(r): (ip, int(p)) for r, ip, p in ctrl[2]
                        }
                    self._book_ready.set()
                elif kind == "dead":
                    self._death_news(int(ctrl[2]))
                elif kind == "bye":
                    with self._plock:
                        self._graceful.add(int(ctrl[2]))
        except (ConnectionError, OSError):
            if self._closed:
                return
            # the rendezvous relay (rank 0's process) hung up.  Unlike the
            # old star this does NOT kill the data plane — direct links
            # keep flowing; only rank 0 itself may be gone.
            if not self._book_ready.is_set():
                self._book_failed = (
                    "control link lost before the address book arrived"
                )
                self._book_ready.set()
            with self._plock:
                graceful = 0 in self._graceful
            if self.rank != 0 and not graceful:
                self._declare_peer_dead(0, "control link lost without goodbye")

    # -- data plane: listener + per-peer links -------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: transport shutting down
            if self._closed:
                conn.close()
                return
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                (peer,) = _U32.unpack(_recv_exact(conn, 4))  # link hello
            except (ConnectionError, OSError):
                conn.close()
                continue
            if self.is_dead(peer):
                conn.close()  # evicted rank: refuse the hello
                continue
            self._register_link(_PeerLink(peer, conn))

    def _register_link(self, link: _PeerLink) -> _PeerLink:
        """Cache ``link`` (or park it as a duplicate when both sides dialed
        simultaneously) and start its reader.  Returns the canonical link
        for that peer."""
        with self._plock:
            if self._closed:
                link.sock.close()
                return link
            current = self._links.get(link.rank)
            if current is None:
                self._links[link.rank] = link
            else:
                self._extra_links.append(link)
            self._last_seen[link.rank] = time.monotonic()
        link.reader = threading.Thread(
            target=self._link_loop, args=(link,),
            name=f"splink-{self.rank}-{link.rank}", daemon=True,
        )
        link.reader.start()
        return current if current is not None else link

    def _drop_link(self, link: _PeerLink) -> None:
        with self._plock:
            if self._links.get(link.rank) is link:
                del self._links[link.rank]
            elif link in self._extra_links:
                self._extra_links.remove(link)
        try:
            link.sock.close()
        except OSError:  # pragma: no cover - already closed
            pass

    def _link_loop(self, link: _PeerLink) -> None:
        peer = link.rank
        try:
            while True:
                (n,) = _U32.unpack(_recv_exact(link.sock, 4))
                body = _recv_into(link.sock, n)
                src, dst, taglen = _FRAME_HDR.unpack_from(body, 0)
                off = _FRAME_HDR.size
                tag_b = bytes(body[off : off + taglen])
                if dst == _CTRL_RANK:  # peer-to-peer control gossip
                    ctrl = decode_message(tag_b)
                    kind = ctrl[1]
                    if kind == "hb":
                        with self._plock:
                            self._last_seen[peer] = time.monotonic()
                    elif kind == "bye":
                        with self._plock:
                            self._graceful.add(
                                int(ctrl[2]) if len(ctrl) > 2 else peer
                            )
                    elif kind == "dead":
                        self._death_news(int(ctrl[2]))
                    continue
                msg = decode_message(memoryview(body)[off + taglen :])
                self._deposit((src, self.rank, tag_b), msg, "_received")
        except (ConnectionError, OSError):
            pass
        finally:
            self._drop_link(link)
            if not self._closed:
                with self._plock:
                    graceful = peer in self._graceful
                if not graceful and not self.is_dead(peer):
                    # EOF without a goodbye, observed by the peer itself —
                    # no router in the detection path
                    self._declare_peer_dead(
                        peer, "peer connection lost without goodbye"
                    )

    # -- failure detection: peer-observed, gossiped --------------------------

    def _declare_peer_dead(self, rank: int, why: str) -> None:
        if rank == self.rank or self._closed or self.is_dead(rank):
            return
        warnings.warn(
            f"rank {self.rank}: declaring rank {rank} dead ({why})",
            RuntimeWarning,
        )
        self._death_news(rank)

    def _death_news(self, rank: int) -> None:
        """Mark ``rank`` dead, reap its links, and gossip once — the dead
        set dedups re-deliveries, so gossip storms terminate."""
        if rank == self.rank:
            return  # never suicide on relayed gossip
        with self._lock:
            if rank in self._dead:
                return
        self.mark_dead(rank)
        with self._plock:
            link = self._links.pop(rank, None)
            extras = [l for l in self._extra_links if l.rank == rank]
            self._extra_links = [l for l in self._extra_links if l.rank != rank]
        for l in ([link] if link is not None else []) + extras:
            try:
                l.sock.close()
            except OSError:  # pragma: no cover - already closed
                pass
        self._gossip(encode_message(("__spctrl__", "dead", rank)))

    def _gossip(self, tag_b: bytes) -> None:
        frame = _ctrl_frame(self.rank, _CTRL_RANK, tag_b)
        try:
            with self._wlock:
                self._sock.sendall(frame)  # the relay re-broadcasts
        except OSError:
            pass  # control link gone; data links below still carry the news
        with self._plock:
            links = list(self._links.values())
        for link in links:
            try:
                with link.wlock:
                    link.sock.sendall(frame)
            except OSError:
                pass  # that link's reader handles its own fallout

    def _hb_loop(self) -> None:
        tag_b = encode_message(("__spctrl__", "hb"))
        frame = _ctrl_frame(self.rank, _CTRL_RANK, tag_b)
        while not self._hb_stop.wait(self._hb_interval):
            try:
                with self._wlock:
                    self._sock.sendall(frame)
            except OSError:
                pass  # relay gone; direct links still prove liveness
            with self._plock:
                links = list(self._links.values())
            for link in links:
                try:
                    with link.wlock:
                        link.sock.sendall(frame)
                except OSError:
                    pass

    def _monitor_loop(self) -> None:
        interval = max(self._hb_timeout / 4.0, 0.02)
        while not self._hb_stop.wait(interval):
            now = time.monotonic()
            with self._plock:
                stale = [
                    r
                    for r, seen in self._last_seen.items()
                    if r in self._links
                    and r not in self._graceful
                    and now - seen > self._hb_timeout
                ]
            for r in stale:
                self._declare_peer_dead(
                    r, f"no heartbeat for more than {self._hb_timeout}s"
                )

    # -- lazy dial + connection cache ----------------------------------------

    def _dial_lock(self, dst: int) -> threading.Lock:
        with self._plock:
            lock = self._dial_locks.get(dst)
            if lock is None:
                lock = self._dial_locks[dst] = threading.Lock()
            return lock

    def _require_book(self) -> dict[int, tuple[str, int]]:
        if not self._book_ready.wait(self._connect_timeout):
            raise SpCommError(
                f"rank {self.rank}: address book not received within "
                f"{self._connect_timeout}s (rendezvous incomplete?)"
            )
        if self._book_failed is not None:
            raise SpCommError(f"rank {self.rank}: {self._book_failed}")
        with self._plock:
            return dict(self._book)

    def _get_link(self, dst: int) -> Optional[_PeerLink]:
        with self._plock:
            link = self._links.get(dst)
        if link is not None:
            return link
        book = self._require_book()
        with self._plock:
            if dst in self._graceful:
                return None  # departed peer: frames to it are dropped
        with self._dial_lock(dst):
            with self._plock:
                link = self._links.get(dst)
            if link is not None:
                return link  # raced with the peer dialing us
            addr = book.get(dst)
            if addr is None:
                raise SpCommError(
                    f"rank {self.rank}: no address for rank {dst} in the book"
                )
            last: Optional[OSError] = None
            sock = None
            for attempt in range(3):
                if self.is_dead(dst):
                    raise SpRankDeadError(
                        f"cannot send to rank {dst}: rank is dead"
                    )
                try:
                    sock = socket.create_connection(
                        addr, timeout=self._connect_timeout
                    )
                    break
                except OSError as e:
                    last = e
                    with self._plock:
                        if dst in self._graceful:
                            return None
                    time.sleep(0.02 * (attempt + 1))
            if sock is None:
                # a refused direct dial to a non-departed peer is EOF-grade
                # evidence: its listener died with its process
                self._declare_peer_dead(
                    dst, f"direct dial to {addr[0]}:{addr[1]} failed ({last})"
                )
                raise SpRankDeadError(
                    f"cannot send to rank {dst}: rank is dead "
                    f"(direct dial failed: {last})"
                )
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(_U32.pack(self.rank))  # link hello
            with self._plock:
                self._dials += 1
            return self._register_link(_PeerLink(dst, sock))

    # -- mailbox side ---------------------------------------------------------

    def _box_key(self, key: tuple) -> tuple:
        src, dst, tag = key
        return (src, dst, _tag_bytes(tag))

    def _post_segments(self, key: tuple, segments: list, nbytes: int) -> None:
        src, dst, tag = key
        if self._closed:
            raise SpCommError("transport is closed")
        if self.is_dead(dst):
            raise SpRankDeadError(f"cannot send to rank {dst}: rank is dead")
        tag_b = _tag_bytes(tag)
        head = (
            _U32.pack(_FRAME_HDR.size + len(tag_b) + nbytes)
            + _FRAME_HDR.pack(src, dst, len(tag_b))
            + tag_b
        )
        link = self._get_link(dst)
        if link is None:
            return  # departed peer: dropped, like the star router did
        try:
            with link.wlock:
                _sendv(link.sock, [head, *segments])
        except OSError as e:
            with self._plock:
                graceful = dst in self._graceful
            if graceful or self._closed:
                return
            self._declare_peer_dead(dst, f"send failed ({e})")
            raise SpRankDeadError(
                f"cannot send to rank {dst}: rank is dead (send failed: {e})"
            ) from e
        with self._lock:
            self._posted += 1

    def post(self, key: tuple, msg: Any) -> None:
        src, dst, tag = key
        if dst == self.rank:
            # self-delivery: straight into the local mailbox (rule 1)
            if self._closed:
                raise SpCommError("transport is closed")
            with self._lock:
                self._posted += 1
            self._deposit(self._box_key(key), msg, "_received")
            return
        segs, nbytes = encode_segments(msg)
        self._post_segments(key, segs, nbytes)

    def post_all(self, keys: list, msg: Any) -> None:
        # broadcast fan-out: serialize once, one vectored frame per link
        segs: Optional[list] = None
        nbytes = 0
        for key in keys:
            if key[1] == self.rank:
                self.post(key, msg)
                continue
            if segs is None:
                segs, nbytes = encode_segments(msg)
            self._post_segments(key, segs, nbytes)

    def stats(self) -> dict:
        out = super().stats()
        out["received"] = self._received
        with self._plock:
            out["links"] = len(self._links) + len(self._extra_links)
            out["dials"] = self._dials
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._hb_stop.set()
        bye = _ctrl_frame(
            self.rank, _CTRL_RANK, encode_message(("__spctrl__", "bye"))
        )
        with self._plock:
            links = list(self._links.values()) + list(self._extra_links)
        for link in links:  # graceful leave on every direct link
            try:
                with link.wlock:
                    link.sock.sendall(bye)
            except OSError:
                pass
        try:
            with self._wlock:
                self._sock.sendall(bye)  # the relay re-broadcasts the bye
        except OSError:
            pass
        if self._router is not None:
            self._router.soft_close()
        _close_listener(self._listener)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        for link in links:
            try:
                link.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                link.sock.close()
            except OSError:
                pass
        self._reader.join(timeout=2.0)
        self._acceptor.join(timeout=2.0)
        self._hb.join(timeout=2.0)
        self._mon.join(timeout=2.0)
        for link in links:
            if link.reader is not None:
                link.reader.join(timeout=1.0)
        if self._router is not None:
            self._router.join(timeout=2.0)

    def __enter__(self) -> "SocketTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------- legacy star (baseline)

class _StarRouter(threading.Thread):
    """LEGACY rank-0 frame switch *and* failure detector — the old
    hub-and-spoke data plane, kept only as :class:`RouterTransport`'s
    router so a benchmark can measure the baseline the p2p plane
    replaced.

    Accepts one connection per rank (hello = the 4-byte rank), then forwards
    every ``[len][src][dst][taglen][tag][payload]`` frame to ``dst``'s
    connection verbatim.  Forwarding starts only once all ``size`` ranks
    have dialed in; frames written earlier sit in kernel socket buffers
    until then.

    Failure detection: frames addressed to :data:`_CTRL_RANK` are consumed
    here — ``hb`` refreshes the sender's last-seen stamp, ``bye`` marks a
    graceful leave.  A rank whose connection EOFs *without* a bye, or whose
    last heartbeat is older than ``heartbeat_timeout``, is declared dead:
    its connection is reaped and a ``dead`` control frame is broadcast to
    every survivor (including rank 0's own transport, which is just another
    connection)."""

    def __init__(self, host: str, port: int, size: int, *, heartbeat_timeout: float = 10.0):
        super().__init__(name="sprouter", daemon=True)
        self._size = size
        self._hb_timeout = heartbeat_timeout
        self._listener = socket.create_server((host, port), backlog=size)
        self.port = self._listener.getsockname()[1]
        self._conns: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._lock = threading.Lock()  # conns / last_seen / dead / graceful
        self._fwd_lock = threading.Lock()
        self.forwarded = 0
        self._all_in = threading.Event()
        self._closing = False
        self._last_seen: dict[int, float] = {}
        self._graceful: set[int] = set()
        self.dead: set[int] = set()
        self._readers: list[threading.Thread] = []

    def run(self) -> None:
        try:
            while not self._closing:
                conn, _addr = self._listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                (rank,) = _U32.unpack(_recv_exact(conn, 4))
                with self._lock:
                    refuse = rank in self.dead or rank in self._conns
                    if not refuse:
                        self._conns[rank] = conn
                        self._send_locks[rank] = threading.Lock()
                        self._last_seen[rank] = time.monotonic()
                        n_in = len(self._conns)
                if refuse:  # protocol breach: duplicate hello / dead rank
                    warnings.warn(
                        f"router: refusing hello for rank {rank} "
                        "(duplicate or already declared dead)",
                        RuntimeWarning,
                    )
                    conn.close()
                    continue
                if self._all_in.is_set():
                    self._start_reader(rank, conn)  # late joiner post-barrier
                elif n_in == self._size:
                    self._all_in.set()
                    with self._lock:
                        ready = list(self._conns.items())
                    for r, c in ready:
                        self._start_reader(r, c)
                    threading.Thread(
                        target=self._monitor, name="sprouter-hb", daemon=True
                    ).start()
        except (ConnectionError, OSError) as e:
            if not self._closing and not self._all_in.is_set():
                # a rank died mid-rendezvous: the job cannot form — fail
                # loudly instead of leaving a half-dead router thread behind
                warnings.warn(
                    f"router: rendezvous failed ({e!r}); closing all connections",
                    RuntimeWarning,
                )
                with self._lock:
                    conns = list(self._conns.values())
                for c in conns:
                    c.close()
        finally:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover - already closed
                pass
        for t in list(self._readers):
            t.join()

    def _start_reader(self, rank: int, conn: socket.socket) -> None:
        t = threading.Thread(
            target=self._forward_from, args=(rank, conn),
            name=f"sproute-{rank}", daemon=True,
        )
        self._readers.append(t)
        t.start()

    def soft_close(self) -> None:
        """Stop accepting and monitoring; live peer↔peer forwarding keeps
        running until each peer hangs up (rank 0 may finish first)."""
        self._closing = True
        _close_listener(self._listener)

    # -- data plane ----------------------------------------------------------

    def _forward_from(self, rank: int, conn: socket.socket) -> None:
        try:
            while True:
                head = _recv_exact(conn, 4)
                (n,) = _U32.unpack(head)
                body = _recv_exact(conn, n)
                _src, dst, taglen = _FRAME_HDR.unpack_from(body, 0)
                if dst == _CTRL_RANK:
                    off = _FRAME_HDR.size
                    ctrl = decode_message(body[off : off + taglen])
                    with self._lock:
                        if ctrl[1] == "hb":
                            self._last_seen[rank] = time.monotonic()
                        elif ctrl[1] == "bye":
                            self._graceful.add(rank)
                    continue
                with self._lock:
                    out = self._conns.get(dst)
                    lock = self._send_locks.get(dst)
                if out is None:
                    continue  # dst gone (dead or departed): drop the frame
                try:
                    with lock:
                        out.sendall(head + body)
                except OSError:
                    continue  # dst hung up mid-forward; its own EOF handles it
                with self._fwd_lock:
                    self.forwarded += 1
        except (ConnectionError, OSError):
            pass  # rank hung up; in-flight traffic for it is already queued
        finally:
            with self._lock:
                graceful = rank in self._graceful
                current = self._conns.get(rank) is conn
                if current:
                    del self._conns[rank]
                    self._send_locks.pop(rank, None)
            try:
                conn.close()
            except OSError:  # pragma: no cover - already closed
                pass
            if current and not graceful and not self._closing:
                # EOF without a goodbye: the process died under us
                self._declare_dead(rank, "connection lost without goodbye")

    # -- failure detector ----------------------------------------------------

    def _monitor(self) -> None:
        interval = max(self._hb_timeout / 4.0, 0.02)
        while not self._closing:
            time.sleep(interval)
            now = time.monotonic()
            with self._lock:
                stale = [
                    r
                    for r, seen in self._last_seen.items()
                    if r in self._conns
                    and r not in self._graceful
                    and r not in self.dead
                    and now - seen > self._hb_timeout
                ]
            for r in stale:
                self._declare_dead(
                    r, f"no heartbeat for more than {self._hb_timeout}s"
                )

    def _declare_dead(self, rank: int, why: str) -> None:
        with self._lock:
            if rank in self.dead:
                return
            self.dead.add(rank)
            conn = self._conns.pop(rank, None)
            self._send_locks.pop(rank, None)
            targets = [
                (r, self._conns[r], self._send_locks[r]) for r in self._conns
            ]
        if conn is not None:
            try:
                conn.close()
            except OSError:  # pragma: no cover - already closed
                pass
        warnings.warn(
            f"router: declaring rank {rank} dead ({why})", RuntimeWarning
        )
        tag_b = encode_message(("__spctrl__", "dead", rank))
        for r, c, lk in targets:
            body = _FRAME_HDR.pack(_CTRL_RANK, r, len(tag_b)) + tag_b
            try:
                with lk:
                    c.sendall(_U32.pack(len(body)) + body)
            except OSError:  # pragma: no cover - survivor also going away
                pass


class RouterTransport(_LockedMailboxes):
    """LEGACY hub-and-spoke TCP transport — every frame is forwarded
    through rank 0's :class:`_StarRouter`.  Kept as the measured baseline;
    all production paths use the peer-to-peer :class:`SocketTransport`."""

    def __init__(
        self,
        rank: int,
        size: int,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        connect_timeout: float = 10.0,
        max_dial_retries: int = 100,
        heartbeat: float | None = None,
        staleness_factor: float | None = None,
        heartbeat_interval: float | None = None,
        heartbeat_timeout: float | None = None,
    ):
        super().__init__()
        interval, heartbeat_timeout = _resolve_hb_knobs(
            heartbeat, staleness_factor, heartbeat_interval, heartbeat_timeout
        )
        self.rank, self.size, self.host = rank, size, host
        self._received = 0
        self._closed = False
        self._router: Optional[_StarRouter] = None
        if rank == 0:
            self._router = _StarRouter(host, port, size, heartbeat_timeout=heartbeat_timeout)
            self._router.start()
            port = self._router.port
        elif port == 0:
            raise ValueError("non-root ranks must be told the rendezvous port")
        self.port = port

        # rank 0 may not be listening yet — dial with a bounded retry count
        # and exponential backoff instead of hammering until connect_timeout
        deadline = time.monotonic() + connect_timeout
        delay, attempts = 0.01, 0
        while True:
            try:
                self._sock = socket.create_connection((host, port), timeout=connect_timeout)
                break
            except OSError as e:
                attempts += 1
                if attempts >= max_dial_retries or time.monotonic() + delay > deadline:
                    raise SpCommError(
                        f"rank {rank}: rendezvous at {host}:{port} unreachable "
                        f"after {attempts} dial attempts over "
                        f"{connect_timeout}s ({e})"
                    ) from e
                time.sleep(delay)
                delay = min(delay * 2.0, 0.5)
        # create_connection leaves connect_timeout armed on the socket;
        # clear it or an idle gap longer than that kills the receiver
        # thread with a swallowed socket.timeout (an OSError subclass)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.sendall(_U32.pack(rank))  # hello
        self._wlock = threading.Lock()
        self._reader = threading.Thread(
            target=self._recv_loop, name=f"sprecv-{rank}", daemon=True
        )
        self._reader.start()
        self._hb_interval = interval
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(
            target=self._hb_loop, name=f"sphb-{rank}", daemon=True
        )
        self._hb.start()

    # -- wire side (receiver thread only) ------------------------------------

    def _recv_loop(self) -> None:
        try:
            while True:
                (n,) = _U32.unpack(_recv_exact(self._sock, 4))
                body = _recv_exact(self._sock, n)
                src, _dst, taglen = _FRAME_HDR.unpack_from(body, 0)
                off = _FRAME_HDR.size
                tag_b = body[off : off + taglen]
                if src == _CTRL_RANK:  # router control plane
                    ctrl = decode_message(tag_b)
                    if ctrl[1] == "dead":
                        self.mark_dead(ctrl[2])
                    continue
                msg = decode_message(body[off + taglen :])
                self._deposit((src, self.rank, tag_b), msg, "_received")
        except (ConnectionError, OSError):
            # transport closed.  If *we* did not close it, the router (and
            # with it rank 0) is gone: the star cannot route anything any
            # more, so every peer is effectively dead from here
            if not self._closed:
                for r in range(self.size):
                    if r != self.rank:
                        self.mark_dead(r)

    # -- control plane -------------------------------------------------------

    def _send_ctrl(self, kind: str) -> None:
        tag_b = encode_message(("__spctrl__", kind))
        body = _FRAME_HDR.pack(self.rank, _CTRL_RANK, len(tag_b)) + tag_b
        with self._wlock:
            self._sock.sendall(_U32.pack(len(body)) + body)

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self._hb_interval):
            try:
                self._send_ctrl("hb")
            except OSError:
                return  # wire gone; the receiver thread handles the fallout

    # -- mailbox side ---------------------------------------------------------

    def _box_key(self, key: tuple) -> tuple:
        src, dst, tag = key
        return (src, dst, _tag_bytes(tag))

    def _send_frame(self, key: tuple, payload: bytes) -> None:
        src, dst, tag = key
        with self._lock:
            dead = dst in self._dead
        if dead:
            raise SpRankDeadError(f"cannot send to rank {dst}: rank is dead")
        tag_b = _tag_bytes(tag)
        body = _FRAME_HDR.pack(src, dst, len(tag_b)) + tag_b + payload
        try:
            with self._wlock:
                self._sock.sendall(_U32.pack(len(body)) + body)
                self._posted += 1
        except OSError as e:
            raise SpCommError(
                f"socket send to rank {dst} failed: wire to the router is "
                f"down ({e})"
            ) from e

    def post(self, key: tuple, msg: Any) -> None:
        self._send_frame(key, encode_message(msg))

    def post_all(self, keys: list, msg: Any) -> None:
        # broadcast fan-out: serialize once, frame per destination
        payload = encode_message(msg)
        for key in keys:
            self._send_frame(key, payload)

    def stats(self) -> dict:
        out = super().stats()
        out["received"] = self._received
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._hb_stop.set()
        try:
            self._send_ctrl("bye")  # graceful leave: not a death
        except OSError:
            pass
        if self._router is not None:
            self._router.soft_close()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=2.0)
        self._hb.join(timeout=2.0)
        if self._router is not None:
            self._router.join(timeout=2.0)

    def __enter__(self) -> "RouterTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SpCommGroup:
    """A communicator: (transport, rank, size) — one per Specx 'instance'.

    ``hub`` may be any :class:`SpTransport`; the in-process default is the
    module-wide :func:`default_hub`.  ``default_timeout`` (seconds) applies
    to every receive issued through this group unless the call overrides it.

    ``members`` (default ``range(size)``) is the *logical* membership: the
    physical ranks participating in this group's collectives, in logical
    order.  ``rank`` / ``size`` stay physical — they are wire identity —
    while ring neighbours etc. are computed in logical coordinates and
    translated via :meth:`to_physical`.  After a rank death, survivors call
    :meth:`shrunk` to get a group over the remaining members without
    re-bootstrapping the transport (the live-reshard recovery path).

    ``device`` (a torch device or its name; None: leave payloads where they
    arrive) is where this rank works: every tensor a receive or broadcast
    delivers is moved onto it, so a rank on the card gets CUDA tensors
    whatever the wire carried, and never a CPU tensor in their place."""

    def __init__(
        self,
        rank: int,
        size: int,
        hub: SpTransport | None = None,
        *,
        default_timeout: float | None = None,
        members: Sequence[int] | None = None,
        device=None,
    ):
        self.rank = rank
        self.size = size
        self.hub = hub if hub is not None else default_hub()
        self.default_timeout = default_timeout
        self.device = None if device is None else torch.device(device)
        self.members = tuple(members) if members is not None else tuple(range(size))
        if rank not in self.members:
            raise ValueError(
                f"rank {rank} is not one of this group's members {self.members}"
            )
        self._logical_rank = self.members.index(rank)
        self._bcast_seq = 0  # paper: same broadcasts, same order on all ranks

    @property
    def transport(self) -> SpTransport:
        return self.hub

    # -- logical coordinates (shrink-aware collectives) -----------------------

    @property
    def logical_size(self) -> int:
        return len(self.members)

    @property
    def logical_rank(self) -> int:
        return self._logical_rank

    def to_physical(self, logical_rank: int) -> int:
        return self.members[logical_rank % len(self.members)]

    def shrunk(self, dead: Sequence[int]) -> "SpCommGroup":
        """A new group over the surviving members (same transport, same
        physical identity); broadcast sequencing carries over so survivors
        stay aligned."""
        gone = set(dead)
        members = tuple(r for r in self.members if r not in gone)
        if self.rank in gone or self.rank not in members:
            raise SpCommError(
                f"rank {self.rank} is itself in the dead set {sorted(gone)}"
            )
        if not members:
            raise SpCommError("no members survive")
        g = SpCommGroup(
            self.rank,
            self.size,
            self.hub,
            default_timeout=self.default_timeout,
            members=members,
            device=self.device,
        )
        g._bcast_seq = self._bcast_seq
        return g


# ---------------------------------------------------------------------------
# Non-blocking requests.
# ---------------------------------------------------------------------------

class CommRequest:
    def test(self) -> bool:
        raise NotImplementedError

    def timed_out(self) -> bool:
        return False

    def timeout_error(self) -> SpCommError:  # pragma: no cover - overridden
        return SpCommTimeoutError("communication request timed out")

    def complete(self) -> None:
        pass


class _DoneRequest(CommRequest):
    def test(self) -> bool:
        return True


def _to_device(obj: Any, device) -> Any:
    """``obj`` with every tensor in it (through tuples, lists and dicts)
    moved onto ``device``; a tensor already there is returned as is, and
    ``device=None`` leaves everything where it is."""
    if device is None:
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device)  # returns obj itself when it is already there
    if isinstance(obj, tuple):
        return tuple(_to_device(v, device) for v in obj)
    if isinstance(obj, list):
        return [_to_device(v, device) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


class _RecvRequest(CommRequest):
    def __init__(self, transport: SpTransport, key: tuple, ref, timeout: float | None = None,
                 device=None):
        self.transport = transport
        self.key = key
        self.ref = ref
        self.device = device
        self._msg = None
        self._have = False
        self._deadline = None if timeout is None else time.monotonic() + timeout
        self._timeout = timeout

    def test(self) -> bool:
        if not self._have:
            try:
                ok, msg = self.transport.poll(self.key)
            except SpRankDeadError as e:
                src, dst, tag = self.key
                raise SpRankDeadError(
                    f"recv(src={src}, dst={dst}, tag={tag!r}) can never "
                    f"complete: {e}"
                ) from e
            if ok:
                self._msg = msg
                self._have = True
        return self._have

    def timed_out(self) -> bool:
        return (
            not self._have
            and self._deadline is not None
            and time.monotonic() > self._deadline
        )

    def timeout_error(self) -> SpCommError:
        src, dst, tag = self.key
        return SpCommTimeoutError(
            f"recv(src={src}, dst={dst}, tag={tag!r}) saw no message within "
            f"{self._timeout}s — peer never posted?"
        )

    def complete(self) -> None:
        self.ref.value = _to_device(unpack(self._msg), self.device)


# ---------------------------------------------------------------------------
# Comm task constructors.
# ---------------------------------------------------------------------------

def _no_spec(graph: SpTaskGraph) -> None:
    if graph.spec_model is not SpSpeculativeModel.SP_NO_SPEC:
        raise ValueError(
            "MPI-style communications are incompatible with speculative "
            "execution (paper §4.4); use a SP_NO_SPEC graph."
        )


def mpi_send(graph: SpTaskGraph, group: SpCommGroup, x: SpData, dest: int, tag) -> TaskView:
    _no_spec(graph)
    acc = SpAccess(x, AccessMode.READ)
    task = Task({"ref": lambda v: None}, [acc], [("single", acc)],
                name=f"send(to={dest},tag={tag})", is_comm=True, cost=0.1)

    def start(args):
        group.hub.post((group.rank, dest, tag), pack(args[0]))
        return _DoneRequest()

    task.comm_start = start
    return graph._insert(task)


def mpi_recv(
    graph: SpTaskGraph,
    group: SpCommGroup,
    x: SpData,
    src: int,
    tag,
    *,
    timeout: float | None = None,
) -> TaskView:
    _no_spec(graph)
    eff_timeout = timeout if timeout is not None else group.default_timeout
    acc = SpAccess(x, AccessMode.WRITE)
    task = Task({"ref": lambda v: None}, [acc], [("single", acc)],
                name=f"recv(from={src},tag={tag})", is_comm=True, cost=0.1)

    def start(args):
        return _RecvRequest(group.hub, (src, group.rank, tag), args[0], eff_timeout,
                            group.device)

    task.comm_start = start
    return graph._insert(task)


def mpi_broadcast(
    graph: SpTaskGraph,
    group: SpCommGroup,
    x: SpData,
    root: int,
    *,
    timeout: float | None = None,
) -> TaskView:
    """Paper: Specx supports MPI broadcast; all instances must issue the same
    broadcasts in the same order — enforced via a per-group sequence tag."""
    _no_spec(graph)
    seq = group._bcast_seq
    group._bcast_seq += 1
    tag = ("bcast", seq)
    eff_timeout = timeout if timeout is not None else group.default_timeout
    if group.rank == root:
        acc = SpAccess(x, AccessMode.READ)
        task = Task({"ref": lambda v: None}, [acc], [("single", acc)],
                    name=f"bcast(root={root},seq={seq})", is_comm=True, cost=0.1)

        def start(args):
            msg = pack(args[0])
            group.hub.post_all(
                [(root, r, tag) for r in group.members if r != root], msg
            )
            return _DoneRequest()

        task.comm_start = start
    else:
        acc = SpAccess(x, AccessMode.WRITE)
        task = Task({"ref": lambda v: None}, [acc], [("single", acc)],
                    name=f"bcast(root={root},seq={seq})", is_comm=True, cost=0.1)

        def start(args):
            return _RecvRequest(group.hub, (root, group.rank, tag), args[0], eff_timeout,
                                group.device)

        task.comm_start = start
    return graph._insert(task)


# ---------------------------------------------------------------------------
# The background progress thread (one per engine).
# ---------------------------------------------------------------------------

class CommThread(threading.Thread):
    """Starts non-blocking ops and polls a request list — the analogue of the
    paper's MPI thread calling test-any in a loop.

    Lifecycle: :meth:`stop` first waits ``grace`` seconds for in-flight
    requests to drain; if the loop is still busy after that, it *aborts*
    the remaining requests — each affected task fails with
    :class:`SpCommAbortedError` (so waiters unblock and see the error) and
    ``stop`` returns their names instead of silently leaking a daemon
    thread with live requests."""

    _ids = iter(range(1 << 20))

    def __init__(self, engine):
        super().__init__(name=f"spcomm-{next(CommThread._ids)}", daemon=True)
        self.engine = engine
        self._incoming: collections.deque[Task] = collections.deque()
        self._cv = threading.Condition()
        self._running = True
        self._abort = False
        self.aborted: list[str] = []

    def submit(self, task: Task) -> None:
        with self._cv:
            self._incoming.append(task)
            self._cv.notify()

    def _cancel_cascade(self, tasks: list) -> None:
        """Transitively cancel released successors: used whenever work
        becomes ready but no worker will ever run it (engine stopped, or
        the request it depended on was aborted) — otherwise
        ``wait_all_tasks`` hangs forever on any chain behind a dead comm
        task."""
        stack = list(tasks)
        while stack:
            t = stack.pop()
            t.mark_cancelled()
            g = getattr(t, "graph", None)
            if g is not None:
                stack.extend(g.on_task_finished(t))

    def _complete(self, task: Task, *, dispatch: bool) -> None:
        """Common completion path: stamp the end time, trace, release
        dependencies, wake waiters.  Successors are dispatched only for a
        *successful* request on a still-running engine; a failed request
        (timeout, start error, abort) cancels them transitively instead —
        their input never arrived, running them would silently propagate
        garbage — and so does a completion landing inside ``stop()``'s
        grace window, when no worker is left to pop the queue."""
        task.t_end = time.perf_counter()
        graph = getattr(task, "graph", None)
        if graph is None:  # pragma: no cover - tasks always carry a graph
            task.mark_finished()
            return
        if getattr(graph, "trace", True):
            graph.trace_events.append(
                {
                    "task": task.name,
                    "uid": task.uid,
                    "worker": self.name,
                    "t0": task.t_start,
                    "t1": task.t_end,
                    "ready": 0,
                    "comm": True,
                    "spec": False,
                }
            )
        newly = graph.on_task_finished(task)
        task.mark_finished()
        if newly:
            if dispatch and getattr(self.engine, "_running", True):
                self.engine.push_many(newly)
            else:
                self._cancel_cascade(newly)

    def _finish(self, task: Task) -> None:
        self._complete(task, dispatch=True)

    def _fail(self, task: Task, exc: BaseException) -> None:
        task.exception = exc
        self._complete(task, dispatch=False)

    def run(self) -> None:
        in_flight: list[tuple[Task, CommRequest, list]] = []
        while True:
            starts: list[Task] = []
            with self._cv:
                if self._abort:
                    break
                if not self._running and not self._incoming and not in_flight:
                    return
                while self._incoming:
                    starts.append(self._incoming.popleft())
                if not in_flight and not starts and self._running:
                    self._cv.wait(timeout=0.05)
                    continue
            # start requests OUTSIDE the lock: a socket send can block on a
            # full kernel buffer, and _fail releases dependencies, which may
            # re-enter submit() — neither may happen while holding _cv
            for task in starts:
                task.state = TaskState.RUNNING
                task.t_start = time.perf_counter()
                try:
                    args, writebacks = task.build_args()
                    req = task.comm_start(args)
                except BaseException as e:
                    self._fail(task, e)
                    continue
                in_flight.append((task, req, writebacks))
            progressed = False
            for item in list(in_flight):
                task, req, writebacks = item
                try:
                    done = req.test()
                except BaseException as e:
                    self._fail(task, e)
                    in_flight.remove(item)
                    progressed = True
                    continue
                if done:
                    in_flight.remove(item)
                    progressed = True
                    try:
                        # decoding a tagged object or moving a tensor to
                        # the group's device may raise: that fails the
                        # task, it must not kill this thread
                        req.complete()
                    except BaseException as e:
                        self._fail(task, e)
                        continue
                    for acc, ref in writebacks:
                        acc.data.value = ref.value
                    self._finish(task)
                elif req.timed_out():
                    self._fail(task, req.timeout_error())
                    in_flight.remove(item)
                    progressed = True
            if not progressed and in_flight:
                time.sleep(0.0005)
        # abort path: fail whatever is still queued or in flight so waiters
        # unblock and stop() can report it
        with self._cv:
            pending = list(self._incoming)
            self._incoming.clear()
        for task, _req, _wb in in_flight:
            self.aborted.append(task.name)
            self._fail(task, SpCommAbortedError(
                f"comm thread stopped with {task.name!r} still in flight"))
        for task in pending:
            self.aborted.append(task.name)
            task.t_start = task.t_start or time.perf_counter()
            self._fail(task, SpCommAbortedError(
                f"comm thread stopped before {task.name!r} started"))

    def stop(self, grace: float = 2.0) -> list[str]:
        """Stop the thread; returns the names of aborted tasks ([] when the
        loop drained cleanly within ``grace`` seconds)."""
        was_alive = self.is_alive()
        with self._cv:
            self._running = False
            self._cv.notify()
        self.join(timeout=grace)
        if self.is_alive():
            with self._cv:
                self._abort = True
                self._cv.notify()
            self.join(timeout=2.0)
        if self.aborted and was_alive:
            warnings.warn(
                f"CommThread stopped with in-flight requests aborted: "
                f"{self.aborted}",
                RuntimeWarning,
                stacklevel=2,
            )
        if self.is_alive():  # pragma: no cover - stuck in a blocking send
            warnings.warn(
                "CommThread failed to exit within the grace period",
                RuntimeWarning,
                stacklevel=2,
            )
        return list(self.aborted)
