"""Wire transports of the PS runtime.

Three interchangeable backends behind the same channel duck type
(``send`` / ``send_many``) the runtime uses for its in-process queues
(:class:`repro_torch.runtime.messages.Channel`):

  * ``queue`` — the in-process ``queue.Queue`` edges (threads only);
  * ``tcp``   — loopback sockets, one connection per client<->shard channel
    pair, length-prefixed pickle-protocol-5 frames with numpy row buffers
    carried out-of-band as contiguous byte ranges;
  * ``shm``   — the same frames over single-producer/single-consumer
    shared-memory byte rings (two rings per client<->shard pair, one per
    direction) for same-host deployments.

Framing.  A frame is ``u32 payload_len | payload``.  Two payload formats
share the stream, discriminated by the payload's first u32:

* **pickle-5** (tcp, control messages, serving)::

      u32 n_buffers | u32 head_len | head | (u64 buf_len | buf) * n_buffers

  ``head`` is ``pickle.dumps(msgs, protocol=5, buffer_callback=...)`` of a
  *list* of messages, so senders coalesce many row updates into one frame
  (``send_many``) and the arrays inside ``UpdateMsg``/``DeliverMsg`` travel
  as raw contiguous buffers after the pickle head instead of being copied
  through the pickler.

* **raw row blocks** (shm data plane, :class:`RowCodec`)::

      u32 RAW_MAGIC | u32 n_msgs | n_msgs * (hdr | rows int64 | delta f64)

  ``hdr`` is the fixed 48-byte struct ``_RAW_HDR`` (msg kind, dtype code,
  interned key id, uid/seq, worker/process/ts/shard/epoch, row and column
  counts).  ``RAW_MAGIC`` can never collide with a sane pickle payload's
  ``n_buffers``.  Only ``UpdateMsg``/``DeliverMsg`` are raw-eligible; a
  batch mixing in control messages is split into consecutive raw/pickle
  frames under the channel lock, preserving FIFO.  On the read side,
  :class:`RingViewReader` decodes the arrays as numpy views *into the ring*
  (zero-copy) and defers the ring's head cursor until the consumer releases
  the frame — see its docstring for the pin/release discipline.  The raw
  format is byte for byte the JAX package's, so either package decodes the
  other's frames.

``payload_len == EOF_LEN`` is the end-of-stream sentinel.
:class:`FrameDecoder` is incremental: feed it arbitrary byte chunks (short
reads, split frames) and it yields complete messages only.

FIFO.  Channels stamp per-channel sequence numbers under a lock exactly like
the in-process queues; receivers assert contiguity via :class:`FifoAssert`,
so a reordering (or replaying) transport is *detected*, not assumed away.

Portability.  The shm ring's lock-free cursor protocol assumes **total
store ordering** (x86/x86-64): the producer's data memcpy must become
visible to the consumer no later than the cursor store that publishes it,
and vice versa for the consumer's head update.  On weakly-ordered ISAs
(aarch64/arm64) the stores can be reordered by the hardware, the cursors
would need real acquire/release barriers, and pure Python cannot express
them — so :func:`require_tso` *refuses to construct* the shm backend there
(clear error pointing at ``transport="tcp"``).

Tracing.  Every channel and reader takes an optional
:class:`~repro_torch.runtime.trace.TraceHub` (``trace=``) and records one
``wire_write`` span per ``send_many`` and one ``wire_decode`` span per
decoded batch; with ``trace=None`` the only cost is one ``is None`` test.

Non-blocking sends.  The serving tier's publish path
(:mod:`repro_torch.runtime.serving`) must never stall a shard on a wedged
replica: a :class:`WireChannel` built with a ``try_write`` sink and a
``room`` probe offers :meth:`WireChannel.try_send_many`, which writes one
frame only if it fits right now (:meth:`ShmRing.try_write` through
:func:`try_ring_writer`, or a :class:`TcpSendQueue`'s bounded queue) and
otherwise rolls its seq stamps back.
"""
from __future__ import annotations

import fcntl
import logging
import os
import pickle
import platform
import queue
import select
import socket
import struct
import threading
import time
from collections import deque
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.messages import DeliverMsg, UpdateMsg

log = logging.getLogger("repro_torch.runtime.transport")

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
EOF_LEN = 0xFFFFFFFF          # length-prefix value signalling end-of-stream
MAX_FRAME = EOF_LEN - 1

# raw row-block payloads (zero-copy shm data plane) -------------------------
RAW_MAGIC = 0x46574152        # b"RAWF" little-endian; impossible n_buffers
K_UPDATE = 1                  # raw msg kinds
K_DELIVER = 2
DT_F64 = 0                    # delta dtype codes (rows are always int64)
# kind u8 | dtype u8 | key id u16 | uid i64 | seq i64 |
# worker, process, ts, shard, epoch, n_rows, n_cols i32  -> 48 bytes
_RAW_HDR = struct.Struct("<BBHqqiiiiiii")

# ISAs whose memory model breaks the shm ring's lock-free cursor protocol
_WEAKLY_ORDERED = ("aarch64", "arm64")


def require_tso(what: str = "the shared-memory ring transport") -> None:
    """Refuse to run the shm rings on a weakly-ordered ISA.

    The SPSC cursor protocol relies on x86 total store ordering (module
    docstring); on aarch64/arm64 the missing barriers corrupt frames
    silently, so fail loudly at construction instead."""
    machine = platform.machine().lower()
    if machine in _WEAKLY_ORDERED:
        raise RuntimeError(
            f"{what} assumes x86 total store ordering, but this host is "
            f"{machine!r} (weakly ordered): the lock-free ring cursors "
            'would need memory barriers Python cannot express. '
            'Use transport="tcp" (loopback sockets) instead.')


def encode_frame(msgs: list) -> bytes:
    """One wire frame holding `msgs` (a list — batching is the unit)."""
    buffers: List[pickle.PickleBuffer] = []
    head = pickle.dumps(msgs, protocol=5, buffer_callback=buffers.append)
    parts = [b"", _U32.pack(len(buffers)), _U32.pack(len(head)), head]
    for b in buffers:
        raw = b.raw()
        parts.append(_U64.pack(raw.nbytes))
        parts.append(raw)          # join() copies once; no tobytes() double
    payload_len = sum(len(p) for p in parts)
    if payload_len > MAX_FRAME:
        raise ValueError(f"frame too large: {payload_len} bytes")
    parts[0] = _U32.pack(payload_len)
    return b"".join(parts)


def eof_frame() -> bytes:
    return _U32.pack(EOF_LEN)


def decode_payload(payload: bytes) -> list:
    """Inverse of the payload part of :func:`encode_frame`."""
    n_buf = _U32.unpack_from(payload, 0)[0]
    head_len = _U32.unpack_from(payload, 4)[0]
    off = 8
    head = payload[off:off + head_len]
    if len(head) != head_len:
        raise ValueError("short frame: truncated pickle head")
    off += head_len
    bufs = []
    for _ in range(n_buf):
        if off + 8 > len(payload):
            raise ValueError("short frame: truncated buffer header")
        n = _U64.unpack_from(payload, off)[0]
        off += 8
        buf = payload[off:off + n]
        if len(buf) != n:
            raise ValueError("short frame: truncated buffer body")
        bufs.append(buf)
        off += n
    if off != len(payload):
        raise ValueError(f"frame overrun: {len(payload) - off} trailing bytes")
    return pickle.loads(head, buffers=bufs)


class FrameDecoder:
    """Incremental frame decoder tolerating arbitrary chunking of the stream.

    ``feed(data)`` returns the list of *messages* (flattened across any
    complete frames in the buffer so far); a trailing partial frame stays
    buffered until its bytes arrive.  After the EOF sentinel, ``closed`` is
    True and further frames are rejected.
    """

    def __init__(self):
        self._buf = bytearray()
        self.closed = False

    def feed(self, data: bytes) -> list:
        if self.closed and data:
            raise ValueError("data after EOF sentinel")
        self._buf += data
        out: list = []
        while True:
            if len(self._buf) < 4:
                break
            plen = _U32.unpack_from(self._buf, 0)[0]
            if plen == EOF_LEN:
                self.closed = True
                if len(self._buf) > 4:
                    raise ValueError("data after EOF sentinel")
                del self._buf[:4]
                break
            if len(self._buf) < 4 + plen:
                break                      # short frame: wait for more bytes
            payload = bytes(self._buf[4:4 + plen])
            del self._buf[:4 + plen]
            out.extend(decode_payload(payload))
        return out

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)


class FifoAssert:
    """Per-sender contiguous-sequence assertion (shared by shard & client).

    ``check(sender, seq)`` returns an error string on a gap/reorder/replay,
    else None.  Mirrors the simulator's ``_last_seq_seen`` checking.
    """

    def __init__(self):
        self._last: Dict[object, int] = {}

    def check(self, sender, seq: int) -> Optional[str]:
        last = self._last.get(sender, -1)
        self._last[sender] = max(seq, last)
        if seq != last + 1:
            return f"seq {seq} after {last}"
        return None


# ---------------------------------------------------------------------------
# raw row-block codec (zero-copy shm data plane)
# ---------------------------------------------------------------------------


class RowCodec:
    """Encode/decode ``UpdateMsg``/``DeliverMsg`` as fixed-header raw frames.

    Key names are interned to u16 ids against a fixed, order-stable key list
    (``list(x0.keys())`` — identical in parent and forked children, so both
    sides agree on the table without a handshake).  Messages that are not
    raw-eligible (control messages, unknown keys, other dtypes) go out as
    pickle-5 frames on the same stream; :meth:`frames` splits a mixed batch
    into consecutive raw/pickle frames so FIFO order is preserved.

    Encoding is zero-copy on the producer side too: :meth:`frames` yields
    *lists of buffers* (length prefix, fixed headers, and the messages' own
    array memoryviews) that :meth:`ShmRing.write_parts` copies straight into
    the ring — no intermediate ``b"".join`` of the row data.
    """

    def __init__(self, keys):
        self._keys = list(keys)
        if len(self._keys) > 0xFFFF:
            raise ValueError("RowCodec supports at most 65535 keys")
        self._key_id = {k: i for i, k in enumerate(self._keys)}

    # ------------------------------------------------------------- encode
    def _raw_ok(self, m) -> bool:
        t = type(m)
        if t is not UpdateMsg and t is not DeliverMsg:
            return False
        return (m.key in self._key_id
                and isinstance(m.rows, np.ndarray)
                and isinstance(m.delta, np.ndarray)
                and m.rows.dtype == np.int64
                and m.delta.dtype == np.float64
                and m.delta.ndim == 2)

    def _pack_raw(self, msgs: list) -> list:
        """One raw frame as a list of buffers (length prefix first)."""
        parts: list = [b"", _U32.pack(RAW_MAGIC), _U32.pack(len(msgs))]
        total = 8
        for m in msgs:
            rows = np.ascontiguousarray(m.rows)
            delta = np.ascontiguousarray(m.delta)
            kind = K_UPDATE if type(m) is UpdateMsg else K_DELIVER
            hdr = _RAW_HDR.pack(
                kind, DT_F64, self._key_id[m.key], m.uid, m.seq,
                m.worker, m.process, m.ts, getattr(m, "shard", 0),
                getattr(m, "epoch", 0), rows.shape[0], delta.shape[1])
            parts.append(hdr)
            parts.append(memoryview(rows).cast("B"))
            parts.append(memoryview(delta).cast("B"))
            total += _RAW_HDR.size + rows.nbytes + delta.nbytes
        if total > MAX_FRAME:
            raise ValueError(f"frame too large: {total} bytes")
        parts[0] = _U32.pack(total)
        return parts

    def raw_size(self, m) -> int:
        return _RAW_HDR.size + m.rows.nbytes + m.delta.nbytes

    def frames(self, msgs: list, max_frame: Optional[int]):
        """Split a batch into wire items, each either a raw frame (list of
        buffers) or a pickle frame (bytes), in batch order."""
        cap = (max_frame if max_frame is not None else MAX_FRAME) - 4
        out: list = []
        i, n = 0, len(msgs)
        while i < n:
            if self._raw_ok(msgs[i]):
                cur, cur_bytes = [], 8
                while i < n and self._raw_ok(msgs[i]):
                    sz = self.raw_size(msgs[i])
                    if cur and cur_bytes + sz > cap:
                        out.append(self._pack_raw(cur))
                        cur, cur_bytes = [], 8
                    cur.append(msgs[i])
                    cur_bytes += sz
                    i += 1
                if cur:
                    out.append(self._pack_raw(cur))
            else:
                j = i
                while j < n and not self._raw_ok(msgs[j]):
                    j += 1
                self._pickle_frames(msgs[i:j], max_frame, out)
                i = j
        return out

    def _pickle_frames(self, msgs: list, max_frame: Optional[int],
                       out: list) -> None:
        frame = encode_frame(msgs)
        if (max_frame is not None and len(frame) > max_frame
                and len(msgs) > 1):
            mid = len(msgs) // 2
            self._pickle_frames(msgs[:mid], max_frame, out)
            self._pickle_frames(msgs[mid:], max_frame, out)
        else:
            out.append(frame)

    # ------------------------------------------------------------- decode
    def decode_raw(self, mv) -> list:
        """Inverse of :meth:`_pack_raw` over a payload memoryview.  The
        returned messages' ``rows``/``delta`` are numpy views *into* ``mv``
        — zero-copy when ``mv`` maps ring memory (the caller then pins the
        frame until every message is released)."""
        n_msgs = _U32.unpack_from(mv, 4)[0]
        off = 8
        msgs = []
        for _ in range(n_msgs):
            (kind, dt, kid, uid, seq, worker, process, ts, shard, epoch,
             n_rows, n_cols) = _RAW_HDR.unpack_from(mv, off)
            off += _RAW_HDR.size
            if dt != DT_F64:
                raise ValueError(f"unknown raw dtype code {dt}")
            rows = np.frombuffer(mv, dtype=np.int64, count=n_rows,
                                 offset=off)
            off += n_rows * 8
            delta = np.frombuffer(mv, dtype=np.float64, count=n_rows * n_cols,
                                  offset=off).reshape(n_rows, n_cols)
            off += n_rows * n_cols * 8
            key = self._keys[kid]
            if kind == K_UPDATE:
                m = UpdateMsg(uid, worker, process, ts, key, rows, delta,
                              epoch, seq)
            elif kind == K_DELIVER:
                m = DeliverMsg(uid, worker, process, shard, ts, key, rows,
                               delta, seq)
            else:
                raise ValueError(f"unknown raw message kind {kind}")
            msgs.append(m)
        if off != mv.nbytes:
            raise ValueError(
                f"raw frame overrun: {mv.nbytes - off} trailing bytes")
        return msgs


class FrameHandle:
    """Pin on one decoded-in-place raw frame: the ring's head cursor may not
    pass this frame until every message decoded from it is released."""

    __slots__ = ("_reader", "start", "end", "_remaining", "released")

    def __init__(self, reader: "RingViewReader", start: int, end: int,
                 count: int):
        self._reader = reader
        self.start = start            # absolute stream offset of the frame
        self.end = end                # absolute offset one past the payload
        self._remaining = count
        self.released = False

    def release_one(self) -> None:
        r = self._reader
        with r._lock:
            self._remaining -= 1
            if self._remaining <= 0 and not self.released:
                self.released = True
                r._advance_locked()


def release_msg(msg) -> None:
    """Drop a message's pin on its source frame (no-op for owned msgs)."""
    h = getattr(msg, "_frame", None)
    if h is not None:
        msg._frame = None
        h.release_one()


def release_msgs(msgs) -> None:
    """Drop the messages' pins on their source frames.  Messages that own
    their arrays (queue channels, pickle frames, frames copied out across
    the ring's wrap) hold none."""
    for m in msgs:
        release_msg(m)


def materialize_msg(msg):
    """Copy a view-backed message's arrays out of the ring and release its
    pin, in place.  Required before *retaining* a message (or its arrays)
    past the apply cycle that received it — once the pin drops and the read
    cursor advances, the producer may overwrite the backing ring bytes.
    Messages that already own their arrays are returned as they are."""
    h = getattr(msg, "_frame", None)
    if h is not None:
        msg.rows = np.array(msg.rows)
        msg.delta = np.array(msg.delta)
        msg._frame = None
        h.release_one()
    return msg


class RingViewReader:
    """Zero-copy consumer side of a :class:`ShmRing` carrying RowCodec frames.

    Owns the ring's read side entirely: a *decode* cursor (``_pos``) runs
    ahead of the shared *head* cursor, which only advances past the longest
    prefix of frames whose messages have all been released.  Raw frames
    that lie contiguous in the ring decode as numpy views into ring memory
    (pinned via :class:`FrameHandle`); frames straddling the wrap point —
    and all pickle frames — are copied out and decode as owned messages
    (no pin, head free to advance).

    Discipline for consumers: every decoded message must be either
    *released* (:func:`release_msg`, after its arrays were fully consumed
    this apply cycle) or *materialized* (:func:`materialize_msg`, before
    being retained), and a consumer must never block on a wire write while
    holding unreleased pins — the producer could be waiting on this very
    ring's free space (see ``shard._handle_batch`` ordering).
    """

    def __init__(self, ring: "ShmRing", codec: RowCodec, bell_r: int,
                 stop: threading.Event,
                 trace: Optional["trace_mod.TraceHub"] = None):
        self.ring = ring
        self.codec = codec
        self.bell_r = bell_r
        self.stop = stop
        self.closed = False
        self.trace = trace
        self._warned_stale = False
        self._pos = 0          # absolute decode cursor
        self._released = 0     # absolute head we last published
        self._pending: deque = deque()   # pinned FrameHandles, stream order
        self._lock = threading.Lock()

    # head may only advance to the start of the first still-pinned frame
    # (or all the way to the decode cursor when nothing is pinned)
    def _advance_locked(self) -> None:
        while self._pending and self._pending[0].released:
            self._pending.popleft()
        new_head = self._pending[0].start if self._pending else self._pos
        if new_head > self._released:
            self._released = new_head
            self.ring._set_head(new_head)

    def pinned_frames(self) -> int:
        with self._lock:
            return len(self._pending)

    def _copy_out(self, pos: int, n: int) -> bytes:
        cap = self.ring.capacity
        off = pos % cap
        first = min(n, cap - off)
        base = ShmRing.HDR
        out = bytes(self.ring.buf[base + off:base + off + first])
        if first < n:
            out += bytes(self.ring.buf[base:base + n - first])
        return out

    def _decode_ready(self) -> list:
        out: list = []
        cap = self.ring.capacity
        t0 = time.monotonic_ns() if self.trace is not None else 0
        while not self.closed:
            tail = self.ring._tail()
            # validate the cross-process cursor read exactly like
            # ShmRing.read_available: a stale/torn value must never reach
            # the arithmetic below (it would replay or overrun the stream)
            if tail < self._pos or tail - self._released > cap:
                if not self._warned_stale:
                    self._warned_stale = True
                    log.warning(
                        "shm view reader: stale cross-process tail cursor "
                        "read (tail=%d decode_pos=%d released=%d cap=%d); "
                        "treating as empty and retrying [warned once per "
                        "ring]", tail, self._pos, self._released, cap)
                break
            if tail - self._pos < 4:
                break
            plen = _U32.unpack(self._copy_out(self._pos, 4))[0]
            if plen == EOF_LEN:
                self.closed = True
                with self._lock:
                    self._pos += 4
                    self._advance_locked()
                break
            if tail - self._pos < 4 + plen:
                break               # defensive: frames publish atomically
            start = self._pos
            body = start + 4
            end = body + plen
            off = body % cap
            pinned = off + plen <= cap      # contiguous span in the ring
            if pinned:
                base = ShmRing.HDR
                mv = self.ring.buf[base + off:base + off + plen]
            else:                           # straddles the wrap: copy out
                mv = memoryview(self._copy_out(body, plen))
            if plen >= 8 and _U32.unpack_from(mv, 0)[0] == RAW_MAGIC:
                msgs = self.codec.decode_raw(mv)
                with self._lock:
                    if pinned and msgs:
                        h = FrameHandle(self, start, end, len(msgs))
                        for m in msgs:
                            m._frame = h
                        self._pending.append(h)
                    self._pos = end
                    self._advance_locked()
            else:
                msgs = decode_payload(bytes(mv))    # owned: copy, no pin
                with self._lock:
                    self._pos = end
                    self._advance_locked()
            out.extend(msgs)
        if out and self.trace is not None:
            self.trace.span(trace_mod.EV_WIRE_DECODE, t0, len(out), 0,
                            threading.current_thread().name)
        return out

    def read_msgs(self) -> Optional[list]:
        """Block until at least one message is decodable; None on EOF/stop."""
        while True:
            msgs = self._decode_ready()
            if msgs:
                return msgs
            if self.closed or self.stop.is_set():
                return None
            try:
                os.read(self.bell_r, 1 << 16)   # park until the bell rings
            except OSError:
                return None                     # bell closed: teardown


def view_reader_loop(reader: RingViewReader, inbox: queue.Queue,
                     on_error: Callable[[BaseException], None]) -> None:
    try:
        while True:
            msgs = reader.read_msgs()
            if msgs is None:
                return
            for m in msgs:
                inbox.put(m)
    except BaseException as e:      # surfaced into RunStats by the runtime
        on_error(e)


def start_view_reader(name: str, reader: RingViewReader, inbox: queue.Queue,
                      on_error: Callable[[BaseException], None],
                      ) -> threading.Thread:
    t = threading.Thread(target=view_reader_loop,
                         args=(reader, inbox, on_error),
                         name=name, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# a forked client's final state, over a pipe
# ---------------------------------------------------------------------------


def _write_all(fd: int, data) -> None:
    mv = memoryview(data).cast("B")
    while mv:
        mv = mv[os.write(fd, mv):]


def _read_exact(fd: int, n: int, deadline: float) -> Optional[bytearray]:
    """``n`` bytes read into one buffer allocated once; None if the writer
    closed first or the deadline passed."""
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        left = deadline - time.monotonic()
        if left <= 0 or not select.select([fd], [], [], left)[0]:
            return None
        k = os.readv(fd, [mv[got:]])
        if k == 0:
            return None
        got += k
    return buf


def send_state(fd: int, obj) -> None:
    """Write ``obj`` to a pipe as pickle-5 with its array buffers out of
    band: ``u64 n_parts | u64 size * n_parts | head | buffers``.

    A client ships its final cache and update totals this way (hundreds of
    MB each at LDA's width).  ``multiprocessing.Connection.recv`` reads a
    large message by asking for all the remaining bytes on every read,
    which allocates that size once a pipe-sized chunk; on the card's host
    that made the transfer the largest part of a run's wall.
    :func:`recv_state` reads each part straight into one buffer of its
    size.  ``tools/time_wire.py`` times both ways (PERF.md has the
    numbers)."""
    if hasattr(fcntl, "F_SETPIPE_SZ"):       # Linux: fewer, larger writes
        try:
            fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, 1 << 20)
        except OSError:
            pass                                # capped by the host: keep it
    bufs: List[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    parts = [head] + [b.raw() for b in bufs]
    sizes = [len(head)] + [r.nbytes for r in parts[1:]]
    _write_all(fd, struct.pack(f"<{len(sizes) + 1}Q", len(sizes), *sizes))
    for part in parts:
        _write_all(fd, part)


def recv_state(fd: int, deadline: float):
    """Inverse of :func:`send_state`: the object (its arrays backed by the
    buffers read), or None if the writer closed first or the deadline
    passed."""
    head = _read_exact(fd, 8, deadline)
    if head is None:
        return None
    n = _U64.unpack(head)[0]
    sizes = _read_exact(fd, 8 * n, deadline)
    if sizes is None:
        return None
    parts = []
    for size in struct.unpack(f"<{n}Q", sizes):
        part = _read_exact(fd, size, deadline)
        if part is None:
            return None
        parts.append(part)
    return pickle.loads(parts[0], buffers=parts[1:])


# ---------------------------------------------------------------------------
# wire-backed channels
# ---------------------------------------------------------------------------


class WireChannel:
    """Channel facade over a byte sink: stamps seqs, writes framed batches.

    Same duck type as :class:`repro_torch.runtime.messages.Channel`
    (``send`` / ``send_many``); the seq stamp and the wire write happen
    under one lock so sequence numbers are monotone in *stream order* even
    with multiple sender threads (all workers of a client process share the
    proc->shard edge).
    """

    def __init__(self, name: str, write: Callable[[bytes], None],
                 max_frame: Optional[int] = None,
                 try_write: Optional[Callable[[bytes], bool]] = None,
                 room: Optional[Callable[[], int]] = None,
                 codec: Optional[RowCodec] = None,
                 on_flush: Optional[Callable[[], None]] = None,
                 trace: Optional["trace_mod.TraceHub"] = None):
        self.name = name
        self._write = write
        self._max_frame = max_frame    # soft cap: split batches above this
        self._try_write = try_write    # non-blocking sink (drop-and-resync)
        self._room = room              # its free-space probe
        self._seq = 0
        self._lock = threading.Lock()
        self._codec = codec            # raw row-block encoding (zero-copy)
        self._on_flush = on_flush      # rung once per send_many, not per
                                       # frame (batched doorbell wakes)
        self._trace = trace

    def send(self, msg) -> None:
        self.send_many([msg])

    def send_many(self, msgs: list) -> None:
        if not msgs:
            return
        trc = self._trace
        t0 = time.monotonic_ns() if trc is not None else 0
        with self._lock:
            for m in msgs:
                m.seq = self._seq
                self._seq += 1
            self._write_frames(msgs)
            if self._on_flush is not None:
                self._on_flush()
        if trc is not None:
            trc.span(trace_mod.EV_WIRE_WRITE, t0, len(msgs), 0, self.name)

    def _write_frames(self, msgs: list) -> None:
        """Encode and write, halving batches that exceed the frame cap (a
        bounded wire like a shm ring cannot take arbitrarily large frames;
        a single oversized message still goes out whole — size the ring for
        the largest single row part)."""
        if self._codec is not None:
            first = True
            for item in self._codec.frames(msgs, self._max_frame):
                if not first and self._on_flush is not None:
                    # Earlier frames of this batch are published but not yet
                    # belled; if this next write blocks on ring space, the
                    # parked reader must be woken to drain them or neither
                    # side can ever advance (the wake byte persists in the
                    # pipe, so ringing before the write cannot be lost).
                    # The common single-frame flush keeps exactly one bell:
                    # the send_many/close on_flush after the write.
                    self._on_flush()
                self._write(item)
                first = False
            return
        frame = encode_frame(msgs)
        if (self._max_frame is not None and len(frame) > self._max_frame
                and len(msgs) > 1):
            mid = len(msgs) // 2
            self._write_frames(msgs[:mid])
            self._write_frames(msgs[mid:])
            return
        self._write(frame)

    # -------------------------------------------------- non-blocking sends
    def room(self) -> int:
        """Free sink bytes right now (a channel built with ``room``)."""
        return self._room()

    def try_send_many(self, msgs: list) -> bool:
        """Send one frame without blocking; False (and NO seq consumed —
        the stamp rolls back) when the sink has no room right now.  Needs
        a channel built with ``try_write``.  The serving publish path uses
        this so a wedged replica can never stall the shard: its frames are
        dropped and it is re-bootstrapped with a fresh in-stream state once
        the sink drains."""
        if not msgs:
            return True
        with self._lock:
            for m in msgs:
                m.seq = self._seq
                self._seq += 1
            frame = encode_frame(msgs)
            if self._try_write(frame):
                return True
            self._seq -= len(msgs)     # dropped: the stream never saw them
            return False

    def close(self) -> None:
        try:
            self._write(eof_frame())
            if self._on_flush is not None:
                self._on_flush()    # wake the reader so it sees the EOF
        except (OSError, ValueError, RuntimeError):
            pass    # peer gone / ring full past deadline; EOF is best-effort


def _reader_loop(read_chunk: Callable[[], Optional[bytes]],
                 inbox: queue.Queue,
                 on_error: Callable[[BaseException], None],
                 trace: Optional["trace_mod.TraceHub"] = None) -> None:
    """Pump a byte source into an inbox until EOF. `read_chunk` returns b''
    to mean try-again (ring empty) and None on hard end-of-stream."""
    dec = FrameDecoder()
    tname = threading.current_thread().name
    try:
        while not dec.closed:
            chunk = read_chunk()
            if chunk is None:
                break
            if not chunk:
                continue
            t0 = time.monotonic_ns() if trace is not None else 0
            msgs = dec.feed(chunk)
            if msgs and trace is not None:
                trace.span(trace_mod.EV_WIRE_DECODE, t0, len(msgs), 0, tname)
            for msg in msgs:
                inbox.put(msg)
    except BaseException as e:      # surfaced into RunStats by the runtime
        on_error(e)


def start_reader(name: str, read_chunk: Callable[[], Optional[bytes]],
                 inbox: queue.Queue,
                 on_error: Callable[[BaseException], None],
                 trace: Optional["trace_mod.TraceHub"] = None,
                 ) -> threading.Thread:
    t = threading.Thread(target=_reader_loop,
                         args=(read_chunk, inbox, on_error, trace),
                         name=name, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# TCP backend
# ---------------------------------------------------------------------------


class TcpConn:
    """One accepted/connected socket carrying a duplex client<->shard edge."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # channels idle for long stretches are normal (a client with no
        # inbound deliveries); never let a connect/accept timeout linger
        # and poison recv() mid-run
        sock.settimeout(None)

    def write(self, data: bytes) -> None:
        self.sock.sendall(data)

    def read_chunk(self) -> Optional[bytes]:
        data = self.sock.recv(1 << 16)
        return data if data else None

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class TcpSendQueue:
    """Bounded non-blocking sink over a :class:`TcpConn`: whole frames queue
    in this process up to ``capacity`` bytes, and one writer thread sends
    them in order with the connection's blocking ``write``.

    The serving tier's tcp publish edge rides this rather than a probe of
    the free kernel send buffer (a few MB at most), which a delta frame at
    a real model's width never fits: the replica would stay stale for good.
    ``room`` and ``try_write`` here behave like a shared-memory ring's of
    the same capacity — a wedged peer fills the queue, and the shard drops
    and resyncs instead of stalling."""

    def __init__(self, conn: TcpConn, capacity: int, name: str,
                 on_error: Callable[[BaseException], None]):
        self.conn = conn
        self.capacity = int(capacity)
        self._frames: deque = deque()
        self._queued = 0                   # bytes queued or being written
        self._closed = False
        self._cond = threading.Condition()
        self._on_error = on_error
        self.thread = threading.Thread(target=self._loop, name=name,
                                       daemon=True)
        self.thread.start()

    def room(self) -> int:
        with self._cond:
            return self.capacity - self._queued

    def try_write(self, data: bytes) -> bool:
        """Queue ``data`` iff it fits right now; never blocks."""
        with self._cond:
            if self._closed or self._queued + len(data) > self.capacity:
                return False
            self._frames.append(data)
            self._queued += len(data)
            self._cond.notify_all()
            return True

    def write(self, data: bytes) -> None:
        """Blocking counterpart of :meth:`try_write`: wait for room."""
        if len(data) > self.capacity:
            raise ValueError(f"frame of {len(data)} bytes exceeds the send "
                             f"queue's capacity {self.capacity}")
        with self._cond:
            while not self._closed and (self._queued + len(data)
                                        > self.capacity):
                self._cond.wait()
            if self._closed:
                raise RuntimeError("tcp send queue closed")
            self._frames.append(data)
            self._queued += len(data)
            self._cond.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._frames and not self._closed:
                    self._cond.wait()
                if not self._frames:
                    return                 # closed and drained
                data = self._frames[0]
            try:
                self.conn.write(data)
            except OSError as e:           # peer gone: drop what is queued
                with self._cond:
                    if not self._closed:
                        self._on_error(e)
                    self._frames.clear()
                    self._queued = 0
                return
            with self._cond:
                self._frames.popleft()
                self._queued -= len(data)
                self._cond.notify_all()    # room for a blocked write()

    def close(self, timeout: float = 5.0) -> None:
        """Stop taking frames, let the writer drain what is queued (up to
        ``timeout``), then close the socket: the FIN ends the peer's
        reader, and a writer still blocked on a stuck peer fails out."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.thread.join(timeout)
        self.conn.close()


class TcpTransport:
    """Listener + handshake: one loopback connection per (process, shard).

    Parent: ``listen()`` before forking, then ``accept_all()``.  Child:
    ``connect(pid)`` opens its ``n_shards`` connections, each starting with
    an 8-byte ``(pid, sid)`` handshake so the parent can route it.
    """

    def __init__(self, n_proc: int, n_shards: int):
        self.n_proc = n_proc
        self.n_shards = n_shards
        self._lsock: Optional[socket.socket] = None
        self.port = 0

    def listen(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(self.n_proc * self.n_shards)
        self._lsock = s
        self.port = s.getsockname()[1]

    def accept_all(self, deadline: float) -> Dict[Tuple[int, int], TcpConn]:
        conns: Dict[Tuple[int, int], TcpConn] = {}
        if self._lsock is None:
            raise RuntimeError("tcp transport: accept_all() before listen()")
        self._lsock.settimeout(1.0)
        want = self.n_proc * self.n_shards
        while len(conns) < want:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"tcp transport: only {len(conns)}/{want} channels "
                    "connected before deadline")
            try:
                sock, _ = self._lsock.accept()
            except socket.timeout:
                continue
            try:
                # the 8-byte handshake must also respect the deadline — a
                # connector that dies (or a stray local client) must not
                # wedge start() in a blocking recv
                sock.settimeout(5.0)
                hs = _recv_exact(sock, 8)
            except (socket.timeout, ConnectionError, OSError):
                sock.close()
                continue
            pid, sid = _U32.unpack_from(hs, 0)[0], _U32.unpack_from(hs, 4)[0]
            if (pid >= self.n_proc or sid >= self.n_shards
                    or (pid, sid) in conns):   # out-of-range or duplicate:
                sock.close()                   # never split a FIFO channel
                continue                       # across two sockets
            conns[(pid, sid)] = TcpConn(sock)
        self._lsock.close()
        self._lsock = None
        return conns

    def connect(self, pid: int) -> Dict[int, TcpConn]:
        out: Dict[int, TcpConn] = {}
        for sid in range(self.n_shards):
            s = socket.create_connection(("127.0.0.1", self.port), timeout=30)
            s.sendall(_U32.pack(pid) + _U32.pack(sid))
            out[sid] = TcpConn(s)
        return out

    def close_listener(self) -> None:
        if self._lsock is not None:
            self._lsock.close()
            self._lsock = None


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("handshake: peer closed early")
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# shared-memory ring backend
# ---------------------------------------------------------------------------


class ShmRing:
    """Single-producer single-consumer byte ring in a SharedMemory segment.

    Layout: ``u64 head | u64 tail | data[capacity]``.  ``head`` (read
    cursor) is written only by the consumer, ``tail`` (write cursor) only by
    the producer; both are monotonically increasing byte counts taken modulo
    ``capacity`` on access, so no lock is needed across processes.  The
    counters are updated strictly *after* the corresponding memcpy, which on
    CPython (no store reordering across bytecode, x86 TSO) makes the data
    visible before the cursor that publishes it.

    Both sides additionally *validate* every cross-process cursor read
    (``head <= tail <= head + capacity``): on some virtualized hosts a read
    of the peer's cursor can transiently return a stale value, and acting
    on one would rewind the read cursor (stream replay) or overstate free
    space (overwrite).  A bogus reading is treated as "empty"/"full" and
    retried — monotone cursors guarantee a sane reading follows.
    """

    HDR = 16

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int):
        self.shm = shm
        self.capacity = capacity
        self.buf = shm.buf
        self._warned_stale = False

    @classmethod
    def create(cls, capacity: int) -> "ShmRing":
        shm = shared_memory.SharedMemory(create=True,
                                         size=cls.HDR + capacity)
        shm.buf[:cls.HDR] = b"\0" * cls.HDR
        return cls(shm, capacity)

    # cursor accessors -----------------------------------------------------
    def _head(self) -> int:
        return _U64.unpack_from(self.buf, 0)[0]

    def _tail(self) -> int:
        return _U64.unpack_from(self.buf, 8)[0]

    def _set_head(self, v: int) -> None:
        _U64.pack_into(self.buf, 0, v)

    def _set_tail(self, v: int) -> None:
        _U64.pack_into(self.buf, 8, v)

    # producer -------------------------------------------------------------
    def write(self, data: bytes, deadline: float = float("inf")) -> None:
        """Block (spin + short sleep) until `data` fits, then publish it."""
        spins = 0
        while not self.try_write(data):
            spins += 1
            if spins > 100:
                if time.monotonic() > deadline:
                    raise RuntimeError("shm ring write timed out (peer stuck)")
                time.sleep(2e-4)

    def free_bytes(self) -> int:
        """Bytes writable right now, from the producer's view.

        ``tail`` is the producer's own cursor (trusted); ``head`` crosses a
        process boundary, and on virtualized hosts a read can transiently
        return a stale value — an overstated head would report free space
        that isn't and let the producer overwrite unread bytes, so any
        out-of-range reading clamps to "full" and the caller retries (the
        cursors are monotone: a sane reading always comes around)."""
        used = self._tail() - self._head()
        if used < 0 or used > self.capacity:
            if not self._warned_stale:
                self._warned_stale = True
                log.warning(
                    "shm ring %s: stale cross-process head cursor read "
                    "(used=%d cap=%d); clamping to full and retrying "
                    "[warned once per ring]",
                    self.shm.name, used, self.capacity)
            return 0                    # stale/torn cursor read: treat full
        return self.capacity - used

    def try_write(self, data: bytes) -> bool:
        """Publish `data` iff it fits right now; never blocks or spins."""
        n = len(data)
        if n > self.capacity:
            raise ValueError(
                f"frame of {n} bytes exceeds ring capacity {self.capacity}")
        if self.free_bytes() < n:
            return False
        tail = self._tail()
        pos = tail % self.capacity
        first = min(n, self.capacity - pos)
        off = self.HDR + pos
        self.buf[off:off + first] = data[:first]
        if first < n:                       # wrap around to the start
            self.buf[self.HDR:self.HDR + n - first] = data[first:]
        self._set_tail(tail + n)
        return True

    def try_write_parts(self, parts: list, total: int) -> bool:
        """Publish a multi-part frame iff it fits right now.  Each part is a
        bytes-like buffer (the RowCodec's fixed headers and the messages'
        own array memoryviews); copying them into the ring one by one is
        the producer's single copy — no intermediate join."""
        if total > self.capacity:
            raise ValueError(
                f"frame of {total} bytes exceeds ring capacity "
                f"{self.capacity}")
        if self.free_bytes() < total:
            return False
        tail = self._tail()
        pos = tail % self.capacity
        for part in parts:
            mv = part if isinstance(part, memoryview) else memoryview(part)
            n = mv.nbytes
            first = min(n, self.capacity - pos)
            off = self.HDR + pos
            self.buf[off:off + first] = mv[:first]
            if first < n:                   # wrap around to the start
                self.buf[self.HDR:self.HDR + n - first] = mv[first:]
            pos = (pos + n) % self.capacity
        self._set_tail(tail + total)
        return True

    def write_parts(self, parts: list,
                    deadline: float = float("inf")) -> None:
        """Blocking counterpart of :meth:`try_write_parts`."""
        mvs, total = [], 0
        for p in parts:
            mv = p if isinstance(p, memoryview) else memoryview(p)
            mvs.append(mv)
            total += mv.nbytes
        spins = 0
        while not self.try_write_parts(mvs, total):
            spins += 1
            if spins > 100:
                if time.monotonic() > deadline:
                    raise RuntimeError("shm ring write timed out (peer stuck)")
                time.sleep(2e-4)

    # consumer -------------------------------------------------------------
    def read_available(self) -> bytes:
        """Drain and return whatever bytes are currently published.

        ``head`` is the consumer's own cursor (trusted); ``tail`` crosses a
        process boundary and can transiently read stale on virtualized
        hosts.  A bogus reading (behind head, or further ahead than the
        ring could hold) must NOT reach the arithmetic below — a negative
        count would *rewind* head and replay the whole stream — so it is
        treated as empty and retried; the doorbell byte that announced the
        real frame persists in the pipe, so no wakeup is lost."""
        head, tail = self._head(), self._tail()
        n = tail - head
        if n <= 0 or n > self.capacity:
            if (n < 0 or n > self.capacity) and not self._warned_stale:
                self._warned_stale = True
                log.warning(
                    "shm ring %s: stale cross-process tail cursor read "
                    "(n=%d cap=%d); treating as empty and retrying "
                    "[warned once per ring]", self.shm.name, n, self.capacity)
            return b""
        pos = head % self.capacity
        first = min(n, self.capacity - pos)
        off = self.HDR + pos
        out = bytes(self.buf[off:off + first])
        if first < n:
            out += bytes(self.buf[self.HDR:self.HDR + n - first])
        self._set_head(head + n)
        return out

    def close(self) -> None:
        self.buf = None
        try:
            self.shm.close()
        except BufferError:
            # a zero-copy numpy view into the segment is still referenced
            # somewhere (e.g. a message abandoned by an aborted run); the
            # mapping is reclaimed at process exit, and unlink() below
            # works regardless
            pass

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class ShmEdge:
    """The two rings of one client<->shard pair (c2s = client writes), each
    with a pipe *doorbell*: the producer writes a wake byte after publishing
    a frame, so the consumer blocks in ``os.read`` (a real kernel sleep that
    releases the GIL) instead of polling.  Sub-ms polling is not an option —
    each poll wakeup forces a GIL handoff, and a few fine-grained pollers
    measurably halve a worker thread's throughput on a small host."""

    def __init__(self, capacity: int):
        self.c2s = ShmRing.create(capacity)
        self.s2c = ShmRing.create(capacity)
        self.c2s_bell = os.pipe()
        self.s2c_bell = os.pipe()
        for _, w in (self.c2s_bell, self.s2c_bell):
            os.set_blocking(w, False)

    @staticmethod
    def ring_bell(bell_w: int) -> None:
        try:
            os.write(bell_w, b"\x01")
        except (BlockingIOError, OSError):
            pass        # pipe full of pending wakeups / peer gone: fine

    def wake_all(self) -> None:
        """Unblock any reader parked on a doorbell (teardown path)."""
        for _, w in (self.c2s_bell, self.s2c_bell):
            self.ring_bell(w)

    def close(self, unlink: bool) -> None:
        for ring in (self.c2s, self.s2c):
            ring.close()
            if unlink:
                ring.unlink()
        for r, w in (self.c2s_bell, self.s2c_bell):
            for fd in (r, w):
                try:
                    os.close(fd)
                except OSError:
                    pass


class ShmTransport:
    """Pre-forked shared-memory edges; children inherit the mappings."""

    def __init__(self, n_proc: int, n_shards: int, capacity: int = 1 << 20):
        require_tso()
        self.edges: Dict[Tuple[int, int], ShmEdge] = {
            (p, s): ShmEdge(capacity)
            for p in range(n_proc) for s in range(n_shards)}

    def close(self, unlink: bool) -> None:
        for e in self.edges.values():
            e.wake_all()               # unpark doorbell readers first
        for e in self.edges.values():
            e.close(unlink)


def ring_writer(ring: ShmRing, bell_w: int,
                deadline: float = float("inf")) -> Callable[[bytes], None]:
    """Byte sink for a :class:`WireChannel`: publish, then ring the bell."""
    def write(data: bytes) -> None:
        ring.write(data, deadline)
        ShmEdge.ring_bell(bell_w)
    return write


def ring_parts_writer(ring: ShmRing, deadline: float = float("inf"),
                      ) -> Callable[[object], None]:
    """Byte sink for a zero-copy :class:`WireChannel`: accepts either a
    plain bytes frame (EOF sentinel, pickle frame) or a RowCodec list of
    buffers, and does NOT ring the doorbell itself — the channel rings via
    ``on_flush``: once after a single-frame send_many (the common case),
    and once per frame when a batch splits, so a producer blocking on ring
    space can never strand published-but-unbelled frames behind a parked
    reader."""
    def write(item) -> None:
        if isinstance(item, (bytes, bytearray, memoryview)):
            ring.write(item, deadline)
        else:
            ring.write_parts(item, deadline)
    return write


def try_ring_writer(ring: ShmRing, bell_w: int) -> Callable[[bytes], bool]:
    """Non-blocking byte sink for ``WireChannel.try_send_many``: publish iff
    the frame fits right now, ringing the bell only on success."""
    def try_write(data: bytes) -> bool:
        if ring.try_write(data):
            ShmEdge.ring_bell(bell_w)
            return True
        return False
    return try_write


def ring_reader(ring: ShmRing, bell_r: int,
                stop: threading.Event) -> Callable[[], Optional[bytes]]:
    """read_chunk adapter for :func:`_reader_loop` over a ShmRing: drain
    whatever is published, else park on the doorbell until the producer
    rings.  A stale wake byte (data already drained) just loops once more;
    a wake byte can never be missed because it persists in the pipe."""
    def read_chunk() -> Optional[bytes]:
        data = ring.read_available()
        if data:
            return data
        if stop.is_set():
            return None
        try:
            os.read(bell_r, 1 << 16)       # kernel sleep until a frame lands
        except OSError:
            return None                    # bell closed: teardown
        return b""
    return read_chunk
