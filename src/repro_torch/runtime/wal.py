"""Per-shard write-ahead delta log (the runtime's durability tier).

Each shard slot appends the update parts it applies — *after* the in-memory
apply, FIFO behind it — to an append-only segment file, then group-commits
the batch at clock boundaries: when the shard's applied vector clock moves
(a ClockMsg arrived), the buffered frames are written out followed by a
vc *stamp* record, exactly the serving-publish discipline (deltas FIFO,
then :class:`~repro_torch.runtime.messages.ReplicaVcMsg`).  Recovery
becomes ``snapshot + replay(log, upto_vc)``
(:func:`repro_torch.runtime.snapshot.recover_to_vc`, which replays on the
card through ``ps_apply``): an empty snapshot (genesis) plus a full replay,
or a periodic snapshot plus the per-slot log *suffix* it does not already
cover.

Wire format — one format for the wire and the disk
--------------------------------------------------
A segment is a stream of the runtime's ordinary wire frames
(``u32 payload_len | payload``, :mod:`repro_torch.runtime.transport`):

* **raw row-block frames** (:class:`~repro_torch.runtime.transport.RowCodec`,
  the zero-copy codec, byte for byte the JAX package's): the coalesced
  ``UpdateMsg`` runs of one apply cycle, each part's uid / origin process /
  ts / epoch / key in the fixed 48-byte struct header, then its global row
  ids and f64 deltas — nothing else is needed to replay it as an ordered
  scatter-add onto a full-key buffer;
* **pickle-5 frames** (the fallback for everything that is not an f64 row
  block): the ``ReplicaVcMsg`` vc stamps, and any update part that is not
  raw-eligible.  A pickle names its class's module, so a stamp written by
  one package does not load in the other: the packages share snapshots
  (:mod:`repro_torch.runtime.snapshot`), not segment files;
* the ``EOF_LEN`` sentinel marks a *sealed* segment (clean close: segment
  rotation, runtime teardown, and the epoch cut of a slot that a
  membership op retires).
  A segment without it is torn — killed mid-write — and the reader
  recovers cleanly to the last complete record (:func:`read_segment`).

Segment files are named ``s{sid:02d}_p{start_part:012d}_g{gen:04d}.wal``
where ``start_part`` is the slot-global index of the segment's first logged
part (``gen`` only keeps names unique across seal/reopen cycles);
the name alone gives every record its exact position in the slot's log, so
a snapshot stamped with per-slot logged-part counts (``wal_parts``) marks
the exact per-slot prefix it covers — positional, not clock-fuzzy.

Durability policies (``RuntimeConfig(wal_fsync=...)``):

* ``"none"`` (default) — group-commit writes ``flush()`` to the OS page
  cache at each clock boundary; survives process kills, not host power
  loss.  This is the hot-path configuration: no fsync ever sits between
  two applies (seal/rotation still fsync).
* ``"boundary"`` — ``fsync`` after every group commit; survives power
  loss to the last completed clock boundary, at the cost of one fsync per
  shard and boundary (``ShardMetrics.wal_fsync_s``).

The writer is single-threaded by construction: only the owning shard's
thread calls :meth:`WalWriter.log_parts` (under the shard lock, so the
logged-part counters stay consistent with the dense state a snapshot
captures), :meth:`WalWriter.commit` and :meth:`WalWriter.seal`; the
metrics collector reads the counters racily like every other shard
counter.  Everything here is host state: the frames are encoded from the
host arrays the shard received, before any copy to the card.
"""
from __future__ import annotations

import logging
import os
import re
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.messages import DeliverMsg, ReplicaVcMsg, UpdateMsg
from repro_torch.runtime.transport import (EOF_LEN, RAW_MAGIC, RowCodec,
                                           decode_payload, encode_frame,
                                           eof_frame)

_U32 = struct.Struct("<I")

log = logging.getLogger("repro_torch.runtime.wal")

FSYNC_POLICIES: Tuple[str, ...] = ("none", "boundary")

_SEG_RE = re.compile(r"^s(\d+)_p(\d+)_g(\d+)\.wal$")


def segment_name(sid: int, start_part: int, gen: int) -> str:
    """``start_part`` positions the segment in the slot's log; ``gen`` is a
    per-writer monotone counter that keeps names unique when a slot seals
    and reopens without logging new parts in between (kill + rejoin)."""
    return f"s{sid:02d}_p{start_part:012d}_g{gen:04d}.wal"


class WalWriter:
    """Append-only per-slot delta log (module docstring).

    ``parts`` / ``applied`` / ``max_ts`` are the slot's durability marks:
    total parts logged, per-origin-process part counts, and the per-process
    maximum update timestamp logged — bumped in :meth:`log_parts` under the
    same shard lock as the dense apply, so a snapshot reading them with the
    dense state (``ServerShard.durability_cut``) captures an exact log
    prefix.
    """

    def __init__(self, dir_path: str, sid: int, codec: RowCodec,
                 n_proc: int, fsync: str = "none",
                 segment_bytes: int = 1 << 22):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"unknown wal fsync policy {fsync!r}; "
                             f"choose from {FSYNC_POLICIES}")
        self.dir = dir_path
        self.sid = sid
        self.codec = codec
        self.n_proc = n_proc
        self.fsync = fsync
        self.segment_bytes = max(1, int(segment_bytes))
        # durability marks (single-writer: the shard thread, under its lock)
        self.parts = 0                    # parts logged (pending + written)
        self.applied = np.zeros(n_proc, dtype=np.int64)
        self.max_ts = np.full(n_proc, -1, dtype=np.int64)
        self._written = 0                 # parts written to segment files
        self._pending: List[bytes] = []   # encoded frames awaiting commit
        self._pending_t0 = 0.0            # monotonic ts of oldest pending
        self._stamp_prefix: Optional[bytes] = None  # cached stamp wire prefix
        self._file = None
        self._seg_size = 0
        # metrics (racy readers: repro_torch.runtime.metrics)
        self.m_commits = 0
        self.m_bytes = 0                  # bytes written, EOF sentinels too
        self.m_segments = 0
        self.m_fsync_s = 0.0

    # ---------------------------------------------------------------- append
    def log_parts(self, run: List[UpdateMsg]) -> None:
        """Append one apply cycle's update parts (FIFO-behind the apply;
        called under the shard lock).  Frames are *encoded to owned bytes*
        immediately — ring-backed zero-copy views are only valid while the
        cycle's frame pins are held — but not written until :meth:`commit`
        (group commit at the clock boundary)."""
        if not run:
            return
        if not self._pending:
            self._pending_t0 = time.monotonic()
        for item in self.codec.frames(run, None):
            if isinstance(item, list):    # raw frame: list of buffers
                # join() reads the buffer views directly — ONE copy into
                # owned bytes, no per-piece bytes() materialization
                self._pending.append(b"".join(item))
            else:                         # pickle fallback: already bytes
                self._pending.append(item)
        for m in run:
            self.applied[m.process] += 1
            if m.ts > self.max_ts[m.process]:
                self.max_ts[m.process] = m.ts
        self.parts += len(run)

    def _stamp_frame(self, vc: np.ndarray) -> bytes:
        """Encoded vc-stamp frame (the serving-publish record shape).

        Every stamp this writer emits has an identical wire prefix — same
        shard id, same ``(n_proc,)`` int64 vc — with only the trailing
        out-of-band buffer (the vc values) changing, so the prefix is
        computed once with :func:`encode_frame` and reused on the commit
        hot path.  The cacheability assumption is checked byte-for-byte on
        the first stamp; if the frame does not end with the raw vc bytes
        (e.g. a pickle that inlines the array), every stamp falls back to
        a full encode.
        """
        vc = np.ascontiguousarray(vc, dtype=np.int64)
        raw = vc.tobytes()
        if self._stamp_prefix is None:
            full = encode_frame([ReplicaVcMsg(self.sid, vc.copy())])
            self._stamp_prefix = (full[:-len(raw)]
                                  if full.endswith(raw) else b"")
            return full
        if not self._stamp_prefix:       # b"" sentinel: not cacheable
            return encode_frame([ReplicaVcMsg(self.sid, vc.copy())])
        return self._stamp_prefix + raw

    def commit(self, vc: np.ndarray) -> None:
        """Group commit at a clock boundary: write the pending frames plus
        a vc stamp (FIFO-after every part it covers, like the publish
        stream), then apply the fsync policy and rotate if the segment
        outgrew ``segment_bytes``."""
        frames = self._pending
        self._pending = []
        frames.append(self._stamp_frame(vc))
        self._write(frames)
        self._written = self.parts
        self.m_commits += 1
        if self.fsync == "boundary":
            self._do_fsync()
        if self._seg_size >= self.segment_bytes:
            self._close_segment()

    def seal(self, vc: Optional[np.ndarray] = None) -> None:
        """Flush everything, optionally stamp a final vc, write the EOF
        sentinel, fsync, and close the current segment.  Called at runtime
        teardown and at the epoch cut of a retiring slot; idempotent — a
        later :meth:`log_parts`/:meth:`commit` (slot re-activation) simply
        opens the next segment."""
        frames = self._pending
        self._pending = []
        if vc is not None and (frames or self._file is not None
                               or self.parts > self._written):
            frames.append(self._stamp_frame(vc))
        if not frames and self._file is None:
            return
        self._write(frames)
        self._written = self.parts
        self._close_segment()

    def marks(self) -> dict:
        """The durability marks a snapshot stores (read under the shard
        lock for consistency with the dense state)."""
        return {"parts": self.parts,
                "applied": self.applied.copy(),
                "max_ts": self.max_ts.copy()}

    @property
    def pending_age_s(self) -> float:
        """Age of the oldest uncommitted frame (wal append lag)."""
        if not self._pending:
            return 0.0
        return max(0.0, time.monotonic() - self._pending_t0)

    # -------------------------------------------------------------- plumbing
    def _ensure_open(self):
        if self._file is None:
            os.makedirs(self.dir, exist_ok=True)
            # the new segment starts at the first not-yet-written part
            path = os.path.join(self.dir, segment_name(
                self.sid, self._written, self.m_segments))
            self._file = open(path, "ab")
            self._seg_size = 0
            self.m_segments += 1
        return self._file

    def _write(self, frames: List[bytes]) -> None:
        if not frames:
            return
        f = self._ensure_open()
        # one buffer, one write(), one flush() syscall: every GIL release
        # on this path is a chance for a worker thread to steal the shard
        # thread's quantum, so the syscall count sets the hot path's cost
        blob = frames[0] if len(frames) == 1 else b"".join(frames)
        f.write(blob)
        f.flush()
        self._seg_size += len(blob)
        self.m_bytes += len(blob)

    def _do_fsync(self) -> None:
        t0 = time.monotonic()
        os.fsync(self._file.fileno())
        self.m_fsync_s += time.monotonic() - t0

    def _close_segment(self) -> None:
        if self._file is None:
            return
        eof = eof_frame()
        self._file.write(eof)
        self._file.flush()
        # the sentinel is bytes on disk too, so m_bytes sums to the
        # segments' sizes (the JAX package's writer leaves it out)
        self.m_bytes += len(eof)
        self._do_fsync()
        self._file.close()
        self._file = None
        self._seg_size = 0


# ---------------------------------------------------------------------------
# read side (recovery)
# ---------------------------------------------------------------------------


def wal_segments(dir_path: str) -> Dict[int, List[Tuple[int, str]]]:
    """List a wal directory's segments: ``{sid: [(start_part, path), ...]}``
    sorted by start position (log order) per slot."""
    out: Dict[int, List[Tuple[int, str]]] = {}
    if not os.path.isdir(dir_path):
        return out
    by: Dict[int, List[Tuple[int, int, str]]] = {}
    for name in os.listdir(dir_path):
        m = _SEG_RE.match(name)
        if m:
            sid, start, gen = (int(m.group(1)), int(m.group(2)),
                               int(m.group(3)))
            by.setdefault(sid, []).append(
                (start, gen, os.path.join(dir_path, name)))
    for sid, segs in by.items():
        segs.sort()
        out[sid] = [(start, path) for start, _, path in segs]
    return out


def read_segment(path: str, codec: RowCodec) -> Tuple[list, bool]:
    """Decode one segment into ``(records, sealed)``.

    ``records`` is a list of ``("parts", [UpdateMsg, ...])`` and
    ``("vc", ReplicaVcMsg)`` entries in log order; ``sealed`` is True when
    the EOF sentinel closed the stream.  A *torn tail* — the file truncated
    mid-record by a kill — stops the decode cleanly at the last complete
    record; bytes *after* the EOF sentinel, or a record that is present but
    undecodable, are corruption and raise."""
    with open(path, "rb") as f:
        data = f.read()
    mv = memoryview(data)
    n = len(data)
    out: list = []
    off = 0
    sealed = False
    while True:
        if off + 4 > n:
            break                              # torn: partial length prefix
        plen = _U32.unpack_from(mv, off)[0]
        if plen == EOF_LEN:
            if off + 4 != n:
                raise ValueError(f"wal segment {path!r}: data after EOF")
            sealed = True
            break
        if off + 4 + plen > n:
            break                              # torn: partial payload
        payload = mv[off + 4:off + 4 + plen]
        off += 4 + plen
        if plen >= 4 and _U32.unpack_from(payload, 0)[0] == RAW_MAGIC:
            out.append(("parts", codec.decode_raw(payload)))
            continue
        run: List[UpdateMsg] = []
        for msg in decode_payload(bytes(payload)):
            if isinstance(msg, ReplicaVcMsg):
                if run:
                    out.append(("parts", run))
                    run = []
                out.append(("vc", msg))
            elif isinstance(msg, (UpdateMsg, DeliverMsg)):
                run.append(msg)                # pickle-5 fallback parts
            else:
                raise ValueError(f"wal segment {path!r}: unexpected "
                                 f"record {type(msg).__name__}")
        if run:
            out.append(("parts", run))
    if not sealed and off < n:
        log.warning("wal segment %s: torn tail — %d trailing byte(s) of an "
                    "incomplete record dropped, recovered cleanly to the "
                    "last complete record (%d kept)",
                    path, n - off, len(out))
    return out, sealed


def prune_segments(dir_path: str,
                   covered_parts: Dict[int, int]) -> List[str]:
    """Delete segments *fully covered* by a snapshot's per-slot logged-part
    marks: segment ``[start, next_start)`` is removable iff a successor
    segment exists and ``next_start <= covered_parts[sid]`` (every part in
    it is positionally inside the snapshot's prefix).  A slot's last
    segment is never deleted — its start position anchors the log.  Returns
    the removed paths."""
    removed: List[str] = []
    for sid, segs in wal_segments(dir_path).items():
        cov = int(covered_parts.get(sid, 0))
        for (start, path), (next_start, _) in zip(segs, segs[1:]):
            if next_start <= cov:
                os.remove(path)
                removed.append(path)
    return removed
