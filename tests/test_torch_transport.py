"""The port's wire layer (``repro_torch.runtime.transport``), on the CPU.

Framing round trips under arbitrary chunking, short and truncated frames,
FIFO sequence stamping, the shared-memory ring (wraparound, back-pressure,
stale cursors), the raw zero-copy wire (views that alias the ring until
released, materialize, the wrap), doorbell batching, the tcp duplex and the
TSO refusal — the JAX package's ``tests/test_transport.py`` cases on the
port's classes.  Two cross-package tests hold the raw wire to the JAX
package's: the same seeded batches encode to byte-equal frames, and each
package decodes the other's frames to bitwise the same rows and deltas.
"""
import os
import platform
import queue
import struct
import threading
import time

import numpy as np
import pytest

from repro.runtime import messages as RM
from repro.runtime import transport as RT
from repro_torch.runtime import messages as M
from repro_torch.runtime import transport as T


def _msg_equal(a, b):
    assert type(a) is type(b)
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"{type(a)}.{f}")
            assert va.dtype == vb.dtype
        else:
            assert va == vb, f"{type(a).__name__}.{f}: {va} != {vb}"


def _sample_msgs(rng, n=20):
    """A mixed bag of every message type the port's wire carries, with
    randomized array payloads."""
    out = []
    for i in range(n):
        kind = i % 7
        rows = np.sort(rng.choice(64, size=rng.integers(1, 9), replace=False))
        delta = rng.normal(size=(len(rows), int(rng.integers(1, 5))))
        if kind == 0:
            out.append(M.UpdateMsg(i, int(rng.integers(4)), 0,
                                   int(rng.integers(10)), "k", rows, delta))
        elif kind == 1:
            out.append(M.DeliverMsg(i, 1, 0, 1, 3, "key/with|chars", rows,
                                    delta))
        elif kind == 2:
            out.append(M.AckBatchMsg(np.arange(i, i + 3, dtype=np.int64),
                                     int(rng.integers(4))))
        elif kind == 3:
            out.append(M.ClockMsg(int(rng.integers(4)), int(rng.integers(50)),
                                  load=rng.normal(size=3)))
        elif kind == 4:
            out.append(M.ClockMarker(0, 1, int(rng.integers(50))))
        elif kind == 5:
            out.append(M.FullyDelivered(i, 2, "k", rows, delta, 0))
        else:
            out.append(M.ProcDoneMsg(int(rng.integers(4))))
    out.append(M.ShardFinMsg(1))
    return out


def _ack(i):
    return M.AckBatchMsg(np.array([i], dtype=np.int64), 1)


# ---------------------------------------------------------------------------
# framing round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_roundtrip_all_types(seed):
    msgs = _sample_msgs(np.random.default_rng(seed))
    dec = T.FrameDecoder()
    got = dec.feed(T.encode_frame(msgs))
    assert len(got) == len(msgs)
    for a, b in zip(msgs, got):
        _msg_equal(a, b)
    assert dec.pending_bytes == 0


def test_frame_roundtrip_edge_arrays():
    """Empty rows, single element, large block, f32 vs f64, non-C-order."""
    big = np.random.default_rng(0).normal(size=(500, 64))
    cases = [
        M.UpdateMsg(0, 0, 0, 0, "k", np.arange(0), np.zeros((0, 3))),
        M.UpdateMsg(1, 0, 0, 0, "k", np.arange(1), np.ones((1, 1))),
        M.UpdateMsg(2, 0, 0, 0, "k", np.arange(500), big),
        M.DeliverMsg(3, 0, 0, 0, 0, "k", np.arange(4),
                     np.ones((4, 2), dtype=np.float32)),
        M.DeliverMsg(4, 0, 0, 0, 0, "k", np.arange(4),
                     np.asfortranarray(np.ones((4, 2)))),
    ]
    for msg in cases:
        got = T.FrameDecoder().feed(T.encode_frame([msg]))
        assert len(got) == 1
        _msg_equal(msg, got[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_decoder_handles_arbitrary_chunking(seed):
    """Byte-by-byte and random-split feeds yield identical messages:
    partial reads and short frames stay buffered, never error."""
    rng = np.random.default_rng(seed)
    msgs = _sample_msgs(rng, n=10)
    stream = b"".join(T.encode_frame([m]) for m in msgs)

    dec, got = T.FrameDecoder(), []
    for i in range(len(stream)):
        got.extend(dec.feed(stream[i:i + 1]))
    assert len(got) == len(msgs)
    for a, b in zip(msgs, got):
        _msg_equal(a, b)

    dec, got, off = T.FrameDecoder(), [], 0
    while off < len(stream):
        n = int(rng.integers(1, 200))
        got.extend(dec.feed(stream[off:off + n]))
        off += n
    assert len(got) == len(msgs)
    for a, b in zip(msgs, got):
        _msg_equal(a, b)
    assert dec.pending_bytes == 0


def test_short_frame_stays_buffered():
    frame = T.encode_frame([_ack(7)])
    dec = T.FrameDecoder()
    assert dec.feed(frame[:-1]) == []          # one byte short: no message
    assert dec.pending_bytes == len(frame) - 1
    got = dec.feed(frame[-1:])
    assert len(got) == 1 and got[0].uids.tolist() == [7]


def test_truncated_payload_raises():
    frame = bytearray(T.encode_frame([_ack(7)]))
    # lie about the payload length: claim 3 fewer bytes than the pickle needs
    plen = struct.unpack_from("<I", frame, 0)[0]
    struct.pack_into("<I", frame, 0, plen - 3)
    with pytest.raises(ValueError):
        T.FrameDecoder().feed(bytes(frame[:len(frame) - 3]))


def test_eof_sentinel_closes_stream():
    dec = T.FrameDecoder()
    msgs = dec.feed(T.encode_frame([_ack(1)]) + T.eof_frame())
    assert len(msgs) == 1
    assert dec.closed
    with pytest.raises(ValueError):
        dec.feed(b"\x00")


# ---------------------------------------------------------------------------
# seq stamping + FIFO assertions
# ---------------------------------------------------------------------------


def test_wirechannel_batches_and_stamps_seq():
    sink = bytearray()
    chan = T.WireChannel("c", sink.extend)
    chan.send_many([_ack(i) for i in range(5)])
    chan.send(M.ClockMsg(0, 9))
    got = T.FrameDecoder().feed(bytes(sink))
    assert [m.seq for m in got] == list(range(6))


def test_wirechannel_seq_monotone_across_threads():
    """Many sender threads share one channel: stream order carries
    contiguous seqs (stamp + write are atomic under the channel lock)."""
    sink = bytearray()
    lock = threading.Lock()

    def write(data):
        with lock:
            sink.extend(data)

    chan = T.WireChannel("c", write)

    def sender(base):
        for i in range(50):
            chan.send(_ack(base * 1000 + i))

    threads = [threading.Thread(target=sender, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    got = T.FrameDecoder().feed(bytes(sink))
    assert [m.seq for m in got] == list(range(200))
    fifo = T.FifoAssert()
    assert all(fifo.check("c", m.seq) is None for m in got)


def test_fifo_assert_detects_gap_reorder_replay():
    fifo = T.FifoAssert()
    assert fifo.check("a", 0) is None
    assert fifo.check("a", 1) is None
    assert "seq 3 after 1" in fifo.check("a", 3)      # gap
    assert fifo.check("a", 4) is None                 # resynced after gap
    assert fifo.check("b", 0) is None                 # per-sender state
    fifo2 = T.FifoAssert()
    fifo2.check("a", 0)
    assert fifo2.check("a", 0) is not None            # replay
    fifo3 = T.FifoAssert()
    fifo3.check("a", 1)                               # starts past 0: gap
    assert fifo3.check("a", 0) is not None            # reorder


def test_wirechannel_splits_batches_over_max_frame():
    """Batches above the frame cap split into several frames (a bounded
    ring cannot take arbitrarily large frames); FIFO seqs stay contiguous."""
    frames = []
    msgs = [M.UpdateMsg(i, 0, 0, 0, "k", np.arange(16),
                        np.ones((16, 16))) for i in range(32)]
    one = len(T.encode_frame([msgs[0]]))
    chan = T.WireChannel("c", frames.append, max_frame=3 * one)
    chan.send_many(msgs)
    assert len(frames) > 1                      # actually split
    assert all(len(f) <= 3 * one for f in frames)
    got = T.FrameDecoder().feed(b"".join(frames))
    assert [m.uid for m in got] == list(range(32))
    assert [m.seq for m in got] == list(range(32))


# ---------------------------------------------------------------------------
# x86-TSO assumption of the shm rings: checked at construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("machine", ["aarch64", "ARM64"])
def test_shm_transport_refuses_weakly_ordered_isa(monkeypatch, machine):
    monkeypatch.setattr(platform, "machine", lambda: machine)
    with pytest.raises(RuntimeError, match=r'transport="tcp"'):
        T.ShmTransport(1, 1)
    with pytest.raises(RuntimeError, match="total store ordering"):
        T.require_tso()


# ---------------------------------------------------------------------------
# shared-memory ring
# ---------------------------------------------------------------------------


def test_shm_ring_roundtrip_with_wraparound():
    ring = T.ShmRing.create(256)       # tiny: every few frames wrap
    try:
        sent = [_ack(i) for i in range(200)]
        got = []
        dec = T.FrameDecoder()

        def consumer():
            deadline = time.monotonic() + 30
            while len(got) < len(sent) and time.monotonic() < deadline:
                got.extend(dec.feed(ring.read_available()))
                time.sleep(1e-4)

        th = threading.Thread(target=consumer)
        th.start()
        chan = T.WireChannel("r",
                             lambda d: ring.write(d, time.monotonic() + 30))
        for m in sent:
            chan.send(m)
        th.join(timeout=30)
        assert not th.is_alive()
        assert [int(m.uids[0]) for m in got] == list(range(200))
        assert [m.seq for m in got] == list(range(len(sent)))
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_blocks_until_drained():
    ring = T.ShmRing.create(128)
    try:
        frame = T.encode_frame([M.ShardFinMsg(0)])
        n_fit = 128 // len(frame)
        for _ in range(n_fit):
            ring.write(frame)
        state = {}

        def writer():
            t0 = time.monotonic()
            ring.write(frame, deadline=time.monotonic() + 30)
            state["blocked_for"] = time.monotonic() - t0

        th = threading.Thread(target=writer)
        th.start()
        time.sleep(0.15)
        assert th.is_alive()               # full ring: writer is blocked
        ring.read_available()              # consumer drains -> space frees
        th.join(timeout=30)
        assert not th.is_alive()
        assert state["blocked_for"] >= 0.1
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_rejects_oversized_frame():
    ring = T.ShmRing.create(64)
    try:
        with pytest.raises(ValueError, match="exceeds ring capacity"):
            ring.write(b"x" * 65)
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_write_timeout():
    ring = T.ShmRing.create(32)
    try:
        ring.write(b"x" * 30)
        with pytest.raises(RuntimeError, match="timed out"):
            ring.write(b"y" * 10, deadline=time.monotonic() + 0.3)
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_survives_stale_cursor_reads():
    """A stale cross-process cursor reading must never reach the ring
    arithmetic: a tail behind head reads as empty (no rewind, no replay),
    a head beyond tail clamps the producer's free space to "full"."""
    ring = T.ShmRing.create(64)
    try:
        ring.write(b"a" * 10)
        assert ring.read_available() == b"a" * 10
        ring.write(b"b" * 10)
        good_tail = ring._tail()
        ring._set_tail(0)
        assert ring.read_available() == b""
        assert ring._head() == 10
        ring._set_tail(10 + ring.capacity + 1)
        assert ring.read_available() == b""
        ring._set_tail(good_tail)
        assert ring.read_available() == b"b" * 10        # stream intact
        good_head = ring._head()
        ring._set_head(ring._tail() + 1)
        assert ring.free_bytes() == 0
        assert not ring.try_write(b"x")
        ring._set_head(good_head)
        assert ring.free_bytes() == ring.capacity
    finally:
        ring.close()
        ring.unlink()


# ---------------------------------------------------------------------------
# tcp end-to-end
# ---------------------------------------------------------------------------


def test_tcp_transport_duplex_end_to_end():
    """One connection per (process, shard) pair; framed messages flow both
    directions and arrive in FIFO order with contiguous seqs."""
    tp = T.TcpTransport(n_proc=2, n_shards=2)
    tp.listen()
    client_conns = {}

    def client(pid):
        client_conns[pid] = tp.connect(pid)

    threads = [threading.Thread(target=client, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    conns = tp.accept_all(deadline=time.monotonic() + 30)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert set(conns) == {(p, s) for p in range(2) for s in range(2)}

    try:
        chan = T.WireChannel("p1->s0", client_conns[1][0].write)
        rows = np.arange(3)
        chan.send_many([M.UpdateMsg(i, 2, 1, 0, "k", rows, np.ones((3, 2)) * i)
                        for i in range(10)])
        inbox = queue.Queue()
        errs = []
        T.start_reader("rx", conns[(1, 0)].read_chunk, inbox, errs.append)
        got = [inbox.get(timeout=10) for _ in range(10)]
        assert [m.uid for m in got] == list(range(10))
        assert [m.seq for m in got] == list(range(10))
        np.testing.assert_array_equal(got[3].delta, np.ones((3, 2)) * 3)

        back = T.WireChannel("s0->p1", conns[(1, 0)].write)
        back.send(M.ShardFinMsg(0))
        inbox2 = queue.Queue()
        T.start_reader("rx2", client_conns[1][0].read_chunk, inbox2,
                       errs.append)
        fin = inbox2.get(timeout=10)
        assert isinstance(fin, M.ShardFinMsg) and fin.shard == 0
        assert errs == []
    finally:
        for conn in conns.values():
            conn.close()
        for cs in client_conns.values():
            for conn in cs.values():
                conn.close()


# ---------------------------------------------------------------------------
# zero-copy raw wire (RowCodec + RingViewReader)
# ---------------------------------------------------------------------------


def _mk_zero_copy(cap=1 << 16, keys=("k", "k2")):
    ring = T.ShmRing.create(cap)
    codec = T.RowCodec(list(keys))
    bell = os.pipe()
    reader = T.RingViewReader(ring, codec, bell[0], threading.Event())
    chan = T.WireChannel("zc", T.ring_parts_writer(ring),
                         max_frame=cap // 4, codec=codec,
                         on_flush=lambda: T.ShmEdge.ring_bell(bell[1]))
    return ring, codec, reader, chan, bell


def _close_zero_copy(ring, bell):
    # decoded views must be dropped before the segment closes, else
    # SharedMemory.__del__ trips over the exported buffers at GC time
    import gc
    gc.collect()
    ring.close()
    ring.unlink()
    for fd in bell:
        try:
            os.close(fd)
        except OSError:
            pass


def _ring_mem(reader):
    return np.frombuffer(reader.ring.buf, dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_raw_wire_roundtrip_mixed_batch(seed):
    """Raw-eligible Update/Deliver msgs and pickle frames (control msgs,
    unknown keys, f32 deltas) interleave on one stream in FIFO order."""
    rng = np.random.default_rng(seed)
    ring, codec, reader, chan, bell = _mk_zero_copy()
    try:
        msgs = []
        for i in range(24):
            rows = np.sort(rng.choice(64, size=int(rng.integers(1, 9)),
                                      replace=False)).astype(np.int64)
            delta = rng.normal(size=(len(rows), 3))
            kind = i % 4
            if kind == 0:
                msgs.append(M.UpdateMsg(i, 1, 0, int(rng.integers(9)), "k",
                                        rows, delta, epoch=2))
            elif kind == 1:
                msgs.append(M.DeliverMsg(i, 1, 0, 1, 3, "k2", rows, delta))
            elif kind == 2:
                msgs.append(_ack(i))                     # pickle frame
            else:
                msgs.append(M.UpdateMsg(i, 1, 0, 0, "unknown-key", rows,
                                        delta.astype(np.float32)))
        chan.send_many(msgs)
        got = []
        while len(got) < len(msgs):
            got.extend(reader._decode_ready())
        assert [m.seq for m in got] == list(range(len(msgs)))
        for a, b in zip(msgs, got):
            _msg_equal(a, b)
        T.release_msgs(got)
        chan.close()
        assert reader.read_msgs() is None
        assert reader.closed
        got.clear()
    finally:
        _close_zero_copy(ring, bell)


def test_zero_copy_views_alias_ring_until_released():
    """Raw frames decode as views INTO the ring; the shared head cursor
    holds at the pinned frame and only advances once every message from it
    is released — the zero-copy contract."""
    ring, codec, reader, chan, bell = _mk_zero_copy()
    try:
        rows = np.arange(5, dtype=np.int64)
        chan.send_many([M.UpdateMsg(i, 0, 0, 0, "k", rows,
                                    np.full((5, 2), float(i)))
                        for i in range(3)])
        got = reader._decode_ready()
        assert len(got) == 3
        mem = _ring_mem(reader)
        for m in got:
            assert np.shares_memory(m.rows, mem)
            assert np.shares_memory(m.delta, mem)
        del m
        assert reader.pinned_frames() == 1
        assert ring._head() == 0                   # nothing released yet
        T.release_msgs(got[:2])
        assert ring._head() == 0                   # frame still partly pinned
        T.release_msg(got[2])
        assert reader.pinned_frames() == 0
        assert ring._head() == ring._tail()        # fully drained
        got.clear()
        del mem
    finally:
        _close_zero_copy(ring, bell)


def test_materialize_unpins_and_owns():
    """materialize_msg copies the arrays out of the ring (no aliasing) and
    drops the pin so the head can advance; the copy survives the producer
    overwriting the ring bytes."""
    ring, codec, reader, chan, bell = _mk_zero_copy()
    try:
        rows = np.arange(4, dtype=np.int64)
        delta = np.ones((4, 3)) * 7.0
        chan.send(M.UpdateMsg(0, 0, 0, 0, "k", rows, delta))
        (m,) = reader._decode_ready()
        mem = _ring_mem(reader)
        assert np.shares_memory(m.delta, mem)
        T.materialize_msg(m)
        assert not np.shares_memory(m.rows, mem)
        assert not np.shares_memory(m.delta, mem)
        assert m._frame is None
        np.testing.assert_array_equal(m.delta, delta)
        assert reader.pinned_frames() == 0
        assert ring._head() == ring._tail()
        chan.send(M.UpdateMsg(1, 0, 0, 0, "k", rows, delta * -1))
        (m2,) = reader._decode_ready()
        np.testing.assert_array_equal(m.delta, delta)
        T.release_msg(m2)
        del m2, mem
    finally:
        _close_zero_copy(ring, bell)


def test_zero_copy_frame_straddling_wraparound_copies_out():
    """A raw frame that straddles the ring's wrap point cannot be viewed
    contiguously: it decodes from an owned copy (no pin, no aliasing) and
    the stream stays intact across the wrap."""
    rows = np.arange(3, dtype=np.int64)

    def msg(i):
        return M.UpdateMsg(i, 0, 0, 0, "k", rows, np.full((3, 1), float(i)))

    codec = T.RowCodec(["k"])
    one = sum(len(p) if isinstance(p, bytes) else p.nbytes
              for p in codec._pack_raw([msg(0)])) + 4
    cap = int(one * 2.5)                # third frame is forced to straddle
    ring, codec, reader, chan, bell = _mk_zero_copy(cap=cap, keys=("k",))
    try:
        mem = _ring_mem(reader)
        straddled = 0
        for i in range(8):
            chan.send(msg(i))
            (m,) = reader._decode_ready()
            assert m.uid == i
            np.testing.assert_array_equal(m.delta, np.full((3, 1), float(i)))
            if np.shares_memory(m.delta, mem):
                T.release_msg(m)
            else:
                straddled += 1
                assert getattr(m, "_frame", None) is None   # owned, unpinned
            assert reader.pinned_frames() == 0
            assert ring._head() == ring._tail()
            del m
        assert straddled > 0            # the wrap path actually ran
        del mem
    finally:
        _close_zero_copy(ring, bell)


def test_doorbell_batched_per_flush_but_rings_every_frame_on_split():
    """The common single-frame flush gets exactly one doorbell wake; a
    batch the codec splits rings once per frame, so no published frame can
    be stranded un-belled behind a parked reader."""
    frames, bells = [], []
    codec = T.RowCodec(["k"])
    rows = np.arange(8, dtype=np.int64)
    msgs = [M.UpdateMsg(i, 0, 0, 0, "k", rows, np.ones((8, 8)))
            for i in range(16)]
    one = codec.raw_size(msgs[0])
    chan = T.WireChannel("c", frames.append, max_frame=2 * one + 64,
                         codec=codec, on_flush=lambda: bells.append(1))
    chan.send_many([msgs[0]])
    assert len(frames) == 1 and len(bells) == 1   # single frame: one bell
    chan.send_many(msgs)
    assert len(frames) > 5              # split into several raw frames...
    assert len(bells) == len(frames)    # ...each belled (none strandable)
    n = len(frames)
    chan.close()                        # EOF frame + its wake
    assert len(frames) == n + 1
    assert len(bells) == len(frames)


def test_multi_frame_batch_larger_than_ring_does_not_deadlock():
    """A send_many batch whose frames total more than the ring's capacity
    completes against a reader parked on the doorbell."""
    cap = 1 << 13                          # 8 KiB ring
    ring = T.ShmRing.create(cap)
    codec = T.RowCodec(["k"])
    bell = os.pipe()
    stop = threading.Event()
    reader = T.RingViewReader(ring, codec, bell[0], stop)
    deadline = time.monotonic() + 20       # a regression fails, not hangs
    chan = T.WireChannel("zc", T.ring_parts_writer(ring, deadline),
                         max_frame=cap // 4, codec=codec,
                         on_flush=lambda: T.ShmEdge.ring_bell(bell[1]))
    inbox: "queue.Queue" = queue.Queue()
    errs: list = []
    t = T.start_view_reader("rx", reader, inbox, errs.append)
    try:
        rows = np.arange(8, dtype=np.int64)
        msgs = [M.UpdateMsg(i, 0, 0, 0, "k", rows, np.ones((8, 8)) * i)
                for i in range(24)]        # ~15 KiB of raw frames > cap
        sender = threading.Thread(target=chan.send_many, args=(msgs,))
        sender.start()
        got = []
        while len(got) < len(msgs):
            m = inbox.get(timeout=15)
            T.materialize_msg(m)
            got.append(m)
        sender.join(timeout=15)
        assert not sender.is_alive()
        assert errs == []
        assert [m.seq for m in got] == list(range(len(msgs)))
        for i, m in enumerate(got):
            assert np.array_equal(m.delta, np.ones((8, 8)) * i)
        chan.close()
        t.join(timeout=10)
        assert not t.is_alive()
        got.clear()
    finally:
        stop.set()
        T.ShmEdge.ring_bell(bell[1])
        _close_zero_copy(ring, bell)


# ---------------------------------------------------------------------------
# the raw wire against the JAX package's
# ---------------------------------------------------------------------------


def _raw_batches(seed, msg_mod):
    """Seeded Update/Deliver batches built from one package's messages."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(40):
        rows = np.sort(rng.choice(4096, size=int(rng.integers(1, 40)),
                                  replace=False)).astype(np.int64)
        delta = rng.normal(size=(len(rows), int(rng.integers(1, 9))))
        delta[rng.random(delta.shape) < 0.05] = -0.0
        key = ("word_topic", "topic", "w")[i % 3]
        if i % 2:
            m = msg_mod.UpdateMsg(int(rng.integers(1 << 40)), i % 4, i % 3,
                                  int(rng.integers(20)), key, rows, delta,
                                  epoch=int(rng.integers(3)))
        else:
            m = msg_mod.DeliverMsg(int(rng.integers(1 << 40)), i % 4, i % 3,
                                   i % 2, int(rng.integers(20)), key, rows,
                                   delta)
        m.seq = i
        msgs.append(m)
    return msgs


def _joined(items):
    return [b"".join(bytes(p) for p in it) for it in items]


@pytest.mark.parametrize("max_frame", [None, 1 << 12], ids=["whole", "split"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raw_frames_byte_equal_to_reference(seed, max_frame):
    keys = ["word_topic", "topic", "w"]
    mine = _joined(T.RowCodec(keys).frames(_raw_batches(seed, M), max_frame))
    ref = _joined(RT.RowCodec(keys).frames(_raw_batches(seed, RM), max_frame))
    assert all(struct.unpack_from("<I", f, 4)[0] == T.RAW_MAGIC for f in mine)
    if max_frame is not None:
        assert len(mine) > 1                         # the split path ran
    assert mine == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_package_decodes_the_others_raw_frames(seed):
    """The port's decoder on the reference's frames and the reference's on
    the port's give bitwise the same rows and deltas, and every field."""
    keys = ["word_topic", "topic", "w"]
    ours, refs = T.RowCodec(keys), RT.RowCodec(keys)
    for enc, dec, src in ((refs, ours, RM), (ours, refs, M)):
        sent = _raw_batches(seed, src)
        got = []
        for frame in _joined(enc.frames(sent, 1 << 12)):
            got += dec.decode_raw(memoryview(frame)[4:])
        assert len(got) == len(sent)
        for a, b in zip(sent, got):
            assert type(a).__name__ == type(b).__name__
            for f in a.__dataclass_fields__:
                va, vb = getattr(a, f), getattr(b, f)
                if isinstance(va, np.ndarray):
                    assert va.dtype == vb.dtype and va.shape == vb.shape
                    assert va.tobytes() == vb.tobytes()      # bitwise
                else:
                    assert va == vb, f


# ---------------------------------------------------------------------------
# a forked client's final state over a pipe
# ---------------------------------------------------------------------------


def test_state_round_trips_through_a_pipe_with_arrays_out_of_band():
    rng = np.random.default_rng(0)
    state = {"pid": 3, "cache": {"a": rng.normal(size=(700, 300)),
                                 "b": np.arange(5.0)},
             "total": {"a": rng.integers(-3, 4, size=(700, 300)) * 1.0},
             "stats": M.ClockMsg(1, 2), "errors": ["x"]}
    r, w = os.pipe()
    try:
        writer = threading.Thread(target=T.send_state, args=(w, state))
        writer.start()                   # 3.4 MB: more than a pipe holds
        got = T.recv_state(r, time.monotonic() + 30)
        writer.join(timeout=30)
        assert not writer.is_alive()
    finally:
        os.close(r)
        os.close(w)
    assert got["pid"] == 3 and got["errors"] == ["x"]
    assert got["stats"] == state["stats"]
    for part in ("cache", "total"):
        for k, v in state[part].items():
            assert got[part][k].dtype == v.dtype
            assert got[part][k].tobytes() == v.tobytes()
    got["cache"]["a"][0, 0] = 1.0        # owned, writable arrays


def test_state_receive_gives_none_on_eof_or_deadline():
    r, w = os.pipe()
    os.write(w, b"\x02\x00")             # a truncated header, then EOF
    os.close(w)
    try:
        assert T.recv_state(r, time.monotonic() + 5) is None
    finally:
        os.close(r)
    r, w = os.pipe()                     # nothing written: the deadline
    try:
        t0 = time.monotonic()
        assert T.recv_state(r, t0 + 0.2) is None
        assert time.monotonic() - t0 < 5
    finally:
        os.close(r)
        os.close(w)


# ---------------------------------------------------------------------------
# the serving tier's messages and non-blocking sends
# ---------------------------------------------------------------------------


def test_frame_roundtrip_serving_and_ackbatch_msgs():
    """The serving-tier publish messages and the batched ack round-trip the
    codec, numpy buffers (uids, vcs, dense state blocks) intact, and the
    fields are the JAX package's."""
    rng = np.random.default_rng(7)
    rows = np.arange(0, 12, 2)
    delta = rng.normal(size=(6, 3))
    state = {"k": {"rows": rows.copy(), "values": delta.copy()},
             "k2": {"rows": np.arange(4), "values": rng.normal(size=(4, 1))}}
    vc = np.array([3, -1, 7], dtype=np.int64)
    msgs = [
        M.AckBatchMsg(np.arange(17, dtype=np.int64), 1),
        M.ReplicaDeltaMsg(0, "k", rows, delta, epoch=2),
        M.ReplicaVcMsg(1, vc),
        M.ReplicaStateMsg(0, state, vc, epoch=1),
        M.ReplicaFinMsg(1),
        M.UnsubscribeMsg(3),
    ]
    got = T.FrameDecoder().feed(T.encode_frame(msgs))
    assert [type(m) for m in got] == [type(m) for m in msgs]
    np.testing.assert_array_equal(got[0].uids, msgs[0].uids)
    assert got[0].process == 1
    np.testing.assert_array_equal(got[1].delta, delta)
    assert got[1].epoch == 2 and got[1].nbytes == delta.nbytes
    np.testing.assert_array_equal(got[2].clock_vc, vc)
    for key in state:
        np.testing.assert_array_equal(got[3].state[key]["rows"],
                                      state[key]["rows"])
        np.testing.assert_array_equal(got[3].state[key]["values"],
                                      state[key]["values"])
    assert got[3].epoch == 1
    assert got[4].shard == 1 and got[5].replica == 3
    for name in ("SubscribeMsg", "UnsubscribeMsg", "ReplicaStateMsg",
                 "ReplicaDeltaMsg", "ReplicaVcMsg", "ReplicaFinMsg"):
        assert (list(getattr(M, name).__dataclass_fields__)
                == list(getattr(RM, name).__dataclass_fields__)), name


def test_serving_shm_refuses_weakly_ordered_isa(monkeypatch):
    from repro_torch.core import policies
    from repro_torch.runtime import PSRuntime, RuntimeConfig
    from repro_torch.runtime.serving import ReplicaSet

    rt = PSRuntime(RuntimeConfig(1, policies.ssp(1), {"a": np.zeros(4)},
                                 n_shards=1, device="cpu"))
    monkeypatch.setattr(platform, "machine", lambda: "aarch64")
    with pytest.raises(RuntimeError, match=r'transport="tcp"'):
        ReplicaSet(rt, 1, transport="shm")


def test_try_send_many_drops_whole_frames_and_rolls_the_seq_back():
    """A full ring refuses the frame without blocking, and the stream never
    sees the dropped messages: their seqs are reused by the next send, so
    the receiver's FIFO check stays clean."""
    def delta():
        return M.ReplicaDeltaMsg(0, "k", np.arange(8), np.ones((8, 4)))

    probe = delta()
    probe.seq = 1                       # the size of a stamped frame
    size = len(T.encode_frame([probe]))
    cap = 2 * size - 1                  # room for one such frame, not two
    ring = T.ShmRing.create(cap)
    r, w = os.pipe()
    os.set_blocking(w, False)
    try:
        chan = T.WireChannel("pub", T.ring_writer(ring, w),
                             try_write=T.try_ring_writer(ring, w),
                             room=ring.free_bytes)
        assert chan.room() == cap
        assert chan.try_send_many([delta()])
        used = cap - chan.room()
        assert used == size
        big = [delta()]
        assert not chan.try_send_many(big)          # does not fit: dropped
        assert big[0].seq == 1 and chan.room() == cap - used
        assert os.read(r, 16) == b"\x01"            # rung once, on success
        first = T.FrameDecoder().feed(ring.read_available())
        assert chan.try_send_many([_ack(1), _ack(2)])
        got = first + T.FrameDecoder().feed(ring.read_available())
        assert [m.seq for m in got] == [0, 1, 2]
        assert [int(m.uids[0]) for m in got[1:]] == [1, 2]
        fifo = T.FifoAssert()
        assert all(fifo.check("pub", m.seq) is None for m in got)
    finally:
        ring.close()
        ring.unlink()
        os.close(r)
        os.close(w)


def test_tcp_send_queue_is_bounded_ordered_and_never_blocks():
    """The serving tcp edge's sink: whole frames queue up to its capacity
    and go out in order; a stalled peer fills it and try_write refuses
    without blocking; once the peer drains, room comes back."""
    import socket

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    peer, _ = srv.accept()
    srv.close()
    errors = []
    cap = 1 << 16
    q = T.TcpSendQueue(T.TcpConn(cli), cap, "tx-test", errors.append)
    try:
        frames = [bytes([i]) * 1000 for i in range(40)]
        assert all(q.try_write(f) for f in frames)
        got = b""
        deadline = time.monotonic() + 10
        while len(got) < 40_000:
            assert time.monotonic() < deadline
            got += peer.recv(1 << 16)
        assert got == b"".join(frames)
        # stall the peer: kernel buffers fill, then the queue does
        chunk = b"s" * (cap // 4)
        deadline = time.monotonic() + 30
        t_max = 0.0
        while True:
            t0 = time.monotonic()
            ok = q.try_write(chunk)
            t_max = max(t_max, time.monotonic() - t0)
            if not ok:
                break
            assert time.monotonic() < deadline, "queue never filled"
        assert t_max < 1.0                      # never blocked
        assert q.room() < len(chunk)
        peer.setblocking(False)
        deadline = time.monotonic() + 30
        while q.room() < cap:
            assert time.monotonic() < deadline, "queue never drained"
            try:
                peer.recv(1 << 20)
            except BlockingIOError:
                time.sleep(1e-3)
        assert q.try_write(b"end") and errors == []
    finally:
        q.close()
        assert not q.thread.is_alive()
        peer.close()


def _tcp_pair():
    """A loopback connection whose kernel buffers are small and fixed (set
    explicitly, they do not grow), so a stalled peer backs up quickly."""
    import socket

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 15)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.socket()
    cli.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 15)
    cli.connect(srv.getsockname())
    peer, _ = srv.accept()
    srv.close()
    return cli, peer


def _drain_until(peer, want: int, deadline_s: float = 30.0) -> bytes:
    got = b""
    deadline = time.monotonic() + deadline_s
    while len(got) < want:
        assert time.monotonic() < deadline, "peer never got the bytes"
        got += peer.recv(1 << 20)
    return got


def test_try_send_many_over_a_tcp_send_queue_rolls_the_seq_back():
    """The tcp serving edge: a stalled peer fills the send queue, the
    refused frames consume no seq, and once the peer drains, the stream it
    decodes has contiguous seqs (the receiver's FIFO check stays clean)."""
    cli, peer = _tcp_pair()
    errors = []
    cap = 1 << 16
    q = T.TcpSendQueue(T.TcpConn(cli), cap, "tx-test", errors.append)
    chan = T.WireChannel("pub", q.write, try_write=q.try_write, room=q.room)
    try:
        sent = 0
        refused = 0
        deadline = time.monotonic() + 30
        while refused < 3:
            assert time.monotonic() < deadline, "queue never filled"
            msg = M.ReplicaDeltaMsg(0, "k", np.arange(64),
                                    np.full((64, 8), float(sent)))
            if chan.try_send_many([msg]):
                assert msg.seq == sent
                sent += 1
            else:
                assert msg.seq == sent          # stamped, then rolled back
                refused += 1
        assert chan.room() == q.room() < cap
        dec = T.FrameDecoder()
        got = []
        peer.settimeout(30)
        while len(got) < sent:
            got += dec.feed(peer.recv(1 << 20))
        assert [m.seq for m in got] == list(range(sent))
        assert [float(m.delta[0, 0]) for m in got] == [float(i)
                                                       for i in range(sent)]
        fifo = T.FifoAssert()
        assert all(fifo.check("pub", m.seq) is None for m in got)
        assert chan.try_send_many([_ack(9)]) and errors == []
        assert dec.feed(peer.recv(1 << 16))[0].seq == sent
    finally:
        q.close()
        peer.close()


def test_tcp_send_queue_blocking_write_waits_for_room_then_fails_closed():
    """The blocking ``write`` (a channel's EOF and its oversized sends)
    waits for room instead of refusing, rejects a frame larger than the
    whole queue, and fails once the queue is closed."""
    cli, peer = _tcp_pair()
    errors = []
    cap = 1 << 16
    q = T.TcpSendQueue(T.TcpConn(cli), cap, "tx-test", errors.append)
    try:
        with pytest.raises(ValueError, match="capacity"):
            q.write(b"x" * (cap + 1))
        # the peer is not reading: kernel buffers fill, then the queue does
        total = 0
        deadline = time.monotonic() + 30
        while True:
            room = q.room()
            if room and q.try_write(b"w" * room):
                total += room
            elif not room:
                time.sleep(0.1)
                if q.room() == 0:               # full, and staying full
                    break
            assert time.monotonic() < deadline, "queue never filled"
        done = threading.Event()

        def blocked():
            q.write(b"last")
            done.set()

        th = threading.Thread(target=blocked, daemon=True)
        th.start()
        assert not done.wait(0.2)               # no room: it waits
        got = _drain_until(peer, total + 4)
        assert done.wait(10) and got.endswith(b"last")
        assert errors == []
    finally:
        q.close()
        peer.close()
    assert not q.thread.is_alive()
    assert not q.try_write(b"late")
    with pytest.raises(RuntimeError, match="closed"):
        q.write(b"late")
