"""The port's write-ahead log and exact-clock recovery against the JAX
package's.

Every test of ``tests/test_wal.py`` is mirrored here: the same inputs, made
from a numpy seed, go through ``repro.runtime`` and through
``repro_torch.runtime`` (``device="cpu"``: the shards' applies and the
recovery's replay take ``ps_apply``'s plain version), and the two agree
bitwise — recovered params, ``applied_parts``, ``clock_vc``, segment
positions, dedup counts.  Integer deltas make every f64 sum exact, so the
recovered state also equals ``x0 + Σ updates`` computed on the side, and
the runtime's own final master.

Only the raw part frames are byte-identical across the packages: a vc
stamp is a pickle naming its package's ``ReplicaVcMsg``, so segment files
are compared through what recovery returns, never byte for byte.
"""
import gc
import os
import threading

import numpy as np
import pytest

from repro.core import policies as ref_policies
from repro.runtime import PSRuntime as RefPSRuntime
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import UidDedup as RefUidDedup
from repro.runtime import UpdateMsg as RefUpdateMsg
from repro.runtime import WalWriter as RefWalWriter
from repro.runtime import prune_segments as ref_prune_segments
from repro.runtime import read_segment as ref_read_segment
from repro.runtime import recover_to_vc as ref_recover_to_vc
from repro.runtime import wal_segments as ref_wal_segments
from repro.runtime.snapshot import load_snapshot as ref_load_snapshot
from repro.runtime.snapshot import save_snapshot as ref_save_snapshot
from repro.runtime.snapshot import take_snapshot as ref_take_snapshot
from repro.runtime.transport import RowCodec as RefRowCodec
from repro_torch.core import policies
from repro_torch.runtime import (PSRuntime, RuntimeConfig, UidDedup,
                                 UpdateMsg, WalWriter, prune_segments,
                                 read_segment, recover_to_vc, wal_segments)
from repro_torch.runtime import transport as T
from repro_torch.runtime.snapshot import (load_snapshot, save_snapshot,
                                          take_snapshot)

# one namespace per package, so a test body runs on either
REF = dict(PSRuntime=RefPSRuntime, RuntimeConfig=RefRuntimeConfig,
           policies=ref_policies, UidDedup=RefUidDedup,
           UpdateMsg=RefUpdateMsg, WalWriter=RefWalWriter,
           prune_segments=ref_prune_segments, read_segment=ref_read_segment,
           recover=ref_recover_to_vc, wal_segments=ref_wal_segments,
           load_snapshot=ref_load_snapshot, save_snapshot=ref_save_snapshot,
           take_snapshot=ref_take_snapshot, RowCodec=RefRowCodec, kw={})
PORT = dict(PSRuntime=PSRuntime, RuntimeConfig=RuntimeConfig,
            policies=policies, UidDedup=UidDedup, UpdateMsg=UpdateMsg,
            WalWriter=WalWriter, prune_segments=prune_segments,
            read_segment=read_segment, recover=recover_to_vc,
            wal_segments=wal_segments, load_snapshot=load_snapshot,
            save_snapshot=save_snapshot, take_snapshot=take_snapshot,
            RowCodec=T.RowCodec, kw={"device": "cpu"})
PKGS = (("ref", REF), ("port", PORT))


def _x0():
    return {"a": np.arange(32, dtype=float).reshape(8, 4) / 2.0,
            "b": np.ones(5)}


def _fn(seed):
    def fn(w, clock, view, rng):
        r = np.random.default_rng((seed, w, clock))
        return {"a": r.integers(-3, 4, size=(8, 4)).astype(float),
                "b": r.integers(-3, 4, size=5).astype(float)}
    return fn


def _expected(seed, n_workers, n_clocks, upto_ts=None):
    out = {k: v.astype(float) for k, v in _x0().items()}
    fn = _fn(seed)
    last = n_clocks if upto_ts is None else min(n_clocks, upto_ts + 1)
    for w in range(n_workers):
        for c in range(last):
            for k, d in fn(w, c, None, None).items():
                out[k] = out[k] + d
    return out


def _run(P, root, seed=5, n_clocks=12, policy=None, **cfg):
    """One runtime of package ``P`` with its log under ``root/wal``."""
    wal_dir = str(root / "wal")
    pol = policy if policy is not None else P["policies"].ssp(3)
    rt = P["PSRuntime"](P["RuntimeConfig"](
        4, pol, _x0(), n_shards=2, threads_per_process=2, seed=seed,
        wal_dir=wal_dir, **P["kw"], **cfg))
    rt.run(_fn(seed), n_clocks=n_clocks)
    return rt, wal_dir


def _recover(P, *args, **kw):
    return P["recover"](*args, **P["kw"], **kw)


def _runs(tmp_path, seed, n_clocks, snaps=False, **cfg):
    """The same run in both packages: {"ref"|"port": (rt, wal_dir, sdir)}."""
    out = {}
    for name, P in PKGS:
        root = tmp_path / name
        sdir = str(root / "snaps") if snaps else None
        extra = dict(snapshot_dir=sdir, **cfg) if snaps else cfg
        rt, wal_dir = _run(P, root, seed=seed, n_clocks=n_clocks, **extra)
        out[name] = (rt, wal_dir, sdir)
    return out


def _same_recovery(a, b, counts=True):
    """Two recover_to_vc results agree bitwise (tolerance: none).  With
    ``counts`` the replay's own counters agree too; a recovery from a
    periodic snapshot may split the same parts differently between the
    snapshot and the replay (snapshots are boundary-triggered, not
    barrier-exact), so it compares only what it returns as state."""
    assert a.keys() == b.keys()
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    for f in ("applied_parts", "clock_vc"):
        np.testing.assert_array_equal(a[f], b[f])
    assert a["clock"] == b["clock"]
    if counts:
        for f in ("n_replayed", "n_deduped", "from_snapshot"):
            assert a[f] == b[f], f


def _msg(P, uid, process, ts, key="a", rows=(0, 1), val=1.0):
    rows = np.asarray(rows, dtype=np.int64)
    cols = 4 if key == "a" else 1
    delta = np.full((len(rows), cols), float(val), dtype=np.float64)
    return P["UpdateMsg"](uid=uid, worker=process, process=process, ts=ts,
                          key=key, rows=rows, delta=delta)


def _codec(P):
    return P["RowCodec"](list(_x0().keys()))


def _records_summary(records):
    """A package-free view of a decoded segment: record kinds, each part's
    header fields and arrays, each stamp's vc."""
    out = []
    for kind, val in records:
        if kind == "vc":
            out.append(("vc", np.asarray(val.clock_vc).tolist()))
        else:
            out.append(("parts", [(m.uid, m.process, m.ts, m.key,
                                   np.asarray(m.rows).tolist(),
                                   np.asarray(m.delta).tolist())
                                  for m in val]))
    return out


# ---------------------------------------------------------------------------
# WalWriter / read_segment
# ---------------------------------------------------------------------------


def test_writer_reader_roundtrip(tmp_path):
    decoded = {}
    for name, P in PKGS:
        d = str(tmp_path / name)
        w = P["WalWriter"](d, sid=0, codec=_codec(P), n_proc=2)
        w.log_parts([_msg(P, 1, 0, 0), _msg(P, 2, 1, 0, key="b", rows=[3])])
        w.commit(np.array([0, 0]))
        w.log_parts([_msg(P, 3, 0, 1, val=-2.5)])
        w.seal(np.array([1, 0]))
        segs = P["wal_segments"](d)
        assert list(segs) == [0] and len(segs[0]) == 1
        (start, path), = segs[0]
        assert start == 0
        records, sealed = P["read_segment"](path, _codec(P))
        assert sealed
        assert [k for k, _ in records] == ["parts", "vc", "parts", "vc"]
        parts = [m for k, run in records if k == "parts" for m in run]
        assert [(m.uid, m.process, m.ts, m.key) for m in parts] == [
            (1, 0, 0, "a"), (2, 1, 0, "b"), (3, 0, 1, "a")]
        np.testing.assert_array_equal(parts[2].delta, np.full((2, 4), -2.5))
        marks = w.marks()
        assert marks["parts"] == 3
        assert marks["applied"].tolist() == [2, 1]
        assert marks["max_ts"].tolist() == [1, 0]
        decoded[name] = _records_summary(records)
    assert decoded["port"] == decoded["ref"]


def test_torn_tail_recovers_to_last_complete_record(tmp_path):
    """A segment truncated at ANY byte offset decodes cleanly to a prefix of
    the full record stream, in both packages."""
    n_full = {}
    for name, P in PKGS:
        d = tmp_path / name
        w = P["WalWriter"](str(d), sid=0, codec=_codec(P), n_proc=2)
        for i in range(4):
            w.log_parts([_msg(P, 2 * i, 0, i),
                         _msg(P, 2 * i + 1, 1, i, key="b", rows=[i])])
            w.commit(np.array([i, i]))
        w.seal()
        (_, path), = P["wal_segments"](str(d))[0]
        full, sealed = P["read_segment"](path, _codec(P))
        assert sealed
        n_full[name] = _records_summary(full)
        data = open(path, "rb").read()
        torn = str(d / "torn.bin")
        prev_len = -1
        for cut in range(len(data) - 1, -1, -1):
            with open(torn, "wb") as f:
                f.write(data[:cut])
            records, sealed = P["read_segment"](torn, _codec(P))
            assert not sealed
            assert len(records) <= len(full)
            for (k, v), (fk, fv) in zip(records, full):
                assert k == fk
            assert len(records) <= max(prev_len, len(full))
            prev_len = len(records)
    assert n_full["port"] == n_full["ref"]


def test_data_after_eof_is_corruption(tmp_path):
    for name, P in PKGS:
        d = str(tmp_path / name)
        w = P["WalWriter"](d, sid=0, codec=_codec(P), n_proc=2)
        w.log_parts([_msg(P, 1, 0, 0)])
        w.seal(np.array([0, 0]))
        (_, path), = P["wal_segments"](d)[0]
        with open(path, "ab") as f:
            f.write(b"\x00\x01\x02\x03")
        with pytest.raises(ValueError, match="data after EOF"):
            P["read_segment"](path, _codec(P))


def test_segment_rotation_positions_are_contiguous(tmp_path):
    """Tiny segment_bytes forces rotation on nearly every commit; segment
    start positions tile the slot's log exactly, the same in both."""
    starts = {}
    for name, P in PKGS:
        d = str(tmp_path / name)
        w = P["WalWriter"](d, sid=3, codec=_codec(P), n_proc=2,
                           segment_bytes=64)
        for i in range(10):
            w.log_parts([_msg(P, i, i % 2, i)])
            w.commit(np.array([i, i]))
        w.seal()
        segs = P["wal_segments"](d)[3]
        assert len(segs) > 1
        pos = 0
        for start, path in segs:
            assert start == pos
            records, sealed = P["read_segment"](path, _codec(P))
            assert sealed
            pos += sum(len(run) for k, run in records if k == "parts")
        assert pos == 10
        starts[name] = [s for s, _ in segs]
    assert starts["port"] == starts["ref"]


def test_seal_reopen_names_never_collide(tmp_path):
    names = {}
    for name, P in PKGS:
        d = str(tmp_path / name)
        w = P["WalWriter"](d, sid=0, codec=_codec(P), n_proc=2)
        w.log_parts([_msg(P, 1, 0, 0)])
        w.seal(np.array([0, 0]))
        w.seal(np.array([0, 0]))                  # idempotent no-op
        w.log_parts([_msg(P, 2, 0, 1)])           # re-activation
        w.seal(np.array([1, 0]))
        w.log_parts([_msg(P, 3, 1, 0)])
        w.seal(np.array([1, 0]))
        segs = P["wal_segments"](d)[0]
        assert len(segs) == 3
        assert len({path for _, path in segs}) == 3
        for _, path in segs:
            records, sealed = P["read_segment"](path, _codec(P))
            assert sealed
        names[name] = [os.path.basename(p) for _, p in segs]
    assert names["port"] == names["ref"]


def test_prune_segments_keeps_uncovered_and_last(tmp_path):
    for name, P in PKGS:
        d = str(tmp_path / name)
        w = P["WalWriter"](d, sid=0, codec=_codec(P), n_proc=2,
                           segment_bytes=1)          # rotate every commit
        for i in range(5):
            w.log_parts([_msg(P, i, 0, i)])
            w.commit(np.array([i, 0]))
        w.seal()
        assert [s for s, _ in P["wal_segments"](d)[0]] == [0, 1, 2, 3, 4]
        removed = P["prune_segments"](d, {0: 3})
        assert len(removed) == 3
        assert [s for s, _ in P["wal_segments"](d)[0]] == [3, 4]
        P["prune_segments"](d, {0: 10 ** 9})
        assert [s for s, _ in P["wal_segments"](d)[0]] == [4]


def test_wal_byte_counter_equals_the_segments_on_disk(tmp_path):
    """The port counts each segment's EOF sentinel in ``m_bytes`` (the JAX
    package leaves it out), so the counter equals the files' sizes."""
    d = str(tmp_path)
    w = WalWriter(d, sid=0, codec=_codec(PORT), n_proc=2, segment_bytes=1)
    for i in range(3):
        w.log_parts([_msg(PORT, i, 0, i)])
        w.commit(np.array([i, 0]))
    w.seal()
    on_disk = sum(os.path.getsize(p) for _, p in wal_segments(d)[0])
    assert w.m_bytes == on_disk
    assert w.m_segments == len(wal_segments(d)[0]) == 3


# ---------------------------------------------------------------------------
# the part frame on disk is the JAX package's raw frame, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_part_frames_byte_identical_to_reference_rowcodec(tmp_path, seed):
    """A port WAL part frame equals the reference ``RowCodec``'s raw frame
    of the same parts, and the reference reader decodes it."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(6):
        key = "a" if i % 2 == 0 else "b"
        n = int(rng.integers(1, 5))
        rows = np.sort(rng.choice(8 if key == "a" else 5, size=n,
                                  replace=False)).astype(np.int64)
        delta = rng.normal(size=(n, 4 if key == "a" else 1))
        specs.append((int(rng.integers(1 << 40)), i % 3, i, key, rows,
                      delta))

    def msgs(P):
        return [P["UpdateMsg"](uid, p, p, ts, key, rows.copy(), d.copy(),
                               epoch=0) for uid, p, ts, key, rows, d in specs]

    w = WalWriter(str(tmp_path), sid=0, codec=_codec(PORT), n_proc=3)
    w.log_parts(msgs(PORT))
    frames = list(w._pending)
    ref_frames = [b"".join(item) for item in
                  _codec(REF).frames(msgs(REF), None)]
    assert frames == ref_frames
    # the reference's decoder reads the port's frame back
    payload = memoryview(frames[0])[4:]
    back = _codec(REF).decode_raw(payload)
    assert [(m.uid, m.process, m.ts, m.key) for m in back] == [
        (u, p, t, k) for u, p, t, k, _, _ in specs]


# ---------------------------------------------------------------------------
# ring views: log_parts owns its bytes before the frame pins drop
# ---------------------------------------------------------------------------


def test_log_parts_from_ring_views_survives_the_ring_wrapping(tmp_path):
    """Parts decoded as views into a shm ring are logged, their pins
    released, and the ring's bytes then overwritten by later frames (the
    ring wraps) before the group commit writes the log.  Recovery must
    still give exactly x0 + the logged parts: ``log_parts`` encodes owned
    bytes inside the apply, not references into the ring."""
    cap = 4096
    ring = T.ShmRing.create(cap)
    codec = T.RowCodec(list(_x0().keys()))
    bell = os.pipe()
    reader = T.RingViewReader(ring, codec, bell[0], threading.Event())
    chan = T.WireChannel("zc", T.ring_parts_writer(ring), max_frame=cap // 4,
                         codec=codec,
                         on_flush=lambda: T.ShmEdge.ring_bell(bell[1]))
    wal = WalWriter(str(tmp_path / "wal"), sid=0, codec=codec, n_proc=1)
    rng = np.random.default_rng(7)
    want = {k: v.reshape(v.shape[0], -1).copy() for k, v in _x0().items()}
    try:
        uid = 0
        for clock in range(3):
            # one batch: decoded in place, logged, released (the shard's
            # order), then more traffic wraps the ring over those bytes
            sent = [UpdateMsg(uid + i, 0, 0, clock, "a",
                              np.arange(8, dtype=np.int64),
                              rng.integers(-5, 6, size=(8, 4)).astype(float))
                    for i in range(2)]
            uid += 2
            chan.send_many(sent)
            got = []
            while len(got) < len(sent):
                got.extend(reader._decode_ready())
            assert all(getattr(m, "_frame", None) is not None for m in got)
            wal.log_parts(got)
            for m in sent:
                want["a"][m.rows] += m.delta
            T.release_msgs(got)
            del got
            for _ in range(12):              # > cap bytes of filler
                filler = [UpdateMsg(10 ** 6, 0, 0, clock, "a",
                                    np.arange(8, dtype=np.int64),
                                    np.full((8, 4), 1e300))]
                chan.send_many(filler)
                drained = []
                while not drained:
                    drained.extend(reader._decode_ready())
                T.release_msgs(drained)
                del drained
            wal.commit(np.array([clock]))
        wal.seal(np.array([2]))
        rec = recover_to_vc(_x0(), str(tmp_path / "wal"), device="cpu")
        assert rec["applied_parts"].tolist() == [6]
        np.testing.assert_array_equal(rec["params"]["a"], want["a"])
        np.testing.assert_array_equal(rec["params"]["b"], _x0()["b"])
    finally:
        gc.collect()
        ring.close()
        ring.unlink()
        for fd in bell:
            os.close(fd)


# ---------------------------------------------------------------------------
# UidDedup
# ---------------------------------------------------------------------------


def test_uid_dedup_drops_duplicates_and_prunes_on_advance():
    for _, P in PKGS:
        d = P["UidDedup"](2)
        assert d.fresh(10, 0, 0)
        assert not d.fresh(10, 0, 0)
        assert d.n_dropped == 1
        assert d.fresh(11, 0, 1)
        assert d.fresh(20, 1, 0)
        d.advance(0, 0)
        assert d.frontier.tolist() == [0, -1]
        assert not d.fresh(12, 0, 0)
        assert d.fresh(13, 0, 1)
        assert 10 not in d._seen[0]
        assert 20 in d._seen[1]
        d.advance(0, -5)
        assert d.frontier.tolist() == [0, -1]


def test_uid_dedup_cross_epoch_resend():
    for _, P in PKGS:
        d = P["UidDedup"](2)
        assert d.fresh(7, 1, 3)
        assert not d.fresh(7, 1, 3)
        d.advance(1, 3)
        assert not d.fresh(7, 1, 3)
        assert d.n_dropped == 2


# ---------------------------------------------------------------------------
# recover_to_vc
# ---------------------------------------------------------------------------


def test_genesis_recovery_bitwise_and_audit(tmp_path):
    runs = _runs(tmp_path, seed=5, n_clocks=12)
    recs = {}
    exp = _expected(5, 4, 12)
    for name, P in PKGS:
        rt, wal_dir, _ = runs[name]
        rec = _recover(P, _x0(), wal_dir)
        assert rec["from_snapshot"] is None
        assert rec["applied_parts"].tolist() == rt._parts_sent.tolist()
        assert rec["n_deduped"] == 0
        assert rec["clock"] == 12
        for k, v in exp.items():
            np.testing.assert_array_equal(rec["params"][k], v)
            np.testing.assert_array_equal(rec["params"][k],
                                          rt.master_value(k))
        recs[name] = rec
    _same_recovery(recs["port"], recs["ref"])


def test_snapshot_positioned_replay(tmp_path):
    runs = _runs(tmp_path, seed=6, n_clocks=15, snaps=True, snapshot_every=4)
    exp = _expected(6, 4, 15)
    for name, P in PKGS:
        rt, wal_dir, sdir = runs[name]
        rec = _recover(P, _x0(), wal_dir, snapshot_dir=sdir)
        assert rec["from_snapshot"] is not None
        assert rec["applied_parts"].tolist() == rt._parts_sent.tolist()
        gen = _recover(P, _x0(), wal_dir)
        for k, v in exp.items():
            np.testing.assert_array_equal(rec["params"][k], v)
            np.testing.assert_array_equal(gen["params"][k], v)


def test_point_in_time_restore(tmp_path):
    runs = _runs(tmp_path, seed=7, n_clocks=12)
    for c in (3, 7):
        recs = {}
        exp = _expected(7, 4, 12, upto_ts=c)
        for name, P in PKGS:
            rec = _recover(P, _x0(), runs[name][1], upto_vc=[c, c])
            assert rec["clock_vc"].tolist() == [c, c]
            assert rec["clock"] == c + 1
            for k, v in exp.items():
                np.testing.assert_array_equal(rec["params"][k], v)
            recs[name] = rec
        for k in exp:
            np.testing.assert_array_equal(recs["port"]["params"][k],
                                          recs["ref"]["params"][k])


def test_point_in_time_skips_uncovered_snapshot(tmp_path):
    runs = _runs(tmp_path, seed=8, n_clocks=16, snaps=True, snapshot_every=4)
    exp = _expected(8, 4, 16, upto_ts=2)
    for name, P in PKGS:
        _, wal_dir, sdir = runs[name]
        rec = _recover(P, _x0(), wal_dir, snapshot_dir=sdir, upto_vc=[2, 2])
        assert rec["from_snapshot"] is None
        for k, v in exp.items():
            np.testing.assert_array_equal(rec["params"][k], v)


def test_double_replay_is_idempotent(tmp_path):
    runs = _runs(tmp_path, seed=9, n_clocks=10)
    for name, P in PKGS:
        rt, wal_dir, _ = runs[name]
        clean = _recover(P, _x0(), wal_dir)
        for fname in list(os.listdir(wal_dir)):
            base, ext = os.path.splitext(fname)
            assert base.endswith("_g0000")
            dup = base[:-6] + "_g9999" + ext
            with open(os.path.join(wal_dir, fname), "rb") as src, \
                    open(os.path.join(wal_dir, dup), "wb") as dst:
                dst.write(src.read())
        rec = _recover(P, _x0(), wal_dir)
        assert rec["n_deduped"] > 0
        assert rec["n_deduped"] == rec["n_replayed"]
        assert rec["applied_parts"].tolist() == rt._parts_sent.tolist()
        for k in clean["params"]:
            np.testing.assert_array_equal(rec["params"][k],
                                          clean["params"][k])


def test_tampered_vc_stamp_refused(tmp_path):
    for name, P in PKGS:
        d1, d2 = str(tmp_path / name / "wal"), str(tmp_path / name / "wal2")
        w = P["WalWriter"](d1, sid=0, codec=_codec(P), n_proc=2)
        w.log_parts([_msg(P, 1, 0, 0)])
        w.commit(np.array([1 << 50, 0]))
        w.seal()
        with pytest.raises(ValueError, match="out-of-range"):
            _recover(P, _x0(), d1, n_proc=2)
        w2 = P["WalWriter"](d2, sid=0, codec=_codec(P), n_proc=2)
        w2.log_parts([_msg(P, 1, 0, 0)])
        w2.commit(np.array([0, 0, 0]))
        w2.seal()
        with pytest.raises(ValueError, match="malformed"):
            _recover(P, _x0(), d2, n_proc=2)


def test_recovery_after_torn_tail(tmp_path):
    runs = _runs(tmp_path, seed=11, n_clocks=10)
    for name, P in PKGS:
        _, wal_dir, _ = runs[name]
        full = _recover(P, _x0(), wal_dir)
        start, path = P["wal_segments"](wal_dir)[0][-1]
        size = os.path.getsize(path)
        with open(path, "rb+") as f:
            f.truncate(size - 7)
        rec = _recover(P, _x0(), wal_dir)
        assert (rec["applied_parts"] <= full["applied_parts"]).all()
        assert rec["n_deduped"] == 0


# ---------------------------------------------------------------------------
# retention + snapshot wal-marks plumbing
# ---------------------------------------------------------------------------


def test_retention_prunes_and_restores_from_newest_pair(tmp_path):
    runs = _runs(tmp_path, seed=12, n_clocks=18, snaps=True,
                 snapshot_every=3, snapshot_keep_last=2,
                 wal_segment_bytes=2048)
    exp = _expected(12, 4, 18)
    for name, P in PKGS:
        rt, wal_dir, sdir = runs[name]
        assert len(os.listdir(sdir)) == 2
        assert len(rt.snapshots) == 2
        rec = _recover(P, _x0(), wal_dir, snapshot_dir=sdir)
        assert rec["from_snapshot"] is not None
        assert rec["applied_parts"].tolist() == rt._parts_sent.tolist()
        for k, v in exp.items():
            np.testing.assert_array_equal(rec["params"][k], v)


def test_snapshot_wal_marks_roundtrip(tmp_path):
    runs = _runs(tmp_path, seed=13, n_clocks=8)
    for name, P in PKGS:
        rt, wal_dir, _ = runs[name]
        snap = P["take_snapshot"](rt)
        assert "wal" in snap
        p = str(tmp_path / name / "s.npz")
        P["save_snapshot"](p, snap)
        back = P["load_snapshot"](p)
        assert back["wal"]["slots"] == snap["wal"]["slots"]
        for f in ("parts", "applied", "max_ts"):
            np.testing.assert_array_equal(back["wal"][f], snap["wal"][f])
        rec = _recover(P, _x0(), wal_dir, snapshot=back)
        assert rec["n_replayed"] == 0
        assert rec["applied_parts"].tolist() == rt._parts_sent.tolist()
    # the two packages cut the same marks of the same run
    snaps = {name: P["take_snapshot"](runs[name][0]) for name, P in PKGS}
    for f in ("parts", "applied", "max_ts"):
        np.testing.assert_array_equal(snaps["port"]["wal"][f],
                                      snaps["ref"]["wal"][f])


# ---------------------------------------------------------------------------
# config validation + metrics surface
# ---------------------------------------------------------------------------


def test_config_validations(tmp_path):
    for _, P in PKGS:
        cfg = P["RuntimeConfig"]
        ok = dict(n_workers=2, policy=P["policies"].ssp(1),
                  init_params=_x0())
        with pytest.raises(ValueError, match="snapshot_dir"):
            cfg(**ok, snapshot_every=5)
        with pytest.raises(ValueError, match="wal_dir"):
            cfg(**ok, wal_fsync="boundary")
        with pytest.raises(ValueError, match="wal_fsync"):
            cfg(**ok, wal_dir=str(tmp_path), wal_fsync="always")
        with pytest.raises(ValueError, match="wal_segment_bytes"):
            cfg(**ok, wal_dir=str(tmp_path), wal_segment_bytes=0)
        with pytest.raises(ValueError, match="snapshot_keep_last"):
            cfg(**ok, snapshot_every=5, snapshot_dir=str(tmp_path),
                snapshot_keep_last=-1)
        with pytest.raises(ValueError, match="snapshot_dir"):
            cfg(**ok, snapshot_keep_last=2)
        cfg(**ok, wal_dir=str(tmp_path), wal_fsync="boundary")
        cfg(**ok, snapshot_every=5, snapshot_dir=str(tmp_path),
            snapshot_keep_last=2)
        with pytest.raises(ValueError, match="fsync"):
            P["WalWriter"](str(tmp_path), 0, _codec(P), 2, fsync="weekly")


def test_metrics_report_wal_counters(tmp_path):
    runs = _runs(tmp_path, seed=14, n_clocks=8, wal_fsync="boundary")
    for name, P in PKGS:
        rt = runs[name][0]
        m = rt.metrics()
        active = [s for s in m.shards if s.active]
        assert sum(s.wal_parts for s in active) == int(rt._parts_sent.sum())
        for s in active:
            assert s.wal_commits > 0
            assert s.wal_bytes > 0
            assert s.wal_segments >= 1
            assert s.wal_fsync_s > 0.0
        off = P["PSRuntime"](P["RuntimeConfig"](2, P["policies"].ssp(1),
                                                _x0(), **P["kw"]))
        off.run(_fn(1), n_clocks=2)
        assert all(s.wal_parts == 0 and s.wal_commits == 0
                   for s in off.metrics().shards)
    # the port's counter includes the EOF sentinels: it equals the files
    rt, wal_dir, _ = runs["port"]
    on_disk = sum(os.path.getsize(os.path.join(wal_dir, f))
                  for f in os.listdir(wal_dir))
    assert sum(s.wal_bytes for s in rt.metrics().shards) == on_disk


# ---------------------------------------------------------------------------
# cross-package: the same bsp run recovers to the same state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_recover_to_vc_bitwise_equal_across_packages_on_bsp(tmp_path, seed):
    """bsp with barrier_reads fixes the order of applies, so both packages
    log the same parts: recovery from genesis, from a snapshot and to a
    point in time returns bitwise equal params, applied_parts and clock_vc
    in the two packages (tolerance: none)."""
    out = {}
    for name, P in PKGS:
        root = tmp_path / name
        sdir = str(root / "snaps")
        rt = P["PSRuntime"](P["RuntimeConfig"](
            2, P["policies"].bsp(), _x0(), n_shards=2, seed=seed,
            barrier_reads=True, wal_dir=str(root / "wal"),
            snapshot_every=3, snapshot_dir=sdir, **P["kw"]))
        rt.run(_fn(seed), n_clocks=8)
        wal_dir = str(root / "wal")
        out[name] = [_recover(P, _x0(), wal_dir),
                     _recover(P, _x0(), wal_dir, snapshot_dir=sdir),
                     _recover(P, _x0(), wal_dir, upto_vc=[4, 4])]
        for k in _x0():
            np.testing.assert_array_equal(out[name][0]["params"][k],
                                          rt.master_value(k))
    for i, (a, b) in enumerate(zip(out["port"], out["ref"])):
        _same_recovery(a, b, counts=i != 1)
