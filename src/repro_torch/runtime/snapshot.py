"""Snapshot/restore of the PS runtime's shard tables, and exact-clock
recovery from the write-ahead log.

A snapshot captures the **master state** — every shard's dense row blocks,
copied from the device to the host, with the global row ids they map to —
at a quiesced point (after ``wait()``, or any moment under the per-shard
locks; mid-run snapshots are consistent per shard but may interleave with
in-flight deliveries, exactly like a parameter server checkpointing
without a barrier).

Restore paths:

  * ``ServerShard.load_state(snap["shards"][sid])`` — a killed server shard
    rejoins with its partition intact (same ``n_shards``);
  * ``PSRuntime(RuntimeConfig(..., restore_from=snap))`` — a fresh runtime
    resumes from the snapshot's master values (any ``n_shards``: the master
    is reassembled and re-partitioned, then copied to the host ``x0`` and
    to the masters on the device), so a restarted server continues where
    the killed one stopped.  Because updates are additive, running clocks
    ``[0, a)`` then resuming for ``[a, b)`` lands on exactly the state of an
    uninterrupted ``[0, b)`` run.

On-disk format: ``np.savez`` with a JSON header (version, n_shards, key
order, original shapes) plus one ``rows``/``values`` array pair per
(shard, key) — no pickled objects, so a snapshot saved by the JAX package
loads here and one saved here loads there.  It is how state crosses
between the two packages, beside :mod:`repro_torch.convert`.

Recovery (:func:`recover_to_vc`) rebuilds the master as ``snapshot +
replay(log, upto_vc)`` from the per-shard logs of
:mod:`repro_torch.runtime.wal`.  The replay runs on the device: the
full-key float64 buffers live there and every logged part lands through
the ``ps_apply`` kernel (its plain version on the CPU), in log order.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.runtime.shard import UidDedup
from repro_torch.runtime.transport import RowCodec
from repro_torch.runtime.wal import read_segment, wal_segments

SNAPSHOT_VERSION = 1


def take_snapshot(rt) -> dict:
    """Capture master shard state of a :class:`PSRuntime` (see module doc).

    Besides the dense row blocks, the snapshot is stamped with each shard's
    applied per-process vector clock (``clock_vcs``) and the completed-clock
    frontier those vcs imply (``clock``) — what lets a serving-tier replica
    seeded from a snapshot report an honest staleness before its in-stream
    bootstrap arrives.

    Elastic membership: only the *active* shards of the current epoch are
    captured (their row sets cover the master exactly), under the
    membership op lock, so a snapshot can never interleave with a live
    re-partition's install window.

    Durability tier: when shards carry a WAL, each active shard's state
    (copied off the device), vc, and log marks are cut under ONE lock
    acquisition (``ServerShard.durability_cut``), and the snapshot gains a
    ``"wal"`` entry with per-*slot* logged-part positions (``parts``),
    per-origin applied counts, and max update timestamps — the exact
    per-slot log prefix this snapshot covers, which :func:`recover_to_vc`
    skips on replay and :func:`repro_torch.runtime.wal.prune_segments`
    truncates by."""
    with rt.membership.op_lock:
        acts = [s for s in rt.shards if rt.partition.owns(s.sid)]
        states, vcs, cut_marks = [], [], {}
        for s in acts:
            st, vc, mk = s.durability_cut()
            states.append(st)
            vcs.append(vc)
            cut_marks[s.sid] = mk
        snap = {
            "version": SNAPSHOT_VERSION,
            "n_shards": len(acts),
            "n_proc": rt.n_proc,
            "clock": min(int(vc.min()) for vc in vcs) + 1,
            "shapes": {k: tuple(v) for k, v in rt._shapes.items()},
            "shards": states,
            "clock_vcs": vcs,
        }
        if any(s.wal is not None for s in rt.shards):
            n_slots = len(rt.shards)
            parts = np.zeros(n_slots, dtype=np.int64)
            applied = np.zeros((n_slots, rt.n_proc), dtype=np.int64)
            max_ts = np.full((n_slots, rt.n_proc), -1, dtype=np.int64)
            for s in rt.shards:
                if s.wal is None:
                    continue
                mk = cut_marks.get(s.sid)
                if mk is None:
                    # inactive slot: its log is sealed/quiescent this
                    # epoch, but read the marks under its lock anyway
                    with s.lock:
                        mk = s.wal.marks()
                parts[s.sid] = mk["parts"]
                applied[s.sid] = mk["applied"]
                max_ts[s.sid] = mk["max_ts"]
            snap["wal"] = {"slots": n_slots, "parts": parts,
                           "applied": applied, "max_ts": max_ts}
        return snap


def assemble_master(snap: dict) -> Dict[str, np.ndarray]:
    """Reassemble the full flat (R, C) master value per key."""
    shapes = snap["shapes"]
    out: Dict[str, np.ndarray] = {}
    for key, shape in shapes.items():
        r = shape[0] if len(shape) else 1
        c = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        full = np.zeros((r, c) if len(shape) else (1, 1), dtype=np.float64)
        seen = 0
        for part in snap["shards"]:
            piece = part[key]
            full[piece["rows"]] = piece["values"]
            seen += len(piece["rows"])
        if seen != full.shape[0]:
            raise ValueError(f"snapshot incomplete for {key!r}: "
                             f"{seen}/{full.shape[0]} rows")
        out[key] = full
    return out


def validate_vcs(snap: dict) -> None:
    """Refuse a snapshot whose vector-clock stamps are malformed or
    internally inconsistent (tampering, truncation, bit rot): every vc must
    be a 1-D integer array of ``n_proc`` entries, each in ``[-1, 2^48)``,
    and the stamped completed-clock frontier must equal the frontier the
    vcs imply.  A corrupted vc would let a serving replica stamp stale
    values as fresh, so a bad snapshot is rejected loudly instead."""
    vcs = snap.get("clock_vcs")
    if not vcs:
        return
    n_proc = snap.get("n_proc")
    for sid, vc in enumerate(vcs):
        a = np.asarray(vc)
        if (a.ndim != 1 or not np.issubdtype(a.dtype, np.integer)
                or (n_proc is not None and a.shape[0] != n_proc)):
            raise ValueError(
                f"snapshot vector clock for shard {sid} is malformed "
                f"(shape {a.shape}, dtype {a.dtype}); refusing to restore")
        if a.size and (int(a.min()) < -1 or int(a.max()) >= 1 << 48):
            raise ValueError(
                f"snapshot vector clock for shard {sid} has out-of-range "
                f"entries ({a.tolist()}); refusing a tampered snapshot")
    clock = snap.get("clock")
    if clock is not None:
        implied = min(int(np.asarray(vc).min()) for vc in vcs) + 1
        if clock != implied:
            raise ValueError(
                f"snapshot clock stamp {clock} contradicts its vector "
                f"clocks (implied {implied}); refusing a tampered snapshot")


def conservative_vc(snap: dict, n_shards: int, n_proc: int) -> np.ndarray:
    """Per-(shard, process) vector-clock seed for a serving-tier replica
    bootstrapping from this snapshot: the per-process minimum across the
    snapshot's shards, broadcast to ``n_shards``.  A valid lower bound for
    every current shard even when the shard count changed since the snapshot
    (the same re-partition-safety argument as :func:`assemble_master`);
    falls back to the all ``-1`` vc when the snapshot predates vc stamping
    or the process count differs."""
    validate_vcs(snap)
    vcs = snap.get("clock_vcs")
    if not vcs or snap.get("n_proc") != n_proc:
        return np.full((n_shards, n_proc), -1, dtype=np.int64)
    lo = np.min(np.stack(vcs), axis=0)
    return np.tile(lo, (n_shards, 1)).astype(np.int64)


def snapshot_params(snap: dict) -> Dict[str, np.ndarray]:
    """Snapshot master values in their original shapes — ready to pass as
    ``init_params`` of a resuming runtime (equivalent to ``restore_from``)."""
    master = assemble_master(snap)
    return {k: master[k].reshape(snap["shapes"][k]) for k in master}


def restore_into(rt, snap: dict) -> None:
    """Adopt snapshot master values into a freshly constructed runtime.

    Called from ``PSRuntime.__init__`` (``restore_from=``) after the shards
    are built and before any client state exists: both the shard blocks on
    the device and the runtime's host x0 (which seeds every process cache)
    take the snapshot values, so eventual-consistency checks remain exact.
    """
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version {snap.get('version')}")
    validate_vcs(snap)
    master = assemble_master(snap)
    if set(master) != set(rt._x0):
        raise ValueError(f"snapshot keys {sorted(master)} != runtime keys "
                         f"{sorted(rt._x0)}")
    for key, full in master.items():
        if tuple(snap["shapes"][key]) != tuple(rt._shapes[key]):
            raise ValueError(f"snapshot shape mismatch for {key!r}: "
                             f"{snap['shapes'][key]} != {rt._shapes[key]}")
        rt._x0[key][...] = full
        for shard in rt.shards:
            rows = rt.partition.rows_of(key, shard.sid)
            with shard.lock:
                shard.dense[key].copy_(torch.from_numpy(full[rows]))


def save_snapshot(path, snap: dict) -> None:
    """Write a snapshot to ``path`` (``.npz``), no pickled objects."""
    keys: List[str] = sorted(snap["shapes"])
    header = {
        "version": snap["version"],
        "n_shards": snap["n_shards"],
        "n_proc": snap.get("n_proc"),
        "clock": snap.get("clock"),
        "keys": keys,
        "shapes": {k: list(snap["shapes"][k]) for k in keys},
    }
    wal = snap.get("wal")
    if wal is not None:
        header["wal_slots"] = int(wal["slots"])
    arrays = {"header": np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)}
    for sid, part in enumerate(snap["shards"]):
        for ki, key in enumerate(keys):
            arrays[f"s{sid}_k{ki}_rows"] = part[key]["rows"]
            arrays[f"s{sid}_k{ki}_values"] = part[key]["values"]
    for sid, vc in enumerate(snap.get("clock_vcs") or []):
        arrays[f"s{sid}_vc"] = vc
    if wal is not None:
        arrays["wal_parts"] = np.asarray(wal["parts"], dtype=np.int64)
        arrays["wal_applied"] = np.asarray(wal["applied"], dtype=np.int64)
        arrays["wal_max_ts"] = np.asarray(wal["max_ts"], dtype=np.int64)
    np.savez(path, **arrays)


def load_snapshot(path) -> dict:
    """Inverse of :func:`save_snapshot`."""
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        keys = header["keys"]
        shards = []
        vcs = []
        for sid in range(header["n_shards"]):
            part = {}
            for ki, key in enumerate(keys):
                part[key] = {"rows": z[f"s{sid}_k{ki}_rows"],
                             "values": z[f"s{sid}_k{ki}_values"]}
            shards.append(part)
            if f"s{sid}_vc" in z:
                vcs.append(z[f"s{sid}_vc"])
        wal = None
        if header.get("wal_slots") is not None:
            wal = {"slots": header["wal_slots"],
                   "parts": z["wal_parts"],
                   "applied": z["wal_applied"],
                   "max_ts": z["wal_max_ts"]}
    out = {
        "version": header["version"],
        "n_shards": header["n_shards"],
        "shapes": {k: tuple(s) for k, s in header["shapes"].items()},
        "shards": shards,
    }
    if header.get("n_proc") is not None:
        out["n_proc"] = header["n_proc"]
    if header.get("clock") is not None:
        out["clock"] = header["clock"]
    if vcs:
        out["clock_vcs"] = vcs
    if wal is not None:
        out["wal"] = wal
    return out


# ---------------------------------------------------------------------------
# exact-clock recovery: snapshot + replay(log, upto_vc)  (durability tier)
# ---------------------------------------------------------------------------

_SNAP_RE = re.compile(r"^snap_c(\d+)\.npz$")


def snapshot_name(clock: int) -> str:
    """File name of the periodic snapshot taken at completed clock
    ``clock`` (the runtime's ``snapshot_dir`` layout)."""
    return f"snap_c{clock:06d}.npz"


def snapshot_files(snapshot_dir: str) -> List[tuple]:
    """The periodic snapshots under ``snapshot_dir`` as ``[(clock, path),
    ...]``, newest first."""
    if not snapshot_dir or not os.path.isdir(snapshot_dir):
        return []
    out = []
    for f in os.listdir(snapshot_dir):
        m = _SNAP_RE.match(f)
        if m:
            out.append((int(m.group(1)), os.path.join(snapshot_dir, f)))
    out.sort(reverse=True)
    return out


def _pick_covered_snapshot(snapshot_dir: str,
                           upto: Optional[np.ndarray]) -> Optional[dict]:
    """Newest on-disk periodic snapshot usable as a replay base: it must
    carry WAL positional marks (``"wal"``), and — for a point-in-time
    target — must not already fold in any update past ``upto`` (a snapshot
    cannot be un-applied).  Snapshots failing coverage fall through to
    older ones (then genesis); a *corrupt* snapshot raises instead of
    being silently skipped."""
    for _, path in snapshot_files(snapshot_dir):
        snap = load_snapshot(path)
        validate_vcs(snap)
        wal = snap.get("wal")
        if wal is None:
            continue           # no positional marks: prefix unknown
        if upto is not None and (
                np.asarray(wal["max_ts"]).max(axis=0) > upto).any():
            continue           # contains updates past the target point
        return snap
    return None


def _infer_n_proc(logs: dict) -> int:
    n = 0
    for recs in logs.values():
        for _, records, _ in recs:
            for kind, val in records:
                if kind == "vc":
                    n = max(n, int(np.asarray(val.clock_vc).shape[0]))
                else:
                    for m in val:
                        n = max(n, m.process + 1)
    if n == 0:
        raise ValueError(
            "cannot infer n_proc from an empty wal; pass n_proc=")
    return n


def _replay_runs(bufs: Dict[str, torch.Tensor],
                runs: Dict[str, tuple]) -> None:
    """Land each key's queued parts (global rows, f64 deltas; log order) in
    its device buffer with one ordered scatter-add, then clear the queue.

    Parts of one key are concatenated in log order: the kernel walks every
    row's entries in submission order, so one launch equals applying the
    parts one by one with ``np.add.at``, bitwise.  Keys are separate
    buffers, so the order between keys does not matter."""
    for key, (rows_l, delta_l) in runs.items():
        buf = bufs[key]
        # owned, writable copies (a part read from a segment views its
        # bytes), contiguous for the wrapper
        rows = np.concatenate(rows_l)
        delta = np.concatenate(delta_l)
        # range check on the host, before the copy (the wrapper would read
        # the rows back from the card to check them)
        if rows.size and (rows.min() < 0 or rows.max() >= buf.shape[0]):
            raise IndexError(f"wal replay {key}: rows span [{rows.min()}, "
                             f"{rows.max()}], outside [0, {buf.shape[0]})")
        apply_ops.scatter_add_(
            buf, torch.from_numpy(rows).to(buf.device),
            torch.from_numpy(delta).to(buf.device), rows_checked=True)
    runs.clear()


def recover_to_vc(init_params, wal_dir: str, *,
                  snapshot_dir: Optional[str] = None,
                  snapshot: Optional[dict] = None,
                  upto_vc=None, n_proc: Optional[int] = None,
                  device=None) -> dict:
    """Rebuild exact master state from ``snapshot + replay(log, upto_vc)``.

    ``init_params`` is the same initial table dict the runtime was
    constructed with (it fixes key order — and therefore the wire codec —
    plus shapes and the additive baseline).  The newest usable periodic
    snapshot under ``snapshot_dir`` (or the explicit ``snapshot``) seeds
    the state and positions replay at the per-slot logged-part prefix it
    covers (``snap["wal"]["parts"]``); every later part in the per-shard
    logs under ``wal_dir`` is re-applied onto the full-key buffers.  With
    no usable snapshot, recovery replays the full log from genesis.

    The replay runs on ``device`` (None: the card): the full-key float64
    buffers live there, and the parts land through ``ps_apply``'s
    ``scatter_add_`` in log order — per slot, one launch per key for the
    parts between two vc stamps (:func:`_replay_runs`), bitwise equal to
    the reference's part-by-part ``np.add.at``.  ``device="cpu"`` runs the
    kernel's plain version.  The result comes back as host numpy arrays in
    the tables' original shapes.

    ``upto_vc`` (point-in-time restore): per-origin-process clock vector;
    parts timestamped past their origin's entry are excluded, yielding the
    exact state at that vector-clock cut — updates are additive and
    commutative, so the cut equals what a run stopped at that frontier
    would hold.

    Replay is **idempotent**: a per-slot :class:`~repro_torch.runtime.shard.
    UidDedup` drops uid-level duplicates across the kill epoch, with its
    frontier advanced by the vc stamps in the log (each stamp is validated
    via :func:`validate_vcs` — a tampered/out-of-range stamp is refused
    loudly).  Torn segment tails (kill mid-write) are dropped by
    :func:`repro_torch.runtime.wal.read_segment`.

    Returns ``{"params", "applied_parts", "clock_vc", "clock",
    "n_replayed", "n_deduped", "from_snapshot"}`` where ``applied_parts``
    is the per-origin-process count of parts folded into ``params``
    (snapshot-covered + replayed) — the number the runtime's
    zero-lost/zero-duplicated counter audit compares against.
    """
    dev = resolve_device("cuda" if device is None else device)
    # canonical flat (R, C) float64 buffers, exactly like PSRuntime.__init__
    shapes: Dict[str, tuple] = {}
    flat: Dict[str, np.ndarray] = {}
    for key, v in init_params.items():
        a = np.asarray(v, dtype=np.float64)
        shapes[key] = a.shape
        f = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(-1, 1)
        flat[key] = f.copy()
    codec = RowCodec(list(init_params.keys()))

    upto = None
    if upto_vc is not None:
        upto = np.asarray(upto_vc, dtype=np.int64).reshape(-1)
        if n_proc is None:
            n_proc = int(upto.shape[0])

    # decode every slot's log up front (cold path; segments are bounded by
    # rotation + retention) — genesis recovery infers n_proc from it
    logs = {sid: [(start, *read_segment(path, codec))
                  for start, path in seg_list]
            for sid, seg_list in wal_segments(wal_dir).items()}

    snap = snapshot
    if snap is None and snapshot_dir is not None:
        snap = _pick_covered_snapshot(snapshot_dir, upto)
    if snap is not None:
        if snap.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"unsupported snapshot version {snap.get('version')}")
        validate_vcs(snap)
        if snap.get("wal") is None:
            raise ValueError("snapshot carries no wal marks; cannot "
                             "position replay (take it with wal_dir set)")
        if n_proc is None:
            n_proc = snap.get("n_proc")
    if n_proc is None:
        n_proc = _infer_n_proc(logs)

    skip_parts: Dict[int, int] = {}
    applied = np.zeros(n_proc, dtype=np.int64)
    frontier = np.full(n_proc, -1, dtype=np.int64)
    if snap is not None:
        wal = snap["wal"]
        for sid, p in enumerate(np.asarray(wal["parts"])):
            skip_parts[sid] = int(p)
        applied += np.asarray(wal["applied"], dtype=np.int64).sum(axis=0)
        np.maximum(frontier,
                   np.asarray(wal["max_ts"], dtype=np.int64).max(axis=0),
                   out=frontier)
        master = assemble_master(snap)
        if set(master) != set(flat):
            raise ValueError(f"snapshot keys {sorted(master)} != "
                             f"init_params keys {sorted(flat)}")
        for key, full in master.items():
            if full.shape != flat[key].shape:
                raise ValueError(f"snapshot shape mismatch for {key!r}: "
                                 f"{full.shape} != {flat[key].shape}")
            flat[key][...] = full

    # the replay buffers on the device (on the CPU they share flat's memory)
    bufs = {key: torch.from_numpy(f).to(dev) for key, f in flat.items()}
    n_replayed = 0
    n_deduped = 0
    runs: Dict[str, tuple] = {}           # key -> (rows list, delta list)
    for sid in sorted(logs):
        # per-SLOT dedup: stamps only order a single slot's log, and uids
        # are only unique per (process, slot-log) — a shared frontier
        # advanced by one slot's stamps would false-drop another's parts
        dedup = UidDedup(n_proc)
        cover = skip_parts.get(sid, 0)
        for start, records, _sealed in logs[sid]:
            pos = start
            for kind, val in records:
                if kind == "vc":
                    _replay_runs(bufs, runs)
                    stamp = np.asarray(val.clock_vc)
                    validate_vcs({"clock_vcs": [stamp], "n_proc": n_proc})
                    for p in range(n_proc):
                        c = int(stamp[p])
                        if upto is not None:
                            c = min(c, int(upto[p]))
                        dedup.advance(p, c)
                    continue
                for m in val:
                    at, pos = pos, pos + 1
                    if at < cover:
                        continue        # inside the snapshot's prefix
                    if upto is not None and m.ts > upto[m.process]:
                        continue        # past the point-in-time target
                    if not dedup.fresh(m.uid, m.process, m.ts):
                        n_deduped += 1
                        continue
                    rows = np.asarray(m.rows, dtype=np.int64)
                    delta = np.asarray(m.delta, dtype=np.float64).reshape(
                        rows.shape[0], flat[m.key].shape[1])
                    run = runs.setdefault(m.key, ([], []))
                    run[0].append(rows)
                    run[1].append(delta)
                    applied[m.process] += 1
                    n_replayed += 1
                    if m.ts > frontier[m.process]:
                        frontier[m.process] = m.ts
        _replay_runs(bufs, runs)

    return {
        "params": {k: bufs[k].cpu().numpy().reshape(shapes[k])
                   for k in bufs},
        "applied_parts": applied,
        "clock_vc": frontier,
        "clock": int(frontier.min()) + 1 if n_proc else 0,
        "n_replayed": n_replayed,
        "n_deduped": n_deduped,
        "from_snapshot": None if snap is None else snap.get("clock"),
    }
