"""Runtime configuration (:class:`RuntimeConfig`).

The single construction surface of :class:`~repro_torch.runtime.PSRuntime`:

    from repro_torch.runtime import PSRuntime, RuntimeConfig

    rt = PSRuntime(RuntimeConfig(4, ssp(3), x0))               # on the card
    rt = PSRuntime(RuntimeConfig(4, ssp(3), x0, device="cpu"))  # on the host
    rt = PSRuntime(RuntimeConfig(4, ssp(3), x0, transport="shm"))  # forked

The fields mirror the JAX package's ``RuntimeConfig`` so call sites carry
over, and so do its validations: a config is either valid or never
constructed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.core.policies import Policy
from repro_torch.core.server import UpdateMap
from repro_torch.runtime.trace import normalize_trace
from repro_torch.runtime.wal import FSYNC_POLICIES as WAL_FSYNC

TRANSPORTS: Tuple[str, ...] = ("queue", "tcp", "shm", "proc")


@dataclass
class RuntimeConfig:
    """Everything a :class:`PSRuntime` needs to build itself.

    The first three fields are the required triple every run names
    (worker count, consistency policy, initial table values); the rest
    default to the single-host topology the tests use.

    ``device`` is where the shards' master blocks live and where the shard
    apply and the send order run: ``"cuda"`` (the default) or ``"cpu"``.
    Under a wire transport (``"shm"``, its alias ``"proc"``, ``"tcp"``) the
    clients are forked processes that stay on the host: the shards, and the
    apply, stay on ``device`` in the parent, and each client orders its
    flushes in host numpy.  ``zero_copy`` (None or True: on) picks the shm
    transport's raw row-block wire with in-ring views over pickle-5 frames;
    the other transports ignore it.
    Elastic membership (:mod:`repro_torch.runtime.membership`):
    ``max_shards`` provisions that many shard slots (threads, channels and
    wires for every transport) with ``n_shards`` of them active in epoch 0,
    so ``rt.add_shard()`` / ``rt.remove_shard()`` can re-partition live;
    ``membership_plan`` (a ``MembershipPlan``) scripts such ops at clock
    boundaries.
    The reference's ``ps_kernels`` flag is not carried over, because on the
    port the device decides: on CUDA the kernels always run, on the CPU
    their plain PyTorch versions do.  Asking for CUDA on a host without a
    CUDA device raises when the runtime is built.

    Durability (:mod:`repro_torch.runtime.wal`): ``wal_dir`` turns on a
    per-shard write-ahead delta log, group-committed at clock boundaries;
    ``wal_fsync`` is ``"none"`` (flush to the OS page cache, the default
    once ``wal_dir`` is set) or ``"boundary"`` (fsync every group commit);
    segments rotate past ``wal_segment_bytes``.  ``snapshot_every=k`` takes
    a snapshot of the masters each time the applied frontier crosses a
    multiple of k clocks, into ``snapshot_dir``, keeping the newest
    ``snapshot_keep_last`` (0: all) and pruning the log segments the oldest
    kept one covers; ``restore_from`` starts the runtime from a snapshot.
    Tracing (:mod:`repro_torch.runtime.trace`): ``trace`` is None or False
    (off, the default), True, a sample rate in (0, 1], a ``{"sample":,
    "capacity":}`` dict or a ``TraceConfig``.
    """

    n_workers: int
    policy: Policy
    init_params: UpdateMap
    n_shards: int = 2
    threads_per_process: int = 1
    seed: int = 0
    prioritize_by_magnitude: bool = True
    check_invariants: bool = True
    barrier_reads: bool = False
    transport: str = "queue"
    restore_from: Optional[dict] = None
    snapshot_every: int = 0
    snapshot_dir: Optional[str] = None
    max_shards: Optional[int] = None
    membership_plan: Optional[object] = None
    zero_copy: Optional[bool] = None
    # keep the per-process load counters and their ClockMsg piggyback on
    metrics: bool = field(default=True)
    wal_dir: Optional[str] = None
    wal_fsync: Optional[str] = None
    wal_segment_bytes: int = 1 << 22
    snapshot_keep_last: int = 0
    trace: object = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.n_workers % self.threads_per_process:
            raise ValueError("n_workers must divide into processes evenly")
        if self.n_shards < 1:
            raise ValueError("need at least one server shard")
        if self.max_shards is not None and self.max_shards < self.n_shards:
            raise ValueError("max_shards must be >= n_shards")
        if self.barrier_reads and self.threads_per_process != 1:
            raise ValueError("barrier_reads requires threads_per_process == 1")
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; "
                             f"choose from {TRANSPORTS}")
        if self.snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0 (0 disables)")
        if self.snapshot_every and not self.snapshot_dir:
            raise ValueError(
                "snapshot_every without snapshot_dir would drop every "
                "periodic snapshot on the floor at restart; pass "
                "snapshot_dir= (or set snapshot_every=0)")
        if self.wal_fsync is not None and not self.wal_dir:
            raise ValueError("wal_fsync without wal_dir is a silent no-op; "
                             "pass wal_dir= (or drop wal_fsync)")
        if self.wal_fsync is not None and self.wal_fsync not in WAL_FSYNC:
            raise ValueError(f"unknown wal_fsync policy {self.wal_fsync!r}; "
                             f"choose from {WAL_FSYNC}")
        if self.wal_segment_bytes < 1:
            raise ValueError("wal_segment_bytes must be >= 1")
        if self.snapshot_keep_last < 0:
            raise ValueError("snapshot_keep_last must be >= 0 (0 keeps all)")
        if self.snapshot_keep_last and not self.snapshot_dir:
            raise ValueError("snapshot_keep_last prunes on-disk snapshots; "
                             "it requires snapshot_dir")
        # a bad trace spec fails at construction, not at the first event
        normalize_trace(self.trace)
