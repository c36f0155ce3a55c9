"""Runtime configuration (:class:`RuntimeConfig`).

The single construction surface of :class:`~repro_torch.runtime.PSRuntime`:

    from repro_torch.runtime import PSRuntime, RuntimeConfig

    rt = PSRuntime(RuntimeConfig(4, ssp(3), x0))               # on the card
    rt = PSRuntime(RuntimeConfig(4, ssp(3), x0, device="cpu"))  # on the host

The fields mirror the JAX package's ``RuntimeConfig`` so call sites carry
over.  The tiers this port does not have yet (wire transports, snapshots,
elastic membership, the write-ahead log, tracing, the zero-copy wire) keep
their fields, and setting one raises :class:`NotImplementedError` naming the
ROADMAP item that ports it, instead of being silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.core.policies import Policy
from repro_torch.core.server import UpdateMap

TRANSPORTS: Tuple[str, ...] = ("queue", "tcp", "shm", "proc")

# field -> (value the port runs with, ROADMAP item that ports the rest)
_NOT_PORTED = {
    "transport": ("queue", "Queue 1 item 2: wire transports (shm, tcp)"),
    "restore_from": (None, "Queue 1 item 5: snapshots and WAL recovery"),
    "snapshot_every": (0, "Queue 1 item 5: snapshots and WAL recovery"),
    "snapshot_dir": (None, "Queue 1 item 5: snapshots and WAL recovery"),
    "snapshot_keep_last": (0, "Queue 1 item 5: snapshots and WAL recovery"),
    "max_shards": (None, "Queue 1 item 5: elastic membership"),
    "membership_plan": (None, "Queue 1 item 5: elastic membership"),
    "zero_copy": (None, "Queue 1 item 2: the shm zero-copy wire"),
    "wal_dir": (None, "Queue 1 item 5: write-ahead log"),
    "wal_fsync": (None, "Queue 1 item 5: write-ahead log"),
    "wal_segment_bytes": (1 << 22, "Queue 1 item 5: write-ahead log"),
    "trace": (None, "Queue 1 item 5: metrics and tracing"),
}


@dataclass
class RuntimeConfig:
    """Everything a :class:`PSRuntime` needs to build itself.

    The first three fields are the required triple every run names
    (worker count, consistency policy, initial table values); the rest
    default to the single-host topology the tests use.

    ``device`` is where the shards' master blocks live and where the shard
    apply and the send order run: ``"cuda"`` (the default) or ``"cpu"``.
    The reference's ``ps_kernels`` flag is not carried over, because on the
    port the device decides: on CUDA the kernels always run, on the CPU
    their plain PyTorch versions do.  Asking for CUDA on a host without a
    CUDA device raises when the runtime is built.
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
        if self.barrier_reads and self.threads_per_process != 1:
            raise ValueError("barrier_reads requires threads_per_process == 1")
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; "
                             f"choose from {TRANSPORTS}")
        for name, (ported, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value != ported and value not in (None, False):
                raise NotImplementedError(
                    f"RuntimeConfig({name}={value!r}) is not ported to "
                    f"repro_torch yet (ROADMAP {item})")
