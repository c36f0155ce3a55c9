"""Asynchronous parameter-server runtime (Petuum-PS style) on PyTorch.

The implementation of the paper's consistency models alongside the
event-driven simulator (:mod:`repro_torch.core.server`, the executable
spec): worker threads grouped into client processes (threads in one
interpreter on the ``queue`` transport, forked OS processes on the ``shm``
and ``tcp`` wire transports), FIFO channels, and server shards whose master
blocks are float64 tensors on the runtime's device, applied by the
``ps_apply`` kernel.  Around it: unified metrics (:mod:`.metrics`),
sampled tracing (:mod:`.trace`), a per-shard write-ahead log (:mod:`.wal`),
snapshots with exact-clock recovery replayed on the card
(:mod:`.snapshot`), the serving tier (:mod:`.serving`): read replicas
with their buffers on the device behind an SLO-routed read gateway, and
elastic shard membership (:mod:`.membership`: shards added and removed
mid-run, the rows migrated on the device) driven by hand, by a scripted
plan, or by the autoscaler (:mod:`.autoscale`).
"""
import logging as _logging

from repro_torch.runtime.autoscale import (AutoscaleAction, AutoscalePolicy,
                                           Autoscaler)
from repro_torch.runtime.config import TRANSPORTS, RuntimeConfig
from repro_torch.runtime.membership import (INF_CLOCK, MembershipEvent,
                                            MembershipManager, MembershipPlan,
                                            Partition)
from repro_torch.runtime.messages import (AckBatchMsg, Channel, ClockMarker,
                                          ClockMsg, DeliverMsg, EpochAckMsg,
                                          EpochBeginMsg, EpochMsg,
                                          FullyDelivered, InstallMsg,
                                          ProcDoneMsg,
                                          ReplicaDeltaMsg, ReplicaFinMsg,
                                          ReplicaStateMsg, ReplicaVcMsg,
                                          ShardFinMsg, SubscribeMsg,
                                          UnsubscribeMsg, UpdateMsg)
from repro_torch.runtime.metrics import (GatewayMetrics, MembershipMetrics,
                                         MetricsHub, ProcessMetrics,
                                         ReplicaMetrics, RunMetrics,
                                         RuntimeMetrics, ShardMetrics,
                                         SnapshotMetrics)
from repro_torch.runtime.runtime import (ClientProcess, PSRuntime,
                                         RuntimeViewHandle)
from repro_torch.runtime.serving import (FRESH, ReadGateway, ReadResult,
                                         ReadShedError, ReplicaSet)
from repro_torch.runtime.shard import ServerShard, UidDedup
from repro_torch.runtime.snapshot import (conservative_vc, load_snapshot,
                                          recover_to_vc, save_snapshot,
                                          snapshot_params, take_snapshot,
                                          validate_vcs)
from repro_torch.runtime.trace import (TraceConfig, TraceHub,
                                       dump_chrome_trace, explain_block,
                                       explain_read, staleness_timeline)
from repro_torch.runtime.transport import (FifoAssert, FrameDecoder, ShmRing,
                                           WireChannel, encode_frame,
                                           require_tso)
from repro_torch.runtime.wal import (WalWriter, prune_segments, read_segment,
                                     wal_segments)

__all__ = [
    "AckBatchMsg", "AutoscaleAction", "AutoscalePolicy", "Autoscaler",
    "Channel", "ClientProcess", "ClockMarker", "ClockMsg",
    "DeliverMsg", "EpochAckMsg", "EpochBeginMsg", "EpochMsg", "FRESH",
    "FifoAssert", "FrameDecoder", "FullyDelivered",
    "GatewayMetrics", "INF_CLOCK", "InstallMsg", "MembershipEvent",
    "MembershipManager", "MembershipMetrics", "MembershipPlan", "MetricsHub",
    "PSRuntime", "Partition", "ProcDoneMsg", "ProcessMetrics",
    "ReadGateway", "ReadResult", "ReadShedError", "ReplicaDeltaMsg",
    "ReplicaFinMsg", "ReplicaMetrics", "ReplicaSet", "ReplicaStateMsg",
    "ReplicaVcMsg", "RunMetrics", "RuntimeConfig", "RuntimeMetrics",
    "RuntimeViewHandle", "ServerShard", "ShardFinMsg", "ShardMetrics",
    "ShmRing", "SnapshotMetrics", "SubscribeMsg", "TRANSPORTS",
    "TraceConfig", "TraceHub", "UidDedup", "UnsubscribeMsg", "UpdateMsg",
    "WalWriter", "WireChannel",
    "conservative_vc", "dump_chrome_trace", "encode_frame", "explain_block",
    "explain_read", "load_snapshot", "prune_segments", "read_segment",
    "recover_to_vc", "require_tso", "save_snapshot", "snapshot_params",
    "staleness_timeline", "take_snapshot", "validate_vcs", "wal_segments",
]

# library logging etiquette: the runtime emits structured degradation
# warnings (WAL torn tails, shm stale-cursor retries); a NullHandler keeps
# them silent unless the application configures logging
_logging.getLogger("repro_torch.runtime").addHandler(_logging.NullHandler())
