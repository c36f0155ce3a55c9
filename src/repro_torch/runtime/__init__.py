"""Asynchronous parameter-server runtime (Petuum-PS style) on PyTorch.

The implementation of the paper's consistency models alongside the
event-driven simulator (:mod:`repro_torch.core.server`, the executable
spec): worker threads grouped into client processes (threads in one
interpreter on the ``queue`` transport, forked OS processes on the ``shm``
and ``tcp`` wire transports), FIFO channels, and server shards whose master
blocks are float64 tensors on the runtime's device, applied by the
``ps_apply`` kernel.
"""
from repro_torch.runtime.config import TRANSPORTS, RuntimeConfig
from repro_torch.runtime.membership import INF_CLOCK, Partition
from repro_torch.runtime.messages import (AckBatchMsg, Channel, ClockMarker,
                                          ClockMsg, DeliverMsg,
                                          FullyDelivered, ProcDoneMsg,
                                          ShardFinMsg, UpdateMsg)
from repro_torch.runtime.runtime import (ClientProcess, PSRuntime,
                                         RuntimeViewHandle)
from repro_torch.runtime.shard import ServerShard, UidDedup
from repro_torch.runtime.transport import FifoAssert

__all__ = [
    "AckBatchMsg", "Channel", "ClientProcess", "ClockMarker", "ClockMsg",
    "DeliverMsg", "FifoAssert", "FullyDelivered", "INF_CLOCK", "PSRuntime",
    "Partition", "ProcDoneMsg", "RuntimeConfig", "RuntimeViewHandle",
    "ServerShard", "ShardFinMsg", "TRANSPORTS", "UidDedup", "UpdateMsg",
]
