"""Read-replica serving tier for the PS runtime.

The paper's bound, enforced on the *read* path: a :class:`ReplicaSet` of
read replicas subscribes to the master shards' publish streams over the
channel/transport layer (``queue`` | ``shm`` | ``tcp``), each replica
holding its value buffers on the runtime's device (every published delta
lands through the ``ps_apply`` kernel) and tracking a per-shard vector
clock of applied updates, and a :class:`ReadGateway` routes every read —
under a client-declared SLO of ``staleness <= k`` clocks or :data:`FRESH` —
to the cheapest replica whose vector clock satisfies it, parking on a
doorbell or escalating to the master when none does.  Every response is
stamped with the staleness actually measured against the master's applied
vector clock.
"""
from repro_torch.runtime.serving.gateway import (FRESH, GatewayStats,
                                                 ReadGateway, ReadResult,
                                                 ReadShedError)
from repro_torch.runtime.serving.replica import (SERVING_TRANSPORTS, Replica,
                                                 ReplicaSet)

__all__ = [
    "FRESH", "GatewayStats", "ReadGateway", "ReadResult", "ReadShedError",
    "Replica", "ReplicaSet", "SERVING_TRANSPORTS",
]
