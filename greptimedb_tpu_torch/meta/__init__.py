"""Meta plane: cluster metadata service, client, failure detection.

Reference behavior: src/meta-srv + src/meta-client (see service.py).

Ported from greptimedb_tpu/meta/: the in-process meta service (kv, lock,
failure_detector, service, balancer). Meta over Flight (flight.py) and its
KV replication (replication.py) are not ported yet.
"""

from .balancer import RegionBalancer
from .failure_detector import PhiAccrualFailureDetector
from .kv import MemKv
from .service import (
    DatanodeStat, HeartbeatResponse, MetaClient, MetaSrv,
    NoAliveDatanodeError, Peer, RegionRoute, TableRoute,
)

__all__ = [
    "DatanodeStat", "HeartbeatResponse", "MemKv", "MetaClient", "MetaSrv",
    "NoAliveDatanodeError", "Peer", "PhiAccrualFailureDetector",
    "RegionBalancer", "RegionRoute", "TableRoute",
]
