"""Cluster serving tier: the deployable service in front of the engines.

``replicas``  — ReplicaPool: N engine replicas, health checks, draining,
                p50-weighted routing, shutdown propagation
``frontend``  — ClusterFrontend: bounded admission queue, deadline/priority
                dequeue, backpressure, failover routing, asyncio adapter
``persist``   — PersistentDatasetStore: WAL + snapshots + crash recovery
                for the streaming ground-truth store
``transport`` — the wire: v2 length-prefixed JSON frames and the v3 binary
                zero-copy framing (raw float payloads, negotiated per
                connection), deadline propagation, FrontendRejected /
                DeadlineExceeded / AuthError as first-class error frames
``remote``    — PredictionServer (a ClusterFrontend on a socket, bounded
                accept loop, graceful drain) and RemoteReplica (the
                engine-shaped client a ReplicaPool routes to cross-host)

Shard-level failure handling (drop a dead shard, renormalize the forest
mean over survivors) lives with the engine it degrades:
``serve.sharded.ShardedForestEngine.drop_shard``.

A copy of ``repro.cluster``, its imports pointed at the port.
"""
from .frontend import (ClusterFrontend, DeadlineExceeded, FrontendConfig,
                       FrontendRejected, FrontendStats)
from .persist import PersistentDatasetStore, WriteAheadLog
from .remote import PredictionServer, RemoteReplica, RemoteStats
from .replicas import PoolStats, Replica, ReplicaPool
from .transport import (PROTOCOL_V3, PROTOCOL_VERSION, AuthError,
                        ProtocolError, RemoteError, TransportError)

__all__ = ["PROTOCOL_V3", "PROTOCOL_VERSION", "AuthError", "ClusterFrontend",
           "DeadlineExceeded", "FrontendConfig", "FrontendRejected",
           "FrontendStats", "PersistentDatasetStore", "PoolStats",
           "PredictionServer", "ProtocolError", "RemoteError",
           "RemoteReplica", "RemoteStats", "Replica", "ReplicaPool",
           "TransportError", "WriteAheadLog"]
