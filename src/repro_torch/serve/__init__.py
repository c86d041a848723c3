"""Streaming session serving: ``sessions`` (carried state + mask
coordinates), ``stream`` (the batched tick loop), ``admission`` (bounded
priority queue, and the fleet's weighted-fair queue), ``scheduler``
(adaptive launch shapes, tick metrics and ``prewarm``), ``graphs`` (a
serving step captured as one CUDA graph), ``persistence`` (crash-safe
snapshots in the reference's format), ``fleet`` (heterogeneous tenants in
one tick) and ``controller`` (the data plane of a reconfiguration)."""

from repro_torch.serve.admission import (AdmissionQueue, DrainRejected,
                                         FleetTicket, QueueFull, Ticket,
                                         WeightedFairQueue)
from repro_torch.serve.controller import (ServingConfig, carry_dtypes,
                                          convert_session)
from repro_torch.serve.fleet import FleetEngine, TenantSpec
from repro_torch.serve.graphs import StaticStep
from repro_torch.serve.persistence import (FLEET_FORMAT_VERSION,
                                           FORMAT_VERSION,
                                           load_any_snapshot_meta,
                                           load_fleet_meta,
                                           load_snapshot_meta, restore_fleet,
                                           restore_store, snapshot_fleet,
                                           snapshot_store)
from repro_torch.serve.scheduler import (AdaptiveTickScheduler, TickMetrics,
                                         pow2_ladder, prewarm, summarize)
from repro_torch.serve.sessions import CapacityError, Session, SessionStore
from repro_torch.serve.stream import (ChunkResult, JsonlSink, MetricsSink,
                                      RingBufferSink, StreamingEngine)

__all__ = ["AdmissionQueue", "AdaptiveTickScheduler", "CapacityError",
           "ChunkResult", "DrainRejected", "FLEET_FORMAT_VERSION",
           "FORMAT_VERSION", "FleetEngine", "FleetTicket", "JsonlSink",
           "MetricsSink", "QueueFull", "RingBufferSink",
           "ServingConfig", "Session", "SessionStore", "StaticStep",
           "StreamingEngine", "TenantSpec", "Ticket", "TickMetrics",
           "WeightedFairQueue", "carry_dtypes", "convert_session",
           "load_any_snapshot_meta", "load_fleet_meta",
           "load_snapshot_meta", "pow2_ladder", "prewarm", "restore_fleet",
           "restore_store", "snapshot_fleet", "snapshot_store", "summarize"]
