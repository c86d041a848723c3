"""Streaming session serving: ``sessions`` (carried state + mask
coordinates), ``stream`` (the batched tick loop), ``admission`` (bounded
priority queue, and the fleet's weighted-fair queue), ``scheduler``
(adaptive launch shapes, tick metrics and ``prewarm``), ``graphs`` (a
serving step captured as one CUDA graph), ``persistence`` (crash-safe
snapshots in the reference's format), ``fleet`` (heterogeneous tenants in
one tick) and ``controller`` (online co-design: the calibrated DSE over
the live knobs, applied through prewarmed config swaps under an SLO)."""

from repro_torch.serve.admission import (AdmissionQueue, DrainRejected,
                                         FleetTicket, QueueFull, Ticket,
                                         WeightedFairQueue)
from repro_torch.serve.controller import (CoDesignController,
                                          DecisionRecord, FleetController,
                                          KnobSpace, ServingConfig,
                                          SimulatedLoadSink, SLOPolicy,
                                          carry_dtypes, convert_session)
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
           "ChunkResult", "CoDesignController", "DecisionRecord",
           "DrainRejected", "FLEET_FORMAT_VERSION", "FORMAT_VERSION",
           "FleetController", "FleetEngine", "FleetTicket", "JsonlSink",
           "KnobSpace", "MetricsSink", "QueueFull", "RingBufferSink",
           "SLOPolicy", "ServingConfig", "Session", "SessionStore",
           "SimulatedLoadSink", "StaticStep", "StreamingEngine",
           "TenantSpec", "Ticket", "TickMetrics", "WeightedFairQueue",
           "carry_dtypes", "convert_session", "load_any_snapshot_meta",
           "load_fleet_meta", "load_snapshot_meta", "pow2_ladder", "prewarm",
           "restore_fleet", "restore_store", "snapshot_fleet",
           "snapshot_store", "summarize"]
