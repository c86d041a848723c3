"""Streaming session serving: ``sessions`` (carried state + mask
coordinates), ``stream`` (the batched tick loop), ``admission`` (bounded
priority queue), ``scheduler`` (adaptive launch shapes, tick metrics and
``prewarm``), ``graphs`` (a serving step captured as one CUDA graph) and
``persistence`` (crash-safe snapshots in the reference's format)."""

from repro_torch.serve.admission import (AdmissionQueue, DrainRejected,
                                         QueueFull, Ticket)
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
           "FORMAT_VERSION", "JsonlSink", "MetricsSink", "QueueFull",
           "RingBufferSink", "Session", "SessionStore", "StaticStep",
           "StreamingEngine", "Ticket", "TickMetrics",
           "load_any_snapshot_meta", "load_fleet_meta",
           "load_snapshot_meta", "pow2_ladder", "prewarm", "restore_fleet",
           "restore_store", "snapshot_fleet", "snapshot_store", "summarize"]
