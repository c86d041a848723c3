"""Streaming session serving: ``sessions`` (carried state + mask
coordinates), ``stream`` (the batched tick loop), ``admission`` (bounded
priority queue), ``scheduler`` (adaptive launch shapes, tick metrics and
``prewarm``) and ``graphs`` (a serving step captured as one CUDA graph)."""

from repro_torch.serve.admission import (AdmissionQueue, DrainRejected,
                                         QueueFull, Ticket)
from repro_torch.serve.graphs import StaticStep
from repro_torch.serve.scheduler import (AdaptiveTickScheduler, TickMetrics,
                                         pow2_ladder, prewarm, summarize)
from repro_torch.serve.sessions import CapacityError, Session, SessionStore
from repro_torch.serve.stream import (ChunkResult, JsonlSink, MetricsSink,
                                      RingBufferSink, StreamingEngine)

__all__ = ["AdmissionQueue", "AdaptiveTickScheduler", "CapacityError",
           "ChunkResult", "DrainRejected", "JsonlSink", "MetricsSink",
           "QueueFull", "RingBufferSink", "Session", "SessionStore",
           "StaticStep", "StreamingEngine", "Ticket", "TickMetrics",
           "pow2_ladder", "prewarm", "summarize"]
