"""Streaming session serving: ``sessions`` (carried state + mask
coordinates), ``stream`` (the batched tick loop), ``admission`` (bounded
priority queue) and ``scheduler`` (adaptive launch shapes + tick metrics)."""

from repro_torch.serve.admission import (AdmissionQueue, DrainRejected,
                                         QueueFull, Ticket)
from repro_torch.serve.scheduler import (AdaptiveTickScheduler, TickMetrics,
                                         pow2_ladder, summarize)
from repro_torch.serve.sessions import CapacityError, Session, SessionStore
from repro_torch.serve.stream import (ChunkResult, JsonlSink, MetricsSink,
                                      RingBufferSink, StreamingEngine)

__all__ = ["AdmissionQueue", "AdaptiveTickScheduler", "CapacityError",
           "ChunkResult", "DrainRejected", "JsonlSink", "MetricsSink",
           "QueueFull", "RingBufferSink", "Session", "SessionStore",
           "StreamingEngine", "Ticket", "TickMetrics", "pow2_ladder",
           "summarize"]
