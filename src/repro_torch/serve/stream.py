"""Streaming engine: unbounded signals, chunk by chunk, one batched pass per
tick — port of ``repro.serve.stream`` for the ECG classifier and the ECG
anomaly autoencoder, LSTM or GRU.

Per tick the engine collects every submitted chunk, pads them to a common
T, folds each session's S MC chains into the batch axis, resumes each row's
carried state (``(h, c)`` per LSTM layer, ``(h,)`` per GRU layer) through
the model, emits per-session uncertainty (a classification summary, or a
regression summary over the reconstructed positions) and stores the new
carry.  On the ``"cuda_seq"`` backend a tick launches the layer kernel once
per layer; on ``"cuda_step"`` the step kernel once per layer per time step.
Streaming passes always supply ``lengths``, so a session's results do not
depend on how its signal was chunked or on which sessions shared the batch:
chunked == unchunked, bit for bit.

``precision`` serves at fp32, bf16, int8 or int4 (bf16 activations and
carried h, an fp32 LSTM c, int8/int4 weights dequantized in the sequence
kernel), on every backend.

A fixed-shape engine on a kernel backend (``chunk_capacity`` an int or
``"auto"``) runs each tick as the replay of one captured CUDA graph, the
counterpart of the reference's jitted stack: a graph a (capacity, chunk
dtype), captured on the first tick that needs it or at boot by
``scheduler.prewarm``, over static buffers the tick copies its batch and
carries into (``serve.graphs.StaticStep``; on the CPU the same buffers,
run without capture).  The quantization of the serving precisions is
captured with the layers.  Dynamic mode (``chunk_capacity=None``) and the
``reference`` backend stay eager: the reference compiles a graph for each
observed shape, and a capture for each shape costs more than an eager
pass.

``snapshot`` / ``restore`` make every live and queued stream durable in
the reference's snapshot format (``serve.persistence``): a snapshot either
package writes restores in the other, and a killed engine resumes
bit-identically, on any backend and ``chunk_capacity``, into an engine
that may already be prewarmed.  ``early_exit_threshold`` retires a
converged session's surplus chains (a prefix, one halving a tick, down to
``min_samples``), deciding as the reference decides.

``student=`` heads (``core.distill``) serve ``mode="student"`` sessions on
the distilled fast path: one deterministic (flagged) row a session, in the
same launches as the MC rows, decoded by one batched call of the student
heads; ``student_escalate_threshold`` regrows an uncertain student to S
fresh MC chains (``SessionStore.grow``).

``mesh=`` shards every tick's batch rows over a device mesh
(``launch.rnn_shardings``): session slots round up to a whole number a
shard, so a session's S chains never cross a shard, and the results are
bit-equal to the unsharded engine's.  Mask rows stay global coordinates,
so a snapshot taken on N shards restores on any other count.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core import autoencoder as _ae, classifier as _clf
from repro_torch.core import distill as _distill, mcd as _mcd, rnn as _rnn
from repro_torch.core.uncertainty import (ClassificationSummary,
                                          RegressionSummary,
                                          RunningClassificationSummary,
                                          RunningRegressionSummary,
                                          classification_summary,
                                          regression_summary)
from repro_torch.kernels import (mcd_gru, mcd_gru_seq, mcd_lstm,
                                 mcd_lstm_seq)
from repro_torch.kernels import ops as _ops, quantize as _quant
from repro_torch.serve import persistence as _persist
from repro_torch.serve.admission import AdmissionQueue, DrainRejected
from repro_torch.serve.graphs import StaticStep
from repro_torch.serve.scheduler import AdaptiveTickScheduler, TickMetrics
from repro_torch.serve.sessions import Session, SessionStore

#: Every recurrent kernel wrapper a tick can launch.
_STACK_KERNELS = (mcd_lstm_seq.mcd_lstm_seq, mcd_gru_seq.mcd_gru_seq,
                  mcd_lstm.mcd_lstm_step, mcd_gru.mcd_gru_step)


def stack_launch_count() -> int:
    """Recurrent-kernel launches so far in this process.

    The delta across a tick is ``TickMetrics.launches``: on the
    ``cuda_seq`` backend every tick launches the layer kernel once per
    layer; on ``cuda_step`` the step kernel once per layer per time step.
    """
    return sum(k.launches for k in _STACK_KERNELS)


@dataclasses.dataclass
class _TickStep:
    """The static buffers of one (capacity, chunk dtype) tick step and the
    step over them: ``x [nb, cap, I]``, ``rows [nb]`` int64, ``lengths
    [nb]`` int32 and each layer's carry parts as ``_gather_states`` makes
    them."""

    x: torch.Tensor
    rows: torch.Tensor
    lengths: torch.Tensor
    state: list
    step: StaticStep


@dataclasses.dataclass
class ChunkResult:
    """Per-chunk Bayesian output for one session."""

    sid: str
    length: int                # timesteps in this chunk
    steps_total: int           # timesteps consumed by the session so far
    summary: Any               # Classification- or RegressionSummary
                               # (batch axis squeezed; regression: the
                               # chunk's valid positions)


@runtime_checkable
class MetricsSink(Protocol):
    """Where the engine's per-tick :class:`TickMetrics` go."""

    def emit(self, m: TickMetrics) -> None: ...

    def window(self) -> Sequence[TickMetrics]: ...

    def last(self) -> TickMetrics | None: ...

    def close(self) -> None: ...


class RingBufferSink:
    """Default sink: a bounded in-memory ring (the last ``window`` ticks)."""

    def __init__(self, window: int = 4096):
        self._ring: deque[TickMetrics] = deque(maxlen=int(window))

    def emit(self, m: TickMetrics) -> None:
        self._ring.append(m)

    def window(self) -> list[TickMetrics]:
        return list(self._ring)

    def last(self) -> TickMetrics | None:
        return self._ring[-1] if self._ring else None

    def close(self) -> None:
        pass


class JsonlSink(RingBufferSink):
    """Append every tick as one JSON line (flushed); keeps the ring too."""

    def __init__(self, path, *, window: int = 4096):
        super().__init__(window)
        self.path = path
        self._fh = open(path, "a")

    def emit(self, m) -> None:
        super().emit(m)
        self._fh.write(json.dumps(dataclasses.asdict(m)) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _lap(parts: dict, name: str, t0: float) -> float:
    """Record the host seconds since ``t0`` as ``parts[name]``; returns
    now."""
    t = time.perf_counter()
    parts[name] = t - t0
    return t


def _unported(feature: str):
    return NotImplementedError(
        f"StreamingEngine: {feature} is not ported to repro_torch yet; "
        "see ROADMAP.md")


class StreamingEngine:
    """Stateful session serving for the ECG classifier / autoencoder.

    Args:
      params: model parameters (``classifier.init``, ``autoencoder.init``
        or the bridge), on ``device``.
      cfg: the matching ``ClassifierConfig`` or ``AutoencoderConfig``; its
        ``mcd`` block fixes S (chains per session), p, placement and seed,
        its ``cell`` the recurrent unit.
      backend: ``"cuda_seq"`` (the serving path: one kernel launch per
        layer per tick), ``"cuda_step"`` (one step-kernel launch per layer
        per time step) or ``"reference"``.
      max_sessions: admission bound on concurrently open sessions.
      chunk_capacity: an int launches every tick at a fixed shape (chunks
        padded to this T, the batch to ``max_sessions`` slots); ``"auto"``
        lets an :class:`AdaptiveTickScheduler` pick T from ``ladder``;
        ``None`` pads each tick to its own longest chunk.
      max_pending: admission-queue bound (``admit`` backpressure).
      metrics_sink: where per-tick :class:`TickMetrics` go (default: a
        ring of the last 4096 ticks).
      device: where the engine serves (default CUDA; ``"cpu"`` runs the
        plain-PyTorch paths).
      precision: serving precision (``quantize.PRECISIONS``; None = native
        dtypes): the fp32 master ``params`` are cast or quantized on the
        way through the stacks, never changed; the carries follow it (h in
        the activation dtype, LSTM c in fp32).
      graphs: replay one captured graph a tick where the shape family is
        bounded (``chunk_capacity`` an int or ``"auto"``) on a kernel
        backend; False serves every tick eagerly (what the graphs are held
        to).  Dynamic mode and the ``reference`` backend are always eager.
      early_exit_threshold: after each served chunk, compare a session's
        uncertainty over all its chains with that over the prefix it would
        keep (``max(min_samples, ceil(s/2))`` chains) — classifier:
        ``|MI_full - MI_prefix|``; autoencoder: the mean ``|epistemic_full
        - epistemic_prefix|`` over the chunk's valid positions — and at or
        under the threshold retire the rest (``SessionStore.retire``).
        None (default) never retires.
      min_samples: the early-exit floor.
      student: distilled student heads (``core.distill.init_student``, on
        ``device``) enabling ``mode="student"`` sessions: one
        deterministic row a session, co-batched with the MC rows, whose
        summary comes from the heads on its feature (``h_T``; the
        decoder's hidden sequence for the autoencoder).  None: student
        admissions are refused.
      student_escalate_threshold: after each served chunk, a student
        whose predicted epistemic uncertainty (MI; the mean epistemic
        variance for the autoencoder) is above this value regrows to
        ``n_samples`` fresh MC chains from its carry
        (``SessionStore.grow``).  None: students never escalate.
      mesh, policy: shard every pass over a ``launch.mesh.Mesh``
        (``launch.rnn_shardings``; policy None = the default).  The engine
        serves on ``mesh.home`` (``device`` must name it when given);
        slots pad to a whole number a shard and every session keeps the
        engine's S, so early exit and students are refused beside a mesh.
        A mesh that lists only ``mesh.home`` (one card, or the CPU, named
        once or more) keeps the tick graphs: one capture holds every
        shard's launches.  A mesh over several cards serves eagerly:
        a graph a card is not built (ROADMAP.md).
    """

    def __init__(self, params, cfg, *, backend: str = "cuda_seq",
                 max_sessions: int = 64,
                 chunk_capacity: int | str | None = None,
                 max_pending: int = 256, ladder=None,
                 metrics_sink: MetricsSink | None = None,
                 device=None, mesh=None, policy=None,
                 precision: str | None = None,
                 early_exit_threshold: float | None = None,
                 min_samples: int = 1,
                 student=None,
                 student_escalate_threshold: float | None = None,
                 graphs: bool = True):
        if isinstance(cfg, _clf.ClassifierConfig):
            self.kind = "classifier"
        elif isinstance(cfg, _ae.AutoencoderConfig):
            self.kind = "autoencoder"
        else:
            raise _unported(f"config {type(cfg).__name__} (the classifier "
                            "and the autoencoder are served)")
        _quant.check_precision(precision)
        if backend not in _ops.LSTM_BACKENDS:
            raise ValueError(f"backend must be one of {_ops.LSTM_BACKENDS}, "
                             f"got {backend!r}")
        self.device = _rnn.stack_device(device, mesh)
        self.mesh = mesh
        self.policy = policy
        if mesh is not None:
            # Deferred: serving imports without the launch layer.
            from repro_torch.launch import rnn_shardings as _rs
            self._shards = _rs.data_size(mesh, policy or _rs.DEFAULT_POLICY)
            if early_exit_threshold is not None:
                raise ValueError(
                    "early_exit_threshold is incompatible with mesh= — "
                    "ragged per-session chain counts would unbalance the "
                    "whole-sessions-per-shard placement; run early exit "
                    "unsharded or disable it on the mesh engine")
            if student is not None:
                raise ValueError(
                    "student= is incompatible with mesh= — single-row "
                    "student sessions would break the whole-sessions-per-"
                    "shard placement; serve the distilled fast path "
                    "unsharded")
        else:
            self._shards = 1
        self.params = params
        self.cfg = cfg
        self.cell = cfg.cell
        self.backend = backend
        self.precision = precision
        self.chunk_capacity = chunk_capacity
        self.max_sessions = max_sessions
        self._scheduler = None
        if chunk_capacity == "auto":
            self._scheduler = AdaptiveTickScheduler(ladder)
        elif isinstance(chunk_capacity, str):
            raise ValueError(f"chunk_capacity must be an int, None or "
                             f"'auto', got {chunk_capacity!r}")
        self._fixed = chunk_capacity is not None
        self.graphs = bool(graphs)
        # (capacity, chunk dtype) -> _TickStep; None serves eagerly.
        # A capture holds one card's launches: a mesh over other devices
        # than this engine's serves eagerly.
        one_device = mesh is None or all(d == self.device
                                         for d in mesh.device_list)
        self._graphs: dict | None = (
            {} if graphs and self._fixed and backend != "reference"
            and one_device else None)
        self._pool = None
        s = cfg.mcd.n_samples if cfg.mcd.any_bayesian else 1
        self.n_samples = max(1, s)
        if (early_exit_threshold is not None
                and not float(early_exit_threshold) >= 0.0):
            raise ValueError(f"early_exit_threshold must be >= 0, "
                             f"got {early_exit_threshold}")
        self.early_exit_threshold = (None if early_exit_threshold is None
                                     else float(early_exit_threshold))
        if not 1 <= int(min_samples) <= self.n_samples:
            raise ValueError(
                f"min_samples must be in [1, {self.n_samples}], "
                f"got {min_samples}")
        self.min_samples = int(min_samples)
        self.student = student
        if student_escalate_threshold is not None:
            if student is None:
                raise ValueError("student_escalate_threshold needs student= "
                                 "heads — there is nothing to escalate from")
            if not float(student_escalate_threshold) >= 0.0:
                raise ValueError(
                    f"student_escalate_threshold must be >= 0, "
                    f"got {student_escalate_threshold}")
        self.student_escalate_threshold = (
            None if student_escalate_threshold is None
            else float(student_escalate_threshold))
        # sid -> the prefix-vs-full delta early exit compared with the
        # threshold on the last tick (sessions above the floor only).
        self.last_exit_deltas: dict[str, float] = {}
        # The last tick's attribution a fleet splits across its tenants:
        # sid -> chains served / rows retired / student rows / escalations.
        self._last_served_chains: dict[str, int] = {}
        self._last_reclaimed: dict[str, int] = {}
        self._last_student_rows: dict[str, int] = {}
        self._last_escalated: dict[str, int] = {}
        self.store = SessionStore(self.n_samples, cfg.mcd.seed,
                                  max_sessions=max_sessions)
        self.queue = AdmissionQueue(max_pending)
        self.tick = 0
        self.metrics_sink: MetricsSink = metrics_sink or RingBufferSink()
        self.dropped_admissions: deque = deque(maxlen=4096)
        self._dropped_unreported = 0

    # -- session lifecycle ---------------------------------------------------
    def open_session(self, sid: str, *, n_samples: int | None = None,
                     mode: str = "mc"):
        """Admit a stream *now* or fail fast with ``CapacityError``.
        ``mode="student"`` opens on the distilled fast path (needs
        ``student=`` heads)."""
        if mode == "student":
            self._check_student(sid)
        else:
            self._check_chain_count(sid, n_samples)
        return self.store.admit(sid, n_samples=n_samples, mode=mode)

    def _check_student(self, sid: str) -> None:
        if self.student is None:
            raise ValueError(
                f"session {sid!r}: mode='student' needs an engine built "
                "with student= head params (repro_torch.core.distill)")

    def _check_chain_count(self, sid: str, n_samples: int | None) -> None:
        # A sharded engine places whole sessions a shard, all at one S:
        # refuse a sub-ceiling admission before it reaches a tick.
        if (n_samples is not None and self._shards > 1
                and int(n_samples) != self.n_samples):
            raise ValueError(
                f"session {sid!r}: sharded engines serve a uniform "
                f"{self.n_samples} chains/session; per-session S needs an "
                "unsharded engine")

    def admit(self, sid: str, *, priority: int = 0,
              session: Session | None = None,
              n_samples: int | None = None, mode: str | None = None):
        """Queue a stream for admission; drain it into any free row now.

        Returns the live :class:`Session` if admitted at once, else None
        (it waits in the queue; see ``queued_sessions``).
        """
        if mode == "student":
            self._check_student(sid)
        if sid in self.store:
            raise ValueError(f"session {sid!r} already admitted")
        if session is not None:
            if session.seed != self.store.seed:
                raise ValueError(
                    f"session {sid!r} was drawn under seed "
                    f"{session.seed!r}, engine uses {self.store.seed!r}")
            if int(session.rows.shape[0]) > self.n_samples:
                raise ValueError(
                    f"session {sid!r} carries {int(session.rows.shape[0])} "
                    f"MC chains, engine ceiling is {self.n_samples}")
            self._check_chain_count(sid, int(session.rows.shape[0]))
            if session.mode == "student":
                self._check_student(sid)
        elif mode != "student":
            self._check_chain_count(sid, n_samples)
        self.queue.submit(sid, priority=priority, session=session,
                          n_samples=n_samples, mode=mode)
        try:
            self.queue.drain(self.store)
        except DrainRejected as err:
            mine = next((e for t, e in err.rejected if t.sid == sid), None)
            others = [(t, e) for t, e in err.rejected if t.sid != sid]
            self.dropped_admissions.extend(others)
            self._dropped_unreported += len(others)
            if mine is not None:
                raise mine from err
        return self.store.get(sid) if sid in self.store else None

    def close_session(self, sid: str):
        """Evict a finished stream; returns the Session (final carry).

        The freed row is offered to the admission queue at once.
        """
        sess = self.store.evict(sid)
        self._drain()
        return sess

    def attach_session(self, session: Session) -> Session:
        """Re-admit an evicted Session (same draw: state + (seed, rows))."""
        if session.mode == "student":
            self._check_student(session.sid)
        else:
            self._check_chain_count(session.sid,
                                    int(session.rows.shape[0]))
        return self.store.attach(session)

    def _drain(self):
        # A rejected ticket belongs to another caller: record it, keep going.
        try:
            return self.queue.drain(self.store)
        except DrainRejected as err:
            self.dropped_admissions.extend(err.rejected)
            self._dropped_unreported += len(err.rejected)
            return err.admitted

    @property
    def active_sessions(self) -> list[str]:
        return self.store.active

    @property
    def queued_sessions(self) -> list[str]:
        return [t.sid for t in self.queue.waiting()]

    @property
    def metrics(self) -> Sequence[TickMetrics]:
        return self.metrics_sink.window()

    @property
    def last_metrics(self) -> TickMetrics | None:
        return self.metrics_sink.last()

    # -- durability ----------------------------------------------------------
    def snapshot(self, directory: str, *, step: int | None = None,
                 extra: dict | None = None) -> str:
        """Atomic, crash-safe snapshot of every live and queued stream.

        Durable state is exactly: per-session per-chain carries, ``(seed,
        rows)`` mask coordinates, step/chunk cursors, the row allocator,
        the admission wait-list, the scheduler's window and the tick
        counter.  Masks are not stored: the kernels recompute them from
        ``(seed, rows)``, which is why restore is bit-exact.  Returns the
        snapshot's path.
        """
        return _persist.snapshot_store(directory, self.store, step=step,
                                       queue=self.queue,
                                       extra=self._engine_meta(extra))

    def _engine_meta(self, extra: dict | None = None) -> dict:
        """The engine's snapshot meta, as the reference writes it;
        validated by :meth:`restore`.  ``backend`` (the port's name) and
        ``data_shards`` are recorded, not validated: a snapshot restores
        on any backend of either package."""
        engine_meta = {"tick": self.tick, "kind": self.kind,
                       "backend": self.backend, "cell": self.cell,
                       "precision": self.precision,
                       "data_shards": self._shards,
                       "mcd": {"p": float(self.cfg.mcd.p),
                               "placement":
                                   _mcd.placement_str(self.cfg.mcd.placement)}}
        if self._scheduler is not None:
            engine_meta["sched"] = self._scheduler.state()
        if extra is not None:
            engine_meta["extra"] = extra
        return engine_meta

    def restore(self, directory: str, *, step: int | None = None,
                sids: list[str] | None = None) -> dict:
        """Resume every snapshotted stream into this (fresh) engine.

        Replaces the store, wait-list and tick counter with the
        snapshot's, carries on this engine's device; serving then goes on
        bit-identically to the uninterrupted run (any backend, any
        ``chunk_capacity``; a prewarmed engine replays its graphs at
        once).  Returns the ``extra`` meta stashed by :meth:`snapshot`.
        """
        if self.store.sessions() or len(self.queue):
            raise RuntimeError("restore() needs a fresh engine: live or "
                               "queued sessions would collide")
        # Size the queue to hold the snapshot's whole wait-list.
        peek = _persist.load_snapshot_meta(directory, step)
        queue = AdmissionQueue(max(self.queue.max_pending,
                                   len(peek["queue"]) or 1))
        store, meta = _persist.restore_store(
            directory, step=peek["step"], sids=sids, queue=queue,
            max_sessions=self.max_sessions, device=self.device)
        engine_meta = self._check_restore_meta(meta)
        self._adopt(store, queue, engine_meta)
        return engine_meta.get("extra", {})

    def _check_restore_meta(self, meta: dict) -> dict:
        """Validate snapshot meta against this engine; return its engine
        meta (typed errors, the reference's messages)."""
        if meta["n_samples"] != self.n_samples:
            raise ValueError(
                f"snapshot's chain ceiling is {meta['n_samples']} MC "
                f"chains/session, engine ceiling is {self.n_samples}")
        if meta["seed"] != self.cfg.mcd.seed:
            raise ValueError(
                f"snapshot drawn under seed {meta['seed']!r}, engine uses "
                f"{self.cfg.mcd.seed!r} — resuming would change the masks")
        engine_meta = meta.get("extra") or {}
        if engine_meta.get("kind") not in (None, self.kind):
            raise ValueError(f"snapshot is a {engine_meta['kind']} stream, "
                             f"engine is a {self.kind}")
        snap_cell = engine_meta.get("cell", "lstm")
        if snap_cell != self.cell:
            raise ValueError(f"snapshot streamed through a {snap_cell} "
                             f"stack, engine runs {self.cell} — the carries "
                             "are not interchangeable")
        # Pre-quantization snapshots carry no key: native-dtype engines
        # wrote them, so they restore only into precision=None.
        snap_prec = engine_meta.get("precision")
        if snap_prec != self.precision:
            raise ValueError(
                f"snapshot streamed at precision {snap_prec!r}, engine "
                f"serves {self.precision!r} — the carries are not "
                "interchangeable")
        snap_mcd = engine_meta.get("mcd")
        here_mcd = {"p": float(self.cfg.mcd.p),
                    "placement": _mcd.placement_str(self.cfg.mcd.placement)}
        if snap_mcd is not None and snap_mcd != here_mcd:
            raise ValueError(
                f"snapshot streamed under mcd {snap_mcd}, engine uses "
                f"{here_mcd} — resuming would silently change the masks")
        return engine_meta

    def _adopt(self, store: SessionStore, queue: AdmissionQueue,
               engine_meta: dict) -> None:
        """Take over a restored store/queue and validated engine meta."""
        # A student session decodes through the student heads: an engine
        # without them would misserve it.
        if self.student is None:
            stu = ([s.sid for s in store.sessions() if s.mode == "student"]
                   + [t.sid for t in queue.waiting()
                      if t.mode == "student"])
            if stu:
                raise ValueError(
                    f"snapshot carries student-mode sessions {sorted(stu)}; "
                    "this engine was built without student= heads")
        store.n_samples = self.n_samples
        self.store = store
        self.queue = queue
        self.tick = int(engine_meta.get("tick", 0))
        if self._scheduler is not None and "sched" in engine_meta:
            self._scheduler.load_state(engine_meta["sched"])

    # -- serving -------------------------------------------------------------
    def step(self, chunks: Mapping[str, Any]) -> dict[str, ChunkResult]:
        """Serve one chunk per submitting session, in one batched pass.

        ``chunks`` maps session id → ``[t, input_dim]`` (or ``[t]`` when
        ``input_dim == 1``) signal slices, numpy arrays or tensors; ``t``
        may differ per session and must be >= 1.
        """
        self._drain()
        if not chunks:
            return {}
        queue_wait_s = self.queue.oldest_wait_s()
        launches_before = stack_launch_count()
        t_start = time.perf_counter()
        sessions, xs, lens = [], [], []
        for sid, chunk in chunks.items():
            sess = self.store.get(sid)
            x = (chunk.detach().cpu().numpy()
                 if isinstance(chunk, torch.Tensor) else np.asarray(chunk))
            if x.ndim == 1:
                x = x[:, None]
            if x.ndim != 2 or x.shape[0] < 1:
                raise ValueError(f"chunk for {sid!r} must be [t>=1, "
                                 f"input_dim], got shape {tuple(x.shape)}")
            sessions.append(sess)
            xs.append(x)
            lens.append(x.shape[0])
        s_list = [int(sess.rows.shape[0]) for sess in sessions]
        if self._shards > 1 and any(si != self.n_samples for si in s_list):
            raise ValueError(
                "sharded launches need every session at the engine ceiling "
                f"({self.n_samples} chains); got {s_list} — per-session S "
                "would straddle shard boundaries")

        if self._scheduler is not None:
            t_max = self._scheduler.plan(lens)
        elif self.chunk_capacity is not None:
            if max(lens) > self.chunk_capacity:
                raise ValueError(f"chunk of {max(lens)} steps exceeds "
                                 f"chunk_capacity={self.chunk_capacity}")
            t_max = self.chunk_capacity
        else:
            t_max = max(lens)
        dtype = xs[0].dtype
        slots = self._slot_count(len(sessions))
        live_chains = sum(s_list)
        nb = (slots * self.n_samples if self._fixed or self._shards > 1
              else live_chains)
        n_pad = nb - live_chains
        # Session-major, chain-minor batch assembled on the host; one
        # transfer per operand per tick.
        x_host = np.zeros((nb, t_max, xs[0].shape[1]), dtype)
        rows_host = np.zeros((nb,), np.int64)
        lens_host = np.ones((nb,), np.int32)
        offsets, off = [], 0
        for x, L, sess, si in zip(xs, lens, sessions, s_list):
            sl = slice(off, off + si)
            offsets.append(off)
            x_host[sl, :L] = x[None]
            rows_host[sl] = sess.rows
            lens_host[sl] = L
            off += si
        dev = self.device
        parts = {}
        t_part = _lap(parts, "assemble", t_start)
        compiles = 0
        if self._graphs is None:
            x_batch = torch.from_numpy(x_host).to(dev)
            rows = torch.from_numpy(rows_host).to(dev)
            lengths = torch.from_numpy(lens_host).to(dev)
            initial_state = self._gather_states(sessions, x_batch.dtype,
                                                n_pad)
            t_part = _lap(parts, "to_device", t_part)
            outs, states = self._apply(x_batch, rows, lengths,
                                       initial_state)
            t_part = _lap(parts, "apply", t_part)
        else:
            x_cpu = torch.from_numpy(x_host)
            entry = self._tick_step(t_max, x_cpu.dtype)
            entry.x.copy_(x_cpu)
            entry.rows.copy_(torch.from_numpy(rows_host))
            entry.lengths.copy_(torch.from_numpy(lens_host))
            self._gather_states(sessions, x_cpu.dtype, n_pad,
                                out=entry.state)
            t_part = _lap(parts, "to_device", t_part)
            if entry.step.ready:
                outs, states = entry.step.replay()
            else:
                outs, states = entry.step.first()
                compiles = 1
            # The next replay overwrites the step's outputs in place:
            # everything the summaries and the store keep is a copy.
            outs = tuple(None if o is None else o.clone() for o in outs)
            states = [tuple(part.clone() for part in layer)
                      for layer in states]
            t_part = _lap(parts, "apply", t_part)

        # Batched summaries over [s, sessions, ...], per-session results
        # indexed out.  A uniform all-MC tick is one reshape of the live
        # prefix; a ragged one (early exit, students) gathers each chain
        # count's sessions into a group of its own.  The chain-axis
        # reductions sum each session's chains in an order fixed by its
        # chain count (``core.uncertainty._chains_last``), so a session's
        # bits follow neither its group's width nor its neighbours.
        # Student sessions are never a column of an MC group: their one
        # row goes through the student heads below.
        k_n = len(sessions)
        summaries: list = [None] * k_n
        stu_ks = [k for k in range(k_n) if sessions[k].mode == "student"]
        mc_ks = [k for k in range(k_n) if sessions[k].mode != "student"]
        uniform = not stu_ks and len(set(s_list)) == 1
        for si in sorted({s_list[k] for k in mc_ks}):
            cols = [k for k in mc_ks if s_list[k] == si]
            if uniform:
                def sel(a, si=si):
                    return a[:k_n * si].reshape((k_n, si) + a.shape[1:])
            else:
                idx = torch.as_tensor(np.concatenate(
                    [np.arange(si) + offsets[k] for k in cols]), device=dev)

                def sel(a, idx=idx, n=len(cols), si=si):
                    return a[idx].reshape((n, si) + a.shape[1:])
            if self.kind == "classifier":
                (logits,) = outs
                batched = classification_summary(
                    sel(logits).transpose(0, 1).float())
                per = ClassificationSummary
            else:
                mean, log_var, _ = outs
                batched = regression_summary(
                    sel(mean).transpose(0, 1).float(),
                    None if log_var is None
                    else sel(log_var).transpose(0, 1).float())
                per = RegressionSummary
            for j, k in enumerate(cols):
                summaries[k] = per(*(v[j] for v in batched))
        t_part = _lap(parts, "summaries", t_part)
        # The distilled fast path: one batched head call over every student
        # row's feature (h_T; the decoder's hidden sequence).
        if stu_ks:
            idx = torch.as_tensor([offsets[k] for k in stu_ks], device=dev)
            if self.kind == "classifier":
                batched = _distill.classifier_student_summary(
                    self.student, states[-1][0][idx])
            else:
                batched = _distill.autoencoder_student_summary(
                    self.student, outs[2][idx], self.cfg.heteroscedastic)
            for j, k in enumerate(stu_ks):
                summaries[k] = type(batched)(*(v[j] for v in batched))
        if self.student is not None:
            t_part = _lap(parts, "student", t_part)

        # A windowed decoder reconstructs min(L, W) positions per chunk.
        win = getattr(self.cfg, "decode_window", None)
        results: dict[str, ChunkResult] = {}
        for k, (sess, L) in enumerate(zip(sessions, lens)):
            sl = slice(offsets[k], offsets[k] + s_list[k])
            summary = summaries[k]
            if self.kind == "autoencoder":
                valid = L if win is None else min(L, win)
                summary = RegressionSummary(*(v[:valid] for v in summary))
            sess.state = [tuple(part[sl] for part in layer)
                          for layer in states]
            sess.steps += L
            sess.chunks += 1
            results[sess.sid] = ChunkResult(sid=sess.sid, length=L,
                                            steps_total=sess.steps,
                                            summary=summary)
        t_part = _lap(parts, "store", t_part)
        self._last_served_chains = {sess.sid: si for sess, si
                                    in zip(sessions, s_list)}
        self._last_student_rows = {sessions[k].sid: 1 for k in stu_ks}
        reclaimed = self._early_exit(sessions, lens, s_list, offsets, outs,
                                     win)
        if self.early_exit_threshold is not None:
            t_part = _lap(parts, "early_exit", t_part)
        # After the writeback: grow() copies the carry the tick just stored.
        escalations = self._escalate(sessions, results)
        if self.student_escalate_threshold is not None:
            t_part = _lap(parts, "escalate", t_part)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _lap(parts, "sync", t_part)
        dur = time.perf_counter() - t_start
        live_chain_steps = int(sum(L * si for L, si in zip(lens, s_list)))
        m = TickMetrics(
            tick=self.tick, capacity=int(t_max), n_chunks=k_n,
            live_rows=live_chains, batch_rows=nb,
            queue_depth=len(self.queue), live_steps=int(sum(lens)),
            live_chain_steps=live_chain_steps,
            padded_steps=nb * int(t_max),
            pad_waste=1.0 - live_chain_steps / (nb * int(t_max)),
            duration_s=dur, shards=self._shards,
            tokens_per_sec=live_chain_steps / dur if dur > 0 else 0.0,
            queue_wait_s=queue_wait_s,
            launches=stack_launch_count() - launches_before,
            compiles=compiles,
            dropped=self._take_dropped(),
            active_chains=self.store.active_chains,
            reclaimed_rows=reclaimed, student_rows=len(stu_ks),
            escalations=escalations, parts_s=parts)
        self.metrics_sink.emit(m)
        self.tick += 1
        return results

    def _early_exit(self, sessions, lens, s_list, offsets, outs, win) -> int:
        """Retire surplus chains of prefix-converged sessions (one stage).

        For each served session above the floor, compare the summary over
        the prefix it would keep with the summary over all its chains, in
        the reference's float64 accumulators on the same values: the
        tick's live logits (or means and log-variances) come to the host
        once, then each session's slice is summarized as the reference
        summarizes it.  At or under the threshold the session is trimmed
        to the prefix.  Returns the rows retired this tick.
        """
        self.last_exit_deltas = {}
        self._last_reclaimed = {}
        if self.early_exit_threshold is None:
            return 0
        keeps = [max(self.min_samples, (si + 1) // 2) for si in s_list]
        if all(keep >= si for keep, si in zip(keeps, s_list)):
            return 0
        live = sum(s_list)
        if self.kind == "classifier":
            host = (outs[0][:live].float().cpu().numpy(),)
        else:
            mean, log_var = outs[0], outs[1]
            t_valid = max(lens) if win is None else min(max(lens), win)
            host = (mean[:live, :t_valid].float().cpu().numpy(),
                    None if log_var is None
                    else log_var[:live, :t_valid].float().cpu().numpy())
        reclaimed = 0
        for k, (sess, L) in enumerate(zip(sessions, lens)):
            si, keep = s_list[k], keeps[k]
            if keep >= si:
                continue
            off = offsets[k]
            if self.kind == "classifier":
                lg = host[0][off:off + si][:, None, :]          # [s, 1, C]
                prefix = RunningClassificationSummary().update(lg[:keep])
                full = prefix.copy().update(lg[keep:])
                delta = float(np.abs(
                    full.finalize_numpy().mutual_information
                    - prefix.finalize_numpy().mutual_information)[0])
            else:
                valid = L if win is None else min(L, win)
                mu = host[0][off:off + si, :valid]
                lv = (None if host[1] is None
                      else host[1][off:off + si, :valid])
                prefix = RunningRegressionSummary().update(
                    mu[:keep], None if lv is None else lv[:keep])
                full = prefix.copy().update(
                    mu[keep:], None if lv is None else lv[keep:])
                delta = float(np.mean(np.abs(
                    full.finalize_numpy().epistemic
                    - prefix.finalize_numpy().epistemic)))
            self.last_exit_deltas[sess.sid] = delta
            if delta <= self.early_exit_threshold:
                n_ret = self.store.retire(sess.sid, keep)
                if n_ret:
                    reclaimed += n_ret
                    self._last_reclaimed[sess.sid] = n_ret
        return reclaimed

    def _escalate(self, sessions, results) -> int:
        """Regrow the student sessions whose predicted uncertainty crossed
        the threshold (the MC fallback).

        Reads each student's served summary (the heads' predicted MI; the
        mean predicted epistemic variance for the autoencoder); above
        ``student_escalate_threshold`` (strict) ``SessionStore.grow(sid,
        n_samples)`` retires the deterministic row and ``n_samples`` fresh
        MC chains resume copies of its carry.  Returns the escalations.
        """
        self._last_escalated = {}
        if self.student_escalate_threshold is None:
            return 0
        stu = [sess for sess in sessions if sess.mode == "student"]
        if not stu:
            return 0
        # One transfer for every student, then the reference's host mean.
        field = ("mutual_information" if self.kind == "classifier"
                 else "epistemic")
        vals = [getattr(results[sess.sid].summary, field).float().reshape(-1)
                for sess in stu]
        host = np.split(torch.cat(vals).cpu().numpy(),
                        np.cumsum([v.numel() for v in vals])[:-1])
        n = 0
        for sess, u in zip(stu, host):
            if float(np.mean(u)) > self.student_escalate_threshold:
                self.store.grow(sess.sid, self.n_samples)
                self._last_escalated[sess.sid] = 1
                n += 1
        return n

    def _take_dropped(self) -> int:
        n, self._dropped_unreported = self._dropped_unreported, 0
        return n

    def _slot_count(self, n_sessions: int) -> int:
        """Session slots a tick launches with, the batch-layout contract
        :meth:`step` and :func:`repro_torch.serve.scheduler.prewarm`
        share: fixed-shape modes pad idle slots to ``max_sessions`` so one
        graph a capacity serves every tick; dynamic mode launches the
        sessions it has.  On a mesh the slots round up to a whole number
        a shard, so a session's S chains never cross a shard and every
        shard launches the same shape."""
        slots = self.max_sessions if self._fixed else n_sessions
        return -(-slots // self._shards) * self._shards

    def _tick_step(self, capacity: int, dtype) -> _TickStep:
        """The tick step of ``(capacity, chunk dtype)``, made on first use
        with its static buffers in the prewarm layout (zeros; lengths 1);
        the caller runs its ``first()`` (a capture on the card)."""
        key = (int(capacity), dtype)
        entry = self._graphs.get(key)
        if entry is not None:
            return entry
        dev = self.device
        if dev.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        nb = self._slot_count(0) * self.n_samples
        x = torch.zeros((nb, int(capacity), self.cfg.input_dim),
                        dtype=dtype, device=dev)
        rows = torch.zeros((nb,), dtype=torch.int64, device=dev)
        lengths = torch.ones((nb,), dtype=torch.int32, device=dev)
        state = self._gather_states([], dtype, n_pad=nb)
        step = StaticStep(lambda: self._apply(x, rows, lengths, state), dev,
                          counted=_STACK_KERNELS, pool=self._pool)
        entry = self._graphs[key] = _TickStep(x, rows, lengths, state, step)
        return entry

    def _apply(self, x_batch, rows, lengths, initial_state):
        """One batched model pass — the tick hot path.

        Returns ``(model outputs tuple, per-layer encoder states)``: the
        outputs are ``(logits,)`` for the classifier and ``(mean, log_var,
        dec_out)`` for the autoencoder.
        """
        kw = dict(backend=self.backend, initial_state=initial_state,
                  lengths=lengths, return_state=True,
                  precision=self.precision, device=self.device,
                  mesh=self.mesh, policy=self.policy)
        if self.kind == "classifier":
            logits, states = _clf.apply(self.params, x_batch, rows, self.cfg,
                                        **kw)
            return (logits,), states
        mean, log_var, dec_out, states = _ae.apply(
            self.params, x_batch, rows, self.cfg, return_decoded=True, **kw)
        return (mean, log_var, dec_out), states

    def _gather_states(self, sessions, dtype, n_pad: int = 0, out=None):
        """Concatenate per-session carries into batch-aligned layer states
        (into the tensors of ``out``, the same layout, when given).

        Fresh sessions and pad slots contribute zeros in the backend's own
        carry dtypes (h in the activation dtype; LSTM c in fp32 on the
        kernel backends, the activation dtype on the reference; under a
        serving precision h in its activation dtype and c in fp32 on every
        backend), sized per encoder layer; the parts follow the cell:
        ``(h, c)`` for the LSTM, ``(h,)`` for the GRU.
        """
        if all(sess.fresh for sess in sessions) and not self._fixed:
            return None
        if self.precision is not None:
            dtype = _quant.activation_dtype(self.precision, dtype)
            c_dtype = torch.float32
        else:
            c_dtype = dtype if self.backend == "reference" else torch.float32
        part_dtypes = (dtype,) if self.cell == "gru" else (dtype, c_dtype)
        dev = self.device
        layers = []
        for li, hid in enumerate(self._encoder_hiddens()):
            parts = [[] for _ in part_dtypes]
            for sess in sessions:
                if sess.fresh:
                    for acc, dt in zip(parts, part_dtypes):
                        acc.append(torch.zeros(
                            (int(sess.rows.shape[0]), hid), dtype=dt,
                            device=dev))
                else:
                    for acc, part in zip(parts, sess.state[li]):
                        acc.append(part)
            if n_pad:
                for acc, dt in zip(parts, part_dtypes):
                    acc.append(torch.zeros((n_pad, hid), dtype=dt,
                                           device=dev))
            if out is None:
                layers.append(tuple(torch.cat(acc) for acc in parts))
            else:
                for acc, dst in zip(parts, out[li], strict=True):
                    torch.cat(acc, out=dst)
        return out if out is not None else layers

    def _encoder_hiddens(self):
        if self.kind == "classifier":
            return (self.cfg.hidden,) * self.cfg.num_layers
        return self.cfg.encoder_hiddens
