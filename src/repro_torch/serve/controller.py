"""Online co-design: close the paper's DSE→serving loop under an SLO —
port of ``repro.serve.controller``.

The paper's central contribution (§IV, Fig. 7) is a framework that searches
algorithmic–hardware configurations for the best accuracy / latency /
uncertainty trade-off, offline, against a benchmarked lookup table.
:class:`CoDesignController` runs the same framework *online*, against the
:class:`~repro_torch.serve.scheduler.TickMetrics` an engine emits:

1. **observe** — roll up the sink's recent window (p95 tick latency,
   tokens/s, queue depth, queue wait, graph captures);
2. **calibrate** — fit the :mod:`repro_torch.dse.gpu_model` roofline to the
   observed durations (:mod:`repro_torch.dse.calibrate`), so predicted
   candidate latency is in the wall-clock world the SLO is written in;
3. **search** — build a candidate table over the live knobs (S MC chains,
   serving precision, chunk-capacity ladder, shard width) and drive
   :func:`repro_torch.dse.search.optimize` with the calibrated
   ``latency_model=`` and the SLO as ``requirements=``;
4. **apply** — swap the winning config in at a tick boundary: a fresh
   engine is built on the old one's device and graph setting, every live
   session's carry is converted (:func:`convert_session`, into the dtypes
   of :func:`carry_dtypes`) and re-attached on the same ``(seed, rows)``
   mask coordinates, so the Bayesian draw goes on, queued tickets follow
   in order, and the new engine is prewarmed (``scheduler.prewarm``: every
   rung's tick graph captured) before it takes traffic — post-swap ticks
   capture nothing.  A swap that fails to build or prewarm raises; the
   old engine is not served on quietly.

Every evaluation that proposes (or refuses) a change is recorded as a
:class:`DecisionRecord` to its own sink (``RingBufferSink`` in memory,
``JsonlSink`` for a durable trail).  Hysteresis and a post-swap cooldown
keep a burst from thrashing reconfigurations.  :class:`FleetController`
runs one such loop per tenant of a ``FleetEngine``.

The safety contract: a session's outputs across a reconfiguration are
bit-identical to an uninterrupted engine at the new config resuming from
the converted carry.

``shards`` is the data-parallel width: a swap to another count builds its
engine on a data mesh of that many entries over the old engine's devices
(:func:`reshard_mesh`), or on none at 1.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import mcd as _mcd
from repro_torch.dse import calibrate as _calib
from repro_torch.dse import search as _search
from repro_torch.dse.fpga_model import RNNArch
from repro_torch.kernels import quantize as _quant
from repro_torch.serve import scheduler as _sched
from repro_torch.serve.scheduler import TickMetrics, percentile, pow2_ladder
from repro_torch.serve.sessions import Session
from repro_torch.serve.stream import RingBufferSink, StreamingEngine

#: Serving-quality rank of each precision (higher = richer numerics): a
#: config's quality is S first (the uncertainty estimate degrades directly
#: with fewer MC chains), precision second.  ``None`` (native dtypes) and
#: ``"fp32"`` tie.
PRECISION_RANK = {None: 3, "fp32": 3, "bf16": 2, "int8": 1, "int4": 0}

#: Roofline weight width per serving precision (``None`` = native fp32).
_WEIGHT_BITS = {**_quant.WEIGHT_BITS, None: 32}

#: Hysteresis: upshift only when the observed p95 is under this share of
#: the SLO *and* the candidate's predicted latency stays under it too.
UPSHIFT_MARGIN = 0.5

#: Downshift target: a breach picks candidates predicted under this share
#: of the SLO, not exactly at the line.
HEADROOM = 0.9


def reshard_mesh(engine: StreamingEngine, shards: int):
    """The mesh of an engine that replaces ``engine`` at ``shards`` data
    shards: ``engine``'s own when the count is unchanged, none at 1, else
    ``launch.mesh.data_mesh_like`` over ``engine``'s devices (its one
    device repeated; else that many cards from its first, or an error:
    a mesh never shrinks to what there is)."""
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards == engine._shards:
        return engine.mesh
    if shards == 1:
        return None
    # Deferred: serving imports without the launch layer.
    from repro_torch.launch.mesh import data_mesh_like
    return data_mesh_like(shards, mesh=engine.mesh, device=engine.device)


def _prewarm_fixed(engine: StreamingEngine) -> None:
    """Capture every rung of a swap's replacement before it takes traffic,
    so no post-swap tick captures; a dynamic-shape engine serves eagerly
    and has nothing to warm."""
    if engine._scheduler is not None or isinstance(engine.chunk_capacity,
                                                   int):
        _sched.prewarm(engine)


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """The service-level objective the controller defends.

    ``p95_tick_s`` is the headline bound: the 95th-percentile engine tick
    wall-clock over the observation window.  ``min_tokens_per_sec`` bounds
    delivered throughput (p50), ``max_queue_depth`` the admissions left
    waiting after a drain, and ``min_samples`` is the **uncertainty
    floor** — the controller never trades S below it, however hard the
    latency requirement binds.
    """

    p95_tick_s: float
    min_tokens_per_sec: float = 0.0
    max_queue_depth: int | None = None
    min_samples: int = 1

    def __post_init__(self):
        if self.p95_tick_s <= 0:
            raise ValueError(f"p95_tick_s must be > 0, got {self.p95_tick_s}")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The live-reconfigurable knobs — the online slice of the DSE space.

    ``chunk_capacity`` is the launch-shape budget (the top ladder rung; 0 =
    keep the engine's own).  ``shards`` is the data-parallel width (the
    engine's mesh's data entries; 1 = no mesh).  H, NL, placement and cell
    change the
    parameters themselves: a deploy, not a reconfiguration.
    """

    n_samples: int
    precision: str | None = None
    chunk_capacity: int = 0
    shards: int = 1

    @property
    def quality(self) -> int:
        """Scalar serving quality: S dominates, precision breaks ties."""
        return self.n_samples * 8 + PRECISION_RANK[self.precision]


@dataclasses.dataclass(frozen=True)
class KnobSpace:
    """Candidate values per knob — the controller's search grid."""

    samples: tuple[int, ...]
    precisions: tuple[str | None, ...] = (None,)
    capacities: tuple[int, ...] = (0,)
    shards: tuple[int, ...] = (1,)

    @classmethod
    def around(cls, config: ServingConfig, *,
               precisions: Sequence[str | None] | None = None) -> KnobSpace:
        """The default grid: pow2 S downshifts from the current config.

        S candidates are ``S, S/2, …, 1``; precision / capacity / shards
        stay at the current value unless ``precisions`` widens that axis.
        """
        s, ladder = config.n_samples, []
        while s >= 1:
            ladder.append(s)
            s //= 2
        return cls(samples=tuple(ladder),
                   precisions=(tuple(precisions) if precisions
                               else (config.precision,)),
                   capacities=(config.chunk_capacity,),
                   shards=(config.shards,))

    def configs(self) -> list[ServingConfig]:
        """Every grid point, best quality first (ties: larger capacity).

        The order is the tiebreak: ``search.optimize``'s sort is stable, so
        equal-score survivors keep table order.
        """
        out = []
        for s in sorted(set(self.samples), reverse=True):
            for prec in sorted(set(self.precisions),
                               key=lambda p: -PRECISION_RANK[p]):
                for cap in sorted(set(self.capacities), reverse=True):
                    for sh in self.shards:
                        out.append(ServingConfig(
                            n_samples=int(s), precision=prec,
                            chunk_capacity=int(cap), shards=int(sh)))
        return out


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One controller evaluation — the observable decision trail.

    JSON-able end to end (``dataclasses.asdict`` → one JSONL line via a
    ``JsonlSink``): what was observed, what the calibration believed, every
    candidate's predicted latency, the winner, and why.  ``applied`` is
    False for records that explain a *refusal* (compile stall, already
    optimal).
    """

    tick: int
    reason: str            # slo-breach | headroom-upshift | compile-stall |
                           # no-feasible-fallback | already-optimal
    applied: bool
    current: dict          # ServingConfig, asdict
    winner: dict | None    # ServingConfig, asdict
    predicted_s: float | None   # winner's calibrated per-tick latency
    observed: dict         # the window roll-up the decision was made on
    slo: dict
    fit: dict | None       # RooflineFit, asdict
    candidates: list = dataclasses.field(default_factory=list)
    tenant: str | None = None   # owning tenant when a FleetController made
                                # the call (None: single-engine controller)


class SimulatedLoadSink(RingBufferSink):
    """A metrics sink that *rewrites* tick durations from a cost model.

    Keeps every structural observable the engine measured (rows, capacity,
    queue depth, captures) and replaces ``duration_s`` / ``tokens_per_sec``
    with

        load(tick) · (overhead_s + per_chain_step_s · batch_rows · capacity)

    so latency responds to the knobs as a busy accelerator would, and an
    injected ``load`` burst is reproducible to the tick: the deterministic
    surface for tests and demos of the control logic.
    """

    def __init__(self, *, per_chain_step_s: float = 1e-5,
                 overhead_s: float = 5e-4,
                 load: Callable[[int], float] | None = None,
                 window: int = 4096):
        super().__init__(window)
        self.per_chain_step_s = float(per_chain_step_s)
        self.overhead_s = float(overhead_s)
        self.load = load or (lambda tick: 1.0)

    def emit(self, m) -> None:
        if isinstance(m, TickMetrics):
            dur = self.load(m.tick) * (
                self.overhead_s
                + self.per_chain_step_s * m.batch_rows * m.capacity)
            m = dataclasses.replace(
                m, duration_s=dur,
                tokens_per_sec=m.live_chain_steps / dur if dur > 0 else 0.0)
        super().emit(m)


def carry_dtypes(cell: str, precision: str | None, backend: str,
                 chunk_dtype=torch.float32) -> tuple:
    """Per-part carry dtypes an engine stores its sessions in.

    As ``StreamingEngine._gather_states``: h in the serving precision's
    activation dtype, the LSTM's c in fp32 (in the activation dtype on the
    ``reference`` backend at native precision).  A carry converted to
    them is what the new engine's graphs take; the conversion is the
    numeric boundary of a precision swap (an fp32 → bf16 downshift rounds
    the carry once).
    """
    h_dt = _quant.activation_dtype(precision, chunk_dtype)
    if precision is not None:
        c_dt = torch.float32
    else:
        c_dt = chunk_dtype if backend == "reference" else torch.float32
    return (h_dt,) if cell == "gru" else (h_dt, c_dt)


def convert_session(sess: Session, *, n_samples: int, part_dtypes: tuple,
                    extra_rows: np.ndarray | None = None) -> Session:
    """Re-shape one session's carry for a new (S, precision) config.

    Chains are independent trajectories, so a downshift keeps the first
    ``n_samples`` chains bit-exactly; an upshift appends fresh chains (zero
    carry, the newly allocated ``extra_rows``) that join the draw at the
    swap.  The carry stays on its device: a slice, a cast to
    ``part_dtypes`` and, on an upshift, zero rows made there.  Rows stay
    host ``np.uint32``; cursors and sid are kept; the session comes back
    in the default mode, as the reference's does.
    """
    rows = np.asarray(sess.rows, np.uint32)
    s_old = int(rows.shape[0])
    if n_samples <= s_old:
        new_rows = rows[:n_samples].copy()
    else:
        if extra_rows is None or len(extra_rows) != n_samples - s_old:
            raise ValueError(
                f"upshift {s_old}→{n_samples} needs {n_samples - s_old} "
                "freshly-allocated extra_rows")
        new_rows = np.concatenate([rows, np.asarray(extra_rows, np.uint32)])
    state = None
    if sess.state is not None:
        state = []
        for layer in sess.state:
            parts = []
            for part, dt in zip(layer, part_dtypes):
                p = part[:min(s_old, n_samples)].to(dt)
                if n_samples > s_old:
                    p = torch.cat([p, torch.zeros(
                        (n_samples - s_old, p.shape[-1]), dtype=dt,
                        device=p.device)])
                parts.append(p)
            state.append(tuple(parts))
    return Session(sid=sess.sid, rows=new_rows, seed=sess.seed, state=state,
                   steps=sess.steps, chunks=sess.chunks)


class CoDesignController:
    """Drive the paper's co-design search online, against live metrics.

    Two modes share the decision logic:

    * **attached** (``engine=`` given): the controller owns the serving
      engine — call :meth:`maybe_reconfigure` after each tick; on a
      decision it swaps ``controller.engine`` for a prewarmed replacement
      with every session transferred.  Always read the engine through the
      controller after that.
    * **detached** (``engine=None``, ``config=`` / ``arch=`` given): pure
      decision logic over a caller-supplied metrics window — :meth:`plan`
      returns the :class:`DecisionRecord` it *would* apply;
      :meth:`mark_applied` simulates the apply (config + cooldown
      bookkeeping).

    Args:
      engine: the :class:`StreamingEngine` to control, or None (detached).
      slo: the :class:`SLOPolicy` to defend.
      knobs: the candidate grid; default ``KnobSpace.around(current)``
        (S downshifts only).
      decision_sink: where :class:`DecisionRecord`\\ s go (``MetricsSink``
        duck-typed; default in-memory ring).
      window: ticks of history a decision looks at (and how many
        comfortable ticks an upshift requires).
      min_ticks: observations below which the controller stays silent —
        both for SLO stats and the calibration fit.
      cooldown_ticks: after any emitted decision, no further evaluation
        for this many ticks.
      config, arch, slots: detached-mode substitutes for what an engine
        would provide (current config, its :class:`RNNArch`, and the
        session slots a fixed-shape tick pads to).
    """

    def __init__(self, engine: StreamingEngine | None, slo: SLOPolicy, *,
                 knobs: KnobSpace | None = None, decision_sink=None,
                 window: int = 16, min_ticks: int = 4,
                 cooldown_ticks: int = 8,
                 config: ServingConfig | None = None,
                 arch: RNNArch | None = None, slots: int | None = None):
        self.engine = engine
        self.slo = slo
        self.window = int(window)
        self.min_ticks = int(min_ticks)
        self.cooldown_ticks = int(cooldown_ticks)
        self.decision_sink = decision_sink or RingBufferSink()
        if engine is not None:
            self.config = self._derive_config(engine)
            self.arch = self._derive_arch(engine, self.config)
            self._slots = engine.max_sessions if engine._fixed else None
        else:
            if config is None or arch is None:
                raise ValueError("detached mode (engine=None) needs "
                                 "config= and arch=")
            self.config = config
            self.arch = dataclasses.replace(
                arch, weight_bits=_WEIGHT_BITS[config.precision])
            self._slots = slots
        self.knobs = knobs or KnobSpace.around(self.config)
        if min(self.knobs.samples) < 1:
            raise ValueError(f"knob S candidates must be >= 1, "
                             f"got {self.knobs.samples}")
        self._window_start_tick = 0
        self._cooldown_until = 0
        self.last_swap: dict | None = None

    # -- observation ---------------------------------------------------------
    @property
    def decisions(self) -> list:
        """The decision sink's retained window (oldest first)."""
        return list(self.decision_sink.window())

    def window_metrics(self, metrics: Sequence[TickMetrics] | None = None
                       ) -> list[TickMetrics]:
        """The ticks a decision may look at: post-last-swap, bounded.

        The window resets at every applied swap — a calibration fit (and an
        SLO judgment) must not straddle a config change.
        """
        if metrics is None:
            if self.engine is None:
                raise ValueError("detached controller: pass metrics=")
            metrics = self.engine.metrics
        return [m for m in metrics
                if m.tick >= self._window_start_tick][-self.window:]

    # -- decision ------------------------------------------------------------
    def plan(self, metrics: Sequence[TickMetrics] | None = None
             ) -> DecisionRecord | None:
        """Evaluate the window; return the decision, or None for a no-op.

        Pure with respect to the engine: nothing is applied and nothing is
        emitted — :meth:`maybe_reconfigure` owns the side effects.  Returns
        None when the SLO is met with no upshift headroom, inside a
        cooldown, or with too little history to judge.
        """
        win = self.window_metrics(metrics)
        if len(win) < self.min_ticks:
            return None
        tick = win[-1].tick
        if tick < self._cooldown_until:
            return None
        stats = _sched.summarize(win)
        observed = {
            "duration_s_p95": stats["duration_s_p95"],
            "duration_s_p50": stats["duration_s_p50"],
            "tokens_per_sec_p50": stats["tokens_per_sec_p50"],
            "mean_queue_depth": stats["mean_queue_depth"],
            "queue_wait_s_p95": stats["queue_wait_s_p95"],
            "compiles": stats["compiles"],
            "ticks": stats["ticks"],
        }
        lat_breach = stats["duration_s_p95"] > self.slo.p95_tick_s
        tps_breach = (self.slo.min_tokens_per_sec > 0 and
                      stats["tokens_per_sec_p50"]
                      < self.slo.min_tokens_per_sec)
        q_breach = (self.slo.max_queue_depth is not None and
                    stats["mean_queue_depth"] > self.slo.max_queue_depth)
        if lat_breach and not (tps_breach or q_breach):
            # A slow window whose slowness vanishes once the capture ticks
            # are left out is a capture stall, not overload: reconfiguring
            # would cause more captures.  Hold — also when captures are
            # present but too few clean ticks remain to judge.
            clean = [m.duration_s for m in win if m.compiles == 0]
            if any(m.compiles for m in win) and (
                    len(clean) < self.min_ticks
                    or percentile(clean, 95) <= self.slo.p95_tick_s):
                return self._record(tick, "compile-stall", observed,
                                    fit=None, winner=None, candidates=[])
        breach = lat_breach or tps_breach or q_breach
        if not breach:
            best = max(c.quality for c in self.knobs.configs())
            if (self.config.quality >= best
                    or len(win) < self.window
                    or stats["duration_s_p95"]
                    > UPSHIFT_MARGIN * self.slo.p95_tick_s):
                return None
            target_lat = UPSHIFT_MARGIN * self.slo.p95_tick_s
            reason = "headroom-upshift"
        else:
            target_lat = HEADROOM * self.slo.p95_tick_s
            reason = "slo-breach"
        fit = _calib.fit_roofline(win, self.arch, min_ticks=self.min_ticks)
        if fit is None:
            return None
        winner_cfg, predicted, cands = self._search(win, fit, target_lat)
        if winner_cfg is None and breach:
            winner_cfg, predicted, cands = self._search(
                win, fit, target_lat, fallback=True)
            reason = "no-feasible-fallback"
        if winner_cfg is None or winner_cfg == self.config:
            if reason == "headroom-upshift":
                return None          # nothing better that is safely faster
            return self._record(tick, "already-optimal", observed, fit=fit,
                                winner=None, candidates=cands)
        return self._record(tick, reason, observed, fit=fit,
                            winner=winner_cfg, candidates=cands,
                            predicted_s=predicted, applied=True)

    def maybe_reconfigure(self) -> DecisionRecord | None:
        """Plan against the engine's window; apply and record the outcome.

        The attached-mode entry point — call once per tick, *after*
        ``engine.step``.  Emits every non-None decision to the decision
        sink and starts the cooldown; on an applied decision the engine is
        swapped (sessions transferred, replacement prewarmed) before the
        record is emitted.
        """
        if self.engine is None:
            raise ValueError("detached controller: use plan()/mark_applied()")
        rec = self.plan()
        if rec is None:
            return None
        if rec.applied:
            self.apply_config(ServingConfig(**rec.winner))
        self._cooldown_until = rec.tick + self.cooldown_ticks
        self.decision_sink.emit(rec)
        return rec

    def mark_applied(self, rec: DecisionRecord) -> None:
        """Detached-mode apply: adopt the winner + cooldown bookkeeping."""
        if rec.winner is not None:
            self.config = ServingConfig(**rec.winner)
            self.arch = dataclasses.replace(
                self.arch, weight_bits=_WEIGHT_BITS[self.config.precision])
        self._window_start_tick = rec.tick + 1
        self._cooldown_until = rec.tick + self.cooldown_ticks

    # -- the DSE call --------------------------------------------------------
    def _search(self, win, fit, target_lat, *, fallback=False):
        """One ``dse.search.optimize`` run over the knob grid.

        Normal mode maximizes config quality under the SLO requirements
        (latency ≤ target, S ≥ floor, tokens/s ≥ floor).  ``fallback`` (no
        candidate met them) keeps only the uncertainty floor and minimizes
        latency.  Candidates are priced on *expected* active chains: the
        config's S scaled by the window's observed survival ratio under
        early exit (1.0 for uniform traffic).
        """
        demand = max(1, int(percentile([m.n_chunks for m in win], 95)))
        obs_cap = max((m.capacity for m in win), default=1)
        ratios = [m.live_rows / (m.n_chunks * self.config.n_samples)
                  for m in win if m.n_chunks > 0]
        eff = min(1.0, sum(ratios) / len(ratios)) if ratios else 1.0
        lat_model = _calib.latency_model(fit, slots=self._slots,
                                         shards=self.config.shards)
        table, cfgs = [], []
        for i, cfg in enumerate(self.knobs.configs()):
            cap = cfg.chunk_capacity or obs_cap
            arch = dataclasses.replace(
                self.arch, weight_bits=_WEIGHT_BITS[cfg.precision],
                timesteps=cap)
            pred = lat_model(arch, None, batch=demand,
                             n_samples=cfg.n_samples * eff)
            slots = max(demand, self._slots or 0)
            tps = (slots * cfg.n_samples * eff * cap / pred) \
                if pred > 0 else 0.0
            table.append(_search.Candidate(
                arch=arch, n_samples=cfg.n_samples,
                metrics={"quality": float(cfg.quality),
                         "samples": float(cfg.n_samples),
                         "tokens_per_sec": tps,
                         "cand_index": float(i)}))
            cfgs.append((cfg, pred, tps))
        if fallback:
            mode, requirements = "latency", {
                "samples": float(self.slo.min_samples)}
        else:
            mode, requirements = "quality", {
                "latency": target_lat,
                "samples": float(self.slo.min_samples),
                "tokens_per_sec": self.slo.min_tokens_per_sec,
            }
        winner = _search.optimize(table, mode, requirements=requirements,
                                  latency_model=lat_model, hw_model=None,
                                  batch=demand)
        cands = [dict(dataclasses.asdict(cfg), predicted_s=pred,
                      tokens_per_sec=tps,
                      feasible=(pred <= target_lat
                                and cfg.n_samples >= self.slo.min_samples
                                and tps >= self.slo.min_tokens_per_sec))
                 for cfg, pred, tps in cfgs]
        if winner is None:
            return None, None, cands
        w_cfg, w_pred, _ = cfgs[int(winner.metrics["cand_index"])]
        return w_cfg, w_pred, cands

    def _record(self, tick, reason, observed, *, fit, winner, candidates,
                predicted_s=None, applied=False) -> DecisionRecord:
        return DecisionRecord(
            tick=int(tick), reason=reason, applied=applied,
            current=dataclasses.asdict(self.config),
            winner=None if winner is None else dataclasses.asdict(winner),
            predicted_s=predicted_s, observed=observed,
            slo=dataclasses.asdict(self.slo),
            fit=None if fit is None else dataclasses.asdict(fit),
            candidates=candidates)

    # -- apply: the prewarmed graph swap -------------------------------------
    def apply_config(self, new: ServingConfig) -> StreamingEngine:
        """Swap the engine to ``new`` at a tick boundary, sessions intact.

        A fresh engine is built at the new config on the old engine's
        ``device`` and ``graphs`` setting; every live session's carry is
        converted (:func:`convert_session`) and re-attached with its
        original mask coordinates; queued tickets are re-queued in order;
        the tick counter and metrics sink carry over (one continuous
        trail); the scheduler's window carries over when the ladder is
        unchanged; the row cursor advances past every row either engine
        drew; and the replacement is prewarmed before it takes traffic.
        As ``FleetEngine.reconfigure_tenant``'s, the new engine takes no
        ``student=`` heads: a student session comes back an MC session on
        its one flagged row.  ``last_swap`` keeps the pre-swap sessions
        (the anchor a bit-identity check replays from) and the host
        seconds of the swap's parts.  A change of ``shards`` makes or drops
        the mesh (:func:`reshard_mesh`: over the old engine's mesh or
        device); a meshed engine's early exit is dropped, as sharded
        launches need every session at one S.
        """
        old = self.engine
        _quant.check_precision(new.precision)
        mesh = reshard_mesh(old, new.shards)
        t0 = time.perf_counter()
        model_cfg = dataclasses.replace(
            old.cfg, mcd=old.cfg.mcd.replace(n_samples=new.n_samples))
        if old._scheduler is not None:
            cap_arg = "auto"
            ladder = (pow2_ladder(new.chunk_capacity) if new.chunk_capacity
                      else old._scheduler.ladder)
        elif isinstance(old.chunk_capacity, int):
            cap_arg, ladder = (new.chunk_capacity or old.chunk_capacity), None
        else:
            cap_arg, ladder = None, None
        # Early exit survives the swap; the SLO's uncertainty floor is
        # enforced in the data plane too (capped by the new ceiling).
        floor = min(new.n_samples, max(old.min_samples,
                                       self.slo.min_samples))
        eng = StreamingEngine(
            old.params, model_cfg, backend=old.backend,
            max_sessions=old.max_sessions, chunk_capacity=cap_arg,
            ladder=ladder, max_pending=old.queue.max_pending,
            metrics_sink=old.metrics_sink, device=old.device, mesh=mesh,
            policy=old.policy if mesh is not None else None,
            graphs=old.graphs, precision=new.precision,
            early_exit_threshold=(None if mesh is not None
                                  else old.early_exit_threshold),
            min_samples=floor)
        if (old._scheduler is not None and eng._scheduler is not None
                and eng._scheduler.ladder == old._scheduler.ladder):
            # Same ladder: carry the chunk-length window, so the new engine
            # starts on the rung the traffic had settled on.
            eng._scheduler.load_state(old._scheduler.state())
        t1 = time.perf_counter()
        part_dtypes = carry_dtypes(eng.cell, new.precision, eng.backend)

        # A session at the old ceiling follows the new one; one early exit
        # already shrank keeps its smaller S (capped by the new ceiling).
        def _target(s_i: int) -> int:
            return (new.n_samples if s_i == old.n_samples
                    else min(s_i, new.n_samples))

        # Fresh chains on an upshift draw rows the old engine never used.
        cursor = old.store.next_row

        def _convert(sess: Session) -> Session:
            nonlocal cursor
            s_i = int(sess.rows.shape[0])
            target = _target(s_i)
            extra = None
            if target > s_i:
                extra = np.arange(cursor, cursor + target - s_i,
                                  dtype=np.uint32)
                cursor += target - s_i
            return convert_session(sess, n_samples=target,
                                   part_dtypes=part_dtypes,
                                   extra_rows=extra)

        for sess in [_convert(s) for s in old.store.sessions()]:
            eng.attach_session(sess)
        for t in old.queue.waiting():
            eng.queue.submit(t.sid, priority=t.priority,
                             session=(None if t.session is None
                                      else _convert(t.session)),
                             n_samples=(None if t.n_samples is None
                                        else min(t.n_samples,
                                                 new.n_samples)))
        # Never re-draw a row either engine ever allocated.
        eng.store._next_row = max(eng.store.next_row, cursor)
        eng.tick = old.tick
        t2 = time.perf_counter()
        _prewarm_fixed(eng)
        t3 = time.perf_counter()
        self.last_swap = {
            "tick": old.tick,
            "old_config": self.config,
            "new_config": new,
            # Shallow copies pin the pre-swap carries (the engine replaces
            # a session's state, never writes it in place).
            "old_sessions": [copy.copy(s) for s in old.store.sessions()],
            "seconds": {"build": t1 - t0, "convert": t2 - t1,
                        "prewarm": t3 - t2},
        }
        self.engine = eng
        self.config = new
        self.arch = dataclasses.replace(
            self.arch, weight_bits=_WEIGHT_BITS[new.precision])
        self._slots = eng.max_sessions if eng._fixed else None
        self._window_start_tick = eng.tick
        return eng

    # -- derivation helpers --------------------------------------------------
    @staticmethod
    def _derive_config(engine: StreamingEngine) -> ServingConfig:
        if engine._scheduler is not None:
            cap = engine._scheduler.max_capacity
        elif isinstance(engine.chunk_capacity, int):
            cap = engine.chunk_capacity
        else:
            cap = 0
        return ServingConfig(n_samples=engine.n_samples,
                             precision=engine.precision,
                             chunk_capacity=cap, shards=engine._shards)

    @staticmethod
    def _derive_arch(engine: StreamingEngine,
                     config: ServingConfig) -> RNNArch:
        cfg = engine.cfg
        if engine.kind == "classifier":
            out_dim = cfg.num_classes
        else:
            out_dim = cfg.input_dim
        return RNNArch(hidden=cfg.hidden, num_layers=cfg.num_layers,
                       placement=_mcd.placement_str(cfg.mcd.placement),
                       kind=engine.kind, cell=engine.cell,
                       weight_bits=_WEIGHT_BITS[config.precision],
                       input_dim=cfg.input_dim, output_dim=out_dim,
                       timesteps=config.chunk_capacity or 1)


class FleetController:
    """Per-tenant co-design over a fleet: one SLO loop per tenant.

    Wraps one *detached* :class:`CoDesignController` per tenant with an
    SLO (``TenantSpec.slo``).  Each tenant's
    controller sees only that tenant's tagged slice of the fleet metrics
    trail, derives its config and arch from the tenant's own launch group,
    and scopes its knob grid to that tenant's live knobs — a breach on one
    tenant downshifts *its* S, never another's.

    Applied decisions go through :meth:`FleetEngine.reconfigure_tenant`
    (the tenant's sessions move to a group of their own, carries converted
    bit-safely), whose new engine is prewarmed before the tenant's next
    tick, as :meth:`CoDesignController.apply_config`'s is; every decision
    — applied or refused — is emitted to the shared decision sink tagged
    with ``DecisionRecord.tenant``.  A knob grid may hold ``shards``
    other than the tenant's: an applied change builds the tenant's new
    engine on a data mesh of that many entries (:func:`reshard_mesh`).
    """

    def __init__(self, fleet, *, knobs=None, decision_sink=None,
                 **ctrl_kwargs):
        """``fleet``: a :class:`~repro_torch.serve.fleet.FleetEngine`;
        tenants whose spec has no ``slo`` are left unmanaged.

        ``knobs``: {tenant: KnobSpace} per-tenant grid override.
        ``ctrl_kwargs`` forward to every per-tenant controller (window,
        min_ticks, cooldown_ticks, ...).
        """
        self.fleet = fleet
        self.decision_sink = decision_sink or RingBufferSink()
        slos = {name: spec.slo for name, spec in fleet.specs.items()
                if spec.slo is not None}
        self.controllers: dict[str, CoDesignController] = {}
        for name, slo in slos.items():
            engine = fleet.group_of(name).engine
            config = CoDesignController._derive_config(engine)
            ctrl = CoDesignController(
                None, slo, config=config,
                arch=CoDesignController._derive_arch(engine, config),
                slots=engine.max_sessions if engine._fixed else None,
                knobs=(knobs or {}).get(name),
                decision_sink=RingBufferSink(4), **ctrl_kwargs)
            self.controllers[name] = ctrl

    @property
    def decisions(self) -> list:
        return list(self.decision_sink.window())

    def maybe_reconfigure(self) -> list[DecisionRecord]:
        """Run every tenant's loop once; apply winners; return the records.

        Call once per fleet tick, after ``fleet.step``.  Per tenant: plan
        on the tenant's metric slice; an applied plan reconfigures just
        that tenant (and resets its observation window) and prewarms its
        new engine; refusals record
        with the same cooldown the single-engine controller keeps.
        """
        out: list[DecisionRecord] = []
        trail = list(self.fleet.metrics)
        for name, ctrl in self.controllers.items():
            win = [m for m in trail if m.tenant == name]
            rec = ctrl.plan(metrics=win)
            if rec is None:
                continue
            if rec.applied:
                _prewarm_fixed(self.fleet.reconfigure_tenant(
                    name, ServingConfig(**rec.winner)))
                ctrl.mark_applied(rec)
            else:
                ctrl._cooldown_until = rec.tick + ctrl.cooldown_ticks
            rec = dataclasses.replace(rec, tenant=name)
            self.decision_sink.emit(rec)
            out.append(rec)
        return out
