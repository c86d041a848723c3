"""Adaptive tick scheduling and per-tick metrics — port of
``repro.serve.scheduler``.

The scheduler picks each tick's launch T from a small ladder of capacities
tracking the observed ragged chunk lengths.  On a kernel backend a rung is
one captured CUDA graph of the tick (``StreamingEngine``: a graph a
capacity and chunk dtype, captured on the first tick that needs it), so
the ladder bounds the captures as the reference's bounds its jit
compiles; :func:`prewarm` captures every rung at boot.
:class:`TickMetrics` counts the graphs a tick captured (``compiles``) and
its kernel launches.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Iterable, Sequence


def pow2_ladder(max_capacity: int, *, first: int = 8) -> tuple[int, ...]:
    """Power-of-two rungs up to a top rung of exactly ``max_capacity``."""
    if max_capacity < 1:
        raise ValueError(f"max_capacity must be >= 1, got {max_capacity}")
    rungs, c = [], min(max(1, first), max_capacity)
    while c < max_capacity:
        rungs.append(c)
        c *= 2
    rungs.append(max_capacity)
    return tuple(rungs)


@dataclasses.dataclass
class TickMetrics:
    """Per-tick control-plane observables."""

    tick: int
    capacity: int          # launch T this tick (ladder rung / fixed / max len)
    n_chunks: int          # sessions served this tick
    live_rows: int         # session-chain rows carrying real data
    batch_rows: int        # launch rows incl. idle-slot padding
    queue_depth: int       # admissions still waiting after the drain
    live_steps: int        # sum of chunk lengths (signal timesteps served)
    live_chain_steps: int  # live_steps x S MC chains (chain-timesteps)
    padded_steps: int      # batch_rows * capacity (chain-timesteps launched)
    pad_waste: float       # 1 - live_chain_steps/padded_steps
    duration_s: float      # wall clock of the tick, ended by a device sync
    tokens_per_sec: float  # live chain-timesteps / duration
    shards: int = 1        # data-parallel width the tick launched across
                           # (the engine mesh's data entries; 1 without a
                           # mesh); dse.calibrate prices the tick with it
    queue_wait_s: float = 0.0  # oldest-pending admission age at the drain
    launches: int = 0      # layer-kernel launches this tick (one per layer
                           # on the kernel backend; 0 on the reference)
    compiles: int = 0      # tick graphs captured this tick (a slow tick
                           # with compiles > 0 is a capture stall, fixed
                           # by prewarm; 0 on an eager tick)
    dropped: int = 0       # admissions the store refused this tick
    active_chains: int = 0     # live MC chains across the store at tick end
                               # (after early exit's retirements)
    reclaimed_rows: int = 0    # chain rows early exit retired this tick
                               # (freed batch capacity; ids stay burned)
    student_rows: int = 0      # rows served on the distilled fast path
                               # (one a student session)
    escalations: int = 0       # student sessions that crossed the
                               # threshold this tick and regrew to S fresh
                               # MC chains (store.grow)
    parts_s: dict = dataclasses.field(default_factory=dict)
                           # host seconds of the tick's parts: assemble
                           # (the batch on the host), to_device (copies and
                           # carries), apply (the pass, or the replay and
                           # the copies out of its buffers), summaries,
                           # student (the student heads' summaries, on an
                           # engine with heads), store (carries and
                           # results), early_exit (the retirement
                           # decisions, when on), escalate (the student
                           # escalations, when on), sync (the wait for
                           # the device)
    tenant: str | None = None  # owning tenant of a FleetEngine record
                               # (None: a single-tenant engine);
                               # summarize() groups on it


class AdaptiveTickScheduler:
    """Pick ``chunk_capacity`` online from the ragged-chunk distribution.

    Args:
      ladder: ascending candidate capacities.
      window: how many recent chunk lengths inform the choice.
      percentile: the rung must cover this percentile of the window (100 =
        the windowed max); the current tick's own max is always covered.
    """

    def __init__(self, ladder: Sequence[int] | None = None, *,
                 max_capacity: int = 512, window: int = 64,
                 percentile: float = 100.0):
        self.ladder = tuple(sorted(ladder)) if ladder \
            else pow2_ladder(max_capacity)
        if not self.ladder or any(c < 1 for c in self.ladder):
            raise ValueError(f"bad capacity ladder {self.ladder}")
        if not 0.0 < percentile <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], "
                             f"got {percentile}")
        self.percentile = float(percentile)
        self._window: deque[int] = deque(maxlen=int(window))

    @property
    def max_capacity(self) -> int:
        return self.ladder[-1]

    def plan(self, lens: Iterable[int]) -> int:
        """Record this tick's chunk lengths; return the capacity to launch."""
        lens = [int(n) for n in lens]
        if not lens:
            return self.ladder[0]
        need = max(lens)
        if need > self.ladder[-1]:
            raise ValueError(
                f"chunk of {need} steps exceeds the capacity ladder "
                f"(top rung {self.ladder[-1]}); split the chunk or extend "
                "the ladder")
        self._window.extend(lens)
        target = max(need, self._percentile_target())
        for rung in self.ladder:
            if rung >= target:
                return rung
        return self.ladder[-1]

    def _percentile_target(self) -> int:
        win = sorted(self._window)
        if not win:
            return self.ladder[0]
        k = max(0, min(len(win) - 1,
                       int(round(self.percentile / 100.0 * len(win))) - 1))
        return win[k]

    # -- persistence hooks (serve.persistence) -------------------------------
    def state(self) -> dict:
        """JSON-able state: the observation window."""
        return {"window": list(self._window)}

    def load_state(self, state: dict) -> None:
        self._window.extend(int(n) for n in state.get("window", ()))


def prewarm(engine, *, dtype=None) -> list[int]:
    """Capture every capacity rung at boot instead of on first use.

    Walks the engine's ladder (or its single fixed capacity) and drives
    the tick step of each rung with the serving batch layout
    (``engine._slot_count(0)`` slots of S chains, zeros from
    ``engine._gather_states([], dtype, n_pad=nb)``), so the first real
    tick of any shape replays a graph that exists (``compiles == 0``).  An
    engine that serves eagerly (the ``reference`` backend, or
    ``graphs=False``) runs one pass a rung, which builds and loads its
    kernels.  Dynamic-shape engines (``chunk_capacity=None``) have no
    finite shape family to warm and are rejected.

    Args:
      engine: a ``StreamingEngine`` with ``chunk_capacity`` an int or
        ``"auto"``.
      dtype: the chunk dtype traffic will arrive in (default float32, what
        the launchers feed; another dtype is another graph).

    Returns the list of capacities warmed, ascending.
    """
    import numpy as np
    import torch

    if engine._scheduler is not None:
        caps = list(engine._scheduler.ladder)
    elif isinstance(engine.chunk_capacity, int):
        caps = [engine.chunk_capacity]
    else:
        raise ValueError(
            "prewarm needs a bounded shape family: chunk_capacity must be "
            "an int or 'auto' (dynamic mode runs each observed shape "
            "eagerly)")
    dtype = torch.from_numpy(
        np.zeros(0, np.float32 if dtype is None else dtype)).dtype
    nb = engine._slot_count(0) * engine.n_samples
    in_dim = engine.cfg.input_dim
    dev = engine.device
    for cap in caps:
        if engine._graphs is not None:
            entry = engine._tick_step(cap, dtype)
            if not entry.step.ready:
                entry.step.first()
            continue
        x = torch.zeros((nb, cap, in_dim), dtype=dtype, device=dev)
        rows = torch.zeros((nb,), dtype=torch.int64, device=dev)
        lengths = torch.ones((nb,), dtype=torch.int32, device=dev)
        state = engine._gather_states([], dtype, n_pad=nb)
        engine._apply(x, rows, lengths, state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return caps


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in (0, 100]); 0.0 on an empty sequence."""
    vals = sorted(values)
    if not vals:
        return 0.0
    k = max(0, min(len(vals) - 1, math.ceil(p / 100.0 * len(vals)) - 1))
    return vals[k]


def summarize(metrics: Sequence[TickMetrics]) -> dict:
    """Aggregate control-plane observables over recorded ticks.

    A fleet trail carries tenant-tagged records: the roll-up then gains
    ``"tenants"``, each tenant's own sub-summary (over tenant-stripped
    copies, so a slice never nests a second ``"tenants"``).
    """
    if not metrics:
        return {"ticks": 0}
    live = sum(m.live_chain_steps for m in metrics)
    padded = sum(m.padded_steps for m in metrics)
    dur = sum(m.duration_s for m in metrics)
    durs = [m.duration_s for m in metrics]
    tps = [m.tokens_per_sec for m in metrics]
    out = {
        "ticks": len(metrics),
        "capacities_used": sorted({m.capacity for m in metrics}),
        "live_chain_steps": live,
        "padded_steps": padded,
        "pad_waste": 1.0 - live / padded if padded else 0.0,
        "mean_queue_depth": (sum(m.queue_depth for m in metrics)
                             / len(metrics)),
        "tokens_per_sec": live / dur if dur > 0 else 0.0,
        "duration_s_p50": percentile(durs, 50),
        "duration_s_p95": percentile(durs, 95),
        "tokens_per_sec_p50": percentile(tps, 50),
        "tokens_per_sec_p95": percentile(tps, 95),
        "queue_wait_s_p95": percentile([m.queue_wait_s for m in metrics], 95),
        "launches": sum(m.launches for m in metrics),
        "compiles": sum(m.compiles for m in metrics),
        "dropped": sum(m.dropped for m in metrics),
        "active_chains_mean": (sum(m.active_chains for m in metrics)
                               / len(metrics)),
        "reclaimed_rows": sum(m.reclaimed_rows for m in metrics),
        "student_rows_mean": (sum(m.student_rows for m in metrics)
                              / len(metrics)),
        "escalations": sum(m.escalations for m in metrics),
    }
    tenants = sorted({m.tenant for m in metrics if m.tenant is not None})
    if tenants:
        out["tenants"] = {
            name: summarize([dataclasses.replace(m, tenant=None)
                             for m in metrics if m.tenant == name])
            for name in tenants}
    return out
