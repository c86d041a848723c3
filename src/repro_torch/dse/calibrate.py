"""Calibrate the GPU roofline against *observed* serving ticks — port of
``repro.dse.calibrate`` over :mod:`repro_torch.dse.gpu_model`.

The paper's DSE prices candidates with an analytic model (FPGA §IV-B/C;
:mod:`repro_torch.dse.gpu_model` on the GPU).  Offline that is enough —
every candidate is compared under the same model, so only the *ranking*
matters.  An **online** controller closing the DSE→serving loop needs
more: its SLO is an absolute wall-clock bound, so the model's predictions
must track the latencies the engine actually measures.  On an H100 an ECG
tick is host-bound: the roofline of a classifier tick is microseconds, the
tick milliseconds, so the fixed per-tick cost carries nearly all of it.

Each served tick is one observation ``(raw, duration)`` where ``raw`` is
the uncalibrated roofline time for the tick's launch shape
(``TickMetrics.batch_rows`` × ``capacity``, the shape the engine reports)
and ``duration`` is what the engine measured.  A two-parameter affine fit

    observed ≈ scale · raw + overhead

absorbs the platform's effective-throughput factor (``scale``) and the
fixed per-tick cost (``overhead``: host staging, summaries, the store, the
graph replay's launch).  The calibrated model then prices *candidate*
configurations — other S, precision, chunk capacity — in observed-world
seconds, which is what ``repro_torch.serve.controller`` feeds to
``search.optimize(latency_model=…)`` and checks against the SLO.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from repro_torch.dse import gpu_model
from repro_torch.dse.fpga_model import RNNArch

#: Relative x-variance below which the affine fit is unidentifiable (every
#: observed tick launched the same shape) and the ratio fallback is used.
_DEGENERATE_REL_VAR = 1e-12


@dataclasses.dataclass(frozen=True)
class RooflineFit:
    """An affine map from roofline seconds to observed seconds.

    ``scale`` is the platform factor (observed seconds per modeled second —
    ~1 on hardware the roofline constants match, far above it on a
    host-bound tick);
    ``overhead_s`` the fixed per-tick cost.  ``resid_s`` (rms residual over
    the fitted window) is the honesty metric: predictions are only as
    SLO-trustworthy as the fit, and a decision trail that records it lets
    an operator see *why* the controller believed a candidate was safe.
    """

    scale: float
    overhead_s: float
    n_ticks: int
    resid_s: float

    def predict(self, raw_s: float) -> float:
        """Observed-world seconds for a modeled (uncalibrated) time."""
        return self.scale * raw_s + self.overhead_s


def tick_raw_seconds(arch: RNNArch, *, rows: float, capacity: int,
                     shards: int = 1) -> float:
    """Uncalibrated roofline time for one engine tick.

    A tick launches ``rows`` batch rows (sessions × S chains, padding
    included — padded rows run the same graph) for ``capacity`` timesteps,
    ``shards``-way data-parallel.  ``rows`` may be fractional: with early
    exit live the controller prices candidates on *expected* active chains
    (ceiling × observed survival ratio), and the roofline is smooth in the
    batch dimension anyway.  ``arch.timesteps`` is overridden by the launch
    capacity: the arch describes the *model*, the tick decides how much
    signal one launch consumes.
    """
    arch_t = dataclasses.replace(arch, timesteps=int(capacity))
    m = gpu_model.rnn_step_model(arch_t, batch=float(rows), n_samples=1,
                                 data=int(shards))
    return m["t_step"]


def fit_roofline(metrics: Sequence, arch: RNNArch, *,
                 min_ticks: int = 4) -> RooflineFit | None:
    """Least-squares fit of observed tick durations to the roofline.

    ``metrics`` is a window of ``TickMetrics``; ``arch`` the architecture
    that served them (the *current* config — calibration windows must not
    straddle a reconfiguration, the controller resets its window at every
    swap).  Returns None below ``min_ticks`` observations — an SLO decision
    off a two-tick fit would be noise dressed as policy.

    Fallbacks keep the fit usable on degenerate windows: when every tick
    launched the same shape the slope is unidentifiable and the fit
    collapses to the ratio ``mean(observed)/mean(raw)`` (zero overhead) —
    still monotone in every knob, which is what candidate ranking needs.
    A non-positive slope or negative overhead (noise) falls back the same
    way.
    """
    obs = [(tick_raw_seconds(arch, rows=m.batch_rows, capacity=m.capacity,
                             shards=m.shards), float(m.duration_s))
           for m in metrics if m.duration_s > 0 and m.batch_rows > 0]
    if len(obs) < min_ticks:
        return None
    n = float(len(obs))
    mx = sum(x for x, _ in obs) / n
    my = sum(y for _, y in obs) / n
    vx = sum((x - mx) ** 2 for x, _ in obs) / n
    if mx <= 0.0:
        return None
    if vx / (mx * mx) < _DEGENERATE_REL_VAR:
        scale, overhead = my / mx, 0.0
    else:
        cov = sum((x - mx) * (y - my) for x, y in obs) / n
        scale = cov / vx
        overhead = my - scale * mx
        if scale <= 0.0:
            scale, overhead = my / mx, 0.0
        elif overhead < 0.0:
            # Clamp to the physical floor, re-aim the slope through the
            # centroid so the fit still passes through the observed mean.
            scale, overhead = my / mx, 0.0
    resid = math.sqrt(sum((y - (scale * x + overhead)) ** 2
                          for x, y in obs) / n)
    return RooflineFit(scale=scale, overhead_s=overhead,
                       n_ticks=int(n), resid_s=resid)


def latency_model(fit: RooflineFit, *, slots: int | None = None,
                  shards: int = 1) -> Callable:
    """A calibrated ``latency_model=`` for
    :func:`repro_torch.dse.search.optimize`.

    The returned callable prices a candidate's *per-tick* latency in
    observed-world seconds.  ``arch.timesteps`` carries the candidate's
    chunk capacity (the controller builds each candidate's arch that way);
    ``batch`` is the live session count and ``n_samples`` the candidate's S.
    ``slots`` mirrors the engine's fixed-shape padding: a fixed/auto engine
    always launches ``max_sessions`` session slots whatever the live count,
    so the candidate must be priced at the shape it would actually launch.
    Pass ``hw_model=None`` to ``optimize`` alongside this — the FPGA DSP
    gate has no business filtering GPU serving candidates.
    """

    def model(arch: RNNArch, hw=None, batch: int = 1,
              n_samples: float = 1) -> float:
        del hw
        sessions = max(int(batch), 1)
        if slots is not None:
            sessions = max(sessions, int(slots))
        # n_samples may be fractional — expected active chains under early
        # exit (ceiling × survival ratio), not a chain count.
        rows = sessions * max(float(n_samples), 1.0)
        raw = tick_raw_seconds(arch, rows=rows, capacity=arch.timesteps,
                               shards=shards)
        return fit.predict(raw)

    return model
