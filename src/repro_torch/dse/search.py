"""The optimization framework (paper §IV, Fig. 7): lookup table + modes —
port of ``repro.dse.search`` (pure Python).

Flow (exactly the paper's):
  1. user gives hardware constraints + metric requirements + focus mode
  2. algorithmic DSE over A = {H, NL, B} against a benchmarked lookup table
  3. quantization (fp32 → bf16/int8 here; 16-bit fixed point on the FPGA)
  4. hardware-parameter optimization against the resource model
     (reuse factors / DSP budget on the FPGA; none on the GPU, whose
     feasibility is priced inside the latency model)
  5. latency estimate from the latency model; filter by minimum requirements

Modes: Opt-Latency, Opt-Accuracy, Opt-Precision, Opt-Recall, Opt-AUC,
Opt-Entropy (paper Tables V/VI).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.dse import fpga_model

MAXIMIZE = {"accuracy", "auc", "ap", "ar", "entropy", "precision", "recall"}
MINIMIZE = {"latency", "nll", "rmse"}

MODES = {
    "Opt-Latency": "latency",
    "Opt-Accuracy": "accuracy",
    "Opt-Precision": "ap",
    "Opt-Recall": "ar",
    "Opt-AUC": "auc",
    "Opt-Entropy": "entropy",
}


@dataclasses.dataclass
class Candidate:
    """One row of the lookup table: a benchmarked (A, metrics) pair.

    ``cell`` surfaces the recurrent-unit axis of the algorithmic space
    (paper §III-A: GRU drops into the same per-gate MCD design at 3/4 the
    datapath cost).  It defaults to the arch's own cell; passing it
    explicitly rewrites the arch, so a table can be built from shared
    ``RNNArch`` shapes with per-row cells and the resource/latency stage
    prices each row with its own gate count.
    """
    arch: fpga_model.RNNArch
    metrics: dict[str, float]          # algorithmic metrics (benchmarked)
    n_samples: int = 30
    cell: str | None = None            # recurrent unit; None = arch.cell
    hw: Any = None                     # filled by the hardware stage
    latency_s: float | None = None

    def __post_init__(self):
        if self.cell is None:
            self.cell = self.arch.cell
        elif self.cell != self.arch.cell:
            self.arch = dataclasses.replace(self.arch, cell=self.cell)

    def score(self, metric: str) -> float:
        if metric == "latency":
            return self.latency_s if self.latency_s is not None else float("inf")
        return self.metrics.get(metric, float("-inf"))


_FPGA_FIT = object()     # sentinel: default hw stage (so None can mean "no gate")


def optimize(table: list[Candidate], mode: str, *,
             dsp_total: int = fpga_model.DSP_TOTAL_ZC706,
             batch: int = 1,
             requirements: dict[str, float] | None = None,
             latency_model: Callable | None = None,
             hw_model: Callable | None = _FPGA_FIT) -> Candidate | None:
    """Greedy DSE per the paper: algorithmic pick → hw fit → filter → best.

    ``latency_model(arch, hw, batch, n_samples)`` defaults to the paper's
    §IV-C model; pass a GPU-roofline-backed callable for the GPU flow.
    ``hw_model(arch, dsp_total)`` is the hardware-feasibility stage —
    default: the paper's reuse-factor search under the ZC706 DSP budget,
    which rejects any arch that cannot fit the FPGA at *any* reuse.  The
    GPU flow passes ``hw_model=None`` (no DSP gate — GPU feasibility is
    priced inside the latency model; ``cand.hw`` stays None) or its own
    search callable.
    """
    metric = MODES.get(mode, mode)
    if hw_model is None and latency_model is None:
        raise ValueError(
            "hw_model=None (no FPGA fit stage) needs an explicit "
            "latency_model: the default §IV-C model prices reuse factors "
            "the disabled stage would have chosen (e.g. pass "
            "latency_model=gpu_model.rnn_latency_s for the GPU flow)")
    lat_fn = latency_model or fpga_model.latency_s
    hw_fn = fpga_model.best_reuse_factors if hw_model is _FPGA_FIT else hw_model
    survivors = []
    for cand in table:
        # Opt-Latency trades Bayesian sampling away (paper: S=1, B=N…N)
        n_samples = 1 if metric == "latency" and not any(
            c == "Y" for c in cand.arch.placement) else cand.n_samples
        hw = hw_fn(cand.arch, dsp_total) if hw_fn is not None else None
        if hw_fn is not None and hw is None:
            continue                     # does not fit the chip at any reuse
        lat = lat_fn(cand.arch, hw, batch=batch, n_samples=n_samples)
        cand = dataclasses.replace(cand, hw=hw, latency_s=lat,
                                   n_samples=n_samples)
        ok = True
        for req_metric, req_value in (requirements or {}).items():
            v = cand.score(req_metric)
            ok &= (v <= req_value) if req_metric in MINIMIZE else (v >= req_value)
        if ok:
            survivors.append(cand)
    if not survivors:
        return None
    reverse = metric not in MINIMIZE
    survivors.sort(key=lambda c: c.score(metric), reverse=reverse)
    return survivors[0]


def pareto_front(table: list[Candidate], x_metric: str,
                 y_metric: str) -> list[Candidate]:
    """Pareto-optimal candidates (paper Fig. 8/9: most are partially Bayesian)."""
    pts = [(c.score(x_metric), c.score(y_metric), c) for c in table]
    front = []
    for x, y, c in pts:
        dominated = any(
            (x2 <= x and y2 >= y and (x2 < x or y2 > y))
            if x_metric in MINIMIZE else
            (x2 >= x and y2 >= y and (x2 > x or y2 > y))
            for x2, y2, _ in pts)
        if not dominated:
            front.append(c)
    return front
