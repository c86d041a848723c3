"""Chain-axis uncertainty — port of ``repro.core.uncertainty``: the batch
summaries, the incremental summaries early exit compares, and the
calibration metrics.

Regression (autoencoder): total = aleatoric + epistemic, where
  aleatoric = E_s[σ²_s(x)] (mean predicted variance) and
  epistemic = Var_s[μ_s(x)] (variance of the predicted means over S).
Classification: predictive entropy H[E_s p_s] (total, nats), expected
entropy E_s H[p_s] (aleatoric) and their difference, the mutual information
(epistemic).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class RegressionSummary(NamedTuple):
    mean: torch.Tensor        # [B, T, I] predictive mean
    aleatoric: torch.Tensor   # [B, T, I] E_s[σ²]
    epistemic: torch.Tensor   # [B, T, I] Var_s[μ]
    total: torch.Tensor       # [B, T, I]


# Sub-fp32 inputs (the bf16 outputs of a serving precision) are summarized
# as the reference computes them: every sum and mean accumulates in fp32
# and rounds to the input dtype once; elementwise ops stay in it; the
# softmax takes exp in the input dtype and its normalizer's sum in fp32.
# fp32 inputs take the PyTorch calls below as they are.


def _low(v: torch.Tensor) -> bool:
    return v.dtype in (torch.bfloat16, torch.float16)


def _sum(v: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    return v.float().sum(dim, keepdim=keepdim).to(v.dtype)


def _chains_last(v: torch.Tensor, dim: int) -> torch.Tensor:
    """``v`` with the chain axis ``dim`` moved last, contiguous.  Reduced
    over its last axis, each output sums its own chains in an order fixed
    by the chain count alone; over a leading axis PyTorch's CPU kernel
    sums in an order that follows the other axes' sizes, so a session's
    summary would follow how many sessions share its batch."""
    return v.movedim(dim, -1).contiguous()


def _mean(v: torch.Tensor, dim: int) -> torch.Tensor:
    d = _chains_last(v if not _low(v) else v.float(), dim)
    if not _low(v):
        return torch.mean(d, dim=-1)
    return (d.sum(-1) / v.shape[dim]).to(v.dtype)


def _var(v: torch.Tensor, dim: int) -> torch.Tensor:
    d = _chains_last(v if not _low(v) else v.float(), dim)
    if not _low(v):
        return torch.var(d, dim=-1, correction=0)
    m = d.sum(-1, keepdim=True) / v.shape[dim]
    return (torch.square(d - m).sum(-1) / v.shape[dim]).to(v.dtype)


def _softmax(v: torch.Tensor) -> torch.Tensor:
    if not _low(v):
        return torch.softmax(v, dim=-1)
    e = torch.exp(v - v.amax(dim=-1, keepdim=True))
    return e / _sum(e, -1, keepdim=True)


def regression_summary(means: torch.Tensor,
                       log_vars: torch.Tensor | None) -> RegressionSummary:
    """means/log_vars: [S, B, T, I] stacked MC passes (fp32, or bf16
    reduced in fp32 as the reference does)."""
    chains = _chains_last(means, 0)     # one copy for the mean and the var
    mu = _mean(chains, -1)
    epistemic = _var(chains, -1)
    aleatoric = (_mean(torch.exp(log_vars), 0)
                 if log_vars is not None else torch.zeros_like(mu))
    return RegressionSummary(mu, aleatoric, epistemic, aleatoric + epistemic)


def regression_nll(summary: RegressionSummary,
                   target: torch.Tensor) -> torch.Tensor:
    """Gaussian NLL of the moment-matched predictive distribution, per
    example."""
    var = torch.clamp(summary.total, min=1e-8)
    return 0.5 * torch.mean((summary.mean - target) ** 2 / var
                            + torch.log(var) + math.log(2.0 * math.pi),
                            dim=(-2, -1))


def rmse(summary: RegressionSummary, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((summary.mean - target) ** 2,
                                 dim=(-2, -1)))


def l1(summary: RegressionSummary, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(summary.mean - target), dim=(-2, -1))


class ClassificationSummary(NamedTuple):
    probs: torch.Tensor               # [B, C] mean predictive probabilities
    predictive_entropy: torch.Tensor  # [B] H[E_s p_s]  (total, nats)
    expected_entropy: torch.Tensor    # [B] E_s H[p_s]  (aleatoric)
    mutual_information: torch.Tensor  # [B] epistemic (BALD)


def _entropy(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    t = p * torch.log(torch.clamp(p, 1e-12, 1.0))
    return -(_sum(t, dim) if _low(p) else torch.sum(t, dim=dim))


def classification_summary(logits: torch.Tensor) -> ClassificationSummary:
    """logits: [S, B, C] stacked MC passes (fp32, or bf16 reduced in fp32
    as the reference does)."""
    probs_s = _softmax(logits)
    probs = _mean(probs_s, 0)
    pred_h = _entropy(probs)
    exp_h = _mean(_entropy(probs_s), 0)
    return ClassificationSummary(probs, pred_h, exp_h, pred_h - exp_h)


# ---------------------------------------------------------------------------
# Incremental (mergeable) chain-axis summaries — the early-exit estimators
# ---------------------------------------------------------------------------
#
# The streaming engine's early exit compares the summary of a *prefix* of a
# session's MC chains with the summary of all of them: accumulate the first
# k chains, snapshot, fold in the rest, compare.  Both accumulators are exact
# one-pass algorithms over the chain axis, in float64 host numpy (the
# reference's arithmetic, step for step): plain sums for the classification
# moments and Welford/Chan for the regression variance.  A convergence
# decision must not flip on fp32 summation order; the chain counts are tiny.
# ``finalize`` returns fp32 tensors, ``finalize_numpy`` the same values as
# numpy arrays (what the engine's early exit compares, on the host).

def _f64(block) -> np.ndarray:
    if isinstance(block, torch.Tensor):
        return block.detach().cpu().to(torch.float64).numpy()
    return np.asarray(block, np.float64)


class RunningClassificationSummary:
    """One-pass accumulator over MC chains for ``classification_summary``.

    ``update`` folds in a ``[s, B, C]`` block of stacked chain logits
    (numpy or a tensor); ``finalize`` returns the
    :class:`ClassificationSummary` over every chain seen so far (fp32).
    ``merge`` folds another accumulator in (disjoint chain sets), ``copy``
    snapshots the state.
    """

    def __init__(self):
        self.count = 0
        self._prob_sum: np.ndarray | None = None   # [B, C] float64
        self._ent_sum: np.ndarray | None = None    # [B]    float64

    def update(self, logits) -> "RunningClassificationSummary":
        block = _f64(logits)
        if block.ndim != 3:
            raise ValueError(f"logits block must be [s, B, C], "
                             f"got shape {block.shape}")
        z = block - block.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        ent = -np.sum(p * np.log(np.clip(p, 1e-12, 1.0)), axis=-1)
        if self._prob_sum is None:
            self._prob_sum = p.sum(axis=0)
            self._ent_sum = ent.sum(axis=0)
        else:
            self._prob_sum += p.sum(axis=0)
            self._ent_sum += ent.sum(axis=0)
        self.count += block.shape[0]
        return self

    def merge(self, other: "RunningClassificationSummary"
              ) -> "RunningClassificationSummary":
        """Fold ``other``'s chains in (disjoint chain sets, any order)."""
        if other.count == 0:
            return self
        if self.count == 0:
            self._prob_sum = other._prob_sum.copy()
            self._ent_sum = other._ent_sum.copy()
        else:
            self._prob_sum = self._prob_sum + other._prob_sum
            self._ent_sum = self._ent_sum + other._ent_sum
        self.count += other.count
        return self

    def copy(self) -> "RunningClassificationSummary":
        out = RunningClassificationSummary()
        out.count = self.count
        if self._prob_sum is not None:
            out._prob_sum = self._prob_sum.copy()
            out._ent_sum = self._ent_sum.copy()
        return out

    def finalize_numpy(self) -> ClassificationSummary:
        """The summary's fields as float32 numpy arrays."""
        if self.count == 0:
            raise ValueError("no chains accumulated")
        probs = self._prob_sum / self.count
        pred_h = -np.sum(probs * np.log(np.clip(probs, 1e-12, 1.0)), axis=-1)
        exp_h = self._ent_sum / self.count
        return ClassificationSummary(*(np.asarray(a, np.float32) for a in
                                       (probs, pred_h, exp_h,
                                        pred_h - exp_h)))

    def finalize(self) -> ClassificationSummary:
        return ClassificationSummary(*map(torch.from_numpy,
                                          self.finalize_numpy()))


class RunningRegressionSummary:
    """Welford/Chan accumulator over MC chains for ``regression_summary``.

    ``update`` folds in ``[s, B, T, I]`` blocks of chain means (and the
    matching log-variances); ``finalize`` matches the batch formula over
    every chain seen (population variance).  The mean/M2 pair merges by
    Chan's parallel rule.
    """

    def __init__(self):
        self.count = 0
        self._mean: np.ndarray | None = None      # [B, T, I] float64
        self._m2: np.ndarray | None = None        # [B, T, I] float64
        self._var_sum: np.ndarray | None = None   # [B, T, I] sum of sigma^2

    def update(self, means, log_vars=None) -> "RunningRegressionSummary":
        block = _f64(means)
        if block.ndim < 2:
            raise ValueError(f"means block must be [s, ...], "
                             f"got shape {block.shape}")
        other = RunningRegressionSummary()
        other.count = block.shape[0]
        other._mean = block.mean(axis=0)
        other._m2 = ((block - other._mean) ** 2).sum(axis=0)
        if log_vars is not None:
            other._var_sum = np.exp(_f64(log_vars)).sum(axis=0)
        else:
            other._var_sum = np.zeros_like(other._mean)
        return self.merge(other)

    def merge(self, other: "RunningRegressionSummary"
              ) -> "RunningRegressionSummary":
        """Chan's parallel variance update over disjoint chain sets."""
        if other.count == 0:
            return self
        if self.count == 0:
            self._mean = other._mean.copy()
            self._m2 = other._m2.copy()
            self._var_sum = other._var_sum.copy()
            self.count = other.count
            return self
        n_a, n_b = self.count, other.count
        n = n_a + n_b
        delta = other._mean - self._mean
        self._m2 = self._m2 + other._m2 + delta ** 2 * (n_a * n_b / n)
        self._mean = self._mean + delta * (n_b / n)
        self._var_sum = self._var_sum + other._var_sum
        self.count = n
        return self

    def copy(self) -> "RunningRegressionSummary":
        out = RunningRegressionSummary()
        out.count = self.count
        if self._mean is not None:
            out._mean = self._mean.copy()
            out._m2 = self._m2.copy()
            out._var_sum = self._var_sum.copy()
        return out

    def finalize_numpy(self) -> RegressionSummary:
        """The summary's fields as float32 numpy arrays."""
        if self.count == 0:
            raise ValueError("no chains accumulated")
        epistemic = self._m2 / self.count
        aleatoric = self._var_sum / self.count
        return RegressionSummary(*(np.asarray(a, np.float32) for a in
                                   (self._mean, aleatoric, epistemic,
                                    aleatoric + epistemic)))

    def finalize(self) -> RegressionSummary:
        return RegressionSummary(*map(torch.from_numpy,
                                      self.finalize_numpy()))


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(probs, -1) == labels).float())


def expected_calibration_error(probs: torch.Tensor, labels: torch.Tensor,
                               n_bins: int = 10) -> torch.Tensor:
    """ECE — calibration quality of the Bayesian predictive distribution."""
    conf = torch.amax(probs, -1)
    correct = (torch.argmax(probs, -1) == labels).float()
    bins = torch.clamp((conf * n_bins).to(torch.int32), 0, n_bins - 1)
    ece = torch.zeros((), dtype=torch.float32, device=probs.device)
    n = probs.shape[0]
    for b in range(n_bins):
        in_bin = (bins == b).float()
        cnt = torch.sum(in_bin)
        denom = torch.clamp(cnt, min=1)
        acc_b = torch.where(cnt > 0, torch.sum(correct * in_bin) / denom, 0.0)
        conf_b = torch.where(cnt > 0, torch.sum(conf * in_bin) / denom, 0.0)
        ece = ece + (cnt / n) * torch.abs(acc_b - conf_b)
    return ece
