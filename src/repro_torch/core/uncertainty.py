"""Chain-axis uncertainty — port of the batch summaries of
``repro.core.uncertainty``.

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


def _mean(v: torch.Tensor, dim: int) -> torch.Tensor:
    if not _low(v):
        return torch.mean(v, dim=dim)
    return (v.float().sum(dim) / v.shape[dim]).to(v.dtype)


def _var(v: torch.Tensor, dim: int) -> torch.Tensor:
    if not _low(v):
        return torch.var(v, dim=dim, correction=0)
    d = v.float()
    m = d.sum(dim, keepdim=True) / v.shape[dim]
    return (torch.square(d - m).sum(dim) / v.shape[dim]).to(v.dtype)


def _softmax(v: torch.Tensor) -> torch.Tensor:
    if not _low(v):
        return torch.softmax(v, dim=-1)
    e = torch.exp(v - v.amax(dim=-1, keepdim=True))
    return e / _sum(e, -1, keepdim=True)


def regression_summary(means: torch.Tensor,
                       log_vars: torch.Tensor | None) -> RegressionSummary:
    """means/log_vars: [S, B, T, I] stacked MC passes (fp32, or bf16
    reduced in fp32 as the reference does)."""
    mu = _mean(means, 0)
    epistemic = _var(means, 0)
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
