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


def regression_summary(means: torch.Tensor,
                       log_vars: torch.Tensor | None) -> RegressionSummary:
    """means/log_vars: [S, B, T, I] stacked MC passes."""
    mu = torch.mean(means, dim=0)
    epistemic = torch.var(means, dim=0, correction=0)
    aleatoric = (torch.mean(torch.exp(log_vars), dim=0)
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
    return -torch.sum(p * torch.log(torch.clamp(p, 1e-12, 1.0)), dim=dim)


def classification_summary(logits: torch.Tensor) -> ClassificationSummary:
    """logits: [S, B, C] stacked MC passes."""
    probs_s = torch.softmax(logits, dim=-1)
    probs = torch.mean(probs_s, dim=0)
    pred_h = _entropy(probs)
    exp_h = torch.mean(_entropy(probs_s), dim=0)
    return ClassificationSummary(probs, pred_h, exp_h, pred_h - exp_h)
