"""Chain-axis uncertainty of the classifier — port of the classification
part of ``repro.core.uncertainty``.

Predictive entropy H[E_s p_s] (total, nats), expected entropy E_s H[p_s]
(aleatoric) and their difference, the mutual information (epistemic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
