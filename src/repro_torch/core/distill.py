"""Distilled single-chain student: deterministic trunk + uncertainty head —
port of ``repro.core.distill``.

The MC-dropout teacher prices every prediction at S stochastic passes.  The
student runs the *same* recurrent trunk once, deterministic (rows carrying
:data:`repro_torch.core.mcd.STUDENT_ROW_FLAG` take the raw view in every
kernel and plain version), then two dense heads on its feature: the
teacher's own head for the prediction and an *uncertainty head* regressed
on the teacher's chain-axis uncertainty:

* classifier — the head predicts the BALD mutual information (epistemic
  nats) from the trunk's final hidden state ``h_T``;
* autoencoder — the head predicts the per-position epistemic variance
  ``Var_s[mu]`` from the decoder's hidden sequence ``dec_out``.

Nothing here owns a forward pass: the trunk is ``classifier.apply`` /
``autoencoder.apply`` with flagged rows, so a student row rides the same
per-layer kernel launches as its MC neighbours.  Teacher targets fold the
chain axis through the ``Running*Summary`` accumulators of
:mod:`repro_torch.core.uncertainty` (float64 on the host), the estimator
early exit reads.  The heads run in the dtype of the feature they are
given: a bf16 ``h_T`` gives bf16 logits, rounded as the reference rounds
them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import autoencoder, classifier, linear, mcd, uncertainty


def det_rows(n: int, base: int = 0, device=None) -> torch.Tensor:
    """``n`` distinct student (deterministic) row ids: flagged ``base+i``,
    as int64 (the uint32 pattern, flag included)."""
    dev = resolve_device(device)
    return (torch.arange(base, base + n, dtype=torch.int64, device=dev)
            | mcd.STUDENT_ROW_FLAG)


def _is_classifier(cfg) -> bool:
    if isinstance(cfg, classifier.ClassifierConfig):
        return True
    if isinstance(cfg, autoencoder.AutoencoderConfig):
        return False
    raise TypeError(f"expected ClassifierConfig or AutoencoderConfig, "
                    f"got {type(cfg).__name__}")


def init_student(generator: torch.Generator, cfg,
                 params: dict[str, Any] | None = None,
                 dtype=torch.float32, device=None) -> dict[str, Any]:
    """Student head params: ``{"head": DenseParams, "unc": DenseParams}``.

    ``head`` maps the trunk feature to the prediction: the teacher's own
    head when ``params`` is given (at init the student's prediction is the
    teacher's deterministic pass), else fresh Glorot drawn from
    ``generator``.  ``unc`` maps the same feature to the epistemic
    estimate, always fresh: ``H -> 1`` (MI) for the classifier, ``H -> I``
    (per-feature Var_s[mu]) for the autoencoder.  A softplus keeps it
    non-negative.  Draws on the CPU generator, placed on ``device``
    (default CUDA).
    """
    dev = resolve_device(device)
    if _is_classifier(cfg):
        out_dim, unc_dim = cfg.num_classes, 1
    else:
        out_dim = 2 * cfg.input_dim if cfg.heteroscedastic else cfg.input_dim
        unc_dim = cfg.input_dim
    head = (params["head"] if params is not None else
            linear.init_dense(generator, cfg.hidden, out_dim, dtype,
                              device=dev))
    unc = linear.init_dense(generator, cfg.hidden, unc_dim, dtype, device=dev)
    return {"head": head, "unc": unc}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as the reference evaluates it
    (``logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def classifier_student_summary(student: dict[str, Any], h_T: torch.Tensor
                               ) -> uncertainty.ClassificationSummary:
    """One-pass summary from the deterministic trunk's ``h_T`` [B, H].

    The student's probs play the ensemble mean; its predicted MI is the
    epistemic estimate, and the expected entropy is ``predictive - MI``,
    so the summary obeys the S-chain estimator's decomposition identity.
    """
    logits = linear.dense(student["head"], h_T)
    probs = uncertainty._softmax(logits)
    pred_h = uncertainty._entropy(probs)
    mi_hat = softplus(linear.dense(student["unc"], h_T))[..., 0]
    return uncertainty.ClassificationSummary(probs, pred_h, pred_h - mi_hat,
                                             mi_hat)


def autoencoder_student_summary(student: dict[str, Any],
                                dec_out: torch.Tensor,
                                heteroscedastic: bool = True
                                ) -> uncertainty.RegressionSummary:
    """One-pass summary from the decoder hidden sequence ``dec_out``
    [B, W, H]: mean and aleatoric from the teacher-shaped head, the
    epistemic variance from the uncertainty head, ``total = aleatoric +
    epistemic``."""
    y = linear.dense(student["head"], dec_out)
    if heteroscedastic:
        mean, log_var = torch.chunk(y, 2, dim=-1)
        aleatoric = torch.exp(torch.clamp(log_var, -10.0, 10.0))
    else:
        mean, aleatoric = y, torch.zeros_like(y)
    eps_hat = softplus(linear.dense(student["unc"], dec_out))
    return uncertainty.RegressionSummary(mean, aleatoric, eps_hat,
                                         aleatoric + eps_hat)


def _teacher_rows(x_seq, cfg, n_samples, base_row, device):
    """(S, B, x tiled S times chain-major, rows) of one teacher launch."""
    dev = resolve_device(device)
    x_seq = torch.as_tensor(x_seq, device=dev)
    S = int(n_samples if n_samples is not None else cfg.mcd.n_samples)
    B = x_seq.shape[0]
    rows = torch.arange(base_row, base_row + S * B, dtype=torch.int64,
                        device=dev)
    return S, B, x_seq.repeat(S, 1, 1), rows


def classifier_teacher_targets(params: dict[str, Any], x_seq, cfg, *,
                               n_samples: int | None = None,
                               backend: str = "reference", base_row: int = 0,
                               device=None, **apply_kw
                               ) -> uncertainty.ClassificationSummary:
    """S-chain teacher summary for a training batch — the distill target.

    Tiles ``x_seq`` [B, T, I] to S·B rows (chain-major, the serving
    engine's row layout) and runs **one** pass; the chain axis is folded
    through :class:`~repro_torch.core.uncertainty.RunningClassificationSummary`,
    the fp32 result placed back on ``device``.
    """
    S, B, xb, rows = _teacher_rows(x_seq, cfg, n_samples, base_row, device)
    logits = classifier.apply(params, xb, rows, cfg, backend=backend,
                              device=xb.device, **apply_kw)
    acc = uncertainty.RunningClassificationSummary()
    acc.update(logits.reshape(S, B, -1))
    return uncertainty.ClassificationSummary(
        *(v.to(xb.device) for v in acc.finalize()))


def autoencoder_teacher_targets(params: dict[str, Any], x_seq, cfg, *,
                                n_samples: int | None = None,
                                backend: str = "reference", base_row: int = 0,
                                device=None, **apply_kw
                                ) -> uncertainty.RegressionSummary:
    """S-chain teacher summary for an autoencoder batch (see the
    classifier's)."""
    S, B, xb, rows = _teacher_rows(x_seq, cfg, n_samples, base_row, device)
    mean, log_var = autoencoder.apply(params, xb, rows, cfg, backend=backend,
                                      device=xb.device, **apply_kw)
    acc = uncertainty.RunningRegressionSummary()
    lv = (log_var.reshape((S, B) + log_var.shape[1:])
          if log_var is not None else None)
    acc.update(mean.reshape((S, B) + mean.shape[1:]), lv)
    return uncertainty.RegressionSummary(
        *(v.to(xb.device) for v in acc.finalize()))
