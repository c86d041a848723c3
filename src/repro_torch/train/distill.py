"""Distillation trainer: roll the MC teacher over a stream, fit the student —
port of ``repro.train.distill``.

The trunk is frozen; only the student's two dense heads
(:func:`repro_torch.core.distill.init_student`) train, so each batch is two
phases:

1. **Teacher pass** (no grad): one S·B-row pass gives the chain-axis
   summary through the ``Running*`` accumulators (the mean prediction and
   the epistemic target, MI / Var_s[mu]); in the same sweep the trunk runs
   once more on *flagged* (deterministic) rows to give the student's
   feature (``h_T`` / ``dec_out``), the values serving computes.  On the
   ``cuda_seq`` / ``cuda_step`` backends both passes run in the recurrent
   kernels.
2. **Student step**: a heads-only loss on those features —
   KL(teacher probs ‖ student softmax) + MSE on the uncertainty head for
   the classifier; mean matching + epistemic MSE for the autoencoder.

The step never touches the recurrent stack: distillation costs one teacher
sweep over the stream plus a dense-head regression.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable

import torch

from repro_torch.core import autoencoder, classifier, distill
from repro_torch.train import optimizer, trainer


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    n_samples: int | None = None   # teacher chain count (None: cfg.mcd.n_samples)
    unc_weight: float = 1.0        # weight of the uncertainty-regression term
    lr: float = 1e-2               # heads only: stiffer than trunk training
    backend: str = "reference"     # the trunk's path: reference | cuda_seq
                                   # | cuda_step
    log_every: int = 0
    #: Sweep the teacher once and cycle its batches: ``xs`` must then be
    #: finite; the targets are deterministic in ``(params, x)``, so a
    #: second sweep over the same batches buys nothing.
    cache_targets: bool = False

    def train_config(self) -> trainer.TrainConfig:
        return trainer.TrainConfig(
            adamw=optimizer.AdamWConfig(lr=self.lr, weight_decay=0.0),
            log_every=self.log_every)


@torch.no_grad()
def classifier_batches(params: dict[str, Any], cfg, xs: Iterable,
                       dcfg: DistillConfig, device=None):
    """Yield ``{"feat", "probs", "mi"}`` per input batch (teacher pass)."""
    for x in xs:
        t = distill.classifier_teacher_targets(
            params, x, cfg, n_samples=dcfg.n_samples, backend=dcfg.backend,
            device=device)
        x = torch.as_tensor(x, device=t.probs.device)
        _, states = classifier.apply(
            params, x, distill.det_rows(x.shape[0], device=x.device), cfg,
            backend=dcfg.backend, return_state=True, device=x.device)
        yield {"feat": states[-1][0], "probs": t.probs,
               "mi": t.mutual_information}


@torch.no_grad()
def autoencoder_batches(params: dict[str, Any], cfg, xs: Iterable,
                        dcfg: DistillConfig, device=None):
    """Yield ``{"feat", "mean", "eps"}`` per input batch (teacher pass)."""
    for x in xs:
        t = distill.autoencoder_teacher_targets(
            params, x, cfg, n_samples=dcfg.n_samples, backend=dcfg.backend,
            device=device)
        x = torch.as_tensor(x, device=t.mean.device)
        out = autoencoder.apply(
            params, x, distill.det_rows(x.shape[0], device=x.device), cfg,
            backend=dcfg.backend, return_decoded=True, device=x.device)
        yield {"feat": out[-1], "mean": t.mean, "eps": t.epistemic}


def _kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Mean KL(p ‖ q) over the batch, probabilities in, nats out."""
    p = torch.clamp(p, 1e-12, 1.0)
    q = torch.clamp(q, 1e-12, 1.0)
    return torch.mean(torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1))


def _fit(loss_fn, student, feed, num_steps, dcfg):
    tr = trainer.Trainer(loss_fn, student, dcfg.train_config())
    if dcfg.cache_targets:
        feed = itertools.cycle(list(feed))
    hist = tr.run(feed, num_steps)
    return tr.params, hist


def distill_classifier(params: dict[str, Any], cfg, xs: Iterable,
                       num_steps: int, *,
                       generator: torch.Generator | None = None,
                       dcfg: DistillConfig = DistillConfig(),
                       student: dict[str, Any] | None = None, device=None):
    """Fit a classifier student on ``xs`` batches ([B, T, I] each) on
    ``device`` (default CUDA).  Returns (student, history)."""
    if student is None:
        student = distill.init_student(
            generator if generator is not None
            else torch.Generator().manual_seed(0), cfg, params,
            device=device)

    def loss_fn(stu, batch, step):
        summ = distill.classifier_student_summary(stu, batch["feat"])
        kl = _kl(batch["probs"], summ.probs)
        unc = torch.mean((summ.mutual_information - batch["mi"]) ** 2)
        return kl + dcfg.unc_weight * unc, {"kl": kl, "unc_mse": unc}

    return _fit(loss_fn, student,
                classifier_batches(params, cfg, xs, dcfg, device),
                num_steps, dcfg)


def distill_autoencoder(params: dict[str, Any], cfg, xs: Iterable,
                        num_steps: int, *,
                        generator: torch.Generator | None = None,
                        dcfg: DistillConfig = DistillConfig(),
                        student: dict[str, Any] | None = None, device=None):
    """Fit an autoencoder student on ``xs`` batches on ``device`` (default
    CUDA).  Returns (student, history)."""
    if student is None:
        student = distill.init_student(
            generator if generator is not None
            else torch.Generator().manual_seed(0), cfg, params,
            device=device)

    def loss_fn(stu, batch, step):
        summ = distill.autoencoder_student_summary(stu, batch["feat"],
                                                   cfg.heteroscedastic)
        mse = torch.mean((summ.mean - batch["mean"]) ** 2)
        unc = torch.mean((summ.epistemic - batch["eps"]) ** 2)
        return mse + dcfg.unc_weight * unc, {"mse": mse, "unc_mse": unc}

    return _fit(loss_fn, student,
                autoencoder_batches(params, cfg, xs, dcfg, device),
                num_steps, dcfg)
