"""End-to-end driver: train the paper's Bayesian recurrent autoencoder on
ECG5000-compatible data and detect anomalies with uncertainty (paper §V-A1
+ Fig. 1), with checkpoint / restart fault tolerance — port of
``examples/anomaly_detection.py``.

    PYTHONPATH=src python -m repro_torch.examples.anomaly_detection \\
        [--steps 300] [--device cpu]

Training runs the plain PyTorch path (``torch.autograd`` through the
``reference`` backend: no kernel has a backward), as the reference trains
through ``jax.grad``; so does the scoring, ``bayesian.predict`` over
``autoencoder.apply``'s default backend.  The weights start from a CPU
``torch.Generator`` seeded 0.  ``--test-beats`` (default the reference's
1024) sizes the scored test set.  The reference scores the parameters it
initialised (its ``Trainer`` is functional and the example reads
``params``, not ``tr.params``); this port scores the trained ones.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import autoencoder as ae
from repro_torch.core import bayesian, mcd
from repro_torch.core import uncertainty as unc
from repro_torch.data import ecg
from repro_torch.train import optimizer, trainer


def roc_auc(score: np.ndarray, positive: np.ndarray) -> float:
    """ROC-AUC by the rank statistic (the reference's)."""
    order = np.argsort(score)
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    pos = positive.sum()
    neg = len(score) - pos
    return float((ranks[positive].sum() - pos * (pos + 1) / 2) / (pos * neg))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--test-beats", type=int, default=1024)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ecg_ae_")

    # --- data: train on NORMAL beats only (reconstruction-based detection)
    tx, ty, ex, ey = ecg.make_ecg5000(seed=0)
    normal = torch.as_tensor(tx[ty == 0], device=dev)

    # --- paper's best anomaly architecture: H=16, NL=2, B=YNYN
    cfg = ae.AutoencoderConfig(
        hidden=16, num_layers=2,
        mcd=mcd.MCDConfig(p=0.125, placement="YNYN", n_samples=30, seed=0))
    params = ae.init(torch.Generator().manual_seed(0), cfg, device=dev)

    def loss(p, batch, step):
        rows = torch.arange(batch.shape[0], dtype=torch.int64, device=dev)
        mean, log_var = ae.apply(p, batch, rows, cfg, device=dev)
        return torch.mean(ae.gaussian_nll(mean, log_var, batch)), {}

    tcfg = trainer.TrainConfig(
        adamw=optimizer.AdamWConfig(lr=3e-3),   # clip 3.0 / wd 1e-4 (paper)
        ckpt_dir=ckpt_dir, ckpt_every=100, log_every=50)
    tr = trainer.Trainer(loss, params, tcfg)    # auto-resumes if restarted
    n = normal.shape[0]
    batches = (normal[(i * 64) % max(n - 64, 1):][:64]
               for i in range(10 ** 6))
    tr.run(batches, args.steps)
    print(f"trained to step {tr.step} (checkpoints in {ckpt_dir})")

    # --- Bayesian anomaly scoring on the test set
    x = torch.as_tensor(ex[:args.test_beats], device=dev)
    labels = np.asarray(ey[:args.test_beats])
    is_anom = labels != 0
    with torch.no_grad():
        means, log_vars = bayesian.predict(
            lambda p, xb, rows: ae.apply(p, xb, rows, cfg, device=dev),
            tr.params, x, cfg.mcd)
        s = unc.regression_summary(means, log_vars)
        score = unc.rmse(s, x).cpu().numpy()
        total_unc = s.total.mean(dim=(1, 2)).cpu().numpy()
    auc = roc_auc(score, is_anom)

    print(f"\nreconstruction RMSE:  normal={score[~is_anom].mean():.3f}  "
          f"anomalous={score[is_anom].mean():.3f}")
    morph = labels == 1                    # Fig. 1-style morphology case
    print(f"total uncertainty:    normal={total_unc[~is_anom].mean():.4f}  "
          f"morphology-anomaly={total_unc[morph].mean():.4f}"
          f"   (Fig. 1 behaviour strengthens with --steps >= 300)")
    print(f"anomaly ROC-AUC: {auc:.3f}")
    return {"auc": auc, "steps": tr.step}


if __name__ == "__main__":
    main()
