"""Quickstart: Bayesian LSTM inference with uncertainty — port of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The S = 30 stochastic passes run ``classifier.apply``'s default
``reference`` backend, as the reference's do.  The weights are random, from
a CPU ``torch.Generator`` seeded 0 (not the reference's numbers).
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bayesian, classifier as clf, mcd
from repro_torch.core import uncertainty as unc
from repro_torch.data import ecg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. An ECG beat classifier with MC-Dropout on layers 1 and 3 (paper's
    #    best: H=8, NL=3, B=YNY) and S=30 Monte-Carlo samples at inference.
    cfg = clf.ClassifierConfig(
        hidden=8, num_layers=3,
        mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=30, seed=0))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)

    # 2. A batch of (synthetic) ECG beats.
    _, _, test_x, _ = ecg.make_ecg5000(seed=0)
    x = torch.as_tensor(test_x[:8], device=dev)

    # 3. S stochastic forward passes, folded into the batch axis so the
    #    weights are fetched once (the paper's sample-wise pipelining).
    logits = bayesian.predict(
        lambda p, xb, rows: clf.apply(p, xb, rows, cfg, device=dev),
        params, x, cfg.mcd)
    print("stacked MC logits:", tuple(logits.shape))   # [S, B, classes]

    # 4. The Bayesian predictive distribution + uncertainty decomposition.
    s = unc.classification_summary(logits)
    for i in range(4):
        print(f"beat {i}: p={np.round(s.probs[i].cpu().numpy(), 3)} "
              f"H_total={float(s.predictive_entropy[i]):.3f} nats "
              f"MI_epistemic={float(s.mutual_information[i]):.3f} nats")
    print("\n(untrained weights -- see repro_torch.examples."
          "anomaly_detection for the trained end-to-end pipeline)")
    return s


if __name__ == "__main__":
    main()
