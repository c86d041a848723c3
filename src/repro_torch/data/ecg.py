"""Synthetic ECG5000-compatible dataset — numpy-only copy of ``repro.data.ecg``.

ECG5000 (PhysioNet [37]) is not bundled with the repository, so we generate
a statistically compatible replacement matching the paper's description:
T=140 samples per beat, 4 classes (1 normal + 3 anomaly morphologies),
500-train / 4500-test split with heavy class imbalance, each trace normalized
to zero mean / unit variance.  Waveforms are PQRST Gaussian-pulse
compositions with physiological jitter; anomalies are (1) inverted T wave +
ST elevation, (2) premature/displaced R peak (PVC-like), (3) low-amplitude
fibrillation-like noise.

The pipeline is deterministic in (seed, epoch) — restart-reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

T_STEPS = 140
NUM_CLASSES = 4
CLASS_FRACTIONS = (0.58, 0.25, 0.12, 0.05)     # imbalance like ECG5000


def _pqrst(rng: np.random.Generator, n: int) -> np.ndarray:
    """Normal beats: P, Q, R, S, T Gaussian bumps with jitter. [n, T]"""
    t = np.linspace(0.0, 1.0, T_STEPS)[None, :]
    def bump(center, width, amp):
        c = center + rng.normal(0, 0.008, (n, 1))
        w = width * (1 + rng.normal(0, 0.08, (n, 1)))
        a = amp * (1 + rng.normal(0, 0.10, (n, 1)))
        return a * np.exp(-0.5 * ((t - c) / w) ** 2)
    x = (bump(0.18, 0.025, 0.18)       # P
         + bump(0.385, 0.012, -0.25)   # Q
         + bump(0.42, 0.016, 1.60)     # R
         + bump(0.455, 0.012, -0.35)   # S
         + bump(0.68, 0.045, 0.40))    # T
    x += rng.normal(0, 0.015, x.shape)             # sensor noise
    return x


def _make_class(rng: np.random.Generator, n: int, label: int) -> np.ndarray:
    x = _pqrst(rng, n)
    t = np.linspace(0.0, 1.0, T_STEPS)[None, :]
    if label == 1:     # inverted T + ST elevation
        x -= 2 * 0.40 * np.exp(-0.5 * ((t - 0.68) / 0.045) ** 2)
        x += 0.22 * ((t > 0.47) & (t < 0.62))
    elif label == 2:   # premature / displaced R (PVC-like)
        x += 1.2 * np.exp(-0.5 * ((t - 0.80) / 0.03) ** 2)
        x -= 0.8 * np.exp(-0.5 * ((t - 0.42) / 0.016) ** 2)
    elif label == 3:   # fibrillation-like: low-amp irregular oscillation
        phase = rng.uniform(0, 2 * np.pi, (n, 1))
        freq = rng.uniform(9, 14, (n, 1))
        x = 0.35 * np.sin(2 * np.pi * freq * t + phase) \
            + rng.normal(0, 0.12, x.shape)
    return x


def make_ecg5000(seed: int = 0):
    """Returns (train_x [500,140,1], train_y, test_x [4500,140,1], test_y)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    total = 5000
    for label, frac in enumerate(CLASS_FRACTIONS):
        n = int(round(total * frac))
        xs.append(_make_class(rng, n, label))
        ys.append(np.full((n,), label, np.int32))
    x = np.concatenate(xs)[:total]
    y = np.concatenate(ys)[:total]
    # per-sample zero mean / unit variance (paper preprocessing)
    x = (x - x.mean(axis=1, keepdims=True)) / (x.std(axis=1, keepdims=True) + 1e-8)
    order = rng.permutation(total)
    x, y = x[order][..., None].astype(np.float32), y[order]
    return x[:500], y[:500], x[500:], y[500:]


@dataclasses.dataclass
class Pipeline:
    """Deterministic shuffled-batch iterator; epoch keyed into the seed."""
    x: np.ndarray
    y: np.ndarray
    batch_size: int = 64
    seed: int = 0
    drop_remainder: bool = True

    def epoch(self, epoch: int):
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.x))
        n_full = len(self.x) // self.batch_size
        end = n_full * self.batch_size if self.drop_remainder else len(self.x)
        for i in range(0, end, self.batch_size):
            idx = order[i:i + self.batch_size]
            yield self.x[idx], self.y[idx]

