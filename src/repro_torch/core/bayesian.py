"""S-sample Bayesian predictive engine (the paper's MC sampling loop) —
port of ``repro.core.bayesian``.

On the FPGA the S MC samples stream through the pipeline back to back
(sample-wise pipelining, Fig. 4/5), so weights are fetched once.  On the GPU
the equivalent is to **fold the S samples into the batch axis**: one pass
over [S·B, ...] launches each layer's kernel once for all samples and
reuses each weight fetch S times.

Two execution strategies:
  * ``fold`` — tile to [S·B] and run once (throughput-optimal; default):
    one launch a layer over S·B rows.
  * ``scan`` — a Python loop over the samples, one pass of B rows each
    (memory-constrained fallback; activations for one sample at a time —
    the FPGA's sequential-sample behaviour): S launches a layer.

Both draw identical masks (the counter PRNG is keyed by the global row id
``sample * B + b``), and a row's result depends on its own row only, so the
choice is a memory / throughput trade-off the DSE can flip.
"""

from __future__ import annotations

import torch

from repro_torch.ckpt.checkpoint import tree_map
from repro_torch.core import mcd


def predict(apply_fn, params, x: torch.Tensor, cfg: mcd.MCDConfig,
            *, strategy: str = "fold"):
    """Run S stochastic forward passes; returns the output tree with
    leading [S, B].

    ``apply_fn(params, x, rows)`` must accept a row-id vector aligned with
    the batch axis of ``x`` (see :func:`repro_torch.core.mcd.sample_rows`)
    and return a tensor or a tree of tensors (tuples, dicts; ``None``
    holds no leaf) whose leaves lead with that batch axis.
    """
    batch = x.shape[0]
    s = max(1, cfg.n_samples if cfg.any_bayesian else 1)
    if strategy == "fold":
        x_tiled = x.unsqueeze(0).expand(s, *x.shape).reshape(
            s * batch, *x.shape[1:])
        rows = mcd.sample_rows(batch, s, device=x.device)
        out = apply_fn(params, x_tiled, rows)
        return tree_map(lambda y: y.reshape(s, batch, *y.shape[1:]), out)
    if strategy == "scan":
        outs = [apply_fn(params, x, sample_id * batch
                         + torch.arange(batch, dtype=torch.int64,
                                        device=x.device))
                for sample_id in range(s)]
        return tree_map(lambda *ys: torch.stack(ys), outs[0], *outs[1:])
    raise ValueError(f"unknown strategy {strategy!r}")
