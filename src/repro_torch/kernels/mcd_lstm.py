"""Per-gate mask streams of the fused LSTM kernels — port of the parts of
``repro.kernels.mcd_lstm`` that the sequence kernel shares: the 8 stream keys
(:func:`gate_keys`) and the mask rule (:func:`_gate_mask`).

The per-step kernel ``mcd_lstm_step`` itself is not ported yet (see
ROADMAP.md, queue B).
"""

from __future__ import annotations

import torch

from repro_torch.core import mcd, prng


def _gate_mask(key: int, rows: torch.Tensor, feat_dim: int,
               p_drop: float) -> torch.Tensor:
    """Keep bits ``[B, feat_dim]``: ``mix32(key ^ mix32(row·F + col)) >= t``.

    ``rows`` holds uint32 row ids (int64 or int32 tensors; an int32 student
    row is its uint32 bit pattern).
    """
    rows = prng.as_u32(rows)
    cols = torch.arange(feat_dim, dtype=torch.int64, device=rows.device)
    idx = (prng.mul_u32(rows[:, None], feat_dim) + cols) & prng.MASK32
    bits = prng._mix32(prng.as_u32(key, rows.device) ^ prng._mix32(idx))
    return bits >= prng.bernoulli_keep_threshold(p_drop)


def gate_keys(seed, layer) -> torch.Tensor:
    """The 8 per-gate stream keys (x-side then h-side): [1, 8] int64 (uint32
    values) on the CPU, since kernels take them as launch arguments."""
    ks = [mcd.mask_key(seed, layer, mcd.KIND_X, g) for g in range(4)] + \
         [mcd.mask_key(seed, layer, mcd.KIND_H, g) for g in range(4)]
    return torch.stack([prng.as_u32(k) for k in ks]).reshape(1, 8)
