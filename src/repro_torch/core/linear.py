"""Dense layer with MCD hook — port of ``repro.core.linear``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import mcd


class DenseParams(NamedTuple):
    w: torch.Tensor  # [in, out]
    b: torch.Tensor  # [out]


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, device=None) -> DenseParams:
    s = (6.0 / (in_dim + out_dim)) ** 0.5
    w = torch.rand((in_dim, out_dim), generator=generator, dtype=dtype)
    return DenseParams((w * (2 * s) - s).to(device),
                       torch.zeros((out_dim,), dtype=dtype, device=device))


def dense(params: DenseParams, x: torch.Tensor,
          mask: torch.Tensor | None = None, p: float = 0.0) -> torch.Tensor:
    """y = (x ⊙ z / (1-p)) @ W + b; mask broadcasts over leading/time axes."""
    if mask is not None and mask.ndim == x.ndim - 1:
        mask = mask[..., None, :]
    x = mcd.apply_mask(x, mask, p)
    # The reference's einsum(x, w.astype(x.dtype), preferred f32), rounded
    # to x's dtype before the bias add in x's dtype: bf16 logits at bf16.
    y = x.float() @ params.w.to(x.dtype).float()
    return y.to(x.dtype) + params.b.to(x.dtype)
