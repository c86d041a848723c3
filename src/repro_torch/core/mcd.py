"""Monte-Carlo-Dropout masks — port of ``repro.core.mcd``.

Masks are pure functions of ``(seed, layer, kind, gate, row, col)`` through
the counter hash in :mod:`repro_torch.core.prng`, tied across all T steps of
a sample (paper §II-B).  The index is ``row·n_feat + col`` wrapping in
uint32, exactly as in the reference, so the port draws the same bits.

Row ids are int64 tensors holding uint32 values; the high bit
(:data:`STUDENT_ROW_FLAG`) marks a deterministic row that runs unmasked.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import prng

KIND_X = 0        # LSTM/GRU input-side gate masks
KIND_H = 1        # LSTM/GRU hidden-side gate masks
KIND_FEAT = 2     # generic per-site feature mask

GATES = ("i", "f", "g", "o")


def parse_placement(b: str | Sequence[bool]) -> tuple[bool, ...]:
    """Parse the paper's B-string (``"YNYN"``) into per-layer booleans."""
    if isinstance(b, str):
        bad = set(b.upper()) - {"Y", "N"}
        if bad:
            raise ValueError(f"placement must be Y/N string, got {b!r}")
        return tuple(c == "Y" for c in b.upper())
    return tuple(bool(x) for x in b)


def placement_str(b: Sequence[bool]) -> str:
    return "".join("Y" if x else "N" for x in b)


@dataclasses.dataclass(frozen=True)
class MCDConfig:
    """Algorithmic parameters of the Bayesian architecture (paper's A/B/S)."""

    p: float = 0.125
    placement: tuple[bool, ...] = ()
    n_samples: int = 30
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"p must be in [0,1), got {self.p}")
        object.__setattr__(self, "placement", parse_placement(self.placement))

    def bayesian(self, layer: int) -> bool:
        """Is layer Bayesian?  The B-string cycles ("YN" = alternating)."""
        if not self.placement:
            return False
        return self.placement[layer % len(self.placement)]

    @property
    def any_bayesian(self) -> bool:
        return any(self.placement)

    def replace(self, **kw) -> "MCDConfig":
        return dataclasses.replace(self, **kw)


def mask_key(seed, layer: int, kind: int, gate: int = 0) -> torch.Tensor:
    """uint32 stream key (int64 tensor) for one mask site."""
    return prng.fold_ids(seed, layer, kind, gate)


def feature_mask(seed, layer: int, rows: torch.Tensor, n_feat: int,
                 p: float, *, kind: int = KIND_FEAT, gate: int = 0,
                 dtype=torch.float32) -> torch.Tensor:
    """Keep-mask of shape ``rows.shape + (n_feat,)`` tied across time."""
    rows = prng.as_u32(rows)
    key = mask_key(seed, layer, kind, gate).to(rows.device)
    cols = torch.arange(n_feat, dtype=torch.int64, device=rows.device)
    idx = (prng.mul_u32(rows[..., None], n_feat) + cols) & prng.MASK32
    bits = prng._mix32(key ^ prng._mix32(idx))
    return (bits >= prng.bernoulli_keep_threshold(p)).to(dtype)


def lstm_gate_masks(seed, layer: int, rows: torch.Tensor, in_dim: int,
                    hidden_dim: int, p: float, dtype=torch.float32):
    """The paper's eight per-gate masks for one LSTM layer.

    Returns ``(z_x, z_h)`` with shapes ``rows.shape + (4, in_dim)`` and
    ``rows.shape + (4, hidden_dim)``.
    """
    zx = torch.stack([feature_mask(seed, layer, rows, in_dim, p, kind=KIND_X,
                                   gate=g, dtype=dtype) for g in range(4)],
                     dim=-2)
    zh = torch.stack([feature_mask(seed, layer, rows, hidden_dim, p,
                                   kind=KIND_H, gate=g, dtype=dtype)
                      for g in range(4)], dim=-2)
    return zx, zh


def gru_gate_masks(seed, layer: int, rows: torch.Tensor, in_dim: int,
                   hidden_dim: int, p: float, dtype=torch.float32):
    """The paper's six per-gate masks for one GRU layer (gates r, z, n).

    Returns ``(z_x, z_h)`` with shapes ``rows.shape + (3, in_dim)`` and
    ``rows.shape + (3, hidden_dim)``, from the same ``(kind, gate)`` stream
    namespace as the LSTM masks.
    """
    zx = torch.stack([feature_mask(seed, layer, rows, in_dim, p, kind=KIND_X,
                                   gate=g, dtype=dtype) for g in range(3)],
                     dim=-2)
    zh = torch.stack([feature_mask(seed, layer, rows, hidden_dim, p,
                                   kind=KIND_H, gate=g, dtype=dtype)
                      for g in range(3)], dim=-2)
    return zx, zh


def apply_mask(x: torch.Tensor, mask: torch.Tensor | None,
               p: float) -> torch.Tensor:
    """Inverted-dropout application ``x · z / (1-p)``."""
    if mask is None or p == 0.0:
        return x
    scale = torch.tensor(1.0 / (1.0 - p), dtype=x.dtype, device=x.device)
    return x * mask.to(x.dtype) * scale


def sample_rows(batch: int, n_samples: int, device=None) -> torch.Tensor:
    """Global row ids ``s * batch + b`` for S MC samples folded into B."""
    return torch.arange(n_samples * batch, dtype=torch.int64, device=device)


#: High bit of a row id marks a *deterministic* (distilled-student) row.
STUDENT_ROW_FLAG = 0x8000_0000


def student_row(row: int) -> int:
    """Tag an allocator row id as deterministic (student fast path)."""
    return int(row) | STUDENT_ROW_FLAG


def base_row(row: int) -> int:
    """Strip a possible student flag, recovering the allocator id."""
    return int(row) & (STUDENT_ROW_FLAG - 1)


def is_student_row(row: int) -> bool:
    return bool(int(row) & STUDENT_ROW_FLAG)


def det_row_mask(rows: torch.Tensor) -> torch.Tensor:
    """Boolean [rows...] — True where the row id carries the student flag."""
    return prng.as_u32(rows) >= STUDENT_ROW_FLAG
