"""Counter-based stateless PRNG — port of ``repro.core.prng``.

The mask stream is a pure integer hash of its coordinates, so the port must
reproduce the reference's uint32 bits exactly.  PyTorch on the CPU has no
uint32 right shift, so every value here is an int64 tensor holding a uint32
(``0 <= v < 2**32``): each multiply, add and left shift is followed by
``& 0xFFFFFFFF``.  A 32×32-bit product does not fit int64, so multiplies go
through the constant's two 16-bit halves, keeping every partial product
under 2**48.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def as_u32(x, device=None) -> torch.Tensor:
    """int64 tensor of uint32 values (Python ints and tensors alike)."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & MASK32


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 ``x`` (int64 tensor) and int ``c``."""
    c &= MASK32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(x) -> torch.Tensor:
    """murmur3-style 32-bit finalizer (full avalanche)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _combine(h, k) -> torch.Tensor:
    """boost::hash_combine fold of one stream id into the running hash."""
    h = as_u32(h)
    k = as_u32(k)
    s = (_mix32(k) + _GOLDEN) & MASK32
    s = (s + ((h << 6) & MASK32)) & MASK32
    s = (s + (h >> 2)) & MASK32
    return h ^ s


def fold_ids(seed, *ids) -> torch.Tensor:
    """Fold integer stream identifiers into a single uint32 key."""
    h = _mix32(seed)
    for k in ids:
        h = _combine(h, k)
    return h


def bernoulli_keep_threshold(p_drop: float) -> int:
    """uint32 threshold t such that P(bits >= t) = 1 - p_drop (keep prob)."""
    return min(max(int(round(p_drop * 4294967296.0)), 0), MASK32)
