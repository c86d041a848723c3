"""Fused MC-dropout mask generation and application — port of
``repro.kernels.bernoulli_mask``.

:func:`masked_activation` launches the hand-written CUDA kernel
``csrc/masked_activation.cu`` (built for ``sm_90a`` by :mod:`.build`, bound
with ``ctypes``) for CUDA tensors, and runs :func:`masked_activation_plain`,
the plain PyTorch version of the same function (a mirror of
``repro/kernels/ref.py::masked_activation``), for CPU tensors.  A CUDA tensor
never reaches the plain version: it launches the kernel or raises.

Element (b, f) keeps with the bit ``mix32(key ^ mix32(rows[b]·F + f)) >= t``
(uint32), the reference's stream.  The launch follows :func:`mask_plan`,
from the shape alone.  Every row is masked, one whose id has
the high bit set too: unlike the recurrent kernels, the reference's
``ref._mask`` has no student exemption.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import prng
from repro_torch.kernels import common


def masked_activation_plain(x: torch.Tensor, rows: torch.Tensor, key: int,
                            p_drop: float) -> torch.Tensor:
    """Plain PyTorch version: ``where(keep, x · scale, 0)`` with the scale in
    x's dtype; ``x`` itself when ``p_drop == 0``."""
    if p_drop == 0.0:
        return x
    keep = common.gate_mask(key, rows.to(x.device), x.shape[1], p_drop)
    scale = torch.tensor(1.0 / (1.0 - p_drop), dtype=x.dtype,
                         device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p)

THREADS = 256           # threads a block, one unit a thread (csrc kThreads)
MAX_ROW_BLOCKS = 65535  # blocks along the rows (gridDim.y's limit)


@functools.cache
def mask_plan(B: int, F: int, aligned: bool = True,
              elem_bytes: int = 4) -> dict:
    """How ``csrc/masked_activation.cu`` covers x [B, F] of ``elem_bytes``
    an element (4: fp32, 2: bf16), from the shape alone (cached by shape).

    ``vec4``: the 16-byte path (F a multiple of the elements in 16 bytes
    and ``aligned``, both pointers 16-byte aligned), where a unit is 16
    bytes (``elems_per_thread`` 4 fp32 or 8 bf16), else one element; a row
    holds ``n`` = F / 4 (F / 8) or F units, one a thread.
    ``grid`` is (blocks along a row, blocks along the rows), as the kernel's
    entry sets it, one row a block along the rows; past ``MAX_ROW_BLOCKS``
    rows the entry makes ``launches`` launches of at most that many rows.
    At the decode shapes the grid is one wave.
    """
    if B < 1 or F < 1:
        raise ValueError(f"x must be [B>=1, F>=1], got {(B, F)}")
    per16 = 16 // elem_bytes
    vec4 = F % per16 == 0 and aligned
    unit = per16 if vec4 else 1
    n = F // unit
    return {"vec4": vec4, "threads": THREADS, "n": n,
            "elems_per_thread": unit,
            "grid": (-(-n // THREADS), min(B, MAX_ROW_BLOCKS)),
            "launches": -(-B // MAX_ROW_BLOCKS)}


def masked_activation(x: torch.Tensor, rows: torch.Tensor, key: int,
                      p_drop: float) -> torch.Tensor:
    """x: [B, F] → ``x ⊙ z / (1-p)`` with ``z ~ Bern(1-p)`` per (row, f).

    ``rows``: [B] uint32 row ids (int64, or the int32 view of
    :func:`repro_torch.kernels.common.rows_to_int32`); ``key``: the uint32
    site key.  CPU tensors run :func:`masked_activation_plain`; CUDA tensors
    launch the kernel on the current stream (counted in
    ``masked_activation.launches``): fp32, or bf16 (its own kernel, the
    scale rounded to bf16); any other dtype raises.
    """
    common.refuse_grad("masked_activation", x)
    if common.check_device("masked_activation", x):
        return masked_activation_plain(x, rows, key, p_drop)
    common.check_p(p_drop)
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be [B>=1, F>=1], got {tuple(x.shape)}")
    act, variant = common.lm_act("masked_activation", x)
    B, F = x.shape
    dev = x.device
    common.check("x", x, dev, act, (B, F))
    rows32 = common.rows_arg(rows, B, dev)
    out = torch.empty_like(x)          # 16-byte aligned: a fresh allocation
    plan = mask_plan(B, F, x.data_ptr() % 16 == 0, x.element_size())
    thr, scale, masked = common.mask_args(p_drop, act)
    common.launch_c(masked_activation, "masked_activation", _ARGTYPES,
                    (x.data_ptr(), rows32.data_ptr(), out.data_ptr(), B, F,
                     int(plan["vec4"]), int(key) & prng.MASK32, thr, scale,
                     masked, common.stream(dev)),
                    f"masked_activation (B={B}, F={F}, {act})", variant,
                    device=dev)
    return out


masked_activation.launches = 0
