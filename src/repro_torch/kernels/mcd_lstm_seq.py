"""Sequence-fused Bayesian LSTM layer — port of ``repro.kernels.mcd_lstm_seq``.

:func:`mcd_lstm_seq` launches the hand-written CUDA kernel
``csrc/mcd_lstm_seq.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`mcd_lstm_seq_plain`, the plain
PyTorch version of the same function, for CPU tensors.  A CUDA tensor never
reaches the plain version: it launches the kernel or raises.

The kernel's design notes (what bounds it on an H100 and what is left for a
later PR) are at the top of the ``.cu`` source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import prng
from repro_torch.kernels import build
from repro_torch.kernels.mcd_lstm import _gate_mask

_THREADS = 128          # target threads per block: R rows x H units
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 227 * 1024


def rows_to_int32(rows: torch.Tensor) -> torch.Tensor:
    """uint32 row ids (any int dtype) as the kernel's int32 view, where the
    student flag (the uint32 high bit) is the sign bit."""
    r = prng.as_u32(rows)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)


def _keys8(keys) -> list[int]:
    ks = [int(k) & prng.MASK32
          for k in torch.as_tensor(keys).reshape(-1).tolist()]
    if len(ks) != 8:
        raise ValueError(f"keys must hold the 8 gate keys, got {len(ks)}")
    return ks


def _scale(p_drop: float) -> torch.Tensor:
    # float32(1/(1-p)) computed in double then rounded — the reference's
    # jnp.asarray(1.0 / (1.0 - p), float32).
    return torch.tensor(1.0 / (1.0 - p_drop), dtype=torch.float32)


def gate_mask_factors(keys, rows: torch.Tensor, in_dim: int, hidden: int,
                      p_drop: float):
    """The factors each gate view is multiplied by: ``[B,4,I]``, ``[B,4,H]``.

    ``1/(1-p)`` where the keep bit is set, 0 where it is not, and 1 for
    student rows or ``p_drop == 0`` — so ``x * factor`` is the reference's
    ``where(det, x, where(mask, x * scale, 0))``.
    """
    ks = _keys8(keys)
    dev = rows.device
    B = rows.shape[0]
    if p_drop <= 0.0:
        return (torch.ones((B, 4, in_dim), device=dev),
                torch.ones((B, 4, hidden), device=dev))
    scale = _scale(p_drop).to(dev)
    det = (prng.as_u32(rows) >= 2 ** 31)[:, None, None]

    def factors(offset, feat):
        keep = torch.stack([_gate_mask(ks[offset + g], rows, feat, p_drop)
                            for g in range(4)], dim=1)
        f = torch.where(keep, scale, torch.zeros((), device=dev))
        return torch.where(det, torch.ones((), device=dev), f)

    return factors(0, in_dim), factors(4, hidden)


def mcd_lstm_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop: float, *,
                       h0=None, c0=None, lengths=None):
    """Plain PyTorch version of the kernel: a Python loop over T.

    Same contract as :func:`mcd_lstm_seq`.  The gate products are written as
    a loop of elementwise multiply-adds over the contraction index (x side,
    then h side, then the bias), the kernel's order; elementwise ops give
    every row the same result whatever the batch around it, so chunked ==
    unchunked holds bit for bit here too.
    """
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    x_seq = x_seq.float()
    fx, fh = gate_mask_factors(keys, rows, I, H, p_drop)
    h = (torch.zeros((B, H), device=dev) if h0 is None else h0.float())
    c = (torch.zeros((B, H), device=dev) if c0 is None else c0.float())
    lens = (torch.full((B,), T, device=dev) if lengths is None
            else lengths.to(dev))
    wx, wh, b = wx.float(), wh.float(), b.float()
    ys = []
    for t in range(T):
        xg = x_seq[:, t, None, :] * fx          # [B, 4, I]
        hg = h[:, None, :] * fh                 # [B, 4, H]
        acc = torch.zeros((B, 4, H), device=dev)
        for i in range(I):
            acc = acc + xg[:, :, i, None] * wx[i]
        for k in range(H):
            acc = acc + hg[:, :, k, None] * wh[k]
        gates = acc + b
        ig = torch.sigmoid(gates[:, 0])
        fg = torch.sigmoid(gates[:, 1])
        gg = torch.tanh(gates[:, 2])
        og = torch.sigmoid(gates[:, 3])
        c_new = fg * c + ig * gg
        h_new = og * torch.tanh(c_new)
        live = (t < lens)[:, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


@functools.cache
def _lib():
    """The built library with its C signatures declared (first use builds)."""
    lib = build.load("mcd_lstm_seq")
    P, I32, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.mcd_lstm_seq_launch.argtypes = [P] * 11 + [I32] * 5 + [
        P, U32, ctypes.c_float, I32, P]
    lib.mcd_lstm_seq_launch.restype = ctypes.c_int
    lib.mcd_lstm_seq_masks_launch.argtypes = [P, P, P] + [I32] * 3 + [
        P, U32, ctypes.c_float, I32, P]
    lib.mcd_lstm_seq_masks_launch.restype = ctypes.c_int
    return lib


def tile_rows(in_dim: int, hidden: int) -> int:
    """Batch rows per block: ~128 threads, shrunk to fit shared memory."""
    if hidden > 1024:
        raise NotImplementedError(
            f"hidden={hidden} > 1024: one block holds whole rows (one thread "
            "per hidden unit); a cluster split of H is a later PR's")
    rows = max(1, _THREADS // hidden)
    per_row = (4 * (in_dim + hidden) + in_dim + hidden) * 4
    while rows > 1 and rows * per_row > _SMEM_DEFAULT:
        rows -= 1
    if rows * per_row > _SMEM_MAX:
        raise NotImplementedError(
            f"I={in_dim}, H={hidden}: one row's mask factors and carry need "
            f"{per_row} bytes of shared memory, above the block's limit")
    return rows


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _keys_arg(keys):
    return (ctypes.c_uint32 * 8)(*_keys8(keys))


def mcd_lstm_seq(x_seq, wx, wh, b, rows, keys, p_drop: float, *,
                 h0=None, c0=None, lengths=None):
    """Sequence-fused Bayesian LSTM layer, optionally resuming carried state.

    x_seq: [B, T, I] fp32; wx: [I, 4, H]; wh: [H, 4, H]; b: [4, H];
    rows: [B] uint32 mask row ids (int64 or int32 tensor; the student flag
    marks unmasked rows); keys: the 8 gate keys from
    :func:`repro_torch.kernels.mcd_lstm.gate_keys`.  h0 / c0 [B, H] seed
    the carry (zeros when omitted); lengths [B] freezes a row at its own
    chunk length.  Returns (ys [B, T, H], h_T [B, H], c_T [B, H]), all fp32;
    ``ys[:, t >= lengths[row]]`` repeats the frozen h.

    CPU tensors run :func:`mcd_lstm_seq_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``mcd_lstm_seq.launches``).
    """
    if x_seq.device.type == "cpu":
        return mcd_lstm_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop,
                                  h0=h0, c0=c0, lengths=lengths)
    if x_seq.device.type != "cuda":
        raise ValueError(f"mcd_lstm_seq runs on cpu or cuda, "
                         f"got {x_seq.device}")
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must be in [0, 1), got {p_drop}")
    if x_seq.ndim != 3 or x_seq.shape[0] < 1 or x_seq.shape[1] < 1:
        raise ValueError(f"x_seq must be [B>=1, T>=1, I], "
                         f"got {tuple(x_seq.shape)}")
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    f32 = torch.float32
    _check("x_seq", x_seq, dev, f32, (B, T, I))
    _check("wx", wx, dev, f32, (I, 4, H))
    _check("wh", wh, dev, f32, (H, 4, H))
    _check("b", b, dev, f32, (4, H))
    if rows.device != dev or rows.shape != (B,):
        raise ValueError(f"rows must be [{B}] on {dev}")
    rows32 = (rows if rows.dtype == torch.int32
              else rows_to_int32(rows)).contiguous()
    h0 = torch.zeros((B, H), device=dev) if h0 is None else h0
    c0 = torch.zeros((B, H), device=dev) if c0 is None else c0
    _check("h0", h0, dev, f32, (B, H))
    _check("c0", c0, dev, f32, (B, H))
    if lengths is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        if lengths.device != dev or lengths.shape != (B,):
            raise ValueError(f"lengths must be [{B}] on {dev}")
        lens = lengths.to(torch.int32).contiguous()
    R = tile_rows(I, H)
    ys = torch.empty((B, T, H), device=dev)
    hT = torch.empty((B, H), device=dev)
    cT = torch.empty((B, H), device=dev)
    masked = p_drop > 0.0
    scale = float(_scale(p_drop)) if masked else 1.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().mcd_lstm_seq_launch(
        x_seq.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
        rows32.data_ptr(), lens.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, I, H, R,
        _keys_arg(keys), prng.bernoulli_keep_threshold(p_drop), scale,
        int(masked), stream)
    if err != 0:
        raise RuntimeError(f"mcd_lstm_seq kernel launch failed: CUDA error "
                           f"{err} (B={B}, T={T}, I={I}, H={H}, R={R})")
    mcd_lstm_seq.launches += 1
    return ys, hT, cT


mcd_lstm_seq.launches = 0


def kernel_mask_factors(keys, rows: torch.Tensor, in_dim: int, hidden: int,
                        p_drop: float):
    """The mask factors the CUDA kernel computes, exported from the card.

    For holding the kernel's mask bits against :func:`gate_mask_factors`;
    CUDA tensors only, and not counted as a layer launch.
    """
    if rows.device.type != "cuda":
        raise ValueError("kernel_mask_factors needs rows on a CUDA device")
    dev = rows.device
    B = rows.shape[0]
    rows32 = rows_to_int32(rows)
    fx = torch.empty((B, 4, in_dim), device=dev)
    fh = torch.empty((B, 4, hidden), device=dev)
    masked = p_drop > 0.0
    err = _lib().mcd_lstm_seq_masks_launch(
        rows32.data_ptr(), fx.data_ptr(), fh.data_ptr(), B, in_dim, hidden,
        _keys_arg(keys), prng.bernoulli_keep_threshold(p_drop),
        float(_scale(p_drop)) if masked else 1.0, int(masked),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mask export kernel launch failed: CUDA error "
                           f"{err}")
    return fx, fh
