"""Sequence-fused Bayesian LSTM layer — port of ``repro.kernels.mcd_lstm_seq``.

:func:`mcd_lstm_seq` launches the hand-written CUDA kernel
``csrc/mcd_lstm_seq.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`mcd_lstm_seq_plain`, the plain
PyTorch version of the same function, for CPU tensors.  A CUDA tensor never
reaches the plain version: it launches the kernel or raises.

:func:`lstm_seq_plan` (:func:`repro_torch.kernels.common.seq_plan`, shared
with the GRU) picks the kernel's path (a warp per 32/H rows for H that
divides 32, else a block per row tile, and for a layer no block holds --
H above 1024, or an input too wide for a block's shared memory -- a
thread block cluster per row tile, the cluster split of H), the rows a
block and the shared memory.  The kernel's design notes (what bounds it on an H100 and what is
left for a later PR) are at the top of the ``.cu`` source.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import (gate_mask_factors,  # noqa: F401
                                        rows_to_int32)
from repro_torch.kernels.mcd_lstm import GATES, lstm_cell_plain


def mcd_lstm_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop: float, *,
                       h0=None, c0=None, lengths=None, weight_bits=None,
                       wx_scale=None, wh_scale=None):
    """Plain PyTorch version of the kernel: a Python loop over T.

    Same contract as :func:`mcd_lstm_seq`, with the kernel's per-row
    summation order and roundings
    (:func:`repro_torch.kernels.mcd_lstm.lstm_cell_plain`): every row's
    result is the same whatever the batch around it, so chunked ==
    unchunked holds bit for bit here too.
    """
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    act = common.act_dtype_of(x_seq)
    x_seq = x_seq.to(act)
    fx, fh = gate_mask_factors(keys, rows, I, H, p_drop, act)
    h = (torch.zeros((B, H), dtype=act, device=dev) if h0 is None
         else h0.to(act))
    c = (torch.zeros((B, H), device=dev) if c0 is None else c0.float())
    lens = (torch.full((B,), T, device=dev) if lengths is None
            else lengths.to(dev))
    wx, wh = common.plain_weights(wx, wh, act, H, weight_bits, wx_scale,
                                  wh_scale)
    b = b.float()
    gx = common.x_side_sums(x_seq, fx, wx)     # every step's x side
    ys = []
    for t in range(T):
        h_new, c_new = lstm_cell_plain(x_seq[:, t], h, c, fx, fh, wx, wh, b,
                                       gx=gx[:, t])
        live = (t < lens)[:, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


X_RING = common.X_RING     # x_t slots a row on the warp path (kXRing)


def tile_rows(in_dim: int, hidden: int) -> int:
    """Batch rows per block on the block path: ~128 threads, shrunk to fit
    shared memory."""
    return common.tile_rows(GATES, in_dim, hidden)


def lstm_seq_plan(batch: int, in_dim: int, hidden: int,
                  act_bytes: int = 4) -> dict:
    """How ``csrc/mcd_lstm_seq.cu`` runs a layer (:func:`common.seq_plan`
    with the LSTM's 4 gates) at an activation width of ``act_bytes``: its
    path (warp for H that divides 32, else block, else cluster), the rows
    a block, the threads and blocks, and the shared memory a block
    needs."""
    return common.seq_plan(GATES, batch, in_dim, hidden, act_bytes)


def mcd_lstm_seq(x_seq, wx, wh, b, rows, keys, p_drop: float, *,
                 h0=None, c0=None, lengths=None, weight_bits=None,
                 wx_scale=None, wh_scale=None):
    """Sequence-fused Bayesian LSTM layer, optionally resuming carried state.

    x_seq: [B, T, I] in the activation dtype (fp32, or bf16 under a serving
    precision); wx: [I, 4, H]; wh: [H, 4, H] in the activation dtype, or,
    with ``weight_bits`` 8 / 4 (over bf16 activations), int8 codes or int4
    codes nibble-packed into uint8 (last axis ``ceil(H/2)``) with the
    [4, H] fp32 per-output-channel scales ``wx_scale`` / ``wh_scale``, which
    the kernel dequantizes once at entry (``float32(q) * scale`` rounded to
    bf16, :func:`repro_torch.kernels.quantize.kernel_weight`); b: [4, H]
    fp32; rows: [B] uint32 mask row ids (int64 or int32 tensor; the student
    flag marks unmasked rows); keys: the 8 gate keys from
    :func:`repro_torch.kernels.mcd_lstm.gate_keys`.  h0 [B, H] (activation
    dtype) / c0 [B, H] (fp32) seed the carry (zeros when omitted); lengths
    [B] freezes a row at its own chunk length.  Returns (ys [B, T, H],
    h_T [B, H]) in the activation dtype and c_T [B, H] fp32;
    ``ys[:, t >= lengths[row]]`` repeats the frozen h.

    CPU tensors run :func:`mcd_lstm_seq_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``mcd_lstm_seq.launches``).
    """
    qkw = dict(weight_bits=weight_bits, wx_scale=wx_scale,
               wh_scale=wh_scale)
    common.refuse_grad("mcd_lstm_seq", x_seq, wx, wh, b, h0, c0, wx_scale,
                       wh_scale)
    if common.check_device("mcd_lstm_seq", x_seq):
        return mcd_lstm_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop,
                                  h0=h0, c0=c0, lengths=lengths, **qkw)
    common.check_p(p_drop)
    if x_seq.ndim != 3 or x_seq.shape[0] < 1 or x_seq.shape[1] < 1:
        raise ValueError(f"x_seq must be [B>=1, T>=1, I], "
                         f"got {tuple(x_seq.shape)}")
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    act = common.check_act("x_seq", x_seq)
    h0 = torch.zeros((B, H), dtype=act, device=dev) if h0 is None else h0
    c0 = torch.zeros((B, H), device=dev) if c0 is None else c0
    common.check("x_seq", x_seq, dev, act, (B, T, I))
    common.check_seq_weights(GATES, dev, act, I, H, wx, wh, b, **qkw)
    common.check("h0", h0, dev, act, (B, H))
    common.check("c0", c0, dev, torch.float32, (B, H))
    rows32 = common.rows_arg(rows, B, dev)
    lens = common.lengths_arg(lengths, B, T, dev)
    ys = torch.empty((B, T, H), dtype=act, device=dev)
    hT = torch.empty((B, H), dtype=act, device=dev)
    cT = torch.empty((B, H), device=dev)
    common.seq_launch(mcd_lstm_seq,
                      (x_seq, wx, wh, wx_scale, wh_scale, b, rows32, lens,
                       h0, c0, ys, hT, cT),
                      B, T, I, H, GATES, keys, p_drop, act, weight_bits)
    return ys, hT, cT


mcd_lstm_seq.launches = 0
