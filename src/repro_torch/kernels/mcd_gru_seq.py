"""Sequence-fused Bayesian GRU layer — port of ``repro.kernels.mcd_gru_seq``.

:func:`mcd_gru_seq` launches the hand-written CUDA kernel
``csrc/mcd_gru_seq.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`mcd_gru_seq_plain`, the plain
PyTorch version of the same function, for CPU tensors.  A CUDA tensor never
reaches the plain version: it launches the kernel or raises.

The GRU's whole recurrent state is ``h``: one carried operand in, one out.
:func:`gru_seq_plan` (:func:`repro_torch.kernels.common.seq_plan`, shared
with the LSTM) picks the kernel's path (a warp per 32/H rows for H that
divides 32, else a block per row tile, and for a layer no block holds --
H above 1024, or an input too wide for a block's shared memory -- a
thread block cluster per row tile, the cluster split of H), the rows a
block and the shared memory.  The kernel's design notes are at the top of the ``.cu``
source.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import gate_mask_factors
from repro_torch.kernels.mcd_gru import GATES, gru_update_plain


def mcd_gru_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop: float, *,
                      h0=None, lengths=None, weight_bits=None,
                      wx_scale=None, wh_scale=None):
    """Plain PyTorch version of the kernel: a Python loop over T.

    Same contract as :func:`mcd_gru_seq`, with the kernel's per-row
    summation order and roundings
    (:func:`repro_torch.kernels.mcd_gru.gru_update_plain`), so chunked ==
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
    lens = (torch.full((B,), T, device=dev) if lengths is None
            else lengths.to(dev))
    wx, wh = common.plain_weights(wx, wh, act, H, weight_bits, wx_scale,
                                  wh_scale)
    b = b.float()
    gx = common.x_side_sums(x_seq, fx, wx)     # every step's x side
    ys = []
    for t in range(T):
        h_new = gru_update_plain(x_seq[:, t], h, h, fx, fh, wx, wh, b,
                                 gx=gx[:, t])
        h = torch.where((t < lens)[:, None], h_new, h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


X_RING = common.X_RING     # x_t slots a row on the warp path (kXRing)


def gru_seq_plan(batch: int, in_dim: int, hidden: int,
                 act_bytes: int = 4) -> dict:
    """How ``csrc/mcd_gru_seq.cu`` runs a layer (:func:`common.seq_plan`
    with the GRU's 3 gates) at an activation width of ``act_bytes``: its
    path, the rows a block, the threads and blocks, and the shared memory a
    block needs."""
    return common.seq_plan(GATES, batch, in_dim, hidden, act_bytes)


def mcd_gru_seq(x_seq, wx, wh, b, rows, keys, p_drop: float, *, h0=None,
                lengths=None, weight_bits=None, wx_scale=None,
                wh_scale=None):
    """Sequence-fused Bayesian GRU layer, optionally resuming carried state.

    x_seq: [B, T, I] in the activation dtype (fp32, or bf16 under a serving
    precision); wx: [I, 3, H]; wh: [H, 3, H] in the activation dtype, or,
    with ``weight_bits`` 8 / 4 (over bf16 activations), int8 codes or int4
    codes nibble-packed into uint8 (last axis ``ceil(H/2)``) with the
    [3, H] fp32 scales ``wx_scale`` / ``wh_scale``, dequantized once at
    kernel entry; b: [3, H] fp32; rows: [B] uint32 mask row ids (int64 or
    int32 tensor; the student flag marks unmasked rows); keys: the 6 gate
    keys from :func:`repro_torch.kernels.mcd_gru.gate_keys`.  h0 [B, H]
    (activation dtype) seeds the carry (zeros when omitted); lengths [B]
    freezes a row at its own chunk length.  Returns (ys [B, T, H], h_T
    [B, H]) in the activation dtype; ``ys[:, t >= lengths[row]]`` repeats
    the frozen h.

    CPU tensors run :func:`mcd_gru_seq_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``mcd_gru_seq.launches``).
    """
    qkw = dict(weight_bits=weight_bits, wx_scale=wx_scale,
               wh_scale=wh_scale)
    common.refuse_grad("mcd_gru_seq", x_seq, wx, wh, b, h0, wx_scale,
                       wh_scale)
    if common.check_device("mcd_gru_seq", x_seq):
        return mcd_gru_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop,
                                 h0=h0, lengths=lengths, **qkw)
    common.check_p(p_drop)
    if x_seq.ndim != 3 or x_seq.shape[0] < 1 or x_seq.shape[1] < 1:
        raise ValueError(f"x_seq must be [B>=1, T>=1, I], "
                         f"got {tuple(x_seq.shape)}")
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    act = common.check_act("x_seq", x_seq)
    h0 = torch.zeros((B, H), dtype=act, device=dev) if h0 is None else h0
    common.check("x_seq", x_seq, dev, act, (B, T, I))
    common.check_seq_weights(GATES, dev, act, I, H, wx, wh, b, **qkw)
    common.check("h0", h0, dev, act, (B, H))
    rows32 = common.rows_arg(rows, B, dev)
    lens = common.lengths_arg(lengths, B, T, dev)
    ys = torch.empty((B, T, H), dtype=act, device=dev)
    hT = torch.empty((B, H), dtype=act, device=dev)
    common.seq_launch(mcd_gru_seq,
                      (x_seq, wx, wh, wx_scale, wh_scale, b, rows32, lens,
                       h0, ys, hT),
                      B, T, I, H, GATES, keys, p_drop, act, weight_bits)
    return ys, hT


mcd_gru_seq.launches = 0
