"""Sequence-fused Bayesian GRU layer — port of ``repro.kernels.mcd_gru_seq``.

:func:`mcd_gru_seq` launches the hand-written CUDA kernel
``csrc/mcd_gru_seq.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`mcd_gru_seq_plain`, the plain
PyTorch version of the same function, for CPU tensors.  A CUDA tensor never
reaches the plain version: it launches the kernel or raises.

The GRU's whole recurrent state is ``h``: one carried operand in, one out.
:func:`gru_seq_plan` picks the kernel's path (a warp per 32/H rows for H
that divides 32, else a block per row tile), the rows a block and the
shared memory.  The kernel's design notes are at the top of the ``.cu``
source.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import gate_mask_factors
from repro_torch.kernels.mcd_gru import GATES, gru_update_plain


def mcd_gru_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop: float, *,
                      h0=None, lengths=None):
    """Plain PyTorch version of the kernel: a Python loop over T.

    Same contract as :func:`mcd_gru_seq`, with the kernel's per-row
    summation order (:func:`repro_torch.kernels.mcd_gru.gru_update_plain`),
    so chunked == unchunked holds bit for bit here too.
    """
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    x_seq = x_seq.float()
    fx, fh = gate_mask_factors(keys, rows, I, H, p_drop)
    h = (torch.zeros((B, H), device=dev) if h0 is None else h0.float())
    lens = (torch.full((B,), T, device=dev) if lengths is None
            else lengths.to(dev))
    wx, wh, b = wx.float(), wh.float(), b.float()
    ys = []
    for t in range(T):
        h_new = gru_update_plain(x_seq[:, t], h, h, fx, fh, wx, wh, b)
        h = torch.where((t < lens)[:, None], h_new, h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


_WARP_BLOCKS = (4, 2, 1)   # warps a block on the warp path, largest first
X_RING = 8                 # x_t slots a row on the warp path (kXRing)


def gru_seq_plan(batch: int, in_dim: int, hidden: int) -> dict:
    """How ``csrc/mcd_gru_seq.cu`` runs a layer: its path, the rows a block,
    the threads and blocks, and the shared memory a block needs.

    H that divides 32 takes the warp path: a row's H units are H lanes of
    one warp, ``32 // H`` rows a warp, 4, 2 or 1 warps a block -- the most
    that still make two blocks an SM, so the rows spread over every SM --
    with the layer's wx, the rows' mask factors and a ring of ``X_RING`` x
    steps a row in shared memory.  Every other H takes the block path (one thread
    per (row, unit), :func:`repro_torch.kernels.common.tile_rows` rows a
    block), and so does an input too wide for the warp path's shared
    memory (its wx alone: ``12 * I * H`` bytes); both paths compute the
    same bits.  Raises ``NotImplementedError`` where neither fits.
    """
    if min(batch, in_dim, hidden) < 1:
        raise ValueError(f"empty layer: B={batch}, I={in_dim}, H={hidden}")
    if 32 % hidden == 0:
        per_warp = 32 // hidden
        warps = -(-batch // per_warp)
        fits = []
        for wpb in _WARP_BLOCKS:
            rows = wpb * per_warp
            smem = 4 * (rows * (GATES * (in_dim + hidden) + X_RING * in_dim)
                        + GATES * in_dim * hidden)
            if smem <= common.SMEM_MAX:
                fits.append((wpb, rows, smem))
        if fits:
            wpb, rows, smem = next((f for f in fits
                                    if -(-warps // f[0]) >= 2 * common.SMS),
                                   fits[-1])
            return {"path": "warp", "rows": rows, "threads": 32 * wpb,
                    "blocks": -(-batch // rows), "smem": smem}
    rows = common.tile_rows(GATES, in_dim, hidden)
    return {"path": "block", "rows": rows, "threads": rows * hidden,
            "blocks": -(-batch // rows),
            "smem": 4 * rows * (GATES * (in_dim + hidden) + in_dim + hidden)}


def mcd_gru_seq(x_seq, wx, wh, b, rows, keys, p_drop: float, *, h0=None,
                lengths=None):
    """Sequence-fused Bayesian GRU layer, optionally resuming carried state.

    x_seq: [B, T, I] fp32; wx: [I, 3, H]; wh: [H, 3, H]; b: [3, H];
    rows: [B] uint32 mask row ids (int64 or int32 tensor; the student flag
    marks unmasked rows); keys: the 6 gate keys from
    :func:`repro_torch.kernels.mcd_gru.gate_keys`.  h0 [B, H] seeds the
    carry (zeros when omitted); lengths [B] freezes a row at its own chunk
    length.  Returns (ys [B, T, H], h_T [B, H]), fp32;
    ``ys[:, t >= lengths[row]]`` repeats the frozen h.

    CPU tensors run :func:`mcd_gru_seq_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``mcd_gru_seq.launches``).
    """
    if common.check_device("mcd_gru_seq", x_seq):
        return mcd_gru_seq_plain(x_seq, wx, wh, b, rows, keys, p_drop,
                                 h0=h0, lengths=lengths)
    common.check_p(p_drop)
    if x_seq.ndim != 3 or x_seq.shape[0] < 1 or x_seq.shape[1] < 1:
        raise ValueError(f"x_seq must be [B>=1, T>=1, I], "
                         f"got {tuple(x_seq.shape)}")
    B, T, I = x_seq.shape
    H = wh.shape[0]
    dev = x_seq.device
    h0 = torch.zeros((B, H), device=dev) if h0 is None else h0
    for name, t, shape in (("x_seq", x_seq, (B, T, I)),
                           ("wx", wx, (I, 3, H)), ("wh", wh, (H, 3, H)),
                           ("b", b, (3, H)), ("h0", h0, (B, H))):
        common.check(name, t, dev, torch.float32, shape)
    rows32 = common.rows_arg(rows, B, dev)
    lens = common.lengths_arg(lengths, B, T, dev)
    plan = gru_seq_plan(B, I, H)
    ys = torch.empty((B, T, H), device=dev)
    hT = torch.empty((B, H), device=dev)
    common.launch(mcd_gru_seq, (x_seq, wx, wh, b, rows32, lens, h0, ys, hT),
                  (B, T, I, H, plan["rows"], int(plan["path"] == "warp"),
                   plan["smem"]), keys, 6, p_drop,
                  f"mcd_gru_seq (B={B}, T={T}, I={I}, H={H}, "
                  f"{plan['path']} path, R={plan['rows']})")
    return ys, hT


mcd_gru_seq.launches = 0

