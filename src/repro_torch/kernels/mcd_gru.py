"""Fused Bayesian GRU step — port of ``repro.kernels.mcd_gru``.

:func:`mcd_gru_step` launches the hand-written CUDA kernel
``csrc/mcd_gru_step.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`mcd_gru_step_plain`, the
plain PyTorch version of the same function, for CPU tensors.  A CUDA tensor
never reaches the plain version: it launches the kernel or raises.

Also here, shared with the sequence kernel: the 6 stream keys
(:func:`gate_keys`: x side r, z, n, then h side r, z, n) and the plain GRU
body (:func:`gru_update_plain`, the reference's ``_gru_update``).
"""

from __future__ import annotations

import torch

from repro_torch.core import mcd, prng
from repro_torch.kernels import common

GATES = 3


def gate_keys(seed, layer) -> torch.Tensor:
    """The 6 per-gate stream keys (x-side then h-side): [1, 6] int64 (uint32
    values) on the CPU, since kernels take them as launch arguments."""
    ks = [mcd.mask_key(seed, layer, mcd.KIND_X, g) for g in range(3)] + \
         [mcd.mask_key(seed, layer, mcd.KIND_H, g) for g in range(3)]
    return torch.stack([prng.as_u32(k) for k in ks]).reshape(1, 6)


def gru_update_plain(x, h, h_prev, fx, fh, wx, wh, b, gx=None):
    """The kernels' GRU body on mask factors, in plain PyTorch.

    x [B, I]; h [B, H] feeds the recurrent products (the full row); h_prev
    [B, H] feeds the ``z·h`` update; x, h, h_prev in the activation dtype
    (fp32 or bf16); fx [B, 3, I], fh [B, 3, H] from
    :func:`repro_torch.kernels.common.gate_mask_factors` in the activation
    dtype; wx [I, 3, H], wh [H, 3, H] fp32 (at bf16: bf16 values); b
    [3, H] fp32.  The masked views are rounded to the activation dtype
    (:func:`repro_torch.kernels.common.masked_view`).  The x-side and
    h-side sums stay apart — the reset gate scales the h-side candidate sum
    alone, before the candidate bias lands — and each is a loop of
    elementwise fp32 multiply-adds over the contraction index, the kernels'
    order; ``r * gh[2]`` and ``z * h_prev`` are fp32 products of the
    activation-dtype h; the activations run row by row
    (:func:`repro_torch.kernels.common.rowwise`), so every row's result is
    the same whatever the batch around it.  ``gx``: the x-side sums
    already taken (:func:`repro_torch.kernels.common.x_side_sums`, as the
    sequence's plain version takes them for every step at once).  Returns
    h_new in h_prev's dtype (rounded once, at the end).
    """
    if gx is None:
        gx = common.x_side_sums(x, fx, wx)      # [B, 3, H]
    hg = common.masked_view(h, fh)              # [B, 3, H]
    gh = torch.zeros_like(gx)
    for k in range(wh.shape[0]):
        gh = gh + hg[:, :, k, None] * wh[k]
    r = common.rowwise(torch.sigmoid, gx[:, 0] + gh[:, 0] + b[0])
    z = common.rowwise(torch.sigmoid, gx[:, 1] + gh[:, 1] + b[1])
    n = common.rowwise(torch.tanh, gx[:, 2] + r * gh[:, 2] + b[2])
    h_new = (1.0 - z) * n + z * h_prev.to(gx.dtype)
    return h_new.to(h_prev.dtype)


def mcd_gru_step_plain(x, h, wx, wh, b, rows, keys, p_drop: float):
    """Plain PyTorch version of the step kernel; same contract as
    :func:`mcd_gru_step`."""
    act = common.act_dtype_of(x)
    fx, fh = common.gate_mask_factors(keys, rows, x.shape[1], wh.shape[0],
                                      p_drop, act)
    h = h.to(act)
    return gru_update_plain(x.to(act), h, h, fx, fh, wx.to(act).float(),
                            wh.to(act).float(), b.float())


def mcd_gru_step(x, h, wx, wh, b, rows, keys, p_drop: float):
    """Fused Bayesian GRU step.

    x: [B, I]; h: [B, H]; wx: [I, 3, H]; wh: [H, 3, H], all in the
    activation dtype (fp32, or bf16 under a serving precision: the int8 /
    int4 weights arrive dequantized, as in the reference); b: [3, H] fp32;
    rows: [B] uint32 mask row ids (int64 or int32 tensor; the student flag
    marks unmasked rows); keys: the 6 keys from :func:`gate_keys`.  Masks
    are rebuilt from the keys at every call.  Returns h_new [B, H] in the
    activation dtype.

    CPU tensors run :func:`mcd_gru_step_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``mcd_gru_step.launches``) on
    the path :func:`repro_torch.kernels.common.step_plan` picks: the warp
    path for H that divides 32, else the block path, and the split path
    for a layer the block path cannot take.
    """
    common.refuse_grad("mcd_gru_step", x, h, wx, wh, b)
    if common.check_device("mcd_gru_step", x):
        return mcd_gru_step_plain(x, h, wx, wh, b, rows, keys, p_drop)
    common.check_p(p_drop)
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [B>=1, I], got {tuple(x.shape)}")
    B, I = x.shape
    H = wh.shape[0]
    dev = x.device
    act = common.check_act("x", x)
    for name, t, dtype, shape in (("x", x, act, (B, I)),
                                  ("h", h, act, (B, H)),
                                  ("wx", wx, act, (I, 3, H)),
                                  ("wh", wh, act, (H, 3, H)),
                                  ("b", b, torch.float32, (3, H))):
        common.check(name, t, dev, dtype, shape)
    rows32 = common.rows_arg(rows, B, dev)
    h_out = torch.empty((B, H), dtype=act, device=dev)
    common.step_launch(mcd_gru_step, (x, h, wx, wh, b, rows32, h_out), B, I,
                       H, GATES, keys, p_drop, act)
    return h_out


mcd_gru_step.launches = 0
