"""Fused Bayesian LSTM step — port of ``repro.kernels.mcd_lstm``.

:func:`mcd_lstm_step` launches the hand-written CUDA kernel
``csrc/mcd_lstm_step.cu`` (built for ``sm_90a`` by :mod:`.build`, bound
with ``ctypes``) for CUDA tensors, and runs :func:`mcd_lstm_step_plain`,
the plain PyTorch version of the same function, for CPU tensors.  A CUDA
tensor never reaches the plain version: it launches the kernel or raises.

Also here, shared with the sequence kernel: the 8 stream keys
(:func:`gate_keys`), the mask rule (:func:`_gate_mask`) and the plain cell
body (:func:`lstm_cell_plain`).
"""

from __future__ import annotations

import torch

from repro_torch.core import mcd, prng
from repro_torch.kernels import common
from repro_torch.kernels.common import gate_mask as _gate_mask  # noqa: F401

GATES = 4


def gate_keys(seed, layer) -> torch.Tensor:
    """The 8 per-gate stream keys (x-side then h-side): [1, 8] int64 (uint32
    values) on the CPU, since kernels take them as launch arguments."""
    ks = [mcd.mask_key(seed, layer, mcd.KIND_X, g) for g in range(4)] + \
         [mcd.mask_key(seed, layer, mcd.KIND_H, g) for g in range(4)]
    return torch.stack([prng.as_u32(k) for k in ks]).reshape(1, 8)


def lstm_cell_plain(x, h, c, fx, fh, wx, wh, b, gx=None):
    """One step of the kernels' LSTM body on mask factors, in plain PyTorch.

    x [B, I]; h [B, H] in the activation dtype (fp32 or bf16); c [B, H]
    fp32; fx [B, 4, I], fh [B, 4, H] from
    :func:`repro_torch.kernels.common.gate_mask_factors` in the activation
    dtype; wx [I, 4, H], wh [H, 4, H] fp32 (at bf16: bf16 values); b
    [4, H] fp32.  The masked views are rounded to the activation dtype
    (:func:`repro_torch.kernels.common.masked_view`); the gate products are
    a loop of elementwise fp32 multiply-adds over the contraction index (x
    side, then h side, then the bias), the kernels' order, and the
    activations run row by row (:func:`repro_torch.kernels.common.rowwise`),
    so every row's result is the same whatever the batch around it.
    ``gx``: the x-side sums already taken (:func:`repro_torch.kernels.
    common.x_side_sums`, as the sequence's plain version takes them for
    every step at once).  Returns (h_new in h's dtype, c_new fp32).
    """
    acc = common.x_side_sums(x, fx, wx) if gx is None else gx
    hg = common.masked_view(h, fh)              # [B, 4, H]
    for k in range(wh.shape[0]):
        acc = acc + hg[:, :, k, None] * wh[k]
    gates = acc + b
    ig = common.rowwise(torch.sigmoid, gates[:, 0])
    fg = common.rowwise(torch.sigmoid, gates[:, 1])
    gg = common.rowwise(torch.tanh, gates[:, 2])
    og = common.rowwise(torch.sigmoid, gates[:, 3])
    c_new = fg * c + ig * gg
    h_new = og * common.rowwise(torch.tanh, c_new)
    return h_new.to(h.dtype), c_new


def mcd_lstm_step_plain(x, h, c, wx, wh, b, rows, keys, p_drop: float):
    """Plain PyTorch version of the step kernel; same contract as
    :func:`mcd_lstm_step`."""
    act = common.act_dtype_of(x)
    fx, fh = common.gate_mask_factors(keys, rows, x.shape[1], wh.shape[0],
                                      p_drop, act)
    return lstm_cell_plain(x.to(act), h.to(act), c.float(), fx, fh,
                           wx.to(act).float(), wh.to(act).float(), b.float())


def mcd_lstm_step(x, h, c, wx, wh, b, rows, keys, p_drop: float):
    """Fused Bayesian LSTM step.

    x: [B, I]; h: [B, H]; wx: [I, 4, H]; wh: [H, 4, H], all in the
    activation dtype (fp32, or bf16 under a serving precision: the int8 /
    int4 weights arrive dequantized, as in the reference); c: [B, H] and
    b: [4, H] fp32; rows: [B] uint32 mask row ids (int64 or int32 tensor;
    the student flag marks unmasked rows); keys: the 8 keys from
    :func:`gate_keys`.  Masks are rebuilt from the keys at every call.
    Returns (h_new [B, H] in the activation dtype, c_new [B, H] fp32).

    CPU tensors run :func:`mcd_lstm_step_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``mcd_lstm_step.launches``) on
    the path :func:`repro_torch.kernels.common.step_plan` picks: the warp
    path for H that divides 32, else the block path, and the split path
    for a layer the block path cannot take.
    """
    common.refuse_grad("mcd_lstm_step", x, h, c, wx, wh, b)
    if common.check_device("mcd_lstm_step", x):
        return mcd_lstm_step_plain(x, h, c, wx, wh, b, rows, keys, p_drop)
    common.check_p(p_drop)
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [B>=1, I], got {tuple(x.shape)}")
    B, I = x.shape
    H = wh.shape[0]
    dev = x.device
    act = common.check_act("x", x)
    f32 = torch.float32
    for name, t, dtype, shape in (("x", x, act, (B, I)),
                                  ("h", h, act, (B, H)),
                                  ("c", c, f32, (B, H)),
                                  ("wx", wx, act, (I, 4, H)),
                                  ("wh", wh, act, (H, 4, H)),
                                  ("b", b, f32, (4, H))):
        common.check(name, t, dev, dtype, shape)
    rows32 = common.rows_arg(rows, B, dev)
    h_out = torch.empty((B, H), dtype=act, device=dev)
    c_out = torch.empty((B, H), device=dev)
    common.step_launch(mcd_lstm_step,
                       (x, h, c, wx, wh, b, rows32, h_out, c_out), B, I, H,
                       GATES, keys, p_drop, act)
    return h_out, c_out


mcd_lstm_step.launches = 0
