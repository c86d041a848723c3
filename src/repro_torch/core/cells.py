"""LSTM / GRU cells with the paper's per-gate MCD mask views — port of
``repro.core.cells``.

Weights are stored as ``[G, in, hidden]`` stacks (gate axis first; G=4 for
the LSTM, 3 for the GRU), the reference's layout; :func:`gate_stacked`
gives the kernel layout ``[in, G, hidden]``.  The LSTM cell state ``c`` is
accumulated in fp32; the GRU's whole carry is ``h``, in the activation
dtype, rounded at every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import mcd
from repro_torch.kernels import common


class LSTMParams(NamedTuple):
    wx: torch.Tensor  # [4, in_dim, hidden]
    wh: torch.Tensor  # [4, hidden, hidden]
    b: torch.Tensor   # [4, hidden]


def _uniform(generator, shape, bound, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return u * (2 * bound) - bound


def init_lstm(generator: torch.Generator, in_dim: int, hidden: int,
              dtype=torch.float32, device=None) -> LSTMParams:
    sx = (6.0 / (in_dim + hidden)) ** 0.5
    sh = (6.0 / (2 * hidden)) ** 0.5
    wx = _uniform(generator, (4, in_dim, hidden), sx, dtype)
    wh = _uniform(generator, (4, hidden, hidden), sh, dtype)
    b = torch.zeros((4, hidden), dtype=dtype)
    b[1] = 1.0    # forget-gate bias 1.0 (standard recurrent practice)
    return LSTMParams(wx.to(device), wh.to(device), b.to(device))


def freeze_rows(t: int, lengths: torch.Tensor, h_new, c_new, h_old, c_old):
    """Per-row streaming freeze: keep the old carry once ``t >= lengths``."""
    live = (t < lengths)[:, None]
    return torch.where(live, h_new, h_old), torch.where(live, c_new, c_old)


def freeze_rows_h(t: int, lengths: torch.Tensor, h_new, h_old):
    """:func:`freeze_rows` for cells whose carry is ``h`` alone (GRU)."""
    return torch.where((t < lengths)[:, None], h_new, h_old)


def gate_stacked(params):
    """Kernel weight layout: ``[G, in, H] → ([in, G, H], [H, G, H], b)``,
    for :class:`LSTMParams` (G=4) and :class:`GRUParams` (G=3) alike."""
    return (params.wx.transpose(0, 1).contiguous(),
            params.wh.transpose(0, 1).contiguous(), params.b.contiguous())


def _gate_sums(views: torch.Tensor, w: torch.Tensor):
    """The gate products ``[B, G, K] = sum_i views[:, :, i] * w[:, i]`` in
    fp32, as the reference's ``einsum(..., preferred_element_type=
    float32)``: the weights cast to the views' (activation) dtype, then
    both operands upcast to fp32 -- a bf16 matmul in PyTorch would round
    its result to bf16 -- so the products are exact at bf16 and the sums
    accumulate in fp32.  The sum runs over the contraction index in order,
    one elementwise multiply-add at a time, so a row's result does not
    depend on the rows around it: a batched matmul picks its blocking (and,
    below 400 multiply-adds a matrix, a loop of its own) from the batch's
    row count, and a fleet's tenant would round otherwise in a shared
    launch than alone."""
    v = views.float()
    wf = w.to(views.dtype).float()
    acc = v[:, :, 0, None] * wf[:, 0]
    for i in range(1, wf.shape[1]):
        acc = acc + v[:, :, i, None] * wf[:, i]
    return acc


def lstm_step(params: LSTMParams, h: torch.Tensor, c: torch.Tensor,
              x: torch.Tensor, zx: torch.Tensor | None,
              zh: torch.Tensor | None, p: float,
              det: torch.Tensor | None = None,
              span: tuple[int, int] | None = None):
    """One LSTM time step with per-gate MCD masks.

    h, c: [B, H] carry; x: [B, I]; zx: [B, 4, I] / zh: [B, 4, H] keep-masks
    or None; det: [B] bool — True rows run deterministic (no mask·scale).
    Returns (h_new, c_new); the gate sums and c accumulate in fp32, h_new
    returns in h's dtype and c_new in c's (fp32 under a serving
    precision).

    ``span=(lo, H)``: ``params`` hold the output columns ``lo .. lo + n``
    of every gate and ``c`` those columns of the cell state (``h`` stays
    whole: it is a contraction operand); returns the slice's ``h_new`` and
    ``c_new``, each element the unsliced step's (``common.rowwise``).
    """
    wx, wh, b = params
    xr = x[:, None, :].expand(x.shape[0], 4, x.shape[1])
    hr = h[:, None, :].expand(h.shape[0], 4, h.shape[1])
    xg = mcd.apply_mask(xr, zx, p)
    hg = mcd.apply_mask(hr, zh, p)
    if det is not None:
        xg = torch.where(det[:, None, None], xr, xg)
        hg = torch.where(det[:, None, None], hr, hg)
    gates = _gate_sums(xg, wx) + _gate_sums(hg, wh) + b.float()
    i = common.rowwise(torch.sigmoid, gates[:, 0], span)
    f = common.rowwise(torch.sigmoid, gates[:, 1], span)
    g = common.rowwise(torch.tanh, gates[:, 2], span)
    o = common.rowwise(torch.sigmoid, gates[:, 3], span)
    c_new = f * c.float() + i * g
    h_new = (o * common.rowwise(torch.tanh, c_new, span)).to(h.dtype)
    return h_new, c_new.to(c.dtype)


class GRUParams(NamedTuple):
    wx: torch.Tensor  # [3, in_dim, hidden]
    wh: torch.Tensor  # [3, hidden, hidden]
    b: torch.Tensor   # [3, hidden]


def init_gru(generator: torch.Generator, in_dim: int, hidden: int,
             dtype=torch.float32, device=None) -> GRUParams:
    sx = (6.0 / (in_dim + hidden)) ** 0.5
    sh = (6.0 / (2 * hidden)) ** 0.5
    wx = _uniform(generator, (3, in_dim, hidden), sx, dtype)
    wh = _uniform(generator, (3, hidden, hidden), sh, dtype)
    return GRUParams(wx.to(device), wh.to(device),
                     torch.zeros((3, hidden), dtype=dtype, device=device))


def gru_step(params: GRUParams, h: torch.Tensor, x: torch.Tensor,
             zx: torch.Tensor | None, zh: torch.Tensor | None, p: float,
             det: torch.Tensor | None = None,
             span: tuple[int, int] | None = None) -> torch.Tensor:
    """One GRU time step with per-gate MCD masks (gate order r, z, n).

    h: [B, H] carry (the GRU's whole recurrent state); x: [B, I];
    zx: [B, 3, I] / zh: [B, 3, H] keep-masks or None; det: [B] bool — True
    rows run deterministic.  The reset gate scales the recurrent candidate
    sum before the candidate bias is added.  Returns h_new in h's dtype.
    ``span=(lo, H)``: ``params`` hold the output columns ``lo .. lo + n``
    of every gate; returns those columns of ``h_new`` (see
    :func:`lstm_step`).
    """
    wx, wh, b = params
    xr = x[:, None, :].expand(x.shape[0], 3, x.shape[1])
    hr = h[:, None, :].expand(h.shape[0], 3, h.shape[1])
    xg = mcd.apply_mask(xr, zx, p)
    hg = mcd.apply_mask(hr, zh, p)
    if det is not None:
        xg = torch.where(det[:, None, None], xr, xg)
        hg = torch.where(det[:, None, None], hr, hg)
    gx = _gate_sums(xg, wx)
    gh = _gate_sums(hg, wh)
    bf = b.float()
    r = common.rowwise(torch.sigmoid, gx[:, 0] + gh[:, 0] + bf[0], span)
    zt = common.rowwise(torch.sigmoid, gx[:, 1] + gh[:, 1] + bf[1], span)
    n = common.rowwise(torch.tanh, gx[:, 2] + r * gh[:, 2] + bf[2], span)
    hs = h if span is None else h[:, span[0]:span[0] + n.shape[1]]
    h_new = (1.0 - zt) * n + zt * hs.float()
    return h_new.to(h.dtype)
