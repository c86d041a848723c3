"""High-level wrappers around the port's kernels — port of the LSTM part of
``repro.kernels.ops``.

Stack-layer execution paths of :func:`repro_torch.core.rnn.run_stack`, and
how they map to the reference's ``LSTM_BACKENDS`` (``repro/kernels/ops.py``):

* ``"reference"`` — plain PyTorch cells on pre-sampled masks; the
  reference's ``"reference"``.
* ``"cuda_seq"`` — the sequence-fused layer kernel
  (:func:`repro_torch.kernels.mcd_lstm_seq.mcd_lstm_seq`), one launch per
  layer with the masks rebuilt in-kernel; the reference's ``"pallas_seq"``.
  On CPU tensors it runs the kernel's plain version.

The reference's ``"pallas_step"`` (per-step kernel scanned over T) has no
counterpart yet; see ROADMAP.md.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import cells
from repro_torch.kernels import mcd_lstm, mcd_lstm_seq

LSTM_BACKENDS = ("reference", "cuda_seq")

#: Serving precisions this slice supports (``None`` = native fp32).
PRECISIONS = (None, "fp32")


def check_precision(precision) -> None:
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (only None/'fp32'); "
            "bf16/int8/int4 serving is queued in ROADMAP.md")


@functools.lru_cache(maxsize=1024)
def _gate_keys(seed: int, layer: int) -> tuple[int, ...]:
    # The hash is ~200 tiny host ops per layer; a stream's keys never change.
    return tuple(mcd_lstm.gate_keys(seed, layer).reshape(-1).tolist())


def fused_lstm_seq(wx4, wh4, b, x_seq, rows, seed, layer: int,
                   p_drop: float, h0=None, c0=None, lengths=None):
    """One kernel launch for the whole sequence.

    wx4: [I, 4, H]; wh4: [H, 4, H]; b: [4, H]; x_seq: [B, T, I].
    Returns (outputs [B, T, H], (h_T, c_T fp32)).
    """
    keys = _gate_keys(int(seed), int(layer))
    ys, hT, cT = mcd_lstm_seq.mcd_lstm_seq(
        x_seq, wx4, wh4, b, rows, keys, p_drop,
        h0=None if h0 is None else h0.float().contiguous(),
        c0=None if c0 is None else c0.float().contiguous(),
        lengths=lengths)
    return ys, (hT, cT)


def lstm_stack_layer(wx, wh, b, x_seq, rows, seed, layer, p_drop: float, *,
                     initial_state=None, lengths=None, precision=None):
    """Core-layout entry for ``run_stack``'s kernel backend.

    Takes :class:`repro_torch.core.cells.LSTMParams` layout (wx: [4, I, H];
    wh: [4, H, H]) and transposes to the kernel's gate-stacked layout
    ``[I, 4, H]`` / ``[H, 4, H]``.  ``initial_state`` is an optional
    ``(h0, c0)`` pair resuming a streaming session's carried state.
    """
    check_precision(precision)
    wx4, wh4, b = cells.gate_stacked(cells.LSTMParams(wx, wh, b))
    h0, c0 = initial_state if initial_state is not None else (None, None)
    return fused_lstm_seq(wx4, wh4, b, x_seq.float().contiguous(), rows,
                          seed, layer, p_drop, h0=h0, c0=c0, lengths=lengths)
