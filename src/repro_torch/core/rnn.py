"""Cascaded LSTM stacks with MCD mask pre-sampling — port of
``repro.core.rnn`` (LSTM, unsharded).

``run_stack`` has two backends (:data:`repro_torch.kernels.ops.LSTM_BACKENDS`):
``"reference"`` runs plain PyTorch cells over pre-sampled masks in the
reference's wavefront order (all layers advance one step per iteration);
``"cuda_seq"`` runs each layer whole through the sequence-fused kernel, one
launch per layer, with masks rebuilt in-kernel from ``(seed, rows)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import cells, mcd
from repro_torch.kernels import mcd_lstm_seq, ops

CELLS = ("lstm",)


def _check_cell(cell: str) -> None:
    if cell not in CELLS:
        raise NotImplementedError(
            f"cell={cell!r} is not ported yet (this slice serves the LSTM); "
            "the GRU and its mcd_gru_seq kernel are queued in ROADMAP.md")


def init_stack(generator: torch.Generator, in_dim: int,
               hiddens: Sequence[int], dtype=torch.float32, *,
               cell: str = "lstm", device=None) -> list:
    _check_cell(cell)
    dims = [in_dim, *hiddens]
    return [cells.init_lstm(generator, d_in, d_h, dtype, device=device)
            for d_in, d_h in zip(dims[:-1], dims[1:])]


def sample_stack_masks(cfg: mcd.MCDConfig, rows: torch.Tensor, in_dim: int,
                       hiddens: Sequence[int], *, layer_offset: int = 0,
                       dtype=torch.float32, cell: str = "lstm"):
    """Pre-sample (z_x, z_h) per layer; None where the layer is pointwise."""
    _check_cell(cell)
    masks = []
    dims = [in_dim, *hiddens]
    for i, (d_in, d_h) in enumerate(zip(dims[:-1], dims[1:])):
        layer = layer_offset + i
        if cfg.any_bayesian and cfg.bayesian(layer) and cfg.p > 0.0:
            masks.append(mcd.lstm_gate_masks(cfg.seed, layer, rows, d_in,
                                             d_h, cfg.p, dtype=dtype))
        else:
            masks.append((None, None))
    return masks


#: Sentinel masks entry: the layer is Bayesian but its masks are rebuilt
#: inside the kernel — no tensors to materialize (see stack_mask_plan).
IN_KERNEL_MASKS = object()


def stack_mask_plan(cfg: mcd.MCDConfig, n_layers: int, *,
                    layer_offset: int = 0):
    """Per-layer Bayesian on/off in the shape ``run_stack`` expects of
    ``masks``, without materializing any mask tensors (kernel backend)."""
    return [(IN_KERNEL_MASKS, None)
            if cfg.any_bayesian and cfg.bayesian(layer_offset + i)
            and cfg.p > 0.0 else (None, None)
            for i in range(n_layers)]


def run_stack(params: Sequence, x_seq, masks, p: float, *,
              return_sequence: bool = True, backend: str = "reference",
              rows=None, seed=0, layer_offset: int = 0,
              initial_state=None, lengths=None,
              return_all_states: bool = False, cell: str = "lstm",
              precision: str | None = None, device=None, mesh=None):
    """Run a cascaded LSTM stack over a [B, T, I] sequence.

    Same contract as the reference's ``run_stack``: ``masks`` from
    :func:`sample_stack_masks` (reference backend) or
    :func:`stack_mask_plan` (kernel backend); ``rows``/``seed``/
    ``layer_offset`` are the mask-stream coordinates; ``initial_state``
    resumes a per-layer ``[(h, c), ...]`` carry; ``lengths`` freezes each
    row at its own length; ``return_all_states`` returns every layer's
    state.  Carry dtypes follow the reference: the kernel backend hands back
    ``c`` in fp32.

    ``device`` (default CUDA) is where the stack runs: inputs are moved
    there, and ``params`` must already live there.
    """
    _check_cell(cell)
    if mesh is not None:
        raise NotImplementedError("run_stack(mesh=...) is not ported yet; "
                                  "see ROADMAP.md")
    ops.check_precision(precision)
    if backend not in ops.LSTM_BACKENDS:
        raise ValueError(f"backend must be one of {ops.LSTM_BACKENDS}, "
                         f"got {backend!r}")
    dev = resolve_device(device)
    for lp in params:
        if lp.wx.device != dev:
            raise ValueError(f"params live on {lp.wx.device}, run_stack "
                             f"runs on {dev}")
    x_seq = torch.as_tensor(x_seq, device=dev)
    if rows is not None:
        rows = torch.as_tensor(rows, device=dev)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    if initial_state is not None:
        initial_state = [None if s is None else tuple(
            torch.as_tensor(part, device=dev) for part in s)
            for s in initial_state]
    if backend == "cuda_seq":
        return _run_stack_kernel(params, x_seq, masks, p,
                                 return_sequence=return_sequence, rows=rows,
                                 seed=seed, layer_offset=layer_offset,
                                 initial_state=initial_state,
                                 lengths=lengths,
                                 return_all_states=return_all_states)
    if any(zx is IN_KERNEL_MASKS for zx, _ in masks):
        raise ValueError("stack_mask_plan() entries carry no mask values; "
                         "the reference backend needs sample_stack_masks()")
    batch = x_seq.shape[0]
    dtype = x_seq.dtype
    carries = _seed_carries(params, initial_state, batch, dtype, dev)
    lens = lengths.to(torch.int64) if lengths is not None else None
    det = mcd.det_row_mask(rows) if rows is not None else None
    ys = []
    for t in range(x_seq.shape[1]):
        inp = x_seq[:, t]
        new = []
        for (h, c), lp, (zx, zh) in zip(carries, params, masks):
            h_new, c_new = cells.lstm_step(lp, h, c, inp, zx, zh, p, det=det)
            if lens is not None:
                h_new, c_new = cells.freeze_rows(t, lens, h_new, c_new, h, c)
            new.append((h_new, c_new))
            inp = h_new
        carries = new
        if return_sequence:
            ys.append(inp)
    out = torch.stack(ys, dim=1) if return_sequence else None
    return out, (carries if return_all_states else carries[-1])


def _seed_carries(params, initial_state, batch, dtype, device):
    """Per-layer ``(h, c)`` carries: zeros, or the resumed state as-is."""
    carries = []
    for i, lp in enumerate(params):
        hidden = lp.wh.shape[-1]
        state = initial_state[i] if initial_state is not None else None
        if state is None:
            state = tuple(torch.zeros((batch, hidden), dtype=dtype,
                                      device=device) for _ in range(2))
        carries.append(tuple(state))
    return carries


def _run_stack_kernel(params, x_seq, masks, p, *, return_sequence, rows,
                      seed, layer_offset, initial_state, lengths,
                      return_all_states):
    """Kernel-backed stack: layers run whole-sequence, one after another."""
    if rows is None:
        raise ValueError("backend='cuda_seq' needs the mask-stream `rows` "
                         "(the same ids passed to sample_stack_masks)")
    # The kernel's operand types, converted once for every layer.
    rows = mcd_lstm_seq.rows_to_int32(rows)
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    inp = x_seq
    states = []
    for i, (lp, (zx, _)) in enumerate(zip(params, masks)):
        p_eff = p if zx is not None else 0.0
        state0 = initial_state[i] if initial_state is not None else None
        inp, carry = ops.lstm_stack_layer(*lp, inp, rows, seed,
                                          layer_offset + i, p_eff,
                                          initial_state=state0,
                                          lengths=lengths)
        states.append(carry)
    out = inp if return_sequence else None
    if return_all_states:
        return out, states
    hT, cT = states[-1]
    return out, (hT, cT.to(x_seq.dtype))
