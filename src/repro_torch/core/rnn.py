"""Cascaded LSTM / GRU stacks with MCD mask pre-sampling — port of
``repro.core.rnn``.

``run_stack`` has three backends (:data:`repro_torch.kernels.ops.LSTM_BACKENDS`):
``"reference"`` runs plain PyTorch cells over pre-sampled masks in the
reference's wavefront order (all layers advance one step per iteration);
``"cuda_step"`` runs each layer through the fused step kernel, one launch
per time step; ``"cuda_seq"`` runs each layer whole through the
sequence-fused kernel, one launch per layer.  The kernel backends rebuild
the masks in-kernel from ``(seed, rows)``.  Both cells run on every
backend: LSTM layers carry ``(h, c)``, GRU layers ``(h,)``.  ``mesh=``
shards the stack over a device mesh (``launch.rnn_shardings``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import cells, mcd
from repro_torch.kernels import common, ops, quantize

#: Recurrent cell types ``run_stack`` (and everything above it) dispatches
#: on; the GRU drops into the same per-gate MCD design (paper §III-A).
CELLS = ("lstm", "gru")


def _check_cell(cell: str) -> None:
    if cell not in CELLS:
        raise ValueError(f"cell must be one of {CELLS}, got {cell!r}")


def init_stack(generator: torch.Generator, in_dim: int,
               hiddens: Sequence[int], dtype=torch.float32, *,
               cell: str = "lstm", device=None) -> list:
    _check_cell(cell)
    init = cells.init_gru if cell == "gru" else cells.init_lstm
    dims = [in_dim, *hiddens]
    return [init(generator, d_in, d_h, dtype, device=device)
            for d_in, d_h in zip(dims[:-1], dims[1:])]


def sample_stack_masks(cfg: mcd.MCDConfig, rows: torch.Tensor, in_dim: int,
                       hiddens: Sequence[int], *, layer_offset: int = 0,
                       dtype=torch.float32, cell: str = "lstm"):
    """Pre-sample (z_x, z_h) per layer; None where the layer is pointwise."""
    _check_cell(cell)
    gate_masks = mcd.gru_gate_masks if cell == "gru" else mcd.lstm_gate_masks
    masks = []
    dims = [in_dim, *hiddens]
    for i, (d_in, d_h) in enumerate(zip(dims[:-1], dims[1:])):
        layer = layer_offset + i
        if cfg.any_bayesian and cfg.bayesian(layer) and cfg.p > 0.0:
            masks.append(gate_masks(cfg.seed, layer, rows, d_in, d_h, cfg.p,
                                    dtype=dtype))
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
              precision: str | None = None, device=None, mesh=None,
              policy=None):
    """Run a cascaded LSTM / GRU stack over a [B, T, I] sequence.

    Same contract as the reference's ``run_stack``: ``masks`` from
    :func:`sample_stack_masks` (reference backend) or
    :func:`stack_mask_plan` (kernel backend); ``rows``/``seed``/
    ``layer_offset`` are the mask-stream coordinates; ``initial_state``
    resumes a per-layer carry (``(h, c)`` for the LSTM, ``(h,)`` for the
    GRU); ``lengths`` freezes each row at its own length;
    ``return_all_states`` returns every layer's state, else the last
    layer's.  Carry dtypes follow the reference: the kernel backends hand
    back the LSTM's ``c`` in fp32 with every layer's state, and in the input
    dtype as the last layer's state.

    ``device`` (default CUDA) is where the stack runs: inputs are moved
    there, and ``params`` must already live there.

    ``precision`` (:data:`repro_torch.kernels.quantize.PRECISIONS`; None =
    native dtypes): ``x_seq`` is cast to the precision's activation dtype
    up front and the fp32 master ``params`` are cast or quantized on the
    way, never changed.  The sequence kernel dequantizes int8/int4 codes
    itself; the step kernel and the reference cells take the same
    dequantized values (``quantize.fake_quant``, in core layout along axis
    1, gives the kernels' ``(q, scale)``).  h travels in the activation
    dtype and the LSTM's c in fp32 on every backend.  The reference
    backend needs ``masks`` sampled in the activation dtype.

    ``mesh`` (a ``launch.mesh.Mesh``) shards the stack: batch rows over its
    data axes, or, under the ``"gspmd"`` strategy, the hidden units over
    its model axis (``policy``: a ``launch.rnn_shardings.
    StackShardingPolicy``; None = the default).  ``rows`` are then
    required, ``params`` live on the mesh's first device (``mesh.home``,
    which ``device`` must name when given) and the results come back
    there.  The sharded run always passes ``lengths`` (full T when None
    is given) and is bit-equal to the unsharded run given them.
    """
    _check_cell(cell)
    quantize.check_precision(precision)
    if backend not in ops.LSTM_BACKENDS:
        raise ValueError(f"backend must be one of {ops.LSTM_BACKENDS}, "
                         f"got {backend!r}")
    dev = stack_device(device, mesh)
    for lp in params:
        if lp.wx.device != dev:
            raise ValueError(f"params live on {lp.wx.device}, run_stack "
                             f"runs on {dev}")
    x_seq = torch.as_tensor(x_seq, device=dev)
    if precision is not None:
        x_seq = x_seq.to(quantize.activation_dtype(precision, x_seq.dtype))
    if rows is not None:
        rows = torch.as_tensor(rows, device=dev)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    if initial_state is not None:
        initial_state = [None if s is None else tuple(
            torch.as_tensor(part, device=dev) for part in s)
            for s in initial_state]
    if mesh is not None:
        # Deferred: the launch layer imports this module.
        from repro_torch.launch import rnn_shardings
        return rnn_shardings.run_stack_sharded(
            params, x_seq, masks, p, mesh=mesh, policy=policy,
            backend=backend, return_sequence=return_sequence, rows=rows,
            seed=seed, layer_offset=layer_offset,
            initial_state=initial_state, lengths=lengths,
            return_all_states=return_all_states, cell=cell,
            precision=precision)
    if backend != "reference":
        return _run_stack_kernel(params, x_seq, masks, p, backend=backend,
                                 return_sequence=return_sequence, rows=rows,
                                 seed=seed, layer_offset=layer_offset,
                                 initial_state=initial_state,
                                 lengths=lengths,
                                 return_all_states=return_all_states,
                                 cell=cell, precision=precision)
    if any(zx is IN_KERNEL_MASKS for zx, _ in masks):
        raise ValueError("stack_mask_plan() entries carry no mask values; "
                         "the reference backend needs sample_stack_masks()")
    if precision is not None:
        # Core layout [G, I/H, H]: the contraction axis is 1, which gives
        # the kernels' (q, scale) of layout [I/H, G, H] along axis 0.
        params = [lp._replace(
            wx=quantize.fake_quant(lp.wx, precision, axis=1,
                                   act_dtype=x_seq.dtype),
            wh=quantize.fake_quant(lp.wh, precision, axis=1,
                                   act_dtype=x_seq.dtype))
            for lp in params]
    batch = x_seq.shape[0]
    dtype = x_seq.dtype
    # Under a serving precision c is fp32, the kernels' cell state.
    c_dtype = torch.float32 if precision is not None else dtype
    carries = _seed_carries(params, initial_state, batch, dtype, dev, cell,
                            c_dtype)
    lens = lengths.to(torch.int64) if lengths is not None else None
    det = mcd.det_row_mask(rows) if rows is not None else None
    gru = cell == "gru"
    ys = []
    for t in range(x_seq.shape[1]):
        inp = x_seq[:, t]
        new = []
        for state, lp, (zx, zh) in zip(carries, params, masks):
            if gru:
                (h,) = state
                h_new = cells.gru_step(lp, h, inp, zx, zh, p, det=det)
                if lens is not None:
                    h_new = cells.freeze_rows_h(t, lens, h_new, h)
                new.append((h_new,))
            else:
                h, c = state
                h_new, c_new = cells.lstm_step(lp, h, c, inp, zx, zh, p,
                                               det=det)
                if lens is not None:
                    h_new, c_new = cells.freeze_rows(t, lens, h_new, c_new,
                                                     h, c)
                new.append((h_new, c_new))
            inp = h_new
        carries = new
        if return_sequence:
            ys.append(inp)
    out = torch.stack(ys, dim=1) if return_sequence else None
    return out, (carries if return_all_states else carries[-1])


def stack_device(device, mesh) -> torch.device:
    """Where a stack runs: ``device`` (default CUDA), or the mesh's first
    device, which ``device`` must then name when given."""
    if mesh is None:
        return resolve_device(device)
    home = getattr(mesh, "home", None)
    if not isinstance(home, torch.device):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if device is not None and resolve_device(device) != home:
        raise ValueError(f"run_stack on {resolve_device(device)} with a "
                         f"mesh whose first device is {home}")
    return home


def _seed_carries(params, initial_state, batch, dtype, device, cell="lstm",
                  c_dtype=None):
    """Per-layer carries — ``(h, c)`` for the LSTM, ``(h,)`` for the GRU:
    zeros (h in ``dtype``, c in ``c_dtype``, default ``dtype``), or the
    resumed state as-is."""
    parts = 1 if cell == "gru" else 2
    dtypes = (dtype, c_dtype or dtype)[:parts]
    carries = []
    for i, lp in enumerate(params):
        hidden = lp.wh.shape[-1]
        state = initial_state[i] if initial_state is not None else None
        if state is None:
            state = tuple(torch.zeros((batch, hidden), dtype=dt,
                                      device=device) for dt in dtypes)
        carries.append(tuple(state))
    return carries


def _run_stack_kernel(params, x_seq, masks, p, *, backend, return_sequence,
                      rows, seed, layer_offset, initial_state, lengths,
                      return_all_states, cell, precision=None):
    """Kernel-backed stack: layers run whole-sequence, one after another
    (the sequence kernel once per layer, or the step kernel once per step).
    """
    if rows is None:
        raise ValueError(f"backend={backend!r} needs the mask-stream `rows` "
                         "(the same ids passed to sample_stack_masks)")
    # The kernels' operand types, converted once for every layer.
    rows = common.rows_to_int32(rows)
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    gru = cell == "gru"
    stack_layer = ops.gru_stack_layer if gru else ops.lstm_stack_layer
    inp = x_seq
    states = []
    for i, (lp, (zx, _)) in enumerate(zip(params, masks)):
        p_eff = p if zx is not None else 0.0
        state0 = initial_state[i] if initial_state is not None else None
        inp, carry = stack_layer(*lp, inp, rows, seed, layer_offset + i,
                                 p_eff, seq=backend == "cuda_seq",
                                 initial_state=state0, lengths=lengths,
                                 precision=precision)
        states.append(carry)
    out = inp if return_sequence else None
    if return_all_states:
        # Session-resume form: LSTM c stays fp32 (the kernels' carry dtype),
        # so a chunk boundary round-trips the cell state losslessly.
        return out, states
    if gru:
        return out, states[-1]                  # (h_T,)
    # The reference's carry contract: c in the input dtype, but fp32 under
    # a serving precision (where the reference carries c in fp32 too).
    hT, cT = states[-1]
    return out, (hT, cT if precision is not None else cT.to(x_seq.dtype))
