"""Sharded execution of the recurrent stack: the multi-device data plane —
counterpart of ``repro.launch.rnn_shardings``.

``rnn.run_stack(..., mesh=...)`` lands here and picks one of two
strategies over a ``(data, model)`` :class:`~repro_torch.launch.mesh.Mesh`:

* ``"data"`` — the serving path.  Batch rows (sessions × MC chains) are
  padded and split into contiguous blocks, one a data-axis entry; each
  entry runs the port's own unsharded ``run_stack`` (the sequence or step
  kernels, or the reference cells) on its device over its block, with the
  weights copied to that device once and kept there until they change.
  MC chains are batch rows, so sharding the batch shards the chains.
* ``"gspmd"`` — the wide-H path.  The reference cells run with every
  weight's H *output* columns split over the ``model`` axis: each
  model-axis entry computes its columns of every gate, runs the cell on
  them and hands back its slice of ``h_t`` (and ``c_t``); the slices are
  put together in order and copied to every entry before step ``t + 1``.
  No reduction is split.  This is how a wide stack's H is tiled across
  *devices* (the kernels themselves take any H up to 16384 on one: the
  sequence kernels' cluster split of H, the step kernels' unit slices,
  ``kernels.common.wide_plan``).

No process group and no collective: one process drives every device of
the mesh in order and puts the results back together on the mesh's first
device (``Mesh.home``).

Why sharded == unsharded, bit for bit, at any device count:

1. Masks are pure functions of global ``(seed, rows)`` coordinates.  Each
   shard gets the global ``rows`` of its block, so it draws exactly the
   bits the unsharded run draws for them.
2. The sharded path always passes ``lengths`` (full-T lengths when the
   caller gives none), the same pass the streaming engine makes.
3. Padding only appends rows (mask row 0, length 1), whose outputs are
   sliced off; a row's arithmetic never sees its neighbours (the kernels
   run a thread a row and unit; the plain versions and the reference
   cells evaluate every row alike, ``kernels.common.rowwise``).
4. The gspmd split is over output columns only: every element of a gate
   sum adds the same products in the same order; the activations of a
   slice are evaluated at their columns of a full-width row.

Policy knobs live in :class:`StackShardingPolicy`; ``"auto"`` picks
``"data"`` until H exceeds ``wide_h`` on a mesh with a model axis, then
``"gspmd"`` — and always ``"gspmd"`` for the reference backend.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.core import cells, mcd, rnn
from repro_torch.kernels import quantize
from repro_torch.launch import mesh as mesh_lib

#: H above which ``"auto"`` tiles H across the mesh's ``model`` axis
#: (``"gspmd"``), the reference's value and reason: H-tiling across
#: devices belongs to gspmd.  Unsharded, or on a data mesh, the kernels
#: run such a layer whole on one device (their wide path,
#: ``kernels.common.wide_plan``).
WIDE_H_DEFAULT = 1024

STRATEGIES = ("auto", "data", "gspmd")


@dataclasses.dataclass(frozen=True)
class StackShardingPolicy:
    """How the recurrent stack maps onto a mesh.

    Attributes:
      data: mesh axes carrying batch rows (``("pod", "data")``; only axes
        present on the mesh are used).
      model: mesh axis carrying the hidden width under ``"gspmd"``.
      strategy: ``"data"``, ``"gspmd"`` or ``"auto"`` (data until
        ``wide_h``, gspmd beyond — and always gspmd for the reference
        backend).
      wide_h: the H ``"auto"`` switches at.
    """

    data: tuple[str, ...] = ("pod", "data")
    model: str = "model"
    strategy: str = "auto"
    wide_h: int = WIDE_H_DEFAULT

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {self.strategy!r}")


DEFAULT_POLICY = StackShardingPolicy()


def data_axes(mesh, policy: StackShardingPolicy = DEFAULT_POLICY):
    """The policy's data axes present on this mesh, in mesh order; None
    (the replicated spec entry) when there are none."""
    axes = tuple(a for a in mesh.axis_names if a in policy.data)
    return axes or None


def data_size(mesh, policy: StackShardingPolicy = DEFAULT_POLICY) -> int:
    sizes = mesh_lib.axis_sizes(mesh)
    out = 1
    for a in (data_axes(mesh, policy) or ()):
        out *= sizes[a]
    return out


def model_size(mesh, policy: StackShardingPolicy = DEFAULT_POLICY) -> int:
    return mesh_lib.axis_sizes(mesh).get(policy.model, 1)


def resolve_strategy(mesh, policy: StackShardingPolicy, backend: str,
                     hiddens) -> str:
    """The strategy for this (mesh, backend, stack)."""
    if policy.strategy != "auto":
        return policy.strategy
    if backend == "reference":
        return "gspmd"              # the reference cells split by columns
    if max(hiddens) > policy.wide_h and model_size(mesh, policy) > 1:
        return "gspmd"              # H tiled across the model axis
    return "data"


# ---------------------------------------------------------------------------
# Specs: the axis each dim of the stack's structures is split over (None =
# whole on every entry), the tuples of the reference's PartitionSpecs
# ---------------------------------------------------------------------------

def _out_axis(h: int, mesh, policy, strategy: str):
    """The axis a weight's H output dim splits over: the model axis under
    gspmd where it divides H, else None.  The one place the rule lives."""
    ms = model_size(mesh, policy)
    if (strategy != "gspmd" or policy.model not in mesh.axis_names
            or ms <= 1 or h % ms):
        return None
    return policy.model


def _param_specs(cell: str, hiddens, mesh, policy: StackShardingPolicy,
                 strategy: str):
    cls = cells.GRUParams if cell == "gru" else cells.LSTMParams
    out = []
    for h in hiddens:
        ax = _out_axis(h, mesh, policy, strategy)
        out.append(cls(wx=(None, None, ax), wh=(None, None, ax),
                       b=(None, ax)))
    return out


def stack_param_specs(params, mesh,
                      policy: StackShardingPolicy = DEFAULT_POLICY, *,
                      strategy: str = "data"):
    """Per-layer specs of core-layout stack weights (``wx [G, I, H]``,
    ``wh [G, H, H]``, ``b [G, H]``): the data strategy keeps every weight
    whole on every entry; gspmd splits the H output dim over ``model``
    where it divides — never a contraction dim."""
    cell = "gru" if isinstance(params[0], cells.GRUParams) else "lstm"
    return _param_specs(cell, tuple(lp.wh.shape[-1] for lp in params),
                        mesh, policy, strategy)


def _spec_entry(axes):
    """A spec entry naming ``axes``, as a ``PartitionSpec`` stores it: None,
    one axis by its name, several as a tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def carry_specs(n_layers: int, mesh,
                policy: StackShardingPolicy = DEFAULT_POLICY, *,
                cell: str = "lstm"):
    """Per-layer state specs: ``[B, H]`` parts split the batch over the
    data axes; ``(h, c)`` for the LSTM, ``(h,)`` for the GRU."""
    dp = _spec_entry(data_axes(mesh, policy))
    parts = 1 if cell == "gru" else 2
    return [tuple((dp, None) for _ in range(parts))
            for _ in range(n_layers)]


def batch_specs(mesh, policy: StackShardingPolicy = DEFAULT_POLICY) -> dict:
    """Specs of the batch-aligned operands: ``rows`` split with the batch,
    so each entry gets the global mask coordinates of its rows."""
    dp = _spec_entry(data_axes(mesh, policy))
    return {"x_seq": (dp, None, None), "rows": (dp,), "lengths": (dp,)}


def shard_devices(mesh, policy: StackShardingPolicy = DEFAULT_POLICY
                  ) -> list[list[torch.device]]:
    """``[data entry][model entry]`` devices: the data entries enumerate
    the policy's data axes in mesh order (row-major), the model entries
    the model axis; every other axis is taken at its first entry."""
    names = mesh.axis_names
    dp = data_axes(mesh, policy) or ()
    d_idx = [i for i, a in enumerate(names) if a in dp]
    m_idx = (names.index(policy.model)
             if policy.model in names and policy.model not in dp else None)
    grid = mesh.devices
    n_model = grid.shape[m_idx] if m_idx is not None else 1
    out = []
    for coord in itertools.product(*(range(grid.shape[i]) for i in d_idx)):
        row = []
        for m in range(n_model):
            at = [0] * len(names)
            for i, c in zip(d_idx, coord):
                at[i] = c
            if m_idx is not None:
                at[m_idx] = m
            row.append(grid[tuple(at)])
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Entry point (run_stack's mesh= dispatch lands here)
# ---------------------------------------------------------------------------

def run_stack_sharded(params, x_seq, masks, p, *, mesh,
                      policy: StackShardingPolicy | None = None,
                      backend: str = "cuda_seq",
                      return_sequence: bool = True, rows=None, seed=0,
                      layer_offset: int = 0, initial_state=None,
                      lengths=None, return_all_states: bool = False,
                      cell: str = "lstm", precision: str | None = None):
    """Run the stack sharded over ``mesh`` — ``run_stack``'s contract.

    Callers use ``rnn.run_stack(..., mesh=..., policy=...)``, which puts
    the operands on ``mesh.home`` first.  Results come back there.  Always
    passes ``lengths`` (full T when the caller gives none), so the result
    is bit-equal to the unsharded run given those lengths, at any device
    count — one included, where the single entry runs exactly the
    unsharded launch.
    """
    policy = policy or DEFAULT_POLICY
    if rows is None:
        raise ValueError("mesh= needs the mask-stream `rows` (the global "
                         "coordinates are what keep sharded masks "
                         "deterministic per logical row)")
    quantize.check_precision(precision)
    if precision is not None:
        x_seq = x_seq.to(quantize.activation_dtype(precision, x_seq.dtype))
    hiddens = [lp.wh.shape[-1] for lp in params]
    strategy = resolve_strategy(mesh, policy, backend, hiddens)
    if lengths is None:
        lengths = torch.full((x_seq.shape[0],), x_seq.shape[1],
                             dtype=torch.int32, device=x_seq.device)
    kw = dict(p=p, return_sequence=return_sequence, rows=rows, seed=seed,
              layer_offset=layer_offset, initial_state=initial_state,
              lengths=lengths, cell=cell, precision=precision)
    if strategy == "gspmd":
        out, states = _run_gspmd(params, x_seq, masks, mesh=mesh,
                                 policy=policy, **kw)
        backend = "reference"
    else:
        out, states = _run_data_sharded(params, x_seq, masks, mesh=mesh,
                                        policy=policy, backend=backend, **kw)
    return _finalize(out, states, x_seq.dtype, backend=backend, cell=cell,
                     return_all_states=return_all_states,
                     precision=precision)


def _pad_batch(arr: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    if pad == 0:
        return arr
    tail = torch.full((pad, *arr.shape[1:]), value, dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, tail])


def _shard_pad(batch: int, ndev: int) -> int:
    """Rows to append so the batch splits evenly with >= 2 rows a shard.

    The reference keeps two rows a shard because a one-row launch took
    another reduction path on its TPU; the port keeps the same layout, so
    both packages launch the same shard shapes.  One shard never pads: it
    runs the exact unsharded launch.
    """
    if ndev <= 1:
        return 0
    per_shard = max(2, -(-batch // ndev))
    return per_shard * ndev - batch


def _split_masks(masks):
    """``(plan, values)``: the plan keeps the ``IN_KERNEL_MASKS`` / None
    markers, the values every real mask array (tensors and host numpy
    arrays alike) as a tensor."""
    def is_arr(v):
        return isinstance(v, (torch.Tensor, np.ndarray))

    plan, values = [], []
    for zx, zh in masks:
        plan.append((None if is_arr(zx) else zx, None if is_arr(zh) else zh))
        values.append((torch.as_tensor(zx) if is_arr(zx) else None,
                       torch.as_tensor(zh) if is_arr(zh) else None))
    return tuple(plan), values


def _merge_masks(plan, values):
    return [(vx if vx is not None else px, vh if vh is not None else ph)
            for (px, ph), (vx, vh) in zip(plan, values)]


def _stage_batch(x_seq, rows, lengths, initial_state, mask_vals, ndev):
    """Pad every batch-aligned operand for an even >= 2-rows-a-shard split.

    Shared by both strategies: appended rows get mask row 0 and length 1,
    and their outputs are sliced off by :func:`_unpad`.  Returns
    ``(B, pad, x, rows, lengths, state, mask_vals)``.
    """
    B = x_seq.shape[0]
    pad = _shard_pad(B, ndev)
    dev = x_seq.device
    x_p = _pad_batch(x_seq, pad)
    rows_p = _pad_batch(torch.as_tensor(rows, device=dev), pad)
    lens_p = _pad_batch(torch.as_tensor(lengths, device=dev)
                        .to(torch.int32), pad, value=1)
    state_p = None
    if initial_state is not None:
        state_p = [None if layer is None else
                   tuple(_pad_batch(part, pad) for part in layer)
                   for layer in initial_state]
    mask_p = [tuple(None if v is None else _pad_batch(v.to(dev), pad)
                    for v in pair) for pair in mask_vals]
    return B, pad, x_p, rows_p, lens_p, state_p, mask_p


def _unpad(out, states, B, pad):
    if not pad:
        return out, states
    return (None if out is None else out[:B],
            [tuple(part[:B] for part in layer) for layer in states])


def _finalize(out, states, x_dtype, *, backend, cell, return_all_states,
              precision=None):
    """``run_stack``'s return contract after an all-states inner run."""
    if return_all_states:
        return out, states
    last = states[-1]
    if cell == "gru" or backend == "reference" or precision is not None:
        # Under a serving precision c stays fp32 on every backend.
        return out, last
    h_t, c_t = last
    return out, (h_t, c_t.to(x_dtype))


def _placed(mesh, t: torch.Tensor, dev, cols=None, quant=None):
    """``t`` on ``dev`` (its ``cols = (lo, hi)`` output columns; fake-
    quantized at ``quant = (precision, activation dtype)``), made once and
    kept on the mesh until ``t`` changes (a new storage or an in-place
    write): the weights are not copied again each tick."""
    if t.device == dev and cols is None and quant is None:
        return t
    key = (id(t), dev, cols, quant)
    version = (t.data_ptr(), t._version)
    hit = mesh._placed.get(key)
    if hit is not None and hit[0] is t and hit[1] == version:
        return hit[2]
    v = t
    if quant is not None:
        v = quantize.fake_quant(v, quant[0], axis=1, act_dtype=quant[1])
    if cols is not None:
        v = v[..., cols[0]:cols[1]]
    v = v.to(dev).contiguous()
    mesh._placed[key] = (t, version, v)
    return v


def _gather(pieces, home):
    """Outputs and every layer's carry parts of the shards, in row order,
    on ``home``."""
    if len(pieces) == 1:
        return pieces[0]
    outs = [o for o, _ in pieces]
    out = (None if outs[0] is None
           else torch.cat([o.to(home) for o in outs]))
    states = [tuple(torch.cat([part.to(home) for part in parts])
                    for parts in zip(*layers))
              for layers in zip(*(s for _, s in pieces))]
    return out, states


def _run_data_sharded(params, x_seq, masks, *, mesh, policy, backend, p,
                      return_sequence, rows, seed, layer_offset,
                      initial_state, lengths, cell, precision):
    """Batch rows over the data axes, every entry running the unsharded
    stack on its block with the weights on its device."""
    devs = [row[0] for row in shard_devices(mesh, policy)]
    plan, mask_vals = _split_masks(masks)
    B, pad, x_p, rows_p, lens_p, state_p, mask_p = _stage_batch(
        x_seq, rows, lengths, initial_state, mask_vals, len(devs))
    per = x_p.shape[0] // len(devs)
    pieces = []
    for k, dev in enumerate(devs):
        sl = slice(k * per, (k + 1) * per)

        def take(t, sl=sl, dev=dev):
            return None if t is None else t[sl].to(dev)

        shard_params = [type(lp)(*(_placed(mesh, t, dev) for t in lp))
                        for lp in params]
        pieces.append(rnn.run_stack(
            shard_params, take(x_p),
            _merge_masks(plan, [tuple(take(v) for v in pair)
                                for pair in mask_p]), p,
            return_sequence=return_sequence, backend=backend,
            rows=take(rows_p), seed=seed, layer_offset=layer_offset,
            initial_state=(None if state_p is None else
                           [None if layer is None else
                            tuple(take(t) for t in layer)
                            for layer in state_p]),
            lengths=take(lens_p), return_all_states=True, cell=cell,
            precision=precision, device=dev))
    out, states = _gather(pieces, mesh.home)
    return _unpad(out, states, B, pad)


def _spans(hidden: int, n_model: int) -> list[tuple[int, int]]:
    """The model entries' output columns: H split evenly where it divides,
    else whole on the first entry (the reference replicates it)."""
    if n_model <= 1 or hidden % n_model:
        return [(0, hidden)]
    w = hidden // n_model
    return [(m * w, (m + 1) * w) for m in range(n_model)]


def _run_gspmd(params, x_seq, masks, *, mesh, policy, p, return_sequence,
               rows, seed, layer_offset, initial_state, lengths, cell,
               precision):
    """The reference cells with each weight's H output columns over the
    model axis and the batch rows over the data axes."""
    grid = shard_devices(mesh, policy)
    plan, mask_vals = _split_masks(masks)
    B, pad, x_p, rows_p, lens_p, state_p, mask_p = _stage_batch(
        x_seq, rows, lengths, initial_state, mask_vals, len(grid))
    per = x_p.shape[0] // len(grid)
    pieces = []
    for k, devs in enumerate(grid):
        sl = slice(k * per, (k + 1) * per)
        pieces.append(_gspmd_block(
            mesh, params, x_p[sl], plan,
            [tuple(None if v is None else v[sl] for v in pair)
             for pair in mask_p],
            rows_p[sl], lens_p[sl],
            None if state_p is None else [
                None if layer is None else tuple(t[sl] for t in layer)
                for layer in state_p],
            devs, p=p, seed=seed, layer_offset=layer_offset, cell=cell,
            precision=precision, return_sequence=return_sequence))
    out, states = _gather(pieces, mesh.home)
    return _unpad(out, states, B, pad)


def _gspmd_block(mesh, params, x, plan, mask_vals, rows, lens, state, devs,
                 *, p, seed, layer_offset, cell, precision,
                 return_sequence):
    """One data entry's rows through the stack, each layer's hidden units
    split over ``devs`` (its model-axis entries).  Every operand arrives on
    ``mesh.home``; results go back there."""
    home = x.device
    gru = cell == "gru"
    dtype = x.dtype
    c_dtype = torch.float32 if precision is not None else dtype
    gate_masks = mcd.gru_gate_masks if gru else mcd.lstm_gate_masks
    det = mcd.det_row_mask(rows)
    quant = None if precision is None else (precision, dtype)
    layers = []
    for i, (lp, (zx, zh)) in enumerate(zip(params,
                                           _merge_masks(plan, mask_vals))):
        H, in_dim = lp.wh.shape[-1], lp.wx.shape[1]
        if zx is rnn.IN_KERNEL_MASKS:
            zx, zh = gate_masks(seed, layer_offset + i, rows, in_dim, H, p,
                                dtype=dtype)
        spans = _spans(H, len(devs))
        entries = []
        for (lo, hi), dev in zip(spans, devs):
            cols = (lo, hi)
            entries.append(dict(
                dev=dev, span=(lo, H),
                params=type(lp)(_placed(mesh, lp.wx, dev, cols, quant),
                                _placed(mesh, lp.wh, dev, cols, quant),
                                _placed(mesh, lp.b, dev, cols)),
                zx=None if zx is None else zx.to(dev),
                zh=None if zh is None else zh.to(dev),
                det=det.to(dev), lens=lens.to(dev).to(torch.int64)))
        s0 = state[i] if state is not None else None
        h = (torch.zeros((x.shape[0], H), dtype=dtype, device=home)
             if s0 is None else s0[0])
        if not gru:
            c = (torch.zeros((x.shape[0], H), dtype=c_dtype, device=home)
                 if s0 is None else s0[1])
            for e, (lo, hi) in zip(entries, spans):
                e["c"] = c[:, lo:hi].to(e["dev"])
        layers.append((entries, spans, h))
    ys = []
    for t in range(x.shape[1]):
        inp = x[:, t]
        new = []
        for entries, spans, h in layers:
            parts = []
            for e, (lo, hi) in zip(entries, spans):
                dev = e["dev"]
                h_e, inp_e = h.to(dev), inp.to(dev)
                h_old = h_e[:, lo:hi]
                if gru:
                    h_new = cells.gru_step(e["params"], h_e, inp_e, e["zx"],
                                           e["zh"], p, det=e["det"],
                                           span=e["span"])
                    h_new = cells.freeze_rows_h(t, e["lens"], h_new, h_old)
                else:
                    h_new, c_new = cells.lstm_step(
                        e["params"], h_e, e["c"], inp_e, e["zx"], e["zh"],
                        p, det=e["det"], span=e["span"])
                    h_new, e["c"] = cells.freeze_rows(
                        t, e["lens"], h_new, c_new, h_old, e["c"])
                parts.append(h_new.to(home))
            h = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            new.append((entries, spans, h))
            inp = h
        layers = new
        if return_sequence:
            ys.append(inp)
    out = torch.stack(ys, dim=1) if return_sequence else None
    states = []
    for entries, _, h in layers:
        if gru:
            states.append((h,))
        else:
            cs = [e["c"].to(home) for e in entries]
            states.append((h, cs[0] if len(cs) == 1
                           else torch.cat(cs, dim=1)))
    return out, states
