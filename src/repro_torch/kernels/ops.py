"""High-level wrappers around the port's kernels — port of
``repro.kernels.ops``.

The LM decode path's three (the reference's hot-path entry points, which
its model code mirrors in jnp; here ``repro_torch.models.layers`` calls them
on its ``cuda`` backend): :func:`flash_decode_attention`,
:func:`mcd_dense` and :func:`mcd_mask_apply`, each taking the site's stream
key ``mcd.mask_key(seed, layer, KIND_FEAT, site)`` as the reference derives
it.  The Mamba2 mixer's prefill scan, :func:`ssd_scan`
(``repro_torch.models.mamba2`` on its ``cuda`` backend).

Stack-layer execution paths of :func:`repro_torch.core.rnn.run_stack`, and
how they map to the reference's ``LSTM_BACKENDS`` (``repro/kernels/ops.py``):

* ``"reference"`` — plain PyTorch cells on pre-sampled masks; the
  reference's ``"reference"``.
* ``"cuda_step"`` — the fused step kernel
  (:func:`repro_torch.kernels.mcd_lstm.mcd_lstm_step`,
  :func:`repro_torch.kernels.mcd_gru.mcd_gru_step`) launched once per time
  step from a Python loop, ragged rows frozen outside the kernel; the
  reference's ``"pallas_step"`` (the per-step baseline).
* ``"cuda_seq"`` — the sequence-fused layer kernel
  (:func:`repro_torch.kernels.mcd_lstm_seq.mcd_lstm_seq`,
  :func:`repro_torch.kernels.mcd_gru_seq.mcd_gru_seq`), one launch per
  layer with the masks rebuilt in-kernel; the reference's ``"pallas_seq"``.

On CPU tensors both kernel backends, and the three LM wrappers, run the
kernels' plain versions.  Every entry point refuses an operand that
requires grad under grad mode (``common.refuse_grad``): no kernel has a
backward, and training runs the ``reference`` backend.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import cells, mcd
from repro_torch.kernels import (bernoulli_mask, common, decode_attn,
                                 mcd_gru, mcd_gru_seq, mcd_lstm,
                                 mcd_lstm_seq, mcd_matmul, quantize,
                                 ssd_chunk)

LSTM_BACKENDS = ("reference", "cuda_step", "cuda_seq")


@functools.lru_cache(maxsize=1024)
def _gate_keys(cell: str, seed: int, layer: int) -> tuple[int, ...]:
    # The hash is ~200 tiny host ops per layer; a stream's keys never change.
    mod = mcd_gru if cell == "gru" else mcd_lstm
    return tuple(mod.gate_keys(seed, layer).reshape(-1).tolist())


@functools.lru_cache(maxsize=4096)
def site_key(seed: int, layer: int, site: int) -> int:
    """The uint32 stream key of one MC-dropout site,
    ``mcd.mask_key(seed, layer, KIND_FEAT, site)`` (cached: the hash is
    ~50 tiny host ops and a site's key never changes)."""
    return int(mcd.mask_key(seed, layer, mcd.KIND_FEAT, site))


def flash_decode_attention(q, k_cache, v_cache, pos):
    """Fused decode attention: q [B, H, hd] over the caches [B, S, KV, hd],
    positions ``<= pos``."""
    common.refuse_grad("flash_decode_attention", q, k_cache, v_cache)
    return decode_attn.decode_attention(q, k_cache, v_cache, pos)


def mcd_dense(x, w, rows, seed, layer: int, site: int, p_drop: float,
              out_dtype=None):
    """Fused masked dense: ``y = (x ⊙ z/(1-p)) @ W`` with the site-keyed
    stream; x [M, K], w [K, N], rows [M]."""
    common.refuse_grad("mcd_dense", x, w)
    key = site_key(int(seed), int(layer), int(site))
    return mcd_matmul.mcd_matmul(x, w, rows, key, p_drop, out_dtype)


def mcd_mask_apply(x, rows, seed, layer: int, site: int, p_drop: float):
    """``x ⊙ z/(1-p)`` with the site-keyed stream; x [B, F], rows [B]."""
    common.refuse_grad("mcd_mask_apply", x)
    key = site_key(int(seed), int(layer), int(site))
    return bernoulli_mask.masked_activation(x, rows, key, p_drop)


def ssd_scan(x, dt, a, bm, cm, d_skip, chunk: int):
    """The model's chunked SSD scan through :func:`ssd_chunk.ssd_chunk_scan`.

    x: [B, L, H, P]; dt: [B, L, H] (after softplus); a, d_skip: [H]; bm, cm:
    [B, L, G, N] with G = 1.  As the model's ``_ssd_chunked``: chunks of
    ``Q = min(chunk, L)`` steps, L padded with zeros to a multiple of Q (dt
    = 0 on the padded steps leaves ``y[:, :L]`` and the final state as they
    are).  Returns (y [B, L, H, P] in x's dtype, h_final [B, H, P, N] fp32).
    """
    common.refuse_grad("ssd_scan", x, dt, a, bm, cm, d_skip)
    B, L, H, P = x.shape
    if bm.shape[2] != 1:
        raise NotImplementedError(
            f"ssd_scan takes n_groups = 1, got {bm.shape[2]}; no "
            "configuration has more; the reference backend runs a grouped "
            "scan (models/mamba2._ssd_chunked)")
    Q = min(chunk, L)
    pad = (-L) % Q

    def padded(t):
        if pad:
            t = torch.cat([t, t.new_zeros((B, pad, *t.shape[2:]))], dim=1)
        return t.contiguous()

    y, h_final = ssd_chunk.ssd_chunk_scan(
        padded(x), padded(dt), a.contiguous(), padded(bm[:, :, 0]),
        padded(cm[:, :, 0]), d_skip.contiguous(), q_chunk=Q)
    return y[:, :L].to(x.dtype), h_final


def _carry_h(t, act):
    """A resumed h: the activation dtype the kernels take it in."""
    return None if t is None else t.to(act).contiguous()


def _carry_c(t):
    """A resumed LSTM c: fp32 on every precision."""
    return None if t is None else t.float().contiguous()


def _precision_weights(wx, wh, x_seq, precision, *, seq: bool):
    """Apply a serving precision to gate-stacked weights and the input, as
    the reference's ``ops._precision_weights``.

    Returns ``(wx, wh, x_seq, qkw)``: ``qkw`` holds the extra keywords the
    sequence kernels take for quantized codes (``weight_bits``, the fp32
    ``[G, H]`` scales).  The step kernels get the dequantized weights
    instead -- the same ``float32(q) * scale`` values, rounded to bf16
    outside the kernel -- so every backend computes with the same weights.
    ``None`` and ``"fp32"`` run fp32.
    """
    act = quantize.activation_dtype(precision, torch.float32)
    x_seq = x_seq.to(act).contiguous()
    if precision not in quantize.QUANTIZED:
        return (wx.to(act).contiguous(), wh.to(act).contiguous(), x_seq,
                {})
    bits = quantize.WEIGHT_BITS[precision]
    qx, sx = quantize.quantize(wx, bits, axis=0)
    qh, sh = quantize.quantize(wh, bits, axis=0)
    if seq:
        return (quantize.packed_weight(qx, bits).contiguous(),
                quantize.packed_weight(qh, bits).contiguous(), x_seq,
                dict(weight_bits=bits, wx_scale=sx.contiguous(),
                     wh_scale=sh.contiguous()))
    return (quantize.dequantize(qx, sx, axis=0).to(act).contiguous(),
            quantize.dequantize(qh, sh, axis=0).to(act).contiguous(), x_seq,
            {})


def fused_lstm_layer(wx4, wh4, b, x_seq, rows, seed, layer: int,
                     p_drop: float, h0=None, c0=None, lengths=None):
    """The step kernel looped over T from Python (the per-step baseline).

    wx4: [I, 4, H]; wh4: [H, 4, H] in x_seq's dtype (fp32 or bf16); b:
    [4, H] fp32; x_seq: [B, T, I].  ``h0``/``c0`` resume carried state
    (zeros when omitted; h in x_seq's dtype, c fp32); ``lengths`` freezes
    each row's state at its own chunk length, outside the kernel.
    Returns (outputs [B, T, H] in x_seq's dtype, (h_T, c_T fp32)).
    """
    common.refuse_grad("fused_lstm_layer", wx4, wh4, b, x_seq, h0, c0)
    B, T, _ = x_seq.shape
    H = wh4.shape[0]
    keys = _gate_keys("lstm", int(seed), int(layer))
    dev = x_seq.device
    act = x_seq.dtype
    h = (torch.zeros((B, H), dtype=act, device=dev) if h0 is None
         else _carry_h(h0, act))
    c = torch.zeros((B, H), device=dev) if c0 is None else _carry_c(c0)
    xs = x_seq.transpose(0, 1).contiguous()            # [T, B, I]
    ys = []
    for t in range(T):
        h_new, c_new = mcd_lstm.mcd_lstm_step(xs[t], h, c, wx4, wh4, b, rows,
                                              keys, p_drop)
        if lengths is not None:
            h_new, c_new = cells.freeze_rows(t, lengths, h_new, c_new, h, c)
        h, c = h_new, c_new
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def fused_lstm_seq(wx4, wh4, b, x_seq, rows, seed, layer: int,
                   p_drop: float, h0=None, c0=None, lengths=None,
                   weight_bits=None, wx_scale=None, wh_scale=None):
    """One kernel launch for the whole sequence.

    Same contract as :func:`fused_lstm_layer`; with ``weight_bits`` 8 / 4,
    ``wx4``/``wh4`` carry quantized codes and ``wx_scale``/``wh_scale`` the
    [4, H] fp32 scales (dequantized in the kernel).
    Returns (outputs [B, T, H], (h_T, c_T fp32)).
    """
    common.refuse_grad("fused_lstm_seq", wx4, wh4, b, x_seq, h0, c0,
                       wx_scale, wh_scale)
    keys = _gate_keys("lstm", int(seed), int(layer))
    ys, hT, cT = mcd_lstm_seq.mcd_lstm_seq(
        x_seq, wx4, wh4, b, rows, keys, p_drop,
        h0=_carry_h(h0, x_seq.dtype), c0=_carry_c(c0), lengths=lengths,
        weight_bits=weight_bits, wx_scale=wx_scale, wh_scale=wh_scale)
    return ys, (hT, cT)


def lstm_stack_layer(wx, wh, b, x_seq, rows, seed, layer, p_drop: float, *,
                     seq: bool = True, initial_state=None, lengths=None,
                     precision=None):
    """Core-layout entry for ``run_stack``'s kernel backends.

    Takes :class:`repro_torch.core.cells.LSTMParams` layout (wx: [4, I, H];
    wh: [4, H, H]) and transposes to the kernel's gate-stacked layout
    ``[I, 4, H]`` / ``[H, 4, H]``.  ``seq`` picks the sequence kernel
    (``cuda_seq``) or the step kernel (``cuda_step``).  ``initial_state`` is
    an optional ``(h0, c0)`` pair resuming a streaming session's state.
    ``precision`` (fp32/bf16/int8/int4) casts or quantizes the fp32 master
    weights (:func:`_precision_weights`): int8/int4 hand the sequence
    kernel the codes and the step kernel the dequantized values.
    """
    common.refuse_grad("lstm_stack_layer", wx, wh, b, x_seq, initial_state)
    wx4, wh4, b = cells.gate_stacked(cells.LSTMParams(wx, wh, b))
    wx4, wh4, x_seq, qkw = _precision_weights(wx4, wh4, x_seq, precision,
                                              seq=seq)
    h0, c0 = initial_state if initial_state is not None else (None, None)
    fn = fused_lstm_seq if seq else fused_lstm_layer
    return fn(wx4, wh4, b.float().contiguous(), x_seq, rows, seed, layer,
              p_drop, h0=h0, c0=c0, lengths=lengths, **qkw)


def fused_gru_layer(wx3, wh3, b, x_seq, rows, seed, layer: int,
                    p_drop: float, h0=None, lengths=None):
    """The GRU step kernel looped over T from Python (per-step baseline).

    wx3: [I, 3, H]; wh3: [H, 3, H] in x_seq's dtype (fp32 or bf16); b:
    [3, H] fp32; x_seq: [B, T, I].  ``h0`` resumes carried state (zeros
    when omitted; x_seq's dtype); ``lengths`` freezes each row's state at
    its own chunk length, outside the kernel.
    Returns (outputs [B, T, H], (h_T,)) — the GRU's whole carry is ``h``.
    """
    common.refuse_grad("fused_gru_layer", wx3, wh3, b, x_seq, h0)
    B, T, _ = x_seq.shape
    H = wh3.shape[0]
    keys = _gate_keys("gru", int(seed), int(layer))
    h = (torch.zeros((B, H), dtype=x_seq.dtype, device=x_seq.device)
         if h0 is None else _carry_h(h0, x_seq.dtype))
    xs = x_seq.transpose(0, 1).contiguous()            # [T, B, I]
    ys = []
    for t in range(T):
        h_new = mcd_gru.mcd_gru_step(xs[t], h, wx3, wh3, b, rows, keys,
                                     p_drop)
        if lengths is not None:
            h_new = cells.freeze_rows_h(t, lengths, h_new, h)
        h = h_new
        ys.append(h)
    return torch.stack(ys, dim=1), (h,)


def fused_gru_seq(wx3, wh3, b, x_seq, rows, seed, layer: int,
                  p_drop: float, h0=None, lengths=None, weight_bits=None,
                  wx_scale=None, wh_scale=None):
    """One kernel launch for the whole GRU sequence.

    Same contract as :func:`fused_gru_layer`; with ``weight_bits`` 8 / 4,
    ``wx3``/``wh3`` carry quantized codes and ``wx_scale``/``wh_scale`` the
    [3, H] fp32 scales (dequantized in the kernel).
    Returns (outputs [B, T, H], (h_T,)).
    """
    common.refuse_grad("fused_gru_seq", wx3, wh3, b, x_seq, h0, wx_scale,
                       wh_scale)
    keys = _gate_keys("gru", int(seed), int(layer))
    ys, hT = mcd_gru_seq.mcd_gru_seq(
        x_seq, wx3, wh3, b, rows, keys, p_drop,
        h0=_carry_h(h0, x_seq.dtype), lengths=lengths,
        weight_bits=weight_bits, wx_scale=wx_scale, wh_scale=wh_scale)
    return ys, (hT,)


def gru_stack_layer(wx, wh, b, x_seq, rows, seed, layer, p_drop: float, *,
                    seq: bool = True, initial_state=None, lengths=None,
                    precision=None):
    """Core-layout GRU entry for ``run_stack``'s kernel backends.

    Mirrors :func:`lstm_stack_layer` for
    :class:`repro_torch.core.cells.GRUParams` (wx: [3, I, H]; wh:
    [3, H, H]); ``initial_state`` is the 1-tuple ``(h0,)`` a streaming
    session stores for a GRU layer; ``precision`` as in
    :func:`lstm_stack_layer`.
    """
    common.refuse_grad("gru_stack_layer", wx, wh, b, x_seq, initial_state)
    wx3, wh3, b = cells.gate_stacked(cells.GRUParams(wx, wh, b))
    wx3, wh3, x_seq, qkw = _precision_weights(wx3, wh3, x_seq, precision,
                                              seq=seq)
    (h0,) = initial_state if initial_state is not None else (None,)
    fn = fused_gru_seq if seq else fused_gru_layer
    return fn(wx3, wh3, b.float().contiguous(), x_seq, rows, seed, layer,
              p_drop, h0=h0, lengths=lengths, **qkw)
