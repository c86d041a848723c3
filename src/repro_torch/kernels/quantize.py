"""Per-channel symmetric weight quantization for the serving kernels — port
of ``repro.kernels.quantize``.

The paper's co-design treats bit-width as a first-class axis: the FPGA
design runs 16-bit fixed point and trades precision against DSPs and
accuracy.  The serving analogue here is *weight* quantization in the
sequence-fused kernels: int8 halves and packed int4 quarters the weight
bytes a layer keeps resident, while activations stay bf16 and the gate sums
accumulate in fp32.

One scheme, shared by every backend (the port's kernels, their plain
versions and the ``reference`` cells), and bit-equal to the reference's:

* **Symmetric, per-output-channel scales.**  For a gate-stacked weight
  ``w[..., G, H]`` each output channel ``(g, h)`` gets
  ``scale = max_i |w[i, g, h]| / qmax`` (one IEEE fp32 division) with
  ``qmax = 2^(bits-1) - 1``; ``q = clip(round(w / scale), ±qmax)``, where
  ``torch.round`` rounds half to even as ``jnp.round`` does.  The reduction
  axis is the contraction axis, so kernel layout ``[I, G, H]`` (axis 0) and
  core layout ``[G, I, H]`` (axis 1) give the same ``(q, scale)``.
* **Canonical dequant** ``w = (float32(q) * scale).to(act)``: the sequence
  kernels apply it in registers to their int operands, the step kernels'
  wrappers and the ``reference`` cells apply it outside -- the same values.
* **int4 packs two's-complement nibbles** two to a byte along the last
  (H) axis, the even column in the low nibble, an odd H padded.
* Biases are never quantized; they enter the gate sums in fp32.

``precision``: ``None`` (the caller's dtypes), ``"fp32"``, ``"bf16"`` (a
cast), ``"int8"``, ``"int4"`` (quantized weights over bf16 activations).
"""

from __future__ import annotations

import torch

#: The serving-precision axis (``None``, not listed, keeps native dtypes).
PRECISIONS = ("fp32", "bf16", "int8", "int4")

#: Weight storage bits per precision (fp32/bf16 are plain casts).
WEIGHT_BITS = {"fp32": 32, "bf16": 16, "int8": 8, "int4": 4}

#: Symmetric integer range: qmax = 2^(bits-1) - 1.
QMAX = {8: 127, 4: 7}

#: Precisions whose weights are integer-quantized (vs plain casts).
QUANTIZED = ("int8", "int4")


def check_precision(precision) -> None:
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS} or None, "
                         f"got {precision!r}")


def activation_dtype(precision, default):
    """The activation / carry dtype a precision runs with: fp32 for
    ``"fp32"``, bf16 for bf16/int8/int4, ``default`` for ``None``."""
    if precision is None:
        return default
    check_precision(precision)
    return torch.float32 if precision == "fp32" else torch.bfloat16


def quantize(w: torch.Tensor, bits: int, *, axis: int):
    """Symmetric per-output-channel quantization of ``w`` along ``axis``
    (the contraction axis).  Returns ``(q int8, scale fp32)`` with
    ``scale.shape`` = ``w.shape`` without ``axis``; an all-zero channel
    gets scale 1.0."""
    qmax = QMAX[bits]
    w = w.to(torch.float32)
    amax = torch.amax(torch.abs(w), dim=axis)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.round(w / scale.unsqueeze(axis))
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, *,
               axis: int) -> torch.Tensor:
    """The canonical dequant: ``float32(q) * scale`` broadcast over
    ``axis``, fp32."""
    return q.to(torch.float32) * scale.unsqueeze(axis)


def fake_quant(w: torch.Tensor, precision: str, *, axis: int, act_dtype):
    """Quantize then dequantize (the ``reference`` and step paths): for the
    cast precisions just ``w.to(act_dtype)``; for int8/int4 exactly the
    values the sequence kernels dequantize in registers."""
    if precision in QUANTIZED:
        q, s = quantize(w, WEIGHT_BITS[precision], axis=axis)
        return dequantize(q, s, axis=axis).to(act_dtype)
    return w.to(act_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 in [-7, 7]) two to a byte along the last axis
    (an odd length padded): uint8 ``[..., ceil(H/2)]``, the even column in
    the low nibble, two's-complement nibbles (-3 stores as 0xD)."""
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    u = q.to(torch.uint8)
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (lo & 0xF) | ((hi & 0xF) << 4)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Invert :func:`pack_int4`: ``[..., ceil(n/2)] uint8 -> [..., n] int8``
    (each nibble sign-extended, low then high, the pad column dropped)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    nib = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    nib = nib[..., :n]
    return torch.where(nib >= 8, nib - 16, nib)


def packed_weight(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Storage form of a quantized weight: int8 as is, int4 nibble-packed."""
    return pack_int4(q) if bits == 4 else q


def kernel_weight(w_codes: torch.Tensor, scale: torch.Tensor, bits: int, *,
                  hidden: int, act_dtype) -> torch.Tensor:
    """The dequant the sequence kernels run on their quantized weight
    operand: ``w_codes`` ``[D, G, H]`` int8, or ``[D, G, ceil(H/2)]`` uint8
    when int4-packed; ``scale`` ``[G, H]`` fp32.  Returns the ``[D, G, H]``
    activation-dtype weights, exactly :func:`fake_quant`'s values."""
    q = unpack_int4(w_codes, hidden) if bits == 4 else w_codes
    return dequantize(q, scale, axis=0).to(act_dtype)


def weight_bytes(in_dim: int, hidden: int, gates: int, precision) -> int:
    """Resident weight bytes of one layer at a precision: ``wx [I, G, H]``
    and ``wh [H, G, H]`` at the storage width, the two fp32 ``[G, H]``
    scales of a quantized precision, and the fp32 bias (``None`` prices as
    fp32)."""
    bits = WEIGHT_BITS.get(precision, 32)
    total = (in_dim + hidden) * gates * hidden * bits // 8
    if precision in QUANTIZED:
        total += 2 * gates * hidden * 4
    total += gates * hidden * 4
    return total
