"""The port's weight quantization (``repro_torch.kernels.quantize``) against
the JAX reference's (``repro.kernels.quantize``), bit for bit.

Codes, scales, packed int4 bytes, ``unpack_int4``, the canonical dequant,
``fake_quant`` and ``kernel_weight`` are integers or single IEEE fp32 / bf16
roundings of the same operations in the same order, so the tolerance is
zero: every comparison is exact (``np.array_equal`` on the raw values, bf16
compared through its exact fp32 widening).  Shapes are small and few, so a
worker compiles little JAX.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import quantize as jq  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402


def _np(a) -> np.ndarray:
    """Raw values of a JAX array or a torch tensor; bf16 as its exact fp32
    widening."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _equal(ref, got):
    r, g = _np(ref), _np(got)
    assert r.dtype == g.dtype and r.shape == g.shape
    assert np.array_equal(r, g)


def _weights(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (axis, shape): kernel layout [I, G, H] (axis 0), core layout [G, I, H]
# (axis 1); odd H for the int4 pad column.
LAYOUTS = [(0, (5, 4, 7)), (0, (3, 3, 8)), (1, (4, 5, 7)), (1, (3, 16, 9))]


@pytest.mark.parametrize("axis,shape", LAYOUTS)
@pytest.mark.parametrize("bits", [8, 4])
def test_codes_and_scales_bit_equal(axis, shape, bits):
    w = _weights(shape)
    if axis == 0:
        w[:, 1, 2] = 0.0                 # an all-zero channel: scale 1
    else:
        w[1, :, 2] = 0.0
    rq, rs = jq.quantize(jnp.asarray(w), bits, axis=axis)
    gq, gs = tq.quantize(torch.from_numpy(w), bits, axis=axis)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    _equal(rq, gq)
    _equal(rs, gs)
    assert (gs == 1.0).any()             # the zero channel
    assert int(gq.abs().max()) <= tq.QMAX[bits]


def test_round_half_to_even_as_jnp_round():
    """Codes exactly between two integers round to the even one."""
    # amax 127: the scale is exactly 1, so q = round(w)
    w = np.asarray([1.0, 2.5, -3.5, 0.5, -0.5, 1.5, 127.0, 126.5],
                   np.float32).reshape(8, 1, 1)
    rq, _ = jq.quantize(jnp.asarray(w), 8, axis=0)
    gq, _ = tq.quantize(torch.from_numpy(w), 8, axis=0)
    _equal(rq, gq)
    assert gq.reshape(-1).tolist() == [1, 2, -4, 0, 0, 2, 127, 126]


@pytest.mark.parametrize("axis,shape", LAYOUTS)
def test_layouts_give_the_same_codes(axis, shape):
    """Axis 0 of the kernel layout and axis 1 of the core layout quantize
    the same channels to the same (q, scale)."""
    w = _weights(shape, seed=3)
    core = torch.from_numpy(w if axis == 1 else np.moveaxis(w, 0, 1).copy())
    kern = core.transpose(0, 1).contiguous()
    for bits in (8, 4):
        qc, sc = tq.quantize(core, bits, axis=1)
        qk, sk = tq.quantize(kern, bits, axis=0)
        assert torch.equal(qc.transpose(0, 1), qk) and torch.equal(sc, sk)


@pytest.mark.parametrize("H", [1, 2, 7, 8, 9, 16])
def test_pack_unpack_int4_bit_equal(H):
    q = np.random.default_rng(H).integers(-7, 8, size=(3, 4, H)).astype(
        np.int8)
    rp = jq.pack_int4(jnp.asarray(q))
    gp = tq.pack_int4(torch.from_numpy(q))
    assert gp.dtype == torch.uint8 and gp.shape[-1] == -(-H // 2)
    _equal(rp, gp)
    _equal(jq.unpack_int4(rp, H), tq.unpack_int4(gp, H))
    assert torch.equal(tq.unpack_int4(gp, H), torch.from_numpy(q))
    for bits in (8, 4):
        _equal(jq.packed_weight(jnp.asarray(q), bits),
               tq.packed_weight(torch.from_numpy(q), bits))


def test_two_complement_nibbles():
    """-3 stores as 0xD; the even column in the low nibble."""
    q = torch.tensor([[-3, 5]], dtype=torch.int8)
    assert tq.pack_int4(q).tolist() == [[0x5D]]
    assert tq.pack_int4(torch.tensor([[-7]], dtype=torch.int8)).tolist() == \
        [[0x9]]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("axis,shape", LAYOUTS[:3])
def test_fake_quant_bit_equal(precision, axis, shape):
    w = _weights(shape, seed=5)
    act_j = jq.activation_dtype(precision, jnp.float32)
    act_t = tq.activation_dtype(precision, torch.float32)
    assert act_t == {"fp32": torch.float32}.get(precision, torch.bfloat16)
    _equal(jq.fake_quant(jnp.asarray(w), precision, axis=axis,
                         act_dtype=act_j),
           tq.fake_quant(torch.from_numpy(w), precision, axis=axis,
                         act_dtype=act_t))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("H", [7, 8])
def test_kernel_weight_bit_equal(bits, act, H):
    """The dequant of the sequence kernels' operand, from the stored form
    (int8, or packed int4), equals the reference's and ``fake_quant``'s."""
    w = _weights((6, 3, H), seed=bits + H)
    jact = jnp.float32 if act == "fp32" else jnp.bfloat16
    tact = torch.float32 if act == "fp32" else torch.bfloat16
    rq, rs = jq.quantize(jnp.asarray(w), bits, axis=0)
    gq, gs = tq.quantize(torch.from_numpy(w), bits, axis=0)
    ref = jq.kernel_weight(jq.packed_weight(rq, bits), rs, bits, hidden=H,
                           act_dtype=jact)
    got = tq.kernel_weight(tq.packed_weight(gq, bits), gs, bits, hidden=H,
                           act_dtype=tact)
    _equal(ref, got)
    _equal(jq.dequantize(rq, rs, axis=0), tq.dequantize(gq, gs, axis=0))
    prec = "int8" if bits == 8 else "int4"
    assert torch.equal(got, tq.fake_quant(torch.from_numpy(w), prec, axis=0,
                                          act_dtype=tact))


@pytest.mark.parametrize("I,H,G", [(1, 8, 4), (8, 8, 3), (16, 16, 4),
                                   (3, 9, 3)])
def test_weight_bytes_equal(I, H, G):
    for precision in (None, "fp32", "bf16", "int8", "int4"):
        assert tq.weight_bytes(I, H, G, precision) == \
            jq.weight_bytes(I, H, G, precision)


def test_precision_names_and_checks():
    assert tq.PRECISIONS == jq.PRECISIONS
    assert tq.WEIGHT_BITS == jq.WEIGHT_BITS and tq.QMAX == jq.QMAX
    assert tq.QUANTIZED == jq.QUANTIZED
    assert tq.activation_dtype(None, torch.float64) == torch.float64
    for bad in ("fp16", "int2", 8):
        with pytest.raises(ValueError, match="precision"):
            tq.check_precision(bad)
        with pytest.raises(ValueError):
            jq.check_precision(bad)


@pytest.mark.parametrize("p", [0.125, 0.1, 0.2, 0.3, 0.05, 0.37, 0.5, 0.9])
def test_bf16_dropout_scale_as_the_reference_rounds_it(p):
    """``common.scale`` at bf16 is ``jnp.asarray(1/(1-p), bf16)``: rounded
    once from the double; the kernels' launch scale is that value."""
    ref = jnp.asarray(1.0 / (1.0 - p), jnp.bfloat16)
    _equal(ref, common.scale(p, torch.bfloat16))
    assert common.mask_args(p, torch.bfloat16)[1] == float(
        ref.astype(jnp.float32))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.integers(1, 3), st.integers(1, 11),
       st.sampled_from([8, 4]), st.integers(0, 2 ** 16))
def test_quantize_pack_roundtrip_any_width(D, G, H, bits, seed):
    """Any [D, G, H]: codes equal the reference's, the packed form unpacks
    to them, and the dequant from the packed form equals ``fake_quant``."""
    w = np.random.default_rng(seed).standard_normal((D, G, H)).astype(
        np.float32)
    gq, gs = tq.quantize(torch.from_numpy(w), bits, axis=0)
    rq, rs = jq.quantize(jnp.asarray(w), bits, axis=0)
    _equal(rq, gq)
    _equal(rs, gs)
    packed = tq.packed_weight(gq, bits)
    if bits == 4:
        assert torch.equal(tq.unpack_int4(packed, H), gq)
    prec = "int8" if bits == 8 else "int4"
    assert torch.equal(
        tq.kernel_weight(packed, gs, bits, hidden=H,
                         act_dtype=torch.bfloat16),
        tq.fake_quant(torch.from_numpy(w), prec, axis=0,
                      act_dtype=torch.bfloat16))
