"""The LM kernels' plain versions against the JAX reference oracles.

* ``masked_activation_plain`` against ``repro.kernels.ref.masked_activation``
  bit for bit (p = 0.1 and p = 0, a row with the high bit set: these
  kernels mask every row, no student exemption).
* ``mcd_matmul_plain`` against ``ref.mcd_matmul`` (x's dtype out) and the
  fp32 product the LM's SwiGLU asks for: 1e-5 absolute (fp32 sums in
  another order).
* ``decode_attention_plain`` against ``ref.decode_attention``: 1e-6
  absolute (softmax-weighted means of unit-scale values), pos at 0, in the
  middle and last, rep = 2, a cache length that is not a multiple of the
  TPU kernel's 512-position block; with ``pos`` an int32 tensor (as the
  TPU kernel takes it) equal to the int, and to the reference with a
  ``jnp`` pos, also at pos >= S (every position live).
* ``ops.site_key`` against ``mcd.mask_key`` (exact), and the ops wrappers
  on CPU tensors against the oracles under those keys.

Inputs are made with numpy from a seed; the JAX side runs the jnp oracles
of ``repro.kernels.ref`` (no interpret-mode Pallas), few shapes.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mcd as jmcd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import bernoulli_mask as tmask  # noqa: E402
from repro_torch.kernels import decode_attn as tattn  # noqa: E402
from repro_torch.kernels import mcd_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ROWS = np.asarray([0, 5, 2 ** 31 + 4, 9, 2 ** 31 - 1, 40], np.uint32)
F = 40


def _key(seed=3, layer=1, site=0):
    return int(np.asarray(jmcd.mask_key(seed, layer, jmcd.KIND_FEAT, site)))


def _x(shape, seed=0, k=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * k).astype(
        np.float32)


def _rows_t(rows=ROWS):
    return torch.from_numpy(rows.astype(np.int64))


@pytest.mark.parametrize("p", [0.1, 0.0])
def test_masked_activation_bit_equal(p):
    x = _x((len(ROWS), F))
    key = _key()
    want = np.asarray(jref.masked_activation(jnp.asarray(x),
                                             jnp.asarray(ROWS), key, p))
    got = tmask.masked_activation_plain(torch.from_numpy(x), _rows_t(), key,
                                        p).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def test_high_bit_rows_are_masked():
    """No student exemption: at p = 0.5 a high-bit row drops some of its
    40 features and keeps others, as the reference's stream says."""
    x = np.ones((len(ROWS), F), np.float32)
    got = tmask.masked_activation_plain(torch.from_numpy(x), _rows_t(),
                                        _key(), 0.5).numpy()
    want = np.asarray(jref.masked_activation(jnp.asarray(x),
                                             jnp.asarray(ROWS), _key(), 0.5))
    hi = ROWS >= 2 ** 31
    assert (got[hi] == 0).any(axis=1).all()
    assert (got[hi] == 2).any(axis=1).all()
    assert np.array_equal(got, want)


def test_masked_activation_int32_rows_draw_the_same_bits():
    x = np.ones((len(ROWS), F), np.float32)
    key = _key(7, 2, 1)
    a = tmask.masked_activation_plain(torch.from_numpy(x), _rows_t(), key,
                                      0.1)
    r32 = torch.from_numpy(ROWS.view(np.int32).copy())
    b = tmask.masked_activation_plain(torch.from_numpy(x), r32, key, 0.1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_mcd_matmul_matches_ref(p, out_dtype):
    x = _x((len(ROWS), F), 1)
    w = _x((F, 24), 2, k=F ** -0.5)
    key = _key(5, 0, 1)
    want = np.asarray(jref.mcd_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(ROWS), key, p))
    got = tmm.mcd_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                               _rows_t(), key, p, out_dtype)
    assert got.dtype == torch.float32 and got.shape == (len(ROWS), 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_mcd_matmul_casts_to_out_dtype():
    x = _x((len(ROWS), F), 3)
    w = _x((F, 8), 4, k=F ** -0.5)
    key = _key(5, 0, 1)
    f32 = tmm.mcd_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                               _rows_t(), key, 0.1, torch.float32)
    bf = tmm.mcd_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                              _rows_t(), key, 0.1, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, f32.to(torch.bfloat16))


@pytest.mark.parametrize("pos", [0, 17, 39])
def test_decode_attention_matches_ref(pos):
    B, H, KV, hd, S = 3, 4, 2, 16, 40
    q = _x((B, H, hd), 5)
    kc = _x((B, S, KV, hd), 6)
    vc = _x((B, S, KV, hd), 7)
    want = np.asarray(jref.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                            jnp.asarray(vc), pos))
    got = tattn.decode_attention_plain(torch.from_numpy(q),
                                       torch.from_numpy(kc),
                                       torch.from_numpy(vc), pos)
    assert got.shape == (B, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pos", [0, 17, 39, 40, 57])
def test_decode_attention_tensor_pos_matches_int_and_ref(pos):
    B, H, KV, hd, S = 3, 4, 2, 16, 40
    q = _x((B, H, hd), 5)
    kc = _x((B, S, KV, hd), 6)
    vc = _x((B, S, KV, hd), 7)
    want = np.asarray(jref.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                            jnp.asarray(vc),
                                            jnp.int32(pos)))
    args = [torch.from_numpy(a) for a in (q, kc, vc)]
    pos_t = torch.tensor([pos], dtype=torch.int32)
    by_int = tattn.decode_attention_plain(*args, pos)
    by_tensor = tattn.decode_attention_plain(*args, pos_t)
    assert torch.equal(by_tensor, by_int)
    assert torch.equal(tattn.decode_attention(*args, pos_t), by_int)
    np.testing.assert_allclose(by_tensor.numpy(), want, rtol=0, atol=1e-6)


def test_decode_attention_ignores_positions_past_pos():
    B, H, KV, hd, S = 2, 4, 2, 16, 12
    q, kc, vc = (torch.from_numpy(_x(s, i)) for i, s in enumerate(
        [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)]))
    a = tattn.decode_attention(q, kc, vc, 5)
    kc[:, 6:] = 1e4
    vc[:, 6:] = -1e4
    assert torch.equal(a, tattn.decode_attention(q, kc, vc, 5))


@pytest.mark.parametrize("seed,layer,site", [(0, 0, 0), (3, 27, 1),
                                             (123456, 5, 1)])
def test_site_keys_equal_mask_key(seed, layer, site):
    assert tops.site_key(seed, layer, site) == _key(seed, layer, site)


def test_ops_wrappers_on_cpu_match_the_oracles():
    x = _x((len(ROWS), F), 8)
    w = _x((F, 16), 9, k=F ** -0.5)
    seed, layer = 4, 3
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = tops.mcd_mask_apply(xt, _rows_t(), seed, layer, 0, 0.1)
    want = jref.masked_activation(jnp.asarray(x), jnp.asarray(ROWS),
                                  _key(seed, layer, 0), 0.1)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = tops.mcd_dense(xt, wt, _rows_t(), seed, layer, 1, 0.1,
                         out_dtype=torch.float32)
    want = jref.mcd_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ROWS),
                           _key(seed, layer, 1), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
