"""The port's counter-PRNG mask stream is bit-equal to the JAX reference.

Same uint32 inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch``; every comparison is exact (the stream is integer-only).
Rows cover the student flag (the uint32 high bit), ids near 2**31 and
``row * n_feat + col`` products that wrap past 2**32.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mcd as jmcd, prng as jprng  # noqa: E402
from repro.kernels import mcd_lstm as jlstm  # noqa: E402
from repro_torch.core import mcd as tmcd, prng as tprng  # noqa: E402
from repro_torch.kernels import mcd_lstm as tlstm  # noqa: E402
from repro_torch.kernels import mcd_lstm_seq as tseq  # noqa: E402

EDGE_ROWS = [0, 1, 2 ** 31 - 1, 2 ** 31 - 3, 2 ** 31, 2 ** 31 + 7,
             2 ** 32 - 1, 0x7FFF_0000, 123_456_789]


def _rows(seed: int, n: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([np.asarray(EDGE_ROWS, np.uint32), r])


def _t(rows: np.ndarray) -> "torch.Tensor":
    return torch.from_numpy(rows.astype(np.int64))


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_bit_equal(seed):
    x = _rows(seed, 4096)
    assert np.array_equal(_u32(jprng._mix32(jnp.asarray(x))),
                          tprng._mix32(_t(x)).numpy())


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 32 - 1])
def test_fold_ids_bit_equal(seed):
    rng = np.random.default_rng(seed % 1000)
    for _ in range(8):
        ids = [int(v) for v in rng.integers(0, 2 ** 32, size=3,
                                            dtype=np.uint64)]
        assert int(jprng.fold_ids(seed, *ids)) == int(
            tprng.fold_ids(seed, *ids))
    ids = _rows(seed % 1000)
    assert np.array_equal(_u32(jprng.fold_ids(seed, 3, jnp.asarray(ids))),
                          tprng.fold_ids(seed, 3, _t(ids)).numpy())


@pytest.mark.parametrize("p", [0.0, 1e-9, 0.125, 0.3, 0.5, 0.999999])
def test_keep_threshold_equal(p):
    assert int(jprng.bernoulli_keep_threshold(p)) == \
        tprng.bernoulli_keep_threshold(p)


@pytest.mark.parametrize("seed,layer,kind,gate", [
    (0, 0, jmcd.KIND_X, 0), (11, 2, jmcd.KIND_H, 3), (2 ** 31, 5, 2, 1)])
def test_mask_key_equal(seed, layer, kind, gate):
    assert int(jmcd.mask_key(seed, layer, kind, gate)) == int(
        tmcd.mask_key(seed, layer, kind, gate))


@pytest.mark.parametrize("seed,layer,n_feat,p", [
    (0, 0, 1, 0.125), (5, 1, 8, 0.125), (9, 2, 16, 0.5),
    (13, 3, 129, 0.25), (2 ** 31 - 1, 0, 1000, 0.125)])
def test_feature_mask_bit_equal(seed, layer, n_feat, p):
    rows = _rows(seed % 97)
    for kind, gate in [(jmcd.KIND_X, 0), (jmcd.KIND_H, 2)]:
        ref = np.asarray(jmcd.feature_mask(seed, layer, jnp.asarray(rows),
                                           n_feat, p, kind=kind, gate=gate))
        got = tmcd.feature_mask(seed, layer, _t(rows), n_feat, p, kind=kind,
                                gate=gate).numpy()
        assert got.shape == (len(rows), n_feat)
        assert np.array_equal(ref, got)


def test_index_wraps_past_2_32():
    """row * n_feat overflows uint32 for these rows: the stream wraps."""
    rows = np.asarray([2 ** 31 - 1, 2 ** 30 + 3, 2 ** 32 - 2], np.uint32)
    n_feat = 24
    assert (rows.astype(np.uint64) * n_feat >= 2 ** 32).all()
    ref = np.asarray(jmcd.feature_mask(3, 1, jnp.asarray(rows), n_feat, 0.5))
    got = tmcd.feature_mask(3, 1, _t(rows), n_feat, 0.5).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("seed,layer,in_dim,hidden", [
    (0, 0, 1, 8), (3, 1, 8, 8), (17, 2, 5, 13)])
def test_lstm_gate_masks_bit_equal(seed, layer, in_dim, hidden):
    rows = _rows(seed)
    zx, zh = jmcd.lstm_gate_masks(seed, layer, jnp.asarray(rows), in_dim,
                                  hidden, 0.125)
    tx, th = tmcd.lstm_gate_masks(seed, layer, _t(rows), in_dim, hidden,
                                  0.125)
    assert np.array_equal(np.asarray(zx), tx.numpy())
    assert np.array_equal(np.asarray(zh), th.numpy())


@pytest.mark.parametrize("seed,layer", [(0, 0), (11, 2), (2 ** 32 - 1, 7)])
def test_gate_keys_bit_equal(seed, layer):
    assert np.array_equal(_u32(jlstm.gate_keys(seed, layer)),
                          tlstm.gate_keys(seed, layer).numpy())


@pytest.mark.parametrize("feat,p", [(1, 0.125), (8, 0.5), (33, 0.25)])
def test_kernel_gate_mask_rule_equal(feat, p):
    rows = _rows(feat)
    key = int(jlstm.gate_keys(4, 1)[0, 5])
    ref = np.asarray(jlstm._gate_mask(key, jnp.asarray(rows).astype(jnp.int32),
                                      0, (len(rows), feat), feat, p))
    # int32 rows (the kernel's view, student flag = sign bit) and uint32
    # rows draw the same bits.
    for rows_t in (_t(rows), tseq.rows_to_int32(_t(rows))):
        assert np.array_equal(ref, tlstm._gate_mask(key, rows_t, feat,
                                                    p).numpy())


@pytest.mark.parametrize("p", [0.0, 0.125])
def test_mask_factors_match_reference_views(p):
    """The kernel's per-gate factors reproduce where(det, 1, z/(1-p))."""
    rows = _rows(5)
    in_dim, hidden, seed, layer = 3, 8, 21, 1
    fx, fh = tseq.gate_mask_factors(tlstm.gate_keys(seed, layer), _t(rows),
                                    in_dim, hidden, p)
    det = np.asarray(jmcd.det_row_mask(jnp.asarray(rows)))[:, None, None]
    if p == 0.0:
        assert (fx.numpy() == 1).all() and (fh.numpy() == 1).all()
        return
    zx, zh = jmcd.lstm_gate_masks(seed, layer, jnp.asarray(rows), in_dim,
                                  hidden, p)
    scale = np.float32(1.0 / (1.0 - p))
    for z, f in ((zx, fx), (zh, fh)):
        ref = np.where(det, np.float32(1), np.asarray(z) * scale)
        assert np.array_equal(ref, f.numpy())


def test_student_row_helpers_equal():
    rows = _rows(1)
    assert np.array_equal(np.asarray(jmcd.det_row_mask(jnp.asarray(rows))),
                          tmcd.det_row_mask(_t(rows)).numpy())
    for r in (0, 5, 2 ** 31 - 1):
        assert tmcd.student_row(r) == jmcd.student_row(r)
        assert tmcd.base_row(tmcd.student_row(r)) == r
        assert tmcd.is_student_row(tmcd.student_row(r))
    assert tmcd.STUDENT_ROW_FLAG == jmcd.STUDENT_ROW_FLAG
    assert tseq.rows_to_int32(_t(np.asarray([2 ** 31 + 2], np.uint32))
                              ).item() == -(2 ** 31) + 2


def test_placement_and_config_equal():
    for b in ("YNY", "N", "ynyn"):
        assert tmcd.parse_placement(b) == jmcd.parse_placement(b)
    cfg = tmcd.MCDConfig(placement="YN")
    assert [cfg.bayesian(i) for i in range(4)] == [True, False, True, False]
    with pytest.raises(ValueError):
        tmcd.MCDConfig(p=1.0)
    with pytest.raises(ValueError):
        tmcd.parse_placement("YX")
