"""The port's GRU against the JAX reference: masks, cell, kernels, stack.

* ``gru_gate_masks`` and the 6 GRU stream keys, bit for bit (student rows
  included).
* ``cells.gru_step`` and ``freeze_rows_h``.
* The plain versions the CUDA wrappers run on CPU tensors —
  ``mcd_gru_seq_plain``, ``mcd_gru_step_plain`` and ``mcd_lstm_step_plain``
  — against ``repro.kernels.ref`` (h0, ragged lengths, student rows), and
  ``mcd_gru_seq_plain`` once against the Pallas kernel in interpret mode.
* ``run_stack(cell="gru")`` on the port's three backends against JAX
  ``run_stack(backend="reference")``.

Inputs and weights are made with numpy from a seed.  Tolerance: 1e-5
absolute for fp32 floats (the JAX backends themselves differ by up to
1.2e-7); integers (mask bits, keys) exactly equal.  One small shape is
reused, so a worker compiles few JAX programs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cells as jcells, mcd as jmcd, rnn as jrnn  # noqa: E402
from repro.kernels import mcd_gru as jgru, mcd_lstm as jlstm  # noqa: E402
from repro.kernels import mcd_gru_seq as jgseq, ref as jref  # noqa: E402
from repro_torch.core import cells as tcells  # noqa: E402
from repro_torch.core import mcd as tmcd, rnn as trnn  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import mcd_gru as tgru  # noqa: E402
from repro_torch.kernels import mcd_gru_seq as tgseq  # noqa: E402
from repro_torch.kernels import mcd_lstm as tlstm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5
SEED, LAYER = 11, 2
B, T, I, H = 6, 9, 3, 5
ROWS = np.asarray([0, 1, 2 ** 31 + 4, 9, 2 ** 31 - 1, 40], np.uint32)
LENS = np.asarray([9, 3, 5, 1, 9, 6], np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rows_t(rows=ROWS):
    return torch.from_numpy(rows.astype(np.int64))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _layer(gates=3, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, k=1.0):
        return (rng.standard_normal(shape) * k).astype(np.float32)

    return dict(x=f(B, T, I), wx=f(I, gates, H, k=0.5),
                wh=f(H, gates, H, k=0.5), b=f(gates, H, k=0.1),
                h0=f(B, H, k=0.5), c0=f(B, H, k=0.5))


# -- masks and keys ---------------------------------------------------------

@pytest.mark.parametrize("seed,layer,in_dim,hidden", [
    (0, 0, 1, 16), (3, 1, 16, 8), (17, 2, 5, 13)])
def test_gru_gate_masks_bit_equal(seed, layer, in_dim, hidden):
    rows = np.concatenate([ROWS, np.asarray([2 ** 32 - 1, 123_456_789],
                                            np.uint32)])
    zx, zh = jmcd.gru_gate_masks(seed, layer, jnp.asarray(rows), in_dim,
                                 hidden, 0.125)
    tx, th = tmcd.gru_gate_masks(seed, layer, _rows_t(rows), in_dim, hidden,
                                 0.125)
    assert tx.shape == (len(rows), 3, in_dim)
    assert np.array_equal(np.asarray(zx), tx.numpy())
    assert np.array_equal(np.asarray(zh), th.numpy())


@pytest.mark.parametrize("seed,layer", [(0, 0), (11, 2), (2 ** 32 - 1, 7)])
def test_gru_gate_keys_bit_equal(seed, layer):
    ref = np.asarray(jgru.gate_keys(seed, layer)).astype(np.int64)
    assert np.array_equal(ref, tgru.gate_keys(seed, layer).numpy())


@pytest.mark.parametrize("p", [0.0, 0.125])
def test_gru_mask_factors_match_reference_views(p):
    """The kernels' six factors reproduce where(det, 1, z/(1-p))."""
    fx, fh = tcommon.gate_mask_factors(tgru.gate_keys(SEED, LAYER),
                                       _rows_t(), I, H, p)
    assert fx.shape == (B, 3, I) and fh.shape == (B, 3, H)
    if p == 0.0:
        assert (fx == 1).all() and (fh == 1).all()
        return
    det = np.asarray(jmcd.det_row_mask(jnp.asarray(ROWS)))[:, None, None]
    zx, zh = jmcd.gru_gate_masks(SEED, LAYER, jnp.asarray(ROWS), I, H, p)
    scale = np.float32(1.0 / (1.0 - p))
    for z, f in ((zx, fx), (zh, fh)):
        ref = np.where(det, np.float32(1), np.asarray(z) * scale)
        assert np.array_equal(ref, f.numpy())


# -- the cell ---------------------------------------------------------------

def test_gru_step_and_freeze_match_jax():
    d = _layer()
    rows = jnp.asarray(ROWS)
    zx, zh = jmcd.gru_gate_masks(SEED, LAYER, rows, I, H, 0.25)
    jp = jcells.GRUParams(*(jnp.asarray(d[k]).transpose(1, 0, 2)
                            if k != "b" else jnp.asarray(d[k])
                            for k in ("wx", "wh", "b")))
    det = jmcd.det_row_mask(rows)
    x0 = jnp.asarray(d["x"][:, 0])
    ref = jcells.gru_step(jp, jnp.asarray(d["h0"]), x0, zx, zh, 0.25,
                          det=det)
    ref_frozen = jcells.freeze_rows_h(3, jnp.asarray(LENS), ref,
                                      jnp.asarray(d["h0"]))
    tp = tcells.GRUParams(*(_t(np.array(a)) for a in jp))
    tx, th = tmcd.gru_gate_masks(SEED, LAYER, _rows_t(), I, H, 0.25)
    got = tcells.gru_step(tp, _t(d["h0"]), _t(d["x"][:, 0]), tx, th, 0.25,
                          det=tmcd.det_row_mask(_rows_t()))
    got_frozen = tcells.freeze_rows_h(3, _t(LENS), got, _t(d["h0"]))
    assert got.dtype == torch.float32
    _close(ref, got)
    _close(ref_frozen, got_frozen)


def test_gate_stacked_gru_layout():
    d = _layer()
    params = (d["wx"].transpose(1, 0, 2), d["wh"].transpose(1, 0, 2), d["b"])
    ref = jcells.gate_stacked(jcells.GRUParams(*map(jnp.asarray, params)))
    got = tcells.gate_stacked(tcells.GRUParams(*map(_t, params)))
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
        assert g.is_contiguous()


# -- the plain kernels --------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.25])
def test_gru_seq_plain_matches_ref(p):
    """h0 carried state, ragged lengths and student rows."""
    d = _layer()
    ref = jref.mcd_gru_seq(
        jnp.asarray(d["x"]), jnp.asarray(d["wx"]), jnp.asarray(d["wh"]),
        jnp.asarray(d["b"]), jnp.asarray(ROWS), jgru.gate_keys(SEED, LAYER),
        p, h0=jnp.asarray(d["h0"]), lengths=jnp.asarray(LENS))
    got = tgseq.mcd_gru_seq_plain(
        _t(d["x"]), _t(d["wx"]), _t(d["wh"]), _t(d["b"]), _rows_t(),
        tgru.gate_keys(SEED, LAYER), p, h0=_t(d["h0"]), lengths=_t(LENS))
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        _close(r, g)
    ys = got[0].numpy()
    for b, L in enumerate(LENS):        # frozen rows repeat their last h
        assert (ys[b, L:] == ys[b, L - 1]).all()


def test_gru_seq_plain_matches_pallas_interpret():
    """The one interpret-mode Pallas call of this file, at a tiny size."""
    d = _layer(seed=1)
    ref = jgseq.mcd_gru_seq(
        jnp.asarray(d["x"]), jnp.asarray(d["wx"]), jnp.asarray(d["wh"]),
        jnp.asarray(d["b"]), jnp.asarray(ROWS), jgru.gate_keys(SEED, LAYER),
        0.25, h0=jnp.asarray(d["h0"]), lengths=jnp.asarray(LENS),
        interpret=True)
    got = tgseq.mcd_gru_seq_plain(
        _t(d["x"]), _t(d["wx"]), _t(d["wh"]), _t(d["b"]), _rows_t(),
        tgru.gate_keys(SEED, LAYER), 0.25, h0=_t(d["h0"]),
        lengths=_t(LENS))
    for r, g in zip(ref, got):
        _close(r, g)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("p", [0.0, 0.25])
def test_step_plain_matches_ref(cell, p):
    gates = 3 if cell == "gru" else 4
    d = _layer(gates, seed=2)
    x, h, c = d["x"][:, 0], d["h0"], d["c0"]
    w = (d["wx"], d["wh"], d["b"])
    if cell == "gru":
        ref = (jref.mcd_gru_step(jnp.asarray(x), jnp.asarray(h),
                                 *map(jnp.asarray, w), jnp.asarray(ROWS),
                                 jgru.gate_keys(SEED, LAYER), p),)
        got = (tgru.mcd_gru_step_plain(_t(x), _t(h), *map(_t, w), _rows_t(),
                                       tgru.gate_keys(SEED, LAYER), p),)
    else:
        ref = jref.mcd_lstm_step(jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(c), *map(jnp.asarray, w),
                                 jnp.asarray(ROWS),
                                 jlstm.gate_keys(SEED, LAYER), p)
        got = tlstm.mcd_lstm_step_plain(_t(x), _t(h), _t(c), *map(_t, w),
                                        _rows_t(),
                                        tlstm.gate_keys(SEED, LAYER), p)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32 and g.shape == (B, H)
        _close(r, g)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_step_wrappers_take_plain_version_on_cpu(cell):
    """CPU tensors run the plain version and launch nothing."""
    gates = 3 if cell == "gru" else 4
    d = _layer(gates, seed=3)
    mod = tgru if cell == "gru" else tlstm
    step = tgru.mcd_gru_step if cell == "gru" else tlstm.mcd_lstm_step
    plain = (tgru.mcd_gru_step_plain if cell == "gru"
             else tlstm.mcd_lstm_step_plain)
    carry = (_t(d["h0"]),) if cell == "gru" else (_t(d["h0"]), _t(d["c0"]))
    args = (_t(d["x"][:, 0]), *carry, _t(d["wx"]), _t(d["wh"]), _t(d["b"]),
            _rows_t(), mod.gate_keys(SEED, LAYER), 0.25)
    before = step.launches
    a, b = step(*args), plain(*args)
    assert step.launches == before
    for u, v in zip(a if cell == "lstm" else (a,),
                    b if cell == "lstm" else (b,)):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="cpu or cuda"):
        x = torch.zeros((2, 3), device="meta")
        step(x, *([x] * (len(args) - 3)), mod.gate_keys(0, 0), 0.1)


def test_gru_seq_plain_chunked_equals_unchunked_bitwise():
    d = _layer(seed=4)
    args = (_t(d["wx"]), _t(d["wh"]), _t(d["b"]), _rows_t(),
            tgru.gate_keys(SEED, LAYER), 0.125)
    full = tgseq.mcd_gru_seq_plain(_t(d["x"]), *args, h0=_t(d["h0"]))
    y1, h1 = tgseq.mcd_gru_seq_plain(_t(d["x"][:, :4]), *args,
                                     h0=_t(d["h0"]))
    y2, h2 = tgseq.mcd_gru_seq_plain(_t(d["x"][:, 4:]), *args, h0=h1)
    assert torch.equal(full[0], torch.cat([y1, y2], dim=1))
    assert torch.equal(full[1], h2)


def test_tile_rows_fit_shared_memory():
    assert tcommon.tile_rows(3, 1, 16) == 8
    assert tcommon.tile_rows(3, 128, 128) == 1
    assert tcommon.tile_rows(3, 16, 8) == 16
    with pytest.raises(NotImplementedError):
        tcommon.tile_rows(3, 8, 2048)


# -- the stack --------------------------------------------------------------

NL, SI, SH = 3, 2, 6          # layers, stack input width, hidden


def _stack(seed=3):
    rng = np.random.default_rng(seed)
    params = []
    for d_in in (SI,) + (SH,) * (NL - 1):
        params.append(tuple((rng.standard_normal(s) * k).astype(np.float32)
                            for s, k in (((3, d_in, SH), 0.5),
                                         ((3, SH, SH), 0.5), ((3, SH), 0.1))))
    x = rng.standard_normal((B, T, SI)).astype(np.float32)
    init = [((rng.standard_normal((B, SH)) * 0.5).astype(np.float32),)
            for _ in range(NL)]
    return params, x, init


@pytest.fixture(scope="module")
def jax_gru_stack_ref():
    params, x, init = _stack()
    cfg = jmcd.MCDConfig(p=0.25, placement="YNY", seed=SEED)
    jp = [jcells.GRUParams(*map(jnp.asarray, lp)) for lp in params]
    masks = jrnn.sample_stack_masks(cfg, jnp.asarray(ROWS), SI, (SH,) * NL,
                                    cell="gru")
    out, states = jrnn.run_stack(
        jp, jnp.asarray(x), masks, cfg.p, backend="reference",
        rows=jnp.asarray(ROWS), seed=cfg.seed,
        initial_state=[tuple(map(jnp.asarray, s)) for s in init],
        lengths=jnp.asarray(LENS), return_all_states=True, cell="gru")
    return (np.asarray(out),
            [tuple(np.asarray(a) for a in s) for s in states])


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_gru_run_stack_matches_jax_reference(jax_gru_stack_ref, backend):
    params, x, init = _stack()
    cfg = tmcd.MCDConfig(p=0.25, placement="YNY", seed=SEED)
    tp = [tcells.GRUParams(*map(_t, lp)) for lp in params]
    rows = _rows_t()
    masks = (trnn.sample_stack_masks(cfg, rows, SI, (SH,) * NL, cell="gru")
             if backend == "reference" else trnn.stack_mask_plan(cfg, NL))
    out, states = trnn.run_stack(
        tp, _t(x), masks, cfg.p, backend=backend, rows=rows, seed=cfg.seed,
        initial_state=[tuple(map(_t, s)) for s in init], lengths=_t(LENS),
        return_all_states=True, cell="gru", device="cpu")
    ref_out, ref_states = jax_gru_stack_ref
    _close(ref_out, out)
    for ref_state, state in zip(ref_states, states):
        assert len(state) == 1          # the GRU carries (h,) alone
        _close(ref_state[0], state[0])
    _, last = trnn.run_stack(
        tp, _t(x), masks, cfg.p, backend=backend, rows=rows, seed=cfg.seed,
        lengths=_t(LENS), return_sequence=False, cell="gru", device="cpu")
    assert len(last) == 1 and last[0].shape == (B, SH)


def test_kernel_backends_bit_equal_on_cpu():
    """cuda_step and cuda_seq run the same plain body on the CPU."""
    params, x, init = _stack()
    cfg = tmcd.MCDConfig(p=0.25, placement="YNY", seed=SEED)
    tp = [tcells.GRUParams(*map(_t, lp)) for lp in params]
    outs = [trnn.run_stack(tp, _t(x), trnn.stack_mask_plan(cfg, NL), cfg.p,
                           backend=backend, rows=_rows_t(), seed=cfg.seed,
                           initial_state=[tuple(map(_t, s)) for s in init],
                           lengths=_t(LENS), return_all_states=True,
                           cell="gru", device="cpu")
            for backend in ("cuda_step", "cuda_seq")]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a[0], b[0])


def test_unknown_cell_raises():
    with pytest.raises(ValueError, match="cell"):
        trnn.init_stack(torch.Generator(), 1, (4,), cell="rnn", device="cpu")
