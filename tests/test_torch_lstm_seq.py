"""The port's sequence-fused LSTM layer and stack against the JAX reference.

``mcd_lstm_seq_plain`` (what the CUDA kernel's wrapper runs for CPU
tensors) is held against the JAX Pallas kernel ``mcd_lstm_seq`` in
interpret mode, as ``tests/test_mcd_lstm_seq.py`` runs it, and the port's
``run_stack`` (both backends) against JAX ``run_stack(backend="reference")``.
Inputs and weights are made with numpy from a seed.  Tolerance: 1e-5
absolute — the JAX backends themselves differ by up to 1.2e-7 at fp32.
JAX shapes are few, so a worker compiles little.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cells as jcells, mcd as jmcd, rnn as jrnn  # noqa: E402
from repro.kernels import mcd_lstm as jlstm  # noqa: E402
from repro.kernels import mcd_lstm_seq as jseq  # noqa: E402
from repro_torch.core import cells as tcells  # noqa: E402
from repro_torch.core import mcd as tmcd, rnn as trnn  # noqa: E402
from repro_torch.kernels import mcd_lstm as tlstm  # noqa: E402
from repro_torch.kernels import mcd_lstm_seq as tseq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5
SEED, LAYER = 11, 2
B, T, I, H = 6, 9, 3, 5
ROWS = np.asarray([0, 1, 2 ** 31 + 4, 9, 2 ** 31 - 1, 40], np.uint32)
LENS = np.asarray([9, 3, 5, 1, 9, 6], np.int32)


def _layer(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, k=1.0):
        return (rng.standard_normal(shape) * k).astype(np.float32)

    return dict(x=f(B, T, I), wx=f(I, 4, H, k=0.5), wh=f(H, 4, H, k=0.5),
                b=f(4, H, k=0.1), h0=f(B, H, k=0.5), c0=f(B, H, k=0.5))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rows_t(rows=ROWS):
    return torch.from_numpy(rows.astype(np.int64))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_plain_matches_jax_kernel_streaming(p):
    """h0/c0 carried state, ragged lengths and student rows."""
    d = _layer()
    ref = jseq.mcd_lstm_seq(
        jnp.asarray(d["x"]), jnp.asarray(d["wx"]), jnp.asarray(d["wh"]),
        jnp.asarray(d["b"]), jnp.asarray(ROWS),
        jlstm.gate_keys(SEED, LAYER), p, h0=jnp.asarray(d["h0"]),
        c0=jnp.asarray(d["c0"]), lengths=jnp.asarray(LENS))
    got = tseq.mcd_lstm_seq_plain(
        _t(d["x"]), _t(d["wx"]), _t(d["wh"]), _t(d["b"]), _rows_t(),
        tlstm.gate_keys(SEED, LAYER), p, h0=_t(d["h0"]), c0=_t(d["c0"]),
        lengths=_t(LENS))
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        _close(r, g)
    ys = got[0].numpy()
    for b, L in enumerate(LENS):        # frozen rows repeat their last h
        assert (ys[b, L:] == ys[b, L - 1]).all()


def test_wrapper_takes_plain_version_on_cpu():
    """CPU tensors run the plain version and launch nothing."""
    d = _layer(1)
    before = tseq.mcd_lstm_seq.launches
    args = (_t(d["x"]), _t(d["wx"]), _t(d["wh"]), _t(d["b"]), _rows_t(),
            tlstm.gate_keys(SEED, LAYER), 0.25)
    a = tseq.mcd_lstm_seq(*args, lengths=_t(LENS))
    b = tseq.mcd_lstm_seq_plain(*args, lengths=_t(LENS))
    assert tseq.mcd_lstm_seq.launches == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((2, 3, 1), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tseq.mcd_lstm_seq(x, x, x, x, x, tlstm.gate_keys(0, 0), 0.1)


def test_plain_chunked_equals_unchunked_bitwise():
    """Resuming (h_T, c_T) at a chunk boundary is lossless."""
    d = _layer(2)
    args = (_t(d["wx"]), _t(d["wh"]), _t(d["b"]), _rows_t(),
            tlstm.gate_keys(SEED, LAYER), 0.125)
    full = tseq.mcd_lstm_seq_plain(_t(d["x"]), *args, h0=_t(d["h0"]),
                                   c0=_t(d["c0"]))
    y1, h1, c1 = tseq.mcd_lstm_seq_plain(_t(d["x"][:, :4]), *args,
                                         h0=_t(d["h0"]), c0=_t(d["c0"]))
    y2, h2, c2 = tseq.mcd_lstm_seq_plain(_t(d["x"][:, 4:]), *args, h0=h1,
                                         c0=c1)
    assert torch.equal(full[0], torch.cat([y1, y2], dim=1))
    assert torch.equal(full[1], h2) and torch.equal(full[2], c2)


def test_tile_rows_fits_shared_memory():
    assert tseq.tile_rows(1, 8) == 16
    assert tseq.tile_rows(128, 128) == 1
    assert tseq.tile_rows(1024, 8) >= 1
    with pytest.raises(NotImplementedError):
        tseq.tile_rows(8, 2048)


# -- the stack --------------------------------------------------------------

NL, SI, SH = 3, 2, 6          # layers, stack input width, hidden


def _stack(seed=3):
    rng = np.random.default_rng(seed)
    params = []
    for d_in in (SI,) + (SH,) * (NL - 1):
        params.append(tuple((rng.standard_normal(s) * k).astype(np.float32)
                            for s, k in (((4, d_in, SH), 0.5),
                                         ((4, SH, SH), 0.5), ((4, SH), 0.1))))
    x = rng.standard_normal((B, T, SI)).astype(np.float32)
    init = [tuple((rng.standard_normal((B, SH)) * 0.5).astype(np.float32)
                  for _ in range(2)) for _ in range(NL)]
    return params, x, init


@pytest.fixture(scope="module")
def jax_stack_ref():
    params, x, init = _stack()
    cfg = jmcd.MCDConfig(p=0.25, placement="YNY", seed=SEED)
    jp = [jcells.LSTMParams(*map(jnp.asarray, lp)) for lp in params]
    masks = jrnn.sample_stack_masks(cfg, jnp.asarray(ROWS), SI, (SH,) * NL)
    out, states = jrnn.run_stack(
        jp, jnp.asarray(x), masks, cfg.p, backend="reference",
        rows=jnp.asarray(ROWS), seed=cfg.seed,
        initial_state=[tuple(map(jnp.asarray, s)) for s in init],
        lengths=jnp.asarray(LENS), return_all_states=True)
    return (np.asarray(out),
            [tuple(np.asarray(a) for a in s) for s in states])


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_run_stack_matches_jax_reference(jax_stack_ref, backend):
    params, x, init = _stack()
    cfg = tmcd.MCDConfig(p=0.25, placement="YNY", seed=SEED)
    tp = [tcells.LSTMParams(*map(_t, lp)) for lp in params]
    rows = _rows_t()
    masks = (trnn.sample_stack_masks(cfg, rows, SI, (SH,) * NL)
             if backend == "reference" else trnn.stack_mask_plan(cfg, NL))
    out, states = trnn.run_stack(
        tp, _t(x), masks, cfg.p, backend=backend, rows=rows, seed=cfg.seed,
        initial_state=[tuple(map(_t, s)) for s in init], lengths=_t(LENS),
        return_all_states=True, device="cpu")
    ref_out, ref_states = jax_stack_ref
    _close(ref_out, out)
    for (rh, rc), (h, c) in zip(ref_states, states):
        _close(rh, h)
        _close(rc, c)
        assert c.dtype == torch.float32


def test_run_stack_last_state_form():
    params, x, _ = _stack()
    cfg = tmcd.MCDConfig(p=0.25, placement="YNY", seed=SEED)
    tp = [tcells.LSTMParams(*map(_t, lp)) for lp in params]
    out, (h, c) = trnn.run_stack(tp, _t(x), trnn.stack_mask_plan(cfg, NL),
                                 cfg.p, backend="cuda_seq", rows=_rows_t(),
                                 seed=cfg.seed, return_sequence=False,
                                 device="cpu")
    assert out is None and h.shape == (B, SH) and c.shape == (B, SH)
    with pytest.raises(ValueError, match="sample_stack_masks"):
        trnn.run_stack(tp, _t(x), trnn.stack_mask_plan(cfg, NL), cfg.p,
                       backend="reference", rows=_rows_t(), device="cpu")
    with pytest.raises(ValueError, match="rows"):
        trnn.run_stack(tp, _t(x), trnn.stack_mask_plan(cfg, NL), cfg.p,
                       backend="cuda_seq", device="cpu")
    # Under a serving precision h comes back in the activation dtype and c
    # in fp32, as the reference returns them; an unknown precision raises.
    _, (h, c) = trnn.run_stack(tp, _t(x), trnn.stack_mask_plan(cfg, NL),
                               cfg.p, backend="cuda_seq", rows=_rows_t(),
                               seed=cfg.seed, return_sequence=False,
                               device="cpu", precision="bf16")
    assert h.dtype == torch.bfloat16 and c.dtype == torch.float32
    with pytest.raises(ValueError, match="precision"):
        trnn.run_stack(tp, _t(x), trnn.stack_mask_plan(cfg, NL), cfg.p,
                       backend="cuda_seq", rows=_rows_t(), device="cpu",
                       precision="fp8")


def test_gate_stacked_layout():
    params, _, _ = _stack()
    ref = jcells.gate_stacked(jcells.LSTMParams(*map(jnp.asarray,
                                                     params[0])))
    got = tcells.gate_stacked(tcells.LSTMParams(*map(_t, params[0])))
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
        assert g.is_contiguous()
