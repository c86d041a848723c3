"""Wide recurrent layers: what the CUDA kernels' wide path (the sequence
kernels' cluster split of H, the step kernels' unit slices; ``csrc/
mcd_wide.cuh``) computes, held against the JAX reference on the CPU.

* The four kernels' plain versions (what the wrappers run for CPU tensors)
  at (I, H) = (3, 1100) -- H above the block path's 1024 -- and (20000,
  8) -- an input whose rows' mask factors, x and h overflow a block --
  against the JAX Pallas kernels in interpret mode, on the operands each
  package's ``_precision_weights`` builds (fp32, and int8: codes and
  scales for the sequence kernels, the dequantized bf16 weights for the
  step kernels), with ragged lengths, h0 / c0 carried, a student row, p =
  0.125 and 0.  The JAX step kernels tile H by ``block_h``, which must
  divide it: H = 1100 runs as one block.
* A two-layer H = 1100 ``run_stack`` on the port's three backends against
  JAX ``run_stack(backend="pallas_seq")`` (interpret mode).
* ``StreamingEngine`` at H = 1100 (2 sessions x S = 2) on the CPU:
  chunked == unchunked and ``cuda_step`` == ``cuda_seq``, bit for bit.

Tolerances: fp32 values within ATOL = 1e-5 (the JAX kernels sum a gate in
XLA's order, the plain versions in index order; the weights are scaled by
1/sqrt(fan-in), as the models' own init, so a gate sum stays O(1)); the
int8 precision's bf16 values within one bf16 ulp of the larger magnitude
(both round at the same points; a sum in another order may cross a bf16
rounding boundary), its fp32 c within ATOL.  No CUDA here: the kernels
themselves are held bit-equal to these plain versions on the card
(``tests/test_torch_cuda_kernel.py``, ``chip_smoke.py`` phase 2).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cells as jcells, classifier as jclf  # noqa: E402
from repro.core import mcd as jmcd, rnn as jrnn  # noqa: E402
from repro.kernels import mcd_gru as jgru, mcd_gru_seq as jgseq  # noqa: E402
from repro.kernels import mcd_lstm as jlstm, mcd_lstm_seq as jlseq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import cells as tcells  # noqa: E402
from repro_torch.core import classifier as tclf  # noqa: E402
from repro_torch.core import mcd as tmcd, rnn as trnn  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import mcd_gru as tgru, mcd_gru_seq as tgseq  # noqa: E402
from repro_torch.kernels import mcd_lstm as tlstm  # noqa: E402
from repro_torch.kernels import mcd_lstm_seq as tlseq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import StreamingEngine  # noqa: E402

ATOL = 1e-5
SEED, LAYER = 11, 2
B, T = 3, 3
ROWS = np.asarray([0, 2 ** 31 + 4, 9], np.uint32)     # row 1: a student
LENS = np.asarray([3, 1, 2], np.int32)
SHAPES = [(3, 1100), (20000, 8)]
# (I, H, precision, p): each shape at both precisions and both rates, the
# step kernels on the other pairings than the sequence kernels (a JAX
# interpret-mode compile is most of a case's time).
SEQ_CASES = [(3, 1100, "fp32", 0.125), (3, 1100, "int8", 0.0),
             (20000, 8, "fp32", 0.0), (20000, 8, "int8", 0.125)]
STEP_CASES = [(3, 1100, "fp32", 0.0), (3, 1100, "int8", 0.125),
              (20000, 8, "fp32", 0.125), (20000, 8, "int8", 0.0)]


def _layer(G, I, H, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, k=1.0):
        return (rng.standard_normal(shape) * k).astype(np.float32)

    k = (I + H) ** -0.5
    return dict(x=f(B, T, I), wx=f(I, G, H, k=k), wh=f(H, G, H, k=k),
                b=f(G, H, k=0.1), h0=f(B, H, k=0.5), c0=f(B, H, k=0.5))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(ref, got):
    """fp32 within ATOL; bf16 within one bf16 ulp of the larger
    magnitude."""
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        mag = np.maximum(np.abs(r), np.abs(g))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(r - g) <= ulp).all(), np.abs(r - g).max()
    else:
        np.testing.assert_allclose(r, g, rtol=0, atol=ATOL)


def _operands(d, precision, seq):
    """The layer at ``precision`` for JAX and for the port, each through
    its own package's ``_precision_weights`` (None / "fp32": as it is)."""
    prec = None if precision == "fp32" else precision
    jw = jops._precision_weights(jnp.asarray(d["wx"]), jnp.asarray(d["wh"]),
                                 jnp.asarray(d["x"]), prec, seq=seq)
    tw = tops._precision_weights(torch.from_numpy(d["wx"]),
                                 torch.from_numpy(d["wh"]),
                                 torch.from_numpy(d["x"]), prec, seq=seq)
    return jw, tw


def _rows_t():
    return torch.from_numpy(ROWS.astype(np.int64))


# -- the kernels' plain versions against the JAX Pallas kernels -------------

@pytest.mark.parametrize("I,H,precision,p", SEQ_CASES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_seq_plain_matches_jax_kernel(cell, I, H, precision, p):
    lstm = cell == "lstm"
    d = _layer(4 if lstm else 3, I, H, seed=I + H)
    (jwx, jwh, jx, jq), (twx, twh, tx, tq) = _operands(d, precision, True)
    jkw = dict(h0=jnp.asarray(d["h0"]).astype(jx.dtype),
               lengths=jnp.asarray(LENS), **jq)
    tkw = dict(h0=torch.from_numpy(d["h0"]).to(tx.dtype),
               lengths=torch.from_numpy(LENS), **tq)
    jb, tb = jnp.asarray(d["b"]), torch.from_numpy(d["b"])
    if lstm:
        jkw["c0"], tkw["c0"] = jnp.asarray(d["c0"]), torch.from_numpy(d["c0"])
        ref = jlseq.mcd_lstm_seq(jx, jwx, jwh, jb, jnp.asarray(ROWS),
                                 jlstm.gate_keys(SEED, LAYER), p, **jkw)
        got = tlseq.mcd_lstm_seq_plain(tx, twx, twh, tb, _rows_t(),
                                       tlstm.gate_keys(SEED, LAYER), p, **tkw)
    else:
        ref = jgseq.mcd_gru_seq(jx, jwx, jwh, jb, jnp.asarray(ROWS),
                                jgru.gate_keys(SEED, LAYER), p, **jkw)
        got = tgseq.mcd_gru_seq_plain(tx, twx, twh, tb, _rows_t(),
                                      tgru.gate_keys(SEED, LAYER), p, **tkw)
    assert got[0].dtype == tx.dtype
    for r, g in zip(ref, got, strict=True):
        _close(r, g)
    ys = got[0]
    for row, L in enumerate(LENS):          # frozen rows repeat their h
        assert torch.equal(ys[row, L:], ys[row, L - 1:L].expand(T - L, -1))


@pytest.mark.parametrize("I,H,precision,p", STEP_CASES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_step_plain_matches_jax_kernel(cell, I, H, precision, p):
    lstm = cell == "lstm"
    d = _layer(4 if lstm else 3, I, H, seed=I + H + 1)
    (jwx, jwh, jx, _), (twx, twh, tx, _) = _operands(d, precision, False)
    jx, tx = jx[:, 0], tx[:, 0].contiguous()
    jh = jnp.asarray(d["h0"]).astype(jx.dtype)
    th = torch.from_numpy(d["h0"]).to(tx.dtype)
    jb, tb = jnp.asarray(d["b"]), torch.from_numpy(d["b"])
    if lstm:
        ref = jlstm.mcd_lstm_step(jx, jh, jnp.asarray(d["c0"]), jwx, jwh, jb,
                                  jnp.asarray(ROWS),
                                  jlstm.gate_keys(SEED, LAYER), p, block_h=H)
        got = tlstm.mcd_lstm_step_plain(tx, th, torch.from_numpy(d["c0"]),
                                        twx, twh, tb, _rows_t(),
                                        tlstm.gate_keys(SEED, LAYER), p)
        assert got[1].dtype == torch.float32
    else:
        ref = (jgru.mcd_gru_step(jx, jh, jwx, jwh, jb, jnp.asarray(ROWS),
                                 jgru.gate_keys(SEED, LAYER), p, block_h=H),)
        got = (tgru.mcd_gru_step_plain(tx, th, twx, twh, tb, _rows_t(),
                                       tgru.gate_keys(SEED, LAYER), p),)
    assert got[0].dtype == tx.dtype
    for r, g in zip(ref, got, strict=True):
        _close(r, g)


def test_wide_layers_take_the_wide_path():
    """The layers above run, on the card, on the wide path: the sequence
    kernels' cluster split and the step kernels' unit slices (H = 1100),
    or, where H divides 32, the step kernels' warp path (I = 20000,
    H = 8)."""
    for gates in (4, 3):
        for I, H in SHAPES:
            assert common.seq_plan(gates, B, I, H)["path"] == "cluster"
        assert common.step_plan(gates, B, 3, 1100)["path"] == "split"
        assert common.step_plan(gates, B, 20000, 8)["path"] == "warp"


# -- the stack: two H = 1100 layers against JAX pallas_seq -------------------

NL, SI, SH = 2, 2, 1100


def _stack(cell):
    rng = np.random.default_rng(5)
    G = 4 if cell == "lstm" else 3
    params = []
    for d_in in (SI, SH):
        k = (d_in + SH) ** -0.5
        params.append(tuple((rng.standard_normal(s) * a).astype(np.float32)
                            for s, a in (((G, d_in, SH), k), ((G, SH, SH), k),
                                         ((G, SH), 0.1))))
    x = rng.standard_normal((B, T, SI)).astype(np.float32)
    init = [tuple((rng.standard_normal((B, SH)) * 0.5).astype(np.float32)
                  for _ in range(2 if cell == "lstm" else 1))
            for _ in range(NL)]
    return params, x, init


@pytest.fixture(scope="module", params=["lstm", "gru"])
def jax_stack_ref(request):
    cell = request.param
    params, x, init = _stack(cell)
    cfg = jmcd.MCDConfig(p=0.125, placement="YN", seed=SEED)
    kind = jcells.LSTMParams if cell == "lstm" else jcells.GRUParams
    jp = [kind(*map(jnp.asarray, lp)) for lp in params]
    out, states = jrnn.run_stack(
        jp, jnp.asarray(x), jrnn.stack_mask_plan(cfg, NL), cfg.p,
        backend="pallas_seq", rows=jnp.asarray(ROWS), seed=cfg.seed,
        initial_state=[tuple(map(jnp.asarray, s)) for s in init],
        lengths=jnp.asarray(LENS), return_all_states=True, cell=cell)
    return cell, np.asarray(out), [tuple(np.asarray(a) for a in s)
                                   for s in states]


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_run_stack_matches_jax_pallas_seq(jax_stack_ref, backend):
    cell, ref_out, ref_states = jax_stack_ref
    params, x, init = _stack(cell)
    cfg = tmcd.MCDConfig(p=0.125, placement="YN", seed=SEED)
    kind = tcells.LSTMParams if cell == "lstm" else tcells.GRUParams
    tp = [kind(*map(torch.from_numpy, lp)) for lp in params]
    masks = (trnn.sample_stack_masks(cfg, _rows_t(), SI, (SH,) * NL,
                                     cell=cell)
             if backend == "reference" else trnn.stack_mask_plan(cfg, NL))
    out, states = trnn.run_stack(
        tp, torch.from_numpy(x), masks, cfg.p, backend=backend,
        rows=_rows_t(), seed=cfg.seed,
        initial_state=[tuple(map(torch.from_numpy, s)) for s in init],
        lengths=torch.from_numpy(LENS), return_all_states=True, cell=cell,
        device="cpu")
    _close(ref_out, out)
    for ref_state, state in zip(ref_states, states, strict=True):
        for r, g in zip(ref_state, state, strict=True):
            _close(r, g)


# -- the engine at H = 1100 ---------------------------------------------------

S_WIDE, HID, C = 2, 1100, 3
PLANS = {"s0": [2, 1, 3], "s1": [3, 2, 1]}     # 6 steps in ragged chunks


@pytest.fixture(scope="module")
def wide_models():
    jcfg = jclf.ClassifierConfig(hidden=HID, num_layers=2, num_classes=C,
                                 mcd=jmcd.MCDConfig(p=0.125, placement="YN",
                                                    n_samples=S_WIDE,
                                                    seed=SEED))
    tree = jax.tree.map(np.asarray, jclf.init(jax.random.key(1), jcfg))
    tcfg = tclf.ClassifierConfig(hidden=HID, num_layers=2, num_classes=C,
                                 mcd=tmcd.MCDConfig(p=0.125, placement="YN",
                                                    n_samples=S_WIDE,
                                                    seed=SEED))
    return tcfg, bridge.from_numpy_params(tree, device="cpu")


def _serve(tparams, tcfg, backend, signals, chunked):
    eng = StreamingEngine(tparams, tcfg, backend=backend, device="cpu")
    for sid in PLANS:
        eng.open_session(sid)
    plans = PLANS if chunked else {sid: [sum(v)] for sid, v in PLANS.items()}
    for k in range(len(next(iter(plans.values())))):
        chunks = {}
        for sid, lens in plans.items():
            pos = eng.store.get(sid).steps
            chunks[sid] = signals[sid][pos:pos + lens[k]]
        res = eng.step(chunks)
        assert eng.last_metrics.launches == 0     # CPU: plain versions
    states = {sid: eng.store.get(sid).state for sid in PLANS}
    return res, states


def test_engine_chunked_equals_unchunked_and_step_equals_seq(wide_models):
    tcfg, tparams = wide_models
    rng = np.random.default_rng(6)
    signals = {sid: rng.standard_normal((6, 1)).astype(np.float32)
               for sid in PLANS}
    runs = {(backend, chunked): _serve(tparams, tcfg, backend, signals,
                                       chunked)
            for backend, chunked in (("cuda_seq", True), ("cuda_seq", False),
                                     ("cuda_step", True))}
    res0, states0 = runs[("cuda_seq", True)]
    for key, (res, states) in runs.items():
        for sid in PLANS:
            for a, b in zip(res0[sid].summary, res[sid].summary,
                            strict=True):
                assert torch.equal(a, b), key
            for la, lb in zip(states0[sid], states[sid], strict=True):
                for a, b in zip(la, lb, strict=True):
                    assert torch.equal(a, b), key
