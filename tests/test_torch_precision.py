"""The serving precisions (bf16, int8, int4) of the port's ECG path against
the JAX reference, and the port's own invariants at each precision.

* The four recurrent kernels' plain versions (what the CUDA wrappers run
  for CPU tensors) against the JAX Pallas kernels in interpret mode, on
  the operands ``ops._precision_weights`` builds from the same fp32 master
  weights: the sequence kernels on int8 codes / packed int4 codes and
  their scales, the step kernels on the dequantized bf16 weights.
* ``run_stack``, the classifier and the autoencoder (LSTM and GRU) on the
  three port backends against JAX ``backend="pallas_seq"``, and a few
  ticks of ``StreamingEngine`` at int8 against the JAX engine on
  ``pallas_seq``.  (The JAX ``reference`` backend cannot run bf16 on the
  CPU: XLA's CPU ``DotThunk`` refuses its batched BF16 x BF16 = F32
  einsum.  The JAX package documents its three backends bit-identical at
  every precision, so ``pallas_seq`` stands for all three.)
* Inside the port: ``cuda_step`` == ``cuda_seq``, chunked == unchunked and
  co-batched == alone, bit for bit, at every precision.

Tolerances.  bf16 values (h, ys, logits, reconstructions, summaries of bf16
outputs): at most one bf16 ulp of the larger magnitude (``BF16_ULPS``) --
both sides round at the same points, but XLA may sum a gate's fp32 terms in
another order, and where that moves a sum across a bf16 rounding boundary
h differs by one ulp.  On these inputs every bf16 comparison came out
bit-equal.  The LSTM's fp32 c: ``C_ATOL`` = 1e-6 absolute (the same fp32
sums in another order; observed up to 2.4e-7).  The engine's fp32
summaries of bf16 outputs: ``SUMMARY_ATOL`` = 1e-5 (a softmax and means in
fp32, observed equal).  Shapes are small (H <= 16, T <= 9, a few rows) so
a worker compiles little JAX.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, classifier as jclf  # noqa: E402
from repro.core import cells as jcells  # noqa: E402
from repro.core import mcd as jmcd, rnn as jrnn  # noqa: E402
from repro.core import uncertainty as junc  # noqa: E402
from repro.kernels import mcd_gru as jgru, mcd_gru_seq as jgseq  # noqa: E402
from repro.kernels import mcd_lstm as jlstm, mcd_lstm_seq as jlseq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae, classifier as tclf  # noqa: E402
from repro_torch.core import cells as tcells  # noqa: E402
from repro_torch.core import mcd as tmcd, rnn as trnn  # noqa: E402
from repro_torch.core import uncertainty as tunc  # noqa: E402
from repro_torch.kernels import mcd_gru as tgru, mcd_gru_seq as tgseq  # noqa: E402
from repro_torch.kernels import mcd_lstm as tlstm  # noqa: E402
from repro_torch.kernels import mcd_lstm_seq as tlseq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import StreamingEngine  # noqa: E402

PRECISIONS = ("bf16", "int8", "int4")
BF16_ULPS = 1
C_ATOL = 1e-6
SUMMARY_ATOL = 1e-5
SEED, LAYER = 11, 2
B, T = 6, 7
ROWS = np.asarray([0, 1, 2 ** 31 + 4, 9, 2 ** 31 - 1, 40], np.uint32)
LENS = np.asarray([7, 3, 5, 1, 7, 6], np.int32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_close(ref, got, ulps=BF16_ULPS):
    """|ref - got| within ``ulps`` bf16 ulps of the larger magnitude."""
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape
    mag = np.maximum(np.abs(r), np.abs(g))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(r - g) <= ulps * ulp).all(), np.abs(r - g).max()


def _layer(G, I, H, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, k=1.0):
        return (rng.standard_normal(shape) * k).astype(np.float32)

    return dict(x=f(B, T, I), wx=f(I, G, H, k=0.5), wh=f(H, G, H, k=0.5),
                b=f(G, H, k=0.1), h0=f(B, H, k=0.5), c0=f(B, H, k=0.5))


def _operands(d, precision, seq):
    """The same layer at ``precision`` for JAX and for the port, through
    each package's own ``_precision_weights``."""
    jw = jops._precision_weights(jnp.asarray(d["wx"]), jnp.asarray(d["wh"]),
                                 jnp.asarray(d["x"]), precision, seq=seq)
    tw = tops._precision_weights(torch.from_numpy(d["wx"]),
                                 torch.from_numpy(d["wh"]),
                                 torch.from_numpy(d["x"]), precision,
                                 seq=seq)
    return jw, tw


# -- the kernels' plain versions against the JAX Pallas kernels -------------

@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("I,H,p", [(3, 5, 0.25), (2, 8, 0.0)])
def test_seq_plain_matches_jax_kernel(cell, precision, I, H, p):
    """Codes (int8, or int4 packed with an odd H's pad column) dequantized
    in the plain version as in the kernel; h0 / c0 carried, ragged lengths,
    student rows."""
    lstm = cell == "lstm"
    d = _layer(4 if lstm else 3, I, H, seed=H)
    (jwx, jwh, jx, jq), (twx, twh, tx, tq) = _operands(d, precision, True)
    assert tx.dtype == torch.bfloat16
    jkw = dict(h0=jnp.asarray(d["h0"]).astype(jx.dtype),
               lengths=jnp.asarray(LENS), **jq)
    tkw = dict(h0=torch.from_numpy(d["h0"]).bfloat16(),
               lengths=torch.from_numpy(LENS), **tq)
    if lstm:
        jkw["c0"], tkw["c0"] = jnp.asarray(d["c0"]), torch.from_numpy(d["c0"])
        ref = jlseq.mcd_lstm_seq(jx, jwx, jwh, jnp.asarray(d["b"]),
                                 jnp.asarray(ROWS),
                                 jlstm.gate_keys(SEED, LAYER), p, **jkw)
        got = tlseq.mcd_lstm_seq_plain(tx, twx, twh, torch.from_numpy(d["b"]),
                                       torch.from_numpy(ROWS.astype(np.int64)),
                                       tlstm.gate_keys(SEED, LAYER), p, **tkw)
    else:
        ref = jgseq.mcd_gru_seq(jx, jwx, jwh, jnp.asarray(d["b"]),
                                jnp.asarray(ROWS), jgru.gate_keys(SEED, LAYER),
                                p, **jkw)
        got = tgseq.mcd_gru_seq_plain(tx, twx, twh, torch.from_numpy(d["b"]),
                                      torch.from_numpy(ROWS.astype(np.int64)),
                                      tgru.gate_keys(SEED, LAYER), p, **tkw)
    ys, hT = got[0], got[1]
    assert ys.dtype == hT.dtype == torch.bfloat16
    _bf16_close(ref[0], ys)
    _bf16_close(ref[1], hT)
    if lstm:
        assert got[2].dtype == torch.float32
        np.testing.assert_allclose(_np(ref[2]), _np(got[2]), rtol=0,
                                   atol=C_ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("p", [0.25, 0.0])
def test_step_plain_matches_jax_kernel(cell, precision, p):
    """bf16 x, h and dequantized bf16 weights (as the reference's step
    backend hands them), fp32 c."""
    lstm = cell == "lstm"
    I, H = 3, 5
    d = _layer(4 if lstm else 3, I, H, seed=7)
    (jwx, jwh, jx, _), (twx, twh, tx, _) = _operands(d, precision, False)
    assert twx.dtype == torch.bfloat16
    jx, tx = jx[:, 0], tx[:, 0].contiguous()
    jh = jnp.asarray(d["h0"]).astype(jnp.bfloat16)
    th = torch.from_numpy(d["h0"]).bfloat16()
    jb, tb = jnp.asarray(d["b"]), torch.from_numpy(d["b"])
    trows = torch.from_numpy(ROWS.astype(np.int64))
    if lstm:
        ref = jlstm.mcd_lstm_step(jx, jh, jnp.asarray(d["c0"]), jwx, jwh, jb,
                                  jnp.asarray(ROWS),
                                  jlstm.gate_keys(SEED, LAYER), p)
        got = tlstm.mcd_lstm_step_plain(tx, th, torch.from_numpy(d["c0"]),
                                        twx, twh, tb, trows,
                                        tlstm.gate_keys(SEED, LAYER), p)
        _bf16_close(ref[0], got[0])
        np.testing.assert_allclose(_np(ref[1]), _np(got[1]), rtol=0,
                                   atol=C_ATOL)
        assert got[0].dtype == torch.bfloat16
        assert got[1].dtype == torch.float32
    else:
        ref = jgru.mcd_gru_step(jx, jh, jwx, jwh, jb, jnp.asarray(ROWS),
                                jgru.gate_keys(SEED, LAYER), p)
        got = tgru.mcd_gru_step_plain(tx, th, twx, twh, tb, trows,
                                      tgru.gate_keys(SEED, LAYER), p)
        assert got.dtype == torch.bfloat16
        _bf16_close(ref, got)


# -- the stack and the models against JAX pallas_seq -------------------------

def _stack(cell, hiddens=(8, 5), in_dim=2):
    rng = np.random.default_rng(3)
    G = 4 if cell == "lstm" else 3
    dims = [in_dim, *hiddens]
    params = [tuple((rng.standard_normal(s) * k).astype(np.float32)
                    for s, k in (((G, i, h), 0.5), ((G, h, h), 0.5),
                                 ((G, h), 0.1)))
              for i, h in zip(dims[:-1], dims[1:])]
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    return params, x


def _stack_params(cell, params, to, port=False):
    """The layers as the JAX (or, ``port``, the port's) cell params."""
    mod = tcells if port else jcells
    kind = mod.GRUParams if cell == "gru" else mod.LSTMParams
    return [kind(*map(to, lp)) for lp in params]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_run_stack_matches_jax_pallas_seq(cell, precision):
    """All three port backends against JAX pallas_seq: outputs and every
    layer's carried state (h bf16, the LSTM's c fp32)."""
    params, x = _stack(cell)
    jP = _stack_params(cell, params, jnp.asarray)
    tP = _stack_params(cell, params, torch.from_numpy, port=True)
    cfg = jmcd.MCDConfig(p=0.25, placement="YN", seed=SEED)
    tcfg = tmcd.MCDConfig(p=0.25, placement="YN", seed=SEED)
    ref, ref_st = jrnn.run_stack(
        jP, jnp.asarray(x), jrnn.stack_mask_plan(cfg, 2), cfg.p,
        backend="pallas_seq", rows=jnp.asarray(ROWS), seed=SEED,
        lengths=jnp.asarray(LENS), return_all_states=True, cell=cell,
        precision=precision)
    trows = torch.from_numpy(ROWS.astype(np.int64))
    for backend in tops.LSTM_BACKENDS:
        masks = (trnn.sample_stack_masks(tcfg, trows, 2, (8, 5),
                                         dtype=torch.bfloat16, cell=cell)
                 if backend == "reference" else trnn.stack_mask_plan(tcfg, 2))
        got, st = trnn.run_stack(
            tP, torch.from_numpy(x), masks, tcfg.p, backend=backend,
            rows=trows, seed=SEED, lengths=torch.from_numpy(LENS),
            return_all_states=True, cell=cell, precision=precision,
            device="cpu")
        assert got.dtype == torch.bfloat16
        _bf16_close(ref, got)
        for rs, gs in zip(ref_st, st):
            _bf16_close(rs[0], gs[0])
            assert gs[0].dtype == torch.bfloat16
            if cell == "lstm":
                assert gs[1].dtype == torch.float32
                np.testing.assert_allclose(_np(rs[1]), _np(gs[1]), rtol=0,
                                           atol=C_ATOL)


def _model(kind, cell):
    mc = dict(p=0.125, placement="YNY" if kind == "clf" else "YNYN",
              n_samples=2, seed=3)
    if kind == "clf":
        jc = jclf.ClassifierConfig(cell=cell, mcd=jmcd.MCDConfig(**mc))
        tc = tclf.ClassifierConfig(cell=cell, mcd=tmcd.MCDConfig(**mc))
        jp = jclf.init(jax.random.key(0), jc)
        return jclf, tclf, jc, tc, jp
    jc = jae.AutoencoderConfig(cell=cell, mcd=jmcd.MCDConfig(**mc))
    tc = tae.AutoencoderConfig(cell=cell, mcd=tmcd.MCDConfig(**mc))
    jp = jae.init(jax.random.key(0), jc)
    return jae, tae, jc, tc, jp


@pytest.mark.parametrize("kind", ["clf", "ae"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_models_match_jax_pallas_seq(kind, cell, precision):
    """The classifier's logits (bf16, as the reference's: the head's fp32
    sums rounded to bf16 before the bf16 bias) and the autoencoder's
    reconstruction (mean, log-variance) on all three port backends."""
    jm, tm, jc, tc, jp = _model(kind, cell)
    tp = bridge.from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((B, T, 1)).astype(
        np.float32)
    rows = ROWS
    ref = jm.apply(jp, jnp.asarray(x), jnp.asarray(rows), jc,
                   backend="pallas_seq", lengths=jnp.asarray(LENS),
                   precision=precision)
    ref = (ref,) if kind == "clf" else ref
    for backend in tops.LSTM_BACKENDS:
        got = tm.apply(tp, torch.from_numpy(x),
                       torch.from_numpy(rows.astype(np.int64)), tc,
                       backend=backend, lengths=torch.from_numpy(LENS),
                       precision=precision, device="cpu")
        got = (got,) if kind == "clf" else got
        for r, g in zip(ref, got, strict=True):
            assert g.dtype == torch.bfloat16
            _bf16_close(r, g)


def test_summaries_of_bf16_outputs_as_the_reference_computes_them():
    """``classification_summary`` / ``regression_summary`` on bf16 inputs
    reduce in fp32 and round to bf16 where the reference does (its jaxprs
    upcast every sum and mean, and its softmax's normalizer)."""
    rng = np.random.default_rng(0)
    lg = jnp.asarray(rng.standard_normal((30, 7, 4)) * 3, jnp.bfloat16)
    ref = junc.classification_summary(lg)
    got = tunc.classification_summary(torch.from_numpy(_np(lg)).bfloat16())
    for r, g in zip(ref, got, strict=True):
        assert g.dtype == torch.bfloat16
        _bf16_close(r, g)
    m = jnp.asarray(rng.standard_normal((30, 3, 5, 1)), jnp.bfloat16)
    lv = jnp.asarray(rng.standard_normal((30, 3, 5, 1)), jnp.bfloat16)
    ref = junc.regression_summary(m, lv)
    got = tunc.regression_summary(torch.from_numpy(_np(m)).bfloat16(),
                                  torch.from_numpy(_np(lv)).bfloat16())
    for r, g in zip(ref, got, strict=True):
        assert g.dtype == torch.bfloat16
        _bf16_close(r, g)


# -- the engine --------------------------------------------------------------

TICKS = [{"a": 5, "b": 8}, {"a": 3, "b": 2}, {"a": 6, "b": 4}]


def _signals(n, length, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((length, 1)).astype(np.float32)
            for _ in range(n)]


def _drive(engine, to_array, sids="ab"):
    sig = dict(zip("ab", _signals(2, 20)))
    for sid in sids:
        engine.open_session(sid)
    out = []
    for plan in TICKS:
        chunks = {}
        for sid in sids:
            pos = engine.store.get(sid).steps
            chunks[sid] = to_array(sig[sid][pos:pos + plan[sid]])
        out.append({sid: [_np(v) for v in r.summary]
                    for sid, r in engine.step(chunks).items()})
    return out


def test_engine_int8_matches_jax_engine():
    """A few ragged ticks of the classifier at int8: the port's engine on
    each backend against the JAX engine on pallas_seq."""
    jm, tm, jc, tc, jp = _model("clf", "lstm")
    tp = bridge.from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    ref = _drive(JaxEngine(jp, jc, backend="pallas_seq", max_sessions=2,
                           chunk_capacity=8, precision="int8"), jnp.asarray)
    for backend in tops.LSTM_BACKENDS:
        got = _drive(StreamingEngine(tp, tc, backend=backend, max_sessions=2,
                                     chunk_capacity=8, precision="int8",
                                     device="cpu"), lambda a: a)
        for rt, gt in zip(ref, got, strict=True):
            assert rt.keys() == gt.keys()
            for sid in rt:
                for r, g in zip(rt[sid], gt[sid], strict=True):
                    np.testing.assert_allclose(r, g, rtol=0,
                                               atol=SUMMARY_ATOL)


# -- the port's own invariants, bit for bit -----------------------------------

@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_step_backend_equals_seq_backend(cell, precision):
    """cuda_step (dequantized weights) == cuda_seq (codes dequantized in the
    kernel): the same values, the same arithmetic."""
    params, x = _stack(cell)
    tP = _stack_params(cell, params, torch.from_numpy, port=True)
    cfg = tmcd.MCDConfig(p=0.25, placement="YN", seed=SEED)
    outs = [trnn.run_stack(tP, torch.from_numpy(x),
                           trnn.stack_mask_plan(cfg, 2), cfg.p,
                           backend=backend, rows=torch.from_numpy(
                               ROWS.astype(np.int64)), seed=SEED,
                           lengths=torch.from_numpy(LENS),
                           return_all_states=True, cell=cell,
                           precision=precision, device="cpu")
            for backend in ("cuda_step", "cuda_seq")]
    (ys, st), (yq, sq) = outs
    assert torch.equal(ys, yq)
    for a, b in zip(st, sq):
        for u, v in zip(a, b, strict=True):
            assert u.dtype == v.dtype and torch.equal(u, v)


PREC_MODELS = [("clf", "lstm", "int8"), ("clf", "gru", "bf16"),
               ("ae", "gru", "int4"), ("ae", "lstm", "int8")]
PLANS = {"s0": [5, 3, 8], "s1": [4, 8, 4], "s2": [7, 7, 2]}


def _serve(kind, cell, precision, backend, submit):
    """An engine at ``precision`` with every session of PLANS admitted (so
    each keeps its rows) and only ``submit`` sending chunks."""
    _, tm, _, tc, jp = _model(kind, cell)
    tp = bridge.from_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    sig = dict(zip(PLANS, _signals(3, 16, seed=4)))
    eng = StreamingEngine(tp, tc, backend=backend, precision=precision,
                          device="cpu")
    for sid in PLANS:
        eng.open_session(sid)
    for k in range(3):
        res = eng.step({sid: sig[sid][eng.store.get(sid).steps:][
            :PLANS[sid][k]] for sid in submit})
    return eng, res, (tm, tc, tp, sig)


@pytest.mark.parametrize("kind,cell,precision", PREC_MODELS)
@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_chunked_equals_unchunked_at_precision(kind, cell, precision,
                                               backend):
    """A precision engine's carried state after three ragged chunks equals
    one unchunked pass, bit for bit, in the carry dtypes (h bf16, c
    fp32)."""
    eng, _, (tm, tc, tp, sig) = _serve(kind, cell, precision, backend,
                                       list(PLANS))
    S = tc.mcd.n_samples
    x = torch.from_numpy(np.concatenate([np.repeat(sig[s][None], S, 0)
                                         for s in PLANS]))
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(s).rows for s in PLANS]).astype(np.int64))
    *_, states = tm.apply(tp, x, rows, tc, backend=backend,
                          lengths=torch.full((len(rows),), 16),
                          return_state=True, precision=precision,
                          device="cpu")
    for li, layer in enumerate(states):
        assert layer[0].dtype == torch.bfloat16
        for k, sid in enumerate(PLANS):
            for part, whole in zip(eng.store.get(sid).state[li], layer,
                                   strict=True):
                assert part.dtype == whole.dtype
                assert torch.equal(part, whole[k * S:(k + 1) * S])


@pytest.mark.parametrize("kind,cell,precision", PREC_MODELS)
@pytest.mark.parametrize("backend", ["cuda_step", "cuda_seq"])
def test_cobatched_equals_alone_at_precision(kind, cell, precision, backend):
    """On the kernel backends (whose plain versions compute each row alone)
    a session co-batched with others equals the same session served alone,
    carries and summary, bit for bit."""
    eng, res, _ = _serve(kind, cell, precision, backend, list(PLANS))
    alone, res1, _ = _serve(kind, cell, precision, backend, ["s1"])
    for a, b in zip(eng.store.get("s1").state, alone.store.get("s1").state):
        for u, v in zip(a, b, strict=True):
            assert torch.equal(u, v)
    for u, v in zip(res["s1"].summary, res1["s1"].summary, strict=True):
        assert torch.equal(u, v)
