"""The port's StreamingEngine serving the anomaly autoencoder and the GRU.

* A 3-tick ragged autoencoder run (LSTM with the full decode, GRU with a
  decode window) on each port backend, against the JAX engine
  (``backend="reference"``) with the same params, sessions and chunks:
  regression summaries within 1e-5, cut to each chunk's valid positions.
* Inside the port, bit for bit: chunked serving equals one unchunked pass
  (the autoencoder, LSTM and GRU, and the GRU classifier), and sessions
  co-batched equal each session served alone.

Sizes are small (H=8, NL=2, S=3, T<=16); the JAX side runs two engines.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, mcd as jmcd  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import classifier as tclf, mcd as tmcd  # noqa: E402
from repro_torch.core.uncertainty import (  # noqa: E402
    RegressionSummary, classification_summary, regression_summary)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import Session, StreamingEngine  # noqa: E402

ATOL = 1e-5
S, HID, NL, SEED, CAP = 3, 8, 2, 7, 8
# (cell, decode_window) of the two JAX-compared configurations.
AE_CASES = [("lstm", None), ("gru", 5)]
# Per tick: chunk lengths per session (ragged; "c" joins at tick 1).
TICKS = [{"a": 6, "b": 8}, {"a": 3, "b": 2, "c": 7}, {"a": 8, "c": 4}]


def _cfgs(cell, window):
    kw = dict(hidden=HID, num_layers=NL, cell=cell, decode_window=window)
    return (jae.AutoencoderConfig(**kw, mcd=jmcd.MCDConfig(
                p=0.125, placement="YNYN", n_samples=S, seed=SEED)),
            tae.AutoencoderConfig(**kw, mcd=tmcd.MCDConfig(
                p=0.125, placement="YNYN", n_samples=S, seed=SEED)))


def _signals(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((length, 1)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for cell, win in AE_CASES:
        jcfg, tcfg = _cfgs(cell, win)
        jparams = jae.init(jax.random.key(2), jcfg)
        tree = jax.tree.map(np.asarray, jparams)
        out[cell] = (jcfg, jparams, tcfg,
                     bridge.from_numpy_params(tree, device="cpu"))
    return out


def _drive(engine, to_array):
    signals = dict(zip("abc", _signals(3, 20, seed=2)))
    log = []
    for plan in TICKS:
        chunks = {}
        for sid, n in plan.items():
            if sid not in engine.active_sessions:
                engine.open_session(sid)
            pos = engine.store.get(sid).steps
            chunks[sid] = to_array(signals[sid][pos:pos + n])
        res = engine.step(chunks)
        log.append({sid: (r.length, [np.asarray(v) for v in r.summary])
                    for sid, r in res.items()})
    return log


@pytest.fixture(scope="module")
def jax_logs(models):
    return {cell: _drive(JaxEngine(models[cell][1], models[cell][0],
                                   backend="reference", max_sessions=3,
                                   chunk_capacity=CAP), jnp.asarray)
            for cell, _ in AE_CASES}


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
@pytest.mark.parametrize("cell,win", AE_CASES)
def test_autoencoder_engine_matches_jax(models, jax_logs, cell, win,
                                        backend):
    _, _, tcfg, tparams = models[cell]
    got = _drive(StreamingEngine(tparams, tcfg, backend=backend,
                                 max_sessions=3, chunk_capacity=CAP,
                                 device="cpu"), lambda a: a)
    for ref_tick, got_tick in zip(jax_logs[cell], got):
        assert ref_tick.keys() == got_tick.keys()
        for sid, (L, ref) in ref_tick.items():
            length, summary = got_tick[sid]
            assert length == L
            valid = L if win is None else min(L, win)
            for r, g in zip(ref, summary):
                assert g.shape == r.shape == (valid, 1)
                np.testing.assert_allclose(r, g, rtol=0, atol=ATOL)


def _ae_params(cell, window=None):
    cfg = tae.AutoencoderConfig(hidden=HID, num_layers=NL, cell=cell,
                                decode_window=window, mcd=tmcd.MCDConfig(
                                    p=0.125, placement="YNYN", n_samples=S,
                                    seed=SEED))
    return cfg, tae.init(torch.Generator().manual_seed(0), cfg, device="cpu")


def _gru_classifier():
    cfg = tclf.ClassifierConfig(hidden=HID, num_layers=3, cell="gru",
                                mcd=tmcd.MCDConfig(p=0.125, placement="YNY",
                                                   n_samples=S, seed=SEED))
    return cfg, tclf.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")


PLANS = {"s0": [5, 3, 8], "s1": [4, 8, 4], "s2": [7, 7, 2]}


def _serve(eng, sig, plans, *, open_sessions=True):
    """Serve every session's plan; returns the last tick's results."""
    if open_sessions:
        for sid in plans:
            eng.open_session(sid)
    res = {}
    for k in range(3):
        chunks = {}
        for sid, lens in plans.items():
            pos = eng.store.get(sid).steps
            chunks[sid] = sig[sid][pos:pos + lens[k]]
        res = eng.step(chunks)
    return res


def _per_session(a, n):
    """[n*S, ...] -> [S, n, ...], the engine's chain-axis layout."""
    return a.reshape((n, S) + a.shape[1:]).transpose(0, 1).float()


@pytest.mark.parametrize("backend", ["cuda_step", "cuda_seq"])
@pytest.mark.parametrize("model", ["ae-lstm", "ae-gru", "clf-gru"])
def test_chunked_equals_unchunked_bitwise(backend, model):
    cfg, params = (_gru_classifier() if model == "clf-gru"
                   else _ae_params(model.split("-")[1]))
    sig = dict(zip(PLANS, _signals(3, 16, seed=4)))
    eng = StreamingEngine(params, cfg, backend=backend, chunk_capacity=CAP,
                          max_sessions=3, device="cpu")
    res = _serve(eng, sig, PLANS)
    assert eng.last_metrics.launches == 0     # CPU: plain versions
    n = len(PLANS)
    x = torch.from_numpy(np.concatenate([np.repeat(sig[s][None], S, 0)
                                         for s in PLANS]))
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(s).rows for s in PLANS]).astype(np.int64))
    full = torch.full((len(rows),), 16)
    if model == "clf-gru":
        logits, states = tclf.apply(params, x, rows, cfg, backend=backend,
                                    lengths=full, return_state=True,
                                    device="cpu")
        ref = classification_summary(_per_session(logits, n))
    else:
        # One pass over the whole signal, decoded over the last tick's
        # launch width: the decoder replays the final bottleneck, so the
        # positions of the last chunk are the same computation.
        ref_cfg = dataclasses.replace(cfg, decode_window=CAP)
        mean, lv, states = tae.apply(params, x, rows, ref_cfg,
                                     backend=backend, lengths=full,
                                     return_state=True, device="cpu")
        ref = regression_summary(_per_session(mean, n),
                                 _per_session(lv, n))
    for li, layer in enumerate(states):
        for k, sid in enumerate(PLANS):
            stored = eng.store.get(sid).state[li]
            assert len(stored) == len(layer) == (2 if model == "ae-lstm"
                                                 else 1)
            for part, whole in zip(stored, layer):
                assert torch.equal(part, whole[k * S:(k + 1) * S])
    for k, sid in enumerate(PLANS):
        L = PLANS[sid][-1]
        for v, r in zip(res[sid].summary, ref):
            assert torch.equal(v, r[k] if model == "clf-gru" else r[k][:L])


@pytest.mark.parametrize("backend", ["cuda_step", "cuda_seq"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cobatched_equals_alone_bitwise(cell, backend):
    cfg, params = _ae_params(cell, window=6)
    sig = dict(zip(PLANS, _signals(3, 16, seed=5)))
    together = StreamingEngine(params, cfg, backend=backend,
                               chunk_capacity=CAP, max_sessions=3,
                               device="cpu")
    res_all = _serve(together, sig, PLANS)
    for sid in PLANS:
        alone = StreamingEngine(params, cfg, backend=backend,
                                chunk_capacity=CAP, max_sessions=1,
                                device="cpu")
        # A fresh session on the same mask rows, through the public
        # re-admission path.
        alone.admit(sid, session=Session(
            sid=sid, rows=together.store.get(sid).rows.copy(),
            seed=cfg.mcd.seed))
        res = _serve(alone, sig, {sid: PLANS[sid]}, open_sessions=False)
        for a, b in zip(res[sid].summary, res_all[sid].summary):
            assert torch.equal(a, b)
        for la, lb in zip(alone.store.get(sid).state,
                          together.store.get(sid).state):
            for a, b in zip(la, lb):
                assert torch.equal(a, b)


def test_summary_is_regression_over_valid_positions():
    cfg, params = _ae_params("gru", window=3)
    eng = StreamingEngine(params, cfg, device="cpu")
    eng.open_session("x")
    res = eng.step({"x": np.ones((7, 1), np.float32)})["x"]
    assert isinstance(res.summary, RegressionSummary)
    assert res.length == 7 and res.summary.mean.shape == (3, 1)
    assert (res.summary.total >= res.summary.aleatoric).all()
    summ = regression_summary(torch.zeros((S, 1, 3, 1)), None)
    assert (summ.aleatoric == 0).all()
