"""The port's classifier and streaming engine against the JAX reference.

* ``classifier.apply`` of both port backends (on the CPU) against JAX
  ``classifier.apply``, with weights passed through the bridge.
* A 3-tick ragged ``StreamingEngine`` run with admissions queued past
  capacity, against the JAX engine with the same params, sessions and
  chunks: summaries within 1e-5, and row allocation and admission order
  exactly equal.
* Inside the port, chunked serving equals one unchunked pass bit for bit.

Sizes are small (H=8, T<=16, S=4) and the JAX side compiles few shapes.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import classifier as jclf, mcd as jmcd  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import classifier as tclf, mcd as tmcd  # noqa: E402
from repro_torch.core.uncertainty import classification_summary  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import StreamingEngine  # noqa: E402

ATOL = 1e-5
S, HID, NL, C, SEED = 4, 8, 3, 4, 5


def _cfgs():
    j = jclf.ClassifierConfig(hidden=HID, num_layers=NL, num_classes=C,
                              mcd=jmcd.MCDConfig(p=0.125, placement="YNY",
                                                 n_samples=S, seed=SEED))
    t = tclf.ClassifierConfig(hidden=HID, num_layers=NL, num_classes=C,
                              mcd=tmcd.MCDConfig(p=0.125, placement="YNY",
                                                 n_samples=S, seed=SEED))
    return j, t


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jclf.init(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, bridge.from_numpy_params(tree, device="cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


def _signals(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((length, 1)).astype(np.float32)
            for _ in range(n)]


def test_bridge_keeps_layouts(models):
    _, jparams, _, tparams = models
    for jl, tl in zip(jparams["encoder"], tparams["encoder"]):
        for a, b in zip(jl, tl):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jparams["head"].w),
                          tparams["head"].w.numpy())


def _apply_inputs():
    n, T = 3, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n * S, T, 1)).astype(np.float32)
    rows = np.arange(n * S, dtype=np.uint32) + 7
    rows[2] |= jmcd.STUDENT_ROW_FLAG
    lens = rng.integers(1, T + 1, size=n * S).astype(np.int32)
    return x, rows, lens


@pytest.fixture(scope="module")
def jax_apply_ref(models):
    """One JAX pass, shared by every port backend."""
    jcfg, jparams, _, _ = models
    x, rows, lens = _apply_inputs()
    ref, ref_states = jclf.apply(jparams, jnp.asarray(x), jnp.asarray(rows),
                                 jcfg, lengths=jnp.asarray(lens),
                                 return_state=True)
    return jax.tree.map(np.asarray, (ref, ref_states))


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_classifier_apply_matches_jax(models, jax_apply_ref, backend):
    _, _, tcfg, tparams = models
    x, rows, lens = _apply_inputs()
    ref, ref_states = jax_apply_ref
    got, states = tclf.apply(tparams, torch.from_numpy(x),
                             torch.from_numpy(rows.astype(np.int64)), tcfg,
                             backend=backend, lengths=torch.from_numpy(lens),
                             return_state=True, device="cpu")
    assert got.shape == (len(rows), C)
    _close(ref, got)
    for (rh, rc), (h, c) in zip(ref_states, states):
        _close(rh, h)
        _close(rc, c)


# Per tick: chunks per session (ragged).  "a" closes after tick 0, which
# lets the best queued ticket ("d", priority 3) in ahead of "c".
TICKS = [{"a": 5, "b": 8},
         {"b": 3, "d": 8},
         {"b": 6, "d": 2}]


def _drive(engine, to_array):
    signals = dict(zip("abcd", _signals(4, 20, seed=2)))
    engine.admit("a")
    engine.admit("b", priority=1)
    engine.admit("c")
    engine.admit("d", priority=3)
    log = {"rows": {}, "queued": [list(engine.queued_sessions)],
           "active": [], "summaries": []}
    for k, plan in enumerate(TICKS):
        chunks = {}
        for sid, n in plan.items():
            pos = engine.store.get(sid).steps
            chunks[sid] = to_array(signals[sid][pos:pos + n])
        res = engine.step(chunks)
        log["summaries"].append({sid: [np.asarray(v) for v in r.summary]
                                 for sid, r in res.items()})
        if k == 0:
            engine.close_session("a")
        log["active"].append(list(engine.active_sessions))
        log["queued"].append(list(engine.queued_sessions))
        for sid in engine.active_sessions:
            log["rows"][sid] = np.asarray(engine.store.get(sid).rows)
    log["next_row"] = engine.store.next_row
    return log


def test_streaming_engine_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    ref = _drive(JaxEngine(jparams, jcfg, backend="reference",
                           max_sessions=2, chunk_capacity=8), jnp.asarray)
    got = _drive(StreamingEngine(tparams, tcfg, max_sessions=2,
                                 chunk_capacity=8, device="cpu"),
                 lambda a: a)
    assert got["queued"] == ref["queued"] == [["d", "c"], ["c"], ["c"],
                                              ["c"]]
    assert got["active"] == ref["active"]
    assert got["next_row"] == ref["next_row"]
    assert got["rows"].keys() == ref["rows"].keys()
    for sid in ref["rows"]:
        assert np.array_equal(got["rows"][sid].astype(np.int64),
                              ref["rows"][sid].astype(np.int64))
    for rt, gt in zip(ref["summaries"], got["summaries"]):
        assert rt.keys() == gt.keys()
        for sid in rt:
            for r, g in zip(rt[sid], gt[sid]):
                _close(r, g)


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_chunked_equals_unchunked_bitwise(models, backend):
    _, _, tcfg, tparams = models
    plans = {"s0": [5, 3, 8], "s1": [4, 8, 4], "s2": [7, 7, 2]}
    sig = dict(zip(plans, _signals(3, 16, seed=4)))
    eng = StreamingEngine(tparams, tcfg, backend=backend, device="cpu")
    for sid in plans:
        eng.open_session(sid)
    for k in range(3):
        chunks = {}
        for sid, lens in plans.items():
            pos = eng.store.get(sid).steps
            chunks[sid] = sig[sid][pos:pos + lens[k]]
        res = eng.step(chunks)
        assert eng.last_metrics.launches == 0     # CPU: plain version
    x = torch.from_numpy(np.concatenate([np.repeat(sig[s][None], S, 0)
                                         for s in plans]))
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(s).rows for s in plans]).astype(np.int64))
    logits, states = tclf.apply(tparams, x, rows, tcfg, backend=backend,
                                lengths=torch.full((len(rows),), 16),
                                return_state=True, device="cpu")
    for li, (h, c) in enumerate(states):
        for k, sid in enumerate(plans):
            sh, sc = eng.store.get(sid).state[li]
            assert torch.equal(sh, h[k * S:(k + 1) * S])
            assert torch.equal(sc, c[k * S:(k + 1) * S])
    summ = classification_summary(
        logits.reshape(len(plans), S, -1).transpose(0, 1))
    for k, sid in enumerate(plans):
        for v, r in zip(res[sid].summary, summ):
            assert torch.equal(v, r[k])
