"""Early exit in the port: the running summaries, ``SessionStore.retire``
and ``StreamingEngine(early_exit_threshold=, min_samples=)``, held against
the JAX package on the CPU.

* ``RunningClassificationSummary`` / ``RunningRegressionSummary`` equal
  JAX's on the same float64 inputs (any partition of the chains) and the
  port's batch summaries within 1e-6; ``accuracy`` and ECE equal JAX's.
* ``retire`` trims rows and carries to a prefix; ids stay burned.
* A flat signal halves to the floor, a random one keeps every chain, the
  ``min_samples`` floor binds mid-halving, a threshold of None never
  retires, and retained sessions' outputs never move (bit for bit).
* On the same inputs the port retires what the JAX engine retires, tick
  by tick (``reclaimed_rows`` and every session's chain count), wherever
  the port's delta is more than 1e-5 from the threshold; the margins are
  printed.
* Per-session S round-trips a snapshot, and the resumed engine goes on
  bit-identically.

The JAX work is small: H = 8, NL = 2, S = 8, the JAX ``reference``
backend at one fixed capacity.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, classifier as jclf  # noqa: E402
from repro.core import mcd as jmcd, uncertainty as junc  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import classifier as tclf  # noqa: E402
from repro_torch.core import mcd as tmcd, uncertainty as tunc  # noqa: E402
from repro_torch.serve import (SessionStore, StreamingEngine,  # noqa: E402
                               summarize)

S, CAP = 8, 8


def _models(kind):
    kw = dict(hidden=8, num_layers=2 if kind == "classifier" else 1)
    if kind == "classifier":
        jm, tm, kw = jclf, tclf, dict(kw, num_classes=4)
        jcfg = jm.ClassifierConfig(**kw, mcd=jmcd.MCDConfig(
            p=0.125, placement="YN", n_samples=S, seed=3))
        tcfg = tm.ClassifierConfig(**kw, mcd=tmcd.MCDConfig(
            p=0.125, placement="YN", n_samples=S, seed=3))
    else:
        jm, tm = jae, tae
        jcfg = jm.AutoencoderConfig(**kw, mcd=jmcd.MCDConfig(
            p=0.125, placement="YN", n_samples=S, seed=1))
        tcfg = tm.AutoencoderConfig(**kw, mcd=tmcd.MCDConfig(
            p=0.125, placement="YN", n_samples=S, seed=1))
    jparams = jm.init(jax.random.key(0), jcfg)
    return jcfg, jparams, tcfg, bridge.from_numpy_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def models():
    return {kind: _models(kind) for kind in ("classifier", "autoencoder")}


def _port(models, kind="classifier", **kw):
    _, _, tcfg, tparams = models[kind]
    kw.setdefault("max_sessions", 2)
    kw.setdefault("backend", "reference")
    return StreamingEngine(tparams, tcfg, device="cpu", **kw)


def _sig(seed, t, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((t, 1))
            * scale).astype(np.float32)


# -- the running summaries -------------------------------------------------

def _blocks(rng, parts, shape):
    return [rng.standard_normal((n,) + shape) * 3 for n in parts]


@pytest.mark.parametrize("parts", [(8,), (1, 7), (3, 3, 2), (1,) * 5])
def test_running_classification_matches_jax_and_batch(parts):
    rng = np.random.default_rng(sum(parts) + len(parts))
    blocks = _blocks(rng, parts, (3, 5))
    got, ref = tunc.RunningClassificationSummary(), \
        junc.RunningClassificationSummary()
    for b in blocks:
        got.update(b if len(got.__dict__) % 2 else torch.from_numpy(b))
        ref.update(b)
    merged = tunc.RunningClassificationSummary().update(blocks[0])
    for b in blocks[1:]:
        merged.merge(tunc.RunningClassificationSummary().update(b))
    batch = tunc.classification_summary(
        torch.from_numpy(np.concatenate(blocks)).float())
    for g, m, r, b in zip(got.finalize(), merged.copy().finalize(),
                          ref.finalize(), batch):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(m.numpy(), g.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("parts", [(8,), (1, 7), (3, 3, 2), (1,) * 5])
@pytest.mark.parametrize("het", [True, False])
def test_running_regression_matches_jax_and_batch(parts, het):
    rng = np.random.default_rng(sum(parts) * 3 + het)
    mus = _blocks(rng, parts, (2, 4, 1))
    lvs = _blocks(rng, parts, (2, 4, 1)) if het else [None] * len(parts)
    got, ref = tunc.RunningRegressionSummary(), \
        junc.RunningRegressionSummary()
    for mu, lv in zip(mus, lvs):
        got.update(torch.from_numpy(mu), lv)
        ref.update(mu, lv)
    batch = tunc.regression_summary(
        torch.from_numpy(np.concatenate(mus)).float(),
        torch.from_numpy(np.concatenate(lvs)).float() if het else None)
    for g, r, b in zip(got.finalize(), ref.finalize(), batch):
        assert np.array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=0, atol=1e-5
                                   * max(1.0, float(b.abs().max())))


def test_running_summaries_refuse_bad_input():
    with pytest.raises(ValueError, match="no chains"):
        tunc.RunningClassificationSummary().finalize()
    with pytest.raises(ValueError, match="no chains"):
        tunc.RunningRegressionSummary().finalize()
    with pytest.raises(ValueError, match=r"\[s, B, C\]"):
        tunc.RunningClassificationSummary().update(np.zeros((2, 3)))
    with pytest.raises(ValueError, match=r"\[s, \.\.\.\]"):
        tunc.RunningRegressionSummary().update(np.zeros(3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracy_and_ece_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((64, 5)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, 5, 64)
    tp, tl = torch.from_numpy(probs), torch.from_numpy(labels)
    assert float(tunc.accuracy(tp, tl)) == float(
        junc.accuracy(jnp.asarray(probs), jnp.asarray(labels)))
    for n_bins in (10, 15):
        got = tunc.expected_calibration_error(tp, tl, n_bins)
        want = junc.expected_calibration_error(jnp.asarray(probs),
                                               jnp.asarray(labels), n_bins)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-6)


# -- the store ------------------------------------------------------------

def test_retire_prefix_trims_rows_and_carries():
    store = SessionStore(n_samples=6, seed=0)
    sess = store.admit("a")
    rows_before = sess.rows.copy()
    sess.state = [(torch.arange(12.0).reshape(6, 2),
                   torch.arange(12.0).reshape(6, 2) + 100)]
    assert store.retire("a", 4) == 2
    assert np.array_equal(sess.rows, rows_before[:4])
    assert sess.state[0][0].shape == (4, 2)
    assert torch.equal(sess.state[0][1],
                       torch.arange(8.0).reshape(4, 2) + 100)
    assert store.active_chains == 4 and store.next_row == 6  # ids burned
    assert store.retire("a", 4) == 0
    for bad in (5, 0):
        with pytest.raises(ValueError, match="keep"):
            store.retire("a", bad)
    assert store.admit("b", n_samples=2).rows.tolist() == [6, 7]
    assert [s.sid for s in store.sessions()] == ["a", "b"]


def test_engine_validation(models):
    with pytest.raises(ValueError, match="threshold"):
        _port(models, early_exit_threshold=-0.5)
    with pytest.raises(ValueError, match="min_samples"):
        _port(models, min_samples=S + 1)
    with pytest.raises(ValueError, match="min_samples"):
        _port(models, min_samples=0)


# -- retirement behaviour -----------------------------------------------------

@pytest.mark.parametrize("backend,capacity", [("reference", None),
                                              ("cuda_seq", 8),
                                              ("cuda_step", "auto")])
def test_flat_halves_to_floor_random_keeps_all(models, backend, capacity):
    eng = _port(models, backend=backend, chunk_capacity=capacity,
                ladder=(4, 8) if capacity == "auto" else None,
                early_exit_threshold=0.0, min_samples=2)
    eng.open_session("hard")
    eng.open_session("easy")
    hard = _sig(7, 24, 3.0)
    for t, want in enumerate([4, 2, 2]):          # 8 -> 4 -> 2, then floor
        eng.step({"easy": np.zeros((8, 1), np.float32),
                  "hard": hard[8 * t:8 * (t + 1)]})
        assert eng.store.get("easy").rows.shape[0] == want
        assert eng.store.get("hard").rows.shape[0] == S
    assert [m.reclaimed_rows for m in eng.metrics] == [4, 2, 0]
    assert summarize(eng.metrics)["reclaimed_rows"] == 6
    assert eng.store.active_chains == 10 == eng.metrics[-1].active_chains


def test_autoencoder_flat_retires(models):
    eng = _port(models, "autoencoder", max_sessions=1,
                early_exit_threshold=0.0, min_samples=2)
    eng.open_session("z")
    for _ in range(3):
        eng.step({"z": np.zeros((5, 1), np.float32)})
    assert eng.store.get("z").rows.shape[0] == 2


def test_min_samples_floor_binds_mid_halving(models):
    eng = _port(models, max_sessions=1, early_exit_threshold=0.0,
                min_samples=3)
    eng.open_session("z")
    sizes = []
    for _ in range(3):
        eng.step({"z": np.zeros((4, 1), np.float32)})
        sizes.append(int(eng.store.get("z").rows.shape[0]))
    assert sizes == [4, 3, 3]


def test_threshold_none_never_retires(models):
    eng = _port(models, max_sessions=1)
    eng.open_session("z")
    for _ in range(3):
        eng.step({"z": np.zeros((4, 1), np.float32)})
    assert eng.store.get("z").rows.shape[0] == S
    assert all(m.reclaimed_rows == 0 and m.active_chains == S
               for m in eng.metrics)
    assert eng.last_exit_deltas == {}


@pytest.mark.parametrize("backend,capacity", [("reference", None),
                                              ("cuda_seq", None),
                                              ("cuda_seq", 8),
                                              ("cuda_step", "auto")])
def test_retained_outputs_never_move(models, backend, capacity):
    T, chunk = 16, 4
    hard = _sig(8, T)
    kw = dict(backend=backend, chunk_capacity=capacity,
              ladder=(4, 8) if capacity == "auto" else None)
    plain = _port(models, **kw)
    eng = _port(models, early_exit_threshold=0.0, min_samples=1, **kw)
    for e in (plain, eng):
        e.open_session("hard")
        e.open_session("easy")
    for lo in range(0, T, chunk):
        zeros = np.zeros((chunk, 1), np.float32)
        want = plain.step({"hard": hard[lo:lo + chunk], "easy": zeros})
        got = eng.step({"hard": hard[lo:lo + chunk], "easy": zeros})
        for a, b in zip(got["hard"].summary, want["hard"].summary):
            assert torch.equal(a, b)
    for a, b in zip(eng.store.get("hard").state[0],
                    plain.store.get("hard").state[0]):
        assert torch.equal(a, b)
    assert eng.store.get("easy").rows.shape[0] == 1
    assert plain.store.get("easy").rows.shape[0] == S


# -- the same decisions as the reference -----------------------------------

THRESHOLD = 1e-3
DECISION_MARGIN = 1e-5


@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_decisions_equal_jax(models, kind):
    jcfg, jparams, _, _ = models[kind]
    sids = ["flat", "small", "ecg", "loud"]
    scale = {"flat": 0.0, "small": 0.05, "ecg": 1.0, "loud": 4.0}
    kw = dict(early_exit_threshold=THRESHOLD, min_samples=2, max_sessions=4)
    ref = JaxEngine(jparams, jcfg, backend="reference", chunk_capacity=CAP,
                    **kw)
    port = _port(models, kind, chunk_capacity=CAP, **kw)
    for e in (ref, port):
        for sid in sids:
            e.open_session(sid)
    margins, compared = [], 0
    for t in range(4):
        chunks = {sid: _sig(10 * t + k, 6, scale[sid])
                  for k, sid in enumerate(sids)}
        ref.step({k: jnp.asarray(v) for k, v in chunks.items()})
        port.step(chunks)
        deltas = dict(port.last_exit_deltas)
        for sid in sids:
            s_ref = int(ref.store.get(sid).rows.shape[0])
            s_port = int(port.store.get(sid).rows.shape[0])
            if sid in deltas:
                margin = abs(deltas[sid] - THRESHOLD)
                margins.append(margin)
                if margin <= DECISION_MARGIN:
                    continue      # too near the threshold to compare
            assert s_port == s_ref, (t, sid, deltas.get(sid))
            assert np.array_equal(port.store.get(sid).rows,
                                  np.asarray(ref.store.get(sid).rows))
            compared += 1
        if all(abs(d - THRESHOLD) > DECISION_MARGIN for d in deltas.values()):
            assert port.last_metrics.reclaimed_rows == \
                ref.last_metrics.reclaimed_rows
            assert port.last_metrics.active_chains == \
                ref.last_metrics.active_chains
    print(f"{kind}: {compared} decisions compared; |delta - threshold| "
          f"min {min(margins):.3g}, {len(margins)} deltas")
    assert compared == 4 * len(sids)
    assert summarize(port.metrics)["reclaimed_rows"] > 0


# -- durability -------------------------------------------------------------

def test_per_session_s_roundtrips_through_snapshot(models, tmp_path):
    T, chunk = 16, 4
    hard = _sig(9, T)
    kw = dict(early_exit_threshold=0.0, min_samples=2, backend="cuda_seq",
              chunk_capacity=8)

    def serve(eng, lo, hi, out=None):
        for a in range(lo, hi, chunk):
            out = eng.step({"hard": hard[a:a + chunk],
                            "easy": np.zeros((chunk, 1), np.float32)})
        return out

    gold = _port(models, **kw)
    victim = _port(models, **kw)
    for e in (gold, victim):
        e.open_session("hard")
        e.open_session("easy")
    final_gold = serve(gold, 0, T)
    serve(victim, 0, T // 2)
    assert victim.store.get("easy").rows.shape[0] == 2
    victim.snapshot(str(tmp_path))
    del victim
    revived = _port(models, **dict(kw, chunk_capacity="auto",
                                   ladder=(4, 8)))
    revived.restore(str(tmp_path))
    sess = revived.store.get("easy")
    assert sess.rows.tolist() == [8, 9]               # reduced S survived
    final = serve(revived, T // 2, T)
    for sid in ("hard", "easy"):
        for a, b in zip(final[sid].summary, final_gold[sid].summary):
            assert torch.equal(a, b)
        for la, lb in zip(revived.store.get(sid).state,
                          gold.store.get(sid).state):
            for a, b in zip(la, lb):
                assert torch.equal(a, b)


def test_queued_ticket_n_samples_survives_snapshot(models, tmp_path):
    eng = _port(models, max_sessions=1)
    eng.open_session("live")
    assert eng.admit("waiting", n_samples=3) is None   # queued
    eng.step({"live": np.ones((2, 1), np.float32)})
    eng.snapshot(str(tmp_path))
    revived = _port(models, max_sessions=1)
    revived.restore(str(tmp_path))
    revived.close_session("live")                # frees the row
    revived.step({})
    assert revived.store.get("waiting").rows.shape[0] == 3
