"""Student sessions in the port's engine: ``StreamingEngine(student=,
student_escalate_threshold=)``, ``SessionStore.grow`` and the student
snapshots, held against the JAX package on the CPU.

* The engine against the JAX engine (``pallas_seq``) with student and MC
  sessions co-batched over ragged ticks, an escalation among them, on the
  three port backends, the classifier and the autoencoder, at fp32 and
  bf16: summaries within SUMMARY_ATOL at fp32 (relative to values above
  1) and one bf16 ulp at bf16; ``student_rows``, ``escalations``, modes,
  rows and chain counts exactly equal, tick by tick.
* ``grow`` of an MC session and of a student session against JAX's store,
  bit for bit: rows, modes, the allocator, every carry part (bf16 h and
  fp32 c included).
* Inside the port, bit for bit on every backend: an escalated session
  equals an always-MC session attached with the regrown rows and the
  copied carry; MC sessions' summaries and carries do not move when
  student sessions join the tick (also in a ragged tick with a session
  below the chain ceiling); a student's carry equals a solo deterministic
  pass of its signal.
* ``distill_v1`` restores and serves one tick in an engine with heads, as
  ``tests/test_snapshot_compat.py::TestDistillCompat`` does, within
  SUMMARY_ATOL of the JAX engine; without heads it is refused.  A
  snapshot with students crosses packages both ways.  ``JsonlSink`` and
  ``summarize`` carry the new fields.

The JAX work is small: H = 8, NL = 2, S = 4 (the fixture's S = 2), a
capacity of 8, three ticks.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, classifier as jclf  # noqa: E402
from repro.core import distill as jdistill, mcd as jmcd  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro.serve.sessions import SessionStore as JaxStore  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae, classifier as tclf  # noqa: E402
from repro_torch.core import distill as tdistill, mcd as tmcd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import (JsonlSink, SessionStore,  # noqa: E402
                               StreamingEngine, summarize)

S, HID, NL, CAP = 4, 8, 2, 8
SUMMARY_ATOL = 1e-5   # fp32 summaries, relative to values above 1
BF16_ULPS = 1         # bf16 summaries: ulps of the larger magnitude
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "snapshots")
# Per tick: chunk lengths (ragged).  "s1", "s2" are students; "c" opens at
# S / 2 chains.
SIDS = ("a", "s1", "c", "s2", "b")
MODES = {"a": "mc", "s1": "student", "c": "mc", "s2": "student", "b": "mc"}
TICKS = [{"a": 5, "s1": 8, "c": 3, "s2": 6, "b": 7},
         {"a": 3, "s1": 2, "c": 8, "s2": 4, "b": 1},
         {"a": 6, "s1": 4, "c": 2, "s2": 7, "b": 5}]


def _cfgs(kind):
    m = dict(p=0.25, placement="YN" if kind == "classifier" else "YNYN",
             n_samples=S, seed=3)
    if kind == "classifier":
        kw = dict(hidden=HID, num_layers=NL, num_classes=4)
        return (jclf.ClassifierConfig(mcd=jmcd.MCDConfig(**m), **kw),
                tclf.ClassifierConfig(mcd=tmcd.MCDConfig(**m), **kw))
    kw = dict(hidden=HID, num_layers=NL, heteroscedastic=True)
    return (jae.AutoencoderConfig(mcd=jmcd.MCDConfig(**m), **kw),
            tae.AutoencoderConfig(mcd=tmcd.MCDConfig(**m), **kw))


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX cfg, params, student, port cfg, params, student)."""
    out = {}
    for kind in ("classifier", "autoencoder"):
        jcfg, tcfg = _cfgs(kind)
        jparams = (jclf if kind == "classifier" else jae).init(
            jax.random.key(0), jcfg)
        jstu = jdistill.init_student(jax.random.key(1), jcfg, jparams)
        out[kind] = (jcfg, jparams, jstu, tcfg,
                     bridge.from_numpy_params(
                         jax.tree.map(np.asarray, jparams), device="cpu"),
                     bridge.from_numpy_student(
                         jax.tree.map(np.asarray, jstu), device="cpu"))
    return out


def _signals():
    rng = np.random.default_rng(4)
    return {sid: rng.standard_normal((24, 1)).astype(np.float32)
            for sid in SIDS}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _drive(eng, to_array, ticks=TICKS, sids=SIDS):
    """Open ``sids`` (their modes; "c" at S / 2), serve ``ticks``; returns
    per tick {sid: summary fields} and the tick's (student_rows,
    escalations, {sid: (mode, rows)})."""
    sig = _signals()
    for sid in sids:
        eng.open_session(sid, mode=MODES[sid],
                         n_samples=S // 2 if sid == "c" else None)
    log = []
    for plan in ticks:
        chunks = {}
        for sid in sids:
            pos = eng.store.get(sid).steps
            chunks[sid] = to_array(sig[sid][pos:pos + plan[sid]])
        res = eng.step(chunks)
        m = eng.last_metrics
        log.append(({sid: [_np(v) for v in r.summary]
                     for sid, r in res.items()},
                    (m.student_rows, m.escalations,
                     {sid: (eng.store.get(sid).mode,
                            [int(r) for r in np.asarray(
                                eng.store.get(sid).rows)])
                      for sid in sids})))
    return log


def _threshold(models, kind):
    """A threshold between the two students' first predicted
    uncertainties, so exactly one escalates on tick 0."""
    jcfg, jparams, jstu, *_ = models[kind]
    log = _drive(JaxEngine(jparams, jcfg, backend="pallas_seq",
                           max_sessions=len(SIDS), chunk_capacity=CAP,
                           student=jstu), jnp.asarray, ticks=TICKS[:1])
    field = 3 if kind == "classifier" else 2
    u = sorted(float(np.mean(log[0][0][sid][field])) for sid in ("s1", "s2"))
    assert u[1] - u[0] > 1e-3, u
    return 0.5 * (u[0] + u[1])


def _close(got, want, precision, what):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.shape == w.shape, what
        if precision == "bf16":
            mag = np.maximum(np.abs(g), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert (np.abs(g - w) <= BF16_ULPS * ulp).all(), (what, i)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=SUMMARY_ATOL * max(1.0, np.abs(w).max()),
                err_msg=f"{what} field {i}")


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_engine_with_students_matches_jax(models, kind, precision):
    jcfg, jparams, jstu, tcfg, tparams, tstu = models[kind]
    thr = _threshold(models, kind)
    ref = _drive(JaxEngine(jparams, jcfg, backend="pallas_seq",
                           max_sessions=len(SIDS), chunk_capacity=CAP,
                           precision=precision, student=jstu,
                           student_escalate_threshold=thr), jnp.asarray)
    assert ref[0][1][:2] == (2, 1)      # one of the two escalates at once
    for backend in tops.LSTM_BACKENDS:
        got = _drive(StreamingEngine(tparams, tcfg, backend=backend,
                                     max_sessions=len(SIDS),
                                     chunk_capacity=CAP, precision=precision,
                                     student=tstu,
                                     student_escalate_threshold=thr,
                                     device="cpu"), lambda a: a)
        for t, ((gs, gm), (rs, rm)) in enumerate(zip(got, ref, strict=True)):
            assert gm == rm, (backend, t)
            assert gs.keys() == rs.keys()
            for sid in gs:
                _close(gs[sid], rs[sid], precision, f"{backend} t{t} {sid}")


# -- grow ----------------------------------------------------------------------

def _carry(rng, s, bf16):
    h = rng.standard_normal((s, 3)).astype(np.float32)
    c = rng.standard_normal((s, 3)).astype(np.float32)
    th = torch.from_numpy(h)
    jh = jnp.asarray(h)
    if bf16:
        th, jh = th.bfloat16(), jh.astype(jnp.bfloat16)
    return [(th, torch.from_numpy(c))], [(jh, jnp.asarray(c))]


@pytest.mark.parametrize("bf16", [False, True])
def test_grow_matches_the_jax_store(bf16):
    rng = np.random.default_rng(int(bf16))
    port, ref = SessionStore(6, seed=0), JaxStore(6, seed=0)
    for store in (port, ref):
        store.admit("m", n_samples=2)
        store.admit("s", mode="student")
        store.admit("f", mode="student")      # stays fresh
        store.admit("n", n_samples=3)         # stays fresh
    pm, jm = _carry(rng, 2, bf16)
    ps, js = _carry(rng, 1, bf16)
    port.get("m").state, ref.get("m").state = pm, jm
    port.get("s").state, ref.get("s").state = ps, js
    for sid, n in (("m", 5), ("s", 4), ("f", 6), ("n", 6), ("m", 5)):
        assert port.grow(sid, n) == ref.grow(sid, n)
    assert port.next_row == ref.next_row
    for sid in ("m", "s", "f", "n"):
        p, r = port.get(sid), ref.get(sid)
        assert p.mode == r.mode == "mc"
        assert p.rows.dtype == np.uint32
        assert np.array_equal(p.rows, np.asarray(r.rows))
        assert (p.state is None) == (r.state is None)
        for lp, lr in zip(p.state or (), r.state or (), strict=True):
            for a, b in zip(lp, lr, strict=True):
                assert str(a.dtype).endswith(str(b.dtype))
                assert np.array_equal(_np(a), _np(b))
    with pytest.raises(ValueError, match="grow target"):
        port.grow("m", 7)
    with pytest.raises(ValueError, match="grow target"):
        port.grow("m", 4)


def test_student_admission_rules():
    store = SessionStore(4, seed=0)
    sess = store.admit("s", mode="student")
    assert sess.rows.dtype == np.uint32 and sess.rows.shape == (1,)
    assert tmcd.is_student_row(int(sess.rows[0]))
    assert tmcd.base_row(int(sess.rows[0])) == 0 and store.next_row == 1
    assert store.admit("t", mode="student", n_samples=1).rows.shape == (1,)
    with pytest.raises(ValueError, match="exactly one"):
        store.admit("u", mode="student", n_samples=2)
    with pytest.raises(ValueError, match="mode"):
        store.admit("v", mode="distilled")
    # attach strips the flag to move the allocator
    evicted = store.evict("s")
    other = SessionStore(4, seed=0)
    other.attach(evicted)
    assert other.next_row == 1


# -- inside the port, bit for bit ------------------------------------------

def _equal_results(a, b, sids, what):
    for sid in sids:
        for x, y in zip(a[sid].summary, b[sid].summary, strict=True):
            assert torch.equal(x, y), (what, sid)


def _equal_carries(ea, eb, sids, what):
    for sid in sids:
        for la, lb in zip(ea.store.get(sid).state, eb.store.get(sid).state,
                          strict=True):
            for x, y in zip(la, lb, strict=True):
                assert x.dtype == y.dtype and torch.equal(x, y), (what, sid)


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_escalation_equals_the_attached_mc_twin(models, kind, backend):
    *_, tcfg, tparams, tstu = models[kind]
    sig = _signals()["a"]
    kw = dict(backend=backend, max_sessions=2, chunk_capacity=CAP,
              device="cpu")
    esc = StreamingEngine(tparams, tcfg, student=tstu,
                          student_escalate_threshold=0.0, **kw)
    esc.open_session("p", mode="student")
    esc.step({"p": sig[:4]})
    assert esc.last_metrics.escalations == 1
    sess = esc.store.get("p")
    assert sess.mode == "mc" and sess.rows.shape == (S,)
    twin = StreamingEngine(tparams, tcfg, **kw)
    twin.attach_session(dataclasses.replace(
        sess, rows=sess.rows.copy(),
        state=[tuple(part.clone() for part in layer)
               for layer in sess.state]))
    for t in range(1, 4):
        chunk = {"p": sig[4 * t:4 * (t + 1)]}
        _equal_results(esc.step(chunk), twin.step(chunk), ["p"],
                       f"tick {t}")
        assert esc.last_metrics.escalations == 0
    _equal_carries(esc, twin, ["p"], "final")


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_mc_sessions_unmoved_by_students(models, kind, backend):
    """The MC sessions ("a", "c" at S / 2, "b") served alone, then with two
    students co-batched between them on the same rows: summaries and
    carries bit-equal on every tick (each tick ragged: "c" is below the
    ceiling)."""
    *_, tcfg, tparams, tstu = models[kind]
    kw = dict(backend=backend, max_sessions=len(SIDS), chunk_capacity=CAP,
              device="cpu")
    mixed = StreamingEngine(tparams, tcfg, student=tstu, **kw)
    alone = StreamingEngine(tparams, tcfg, **kw)
    sig = _signals()
    for sid in SIDS:
        mixed.open_session(sid, mode=MODES[sid],
                           n_samples=S // 2 if sid == "c" else None)
    mc = [sid for sid in SIDS if MODES[sid] == "mc"]
    for sid in mc:
        sess = mixed.store.get(sid)
        alone.attach_session(dataclasses.replace(sess,
                                                 rows=sess.rows.copy()))
    for t, plan in enumerate(TICKS):
        chunks = {sid: sig[sid][mixed.store.get(sid).steps:][:plan[sid]]
                  for sid in SIDS}
        got = mixed.step(chunks)
        want = alone.step({sid: chunks[sid] for sid in mc})
        _equal_results(got, want, mc, f"tick {t}")
        assert mixed.last_metrics.student_rows == 2
        assert mixed.last_metrics.live_rows == \
            alone.last_metrics.live_rows + 2
    _equal_carries(mixed, alone, mc, "final")


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_student_is_the_deterministic_pass(models, kind, backend):
    """A student served in ragged chunks beside MC sessions: its carry
    equals one solo pass of its whole signal on a flagged row, its last
    summary the heads on that pass (bit for bit on the kernel
    backends)."""
    *_, tcfg, tparams, tstu = models[kind]
    eng = StreamingEngine(tparams, tcfg, backend=backend,
                          max_sessions=len(SIDS), chunk_capacity=CAP,
                          student=tstu, device="cpu")
    _drive(eng, lambda a: a)
    sess = eng.store.get("s2")
    whole = _signals()["s2"][:sess.steps][None]
    rows = torch.as_tensor(sess.rows.astype(np.int64))
    kw = dict(backend=backend, return_state=True, device="cpu")
    if kind == "classifier":
        _, states = tclf.apply(tparams, torch.from_numpy(whole), rows, tcfg,
                               **kw)
    else:
        *_, states = tae.apply(tparams, torch.from_numpy(whole), rows, tcfg,
                               **kw)
    for lp, lw in zip(sess.state, states, strict=True):
        for a, b in zip(lp, lw, strict=True):
            assert torch.equal(a, b)
    # The last chunk's summary: the heads on that chunk's pass resumed
    # from the carry before it.
    last = TICKS[-1]["s2"]
    eng2 = StreamingEngine(tparams, tcfg, backend=backend, max_sessions=1,
                           chunk_capacity=CAP, student=tstu, device="cpu")
    eng2.open_session("s2", mode="student")
    sig = _signals()["s2"]
    for plan in TICKS[:-1]:
        eng2.step({"s2": sig[eng2.store.get("s2").steps:][:plan["s2"]]})
    x = torch.from_numpy(sig[sess.steps - last:sess.steps][None])
    init = eng2.store.get("s2").state
    if kind == "classifier":
        _, st = tclf.apply(tparams, x, rows, tcfg, initial_state=init, **kw)
        want = tdistill.classifier_student_summary(tstu, st[-1][0])
    else:
        *_, dec, _ = tae.apply(tparams, x, rows, tcfg, initial_state=init,
                               return_decoded=True, **kw)
        want = tdistill.autoencoder_student_summary(tstu, dec, True)
    got = eng2.step({"s2": sig[sess.steps - last:sess.steps]})["s2"].summary
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w[0])


# -- refusals and metrics -------------------------------------------------------

def test_refusals(models):
    *_, tcfg, tparams, tstu = models["classifier"]
    with pytest.raises(ValueError, match="nothing to escalate"):
        StreamingEngine(tparams, tcfg, device="cpu",
                        student_escalate_threshold=0.1)
    with pytest.raises(ValueError, match=">= 0"):
        StreamingEngine(tparams, tcfg, device="cpu", student=tstu,
                        student_escalate_threshold=-1.0)
    eng = StreamingEngine(tparams, tcfg, device="cpu")
    with pytest.raises(ValueError, match="student"):
        eng.open_session("s", mode="student")
    with pytest.raises(ValueError, match="student"):
        eng.admit("s", mode="student")
    stu = SessionStore(S, seed=3).admit("x", mode="student")
    with pytest.raises(ValueError, match="student"):
        eng.attach_session(stu)
    with pytest.raises(ValueError, match="student"):
        eng.admit("x", session=stu)


def test_jsonl_sink_and_summarize_carry_the_student_fields(models,
                                                           tmp_path):
    *_, tcfg, tparams, tstu = models["classifier"]
    path = tmp_path / "ticks.jsonl"
    sink = JsonlSink(str(path))
    eng = StreamingEngine(tparams, tcfg, backend="cuda_seq", max_sessions=3,
                          chunk_capacity=CAP, student=tstu,
                          student_escalate_threshold=0.0,
                          metrics_sink=sink, device="cpu")
    eng.open_session("s", mode="student")
    eng.open_session("m")
    sig = _signals()["a"]
    eng.step({"s": sig[:3], "m": sig[:3]})
    eng.step({"s": sig[3:5], "m": sig[3:5]})
    sink.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(d["student_rows"], d["escalations"]) for d in lines] == \
        [(1, 1), (0, 0)]
    assert "student" in lines[0]["parts_s"]
    assert "escalate" in lines[0]["parts_s"]
    agg = summarize(eng.metrics)
    assert agg["student_rows_mean"] == 0.5 and agg["escalations"] == 1


# -- snapshots --------------------------------------------------------------------

FIX_HID, FIX_NL, FIX_S, FIX_SEED = 8, 2, 2, 3


@pytest.fixture(scope="module")
def fixture_models():
    """The distill_v1 fixture's geometry: the JAX engine's params and
    heads (as TestDistillCompat draws them) and the port's copies."""
    m = dict(p=0.125, placement="YN", n_samples=FIX_S, seed=FIX_SEED)
    kw = dict(hidden=FIX_HID, num_layers=FIX_NL)
    jcfg = jclf.ClassifierConfig(mcd=jmcd.MCDConfig(**m), **kw)
    tcfg = tclf.ClassifierConfig(mcd=tmcd.MCDConfig(**m), **kw)
    jparams = jclf.init(jax.random.key(0), jcfg)
    jstu = jdistill.init_student(jax.random.key(1), jcfg, jparams)
    return (jcfg, jparams, jstu, tcfg,
            bridge.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                     device="cpu"),
            bridge.from_numpy_student(jax.tree.map(np.asarray, jstu),
                                      device="cpu"))


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_distill_v1_restores_and_serves(fixture_models, backend):
    jcfg, jparams, jstu, tcfg, tparams, tstu = fixture_models
    path = os.path.join(FIXTURES, "distill_v1")
    port = StreamingEngine(tparams, tcfg, backend=backend, device="cpu",
                           student=tstu, chunk_capacity=CAP)
    port.restore(path)
    sess = port.store.get("ward_2")
    assert sess.mode == "student"
    assert sess.rows.shape == (1,) and int(sess.rows[0]) == \
        0x8000_0000 | FIX_S
    assert port.store.get("ward_1").mode == "mc"
    assert [t.mode for t in port.queue.waiting()] == ["student"]
    ref = JaxEngine(jparams, jcfg, backend="pallas_seq", student=jstu,
                    chunk_capacity=CAP)
    ref.restore(path)
    chunk = np.ones((3, 1), np.float32)
    got = port.step({"ward_2": chunk, "ward_1": chunk})
    want = ref.step({"ward_2": jnp.asarray(chunk),
                     "ward_1": jnp.asarray(chunk)})
    assert got["ward_2"].steps_total == want["ward_2"].steps_total == 10
    assert port.last_metrics.student_rows == 1
    for sid in got:
        _close([_np(v) for v in got[sid].summary],
               [_np(v) for v in want[sid].summary], None, sid)
    # the queued student ticket drains into a student session once a
    # session closes
    port.close_session("ward_1")
    queued = [s for s in port.active_sessions if s not in ("ward_2",)]
    assert queued and port.store.get(queued[0]).mode == "student"


def test_distill_v1_refused_without_heads(fixture_models):
    *_, tcfg, tparams, _ = fixture_models
    eng = StreamingEngine(tparams, tcfg, device="cpu")
    with pytest.raises(ValueError, match="student= heads"):
        eng.restore(os.path.join(FIXTURES, "distill_v1"))


def _serve_pair(eng, lo, hi, sig, to_array):
    out = None
    for t in range(lo, hi):
        out = eng.step({"stu": to_array(sig[3 * t:3 * (t + 1)]),
                        "mc": to_array(sig[3 * t:3 * (t + 1)])})
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_student_snapshot_crosses_packages(fixture_models, writer,
                                           tmp_path):
    """Two ticks with a live student and an MC session, a snapshot by one
    package, two more ticks in the other: within SUMMARY_ATOL of the
    writer's own uninterrupted run; modes and rows survive."""
    jcfg, jparams, jstu, tcfg, tparams, tstu = fixture_models
    sig = np.random.default_rng(3).standard_normal((12, 1)).astype(
        np.float32)

    def port():
        return StreamingEngine(tparams, tcfg, backend="cuda_seq",
                               device="cpu", student=tstu, max_sessions=4,
                               chunk_capacity=CAP)

    def ref():
        return JaxEngine(jparams, jcfg, backend="pallas_seq", student=jstu,
                         max_sessions=4, chunk_capacity=CAP)

    first, second = (port, ref) if writer == "port" else (ref, port)
    arr = {port: lambda a: a, ref: jnp.asarray}
    gold = first()
    gold.open_session("stu", mode="student")
    gold.open_session("mc")
    _serve_pair(gold, 0, 2, sig, arr[first])
    gold.snapshot(str(tmp_path))
    want = _serve_pair(gold, 2, 4, sig, arr[first])
    other = second()
    other.restore(str(tmp_path))
    assert other.store.get("stu").mode == "student"
    assert np.array_equal(np.asarray(other.store.get("stu").rows),
                          np.asarray(gold.store.get("stu").rows))
    got = _serve_pair(other, 2, 4, sig, arr[second])
    for sid in ("stu", "mc"):
        _close([_np(v) for v in got[sid].summary],
               [_np(v) for v in want[sid].summary], None, sid)


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
def test_kill_restore_with_students_is_bit_identical(fixture_models,
                                                     backend, tmp_path):
    *_, tcfg, tparams, tstu = fixture_models
    sig = np.random.default_rng(5).standard_normal((12, 1)).astype(
        np.float32)

    def engine():
        return StreamingEngine(tparams, tcfg, backend=backend, device="cpu",
                               student=tstu, max_sessions=2,
                               chunk_capacity=CAP)

    gold = engine()
    gold.open_session("stu", mode="student")
    gold.open_session("mc")
    want = _serve_pair(gold, 0, 4, sig, lambda a: a)
    victim = engine()
    victim.open_session("stu", mode="student")
    victim.open_session("mc")
    _serve_pair(victim, 0, 2, sig, lambda a: a)
    victim.admit("queued", mode="student")      # waits: the store is full
    victim.snapshot(str(tmp_path))
    revived = engine()
    revived.restore(str(tmp_path))
    assert revived.queued_sessions == ["queued"]
    got = _serve_pair(revived, 2, 4, sig, lambda a: a)
    _equal_results(got, want, ["stu", "mc"], "resumed")
    _equal_carries(revived, gold, ["stu", "mc"], "resumed")
