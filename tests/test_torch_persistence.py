"""Durable streams in the port: ``repro_torch.ckpt.checkpoint``,
``repro_torch.serve.persistence`` and ``StreamingEngine.snapshot /
restore``, held against the JAX package on the CPU.

* The committed golden snapshots (``tests/fixtures/snapshots``) restore
  into the port and serve one tick within 1e-5 of the JAX engine restored
  from the same files; a re-save of ``pr3_lstm`` reproduces its leaf
  names and sha256s; the typed refusals are the reference's; the fleet
  and distill goldens restore at the store level exactly as JAX restores
  them.
* The format crosses packages: a bf16 + fp32 store written by each gives
  the same leaf bytes, and an engine's snapshot continues in the other
  package's engine within 1e-5.
* Inside the port a killed engine resumes bit-identically: LSTM and GRU,
  on every backend, across ``chunk_capacity`` changes, on the graph path
  as the CPU runs it, at bf16 and int8.
* The reference's persistence cases: queue order and carries, the
  ``sids`` subset, aliasing sids, corrupt leaves, ``resume_or_none``,
  ``keep_last``.

The JAX work is small: H = 8, NL = 2, S = 2, seed 3 (the fixtures'
geometry), the JAX ``reference`` backend at one fixed capacity.
"""

import hashlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import classifier as jclf, mcd as jmcd  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro.serve import persistence as jpersist  # noqa: E402
from repro.serve.admission import AdmissionQueue as JaxQueue  # noqa: E402
from repro.serve.sessions import SessionStore as JaxStore  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.core import classifier as tclf, mcd as tmcd  # noqa: E402
from repro_torch.serve import (AdmissionQueue, SessionStore,  # noqa: E402
                               StreamingEngine, persistence)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "snapshots")
HIDDEN, NUM_LAYERS, N_SAMPLES, SEED = 8, 2, 2, 3
ATOL = 1e-5
CAP = 8


def _cfgs(cell="lstm", s=N_SAMPLES):
    kw = dict(hidden=HIDDEN, num_layers=NUM_LAYERS, num_classes=4, cell=cell)
    return (jclf.ClassifierConfig(mcd=jmcd.MCDConfig(
                p=0.125, placement="YN", n_samples=s, seed=SEED), **kw),
            tclf.ClassifierConfig(mcd=tmcd.MCDConfig(
                p=0.125, placement="YN", n_samples=s, seed=SEED), **kw))


@pytest.fixture(scope="module")
def models():
    """Per cell: (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    for cell in ("lstm", "gru"):
        jcfg, tcfg = _cfgs(cell)
        jparams = jclf.init(jax.random.key(0), jcfg)
        out[cell] = (jcfg, jparams, tcfg, bridge.from_numpy_params(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


def _port(models, cell="lstm", **kw):
    _, _, tcfg, tparams = models[cell]
    kw.setdefault("backend", "reference")
    kw.setdefault("max_sessions", 4)
    return StreamingEngine(tparams, tcfg, device="cpu", **kw)


def _jax(models, cell="lstm", **kw):
    jcfg, jparams, _, _ = models[cell]
    return JaxEngine(jparams, jcfg, backend="reference", max_sessions=4,
                     chunk_capacity=CAP, **kw)


def _chunks(seed, sids, n=3):
    rng = np.random.default_rng(seed)
    return {sid: rng.standard_normal((n + k, 1)).astype(np.float32)
            for k, sid in enumerate(sids)}


def _close(port_summary, jax_summary):
    for a, b in zip(port_summary, jax_summary, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def _leaves(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return [(e["name"], e["dtype"], e["shape"], e["sha256"])
                for e in json.load(f)["leaves"]]


# -- the golden fixtures ---------------------------------------------------

@pytest.mark.parametrize("name,cell", [("pr3_lstm", "lstm"),
                                       ("pr4_gru", "gru")])
def test_golden_fixture_serves_as_jax(models, name, cell):
    path = os.path.join(FIXTURES, name)
    port = _port(models, cell, chunk_capacity=CAP)
    ref = _jax(models, cell)
    assert port.restore(path) == ref.restore(path) == {}
    assert port.tick == ref.tick == 2
    for sid in ("ward_1", "ward_2"):
        p, r = port.store.get(sid), ref.store.get(sid)
        assert (p.steps, p.chunks) == (r.steps, r.chunks) == (7, 2)
        assert p.rows.dtype == np.uint32
        assert np.array_equal(p.rows, np.asarray(r.rows))
        for lp, lr in zip(p.state, r.state, strict=True):
            for a, b in zip(lp, lr, strict=True):
                assert np.array_equal(a.numpy(), np.asarray(b))
    chunks = _chunks(1, ["ward_1", "ward_2"])
    got = port.step(chunks)
    want = ref.step({k: jnp.asarray(v) for k, v in chunks.items()})
    for sid in chunks:
        assert got[sid].steps_total == want[sid].steps_total
        _close(got[sid].summary, want[sid].summary)
    assert port.tick == ref.tick == 3
    assert port.store.next_row == ref.store.next_row


def test_resave_reproduces_the_fixture_leaves(models, tmp_path):
    port = _port(models)
    port.restore(os.path.join(FIXTURES, "pr3_lstm"))
    path = port.snapshot(str(tmp_path))
    assert _leaves(path) == _leaves(os.path.join(
        FIXTURES, "pr3_lstm", "step-0000000000"))


def test_typed_refusals(models):
    with pytest.raises(ValueError, match="lstm"):
        _port(models, "gru").restore(os.path.join(FIXTURES, "pr3_lstm"))
    with pytest.raises(ValueError, match="precision"):
        _port(models, precision="int8").restore(
            os.path.join(FIXTURES, "pr3_lstm"))
    with pytest.raises(IOError, match="not a session"):
        _port(models).restore(os.path.join(FIXTURES, "fleet_v1"))
    with pytest.raises(ValueError, match="student"):
        _port(models).restore(os.path.join(FIXTURES, "distill_v1"))
    with pytest.raises(IOError, match="fleet"):
        persistence.load_fleet_meta(os.path.join(FIXTURES, "pr3_lstm"), 0)


def _same_session(p, r):
    assert (p.sid, p.steps, p.chunks, p.mode, p.seed) == \
        (r.sid, r.steps, r.chunks, r.mode, r.seed)
    assert np.array_equal(p.rows, np.asarray(r.rows))
    assert (p.state is None) == (r.state is None)
    for lp, lr in zip(p.state or (), r.state or (), strict=True):
        for a, b in zip(lp, lr, strict=True):
            assert np.array_equal(a.numpy(), np.asarray(b))


def _same_store(p, r):
    assert p.active == r.active and p.next_row == r.next_row
    assert (p.n_samples, p.seed, p.max_sessions) == \
        (r.n_samples, r.seed, r.max_sessions)
    for sid in p.active:
        _same_session(p.get(sid), r.get(sid))


def test_fleet_fixture_at_the_store_level():
    path = os.path.join(FIXTURES, "fleet_v1")
    meta, stores = persistence.restore_fleet(path, device="cpu")
    jmeta, jstores = jpersist.restore_fleet(path)
    assert stores.keys() == jstores.keys() == {"g0"}
    for g in stores:
        _same_store(stores[g][0], jstores[g][0])
        assert stores[g][1] == jstores[g][1]
    assert {k: v for k, v in meta.items() if k != "queue"} == \
        {k: v for k, v in jmeta.items() if k != "queue"}
    assert [{k: v for k, v in e.items() if k != "session_obj"}
            for e in meta["queue"]] == \
        [{k: v for k, v in e.items() if k != "session_obj"}
         for e in jmeta["queue"]]
    assert [e["session_obj"] for e in meta["queue"]] == [None]


def test_distill_fixture_at_the_store_level():
    path = os.path.join(FIXTURES, "distill_v1")
    q, jq = AdmissionQueue(), JaxQueue()
    store, meta = persistence.restore_store(path, queue=q, device="cpu")
    jstore, jmeta = jpersist.restore_store(path, queue=jq)
    _same_store(store, jstore)
    assert meta == jmeta
    assert store.get("ward_2").mode == "student"
    assert [(t.sid, t.priority, t.mode, t.n_samples) for t in q.waiting()] \
        == [(t.sid, t.priority, t.mode, t.n_samples) for t in jq.waiting()]
    # Students are ported: the queued student ticket drains into a student
    # session, as in the reference.
    store.evict("ward_1")
    jstore.evict("ward_1")
    got, want = q.drain(store), jq.drain(jstore)
    assert [(s.sid, s.mode) for s in got] == \
        [(s.sid, s.mode) for s in want] == [(want[0].sid, "student")]
    _same_store(store, jstore)


# -- the format across packages ----------------------------------------------

def _bf16_exact(rng, shape):
    """fp32 values that bf16 holds exactly."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def test_bf16_leaves_byte_identical_across_packages(tmp_path):
    rng = np.random.default_rng(7)
    carries = [(_bf16_exact(rng, (2, 4)),
                rng.standard_normal((2, 4)).astype(np.float32))
               for _ in range(2)]
    jstore, tstore = JaxStore(2, seed=5), SessionStore(2, seed=5)
    for store, conv in ((jstore, lambda h, c: (jnp.asarray(h, jnp.bfloat16),
                                               jnp.asarray(c))),
                        (tstore, lambda h, c: (torch.from_numpy(h).to(
                            torch.bfloat16), torch.from_numpy(c)))):
        store.admit("fresh")
        sess = store.admit("ward 1")
        sess.state = [conv(h, c) for h, c in carries]
        sess.steps, sess.chunks = 11, 2
    jpath = jpersist.snapshot_store(str(tmp_path / "jax"), jstore)
    tpath = persistence.snapshot_store(str(tmp_path / "port"), tstore)
    leaves = _leaves(tpath)
    assert leaves == _leaves(jpath)
    assert [d for _, d, _, _ in leaves] == \
        ["uint32", "uint32", "bfloat16", "float32", "bfloat16", "float32"]
    # each package reads the other's bf16 back bit for bit
    got, _ = persistence.restore_store(str(tmp_path / "jax"), device="cpu")
    jgot, _ = jpersist.restore_store(str(tmp_path / "port"))
    for (h, c), (jh, jc), (h0, c0) in zip(got.get("ward 1").state,
                                          jgot.get("ward 1").state, carries):
        assert h.dtype == torch.bfloat16 and c.dtype == torch.float32
        assert np.array_equal(h.float().numpy(), h0)
        assert np.array_equal(np.asarray(jh, np.float32), h0)
        assert np.array_equal(c.numpy(), c0)
        assert np.array_equal(np.asarray(jc), c0)
    assert got.get("fresh").fresh and jgot.get("fresh").fresh


def _serve(eng, ticks, sids, seed0, to=lambda a: a):
    out = None
    for t in range(ticks):
        out = eng.step({k: to(v) for k, v in
                        _chunks(seed0 + t, sids).items()})
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_continues_in_the_other_package(models, writer, tmp_path):
    sids = ["a", "b"]
    gold = _jax(models)
    for sid in sids:
        gold.open_session(sid)
    _serve(gold, 2, sids, 10, jnp.asarray)
    want = _serve(gold, 2, sids, 12, jnp.asarray)
    first = _jax(models) if writer == "jax" else _port(models)
    for sid in sids:
        first.open_session(sid)
    _serve(first, 2, sids, 10, jnp.asarray if writer == "jax"
           else lambda a: a)
    first.snapshot(str(tmp_path))
    if writer == "jax":
        second = _port(models, chunk_capacity=CAP)
        second.restore(str(tmp_path))
        got = _serve(second, 2, sids, 12)
        pairs = [(got[s].summary, want[s].summary) for s in sids]
    else:
        second = _jax(models)
        second.restore(str(tmp_path))
        got = _serve(second, 2, sids, 12, jnp.asarray)
        pairs = [(tuple(torch.from_numpy(np.array(v)) for v in
                        got[s].summary), want[s].summary) for s in sids]
    assert second.tick == 4
    for p, r in pairs:
        _close(p, r)


# -- kill -> snapshot -> restore inside the port ---------------------------

KILL_CASES = [
    # (cell, backend, precision, capacity before, capacity after)
    ("lstm", "reference", None, None, 8),
    ("lstm", "cuda_seq", None, None, 8),
    ("lstm", "cuda_seq", None, 8, "auto"),
    ("lstm", "cuda_step", None, "auto", None),
    ("gru", "reference", None, None, "auto"),
    ("gru", "cuda_seq", None, 8, 8),
    ("gru", "cuda_step", None, None, 8),
    ("lstm", "cuda_seq", "bf16", 8, "auto"),
    ("gru", "cuda_step", "bf16", 8, 8),
    ("lstm", "cuda_step", "int8", None, 8),
    ("gru", "cuda_seq", "int8", "auto", None),
]


def _kill_engine(models, cell, backend, precision, capacity):
    return _port(models, cell, backend=backend, precision=precision,
                 chunk_capacity=capacity, max_sessions=3,
                 ladder=(4, 8) if capacity == "auto" else None)


@pytest.mark.parametrize("cell,backend,precision,before,after", KILL_CASES)
def test_kill_restore_bit_identical(models, cell, backend, precision,
                                   before, after, tmp_path):
    sids = ["a", "b", "c"]

    def run(eng, t0, t1):
        ticks = []
        for t in range(t0, t1):
            live = sids if t < 2 else sids[:2]
            ticks.append(eng.step(_chunks(20 + t, live, n=2)))
            if t == 1:
                eng.admit("c", session=eng.close_session("c"))
        return ticks

    gold = _kill_engine(models, cell, backend, precision, before)
    for sid in sids:
        gold.open_session(sid)
    want = run(gold, 0, 4)
    victim = _kill_engine(models, cell, backend, precision, before)
    for sid in sids:
        victim.open_session(sid)
    run(victim, 0, 2)
    victim.snapshot(str(tmp_path))
    del victim
    revived = _kill_engine(models, cell, backend, precision, after)
    revived.restore(str(tmp_path))
    got = run(revived, 2, 4)
    for g, w in zip(got, want[2:], strict=True):
        assert g.keys() == w.keys()
        for sid in g:
            for a, b in zip(g[sid].summary, w[sid].summary, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    for sid in sids:
        for lg, lw in zip(revived.store.get(sid).state,
                          gold.store.get(sid).state, strict=True):
            for a, b in zip(lg, lw, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert revived.queued_sessions == gold.queued_sessions == []


def test_restore_into_prewarmed_engine_captures_nothing(models, tmp_path):
    from repro_torch.serve import prewarm
    victim = _kill_engine(models, "lstm", "cuda_seq", None, 8)
    victim.open_session("a")
    victim.step(_chunks(0, ["a"]))
    victim.snapshot(str(tmp_path))
    eng = _kill_engine(models, "lstm", "cuda_seq", None, "auto")
    prewarm(eng)
    eng.restore(str(tmp_path))
    eng.step(_chunks(1, ["a"]))
    assert eng.last_metrics.compiles == 0
    assert eng.store.get("a").state[0][0].device.type == "cpu"


# -- the reference's persistence cases ----------------------------------------

def _store_with_state(s=2, hid=4, layers=2):
    store = SessionStore(n_samples=s, seed=5, max_sessions=4)
    a = store.admit("a")                        # fresh, no carry yet
    b = store.admit("b")
    b.state = [(torch.arange(s * hid, dtype=torch.bfloat16).reshape(s, hid),
                torch.arange(s * hid, dtype=torch.float32).reshape(s, hid)
                * 0.5) for _ in range(layers)]
    b.steps, b.chunks = 17, 3
    return store, a, b


def test_snapshot_restore_bit_exact(tmp_path):
    store, _, b = _store_with_state()
    path = persistence.snapshot_store(str(tmp_path), store)
    assert path.endswith("step-0000000000")
    got, meta = persistence.restore_store(str(tmp_path), device="cpu")
    assert meta["seed"] == 5 and got.active == ["a", "b"]
    assert got.next_row == store.next_row
    ga, gb = got.get("a"), got.get("b")
    assert ga.fresh and gb.steps == 17 and gb.chunks == 3
    assert np.array_equal(gb.rows, b.rows) and gb.rows.dtype == np.uint32
    for (h, c), (h0, c0) in zip(gb.state, b.state):
        assert h.dtype == torch.bfloat16 and c.dtype == torch.float32
        assert torch.equal(h, h0) and torch.equal(c, c0)


def test_queue_roundtrip_preserves_order_and_carry(tmp_path):
    store, _, _ = _store_with_state()
    q = AdmissionQueue()
    evicted = store.evict("b")
    q.submit("b", priority=1, session=evicted)
    q.submit("c", priority=7, n_samples=1)
    persistence.snapshot_store(str(tmp_path), store, queue=q)
    q2 = AdmissionQueue()
    got, _ = persistence.restore_store(str(tmp_path), queue=q2,
                                       device="cpu")
    assert [t.sid for t in q2.waiting()] == ["c", "b"]
    tickets = {t.sid: t for t in q2.waiting()}
    assert tickets["c"].n_samples == 1 and tickets["c"].session is None
    assert tickets["b"].session.steps == 17
    for (h, c), (h0, c0) in zip(tickets["b"].session.state, evicted.state):
        assert torch.equal(h, h0) and torch.equal(c, c0)
    q2.drain(got)                               # both go live, c first
    assert got.active == ["a", "c", "b"]
    assert got.get("c").rows.shape == (1,)


def test_sids_subset_burns_unrestored_rows(tmp_path):
    store, _, _ = _store_with_state()
    q = AdmissionQueue()
    q.submit("fresh-q", priority=2)
    persistence.snapshot_store(str(tmp_path), store, queue=q)
    got, _ = persistence.restore_store(str(tmp_path), sids=["b"],
                                       queue=AdmissionQueue(), device="cpu")
    assert got.active == ["b"]
    assert got.admit("new").rows.min() >= store.next_row
    with pytest.raises(KeyError, match="no session"):
        persistence.restore_store(str(tmp_path), sids=["ghost"],
                                  device="cpu")
    with pytest.raises(ValueError, match="silently drop"):
        persistence.restore_store(str(tmp_path), device="cpu")
    q3 = AdmissionQueue()
    got3, _ = persistence.restore_store(str(tmp_path), sids=["a", "fresh-q"],
                                        queue=q3, device="cpu")
    assert got3.active == ["a"] and [t.sid for t in q3.waiting()] == \
        ["fresh-q"]


def test_aliasing_sids_never_cross_contaminate(tmp_path):
    store = SessionStore(n_samples=1, seed=0, max_sessions=4)
    for sid, fill in (("ward 3", 1.0), ("ward_3", 2.0)):
        sess = store.admit(sid)
        sess.state = [(torch.full((1, 4), fill), torch.full((1, 4), fill))]
        sess.steps = int(fill)
    persistence.snapshot_store(str(tmp_path), store)
    for sid, fill in (("ward 3", 1.0), ("ward_3", 2.0)):
        got, _ = persistence.restore_store(str(tmp_path), sids=[sid],
                                           device="cpu")
        h, c = got.get(sid).state[0]
        assert torch.equal(c, torch.full((1, 4), fill))
        assert np.array_equal(got.get(sid).rows, store.get(sid).rows)
        assert got.get(sid).steps == int(fill)


def test_corrupt_leaf_raises(tmp_path):
    store, _, _ = _store_with_state()
    path = persistence.snapshot_store(str(tmp_path), store)
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[-1]
    with open(os.path.join(path, victim), "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\x7f")
    with pytest.raises(IOError, match="checksum"):
        persistence.restore_store(str(tmp_path), device="cpu")


def test_checkpoint_resume_falls_back_and_keep_last_prunes(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "layers": [(np.arange(3, dtype=np.int32),
                        torch.ones(2, dtype=torch.bfloat16))]}
    for step in range(4):
        checkpoint.save(d, step, tree, meta={"step": step})
    assert checkpoint.latest_step(d) == 3
    bad = os.path.join(d, "step-0000000003", "w.npy")
    with open(bad, "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\x00")
    step, got = checkpoint.resume_or_none(d, tree)
    assert step == 2 and checkpoint.load_meta(d, 2) == {"step": 2}
    assert np.array_equal(got["w"], tree["w"].numpy())
    assert got["layers"][0][1].dtype == torch.bfloat16
    on_dev = checkpoint.restore(d, 2, tree, "cpu")
    assert isinstance(on_dev["layers"][0][0], torch.Tensor)
    checkpoint.keep_last(d, 2)
    assert sorted(os.listdir(d)) == ["step-0000000002", "step-0000000003"]
    with pytest.raises(ValueError, match="misses"):
        checkpoint.restore(d, 2, {"w": 0})
    with pytest.raises(KeyError, match="not in checkpoint"):
        checkpoint.restore(d, 2, {"v": 0}, partial=True)
    assert checkpoint.resume_or_none(str(tmp_path / "none"), tree) is None


def test_leaf_names_follow_jax_flattening():
    tree = {"ward 1": {"rows": 1, "state": [[1, 2]]}, "b": {"rows": 2},
            "x": (3, None, 4), "dup": {"a b": 1, "a_b": 2}}
    names = checkpoint._leaf_names(tree)
    assert names == ["b_rows", "dup_a_b", "dup_a_b__1", "ward_1_rows",
                     "ward_1_state_0_0", "ward_1_state_0_1", "x_0", "x_2"]
    # the reference's names, from its own flattener
    from repro.ckpt import checkpoint as jckpt
    assert names == jckpt._leaf_names(tree)


def test_partial_restore_refuses_disambiguated_names(tmp_path):
    tree = {"dup": {"a b": np.ones(1), "a_b": np.zeros(1)}, "k": np.ones(2)}
    checkpoint.save(str(tmp_path), 0, tree)
    with pytest.raises(ValueError, match="positionally"):
        checkpoint.restore(str(tmp_path), 0, {"dup": {"a_b": 0}},
                           partial=True)
    got = checkpoint.restore(str(tmp_path), 0, {"k": 0}, partial=True)
    assert np.array_equal(got["k"], np.ones(2))


def test_unknown_dtype_raises_ioerror(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 0, {"w": np.zeros(2, np.float32)})
    path = os.path.join(d, "step-0000000000", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["leaves"][0]["dtype"] = "float8_e4m3fn"
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="reinterpret"):
        checkpoint.restore(d, 0, {"w": 0})


def test_checkpoint_bytes_hash_as_recorded(tmp_path):
    path = checkpoint.save(str(tmp_path), 5, {"h": torch.ones(
        3, dtype=torch.bfloat16)})
    with open(os.path.join(path, "h.npy"), "rb") as f:
        data = f.read()
    (_, dtype, shape, sha), = _leaves(path)
    assert (dtype, shape) == ("bfloat16", [3])
    assert hashlib.sha256(data).hexdigest() == sha
    assert np.load(os.path.join(path, "h.npy")).dtype.str == "|V2"
