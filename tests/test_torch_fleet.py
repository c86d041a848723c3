"""The multi-tenant fleet in the port: ``serve/fleet.py``, the
weighted-fair queue (``serve/admission.py``), tenant-tagged metrics
(``serve/scheduler.py``), the data plane of a reconfiguration
(``serve/controller.py``) and the ``--tenants`` launcher, held against the
JAX package on the CPU.

* **Queue.**  ``WeightedFairQueue`` against JAX's on scripted submit /
  drain / cancel sequences (budgets, frozen tenants, rejects, the aging
  guard, a skewed ledger): every drain's admission order, rejects,
  ``state()``, ``waiting()`` and ``shares()`` exactly equal.
  ``AdmissionQueue.cancel`` (heap compaction included), ``depth``,
  ``__contains__`` and ``__iter__`` likewise.
* **Fleet against the JAX fleet.**  Two heterogeneous tenants (an LSTM
  classifier and a GRU autoencoder) under a per-tick admission budget,
  ragged ticks, a close and a poison re-attach: summaries within
  SUMMARY_ATOL of JAX's ``reference`` backend on each port backend, every
  integer per-tenant ``TickMetrics`` field equal (``tenant``,
  ``queue_depth`` and ``dropped`` included; ``compiles`` is the port's
  documented divergence, ``launches`` the port's own field), and
  ``summarize()["tenants"]``.
* **Data plane.**  ``carry_dtypes`` and ``convert_session`` against JAX's.
* **Port invariants, bit for bit on the three port backends.**  A tenant
  in a shared fleet tick equals its sessions in an engine of their own on
  the same rows (two same-S tenants sharing a group, a tenant below the
  group's ceiling, a quantized tenant); neither a chain-axis summary nor
  a row of the ``reference`` backend's step follows the batch around it
  (the two faults this slice repaired, ROADMAP C);
  kill -> snapshot -> restore of the whole fleet mid-stream with a queued
  fresh ticket and a queued re-attach; a reconfiguration's surviving
  chains and untouched tenants.
* **Snapshots across packages.**  A fleet snapshot restores in the other
  package both ways; ``fleet_v1`` restores and serves, ``pr3_lstm`` is
  adopted into a one-tenant fleet (the port of
  ``tests/test_snapshot_compat.py::TestFleetFixtures``).
* **Reconfiguration.**  ``reconfigure_tenant``'s groups, ceilings and row
  cursors equal JAX's; a tenant with student heads reconfigures as in
  JAX (the new engine has no heads; the student session comes back an MC
  session on its one flagged row).
* **Launcher.**  ``--tenants`` on the CPU, ``load_fleet`` against JAX's.

The JAX work is small: H = 8, the classifier NL = 2 and S = 3, the
autoencoder NL = 1 and S = 2, capacity 8, a few ticks on JAX's
``reference`` backend.
"""

import dataclasses
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, classifier as jclf  # noqa: E402
from repro.core import distill as jdistill, mcd as jmcd  # noqa: E402
from repro.launch import stream as jlaunch  # noqa: E402
from repro.serve import FleetEngine as JaxFleet  # noqa: E402
from repro.serve import TenantSpec as JaxSpec  # noqa: E402
from repro.serve import admission as jadm, controller as jctl  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro.serve import sessions as jsessions  # noqa: E402
from repro.serve.sessions import Session as JaxSession  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae, classifier as tclf  # noqa: E402
from repro_torch.core import cells as tcells, mcd as tmcd  # noqa: E402
from repro_torch.core.uncertainty import (classification_summary,  # noqa: E402
                                          regression_summary)
from repro_torch.launch import stream as tlaunch  # noqa: E402
from repro_torch.serve import admission as tadm  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve import sessions as tsessions  # noqa: E402
from repro_torch.serve import (DrainRejected, FleetEngine,  # noqa: E402
                               JsonlSink, ServingConfig, Session,
                               SessionStore, StreamingEngine, TenantSpec,
                               WeightedFairQueue, carry_dtypes,
                               convert_session, load_fleet_meta, summarize)

BACKENDS = ("reference", "cuda_seq", "cuda_step")
CAP = 8
SUMMARY_ATOL = 3e-7
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "snapshots")
#: Integer (and tag) fields of a TickMetrics record both packages fill.
INT_FIELDS = ("tick", "capacity", "n_chunks", "live_rows", "batch_rows",
              "queue_depth", "live_steps", "live_chain_steps",
              "padded_steps", "dropped", "active_chains", "reclaimed_rows",
              "student_rows", "escalations", "tenant")


def _mcd(mod, s, seed):
    return mod.MCDConfig(p=0.125, placement="YN", n_samples=s, seed=seed)


def _clf_cfgs(s=3, seed=3):
    kw = dict(hidden=8, num_layers=2, num_classes=4, cell="lstm")
    return (jclf.ClassifierConfig(mcd=_mcd(jmcd, s, seed), **kw),
            tclf.ClassifierConfig(mcd=_mcd(tmcd, s, seed), **kw))


def _ae_cfgs(s=2, seed=1):
    kw = dict(hidden=8, num_layers=1, cell="gru")
    return (jae.AutoencoderConfig(mcd=_mcd(jmcd, s, seed), **kw),
            tae.AutoencoderConfig(mcd=_mcd(tmcd, s, seed), **kw))


@pytest.fixture(scope="module")
def models():
    """``{"clf" | "ae": (JAX cfg, JAX params, port cfg, port params)}``."""
    out = {}
    for name, (cfgs, init, key) in {"clf": (_clf_cfgs(), jclf.init, 0),
                                    "ae": (_ae_cfgs(), jae.init, 1)}.items():
        jcfg, tcfg = cfgs
        jparams = init(jax.random.key(key), jcfg)
        out[name] = (jcfg, jparams, tcfg, bridge.from_numpy_params(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


def _signals(n, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(T, 1)).astype(np.float32) for _ in range(n)]


def _close(got, want, what, atol=SUMMARY_ATOL):
    for g, w in zip(got, want, strict=True):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, what
        err = float(np.max(np.abs(g - w))) if g.size else 0.0
        assert err <= atol, f"{what}: {err}"


def _equal(a, b, what):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y), what


def _same_carry(sa, sb, what):
    assert np.array_equal(sa.rows, sb.rows), what
    for la, lb in zip(sa.state, sb.state, strict=True):
        _equal(la, lb, what)


# ---------------------------------------------------------------------------
# The queues: pure Python on both sides, exactly equal
# ---------------------------------------------------------------------------

def _queue_script(seed):
    """A random submit / cancel / drain script over three tenants."""
    rng = np.random.default_rng(seed)
    ops, k = [], 0
    for _ in range(40):
        r = rng.random()
        if r < 0.5:
            ops.append(("submit", ["a", "b", "c"][rng.integers(3)], f"s{k}",
                        int(rng.integers(0, 3))))
            k += 1
        elif r < 0.6 and k:
            ops.append(("cancel", f"s{rng.integers(k)}"))
        else:
            ops.append(("drain",
                        None if rng.random() < 0.3
                        else int(rng.integers(0, 4)),
                        tuple(t for t in "abc" if rng.random() < 0.8),
                        f"s{rng.integers(max(k, 1))}"))
    return ops


def _run_queue(mod, ops, aging_rounds, skew):
    q = mod.WeightedFairQueue({"a": 3.0, "b": 1.0, "c": 2.0},
                              max_pending=64, aging_rounds=aging_rounds)
    if skew:
        st = q.state()
        st["admitted"] = {"a": 0, "b": 40, "c": 3}
        q.load_state(st)
    trail = []
    for op in ops:
        if op[0] == "submit":
            _, tenant, sid, prio = op
            q.submit(tenant, sid, priority=prio)
        elif op[0] == "cancel":
            trail.append(("cancel", q.cancel(op[1]), op[1] in q))
        else:
            _, budget, roomy, poison = op

            def admit(t, poison=poison):
                if t.sid == poison:
                    raise ValueError("poison")

            try:
                got = q.drain(admit, lambda n, roomy=roomy: n in roomy,
                              budget)
                rej = []
            except Exception as err:            # DrainRejected of either
                got, rej = err.admitted, [t.sid for t, _ in err.rejected]
            trail.append(("drain", [(t.tenant, t.sid) for t in got], rej))
        trail.append((q.state(), [(t.tenant, t.sid, t.enqueued_round)
                                  for t in q.waiting()],
                      {n: q.depth_of(n) for n in "abc"}, q.depth, len(q),
                      q.shares()))
    return trail


@pytest.mark.parametrize("aging_rounds,skew", [(16, False), (3, True),
                                               (10 ** 6, True)])
@pytest.mark.parametrize("seed", range(4))
def test_weighted_fair_queue_equals_jax(seed, aging_rounds, skew):
    ops = _queue_script(seed)
    assert _run_queue(tadm, ops, aging_rounds, skew) == \
        _run_queue(jadm, ops, aging_rounds, skew)


def test_queue_validation():
    for mod in (jadm, tadm):
        with pytest.raises(ValueError, match="/"):
            mod.WeightedFairQueue({"a/b": 1.0})
        with pytest.raises(ValueError, match="weight"):
            mod.WeightedFairQueue({"a": 0.0})
        with pytest.raises(ValueError, match="at least one"):
            mod.WeightedFairQueue({})
        q = mod.WeightedFairQueue({"a": 1.0}, max_pending=1)
        q.submit("a", "s1")
        with pytest.raises(mod.QueueFull):
            q.submit("a", "s2")
        with pytest.raises(KeyError, match="unknown tenant"):
            q.submit("zzz", "s3")
        with pytest.raises(ValueError, match="already queued"):
            q.submit("a", "s1")


def test_rejects_do_not_consume_budget():
    store = SessionStore(n_samples=2, seed=7, max_sessions=4)
    poison = SessionStore(n_samples=2, seed=999).admit("a/bad")
    q = WeightedFairQueue({"a": 1.0})
    q.submit("a", "a/bad", session=poison)
    q.submit("a", "a/ok")
    with pytest.raises(DrainRejected) as info:
        q.drain(lambda t: (store.attach(t.session) if t.session
                           is not None else store.admit(t.sid)),
                lambda n: True, 1)
    assert [t.sid for t in info.value.admitted] == ["a/ok"]
    assert [t.sid for t, _ in info.value.rejected] == ["a/bad"]


def _run_admission_queue(mod, store_mod):
    q = mod.AdmissionQueue(max_pending=64)
    store = store_mod.SessionStore(2, 0, max_sessions=3)
    trail = []
    for k in range(30):
        q.submit(f"s{k}", priority=k % 3)
    for k in range(0, 30, 2):
        trail.append((q.cancel(f"s{k}"), q.cancel(f"s{k}"), f"s{k}" in q,
                      q.depth, len(q._heap)))
    trail.append([t.sid for t in q])
    trail.append([s.sid for s in q.drain(store)])
    trail.append((q.depth, [t.sid for t in q.waiting()]))
    return trail


def test_admission_queue_cancel_equals_jax():
    assert _run_admission_queue(tadm, tsessions) == \
        _run_admission_queue(jadm, jsessions)


# ---------------------------------------------------------------------------
# Tenant-tagged metrics
# ---------------------------------------------------------------------------

def _records(mod):
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        tenant = [None, "ward", "anom"][i % 3]
        out.append(mod.TickMetrics(
            tick=i, capacity=8, n_chunks=2, live_rows=6, batch_rows=12,
            queue_depth=int(rng.integers(4)), live_steps=10,
            live_chain_steps=30, padded_steps=96, pad_waste=1 - 30 / 96,
            duration_s=float(rng.random()), tokens_per_sec=30.0,
            queue_wait_s=float(rng.random()), dropped=int(rng.integers(2)),
            active_chains=6, tenant=tenant))
    return out


def test_summarize_tenants_equals_jax():
    want = jsched.summarize(_records(jsched))
    got = summarize(_records(tsched))
    assert set(got["tenants"]) == set(want["tenants"]) == {"ward", "anom"}
    for name in ("ward", "anom"):
        g, w = got["tenants"][name], want["tenants"][name]
        assert "tenants" not in g
        for key in w:
            if key != "compiles":
                assert g[key] == w[key], key
    for key in want:
        if key not in ("tenants", "compiles"):
            assert got[key] == want[key], key
    assert "tenants" not in summarize([dataclasses.replace(
        m, tenant=None) for m in _records(tsched)][:1])


def test_jsonl_sink_writes_the_tag(tmp_path):
    path = tmp_path / "t.jsonl"
    sink = JsonlSink(str(path))
    for m in _records(tsched)[:3]:
        sink.emit(m)
    sink.close()
    assert [json.loads(line)["tenant"] for line in
            path.read_text().splitlines()] == [None, "ward", "anom"]


# ---------------------------------------------------------------------------
# The fleet against the JAX fleet
# ---------------------------------------------------------------------------

# (tenant, sid) -> chunk lengths a tick (0: sits out).  The budget of 2
# admissions a tick binds; w0 and a1 close after tick 2; at tick 3 w2
# takes w0's row, and anom's poison re-attach (a0's rows) is dropped while
# anom sits out: its quiet record carries the drop.
PLAN = {("ward", "w0"): (3, 5, 8),
        ("ward", "w1"): (2, 1, 7, 6, 0),
        ("ward", "w2"): (0, 0, 0, 4, 8),
        ("anom", "a0"): (5, 0, 3, 0, 1),
        ("anom", "a1"): (1, 6, 2)}
TICKS = 5


def _two_tenants(models, pkg, backend, **kw):
    """The LSTM classifier ("ward", S 3, weight 3) and the GRU
    autoencoder ("anom", S 2, weight 1), two rows each, capacity 8."""
    jc, jp, tc, tp = models["clf"]
    ja, jap, ta, tap = models["ae"]
    if pkg == "jax":
        return JaxFleet([
            JaxSpec(name="ward", cfg=jc, params=jp, weight=3.0,
                    max_sessions=2, chunk_capacity=CAP, backend=backend),
            JaxSpec(name="anom", cfg=ja, params=jap, weight=1.0,
                    max_sessions=2, chunk_capacity=CAP, backend=backend)],
            **kw)
    return FleetEngine([
        TenantSpec(name="ward", cfg=tc, params=tp, weight=3.0,
                   max_sessions=2, chunk_capacity=CAP, backend=backend),
        TenantSpec(name="anom", cfg=ta, params=tap, weight=1.0,
                   max_sessions=2, chunk_capacity=CAP, backend=backend)],
        device="cpu", **kw)


def _poison(pkg):
    rows = np.asarray([0, 1], np.uint32)
    if pkg == "jax":
        return JaxSession(sid="bad", rows=jax.numpy.asarray(rows), seed=1)
    return Session(sid="bad", rows=rows, seed=1)


def _drive(fleet, pkg):
    """Run PLAN through a fleet (admit_per_tick=2): every tick's results
    and the whole metrics trail."""
    sigs = dict(zip(PLAN, _signals(len(PLAN), seed=2)))
    for prio, (tenant, sid) in enumerate(PLAN):
        fleet.admit(tenant, sid, priority=prio)
    pos = {key: 0 for key in PLAN}
    ticks = []
    for t in range(TICKS):
        if t == 3:
            fleet.admit("anom", "bad", session=_poison(pkg))
        chunks = {}
        for key, lens in PLAN.items():
            tenant, sid = key
            if t < len(lens) and lens[t] and \
                    sid in fleet.active_sessions[tenant]:
                chunks.setdefault(tenant, {})[sid] = \
                    sigs[key][pos[key]:pos[key] + lens[t]]
                pos[key] += lens[t]
        ticks.append(fleet.step(chunks))
        if t == 2:
            fleet.close("ward", "w0")
            fleet.close("anom", "a1")
    return ticks


@pytest.fixture(scope="module")
def jax_run(models):
    fleet = _two_tenants(models, "jax", "reference", admit_per_tick=2)
    return fleet, _drive(fleet, "jax")


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_matches_jax(models, jax_run, backend):
    jfleet, jticks = jax_run
    fleet = _two_tenants(models, "port", backend, admit_per_tick=2)
    ticks = _drive(fleet, "port")
    for t, (got, want) in enumerate(zip(ticks, jticks, strict=True)):
        assert {k: set(v) for k, v in got.items()} == \
            {k: set(v) for k, v in want.items()}, t
        for tenant in want:
            for sid, w in want[tenant].items():
                g = got[tenant][sid]
                assert (g.sid, g.length, g.steps_total) == \
                    (w.sid, w.length, w.steps_total)
                _close(g.summary, w.summary, f"tick {t} {tenant}/{sid}")
    gm, jm = fleet.metrics, jfleet.metrics
    assert len(gm) == len(jm)
    for g, w in zip(gm, jm):
        assert {f: getattr(g, f) for f in INT_FIELDS} == \
            {f: getattr(w, f) for f in INT_FIELDS}
        assert g.pad_waste == w.pad_waste
    assert any(m.dropped for m in gm) and any(m.n_chunks == 0 for m in gm)
    assert [(t.tenant, str(e)) for t, e in fleet.dropped_admissions] == \
        [(t.tenant, str(e)) for t, e in jfleet.dropped_admissions]
    got, want = fleet.summarize()["tenants"], jfleet.summarize()["tenants"]
    assert set(got) == set(want) == {"ward", "anom"}
    for name in want:
        for key in ("ticks", "capacities_used", "live_chain_steps",
                    "padded_steps", "pad_waste", "mean_queue_depth",
                    "dropped", "active_chains_mean", "reclaimed_rows",
                    "student_rows_mean", "escalations"):
            assert got[name][key] == want[name][key], (name, key)
    assert fleet.queue.state() == jfleet.queue.state()
    assert {g.name: g.tenants for g in fleet.groups.values()} == \
        {g.name: g.tenants for g in jfleet.groups.values()}


# ---------------------------------------------------------------------------
# Tenants, groups and per-tenant metrics (port-only, no JAX)
# ---------------------------------------------------------------------------

def test_spec_validation_and_grouping(models):
    _, _, tc, tp = models["clf"]
    with pytest.raises(ValueError, match="/"):
        TenantSpec(name="a/b", cfg=tc, params=tp)
    with pytest.raises(ValueError, match="weight"):
        TenantSpec(name="a", cfg=tc, params=tp, weight=0.0)
    with pytest.raises(TypeError, match="config"):
        TenantSpec(name="a", cfg=object(), params=tp)
    with pytest.raises(ValueError, match="duplicate"):
        FleetEngine([TenantSpec(name="a", cfg=tc, params=tp),
                     TenantSpec(name="a", cfg=tc, params=tp)], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        FleetEngine([], device="cpu")
    fleet = FleetEngine([
        TenantSpec(name="a", cfg=tc, params=tp, max_sessions=2),
        TenantSpec(name="b", cfg=tc, params=tp, n_samples=2,
                   max_sessions=3),
        TenantSpec(name="c", cfg=tc, params=tp, precision="int8")],
        device="cpu", graphs=False)
    assert len(fleet.groups) == 2
    eng = fleet.group_of("a").engine
    assert eng is fleet.group_of("b").engine
    assert eng.n_samples == 3 and eng.max_sessions == 5
    assert eng._graphs is None and eng.device.type == "cpu"
    assert fleet.group_of("c").engine.precision == "int8"
    fleet.admit("a", "p")
    fleet.admit("b", "p")                   # same bare sid, no collision
    assert sorted(eng.active_sessions) == ["a/p", "b/p"]
    assert int(eng.store.get("b/p").rows.shape[0]) == 2
    with pytest.raises(KeyError, match="unknown tenant"):
        fleet.group_of("zzz")


def test_per_tenant_capacity_inside_a_shared_group(models):
    _, _, tc, tp = models["clf"]
    fleet = FleetEngine([
        TenantSpec(name="icu", cfg=tc, params=tp, max_sessions=1),
        TenantSpec(name="er", cfg=tc, params=tp, max_sessions=2)],
        device="cpu")
    assert fleet.admit("icu", "p1") is not None
    assert fleet.admit("icu", "p2") is None
    assert fleet.queue.depth_of("icu") == 1
    assert fleet.admit("er", "p1") is not None
    assert fleet.close("icu", "p1").sid == "p1"       # bare sid back
    assert fleet.active_sessions["icu"] == ["p2"]


def test_quiet_record_and_drops_in_the_trail(models, tmp_path):
    _, _, tc, tp = models["clf"]
    path = tmp_path / "fleet.jsonl"
    fleet = FleetEngine(
        [TenantSpec(name="icu", cfg=tc, params=tp, max_sessions=2),
         TenantSpec(name="er", cfg=tc, params=tp, max_sessions=2)],
        admit_per_tick=1, metrics_sink=JsonlSink(str(path)), device="cpu")
    fleet.admit("icu", "p1")
    fleet.admit("er", "p1")
    fleet.step({})                 # budget 1: one tenant stays queued
    (starved,) = [t for t in ("icu", "er") if fleet.queue.depth_of(t)]
    (quiet,) = [m for m in fleet.metrics if m.tenant == starved]
    assert quiet.n_chunks == 0 and quiet.queue_depth == 1
    fleet.step({})
    clash = SessionStore(n_samples=3, seed=3).admit("icu/bad")
    fleet.admit("icu", "bad", session=clash)
    fleet.step({"icu": {"p1": np.ones((2, 1), np.float32)}})
    assert [m for m in fleet.metrics if m.tenant == "icu"][-1].dropped == 1
    (ticket, err), = fleet.dropped_admissions
    assert ticket.tenant == "icu" and "collide" in str(err)
    fleet.metrics_sink.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert any(r["tenant"] == "icu" and r["dropped"] == 1 for r in recs)


# ---------------------------------------------------------------------------
# The data plane of a reconfiguration
# ---------------------------------------------------------------------------

_JDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("backend", ["reference", "cuda_seq"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_carry_dtypes_equal_jax(cell, backend):
    jb = {"cuda_seq": "pallas_seq"}.get(backend, backend)
    for prec in (None, "fp32", "bf16", "int8", "int4"):
        for chunk in ("float32", "bfloat16"):
            want = jctl.carry_dtypes(cell, prec, jb,
                                     getattr(jax.numpy, chunk))
            got = carry_dtypes(cell, prec, backend, _JDT[chunk])
            assert got == tuple(_JDT[np.dtype(d).name] for d in want)


@pytest.mark.parametrize("n,prec", [(2, None), (3, "bf16"), (5, "int8"),
                                    (1, "bf16")])
def test_convert_session_equals_jax(n, prec):
    rng = np.random.default_rng(n)
    carry = [(rng.normal(size=(3, 8)).astype(np.float32),
              rng.normal(size=(3, 8)).astype(np.float32)) for _ in range(2)]
    rows = np.asarray([4, 5, 6], np.uint32)
    extra = np.arange(9, 9 + max(0, n - 3), dtype=np.uint32)
    dts = carry_dtypes("lstm", prec, "cuda_seq")
    tsess = Session(sid="x", rows=rows.copy(), seed=3, steps=7, chunks=2,
                    state=[tuple(torch.from_numpy(p) for p in layer)
                           for layer in carry])
    jsess = JaxSession(sid="x", rows=jax.numpy.asarray(rows), seed=3,
                       steps=7, chunks=2,
                       state=[tuple(jax.numpy.asarray(p) for p in layer)
                              for layer in carry])
    got = convert_session(tsess, n_samples=n, part_dtypes=dts,
                          extra_rows=extra if n > 3 else None)
    want = jctl.convert_session(
        jsess, n_samples=n, extra_rows=extra if n > 3 else None,
        part_dtypes=jctl.carry_dtypes("lstm", prec, "pallas_seq"))
    assert got.rows.dtype == np.uint32
    assert np.array_equal(got.rows, np.asarray(want.rows))
    assert (got.sid, got.steps, got.chunks, got.mode) == \
        (want.sid, want.steps, want.chunks, want.mode)
    for lg, lw in zip(got.state, want.state, strict=True):
        for g, w in zip(lg, lw, strict=True):
            assert g.device.type == "cpu" and g.shape == w.shape
            assert np.array_equal(g.float().numpy(),
                                  np.asarray(w, np.float32))
            assert str(g.dtype).endswith(np.dtype(w.dtype).name)
    with pytest.raises(ValueError, match="extra_rows"):
        convert_session(tsess, n_samples=5, part_dtypes=dts)


# ---------------------------------------------------------------------------
# Port invariants: bit for bit inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [3, 10, 30])
def test_a_summary_does_not_follow_the_batch_width(s, dtype):
    """A session's chain-axis summary is the same whatever the number of
    sessions summarized beside it (PyTorch's CPU `mean` over a leading
    axis sums in an order that follows the other axes' sizes: before
    this slice a session alone and beside 1-6 others differed)."""
    g = torch.Generator().manual_seed(s)
    logits = torch.randn((40, s, 4), generator=g).to(dtype)
    mean = torch.randn((40, s, 8, 1), generator=g).to(dtype)
    alone_c = classification_summary(logits[:1].transpose(0, 1))
    alone_r = regression_summary(mean[:1].transpose(0, 1),
                                 mean[:1].transpose(0, 1))
    for width in (2, 3, 5, 7, 8, 33, 40):
        wide_c = classification_summary(logits[:width].transpose(0, 1))
        wide_r = regression_summary(mean[:width].transpose(0, 1),
                                    mean[:width].transpose(0, 1))
        _equal([v[0] for v in wide_c], [v[0] for v in alone_c], width)
        _equal([v[0] for v in wide_r], [v[0] for v in alone_r], width)


@pytest.mark.parametrize("batch,lo,hi", [(9, 3, 6), (7, 1, 2), (33, 0, 30),
                                         (40, 30, 40), (90, 30, 60)])
@pytest.mark.parametrize("cell,hidden,in_dim", [("lstm", 8, 1),
                                                ("lstm", 8, 8),
                                                ("gru", 8, 1),
                                                ("gru", 16, 16)])
def test_reference_step_does_not_follow_the_batch(cell, hidden, in_dim,
                                                  batch, lo, hi):
    """A row of the ``reference`` backend's step is the same whatever the
    rows around it (ROADMAP C: before this slice its gate sums were a
    batched matmul, whose CPU path switches at 400 multiply-adds a matrix
    between a loop and BLAS, and the GRU's sigmoid and tanh ran a flat
    tensor whose scalar tail follows the batch size)."""
    g = torch.Generator().manual_seed(batch + hidden)
    n_gates = 4 if cell == "lstm" else 3
    init = tcells.init_lstm if cell == "lstm" else tcells.init_gru
    params = init(g, in_dim, hidden)
    h, c = (torch.randn((batch, hidden), generator=g) for _ in range(2))
    x = torch.randn((batch, in_dim), generator=g)
    zx = (torch.rand((batch, n_gates, in_dim), generator=g) > 0.125).float()
    zh = (torch.rand((batch, n_gates, hidden), generator=g) > 0.125).float()
    det = torch.arange(batch) % 5 == 0

    def step(*a):
        if cell == "lstm":
            return tcells.lstm_step(params, *a[:2], *a[2:5], 0.125,
                                    det=a[5])
        return tcells.gru_step(params, a[0], *a[2:5], 0.125, det=a[5])

    ins = (h, c, x, zx, zh, det)
    wide = step(*ins)
    alone = step(*(v[lo:hi].clone() for v in ins))
    wide, alone = ((wide,), (alone,)) if cell == "gru" else (wide, alone)
    _equal([v[lo:hi] for v in wide], alone, f"{cell} {batch} {lo}:{hi}")


def _solo_for(fleet, tenant, spec, backend):
    """An engine of its own holding ``tenant``'s sessions on their rows."""
    eng = StreamingEngine(spec.params, spec.resolved_cfg(), backend=backend,
                          max_sessions=spec.max_sessions,
                          chunk_capacity=spec.chunk_capacity,
                          precision=spec.precision, device="cpu")
    for sess in fleet.sessions_of(tenant):
        eng.attach_session(Session(sid=sess.sid, rows=sess.rows.copy(),
                                   seed=sess.seed))
    return eng


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_equals_solo(models, backend):
    """Four tenants in three groups: ``ward`` and ``ward2`` share a group
    at the same S, ``lite`` sits below its group's ceiling, ``anom`` is
    another model, ``q8`` is ``ward`` at int8.  Every tenant's summaries
    and carries equal an engine of its own on the same rows, bit for bit,
    over ragged ticks in which tenants sit out."""
    _, _, tc, tp = models["clf"]
    _, _, ta, tap = models["ae"]
    kw = dict(chunk_capacity=CAP, backend=backend)
    specs = [TenantSpec(name="ward", cfg=tc, params=tp, max_sessions=2,
                        **kw),
             TenantSpec(name="ward2", cfg=tc, params=tp, max_sessions=1,
                        **kw),
             TenantSpec(name="lite", cfg=tc, params=tp, n_samples=2,
                        max_sessions=2, **kw),
             TenantSpec(name="anom", cfg=ta, params=tap, max_sessions=2,
                        **kw),
             TenantSpec(name="q8", cfg=tc, params=tp, precision="int8",
                        max_sessions=1, **kw)]
    fleet = FleetEngine(specs, device="cpu")
    assert len(fleet.groups) == 3
    sids = {"ward": ["p", "q"], "ward2": ["p"], "lite": ["p", "r"],
            "anom": ["p", "q"], "q8": ["p"]}
    for tenant, ss in sids.items():
        for sid in ss:
            fleet.admit(tenant, sid)
    solo = {s.name: _solo_for(fleet, s.name, s, backend) for s in specs}
    sigs = _signals(9, seed=5)
    rng = np.random.default_rng(6)
    pos = {}
    for t in range(4):
        chunks = {}
        for k, (tenant, sid) in enumerate(
                (t_, s_) for t_, ss in sids.items() for s_ in ss):
            if (t + k) % 4 == 3:
                continue                       # sits out this tick
            n = int(rng.integers(1, 5))
            at = pos.get((tenant, sid), 0)
            chunks.setdefault(tenant, {})[sid] = sigs[k][at:at + n]
            pos[(tenant, sid)] = at + n
        got = fleet.step(chunks)
        for tenant, tchunks in chunks.items():
            want = solo[tenant].step({f"{tenant}/{s}": c
                                      for s, c in tchunks.items()})
            for sid in tchunks:
                _equal(got[tenant][sid].summary,
                       want[f"{tenant}/{sid}"].summary,
                       f"tick {t} {tenant}/{sid}")
    for tenant, eng in solo.items():
        for sess in fleet.sessions_of(tenant):
            _same_carry(sess, eng.store.get(sess.sid), sess.sid)


def _kill_fleet(models, backend):
    _, _, tc, tp = models["clf"]
    _, _, ta, tap = models["ae"]
    kw = dict(chunk_capacity=CAP, backend=backend, max_sessions=2)
    return FleetEngine([TenantSpec(name="ward", cfg=tc, params=tp, **kw),
                        TenantSpec(name="lite", cfg=tc, params=tp,
                                   n_samples=2, **kw),
                        TenantSpec(name="anom", cfg=ta, params=tap, **kw)],
                       device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_kill_restore_bitwise(models, backend, tmp_path):
    """Snapshot mid-stream with a queued fresh ticket and a queued
    re-attach; a fresh fleet restores it and serves the rest bit-equal to
    the uninterrupted fleet."""
    sigs = dict(zip(["w0", "w1", "l0", "a0", "a1", "n0", "n1"],
                    _signals(7, T=24, seed=8)))
    owner = {"w0": "ward", "w1": "ward", "l0": "lite", "a0": "anom",
             "a1": "anom"}
    lens = [3, 2, 4, 1, 5, 3]

    def chunks(fleet, t):
        out = {}
        for sid, tenant in owner.items():
            if sid in fleet.active_sessions[tenant]:
                sess = fleet.group_of(tenant).engine.store.get(
                    f"{tenant}/{sid}")
                out.setdefault(tenant, {})[sid] = \
                    sigs[sid][sess.steps:sess.steps + lens[t]]
        return out

    def setup(fleet):
        for sid, tenant in owner.items():
            fleet.admit(tenant, sid)

    run = _kill_fleet(models, backend)
    setup(run)
    ticks = []
    for t in range(len(lens)):
        if t == 2:
            gone = run.close("anom", "a1")
            run.admit("anom", "n0")             # fresh: takes a1's row
            run.admit("anom", "n1")             # waits
            run.admit("anom", "a1", session=gone)  # waits too
            run.snapshot(str(tmp_path))
            ledger = run.queue.state()
            queued = [(q.tenant, q.sid) for q in run.queue.waiting()]
            assert queued == [("anom", "anom/n1"), ("anom", "anom/a1")]
            owner.update(n0="anom", n1="anom")
        if t == 4:
            run.close("anom", "n0")             # n1 goes live
            run.close("ward", "w1")
        ticks.append(run.step(chunks(run, t)))

    back = _kill_fleet(models, backend)
    back.restore(str(tmp_path))
    assert [(q.tenant, q.sid) for q in back.queue.waiting()] == queued
    assert back.queue.state()["admitted"] == ledger["admitted"]
    assert back.tick == 2
    for t in range(2, len(lens)):
        if t == 4:
            back.close("anom", "n0")
            back.close("ward", "w1")
        got = back.step(chunks(back, t))
        for tenant in ticks[t]:
            for sid, r in ticks[t][tenant].items():
                _equal(got[tenant][sid].summary, r.summary,
                       f"restored tick {t} {tenant}/{sid}")
    for tenant in ("ward", "lite", "anom"):
        assert back.active_sessions[tenant] == run.active_sessions[tenant]
        for sess in run.sessions_of(tenant):
            _same_carry(back.group_of(tenant).engine.store.get(sess.sid),
                        sess, sess.sid)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reconfigure_keeps_chains_bitwise(models, backend):
    """``reconfigure_tenant("ward", S 2)`` mid-stream: ``lite`` (its
    former group-mate) and ``anom`` bit-unmoved against the fleet that was
    not reconfigured, ``ward``'s two kept chains' carries its first two
    rows there, bit for bit (the new engine launches another shape); the
    first tick after the swap
    captures the new engine's graph on a kernel backend (the CPU runs it
    without capture)."""
    sigs = _signals(4, seed=9)
    owner = [("ward", "w0"), ("ward", "w1"), ("lite", "l0"),
             ("anom", "a0")]
    fleets = [_kill_fleet(models, backend) for _ in range(2)]
    for fleet in fleets:
        for tenant, sid in owner:
            fleet.admit(tenant, sid)
    lens, res = [3, 2, 5, 1], ([], [])
    for t, n in enumerate(lens):
        if t == 2:
            eng = fleets[1].reconfigure_tenant("ward",
                                               ServingConfig(n_samples=2))
            assert eng.n_samples == 2 and len(fleets[1].groups) == 3
        for i, fleet in enumerate(fleets):
            ch = {}
            for k, (tenant, sid) in enumerate(owner):
                at = sum(lens[:t])
                ch.setdefault(tenant, {})[sid] = sigs[k][at:at + n]
            res[i].append(fleet.step(ch))
    new = fleets[1].group_of("ward").engine
    assert [m.compiles for m in new.metrics] == \
        [int(backend != "reference"), 0]
    for t in (2, 3):
        for tenant in ("lite", "anom"):
            for sid, r in res[0][t][tenant].items():
                _equal(res[1][t][tenant][sid].summary, r.summary,
                       f"tick {t} {tenant}")
    for tenant in ("lite", "anom"):
        for sess in fleets[0].sessions_of(tenant):
            _same_carry(fleets[1].group_of(tenant).engine.store.get(
                sess.sid), sess, sess.sid)
    for sess in fleets[0].sessions_of("ward"):
        kept = new.store.get(sess.sid)
        assert np.array_equal(kept.rows, sess.rows[:2])
        for lk, lf in zip(kept.state, sess.state, strict=True):
            _equal(lk, [p[:2] for p in lf], sess.sid)


# ---------------------------------------------------------------------------
# Snapshots across packages, the goldens, reconfiguration against JAX
# ---------------------------------------------------------------------------

def _serve_both(jfleet, tfleet, chunks, what, atol=SUMMARY_ATOL):
    want, got = jfleet.step(chunks), tfleet.step(chunks)
    for tenant in want:
        for sid, w in want[tenant].items():
            _close(got[tenant][sid].summary, w.summary, f"{what} {sid}",
                   atol)
    return got


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_snapshot_crosses_packages(models, writer, tmp_path):
    sigs = _signals(4, seed=11)
    first = {"ward": {"p": sigs[0][:3], "q": sigs[1][:5]},
             "anom": {"p": sigs[2][:4]}}
    then = {"ward": {"p": sigs[0][3:9], "q": sigs[1][5:6]},
            "anom": {"p": sigs[2][4:8]}}
    fleets = {pkg: _two_tenants(models, pkg, "reference")
              for pkg in ("jax", "port")}
    src = fleets[writer]
    for sid, tenant in (("p", "ward"), ("q", "ward"), ("p", "anom"),
                        ("x", "ward")):
        src.admit(tenant, sid)
    src.step(first)
    src.snapshot(str(tmp_path))
    meta = load_fleet_meta(str(tmp_path))
    assert meta["fleet_format"] == 1 and set(meta["tenants"]) == \
        {"ward", "anom"}
    reader = "port" if writer == "jax" else "jax"
    fresh = _two_tenants(models, reader, "reference")
    fresh.restore(str(tmp_path))
    assert fresh.active_sessions == src.active_sessions
    assert [(t.tenant, t.sid) for t in fresh.queue.waiting()] == \
        [(t.tenant, t.sid) for t in src.queue.waiting()] == \
        [("ward", "ward/x")]
    assert fresh.queue.state()["admitted"] == src.queue.state()["admitted"]
    assert fresh.tick == src.tick == 1
    jfleet, tfleet = ((src, fresh) if writer == "jax" else (fresh, src))
    _serve_both(jfleet, tfleet, then, "continued")


def _fixture_fleets(models, names, backend, jbackend="reference"):
    """JAX and port fleets on the fixtures' geometry (H 8, NL 2, S 2,
    seed 3; one params object)."""
    jcfg, tcfg = _clf_cfgs(s=2)
    jparams = jclf.init(jax.random.key(0), jcfg)
    tparams = bridge.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return (JaxFleet([JaxSpec(name=n, cfg=jcfg, params=jparams,
                              max_sessions=4, backend=jbackend,
                              chunk_capacity=CAP) for n in names]),
            FleetEngine([TenantSpec(name=n, cfg=tcfg, params=tparams,
                                    max_sessions=4, backend=backend,
                                    chunk_capacity=CAP) for n in names],
                        device="cpu"))


@pytest.mark.parametrize("backend", ["reference", "cuda_seq"])
def test_fleet_v1_restores_and_serves(models, backend):
    """The port of ``TestFleetFixtures.test_fleet_v1_restores_and_serves``,
    the tick against the JAX fleet restored from the same files."""
    jfleet, fleet = _fixture_fleets(models, ("ward", "anom"), backend)
    path = os.path.join(FIXTURES, "fleet_v1")
    meta = fleet.restore(path)
    jfleet.restore(path)
    assert meta["fleet_format"] == 1 and fleet.tick == 3
    assert fleet.active_sessions == {"ward": ["p1"], "anom": ["p1"]}
    sess = fleet.group_of("ward").engine.store.get("ward/p1")
    assert (sess.steps, sess.chunks) == (7, 2)
    assert np.array_equal(sess.rows, [0, 1])
    assert fleet.queue.state()["admitted"] == {"ward": 3, "anom": 1}
    assert [(t.tenant, t.sid) for t in fleet.queue.waiting()] == \
        [("ward", "ward/p2")]
    out = _serve_both(jfleet, fleet,
                      {"ward": {"p1": np.ones((3, 1), np.float32)}},
                      "fleet_v1")
    assert out["ward"]["p1"].steps_total == 10


def test_single_engine_snapshot_adopts_into_one_tenant_fleet(models):
    jfleet, fleet = _fixture_fleets(models, ("icu",), "cuda_seq",
                                    "pallas_seq")
    path = os.path.join(FIXTURES, "pr3_lstm")
    fleet.restore(path)
    jfleet.restore(path)
    assert sorted(fleet.active_sessions["icu"]) == ["ward_1", "ward_2"]
    assert fleet.tick == 2
    assert [(t.tenant, t.sid) for t in fleet.queue.waiting()] == \
        [(t.tenant, t.sid) for t in jfleet.queue.waiting()]
    out = _serve_both(jfleet, fleet,
                      {"icu": {"ward_1": np.ones((3, 1), np.float32)}},
                      "pr3_lstm", atol=1e-5)
    assert out["icu"]["ward_1"].steps_total == 10
    _, two = _fixture_fleets(models, ("ward", "anom"), "cuda_seq")
    with pytest.raises(ValueError, match="one-tenant"):
        two.restore(path)


def test_restore_refusals(models, tmp_path):
    fleet = _two_tenants(models, "port", "reference")
    fleet.admit("ward", "p1")
    fleet.snapshot(str(tmp_path))
    with pytest.raises(RuntimeError, match="fresh"):
        fleet.restore(str(tmp_path))
    _, _, tc, tp = models["clf"]
    other = FleetEngine([TenantSpec(name="ward", cfg=tc, params=tp)],
                        device="cpu")
    with pytest.raises(ValueError, match="tenants"):
        other.restore(str(tmp_path))
    with pytest.raises(IOError, match="not a session"):
        StreamingEngine(tp, tc, device="cpu").restore(str(tmp_path))


@pytest.mark.parametrize("new", [ServingConfig(n_samples=2),
                                 ServingConfig(n_samples=5,
                                               precision="bf16",
                                               chunk_capacity=4)])
def test_reconfigure_matches_jax(models, new):
    """The reference's reconfiguration case on both packages: groups,
    ceilings, rows and both stores' cursors equal, and the next tick's
    summaries within SUMMARY_ATOL (the bf16 upshift within a bf16 ulp)."""
    jc, jp, tc, tp = models["clf"]
    kw = dict(max_sessions=2, chunk_capacity=CAP)
    fleets = {
        "jax": JaxFleet([JaxSpec(name="icu", cfg=jc, params=jp,
                                 backend="pallas_seq", **kw),
                         JaxSpec(name="er", cfg=jc, params=jp,
                                 backend="pallas_seq", **kw)]),
        "port": FleetEngine([TenantSpec(name="icu", cfg=tc, params=tp, **kw),
                             TenantSpec(name="er", cfg=tc, params=tp, **kw)],
                            device="cpu")}
    sig = _signals(1, seed=7)[0]
    for fleet in fleets.values():
        fleet.admit("icu", "s")
        fleet.admit("er", "s")
        fleet.admit("er", "t")
        fleet.step({"icu": {"s": sig[:3]}, "er": {"s": sig[:3],
                                                  "t": sig[:2]}})
    jnew = jctl.ServingConfig(n_samples=new.n_samples,
                              precision=new.precision,
                              chunk_capacity=new.chunk_capacity)
    engines = {"jax": fleets["jax"].reconfigure_tenant("icu", jnew),
               "port": fleets["port"].reconfigure_tenant("icu", new)}
    state = {}
    for pkg, fleet in fleets.items():
        eng = engines[pkg]
        state[pkg] = (
            {g.name: g.tenants for g in fleet.groups.values()},
            eng.n_samples, eng.precision, eng.chunk_capacity, eng.tick,
            eng.store.next_row, fleet.group_of("er").engine.store.next_row,
            [(s.sid, np.asarray(s.rows).tolist(), s.steps)
             for g in fleet.groups.values()
             for s in g.engine.store.sessions()])
    assert state["port"] == state["jax"]
    atol = SUMMARY_ATOL if new.precision is None else 2 ** -7
    _serve_both(fleets["jax"], fleets["port"],
                {"icu": {"s": sig[3:7]}, "er": {"s": sig[3:5]}},
                "after the swap", atol=atol)


def test_reconfigure_student_tenant_matches_jax(models):
    """What both packages do to a tenant with student heads: the new
    engine takes none, and a student session comes back an MC session on
    its one flagged row, served so in both."""
    jc, jp, tc, tp = models["clf"]
    jheads = jdistill.init_student(jax.random.key(5), jc, jp)
    theads = bridge.from_numpy_student(jax.tree.map(np.asarray, jheads),
                                       device="cpu")
    kw = dict(max_sessions=2, chunk_capacity=CAP)
    jfleet = JaxFleet([JaxSpec(name="icu", cfg=jc, params=jp,
                               backend="pallas_seq", student=jheads, **kw)])
    fleet = FleetEngine([TenantSpec(name="icu", cfg=tc, params=tp,
                                    student=theads, **kw)], device="cpu")
    sig = _signals(1, seed=12)[0]
    for f in (jfleet, fleet):
        f.admit("icu", "mc")
        f.admit("icu", "st", mode="student")
    _serve_both(jfleet, fleet, {"icu": {"mc": sig[:3], "st": sig[:4]}},
                "students")
    jeng = jfleet.reconfigure_tenant("icu", jctl.ServingConfig(n_samples=2))
    eng = fleet.reconfigure_tenant("icu", ServingConfig(n_samples=2))
    assert eng.student is None and jeng.student is None
    for sid in ("icu/mc", "icu/st"):
        s, js = eng.store.get(sid), jeng.store.get(sid)
        assert (s.mode, s.rows.tolist()) == (js.mode,
                                             np.asarray(js.rows).tolist())
    assert eng.store.get("icu/st").mode == "mc"
    assert len(eng.store.get("icu/st").rows) == 1
    _serve_both(jfleet, fleet, {"icu": {"mc": sig[3:5], "st": sig[4:6]}},
                "after the swap")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

FLEET_JSON = {
    "admit_per_tick": 2,
    "tenants": [
        {"name": "ward", "task": "classifier", "hidden": 8, "layers": 2,
         "classes": 4, "samples": 3, "weight": 3, "max_sessions": 2,
         "streams": 3, "beats": 1, "seed": 0, "backend": "pallas_seq"},
        {"name": "lite", "task": "classifier", "hidden": 8, "layers": 2,
         "classes": 4, "samples": 3, "weight": 1, "max_sessions": 1,
         "streams": 1, "beats": 1, "seed": 0, "backend": "pallas_seq"},
        {"name": "anom", "task": "autoencoder", "cell": "gru", "hidden": 8,
         "layers": 1, "samples": 2, "weight": 2, "max_sessions": 1,
         "streams": 2, "beats": 1, "seed": 1, "backend": "pallas_step",
         "precision": "int4"}]}


def test_load_fleet_equals_jax(tmp_path):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(FLEET_JSON))
    specs, plans, kw = tlaunch.load_fleet(str(path), 0, device="cpu")
    jspecs, jplans, jkw = jlaunch.load_fleet(str(path), 0)
    assert plans == jplans and kw == jkw == {"admit_per_tick": 2}
    for s, j in zip(specs, jspecs, strict=True):
        assert (s.name, s.weight, s.precision, s.max_sessions,
                s.early_exit_threshold, s.min_samples) == \
            (j.name, j.weight, j.precision, j.max_sessions,
             j.early_exit_threshold, j.min_samples)
        assert s.backend == {"pallas_seq": "cuda_seq",
                             "pallas_step": "cuda_step"}[j.backend]
        assert dataclasses.asdict(s.cfg) == dataclasses.asdict(j.cfg)
    assert specs[0].params is specs[1].params        # folds into one group
    assert specs[0].params is not specs[2].params


def test_cli_tenants_on_cpu(tmp_path):
    """``--tenants`` serves every stream to its end, tagging each record;
    ``--resume`` from a snapshot taken mid-run serves exactly the steps
    left."""
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(FLEET_JSON))
    out, again = tmp_path / "fleet.jsonl", tmp_path / "again.jsonl"
    snaps = tmp_path / "snaps"
    base = ["--device", "cpu", "--tenants", str(path), "--chunk-len", "70",
            "--snapshot-dir", str(snaps)]
    agg = tlaunch.main(base + ["--metrics-out", str(out),
                               "--snapshot-every", "2",
                               "--snapshot-keep", "100"])
    assert set(agg["tenants"]) == {"ward", "lite", "anom"}
    assert agg["launches"] == 0 and agg["dropped"] == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert {r["tenant"] for r in recs} == {"ward", "lite", "anom"}
    assert sum(r["live_steps"] for r in recs) == 6 * 140
    steps = sorted(os.listdir(snaps))
    for d in steps[1:]:                      # keep the first snapshot only
        shutil.rmtree(snaps / d)
    tick = load_fleet_meta(str(snaps))["tick"]
    tlaunch.main(base + ["--resume", "--metrics-out", str(again)])
    left = [json.loads(line) for line in again.read_text().splitlines()]
    assert sum(r["live_steps"] for r in left) == \
        6 * 140 - sum(r["live_steps"] for r in recs if r["tick"] < tick)
