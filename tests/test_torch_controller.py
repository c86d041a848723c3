"""The co-design controller in the port (``repro_torch.serve.controller``,
``core/bayesian.py``, ``--controller``) held against the JAX package on the
CPU.

* **Decisions.**  With the port's roofline priced at the reference's peaks,
  a detached ``CoDesignController`` gives JAX's ``DecisionRecord``\\ s field
  for field on the cases of ``tests/test_controller.py::TestDecisionLogic``
  (breach, compile stall, contaminated window, cooldown, window reset,
  hysteresis upshift, uncertainty floor) and on a throughput breach, a
  queue breach and an early-exit window; the knob grid in JAX's order.
* **Attached, end to end** (the ``TestEndToEnd`` scenario: an injected
  burst through ``SimulatedLoadSink``): the decisions (tick, reason, winner)
  equal JAX's on each port backend, the post-swap summaries within
  SUMMARY_ATOL of JAX's ``reference`` backend, and bit-equal inside the
  port to a prewarmed engine at the winner's config fed ``convert_session``
  of ``last_swap["old_sessions"]``; no tick after the swap captures.
* **The swap's data plane**: S downshift, upshift, a precision swap,
  queued tickets in order, row disjointness, a student session, the
  ``graphs`` setting, a failing prewarm raising, ``shards`` (a data mesh
  made and dropped).
* **Fleet.**  ``FleetController`` downshifts only the breaching tenant
  (the port of ``tests/test_fleet.py::
  test_fleet_controller_downshifts_breaching_tenant_only``), with JAX's
  record; live on the CPU, the untouched tenant stays bit-equal to an
  engine of its own.
* **predict.**  ``fold`` and ``scan`` within SUMMARY_ATOL of JAX's and
  bit-equal to each other, on all three port backends.
* **Launcher.**  ``--controller --device cpu`` serves, swaps and writes a
  decision trail.

The JAX work is small and compiled once, in one module fixture: the burst
scenario (H = 8, NL = 2, S = 4, two sessions, capacity 8, JAX's
``reference`` backend) and ``predict`` on the classifier and autoencoder.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, bayesian as jbayes  # noqa: E402
from repro.core import classifier as jclf, mcd as jmcd  # noqa: E402
from repro.dse import fpga_model as jfm  # noqa: E402
from repro.serve import FleetEngine as JaxFleet  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro.serve import TenantSpec as JaxSpec  # noqa: E402
from repro.serve import controller as jctl, scheduler as jsched  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae, bayesian  # noqa: E402
from repro_torch.core import classifier as tclf, mcd as tmcd  # noqa: E402
from repro_torch.dse import fpga_model as tfm, gpu_model  # noqa: E402
from repro_torch.launch import stream as tlaunch  # noqa: E402
from repro_torch.serve import controller as tctl  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve import (FleetEngine, JsonlSink,  # noqa: E402
                               StreamingEngine, TenantSpec, prewarm)

BACKENDS = ("reference", "cuda_seq", "cuda_step")
SUMMARY_ATOL = 1e-6
REF_PEAKS = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9}
SLOTS = 4


@pytest.fixture(autouse=True)
def ref_peaks(monkeypatch):
    """Every decision here is priced at the reference's roofline peaks."""
    for name, value in REF_PEAKS.items():
        monkeypatch.setattr(gpu_model, name, value)


def _arch(fm):
    return fm.RNNArch(hidden=8, num_layers=2, placement="YN",
                      kind="classifier", cell="lstm", weight_bits=32,
                      input_dim=1, output_dim=4, timesteps=64)


def _tick(sched, i, dur, *, s=8, cap=64, compiles=0, n_chunks=4,
          queue_depth=0, queue_wait=0.0, slots=SLOTS, live_s=None):
    """The reference test's synthetic tick (``live_s``: chains a served
    session still has, below ``s`` under early exit)."""
    rows = slots * s
    live_rows = n_chunks * (s if live_s is None else live_s)
    live = live_rows * cap
    return sched.TickMetrics(
        tick=i, capacity=cap, n_chunks=n_chunks, live_rows=live_rows,
        batch_rows=rows, queue_depth=queue_depth,
        live_steps=n_chunks * cap, live_chain_steps=live,
        padded_steps=rows * cap, pad_waste=1.0 - live / (rows * cap),
        duration_s=dur, tokens_per_sec=live / dur, queue_wait_s=queue_wait,
        compiles=compiles)


def _controller(ctl, fm, slo=None, *, s=8, knobs=None, **kw):
    cfg = ctl.ServingConfig(n_samples=s, precision=None, chunk_capacity=64)
    kw.setdefault("window", 8)
    kw.setdefault("min_ticks", 4)
    return ctl.CoDesignController(
        None, slo or ctl.SLOPolicy(p95_tick_s=4e-3), config=cfg,
        arch=_arch(fm), slots=SLOTS, knobs=knobs, **kw)


def _rec(rec):
    return None if rec is None else dataclasses.asdict(rec)


def _case(name, ctl, sched, fm):
    """What one TestDecisionLogic case returns, in either package."""
    t = lambda *a, **k: _tick(sched, *a, **k)  # noqa: E731
    if name == "noop":
        return [_rec(_controller(ctl, fm).plan([t(i, 1e-3)
                                                for i in range(8)]))]
    if name == "too-little":
        return [_rec(_controller(ctl, fm).plan([t(i, 99.0)
                                                for i in range(3)]))]
    if name == "breach":
        return [_rec(_controller(ctl, fm).plan([t(i, 10e-3)
                                                for i in range(8)]))]
    if name == "floor":
        c = _controller(ctl, fm, ctl.SLOPolicy(p95_tick_s=4e-3,
                                               min_samples=4))
        return [_rec(c.plan([t(i, 10e-3) for i in range(8)]))]
    if name == "compile-stall":
        c = _controller(ctl, fm, min_ticks=3)
        return [_rec(c.plan([t(i, 10e-3, compiles=2) for i in range(3)]
                            + [t(3 + i, 1e-3) for i in range(3)]))]
    if name == "contaminated":
        return [_rec(_controller(ctl, fm).plan(
            [t(i, 10e-3, compiles=1) for i in range(5)]
            + [t(5 + i, 1e-3) for i in range(3)]))]
    if name == "cooldown":
        c = _controller(ctl, fm, cooldown_ticks=8)
        win = [t(i, 10e-3) for i in range(8)]
        rec = c.plan(win)
        c.mark_applied(rec)
        more = win + [t(8 + i, 10e-3, s=2) for i in range(5)]
        return [_rec(rec), dataclasses.asdict(c.config), _rec(c.plan(more))]
    if name == "window-reset":
        c = _controller(ctl, fm, cooldown_ticks=2)
        c.mark_applied(c.plan([t(i, 10e-3) for i in range(8)]))
        got = c.window_metrics([t(i, 10e-3) for i in range(8)]
                               + [t(8 + i, 1e-3, s=2) for i in range(4)])
        return [[m.tick for m in got], _rec(c.plan(
            [t(8 + i, 1e-3, s=2) for i in range(12)]))]
    if name == "upshift":
        knobs = ctl.KnobSpace(samples=(8, 4, 2, 1), capacities=(64,))
        c = _controller(ctl, fm, s=2, knobs=knobs)
        warm = [t(i, 2.5e-3, s=2) for i in range(8)]
        cool = [t(i, 0.3e-3, s=2) for i in range(8)]
        return [_rec(c.plan(warm)), _rec(c.plan(cool[:6])),
                _rec(c.plan(cool))]
    if name == "tps-breach":
        c = _controller(ctl, fm, ctl.SLOPolicy(
            p95_tick_s=50e-3, min_tokens_per_sec=5e6))
        return [_rec(c.plan([t(i, 2e-3) for i in range(8)]))]
    if name == "queue-breach":
        c = _controller(ctl, fm, ctl.SLOPolicy(p95_tick_s=50e-3,
                                               max_queue_depth=2))
        return [_rec(c.plan([t(i, 2e-3, queue_depth=5, queue_wait=0.1)
                             for i in range(8)]))]
    if name == "early-exit":
        return [_rec(_controller(ctl, fm).plan(
            [t(i, 10e-3, live_s=3) for i in range(8)]))]
    if name == "precision-grid":
        knobs = ctl.KnobSpace.around(
            ctl.ServingConfig(n_samples=8, chunk_capacity=64),
            precisions=(None, "bf16", "int8", "int4"))
        c = _controller(ctl, fm, knobs=knobs)
        return [[dataclasses.asdict(x) for x in knobs.configs()],
                _rec(c.plan([t(i, 10e-3) for i in range(8)]))]
    if name == "shards-grid":
        knobs = ctl.KnobSpace(samples=(8, 4), shards=(1, 2, 4),
                              capacities=(64, 32))
        c = _controller(ctl, fm, knobs=knobs)
        return [_rec(c.plan([t(i, 10e-3) for i in range(8)]))]
    raise KeyError(name)


CASES = ["noop", "too-little", "breach", "floor", "compile-stall",
         "contaminated", "cooldown", "window-reset", "upshift",
         "tps-breach", "queue-breach", "early-exit", "precision-grid",
         "shards-grid"]


@pytest.mark.parametrize("name", CASES)
def test_detached_decisions_equal_jax(name):
    want = _case(name, jctl, jsched, jfm)
    got = _case(name, tctl, tsched, tfm)
    assert got == want
    if name in ("breach", "upshift", "floor"):
        rec = got[-1]
        assert rec["applied"] and rec["fit"] is not None
        assert {"breach": 2, "upshift": 8, "floor": 4}[name] \
            == rec["winner"]["n_samples"]


def test_knob_space_and_policy_equal_jax():
    for cfg in (dict(n_samples=8, chunk_capacity=64),
                dict(n_samples=30, precision="bf16", chunk_capacity=20),
                dict(n_samples=5, precision="int4")):
        for prec in (None, (None, "bf16"), ("int8", "fp32", "int4")):
            want = jctl.KnobSpace.around(jctl.ServingConfig(**cfg),
                                         precisions=prec)
            got = tctl.KnobSpace.around(tctl.ServingConfig(**cfg),
                                        precisions=prec)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert [dataclasses.asdict(c) for c in got.configs()] == \
                [dataclasses.asdict(c) for c in want.configs()]
            assert [c.quality for c in got.configs()] == \
                [c.quality for c in want.configs()]
    assert tctl.PRECISION_RANK == jctl.PRECISION_RANK
    assert tctl._WEIGHT_BITS == jctl._WEIGHT_BITS
    for bad in (dict(p95_tick_s=0.0), dict(p95_tick_s=1.0, min_samples=0)):
        with pytest.raises(ValueError):
            tctl.SLOPolicy(**bad)
    with pytest.raises(ValueError, match="config= and arch="):
        tctl.CoDesignController(None, tctl.SLOPolicy(p95_tick_s=1.0))


def test_tick_metrics_fields_follow_jax():
    """``TickMetrics.shards`` (always 1 here) sits where the reference's
    does; the port's own fields are ``launches`` and ``parts_s``."""
    want = [f.name for f in dataclasses.fields(jsched.TickMetrics)]
    got = [f.name for f in dataclasses.fields(tsched.TickMetrics)
           if f.name not in ("launches", "parts_s")]
    assert got == want
    assert _tick(tsched, 0, 1e-3).shards == 1


# ---------------------------------------------------------------------------
# Attached, end to end: the reference's burst scenario
# ---------------------------------------------------------------------------

BURST_TICKS, CAP = 28, 8


def _burst(tick):
    return 4.0 if tick >= 8 else 1.0


def _clf_cfg(clf, mcd, s=4, seed=3):
    return clf.ClassifierConfig(
        hidden=8, num_layers=2, num_classes=4,
        mcd=mcd.MCDConfig(p=0.125, placement="YN", n_samples=s, seed=seed))


def _ae_cfg(ae, mcd, s=3, hetero=True):
    return ae.AutoencoderConfig(
        hidden=8, num_layers=2, cell="gru", heteroscedastic=hetero,
        mcd=mcd.MCDConfig(p=0.125, placement="YN", n_samples=s, seed=1))


def _chunks(sig, t):
    return {"a": sig[0, CAP * t:CAP * (t + 1)],
            "b": sig[1, CAP * t:CAP * (t + 1)]}


def _run_burst(engine_cls, ctl, params, cfg, sig, **kw):
    """The burst scenario on one engine: (controller, decisions, every
    post-swap tick's results, swap tick)."""
    sink = ctl.SimulatedLoadSink(per_chain_step_s=1e-5, overhead_s=2e-4,
                                 load=_burst)
    eng = engine_cls(params, cfg, max_sessions=2, chunk_capacity="auto",
                     ladder=(CAP,), metrics_sink=sink, **kw)
    eng.open_session("a")
    eng.open_session("b")
    c = ctl.CoDesignController(eng, ctl.SLOPolicy(p95_tick_s=3e-3),
                               window=8, min_ticks=4, cooldown_ticks=8)
    post, swap = [], None
    for t in range(BURST_TICKS):
        res = c.engine.step(_chunks(sig, t))
        if swap is not None:
            post.append(res)
        rec = c.maybe_reconfigure()
        if rec is not None and rec.applied and swap is None:
            swap = rec.tick
    return c, [(r.tick, r.reason, r.winner) for r in c.decisions], post, swap


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side, compiled once: the burst scenario on JAX's
    ``reference`` backend, and ``predict`` (fold and scan) on the
    classifier and the heteroscedastic autoencoder."""
    jcfg = _clf_cfg(jclf, jmcd)
    jparams = jclf.init(jax.random.key(0), jcfg)
    sig = np.random.default_rng(5).normal(size=(2, 240, 1)).astype(
        np.float32)
    _, decisions, post, swap = _run_burst(JaxEngine, jctl, jparams, jcfg,
                                          sig, backend="reference")
    post = [{sid: np.asarray(r.summary.probs) for sid, r in res.items()}
            for res in post]
    x = np.random.default_rng(7).normal(size=(4, 12, 1)).astype(np.float32)
    acfg = _ae_cfg(jae, jmcd)
    aparams = jae.init(jax.random.key(1), acfg)
    pred = {}
    for strategy in ("fold", "scan"):
        pred["clf", strategy] = np.asarray(jbayes.predict(
            lambda p, xx, r: jclf.apply(p, xx, r, jcfg, backend="reference"),
            jparams, x, jcfg.mcd, strategy=strategy))
        pred["ae", strategy] = [np.asarray(v) for v in jbayes.predict(
            lambda p, xx, r: jae.apply(p, xx, r, acfg, backend="reference"),
            aparams, x, acfg.mcd, strategy=strategy)]
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"sig": sig, "decisions": decisions, "post": post, "swap": swap,
            "params": to_np(jparams), "ae_params": to_np(aparams), "x": x,
            "predict": pred}


@pytest.mark.parametrize("backend", BACKENDS)
def test_burst_decisions_and_summaries_equal_jax(jax_runs, backend):
    tcfg = _clf_cfg(tclf, tmcd)
    params = bridge.from_numpy_params(jax_runs["params"], device="cpu")
    sig = jax_runs["sig"]
    c, decisions, post, swap = _run_burst(
        StreamingEngine, tctl, params, tcfg, sig, backend=backend,
        device="cpu")
    assert decisions == jax_runs["decisions"]
    assert swap == jax_runs["swap"] and swap is not None
    applied = [r for r in c.decisions if r.applied]
    assert applied[0].reason == "slo-breach"
    new = tctl.ServingConfig(**applied[0].winner)
    assert new.n_samples < 4 and c.config == new
    # The swap's replacement was prewarmed: no post-swap tick captures.
    assert all(m.compiles == 0 for m in c.engine.metrics if m.tick > swap)
    for res, want in zip(post, jax_runs["post"], strict=True):
        for sid in ("a", "b"):
            err = np.max(np.abs(res[sid].summary.probs.numpy() - want[sid]))
            assert err <= SUMMARY_ATOL, (sid, err)
    # Bit-equal to a prewarmed engine at the winner's config fed the
    # converted pre-swap sessions.
    twin = StreamingEngine(
        params, dataclasses.replace(tcfg, mcd=tcfg.mcd.replace(
            n_samples=new.n_samples)),
        backend=backend, max_sessions=2, chunk_capacity="auto",
        ladder=(CAP,), precision=new.precision, device="cpu")
    prewarm(twin)
    dts = tctl.carry_dtypes("lstm", new.precision, backend)
    for sess in c.last_swap["old_sessions"]:
        twin.attach_session(tctl.convert_session(
            sess, n_samples=new.n_samples, part_dtypes=dts))
    for t, res in zip(range(swap + 1, BURST_TICKS), post, strict=True):
        want = twin.step(_chunks(sig, t))
        for sid in ("a", "b"):
            for x, y in zip(res[sid].summary, want[sid].summary,
                            strict=True):
                assert torch.equal(x, y), (t, sid)
    for sid in ("a", "b"):
        for la, lb in zip(c.engine.store.get(sid).state,
                          twin.store.get(sid).state, strict=True):
            assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_decision_trail_reads_back(tmp_path, jax_runs):
    tcfg = _clf_cfg(tclf, tmcd)
    params = bridge.from_numpy_params(jax_runs["params"], device="cpu")
    path = tmp_path / "decisions.jsonl"
    sink = tctl.SimulatedLoadSink(per_chain_step_s=1e-5, overhead_s=2e-4,
                                  load=_burst)
    eng = StreamingEngine(params, tcfg, max_sessions=2, backend="cuda_seq",
                          chunk_capacity="auto", ladder=(CAP,),
                          metrics_sink=sink, device="cpu")
    eng.open_session("a")
    eng.open_session("b")
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=3e-3),
                                decision_sink=JsonlSink(str(path)),
                                window=8, min_ticks=4, cooldown_ticks=8)
    for t in range(20):
        c.engine.step(_chunks(jax_runs["sig"], t))
        c.maybe_reconfigure()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    # Tick 8's breach finds the current config predicted feasible (one slow
    # tick in a one-shape window); the cooldown's end, tick 16, downshifts.
    assert [(x["tick"], x["reason"], x["applied"]) for x in lines] == [
        (8, "already-optimal", False), (16, "slo-breach", True)]
    assert lines == [json.loads(json.dumps(dataclasses.asdict(r)))
                     for r in c.decisions]


# ---------------------------------------------------------------------------
# The swap's data plane, inside the port
# ---------------------------------------------------------------------------

def _engine(params, cfg, **kw):
    kw.setdefault("max_sessions", 2)
    kw.setdefault("chunk_capacity", 4)
    return StreamingEngine(params, cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def port_model():
    cfg = _clf_cfg(tclf, tmcd, s=4)
    return cfg, tclf.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")


def _sig(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 1)).astype(
        np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("new", [dict(n_samples=2), dict(n_samples=4,
                                                          precision="bf16"),
                                 dict(n_samples=1, precision="int8")])
def test_swap_is_the_converted_attach_twin(port_model, backend, new):
    cfg, params = port_model
    sig = _sig(12, 2)
    eng = _engine(params, cfg, backend=backend)
    eng.open_session("a")
    eng.step({"a": sig[0:4]})
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))
    new = tctl.ServingConfig(chunk_capacity=4, **new)
    got_eng = c.apply_config(new)
    assert got_eng is c.engine and got_eng is not eng
    assert got_eng.tick == eng.tick and got_eng.metrics_sink is \
        eng.metrics_sink
    assert set(c.last_swap["seconds"]) == {"build", "convert", "prewarm"}
    got = [got_eng.step({"a": sig[4:8]})["a"],
           got_eng.step({"a": sig[8:12]})["a"]]
    assert got[-1].steps_total == 12
    assert all(m.compiles == 0 for m in got_eng.metrics[1:])
    (pre,) = c.last_swap["old_sessions"]
    twin = _engine(params, dataclasses.replace(cfg, mcd=cfg.mcd.replace(
        n_samples=new.n_samples)), backend=backend,
        precision=new.precision)
    twin.attach_session(tctl.convert_session(
        pre, n_samples=new.n_samples,
        part_dtypes=tctl.carry_dtypes("lstm", new.precision, backend)))
    want = [twin.step({"a": sig[4:8]})["a"], twin.step({"a": sig[8:12]})["a"]]
    for g, w in zip(got, want):
        for x, y in zip(g.summary, w.summary, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_upshift_draws_fresh_rows(port_model):
    cfg, params = port_model
    small = dataclasses.replace(cfg, mcd=cfg.mcd.replace(n_samples=2))
    eng = _engine(params, small)
    eng.open_session("a")
    eng.step({"a": _sig(4, 4)})
    old_rows = eng.store.get("a").rows.copy()
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0),
                                knobs=tctl.KnobSpace(samples=(4, 2, 1),
                                                     capacities=(4,)))
    c.apply_config(tctl.ServingConfig(n_samples=4, chunk_capacity=4))
    rows = c.engine.store.get("a").rows
    assert np.array_equal(rows[:2], old_rows) and len(set(rows)) == 4
    assert c.engine.store.next_row >= int(rows.max()) + 1
    assert c.engine.step({"a": _sig(4, 5)})["a"].steps_total == 8


def test_swap_keeps_the_queue_in_order_and_rows_apart(port_model):
    cfg, params = port_model
    eng = _engine(params, cfg, max_sessions=1)
    eng.open_session("a")
    eng.step({"a": _sig(3, 1)})
    gone = eng.close_session("a")
    eng.open_session("b")
    for sid, prio in (("c", 1), ("d", 3), ("e", 3)):
        eng.admit(sid, priority=prio)
    eng.admit("a", session=gone, priority=2)
    order = eng.queued_sessions
    used = set(eng.store.get("b").rows.tolist()) | set(gone.rows.tolist())
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))
    c.apply_config(tctl.ServingConfig(n_samples=2, chunk_capacity=4))
    new = c.engine
    assert new.queued_sessions == order == ["d", "e", "a", "c"]
    requeued = next(t for t in new.queue.waiting() if t.sid == "a")
    assert requeued.session.steps == 3 and len(requeued.session.rows) == 2
    drawn = set()
    for sid in ("d", "e", "a", "c"):
        new.close_session(new.active_sessions[0])
        sess = new.store.get(sid)
        drawn |= set(sess.rows.tolist()) if sid != "a" else set()
    assert not drawn & used
    assert new.store.get("c").steps == 0


def test_student_session_comes_back_an_mc_session(port_model):
    from repro_torch.core import distill
    cfg, params = port_model
    heads = distill.init_student(torch.Generator().manual_seed(1), cfg,
                                 params, device="cpu")
    eng = _engine(params, cfg, student=heads)
    eng.open_session("mc")
    eng.open_session("st", mode="student")
    eng.step({"mc": _sig(3, 6), "st": _sig(4, 7)})
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))
    new = c.apply_config(tctl.ServingConfig(n_samples=2, chunk_capacity=4))
    assert new.student is None
    st = new.store.get("st")
    assert st.mode == "mc" and len(st.rows) == 1
    assert st.rows[0] == eng.store.get("st").rows[0]
    assert new.step({"st": _sig(2, 8)})["st"].steps_total == 6


@pytest.mark.parametrize("graphs", [True, False])
def test_swap_keeps_the_graph_setting(port_model, graphs):
    cfg, params = port_model
    eng = _engine(params, cfg, backend="cuda_seq", graphs=graphs)
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))
    new = c.apply_config(tctl.ServingConfig(n_samples=2, chunk_capacity=4))
    assert new.graphs is graphs and new.device == eng.device
    assert (new._graphs is not None) is graphs
    if graphs:                                 # prewarmed: every rung ready
        assert all(e.step.ready for e in new._graphs.values())


def test_a_failing_prewarm_raises_and_keeps_the_engine(port_model,
                                                       monkeypatch):
    cfg, params = port_model
    eng = _engine(params, cfg)
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))

    def broken(engine, **kw):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(tsched, "prewarm", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        c.apply_config(tctl.ServingConfig(n_samples=2, chunk_capacity=4))
    assert c.engine is eng and c.config.n_samples == 4


def test_shards_are_refused(port_model):
    """Sharding is ported: ``apply_config`` to ``shards`` 2 builds a data
    mesh of two entries over the old engine's device (and drops a meshed
    engine's early exit), back at 1 drops the mesh; the config the
    controller derives carries the engine's count.  Refused: a count
    below 1, with the engine kept.  ``FleetController`` takes a knob grid
    with ``shards`` 2."""
    cfg, params = port_model
    eng = _engine(params, cfg, early_exit_threshold=0.5)
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))
    with pytest.raises(ValueError, match="shards"):
        c.apply_config(tctl.ServingConfig(n_samples=2, shards=0))
    assert c.engine is eng
    two = c.apply_config(tctl.ServingConfig(n_samples=2, shards=2))
    assert two._shards == 2 and two.early_exit_threshold is None
    assert two.mesh.device_list == [torch.device("cpu")] * 2
    assert tctl.CoDesignController._derive_config(two).shards == 2
    one = c.apply_config(tctl.ServingConfig(n_samples=2, shards=1))
    assert one.mesh is None and one._shards == 1
    fleet = FleetEngine([TenantSpec(name="t", cfg=cfg, params=params,
                                    slo=tctl.SLOPolicy(p95_tick_s=1.0))],
                        device="cpu")
    fc = tctl.FleetController(fleet, knobs={"t": tctl.KnobSpace(
        samples=(4, 2), shards=(1, 2))})
    assert fc.controllers["t"].knobs.shards == (1, 2)
    assert set(tctl.FleetController(fleet).controllers) == {"t"}


# ---------------------------------------------------------------------------
# The fleet controller
# ---------------------------------------------------------------------------

def _hot_trail(sched, sink):
    s, cap, slots = 8, 64, 4
    for i in range(8):
        live = 4 * cap * s
        sink.emit(sched.TickMetrics(
            tick=i, capacity=cap, n_chunks=4, live_rows=4 * s,
            batch_rows=slots * s, queue_depth=0, live_steps=4 * cap,
            live_chain_steps=live, padded_steps=slots * s * cap,
            pad_waste=1.0 - live / (slots * s * cap), duration_s=10e-3,
            tokens_per_sec=live / 10e-3, tenant="hot"))


def test_fleet_controller_downshifts_the_breaching_tenant_only(jax_runs):
    jp = jax.tree.map(np.asarray, jax_runs["params"])
    tp = bridge.from_numpy_params(jax_runs["params"], device="cpu")
    out = []
    for fleet_cls, spec, clf, mcd, ctl, sched, params, kw in (
            (JaxFleet, JaxSpec, jclf, jmcd, jctl, jsched, jp,
             dict(backend="reference")),
            (FleetEngine, TenantSpec, tclf, tmcd, tctl, tsched, tp,
             dict(backend="reference"))):
        fleet = fleet_cls([
            spec(name="hot", cfg=_clf_cfg(clf, mcd, s=8), params=params,
                 max_sessions=4, chunk_capacity=64,
                 slo=ctl.SLOPolicy(p95_tick_s=4e-3), **kw),
            spec(name="cold", cfg=_clf_cfg(clf, mcd, s=3, seed=11),
                 params=params, max_sessions=4, **kw),
        ], **({} if fleet_cls is JaxFleet else {"device": "cpu"}))
        c = ctl.FleetController(fleet, window=8, min_ticks=4)
        assert set(c.controllers) == {"hot"}
        cold = fleet.group_of("cold").engine
        _hot_trail(sched, fleet.metrics_sink)
        recs = c.maybe_reconfigure()
        assert len(recs) == 1 and recs[0].applied
        assert recs[0].tenant == "hot" == c.decisions[-1].tenant
        assert recs[0].winner["n_samples"] < 8
        assert fleet.group_of("hot").engine.n_samples == \
            recs[0].winner["n_samples"]
        assert fleet.group_of("cold").engine is cold
        out.append(dataclasses.asdict(recs[0]))
    assert out[1] == out[0]


def test_fleet_controller_live_leaves_the_other_tenant_bitwise():
    """A live fleet on the CPU: the hot tenant's burst (through a
    ``SimulatedLoadSink``) downshifts only it, through
    ``reconfigure_tenant``; the cold tenant's engine object is kept and
    its summaries equal an engine of its own on the same rows."""
    hot_cfg = _clf_cfg(tclf, tmcd, s=4)
    cold_cfg = _ae_cfg(tae, tmcd, s=2)
    hot_p = tclf.init(torch.Generator().manual_seed(0), hot_cfg,
                      device="cpu")
    cold_p = tae.init(torch.Generator().manual_seed(1), cold_cfg,
                      device="cpu")
    sink = tctl.SimulatedLoadSink(per_chain_step_s=1e-5, overhead_s=2e-4,
                                  load=_burst)
    fleet = FleetEngine([
        TenantSpec(name="hot", cfg=hot_cfg, params=hot_p, max_sessions=2,
                   chunk_capacity=CAP, slo=tctl.SLOPolicy(p95_tick_s=3e-3)),
        TenantSpec(name="cold", cfg=cold_cfg, params=cold_p,
                   max_sessions=2, chunk_capacity=CAP, backend="cuda_step",
                   precision="bf16")], metrics_sink=sink, device="cpu")
    c = tctl.FleetController(fleet, window=8, min_ticks=4, cooldown_ticks=8)
    cold = fleet.group_of("cold").engine
    solo = StreamingEngine(cold_p, cold_cfg, max_sessions=2,
                           chunk_capacity=CAP, backend="cuda_step",
                           precision="bf16", device="cpu")
    sig = np.random.default_rng(9).normal(size=(4, 20 * CAP, 1)).astype(
        np.float32)
    for sid in ("a", "b"):
        fleet.admit("hot", sid)
        fleet.admit("cold", sid)
        solo.attach_session(dataclasses.replace(
            fleet.group_of("cold").engine.store.get(f"cold/{sid}")))
    for t in range(20):
        chunk = lambda k: sig[k, CAP * t:CAP * (t + 1)]  # noqa: E731
        res = fleet.step({"hot": {"a": chunk(0), "b": chunk(1)},
                          "cold": {"a": chunk(2), "b": chunk(3)}})
        want = solo.step({"cold/a": chunk(2), "cold/b": chunk(3)})
        for sid in ("a", "b"):
            for x, y in zip(res["cold"][sid].summary,
                            want[f"cold/{sid}"].summary, strict=True):
                assert torch.equal(x, y), (t, sid)
        c.maybe_reconfigure()
    applied = [r for r in c.decisions if r.applied]
    assert applied and {r.tenant for r in c.decisions} == {"hot"}
    assert applied[0].reason == "slo-breach"
    assert fleet.group_of("hot").engine.n_samples < 4
    assert fleet.group_of("cold").engine is cold
    # The hot tenant's new engine was prewarmed: no tick after a swap
    # captures.
    swapped = [m for m in fleet.metrics if m.tenant == "hot"
               and m.tick > applied[0].tick]
    assert swapped and all(m.compiles == 0 for m in swapped)


# ---------------------------------------------------------------------------
# core/bayesian.predict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_predict_fold_and_scan_equal_jax(jax_runs, backend):
    x = torch.from_numpy(jax_runs["x"])
    cfg = _clf_cfg(tclf, tmcd)
    params = bridge.from_numpy_params(jax_runs["params"], device="cpu")
    acfg = _ae_cfg(tae, tmcd)
    aparams = bridge.from_numpy_params(jax_runs["ae_params"], device="cpu")
    got = {}
    for strategy in ("fold", "scan"):
        got["clf", strategy] = bayesian.predict(
            lambda p, xx, r: tclf.apply(p, xx, r, cfg, backend=backend,
                                        device="cpu"),
            params, x, cfg.mcd, strategy=strategy)
        got["ae", strategy] = bayesian.predict(
            lambda p, xx, r: tae.apply(p, xx, r, acfg, backend=backend,
                                       device="cpu"),
            aparams, x, acfg.mcd, strategy=strategy)
    assert got["clf", "fold"].shape == (4, 4, 4)
    assert torch.equal(got["clf", "fold"], got["clf", "scan"])
    assert len(got["ae", "fold"]) == 2
    for a, b in zip(got["ae", "fold"], got["ae", "scan"], strict=True):
        assert a.shape == (3, 4, 12, 1) and torch.equal(a, b)
    for strategy in ("fold", "scan"):
        want = jax_runs["predict"]["clf", strategy]
        assert np.max(np.abs(got["clf", strategy].numpy() - want)) \
            <= SUMMARY_ATOL
        for a, w in zip(got["ae", strategy],
                        jax_runs["predict"]["ae", strategy], strict=True):
            assert np.max(np.abs(a.numpy() - w)) <= SUMMARY_ATOL


def test_predict_trees_and_errors():
    cfg = tmcd.MCDConfig(p=0.125, placement="N", n_samples=5)
    x = torch.arange(6.0).reshape(3, 2)

    def fn(p, xx, rows):
        return {"x": xx * p, "rows": rows, "none": None}

    out = bayesian.predict(fn, 2.0, x, cfg)
    assert out["x"].shape == (1, 3, 2) and out["none"] is None
    cfg = cfg.replace(placement="Y")
    fold = bayesian.predict(fn, 2.0, x, cfg)
    scan = bayesian.predict(fn, 2.0, x, cfg, strategy="scan")
    assert torch.equal(fold["rows"], scan["rows"])
    assert fold["rows"].tolist() == [[5 * 0 + 3 * s + b for b in range(3)]
                                     for s in range(5)]
    with pytest.raises(ValueError, match="strategy"):
        bayesian.predict(fn, 2.0, x, cfg, strategy="map")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_controller_writes_a_decision_trail(tmp_path):
    path = tmp_path / "decisions.jsonl"
    agg = tlaunch.main(["--device", "cpu", "--sessions", "2", "--samples",
                        "4", "--beats", "1", "--chunk-len", "20",
                        "--ragged", "--capacity", "auto", "--prewarm",
                        "--controller", "--slo-p95-ms", "0.001",
                        "--min-samples", "2", "--decisions-out", str(path)])
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines and lines[0]["applied"]
    assert lines[0]["winner"]["n_samples"] == 2      # the floor holds
    assert all(line["winner"] is None or line["winner"]["n_samples"] >= 2
               for line in lines)
    assert agg["compiles"] == 0 and agg["ticks"] >= 5


@pytest.mark.parametrize("flag", [["--controller"],
                                  ["--decisions-out", "d.jsonl"]])
def test_launcher_refuses_a_controller_on_a_fleet(tmp_path, flag):
    """``--tenants`` serves through the fleet, which the single-engine
    controller does not drive: asking for one is an error, not a fleet
    served uncontrolled."""
    fleet_json = tmp_path / "fleet.json"
    fleet_json.write_text(json.dumps({"tenants": [{"name": "ward"}]}))
    with pytest.raises(SystemExit) as err:
        tlaunch.main(["--device", "cpu", "--tenants", str(fleet_json),
                      *flag])
    assert err.value.code == 2
    assert not (tmp_path / "d.jsonl").exists()
