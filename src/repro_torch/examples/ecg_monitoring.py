"""Continuous ECG monitoring with streaming Bayesian uncertainty — port of
``examples/ecg_monitoring.py``.

The paper's motivating deployment: a Bayesian classifier watches a
patient's ECG as an unbounded stream and emits, for every arriving chunk,
the predictive distribution over beat classes for the signal so far plus
its uncertainty decomposition -- high mutual information (epistemic)
marks windows the model has not seen the like of.

The stream is served through ``repro_torch.serve.StreamingEngine``: the
per-session carry resumes the sequence-fused kernel at every chunk
boundary, and the MC-dropout masks stay tied across the whole session, so
the chunking of the signal is invisible to the Bayesian draw (chunked and
unchunked serving are bit-identical; the demo asserts it).

Modes, each asserting its contract:
  --kill-resume  snapshot mid-run, drop the engine, restore into a fresh
                 one and finish: bit-identical to an uninterrupted run;
  --controller   a simulated x4 load burst; the online
                 ``CoDesignController`` downshifts S, recovers the SLO, and
                 the streams across the swap are bit-identical to an engine
                 born at the new config from the same carries;
  --early-exit   a flatline stream retires its surplus chains to the floor,
                 a real beat keeps all S, retained outputs bit-identical;
  --distill      both streams start on a distilled single-row student; the
                 anomalous beat escalates to S fresh MC chains,
                 bit-identical to an always-MC session attached at the
                 carry.

    PYTHONPATH=src python -m repro_torch.examples.ecg_monitoring [--steps 120]
    PYTHONPATH=src python -m repro_torch.examples.ecg_monitoring --smoke
    PYTHONPATH=src python -m repro_torch.examples.ecg_monitoring --smoke \\
        --kill-resume --early-exit --device cpu

The backend defaults to ``cuda_seq`` where the reference's is
``pallas_seq``; the reference's names are taken and mapped
(``pallas_seq`` -> ``cuda_seq``, ``pallas_step`` -> ``cuda_step``), as
``launch.stream.load_fleet`` maps them.  Training (``train_quick``) runs
the plain PyTorch path through ``torch.autograd``, as the reference trains
through ``jax.grad``; weights start from CPU ``torch.Generator``s.
"""

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import classifier as clf, mcd
from repro_torch.data import ecg
from repro_torch.launch.stream import REFERENCE_BACKENDS
from repro_torch.serve import StreamingEngine
from repro_torch.train import optimizer, trainer


def _init(cfg, dev, seed: int = 0):
    return clf.init(torch.Generator().manual_seed(seed), cfg, device=dev)


def train_quick(cfg, tx, ty, steps: int, dev, seed: int = 0):
    """A few AdamW steps on the synthetic ECG5000 train split."""
    params = _init(cfg, dev, seed)
    if steps == 0:
        return params

    def loss(p, batch, step):
        x, y = batch
        rows = torch.arange(x.shape[0], dtype=torch.int64, device=dev)
        logits = clf.apply(p, x, rows, cfg, device=dev)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.mean(torch.gather(logp, -1, y.long()[:, None])), {}

    tr = trainer.Trainer(loss, params, trainer.TrainConfig(
        adamw=optimizer.AdamWConfig(lr=3e-3), log_every=0))
    pipe = ecg.Pipeline(tx, ty, batch_size=64, seed=seed)
    tr.run((tuple(torch.as_tensor(a, device=dev) for a in b)
            for e in range(200) for b in pipe.epoch(e)), steps)
    return tr.params


def _engine(params, cfg, args, dev, **kw):
    kw.setdefault("precision", args.precision)
    return StreamingEngine(params, cfg, backend=args.backend, device=dev,
                           **kw)


def _same(a, b) -> bool:
    return torch.equal(a.summary.probs, b.summary.probs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120, help="training steps")
    ap.add_argument("--samples", type=int, default=8, help="S MC chains")
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--chunk-len", type=int, default=28)
    ap.add_argument("--backend", default="cuda_seq",
                    choices=("reference", "cuda_step", "cuda_seq",
                             *REFERENCE_BACKENDS))
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "int8", "int4"),
                    help="serving precision: quantize weights per-channel "
                    "(int8/int4 packed, dequantized in the kernel) and run "
                    "bf16 activations; default: native dtypes")
    ap.add_argument("--cell", default="lstm", choices=("lstm", "gru"),
                    help="recurrent unit (§III-A: the GRU drops into the "
                    "same per-gate MCD design; streamed with h-only "
                    "carries)")
    ap.add_argument("--mi-alarm", type=float, default=0.15,
                    help="epistemic (MI) escalation threshold, nats")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: untrained tiny model, a few chunks")
    ap.add_argument("--kill-resume", action="store_true",
                    help="snapshot mid-run, rebuild the engine from disk, "
                    "assert bit-identical continuation")
    ap.add_argument("--controller", action="store_true",
                    help="overload-burst demo: the co-design controller "
                    "downshifts under a simulated x4 load burst, recovers "
                    "the SLO, and the streams stay bit-identical across "
                    "the swap")
    ap.add_argument("--early-exit", action="store_true",
                    help="adaptive-sampling demo: a flatline stream "
                    "retires its surplus MC chains mid-stream, a real ECG "
                    "stream keeps all of them, and the retained outputs "
                    "stay bit-identical to a static-S engine")
    ap.add_argument("--distill", action="store_true",
                    help="distilled fast-path demo: both streams serve on "
                    "a single-row student; the anomalous beat escalates "
                    "to full MC, bit-identical to an always-MC session "
                    "attached at that carry")
    ap.add_argument("--snapshot-dir", default=None,
                    help="where --kill-resume persists sessions "
                    "(default: a temp dir)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    args.backend = REFERENCE_BACKENDS.get(args.backend, args.backend)
    if args.smoke:
        args.steps, args.samples, args.sessions, args.chunk_len = 0, 4, 2, 10

    # Paper's best ECG classifier config (H=8, NL=3, placement YNY).
    cfg = clf.ClassifierConfig(
        hidden=8, num_layers=3, num_classes=ecg.NUM_CLASSES, cell=args.cell,
        mcd=mcd.MCDConfig(p=0.125, placement="YNY",
                          n_samples=args.samples, seed=0))
    tx, ty, ex, ey = ecg.make_ecg5000(seed=0)
    params = train_quick(cfg, tx, ty, args.steps, dev)

    # Each session streams one held-out beat; smoke keeps it to a prefix.
    rng = np.random.default_rng(1)
    picks = rng.choice(len(ex), size=args.sessions, replace=False)
    total_t = 3 * args.chunk_len if args.smoke else ecg.T_STEPS

    eng = _engine(params, cfg, args, dev, max_sessions=args.sessions)
    for k in range(args.sessions):
        eng.open_session(f"patient-{k}")
    print(f"monitoring {args.sessions} sessions, chunk={args.chunk_len}, "
          f"S={args.samples}, cell={args.cell}, backend={args.backend}, "
          f"device={dev}, precision={args.precision or 'native'}, "
          f"model trained {args.steps} steps")

    pos = 0
    while pos < total_t:
        chunks = {f"patient-{k}": ex[picks[k]][pos:pos + args.chunk_len]
                  for k in range(args.sessions)}
        results = eng.step(chunks)
        pos += args.chunk_len
        for sid, res in sorted(results.items()):
            su = res.summary
            mi = float(su.mutual_information)
            cls = int(torch.argmax(su.probs))
            flag = ("  <-- ESCALATE (high epistemic)"
                    if mi > args.mi_alarm else "")
            print(f"  {sid} t={res.steps_total:3d}: class={cls} "
                  f"H={float(su.predictive_entropy):5.3f} MI={mi:6.4f}{flag}")

    print()
    for k in range(args.sessions):
        sess = eng.close_session(f"patient-{k}")
        print(f"patient-{k}: true class {int(ey[picks[k]])}, served "
              f"{sess.steps} steps in {sess.chunks} chunks "
              f"(masks tied across all of them)")

    # The invariant that makes this safe to deploy: chunking is invisible.
    eng2 = _engine(params, cfg, args, dev, max_sessions=1)
    eng2.open_session("whole")
    whole = eng2.step({"whole": ex[picks[0]][:total_t]})["whole"]
    eng3 = _engine(params, cfg, args, dev, max_sessions=1)
    eng3.open_session("split")
    split = None
    for a in range(0, total_t, 7):
        split = eng3.step(
            {"split": ex[picks[0]][a:min(a + 7, total_t)]})["split"]
    same = _same(whole, split)
    print(f"\nchunked-equals-unchunked (7-step chunks vs one pass): "
          f"bit-identical={same}")
    assert same, "streaming resumption must be bit-identical"

    if args.kill_resume:
        kill_and_resume(params, cfg, ex, picks, args, total_t, dev)
    if args.controller:
        controller_demo(params, cfg, ex, picks, args, dev)
    if args.early_exit:
        early_exit_demo(cfg, ex, picks, args, dev)
    if args.distill:
        distill_demo(cfg, tx, ty, ex, picks, args, dev)
    return eng


def kill_and_resume(params, cfg, ex, picks, args, total_t, dev):
    """Snapshot mid-run, 'crash', restore into a fresh engine, compare:
    every post-resume chunk's summary bit-identical to an uninterrupted
    engine's."""
    half = (total_t // (2 * args.chunk_len)) * args.chunk_len

    def serve(eng, lo, hi):
        out = {}
        pos = lo
        while pos < hi:
            out = eng.step({f"patient-{k}":
                            ex[picks[k]][pos:pos + args.chunk_len]
                            for k in range(args.sessions)})
            pos += args.chunk_len
        return out

    def fresh():
        return _engine(params, cfg, args, dev, max_sessions=args.sessions)

    gold = fresh()
    for k in range(args.sessions):
        gold.open_session(f"patient-{k}")
    final_gold = serve(gold, 0, total_t)

    victim = fresh()
    for k in range(args.sessions):
        victim.open_session(f"patient-{k}")
    serve(victim, 0, half)
    with tempfile.TemporaryDirectory() as tmp:
        snap_dir = args.snapshot_dir or tmp
        path = victim.snapshot(snap_dir)
        print(f"\nkill-and-resume: snapshot at t={half} -> {path}")
        del victim                                  # the crash
        revived = fresh()
        revived.restore(snap_dir)
        final_res = serve(revived, half, total_t)

    for sid, want in sorted(final_gold.items()):
        got = final_res[sid]
        same = got.steps_total == want.steps_total and _same(got, want)
        print(f"  {sid}: resumed summary bit-identical={same}")
        assert same, (f"{sid}: kill-and-resume diverged from the "
                      "uninterrupted stream")
    print("kill-and-resume OK: restored process == never-crashed process")


def early_exit_demo(cfg, ex, picks, args, dev):
    """Adaptive sampling: easy streams shed chains, hard streams keep S.

    Served with ``early_exit_threshold=0.0``: a session retires chains
    only when halving them moves its summary by exactly nothing.  A
    flatline through a freshly initialised stack (zero biases) keeps every
    activation at zero, so all S chains are identical and it retires to
    the floor; a real beat keeps every chain, and its summaries are
    bit-identical to a static-S engine serving it solo.
    """
    demo_params = _init(cfg, dev)        # fresh init: zero biases
    floor, S = 2, args.samples
    eng = StreamingEngine(demo_params, cfg, backend=args.backend,
                          max_sessions=2, early_exit_threshold=0.0,
                          min_samples=floor, device=dev)
    solo = StreamingEngine(demo_params, cfg, backend=args.backend,
                           max_sessions=1, device=dev)
    # "ecg" first: mask rows follow admission order, and the solo engine
    # hands its only session rows [0..S) -- the same Bayesian draw.
    eng.open_session("ecg")
    eng.open_session("flatline")
    solo.open_session("ecg")
    print(f"\nearly-exit demo: S={S} floor={floor} threshold=0.0 "
          f"(flatline vs real beat)")
    retained_same = True
    flat = np.zeros((args.chunk_len, 1), np.float32)
    for t in range(4):
        lo = t * args.chunk_len
        beat = ex[picks[0]][lo:lo + args.chunk_len]
        res = eng.step({"flatline": flat, "ecg": beat})
        want = solo.step({"ecg": beat})["ecg"]
        retained_same &= _same(res["ecg"], want)
        s_easy = int(eng.store.get("flatline").rows.shape[0])
        s_hard = int(eng.store.get("ecg").rows.shape[0])
        m = eng.last_metrics
        print(f"  tick {t}: flatline S={s_easy} ecg S={s_hard} "
              f"active={m.active_chains} retired={m.reclaimed_rows}")
    s_easy = int(eng.store.get("flatline").rows.shape[0])
    s_hard = int(eng.store.get("ecg").rows.shape[0])
    assert s_easy == floor, \
        f"flatline stream should retire to the floor, holds {s_easy}"
    assert s_hard == S, \
        f"ecg stream should keep all {S} chains, holds {s_hard}"
    reclaimed = sum(m.reclaimed_rows for m in eng.metrics)
    assert reclaimed == S - floor, \
        f"expected {S - floor} retired chains, metrics counted {reclaimed}"
    print(f"  ecg stream vs static-S solo engine: "
          f"bit-identical={retained_same}")
    assert retained_same, "early exit perturbed a retained stream's outputs"
    print("early-exit demo OK: confident stream at the floor, uncertain "
          "stream at full S, retained outputs bit-identical")


def distill_demo(cfg, tx, ty, ex, picks, args, dev):
    """Distilled fast path: easy traffic on one row, MC fallback on demand.

    Both streams open in ``mode="student"``, a single deterministic row
    decoded through heads distilled here from a quick-trained S-chain
    teacher (cached targets, thousands of head steps).  Against a
    threshold between the student's predicted MI on a flatline and on the
    beat it flags hardest, the flatline stays on the student while the
    anomalous beat escalates on its first chunk (``SessionStore.grow``
    regrows S fresh chains from the student's carry); the regrown
    stream's summaries are bit-identical to an always-MC engine serving a
    session attached with those rows and that carry.
    """
    from repro_torch.core import distill
    from repro_torch.train import distill as distill_train

    n_chunks, n_steps = 2, 6000
    # A freshly initialised stack is near-uniform everywhere, so the demo
    # trains its own quick teacher.
    demo_params = train_quick(cfg, tx, ty, max(args.steps, 120), dev)
    S = args.samples
    rng = np.random.default_rng(2)
    cand_ids = rng.choice(len(ex), size=16, replace=False)
    cand = torch.as_tensor(
        np.stack([ex[i][:args.chunk_len] for i in cand_ids]), device=dev)
    # The four candidates the teacher is most epistemically uncertain
    # about on their first chunk.
    teacher_mi = distill.classifier_teacher_targets(
        demo_params, cand, cfg, n_samples=S,
        device=dev).mutual_information.cpu().numpy()
    top = np.argsort(-teacher_mi)[:4]
    beats = cand[torch.as_tensor(top, device=dev)]
    # The distillation stream: the first-chunk flatline window shares a
    # batch with the beats, plus the longer flatline prefix the student
    # will also be asked about.
    zeros = torch.zeros((1, args.chunk_len, 1), device=dev)
    xs = [torch.cat([zeros, beats]),
          torch.zeros((1, n_chunks * args.chunk_len, 1), device=dev)]
    dcfg = distill_train.DistillConfig(n_samples=S, lr=3e-2,
                                       cache_targets=True)
    student, hist = distill_train.distill_classifier(
        demo_params, cfg, xs, n_steps,
        generator=torch.Generator().manual_seed(1), dcfg=dcfg, device=dev)

    def mi_hat(x):
        with torch.no_grad():
            _, states = clf.apply(demo_params, x,
                                  distill.det_rows(x.shape[0], device=dev),
                                  cfg, return_state=True, device=dev)
            return distill.classifier_student_summary(
                student, states[-1][0]).mutual_information.cpu().numpy()

    mi_flat = max(float(mi_hat(torch.zeros(
        (1, k * args.chunk_len, 1), device=dev))[0])
        for k in range(1, n_chunks + 1))
    stu_mi = mi_hat(beats)
    worst = int(np.argmax(stu_mi))
    anomaly = ex[cand_ids[top[worst]]]
    mi_anom = float(stu_mi[worst])
    assert mi_flat < mi_anom, "uncertainty head failed to separate regimes"
    thr = 0.5 * (mi_flat + mi_anom)
    print(f"\ndistill demo: S={S} student MI flatline<={mi_flat:.4f} "
          f"anomalous beat={mi_anom:.4f} threshold={thr:.4f} "
          f"(distilled {n_steps} steps, final loss={hist[-1]['loss']:.4f})")

    eng = StreamingEngine(demo_params, cfg, backend=args.backend,
                          max_sessions=2, student=student,
                          student_escalate_threshold=thr, device=dev)
    eng.open_session("flatline", mode="student")
    eng.open_session("anomaly", mode="student")
    plain, identical = None, True
    flat = np.zeros((args.chunk_len, 1), np.float32)
    for t in range(n_chunks):
        lo = t * args.chunk_len
        chunk = anomaly[lo:lo + args.chunk_len]
        res = eng.step({"flatline": flat, "anomaly": chunk})
        m = eng.last_metrics
        print(f"  tick {t}: student_rows={m.student_rows} "
              f"escalations={m.escalations} active={m.active_chains} "
              f"anomaly_MI="
              f"{float(res['anomaly'].summary.mutual_information):.4f}")
        if t == 0:
            # The anomalous beat must escalate on its very first chunk.
            assert m.escalations == 1 and m.student_rows == 2
            sess = eng.store.get("anomaly")
            assert sess.mode == "mc" and int(sess.rows.shape[0]) == S
            plain = StreamingEngine(demo_params, cfg, backend=args.backend,
                                    max_sessions=1, device=dev)
            plain.attach_session(dataclasses.replace(
                sess, state=[tuple(layer) for layer in sess.state]))
        else:
            assert m.escalations == 0 and m.student_rows == 1
            want = plain.step({"anomaly": chunk})["anomaly"]
            identical &= _same(res["anomaly"], want)
    assert eng.store.get("flatline").mode == "student", \
        "flatline stream should have stayed on the student fast path"
    print(f"  escalated stream vs always-MC engine attached at the carry: "
          f"bit-identical={identical}")
    assert identical, "escalation diverged from the always-MC twin"
    print("distill demo OK: easy stream on one student row, anomalous "
          "stream escalated to full MC, regrown chains bit-identical")


def controller_demo(params, cfg, ex, picks, args, dev):
    """Overload burst -> downshift -> SLO recovered, streams bit-safe.

    Tick durations come from a deterministic simulated cost model (a x4
    load burst from tick 8); the controller calibrates, searches and
    swaps.  The contract: at least one applied ``DecisionRecord`` with a
    changed config, p95 back under the SLO within the cooldown, and the
    post-swap outputs bit-identical to an engine born at the new config
    resuming from the same carried state.
    """
    from repro_torch.serve import (CoDesignController, ServingConfig,
                                   SimulatedLoadSink, SLOPolicy)
    from repro_torch.serve.controller import carry_dtypes, convert_session
    from repro_torch.serve.scheduler import percentile

    n_ticks, chunk = 24, 8
    slo = SLOPolicy(p95_tick_s=3e-3)
    sink = SimulatedLoadSink(per_chain_step_s=1e-5, overhead_s=2e-4,
                             load=lambda t: 4.0 if t >= 8 else 1.0)
    sig = [np.tile(ex[picks[k]], (2, 1)) for k in range(args.sessions)]
    eng = StreamingEngine(params, cfg, backend=args.backend,
                          max_sessions=args.sessions,
                          chunk_capacity="auto", ladder=(chunk,),
                          metrics_sink=sink, device=dev)
    for k in range(args.sessions):
        eng.open_session(f"patient-{k}")
    ctrl = CoDesignController(eng, slo, window=8, min_ticks=4,
                              cooldown_ticks=8)
    print(f"\ncontroller demo: SLO p95<={slo.p95_tick_s * 1e3:.0f}ms "
          f"(simulated x4 burst at tick 8) | knobs "
          f"S={list(ctrl.knobs.samples)}")

    def chunks_at(t):
        return {f"patient-{k}": sig[k][t * chunk:(t + 1) * chunk]
                for k in range(args.sessions)}

    post, swap_tick = [], None
    for t in range(n_ticks):
        res = ctrl.engine.step(chunks_at(t))
        if swap_tick is not None:
            post.append({sid: r.summary.probs for sid, r in res.items()})
        rec = ctrl.maybe_reconfigure()
        if rec is not None:
            print(f"  tick {rec.tick}: [{rec.reason}] "
                  f"applied={rec.applied} winner={rec.winner}")
            if rec.applied and swap_tick is None:
                swap_tick = rec.tick

    applied = [r for r in ctrl.decisions if r.applied]
    assert applied, "controller never reconfigured under the burst"
    new = ServingConfig(**applied[0].winner)
    assert applied[0].winner != applied[0].current
    recov = [m.duration_s for m in sink.window()
             if swap_tick < m.tick <= swap_tick + ctrl.cooldown_ticks]
    p95 = percentile(recov, 95)
    print(f"  post-swap p95 {p95 * 1e3:.2f}ms "
          f"vs SLO {slo.p95_tick_s * 1e3:.0f}ms")
    assert p95 <= slo.p95_tick_s, "SLO not recovered within the cooldown"

    # Bit-identity across the boundary: an engine born at the new config,
    # resuming from the same carried state, must stream the same outputs.
    cfg2 = dataclasses.replace(
        cfg, mcd=cfg.mcd.replace(n_samples=new.n_samples))
    ref = StreamingEngine(params, cfg2, backend=args.backend,
                          max_sessions=args.sessions,
                          chunk_capacity="auto", ladder=(chunk,),
                          precision=new.precision, device=dev)
    dts = carry_dtypes(cfg.cell, new.precision, ref.backend)
    for sess in ctrl.last_swap["old_sessions"]:
        ref.attach_session(convert_session(
            sess, n_samples=new.n_samples, part_dtypes=dts))
    same = True
    for t, probs in zip(range(swap_tick + 1, n_ticks), post):
        want = ref.step(chunks_at(t))
        same &= all(torch.equal(probs[sid], want[sid].summary.probs)
                    for sid in probs)
    print(f"  streams across the swap bit-identical={same}")
    assert same, "reconfiguration changed a stream's outputs"
    print("controller demo OK: downshift under burst, SLO recovered, "
          "streams bit-safe")


if __name__ == "__main__":
    main()
