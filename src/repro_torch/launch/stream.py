"""Streaming session-serving launcher: continuous ECG monitoring on the GPU.

Opens concurrent sessions, each a synthetic-ECG signal (ECG5000-compatible
beats back to back), and serves them chunk by chunk through the
``StreamingEngine`` with carried per-session state: per-chunk Bayesian
uncertainty over the signal so far.  Single tenant, the ECG classifier,
LSTM or GRU (``--cell``), on any stack backend (``--backend``).

``--overload N`` serves N streams through ``--sessions`` live rows: all
are admitted up front (earlier streams at higher priority), the first
``--sessions`` go live and the rest wait in the admission queue until a
stream finishes.  More than ``--max-pending`` waiting streams are refused
(``serve.admission.QueueFull``), as in the reference.

``--tenants fleet.json`` serves a multi-tenant fleet instead: the JSON
declares heterogeneous tenants (classifier or autoencoder, LSTM or GRU,
each with its own S, precision and weight) and one ``FleetEngine`` serves
them all a tick (see :func:`load_fleet`).  ``--chunk-len``, ``--ragged``,
``--metrics-out``, ``--snapshot-*``, ``--resume``, ``--device`` and
``--shards`` apply fleet-wide.

``--shards N`` serves every launch over a data mesh of N entries
(``launch.rnn_shardings``): the first N cards, or an error where the
machine has fewer; with ``--device cpu`` the CPU N times.  The results are
the unsharded engine's, bit for bit.  It is refused beside
``--early-exit-threshold`` (sharded launches need one S a session).

``--controller`` runs the online co-design loop on the single-tenant engine
(``serve.controller.CoDesignController``): after each tick it calibrates
the GPU roofline against the observed ticks and, when the SLO
(``--slo-p95-ms``, ``--min-tokens-per-sec``, the ``--min-samples`` floor)
is breached, swaps in a prewarmed engine at a smaller S, sessions intact;
``--decisions-out`` appends its decisions as JSON lines.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 4 \
      --chunk-len 20 --samples 8 --beats 2
  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 4 \
      --cell gru --backend cuda_step
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \
      --sessions 2 --samples 4 --beats 1 --ragged --capacity auto
  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 2 \
      --overload 6 --capacity auto --snapshot-dir snaps --snapshot-every 3
  PYTHONPATH=src python -m repro_torch.launch.stream --precision int8 \
      --sessions 4 --samples 8 --beats 1
  PYTHONPATH=src python -m repro_torch.launch.stream --capacity auto \
      --prewarm --sessions 4 --samples 8 --beats 1
  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 4 \
      --samples 8 --beats 2 --snapshot-dir snaps --snapshot-every 2
  PYTHONPATH=src python -m repro_torch.launch.stream --snapshot-dir snaps \
      --resume            # a killed run goes on where its snapshot left it
  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 4 \
      --samples 8 --early-exit-threshold 1e-3 --min-samples 2
  PYTHONPATH=src python -m repro_torch.launch.stream --tenants fleet.json \
      --chunk-len 20 --metrics-out fleet.jsonl
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \
      --sessions 3 --samples 2 --beats 1 --ragged --shards 2
  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 64 \
      --samples 30 --beats 4 --ragged --capacity auto --prewarm \
      --controller --slo-p95-ms 3 --min-samples 8 \
      --decisions-out decisions.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint
from repro_torch.core import autoencoder as ae, classifier as clf, mcd
from repro_torch.data import ecg
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.serve import (CoDesignController, FleetEngine, JsonlSink,
                               SLOPolicy, StreamingEngine, TenantSpec,
                               pow2_ladder, prewarm, summarize)

#: The reference's backend names, as a fleet table written for it names
#: them (a snapshot's backend name is not checked either).
REFERENCE_BACKENDS = {"pallas_seq": "cuda_seq", "pallas_step": "cuda_step"}


def build_streams(n_sessions: int, beats: int, seed: int):
    """Per-session continuous signals: ``beats`` ECG beats back to back."""
    _, _, ex, ey = ecg.make_ecg5000(seed)
    rng = np.random.default_rng(seed)
    streams, labels = [], []
    for _ in range(n_sessions):
        idx = rng.integers(0, len(ex), size=beats)
        streams.append(np.concatenate([ex[i] for i in idx], axis=0))
        labels.append([int(ey[i]) for i in idx])
    return streams, labels


def load_fleet(path: str, default_seed: int, device=None):
    """Parse a fleet JSON tenant table into ``TenantSpec``s and stream
    plans.

    Schema (every per-tenant key optional except ``name``)::

        {"admit_per_tick": 4, "aging_rounds": 16, "max_pending": 256,
         "tenants": [
           {"name": "ward", "task": "classifier", "cell": "lstm",
            "hidden": 8, "layers": 2, "classes": 5, "samples": 4,
            "p": 0.125, "placement": "YN", "weight": 3.0,
            "precision": null, "backend": "cuda_seq",
            "max_sessions": 4, "streams": 6, "beats": 2,
            "decode_window": null, "seed": 0,
            "early_exit_threshold": null, "min_samples": 1},
           ...]}

    The reference's schema, read the same way: a table written for it
    names ``pallas_seq`` / ``pallas_step``, served here as ``cuda_seq`` /
    ``cuda_step``.  Tenants serve at dynamic shapes, as the reference's.
    ``streams`` is how many signals the tenant submits (more than
    ``max_sessions`` overloads it).  Each params object is drawn from a
    ``torch.Generator`` seeded by the tenant's ``seed``; tenants with an
    identical model spec and seed share one, so they fold into one launch
    group.
    """
    with open(path) as fh:
        doc = json.load(fh)
    specs, plans, params_cache = [], {}, {}
    for e in doc["tenants"]:
        name = e["name"]
        task = e.get("task", "classifier")
        layers = int(e.get("layers", 2))
        m = mcd.MCDConfig(
            p=float(e.get("p", 0.125)),
            placement=e.get("placement") or "Y" + "N" * (layers - 1),
            n_samples=int(e.get("samples", 4)),
            seed=int(e.get("seed", default_seed)))
        if task == "classifier":
            cfg = clf.ClassifierConfig(
                hidden=int(e.get("hidden", 8)), num_layers=layers,
                num_classes=int(e.get("classes", 5)),
                cell=e.get("cell", "lstm"), mcd=m)
            init = clf.init
        elif task == "autoencoder":
            cfg = ae.AutoencoderConfig(
                hidden=int(e.get("hidden", 8)), num_layers=layers,
                cell=e.get("cell", "lstm"), mcd=m,
                decode_window=e.get("decode_window"))
            init = ae.init
        else:
            raise ValueError(f"tenant {name!r}: unknown task {task!r} "
                             "(classifier | autoencoder)")
        key = (task, cfg, m.seed)
        if key not in params_cache:
            params_cache[key] = init(torch.Generator().manual_seed(m.seed),
                                     cfg, device=device)
        backend = e.get("backend", "cuda_seq")
        max_sessions = int(e.get("max_sessions", 4))
        eet = e.get("early_exit_threshold")
        specs.append(TenantSpec(
            name=name, cfg=cfg, params=params_cache[key],
            weight=float(e.get("weight", 1.0)),
            precision=e.get("precision"),
            backend=REFERENCE_BACKENDS.get(backend, backend),
            max_sessions=max_sessions,
            early_exit_threshold=None if eet is None else float(eet),
            min_samples=int(e.get("min_samples", 1))))
        plans[name] = {"streams": int(e.get("streams", max_sessions)),
                       "beats": int(e.get("beats", 2)),
                       "seed": int(e.get("seed", default_seed))}
    fleet_kw = {k: doc[k] for k in ("admit_per_tick", "aging_rounds",
                                    "max_pending") if k in doc}
    return specs, plans, fleet_kw


def run_fleet(args, device) -> dict:
    """Serve the multi-tenant fleet of ``--tenants fleet.json``; returns
    ``summarize()`` of its tenant-tagged trail."""
    specs, plans, fleet_kw = load_fleet(args.tenants, args.seed, device)
    sink = JsonlSink(args.metrics_out) if args.metrics_out else None
    mesh = (make_data_mesh(args.shards, device=device) if args.shards
            else None)
    fleet = FleetEngine(specs, metrics_sink=sink, device=device, mesh=mesh,
                        **fleet_kw)
    for g in fleet.groups.values():
        print(f"launch group {g.name}: tenants={g.tenants}")
    print(f"fleet of {len(specs)} tenant(s) on {device}, "
          f"admit_per_tick={fleet.admit_per_tick or 'eager'} | "
          + " ".join(f"{s.name}[w={s.weight:g} rows={s.max_sessions} "
                     f"streams={plans[s.name]['streams']}]" for s in specs))

    # Streams regenerate from the tenant table, so a resume needs only the
    # snapshot and the same fleet.json.
    streams = {t: build_streams(p["streams"], p["beats"], p["seed"])[0]
               for t, p in plans.items()}
    planned = {t: [f"s{k}" for k in range(p["streams"])]
               for t, p in plans.items()}
    done: dict[str, set[str]] = {t: set() for t in plans}
    if args.resume:
        fleet.restore(args.snapshot_dir)
        live = fleet.active_sessions
        queued = {(t.tenant, t.sid.split("/", 1)[1])
                  for t in fleet.queue.waiting()}
        # Everything was admitted before the first snapshot: a planned sid
        # neither live nor queued has finished.
        for t in plans:
            done[t] = {s for s in planned[t]
                       if s not in live.get(t, []) and (t, s) not in queued}
        print(f"resumed fleet tick {fleet.tick}: live={live} "
              f"queued={sorted(queued)} "
              f"done={ {t: sorted(v) for t, v in done.items() if v} }")
    else:
        for t in sorted(plans):
            for k, s in enumerate(planned[t]):
                went_live = fleet.admit(t, s, priority=len(planned[t]) - k)
                print(f"admit {t}/{s}: "
                      f"{'live' if went_live is not None else 'queued'}")

    rng = np.random.default_rng(args.seed + 1)
    total = sum(len(v) for v in planned.values())
    while sum(len(v) for v in done.values()) < total:
        chunks: dict[str, dict] = {}
        for t, sids in fleet.active_sessions.items():
            store = fleet.group_of(t).engine.store
            for s in sids:
                sig = streams[t][int(s[1:])]
                pos = store.get(f"{t}/{s}").steps
                if pos >= len(sig):
                    continue
                n = (int(rng.integers(1, args.chunk_len + 1)) if args.ragged
                     else args.chunk_len)
                chunks.setdefault(t, {})[s] = sig[pos:pos + n]
        results = fleet.step(chunks)
        print(f"tick {fleet.tick:3d} | " + " ".join(
            f"{t}:{len(results.get(t, {}))}r q={fleet.queue.depth_of(t)} "
            f"done={len(done[t])}/{len(planned[t])}"
            for t in sorted(plans)))
        for t, sids in list(fleet.active_sessions.items()):
            store = fleet.group_of(t).engine.store
            for s in list(sids):
                if store.get(f"{t}/{s}").steps >= len(streams[t][int(s[1:])]):
                    sess = fleet.close(t, s)
                    done[t].add(s)
                    print(f"  {t}/{s}: served {sess.steps} steps in "
                          f"{sess.chunks} chunks")
        if args.snapshot_dir and fleet.tick % args.snapshot_every == 0:
            path = fleet.snapshot(args.snapshot_dir)
            checkpoint.keep_last(args.snapshot_dir, args.snapshot_keep)
            print(f"  snapshot -> {path}")

    agg = fleet.summarize()
    for t, sub in sorted(agg.get("tenants", {}).items()):
        print(f"{t}: {sub['ticks']} tick record(s) | tick p95 "
              f"{sub['duration_s_p95'] * 1e3:.2f}ms | p95 wait "
              f"{sub['queue_wait_s_p95'] * 1e3:.2f}ms | "
              f"dropped {sub['dropped']}")
    if args.metrics_out:
        fleet.metrics_sink.close()
        print(f"tick metrics -> {args.metrics_out}")
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", default=None, metavar="FLEET_JSON",
                    help="multi-tenant fleet mode: serve the tenant table "
                    "in this JSON file through one FleetEngine (see "
                    "load_fleet for the schema); the per-model flags are "
                    "ignored, the serving flags apply fleet-wide")
    ap.add_argument("--sessions", type=int, default=4,
                    help="store capacity: concurrently live streams")
    ap.add_argument("--overload", type=int, default=None,
                    help="total streams to serve (> --sessions exercises "
                    "the admission queue; default: --sessions)")
    ap.add_argument("--chunk-len", type=int, default=20)
    ap.add_argument("--beats", type=int, default=2,
                    help="ECG beats (T=140 each) per session stream")
    ap.add_argument("--samples", type=int, default=8, help="S MC chains")
    ap.add_argument("--backend", default="cuda_seq",
                    choices=("reference", "cuda_step", "cuda_seq"))
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "int8", "int4"),
                    help="serving precision: per-channel weight "
                    "quantization + bf16 activations (default: native "
                    "dtypes, fp32)")
    ap.add_argument("--cell", default="lstm", choices=("lstm", "gru"),
                    help="recurrent unit (paper §III-A: the GRU drops into "
                    "the same per-gate MCD design; h-only carried state)")
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--placement", default="YNY")
    ap.add_argument("--p", type=float, default=0.125)
    ap.add_argument("--ragged", action="store_true",
                    help="jitter chunk lengths per session per tick")
    ap.add_argument("--capacity", default="fixed",
                    choices=("fixed", "auto", "dynamic"),
                    help="launch-shape policy: fixed=--chunk-len, "
                    "auto=adaptive ladder, dynamic=per-tick max")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="admission-queue backpressure bound")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard every launch over N devices of --device's "
                    "kind (batch / data parallel, launch.rnn_shardings; "
                    "0 = no mesh): the first N cards, an error where there "
                    "are fewer; with --device cpu the CPU N times")
    ap.add_argument("--prewarm", action="store_true",
                    help="capture every capacity rung's tick graph at boot "
                    "(scheduler.prewarm) so no tick pays a first-use "
                    "capture; needs --capacity fixed or auto")
    ap.add_argument("--metrics-out", default=None,
                    help="append per-tick TickMetrics as JSON lines here")
    ap.add_argument("--controller", action="store_true",
                    help="run the online co-design controller: calibrate "
                    "the GPU roofline against observed ticks and "
                    "reconfigure S at tick boundaries to hold the SLO "
                    "(serve.controller)")
    ap.add_argument("--slo-p95-ms", type=float, default=50.0,
                    help="SLO: p95 tick latency bound in milliseconds")
    ap.add_argument("--min-tokens-per-sec", type=float, default=0.0,
                    help="SLO: minimum delivered chain-timesteps/sec (p50)")
    ap.add_argument("--decisions-out", default=None,
                    help="append controller DecisionRecords as JSON lines "
                    "(default: in-memory ring only)")
    ap.add_argument("--min-samples", type=int, default=1,
                    help="uncertainty floor: neither the controller nor "
                    "early exit ever takes a session below this many "
                    "chains")
    ap.add_argument("--early-exit-threshold", type=float, default=None,
                    metavar="DELTA",
                    help="retire a session's surplus MC chains once halving "
                    "them would move its uncertainty summary by at most "
                    "DELTA (default: off, every session keeps --samples).  "
                    "Incompatible with --shards.")
    ap.add_argument("--snapshot-dir", default=None,
                    help="durable session snapshots (crash-safe resume)")
    ap.add_argument("--snapshot-every", type=int, default=5,
                    help="snapshot cadence in ticks")
    ap.add_argument("--snapshot-keep", type=int, default=3,
                    help="snapshots retained (older ones pruned)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot in --snapshot-dir "
                    "and continue every stream where it left off")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain-PyTorch paths)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    total = args.overload or args.sessions
    if args.resume and not args.snapshot_dir:
        ap.error("--resume requires --snapshot-dir")
    if args.early_exit_threshold is not None and args.shards:
        ap.error("--early-exit-threshold is incompatible with --shards "
                 "(sharded launches need uniform chains per session)")
    if args.tenants and (args.controller or args.decisions_out):
        ap.error("--controller and --decisions-out drive the single-engine "
                 "path; a fleet's per-tenant loops are "
                 "serve.FleetController's, which --tenants does not run")

    device = resolve_device(args.device)
    if args.tenants:
        return run_fleet(args, device)
    cfg = clf.ClassifierConfig(
        hidden=args.hidden, num_layers=args.layers, cell=args.cell,
        mcd=mcd.MCDConfig(p=args.p, placement=args.placement,
                          n_samples=args.samples, seed=args.seed))
    params = clf.init(torch.Generator().manual_seed(args.seed), cfg,
                      device=device)
    capacity = {"fixed": args.chunk_len, "auto": "auto",
                "dynamic": None}[args.capacity]
    ladder = pow2_ladder(args.chunk_len) if capacity == "auto" else None
    mesh = None
    if args.shards:
        mesh = make_data_mesh(args.shards, device=device)
        print(f"sharding launches over {args.shards} devices (data axis): "
              f"{mesh}")
    sink = JsonlSink(args.metrics_out) if args.metrics_out else None
    eng = StreamingEngine(params, cfg, backend=args.backend,
                          max_sessions=args.sessions,
                          chunk_capacity=capacity, ladder=ladder,
                          max_pending=args.max_pending,
                          metrics_sink=sink, device=device, mesh=mesh,
                          precision=args.precision,
                          early_exit_threshold=args.early_exit_threshold,
                          min_samples=min(args.min_samples, args.samples))
    if args.prewarm:
        t0 = time.perf_counter()
        caps = prewarm(eng)
        print(f"prewarmed capacities {caps} in "
              f"{time.perf_counter() - t0:.2f}s")
    ctrl = None
    if args.controller:
        slo = SLOPolicy(p95_tick_s=args.slo_p95_ms / 1e3,
                        min_tokens_per_sec=args.min_tokens_per_sec,
                        min_samples=args.min_samples)
        trail = (JsonlSink(args.decisions_out) if args.decisions_out
                 else None)
        ctrl = CoDesignController(eng, slo, decision_sink=trail)
        print(f"controller on: SLO p95<={args.slo_p95_ms}ms "
              f"tokens/s>={args.min_tokens_per_sec} "
              f"S>={args.min_samples} | knobs S{list(ctrl.knobs.samples)}")
    # Streams are regenerated from their generation params, which ride the
    # snapshot; the per-stream cursor lives in the session (steps served).
    done: set[str] = set()
    if args.resume:
        extra = eng.restore(args.snapshot_dir)
        done = set(extra.get("done", []))
        gen = extra.get("gen")
        if gen and (gen["total"], gen["beats"]) != (total, args.beats):
            print(f"resume: adopting snapshot stream params "
                  f"total={gen['total']} beats={gen['beats']} "
                  f"(CLI values differ)")
        if gen:
            total, args.beats = int(gen["total"]), int(gen["beats"])
        print(f"resumed tick {eng.tick}: live={eng.active_sessions} "
              f"queued={eng.queued_sessions} done={sorted(done)}")
    streams, labels = build_streams(total, args.beats, args.seed)
    if not args.resume:
        # Admit everything up front: the first --sessions go live, the
        # rest wait in the queue (earlier streams at higher priority) and
        # go live as streams finish.
        for k in range(total):
            live = eng.admit(f"ecg-{k}", priority=total - k)
            print(f"admit ecg-{k}: "
                  f"{'live' if live is not None else 'queued'}")
    print(f"streaming {total} sessions ({args.sessions} live rows) x "
          f"{args.beats} beats "
          f"(T={ecg.T_STEPS} each) | S={args.samples} p={cfg.mcd.p} "
          f"B={mcd.placement_str(cfg.mcd.placement)} cell={args.cell} "
          f"backend={args.backend} device={device} "
          f"precision={args.precision or 'native'} "
          f"capacity={args.capacity}")

    rng = np.random.default_rng(args.seed + 1)
    while eng.active_sessions:
        chunks = {}
        for sid in eng.active_sessions:
            k = int(sid.split("-")[1])
            pos = eng.store.get(sid).steps
            n = (int(rng.integers(1, args.chunk_len + 1)) if args.ragged
                 else args.chunk_len)
            chunks[sid] = streams[k][pos:pos + n]
        results = eng.step(chunks)
        line = []
        for sid, res in sorted(results.items()):
            su = res.summary
            line.append(f"{sid}@{res.steps_total:4d} "
                        f"cls={int(torch.argmax(su.probs))} "
                        f"H={float(su.predictive_entropy):5.3f} "
                        f"MI={float(su.mutual_information):6.4f}")
        m = eng.last_metrics
        stat = (f"cap={m.capacity} q={m.queue_depth} launches={m.launches} "
                f"compiles={m.compiles} {m.duration_s * 1e3:.2f}ms")
        if args.early_exit_threshold is not None:
            stat += f" chains={m.active_chains}"
            if m.reclaimed_rows:
                stat += f" -{m.reclaimed_rows}"
        print(f"tick {m.tick:3d} [{stat}] | " + " | ".join(line))
        if ctrl is not None:
            rec = ctrl.maybe_reconfigure()
            if rec is not None:
                print(f"  controller[{rec.reason}] applied={rec.applied} "
                      f"winner={rec.winner} "
                      f"p95={rec.observed['duration_s_p95'] * 1e3:.2f}ms")
            eng = ctrl.engine       # maybe a prewarmed replacement
        for sid in list(eng.active_sessions):
            k = int(sid.split("-")[1])
            if eng.store.get(sid).steps >= len(streams[k]):
                sess = eng.close_session(sid)
                done.add(sid)
                print(f"{sid}: served {sess.steps} steps in {sess.chunks} "
                      f"chunks (beat labels {labels[k]})")
        if args.snapshot_dir and eng.tick % args.snapshot_every == 0:
            path = eng.snapshot(args.snapshot_dir, extra={
                "done": sorted(done),
                "gen": {"total": total, "beats": args.beats,
                        "seed": args.seed}})
            checkpoint.keep_last(args.snapshot_dir, args.snapshot_keep)
            print(f"  snapshot -> {path}")
    agg = summarize(eng.metrics)
    if not eng.metrics:
        print("nothing left to serve")
        return agg
    print(f"served {sum(m.live_steps for m in eng.metrics)} signal steps "
          f"over {agg['ticks']} ticks | launches {agg['launches']} | "
          f"compiles {agg['compiles']} | "
          f"pad waste {agg['pad_waste']:4.2f} | tick p50 "
          f"{agg['duration_s_p50'] * 1e3:.2f}ms p95 "
          f"{agg['duration_s_p95'] * 1e3:.2f}ms")
    if args.early_exit_threshold is not None:
        print(f"early exit: {agg['reclaimed_rows']} chain(s) retired | "
              f"mean active chains {agg['active_chains_mean']:.1f}")
    if ctrl is not None:
        n_applied = sum(1 for r in ctrl.decisions if r.applied)
        print(f"controller: {len(ctrl.decisions)} decision(s), "
              f"{n_applied} applied | final config {ctrl.config}")
        if args.decisions_out:
            ctrl.decision_sink.close()
            print(f"decision trail -> {args.decisions_out}")
    if args.metrics_out:
        eng.metrics_sink.close()
        print(f"tick metrics -> {args.metrics_out}")
    return agg


if __name__ == "__main__":
    main()
