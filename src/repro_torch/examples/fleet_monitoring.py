"""Hospital-fleet monitoring: heterogeneous Bayesian RNN tenants, one
engine — port of ``examples/fleet_monitoring.py``.

Three tenants with different models, tasks and priorities go through a
single ``repro_torch.serve.FleetEngine``:

* ``ward``   — the paper's Bayesian LSTM beat classifier (weight 3);
* ``anom``   — a GRU autoencoder scoring reconstruction uncertainty, with
  a ``decode_window`` so each chunk replays only the last W steps
  (weight 1);
* ``edge``   — the classifier again, int8-quantized (weight 1).

Every tenant submits more streams than its row quota, so admission runs
through the shared weighted-fair queue.  Mid-run the fleet is snapshotted,
thrown away and restored into a fresh fleet (kill / resume).  The demo
then checks that a tracked stream of every tenant is bit-identical to a
solo ``StreamingEngine`` serving the same signal, and that while every
tenant is backlogged the weight-3 tenant takes the largest admission
share.

    PYTHONPATH=src python -m repro_torch.examples.fleet_monitoring
    PYTHONPATH=src python -m repro_torch.examples.fleet_monitoring --smoke
    PYTHONPATH=src python -m repro_torch.examples.fleet_monitoring \\
        --smoke --device cpu

The backend defaults to ``cuda_seq`` where the reference's is
``pallas_seq``; the reference's names are taken and mapped to the port's
(``pallas_seq`` -> ``cuda_seq``, ``pallas_step`` -> ``cuda_step``), as
``launch.stream.load_fleet`` maps them.  Weights are random, from CPU
``torch.Generator``s seeded 0 and 1.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import autoencoder as ae, classifier as clf, mcd
from repro_torch.data import ecg
from repro_torch.launch.stream import REFERENCE_BACKENDS
from repro_torch.serve import FleetEngine, StreamingEngine, TenantSpec

WINDOW = 16          # anom's decode_window (replay only the last W steps)


def make_specs(backend: str, samples: int, device):
    cfg_ward = clf.ClassifierConfig(
        hidden=8, num_layers=2, num_classes=ecg.NUM_CLASSES,
        mcd=mcd.MCDConfig(p=0.125, placement="YN", n_samples=samples,
                          seed=0))
    cfg_anom = ae.AutoencoderConfig(
        hidden=8, num_layers=1, cell="gru", decode_window=WINDOW,
        mcd=mcd.MCDConfig(p=0.125, placement="Y",
                          n_samples=max(2, samples // 2), seed=1))
    p_clf = clf.init(torch.Generator().manual_seed(0), cfg_ward,
                     device=device)
    p_anom = ae.init(torch.Generator().manual_seed(1), cfg_anom,
                     device=device)
    return [
        TenantSpec(name="ward", cfg=cfg_ward, params=p_clf, weight=3.0,
                   max_sessions=4, backend=backend),
        TenantSpec(name="anom", cfg=cfg_anom, params=p_anom, weight=1.0,
                   max_sessions=3, backend=backend),
        TenantSpec(name="edge", cfg=cfg_ward, params=p_clf, weight=1.0,
                   max_sessions=2, backend=backend, precision="int8"),
    ]


def make_streams(counts: dict[str, int], seed: int = 7):
    """Per-tenant synthetic patients: one ECG5000-compatible beat each."""
    _, _, ex, _ = ecg.make_ecg5000(seed)
    rng = np.random.default_rng(seed)
    return {t: [ex[i] for i in rng.integers(0, len(ex), size=n)]
            for t, n in counts.items()}


def build_fleet(args, specs, device):
    return FleetEngine(specs, admit_per_tick=args.admit_per_tick,
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--patients", type=int, default=1000,
                    help="total synthetic patients across the fleet")
    ap.add_argument("--samples", type=int, default=4, help="S MC chains")
    ap.add_argument("--chunk-len", type=int, default=35)
    ap.add_argument("--backend", default="cuda_seq",
                    choices=("reference", "cuda_step", "cuda_seq",
                             *REFERENCE_BACKENDS))
    ap.add_argument("--admit-per-tick", type=int, default=4,
                    help="fleet-wide admission budget per tick (the "
                    "weighted-fair queue rations it 3:1:1)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: a handful of patients, short streams")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.patients, args.chunk_len, args.admit_per_tick = 20, 70, 2
    backend = REFERENCE_BACKENDS.get(args.backend, args.backend)

    specs = make_specs(backend, args.samples, dev)
    counts = {"ward": args.patients // 2,
              "anom": args.patients * 3 // 10,
              "edge": args.patients - args.patients // 2
              - args.patients * 3 // 10}
    streams = make_streams(counts)
    fleet = build_fleet(args, specs, dev)
    print(f"fleet: {len(fleet.groups)} launch group(s) for "
          f"{len(specs)} tenants on {dev} ({backend}) | " + " ".join(
              f"{s.name}[w={s.weight:g} rows={s.max_sessions} "
              f"patients={counts[s.name]}]" for s in specs))

    for t in sorted(counts):
        for k in range(counts[t]):
            fleet.admit(t, f"s{k}", priority=counts[t] - k)
    backlog0 = {t: fleet.queue.depth_of(t) for t in counts}
    print(f"admitted everything into the shared queue: backlog {backlog0}")

    kill_tick = 3
    fair_rounds, fair_admitted = 0, None    # ledger while ALL backlogged
    done = {t: 0 for t in counts}
    total = sum(counts.values())
    snap_dir = tempfile.mkdtemp(prefix="fleet_snap_")

    while sum(done.values()) < total:
        if fleet.tick == kill_tick:
            path = fleet.snapshot(snap_dir)
            print(f"tick {fleet.tick}: KILL -- snapshot -> {path}")
            del fleet                                   # the crash
            fleet = build_fleet(args, specs, dev)       # a fresh fleet
            fleet.restore(snap_dir)
            live = {t: len(v) for t, v in fleet.active_sessions.items()}
            print(f"RESUME: tick {fleet.tick} restored, live={live}, "
                  f"queue={ {t: fleet.queue.depth_of(t) for t in counts} }")

        chunks: dict[str, dict[str, np.ndarray]] = {}
        for t, sids in fleet.active_sessions.items():
            store = fleet.group_of(t).engine.store
            for s in sids:
                sig = streams[t][int(s[1:])]
                pos = store.get(f"{t}/{s}").steps
                if pos < len(sig):
                    chunks.setdefault(t, {})[s] = \
                        sig[pos:pos + args.chunk_len]
        fleet.step(chunks)
        if all(fleet.queue.depth_of(t) > 0 for t in counts):
            # Every tenant still has waiting streams: the weighted drain
            # alone rations rows now.
            fair_rounds += 1
            fair_admitted = dict(fleet.queue.state()["admitted"])
        for t, sids in list(fleet.active_sessions.items()):
            store = fleet.group_of(t).engine.store
            for s in list(sids):
                if store.get(f"{t}/{s}").steps >= len(
                        streams[t][int(s[1:])]):
                    fleet.close(t, s)
                    done[t] += 1
        if fleet.tick % 10 == 0 or sum(done.values()) == total:
            print(f"tick {fleet.tick:4d} | " + " ".join(
                f"{t}: done {done[t]}/{counts[t]} "
                f"q={fleet.queue.depth_of(t)}" for t in sorted(counts)))

    if fair_admitted:
        share = {t: fair_admitted[t] / sum(fair_admitted.values())
                 for t in fair_admitted}
        print(f"\nadmissions while every tenant was backlogged "
              f"({fair_rounds} tick(s)): {fair_admitted} "
              f"shares={ {t: round(v, 3) for t, v in share.items()} } "
              f"(weights 3:1:1 -> 0.6:0.2:0.2)")
        assert share["ward"] > share["anom"] and \
            share["ward"] > share["edge"], \
            "the weight-3 tenant must take the largest admission share"

    heterogeneity_pin(specs, streams, args, dev)
    print("\nfleet demo OK: heterogeneous tenants co-served, kill/resume "
          "survived, weighted shares honored, solo bit-identity held")
    return done


def heterogeneity_pin(specs, streams, args, dev):
    """Fleet-served stream s0 of every tenant == a solo engine, bit for bit.

    The fleet co-batches each tenant with the others; the solo engine does
    not.  Masks are functions of (seed, rows) and the chunk boundaries are
    the same ``--chunk-len`` grid, so the outputs must match exactly.
    """
    print("\nheterogeneity pin: tenant s0 vs solo single-tenant engine")
    fleet = FleetEngine(specs, admit_per_tick=None, device=dev)
    for s in specs:
        fleet.admit(s.name, "s0")
    finals: dict[str, object] = {}
    live = True
    while live:
        chunks = {}
        for s in specs:
            sig = streams[s.name][0]
            store = fleet.group_of(s.name).engine.store
            if f"{s.name}/s0" not in store.active:
                continue
            pos = store.get(f"{s.name}/s0").steps
            if pos >= len(sig):
                continue
            chunks[s.name] = {"s0": sig[pos:pos + args.chunk_len]}
        live = bool(chunks)
        if live:
            for t, res in fleet.step(chunks).items():
                finals[t] = res["s0"]

    for s in specs:
        solo = StreamingEngine(s.params, s.resolved_cfg(), backend=s.backend,
                               precision=s.precision, max_sessions=1,
                               device=dev)
        solo.open_session("s0")
        sig = streams[s.name][0]
        want = None
        for a in range(0, len(sig), args.chunk_len):
            want = solo.step({"s0": sig[a:a + args.chunk_len]})["s0"]
        got = finals[s.name]
        if hasattr(got.summary, "probs"):
            same = torch.equal(got.summary.probs, want.summary.probs)
        else:
            same = (torch.equal(got.summary.mean, want.summary.mean)
                    and got.summary.mean.shape[0] <= WINDOW)
        print(f"  {s.name} (S={s.resolved_cfg().mcd.n_samples}, "
              f"precision={s.precision or 'native'}): "
              f"bit-identical={same}")
        assert same, f"{s.name}: fleet serving diverged from solo serving"


if __name__ == "__main__":
    main()
