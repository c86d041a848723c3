#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

Phases (each raises on failure; the exit code is then non-zero):

1. Device: print the card's name and power limit; build every CUDA kernel
   of the serving path from ``src/repro_torch/kernels/csrc`` with ``nvcc``
   for ``sm_90a`` (one ``nvcc`` per source, all started together).
2. Kernels: hold ``mcd_lstm_seq`` (CUDA) against ``mcd_lstm_seq_plain`` on
   the card, at the classifier's layer shapes (B = 64 sessions x 30 chains
   = 1920 rows, T = 140, I = 1 / 8, H = 8) and one wide layer (B = 256,
   T = 64, I = H = 128), with ragged lengths, non-zero h0/c0, student rows,
   p = 0.125 and p = 0: fp32 max abs error on ys, h_T, c_T within 1e-5,
   and the kernel's mask bits equal to the plain stream's.  Times the
   kernel, its plain version and, where one PyTorch call computes the same
   function (p = 0, no student rows, full lengths: cuDNN's LSTM through
   ``torch.nn.LSTM``), that call.
3. Serving: ``StreamingEngine`` on the card serves the ECG classifier at
   full width (I = 1, H = 8, NL = 3, placement YNY, p = 0.125, S = 30) for
   64 sessions over whole 140-step beats in ragged chunks of up to 20
   steps.  Checks that every tick launched the kernel once per layer, that
   chunked serving equals one unchunked pass (carried state bit for bit),
   and that the summaries agree with the port's "reference" backend.

Prints the ``kernels`` JSON line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): the
# kernel computes in fp32 on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 1e-5          # fp32: the kernel fuses multiply-adds the plain
                    # version rounds twice; the error stays ~1e-6 over T
SUMMARY_TOL = 1e-5  # engine (kernel) vs the reference backend (cuBLAS)

S, SESSIONS, T_BEAT, CHUNK = 30, 64, 140, 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_us(prof, match=None) -> float:
    """Device-kernel time (us) in a profile; only kernels whose name holds
    ``match`` when given.  CPU ops are skipped: they would count their
    kernels twice."""
    total = 0.0
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        if match is None or match in ev.key:
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total


def device_ms(fn, iters: int, match=None) -> float:
    """Device time per call (torch.profiler, CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _device_us(prof, match) / iters / 1e3


def layer_inputs(B, T, I, H, *, seed, students=True, ragged=True):
    import torch
    from repro_torch.core import mcd
    g = torch.Generator().manual_seed(seed)

    def r(*shape, k=1.0):
        return (torch.randn(shape, generator=g) * k).cuda()

    rows = torch.arange(B, dtype=torch.int64) + 1000
    if students:
        rows[::16] |= mcd.STUDENT_ROW_FLAG
    lens = (torch.randint(1, T + 1, (B,), generator=g) if ragged
            else torch.full((B,), T)).to(torch.int32)
    return dict(x=r(B, T, I), wx=r(I, 4, H, k=0.4), wh=r(H, 4, H, k=0.4),
                b=r(4, H, k=0.1), rows=rows.cuda(), h0=r(B, H, k=0.5),
                c0=r(B, H, k=0.5), lengths=lens.cuda())


def bound(d, p) -> tuple[float, str]:
    """Least time (ms) for one launch on these inputs: bytes each input read
    once and each output written once, over HBM; operations over the fp32
    peak.  Only the live steps (t < length) need x and compute."""
    B, T, I = d["x"].shape
    H = d["wh"].shape[0]
    live = int(d["lengths"].clamp(max=T).sum())
    nbytes = 4 * (live * I + 4 * H * (I + H) + 4 * H + 2 * B
                  + 2 * B * H + B * T * H + 2 * B * H)
    per_step = H * (8 * (I + H) + 4 + 15)      # gate products, bias, tail
    if p > 0:
        per_step += 4 * (I + H)                # the masked views
    flops = live * per_step
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_ms(d) -> tuple[float, float, float]:
    """cuDNN's LSTM (one torch.nn.LSTM call) on the same inputs at p = 0,
    full lengths, no student rows; returns (call ms, device ms, max abs
    diff to the kernel)."""
    import torch
    from repro_torch.kernels import mcd_lstm, mcd_lstm_seq as seq
    B, T, I = d["x"].shape
    H = d["wh"].shape[0]
    lstm = torch.nn.LSTM(I, H, batch_first=True).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(d["wx"].permute(1, 2, 0).reshape(4 * H, I))
        lstm.weight_hh_l0.copy_(d["wh"].permute(1, 2, 0).reshape(4 * H, H))
        lstm.bias_ih_l0.copy_(d["b"].reshape(-1))
        lstm.bias_hh_l0.zero_()
    state = (d["h0"][None].contiguous(), d["c0"][None].contiguous())

    def call():
        with torch.no_grad():
            return lstm(d["x"], state)

    ys_lib, _ = call()
    ys, _, _ = seq.mcd_lstm_seq(d["x"], d["wx"], d["wh"], d["b"], d["rows"],
                                mcd_lstm.gate_keys(0, 0), 0.0, h0=d["h0"],
                                c0=d["c0"])
    diff = (ys_lib - ys).abs().max().item()
    return cuda_time_ms(call, iters=20), device_ms(call, 10), diff


def kernel_phase(report):
    import torch
    from repro_torch.kernels import mcd_lstm, mcd_lstm_seq as seq
    # (B, T, I, H, p) — the classifier's three layers (YNY: layer 1 runs
    # unmasked), then both p for each, then the wide coverage layer.
    main = [(1920, T_BEAT, 1, 8, 0.125), (1920, T_BEAT, 8, 8, 0.0),
            (1920, T_BEAT, 8, 8, 0.125)]
    cases = main + [(1920, T_BEAT, 1, 8, 0.0), (1920, CHUNK, 1, 8, 0.125),
                    (1920, CHUNK, 8, 8, 0.0), (1920, CHUNK, 8, 8, 0.125),
                    (256, 64, 128, 128, 0.125), (256, 64, 128, 128, 0.0)]
    rows_out, worst = [], 0.0
    for n, (B, T, I, H, p) in enumerate(cases):
        d = layer_inputs(B, T, I, H, seed=n)
        keys = mcd_lstm.gate_keys(7, n)
        args = (d["x"], d["wx"], d["wh"], d["b"], d["rows"], keys, p)
        kw = dict(h0=d["h0"], c0=d["c0"], lengths=d["lengths"])
        got = seq.mcd_lstm_seq(*args, **kw)
        torch.cuda.synchronize()
        ref = seq.mcd_lstm_seq_plain(*args, **kw)
        errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
        if not all(torch.isfinite(g).all() for g in got):
            raise RuntimeError(f"non-finite kernel output at {B,T,I,H,p}")
        err = max(errs)
        if err > TOL:
            raise RuntimeError(f"mcd_lstm_seq disagrees with its plain "
                               f"version at B={B} T={T} I={I} H={H} p={p}: "
                               f"max abs err {errs} > {TOL}")
        worst = max(worst, err)
        kx, kh = seq.kernel_mask_factors(keys, d["rows"], I, H, p)
        px, ph = seq.gate_mask_factors(keys, d["rows"], I, H, p)
        if not (torch.equal(kx, px) and torch.equal(kh, ph)):
            raise RuntimeError(f"kernel mask bits differ from the plain "
                               f"stream at B={B} I={I} H={H} p={p}")
        rec = dict(B=B, T=T, I=I, H=H, p=p, max_abs_err=err,
                   mask_bits_equal=True)
        # Timed as the stack calls it: int32 rows and lengths converted
        # once per stack, the 8 keys as host ints.
        kargs = (d["x"], d["wx"], d["wh"], d["b"],
                 seq.rows_to_int32(d["rows"]),
                 tuple(keys.reshape(-1).tolist()), p)

        def launch():
            return seq.mcd_lstm_seq(*kargs, **kw)

        rec["kernel_ms"] = cuda_time_ms(launch, iters=20, warmup=2)
        rec["kernel_device_ms"] = device_ms(launch, 10,
                                            "mcd_lstm_seq_kernel")
        rec["plain_ms"] = cuda_time_ms(
            lambda: seq.mcd_lstm_seq_plain(*args, **kw), iters=2, warmup=0)
        rec["bound_ms"], rec["bound_by"] = bound(d, p)
        if p == 0.0:
            dl = layer_inputs(B, T, I, H, seed=n, students=False,
                              ragged=False)
            (rec["library_ms"], rec["library_device_ms"],
             rec["library_max_abs_diff"]) = library_ms(dl)
        rows_out.append(rec)
        print("kernel case " + json.dumps(rec), flush=True)
    report["kernel_cases"] = rows_out
    # One full-beat classifier pass: the three main-path layer launches.
    main_recs = rows_out[:3]
    lib3, lib3_device = classifier_library_ms()
    entry = {
        "name": "mcd_lstm_seq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mcd_lstm_seq.cu",
        "replaces": "src/repro/kernels/mcd_lstm_seq.py:133",
        "shape": "classifier pass: 3 layers, B=1920 (64 sessions x S=30), "
                 "T=140, I=1/8/8, H=8, p=0.125/0/0.125, ragged lengths",
        "launches": None,
        "max_abs_err": worst,
        "ms": sum(r["kernel_ms"] for r in main_recs),
        "device_ms": sum(r["kernel_device_ms"] for r in main_recs),
        "plain_ms": sum(r["plain_ms"] for r in main_recs),
        "bound_ms": sum(r["bound_ms"] for r in main_recs),
        "bound_by": main_recs[0]["bound_by"],
        "library_ms": lib3,
        "library_device_ms": lib3_device,
    }
    entry["kernel_ms"] = entry["ms"]
    return entry


def classifier_library_ms() -> tuple[float, float]:
    """One 3-layer cuDNN torch.nn.LSTM call at the classifier's shapes
    (p = 0, full lengths), the yardstick for one full-beat pass: (call ms,
    device ms)."""
    import torch
    lstm = torch.nn.LSTM(1, 8, num_layers=3, batch_first=True).cuda()
    x = torch.randn(1920, T_BEAT, 1, device="cuda")

    def call():
        with torch.no_grad():
            return lstm(x)
    return cuda_time_ms(call, iters=20, warmup=2), device_ms(call, 10)


def serving_phase(report, dev):
    import numpy as np
    import torch
    from repro_torch.core import classifier as clf, mcd
    from repro_torch.data import ecg
    from repro_torch.kernels import mcd_lstm_seq as seq
    from repro_torch.launch.stream import build_streams
    from repro_torch.serve import StreamingEngine, summarize

    cfg = clf.ClassifierConfig(
        input_dim=1, hidden=8, num_layers=3, num_classes=4,
        mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=S, seed=0))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    streams, _ = build_streams(SESSIONS, 1, seed=0)
    if any(len(s) != T_BEAT for s in streams) or ecg.T_STEPS != T_BEAT:
        raise RuntimeError("ECG beats are not 140 steps long")
    eng = StreamingEngine(params, cfg, backend="cuda_seq",
                          max_sessions=SESSIONS, chunk_capacity=CHUNK,
                          device=dev)
    sids = [f"ecg-{k}" for k in range(SESSIONS)]
    for sid in sids:
        eng.open_session(sid)
    rng = np.random.default_rng(1)
    final = {}
    seq.mcd_lstm_seq.launches = 0            # count the main path only
    while len(final) < SESSIONS:
        chunks = {}
        for k, sid in enumerate(sids):
            pos = eng.store.get(sid).steps
            if pos < T_BEAT:
                n = int(rng.integers(1, CHUNK + 1))
                chunks[sid] = streams[k][pos:pos + n]
        for sid, res in eng.step(chunks).items():
            if res.steps_total == T_BEAT:
                final[sid] = res.summary
    launches = seq.mcd_lstm_seq.launches
    metrics = eng.metrics
    bad = [m.tick for m in metrics if m.launches != cfg.num_layers]
    if bad or launches != cfg.num_layers * len(metrics):
        raise RuntimeError(f"ticks {bad} did not launch the kernel once per "
                           f"layer ({launches} launches, {len(metrics)} "
                           "ticks)")

    # One unchunked pass over the whole beats, same rows, kernel backend.
    x = torch.from_numpy(np.concatenate(
        [np.repeat(s[None], S, 0) for s in streams])).to(dev)
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(sid).rows for sid in sids]).astype(np.int64)).to(dev)
    full = torch.full((len(rows),), T_BEAT, device=dev)
    logits, states = clf.apply(params, x, rows, cfg, backend="cuda_seq",
                               lengths=full, return_state=True, device=dev)
    for li, (h, c) in enumerate(states):
        for k, sid in enumerate(sids):
            sh, sc = eng.store.get(sid).state[li]
            if not (torch.equal(sh, h[k * S:(k + 1) * S])
                    and torch.equal(sc, c[k * S:(k + 1) * S])):
                raise RuntimeError(f"chunked != unchunked for {sid} at "
                                   f"layer {li}")
    ref_logits = clf.apply(params, x, rows, cfg, backend="reference",
                           lengths=full, device=dev)
    from repro_torch.core.uncertainty import classification_summary
    per = lambda lg: classification_summary(  # noqa: E731
        lg.reshape(SESSIONS, S, -1).transpose(0, 1))
    unchunked, reference = per(logits), per(ref_logits)
    d_unchunked = d_ref = 0.0
    for k, sid in enumerate(sids):
        for v, u, r in zip(final[sid], unchunked, reference):
            if not torch.isfinite(v).all():
                raise RuntimeError(f"non-finite summary for {sid}")
            d_unchunked = max(d_unchunked, (v - u[k]).abs().max().item())
            d_ref = max(d_ref, (v - r[k]).abs().max().item())
    if d_ref > SUMMARY_TOL or d_unchunked > SUMMARY_TOL:
        raise RuntimeError(f"summaries disagree: vs reference {d_ref}, "
                           f"vs unchunked {d_unchunked} (tol {SUMMARY_TOL})")
    probs = torch.stack([final[s].probs for s in sids])
    if probs.shape != (SESSIONS, 4) or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-5:
        raise RuntimeError(f"bad class probabilities {probs.shape}")
    agg = summarize(metrics)
    serve = {
        "card": report["card"], "sessions": SESSIONS, "chains": S,
        "rows": SESSIONS * S,
        "ticks": agg["ticks"], "launches": launches,
        "tick_ms_p50": agg["duration_s_p50"] * 1e3,
        "tick_ms_p95": agg["duration_s_p95"] * 1e3,
        "chain_steps_per_s": agg["tokens_per_sec"],
        "pad_waste": agg["pad_waste"],
        "summary_diff_vs_reference": d_ref,
        "summary_diff_vs_unchunked": d_unchunked,
    }
    serve.update(profile_ticks(params, cfg, streams, dev))
    report["serving"] = serve
    print("serving " + json.dumps(serve), flush=True)
    return launches


def profile_ticks(params, cfg, streams, dev, n_ticks: int = 5) -> dict:
    """Device time inside a few serving ticks (torch.profiler, CUDA
    activity): the kernel's share and the device's idle share of the
    tick's wall time.  Runs a fresh engine; not part of the launch count.
    """
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import StreamingEngine
    eng = StreamingEngine(params, cfg, max_sessions=SESSIONS,
                          chunk_capacity=CHUNK, device=dev)
    sids = [f"p{k}" for k in range(SESSIONS)]
    for sid in sids:
        eng.open_session(sid)
    rng = np.random.default_rng(2)

    def tick():
        eng.step({sid: streams[k][eng.store.get(sid).steps:][
            :int(rng.integers(1, CHUNK + 1))] for k, sid in enumerate(sids)})

    tick()                                   # warm: allocator, cuBLAS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = _device_us(prof)
    kern_us = _device_us(prof, "mcd_lstm_seq_kernel")
    return {"profiled_ticks": n_ticks,
            "profiled_tick_ms": wall_us / n_ticks / 1e3,
            "device_busy_ms_per_tick": dev_us / n_ticks / 1e3,
            "kernel_ms_per_tick": kern_us / n_ticks / 1e3,
            "device_idle_share": (1.0 - dev_us / wall_us) if dev_us else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    logs = build.build_all(["mcd_lstm_seq"])
    report["build_s"] = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"nvcc {name}.cu ({report['build_s']:.1f}s):\n{log.strip()}",
              flush=True)
    entry = kernel_phase(report)
    entry["launches"] = serving_phase(report, torch.device("cuda"))
    report["kernels"] = [entry]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
