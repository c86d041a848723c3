"""Multi-pod dry run: count every (arch × shape) on the production mesh and
record roofline terms — port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for a forced 256- or
512-device host mesh and reads XLA's cost and memory analyses.  The port
has no compiler and no partitioner.  For each cell it

* counts the whole step once (``launch.analysis.count`` on full-width
  fake tensors: shapes and dtypes, no storage).  The count sees every op
  of one program that covers every chip (no while body is undercounted),
  so per device it is divided by ``chips``: an *ideal partition*;
* counts the reference's probes (``launch.specs.probe_jobs``) and composes
  Σ body × repeat + head (+ opt), beside the whole-step count;
* prices the per-device residency of params, optimizer state and caches
  from the spec trees under ``specs.make_policy`` (``shardings.shard_bytes``,
  the counterpart of ``memory_analysis()``);
* adds the per-device step terms of the H100 model
  (``dse.gpu_model.step_model``) under the same policy: the collective
  bytes come from that model only.

Both counts run under the probes' attention tiling (``specs._attn_blocks_for``,
≤ 64 bodies a layer): the blockwise attention computes every block, so
its flops do not depend on the tiling; its unfused bytes do.

``--measure`` builds each probe's arguments for real on a device (CUDA
unless ``--device cpu``), runs and counts each with the same counter
(the count must equal the fake-tensor count exactly) and times it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod --out results.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --measure
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.dse import gpu_model
from repro_torch.launch import analysis, mesh as mesh_lib, shardings, specs
from repro_torch.launch.hillclimb import variant_ctx
from repro_torch.models import layers
from repro_torch.models.config import SHAPES, shape_applicable

OPTS = ("moe_group", "seqpar", "kv8")


def hw_for(mesh, cfg, microbatches: int = 1) -> gpu_model.GpuHwConfig:
    """The H100 model's hardware point for ``specs.make_policy``'s layout."""
    po = specs.make_policy(mesh, cfg)
    axes = po.axes
    return gpu_model.GpuHwConfig(data=axes.get("data", 1),
                                 model=axes.get("model", 1),
                                 pod=axes.get("pod", 1),
                                 microbatches=microbatches, fsdp=po.fsdp)


def residency(job, counts, cfg, mesh, kv_quant: bool = False) -> dict:
    """Per-device bytes of params, optimizer state and decode caches under
    the job's spec trees (an ideal layout over the mesh's axes)."""
    po = specs.make_policy(mesh, cfg)
    axes = po.axes
    params = job.args[0]
    out = {"params": shardings.shard_bytes(
        params, shardings.param_specs(cfg, po), axes)}
    if job.kind == "train":
        opt = job.args[1]
        out["opt_state"] = shardings.shard_bytes(
            opt._replace(m=shardings.stacked(opt.m),
                         v=shardings.stacked(opt.v)), job.in_specs[1], axes)
    else:
        state = job.args[2] if job.kind == "decode" else counts.out[1]
        batch = job.args[1].shape[0] if job.kind == "decode" else \
            job.args[1]["tokens"].shape[0]
        out["caches"] = shardings.shard_bytes(
            state, shardings.cache_specs(cfg, po, batch, kv_quant), axes)
    out["total"] = sum(out.values())
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             microbatches: int = 1, verbose: bool = True,
             probes: bool = True, opts: tuple = ()) -> dict:
    cfg = get_config(arch)
    record = {"arch": arch, "shape": shape,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "kind": SHAPES[shape].kind, "opts": list(opts)}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        return record
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    cell = SHAPES[shape]
    kv8 = "kv8" in opts and cell.kind == "decode"
    t0 = time.time()
    try:
        with variant_ctx(set(opts), mesh), layers.attention_override(
                **specs._attn_blocks_for(cell.seq_len)):
            job = specs.make_job(cfg, shape, mesh,
                                 microbatches=microbatches, kv_quant=kv8)
            t_build = time.time() - t0
            whole = analysis.count(job.fn, *job.args)
        t_count = time.time() - t0 - t_build
        mf = analysis.model_flops(cfg, cell, chips)
        hw = hw_for(mesh, cfg, microbatches)
        model = gpu_model.step_model(cfg, cell, hw)
        record.update({
            "status": "ok",
            "chips": chips,
            "build_s": round(t_build, 2),
            "count_s": round(t_count, 2),
            "whole_flops": whole.flops,
            "whole_bytes": whole.bytes,
            "whole_ops": whole.ops,
            "raw_flops_per_device": whole.flops / chips,
            "raw_bytes_per_device": whole.bytes / chips,
            "per_device": "ideal partition: the whole program / chips",
            "model_flops_per_device": mf,
            "memory": residency(job, whole, cfg, mesh, kv8),
            "gpu_model": {**model, "hw": dataclasses.asdict(hw),
                          "memory": gpu_model.memory_model(cfg, cell, hw)},
        })
        del job
        if probes:
            record.update(run_probes(cfg, shape, mesh, opts=opts,
                                     coll=model["coll"]))
            record["useful_flops_ratio"] = (
                mf / record["flops_per_device"]
                if record.get("flops_per_device") else 0.0)
            record["composition_vs_whole"] = {
                "flops": record["composition_flops"] / max(whole.flops, 1),
                "bytes": record["composition_bytes"] / max(whole.bytes, 1)}
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    if verbose:
        s = record["status"]
        extra = (f" bottleneck={record.get('bottleneck')}"
                 f" t=({record.get('t_compute', 0):.3e},"
                 f"{record.get('t_memory', 0):.3e},"
                 f"{record.get('t_collective', 0):.3e})s"
                 if s == "ok" else record.get("reason", record.get("error", "")))
        print(f"[dryrun] {arch} × {shape} × {record['mesh']}: {s}{extra}",
              flush=True)
    return record


def run_probes(cfg, shape: str, mesh, opts: tuple = (), *,
               coll: float = 0.0) -> dict:
    """Count the per-block probes and compose the roofline (Σ body ×
    repeat + head + opt), per device over ``chips`` (an ideal partition);
    ``coll``: the per-device collective bytes of the H100 model."""
    cell = SHAPES[shape]
    chips = mesh.size
    tot = {"flops": 0, "bytes": 0}
    details = []
    with variant_ctx(set(opts), mesh), layers.attention_override(
            **specs._attn_blocks_for(cell.seq_len)):
        for pr in specs.probe_jobs(cfg, shape, mesh, kv_quant="kv8" in opts):
            c = analysis.count(pr.fn, *pr.args)
            tot["flops"] += c.flops * pr.multiplier
            tot["bytes"] += c.bytes * pr.multiplier
            details.append({"probe": pr.name, "multiplier": pr.multiplier,
                            "flops": c.flops, "bytes": c.bytes,
                            "ops": c.ops})
    roof = analysis.roofline(tot["flops"] / chips, tot["bytes"] / chips,
                             coll)
    return {
        "composition_flops": tot["flops"],
        "composition_bytes": tot["bytes"],
        "flops_per_device": roof.flops,
        "bytes_per_device": roof.bytes_hbm,
        "collective_bytes_per_device": coll,
        "t_compute": roof.t_compute, "t_memory": roof.t_memory,
        "t_collective": roof.t_collective,
        "bottleneck": roof.bottleneck,
        "roofline_fraction": roof.roofline_fraction(),
        "probes": details,
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, args, dev, iters: int = 3) -> float:
    """Mean ms of ``fn(*args)`` after one warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    fn(*args)
    _sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t) * 1e3 / iters


def measure_probes(arch: str, shape: str, *, multi_pod: bool = False,
                   batch: int | None = None, device=None, opts: tuple = (),
                   iters: int = 3) -> list:
    """Each probe of the cell, built for real on ``device`` (default CUDA)
    at full width (``batch`` cuts the cell's batch): counted there with the
    fake-tensor count's counter, the two counts compared (``equal``), and
    timed (``ms``: CUDA events on a card) beside two roofline times at
    ``analysis``'s peaks: ``bound_ms`` from the counted flops and the
    bytes of the probe's inputs and outputs (``analysis.io_bytes``: the
    least the card could take), and ``t_unfused_ms`` from the counted
    flops and the counted, unfused bytes (the plain path's own traffic,
    no bound)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    cell = SHAPES[shape]
    kv8 = "kv8" in opts
    out = []
    with variant_ctx(set(opts), mesh), layers.attention_override(
            **specs._attn_blocks_for(cell.seq_len)):
        # fake tensors made for the same device: a count on the card also
        # sees the mask keys' host-to-device copies (2 ops of 16 bytes a
        # masked site), which a count for the CPU has no reason to make
        fakes = specs.probe_jobs(cfg, shape, mesh, kv8, batch=batch,
                                 device=dev)
        reals = specs.probe_jobs(cfg, shape, mesh, kv8, batch=batch,
                                 device=dev, fake=False)
        for k, fk in enumerate(fakes):
            real, reals[k] = reals[k], None
            want = analysis.count(fk.fn, *fk.args)
            got = analysis.count(real.fn, *real.args)
            _sync(dev)
            io = analysis.io_bytes(real.args, got.out)
            del got.out
            ms = time_ms(real.fn, real.args, dev, iters)
            roof = got.roofline()
            floor = analysis.roofline(float(got.flops), float(io))
            out.append({
                "probe": real.name, "multiplier": real.multiplier,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "batch": batch or cell.global_batch,
                "fake": {"flops": want.flops, "bytes": want.bytes,
                         "ops": want.ops},
                "real": {"flops": got.flops, "bytes": got.bytes,
                         "ops": got.ops},
                "equal": (want.flops, want.bytes, want.ops)
                == (got.flops, got.bytes, got.ops),
                "ms": ms, "io_bytes": io,
                "bound_ms": floor.t_bound * 1e3,
                "bound_by": floor.bottleneck,
                "t_unfused_ms": roof.t_bound * 1e3,
                "unfused_by": roof.bottleneck})
            del real
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ALIASES))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-probes", action="store_true",
                    help="whole-step count only (skip the probe "
                         "composition)")
    ap.add_argument("--opt", action="append", default=[], choices=OPTS,
                    help="optimization variants (§Perf)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--measure", action="store_true",
                    help="also build each probe on --device, count and "
                         "time it")
    ap.add_argument("--device", default=None,
                    help="--measure's device: cuda (default) or cpu; the "
                         "dry run itself runs on fake tensors")
    ap.add_argument("--batch", type=int, default=None,
                    help="--measure: cut the cell's batch to this")
    args = ap.parse_args(argv)
    if args.measure:
        resolve_device(args.device)

    cells = []
    archs = sorted(ALIASES) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))

    records = []
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, microbatches=args.microbatches,
                       probes=not args.no_probes, opts=tuple(args.opt))
        if args.measure and rec["status"] == "ok":
            try:
                rec["measured"] = measure_probes(
                    arch, shape, multi_pod=mp, batch=args.batch,
                    device=args.device, opts=tuple(args.opt))
                for m in rec["measured"]:
                    print(f"[measure] {m['probe']:28s} x{m['multiplier']:3d}"
                          f" {m['ms']:.3f} ms (bound {m['bound_ms']:.3f},"
                          f" {m['bound_by']}; unfused count "
                          f"{m['t_unfused_ms']:.3f}) counts equal: "
                          f"{m['equal']}",
                          flush=True)
                if not all(m["equal"] for m in rec["measured"]):
                    raise RuntimeError("a probe's count on the device "
                                       "differs from its fake count")
            except Exception as e:  # noqa: BLE001 — reported as a record
                rec["status"] = "error"
                rec["error"] = f"measure: {type(e).__name__}: {e}"
                rec["traceback"] = traceback.format_exc()[-2000:]
        records.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = len(records) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
