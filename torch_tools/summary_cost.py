"""The cost of the ECG tick's chain-axis summaries in two checkouts'
``core/uncertainty.py``, timed in turns in one process.

Loads ``src/repro_torch/core/uncertainty.py`` of PARENT and of CHANGE by
path (the module imports only numpy and torch) and calls
``classification_summary`` and ``regression_summary`` as
``StreamingEngine.step`` does on a uniform tick of 64 sessions x S = 30:
a transposed fp32 view of the [sessions, S, ...] outputs, the
classifier's logits [1920, 4] and the autoencoder's means and log
variances [1920, 20, 1] (capacity 20).  For each side: host ms a call (a
loop of calls, synced at its end), and, from ``torch.profiler``, the
kernels a call launches and their device ms.  The sides run in turns,
parent, change, change, parent, ROUNDS times over.  The largest
difference between the two sides' summaries is reported beside.

Usage, on a machine with the card::

    python torch_tools/summary_cost.py PARENT CHANGE OUT.json
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

SESSIONS, S, CLASSES, T = 64, 30, 4, 20
CALLS, ROUNDS = 200, 4


def load(tree: str, name: str):
    path = os.path.join(tree, "src", "repro_torch", "core", "uncertainty.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def calls(mod, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((SESSIONS * S, CLASSES), generator=g, device=dev)
    mean = torch.randn((SESSIONS * S, T, 1), generator=g, device=dev)
    log_var = torch.randn((SESSIONS * S, T, 1), generator=g, device=dev)

    def sel(a):
        return a.reshape((SESSIONS, S) + a.shape[1:]).transpose(0, 1)

    return {"classification": lambda: mod.classification_summary(
                sel(logits).float()),
            "regression": lambda: mod.regression_summary(
                sel(mean).float(), sel(log_var).float())}


def host_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e3


def kernels(fn) -> tuple:
    """(kernels a call, device ms a call) over 20 calls, or (None, None)
    when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evts:
        return None, None
    us = sum(e.device_time for e in evts)
    return len(evts) / 20, us / 20 / 1e3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(parent: str, change: str, out: str):
    dev = torch.device("cuda")
    mods = {"parent": load(parent, "uncertainty_parent"),
            "change": load(change, "uncertainty_change")}
    fns = {side: calls(mod, dev) for side, mod in mods.items()}
    report = {"card": card(), "sessions": SESSIONS, "chains": S,
              "calls": CALLS, "rounds": ROUNDS, "max_abs_diff": {},
              "host_ms": {}, "kernels": {}}
    for what in ("classification", "regression"):
        a, b = fns["parent"][what](), fns["change"][what]()
        report["max_abs_diff"][what] = max(
            float((x - y).abs().max()) for x, y in zip(a, b, strict=True))
    for what in ("classification", "regression"):
        runs = {"parent": [], "change": []}
        for _ in range(ROUNDS):
            for side in ("parent", "change", "change", "parent"):
                runs[side].append(host_ms(fns[side][what]))
        report["host_ms"][what] = runs
        report["kernels"][what] = {
            side: dict(zip(("launches", "device_ms"),
                           kernels(fns[side][what]))) for side in fns}
    print(json.dumps(report), flush=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(*(os.path.abspath(p) for p in sys.argv[1:3]), sys.argv[3])
