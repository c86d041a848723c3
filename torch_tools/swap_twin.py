"""The twin of the controller-swap check, set up three ways, on the card.

``tests/test_torch_cuda_graphs.py::test_controller_swap_on_the_card``
holds an attached controller's swapped engine against a twin: a
prewarmed engine at the new config fed the converted pre-swap sessions.
``apply_config`` carries the scheduler's chunk-length window across a
swap whose ladder is unchanged, so the swapped engine stays on the rung
the traffic had settled on.  This script replays that check on both
recurrent backends and both new configs with the twin (a) as the test
builds it, loading the old engine's scheduler state, (b) with a fresh
scheduler window, and (c) on ``cuda_seq`` whatever the swapped engine's
backend; and, apart from the swap, ticks one engine at capacity 8 and
one at 12 on the same chunks.  For each it writes the largest summary
difference, the rungs each side ran, and the launches of each tick.

Usage, on a machine with the card, from the root of the repo::

    PYTHONPATH=src python torch_tools/swap_twin.py OUT.json
"""
import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
import test_torch_cuda_graphs as t  # noqa: E402
from repro_torch.serve import StreamingEngine, prewarm  # noqa: E402
from repro_torch.serve.controller import (  # noqa: E402
    CoDesignController, ServingConfig, SLOPolicy, carry_dtypes,
    convert_session)

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = {}


def swap(backend, new, load_state=True, twin_backend=None):
    cfg, params = t._model("classifier", "lstm", dev)
    rng = np.random.default_rng(11)
    sigs = [rng.normal(size=(60, 1)).astype(np.float32) for _ in range(3)]
    sids = [f"s{k}" for k in range(3)]
    eng = StreamingEngine(params, cfg, backend=backend, max_sessions=4,
                          chunk_capacity="auto", ladder=(8, 12), device=dev)
    prewarm(eng)
    for sid in sids:
        eng.open_session(sid)
    plan = rng.integers(1, 13, size=(3, 3))
    for k in range(3):
        eng.step({sid: sigs[j][eng.store.get(sid).steps:][:plan[j, k]]
                  for j, sid in enumerate(sids)})
    ctrl = CoDesignController(eng, SLOPolicy(p95_tick_s=1.0))
    new = ServingConfig(chunk_capacity=12, **new)
    sw = ctrl.apply_config(new)
    twin = StreamingEngine(
        params, dataclasses.replace(cfg, mcd=cfg.mcd.replace(
            n_samples=new.n_samples)),
        backend=twin_backend or backend, max_sessions=4,
        chunk_capacity="auto", ladder=(8, 12), precision=new.precision,
        device=dev)
    prewarm(twin)
    if load_state:
        twin._scheduler.load_state(eng._scheduler.state())
    dts = carry_dtypes("lstm", new.precision, twin.backend)
    for sess in ctrl.last_swap["old_sessions"]:
        twin.attach_session(convert_session(sess, n_samples=new.n_samples,
                                            part_dtypes=dts))
    diff = 0.0
    for k in range(3):
        chunks = {sid: sigs[j][sw.store.get(sid).steps:][:4 + k]
                  for j, sid in enumerate(sids)}
        got, want = sw.step(chunks), twin.step(chunks)
        for sid in sids:
            for a, b in zip(got[sid].summary, want[sid].summary, strict=True):
                diff = max(diff, float((a.float() - b.float()).abs().max()))
    post = [m for m in sw.metrics if m.tick >= ctrl.last_swap["tick"]]
    return {"max_abs_diff": diff,
            "caps_swapped": [m.capacity for m in post],
            "caps_twin": [m.capacity for m in twin.metrics],
            "compiles_swapped": [m.compiles for m in post],
            "launches_swapped": [m.launches for m in post],
            "launches_twin": [m.launches for m in twin.metrics]}


def rung(backend):
    """One engine at fixed capacity 8, one at 12, the same sessions and
    chunks of at most 8 steps: bit-equal summaries?"""
    cfg, params = t._model("classifier", "lstm", dev)
    rng = np.random.default_rng(5)
    sigs = [rng.normal(size=(60, 1)).astype(np.float32) for _ in range(3)]
    engs = {c: StreamingEngine(params, cfg, backend=backend, max_sessions=4,
                               chunk_capacity=c, device=dev)
            for c in (8, 12)}
    for e in engs.values():
        prewarm(e)
        for k in range(3):
            e.open_session(f"s{k}")
    diff = 0.0
    for k in range(4):
        lens = rng.integers(1, 9, size=3)
        chunks = {f"s{j}": sigs[j][engs[8].store.get(f"s{j}").steps:][
            :lens[j]] for j in range(3)}
        a, b = engs[8].step(chunks), engs[12].step(chunks)
        for sid in chunks:
            for x, y in zip(a[sid].summary, b[sid].summary, strict=True):
                diff = max(diff, float((x.float() - y.float()).abs().max()))
    return {"max_abs_diff": diff}


for backend in ("cuda_seq", "cuda_step"):
    for name, new in (("S2", dict(n_samples=2)),
                      ("bf16", dict(n_samples=t.S, precision="bf16"))):
        for variant, kw in (("as_is", {}),
                            ("no_load_state", {"load_state": False}),
                            ("twin_cuda_seq", {"twin_backend": "cuda_seq"})):
            key = f"{backend}/{name}/{variant}"
            try:
                out[key] = swap(backend, new, **kw)
            except Exception:
                out[key] = {"error": traceback.format_exc()[-800:]}
            print(key, json.dumps(out[key]), flush=True)
    out[f"rung/{backend}"] = rung(backend)
    print(f"rung/{backend}", json.dumps(out[f"rung/{backend}"]), flush=True)
with open(sys.argv[1], "w") as f:
    json.dump(out, f, indent=1)
