"""The co-design framework end-to-end (paper §IV / Fig. 7), both targets —
port of ``examples/codesign_search.py``.

FPGA target: scan reuse factors under the ZC706 DSP budget for the paper's
best models.  GPU target (the reference's TPU half): scan mesh
factorizations of 256 H100s (falling back to 2 pods) under one card's
80 GB of HBM for three zoo architectures at ``train_4k``
(``dse.gpu_model.search_hw``).

    PYTHONPATH=src python -m repro_torch.examples.codesign_search

The search is host arithmetic; ``--device`` is taken for a uniform
interface and resolved as every entry point resolves it.  The H100 peaks
are ``launch.analysis``'s (data sheet), not a measurement.
"""

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.dse import fpga_model as fm
from repro_torch.dse import gpu_model, search
from repro_torch.models.config import SHAPES

MESH_ARCHS = ("llama3-8b", "olmoe-1b-7b", "jamba-1.5-large-398b")


def mesh_picks(hbm_limit: float = 80e9) -> dict:
    """Each of MESH_ARCHS at ``train_4k``: the fastest feasible split of
    256 cards, else of 2 pods of 256; ``{arch: (pods, row) | None}``."""
    out = {}
    for arch in MESH_ARCHS:
        cfg = get_config(arch)
        best = None
        for pods in (1, 2):
            rows = gpu_model.search_hw(cfg, SHAPES["train_4k"], chips=256,
                                       hbm_limit=hbm_limit, pod=pods)
            best = next((r for r in rows if r["feasible"]), None)
            if best is not None:
                break
        out[arch] = None if best is None else (pods, best)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    print("=== FPGA DSE (paper §IV): reuse factors under the DSP budget ===")
    table = [
        search.Candidate(arch=fm.RNNArch(8, 1, "N"), n_samples=1,
                         metrics={"accuracy": 0.90, "ap": 0.62,
                                  "entropy": 0.15}),
        search.Candidate(arch=fm.RNNArch(8, 3, "YNY"),
                         metrics={"accuracy": 0.92, "ap": 0.69,
                                  "entropy": 0.30}),
        search.Candidate(arch=fm.RNNArch(8, 3, "YNN"),
                         metrics={"accuracy": 0.89, "ap": 0.59,
                                  "entropy": 0.60}),
        # §III-A cell axis: the 3-gate GRU datapath at 3/4 the DSP cost --
        # the co-design loop may trade it against the accuracy it gives up.
        search.Candidate(arch=fm.RNNArch(8, 3, "YNY"), cell="gru",
                         metrics={"accuracy": 0.91, "ap": 0.66,
                                  "entropy": 0.28}),
    ]
    picks = {}
    for mode in ("Opt-Latency", "Opt-Accuracy", "Opt-Entropy"):
        got = picks[mode] = search.optimize(table, mode, batch=50)
        print(f"{mode:14s} → H={got.arch.hidden} NL={got.arch.num_layers} "
              f"B={got.arch.placement} S={got.n_samples} cell={got.cell} "
              f"R=({got.hw.r_x},{got.hw.r_h},{got.hw.r_d}) "
              f"lat={got.latency_s*1e3:.2f} ms "
              f"DSPs={fm.dsp_usage(got.arch, got.hw):.0f}/900")
    print("\n=== GPU DSE: mesh factorizations under the 80 GB HBM budget "
          "===")
    meshes = picks["mesh"] = mesh_picks()
    for arch, got in meshes.items():
        if got is None:
            print(f"{arch:24s} infeasible even at 2 pods")
            continue
        pods, best = got
        hw = best["hw"]
        print(f"{arch:24s} → pods={pods} mesh=({hw.data}×{hw.model}) "
              f"mb={hw.microbatches} fsdp={hw.fsdp} "
              f"mem={best['mem']/1e9:.1f} GB t_step={best['t_step']:.2f}s "
              f"bound={'C' if best['t_compute']==best['t_step'] else 'M/X'}")
    return picks


if __name__ == "__main__":
    main()
