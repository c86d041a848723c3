"""The co-design framework (paper §IV / Fig. 7), the FPGA target — port of
``examples/codesign_search.py``.

FPGA target: scan reuse factors under the ZC706 DSP budget for the paper's
best models.  The reference's second half, mesh factorizations of a zoo
LM under a TPU's HBM budget (``tpu_model.search_hw``), waits for the LM
half of the hardware model (ROADMAP.md, A9).

    PYTHONPATH=src python -m repro_torch.examples.codesign_search

The search is host arithmetic; ``--device`` is taken for a uniform
interface and resolved as every entry point resolves it.
"""

import argparse

from repro_torch import resolve_device
from repro_torch.dse import fpga_model as fm
from repro_torch.dse import search


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
    print("\n(the mesh half, tpu_model.search_hw over zoo LMs, is not "
          "ported: ROADMAP.md, A9)")
    return picks


if __name__ == "__main__":
    main()
