"""Time one checkout of the port, for a comparison of two in turns.

Puts CHECKOUT's ``src`` first on the path (its kernels build into its own
``build/kernels``) and measures it on the card with this repository's
``chip_smoke.py``, so that both sides of a comparison run the same
harness:

* ``mcd_matmul`` at qwen3-1.7b's SwiGLU gate/up product, [M, 2048] @
  [2048, 12288], M = 64 (decode) and 8192 (prefill), p = 0.1, fp32 and
  bf16 operands, fp32 out; ``ssd_chunk_scan`` at mamba2-370m's prefill,
  [64, 512, 32, 64], N = 128, Q = 256, fp32 and bf16 x, B and C: device
  ms a call (``chip_smoke.device_ms``: every kernel of the launch) and
  host ms a call (``chip_smoke.host_ms``);
* the serving phases named after OUT.json (default ``7b 7c``), each
  ``chip_smoke``'s own function with its gates: ``5c`` (the ECG tick
  graphs against eager), ``5e`` (students beside MC sessions: a ragged
  tick), ``ee`` (phase 5d's early-exit cell alone: on against off),
  ``7`` / ``9`` (qwen3-1.7b / mamba2-370m fp32), ``7b`` / ``9b`` (the
  same in bf16: prefill and decode times, device ms and top kernels of a
  prefill, peak memory, graph against eager), ``7c`` (the eager decode
  step from an int8 KV cache).

Usage, on a machine with the card, both checkouts on the same card and in
turns (parent, change, change, parent)::

    python torch_tools/turns.py CHECKOUT OUT.json [PHASE ...]

Writes the numbers, the card's name and power limit to OUT.json.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

def early_exit_cell(report, dev):
    """Phase 5d's early-exit cell alone (the ragged tick's summaries)."""
    report["early_exit"] = chip_smoke._early_exit_cell(
        report, dev, {name: 0 for name in chip_smoke.ALL_KERNELS})
    print("early_exit " + json.dumps(report["early_exit"]), flush=True)


PHASES = {"5c": chip_smoke.graph_phase, "5e": chip_smoke.student_phase,
          "ee": early_exit_cell, "7": chip_smoke.lm_serving_phase,
          "9": chip_smoke.mamba_serving_phase,
          "7b": chip_smoke.lm_bf16_serving_phase,
          "9b": chip_smoke.mamba_bf16_serving_phase,
          "7c": chip_smoke.int8_kv_phase}


def _time(rec, call, iters, match):
    rec.update(device_ms=chip_smoke.device_ms(call, iters, match),
               host_ms=chip_smoke.host_ms(call))
    print(json.dumps(rec), flush=True)
    return rec


def kernel_times(dev) -> list:
    import torch
    from repro_torch.kernels import mcd_matmul, ssd_chunk
    K, N = 2048, 12288
    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        w = (torch.randn((K, N), generator=g, device=dev)
             * K ** -0.5).to(dtype)
        for M in (64, 8192):
            x = torch.randn((M, K), generator=g, device=dev).to(dtype)
            rows = torch.arange(M, dtype=torch.int32, device=dev)

            def call(x=x, w=w, rows=rows):
                return mcd_matmul.mcd_matmul(x, w, rows, 0x2545F491, 0.1,
                                             torch.float32)

            out.append(_time({"kernel": "mcd_matmul",
                              "dtype": str(dtype)[6:], "M": M, "K": K,
                              "N": N}, call, 3 if M > 64 else 20,
                             "mcd_matmul_kernel"))
            del x
        del w
    B, L, H, P, N, q = chip_smoke.SSD_CASES[0]
    for dtype in (torch.float32, torch.bfloat16):
        ins = chip_smoke.ssd_inputs(B, L, H, P, N, seed=L + H + 1)
        for i in (0, 3, 4):
            ins[i] = ins[i].to(dtype)

        def call(ins=ins):
            return ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)

        out.append(_time({"kernel": "ssd_chunk_scan",
                          "dtype": str(dtype)[6:], "B": B, "L": L, "H": H,
                          "P": P, "N": N, "q_chunk": q}, call, 3,
                         "ssd_chunk_scan_kernel"))
        del ins
    return out


def main(tree, path, phases):
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    import repro_torch
    from repro_torch.kernels import build
    if not repro_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(list(chip_smoke.KERNELS) + [
        src.removesuffix(".cu")
        for _, src, _ in chip_smoke.LM_KERNELS.values()])
    dev = torch.device("cuda")
    report = {"tree": tree, "card": chip_smoke.card_line(),
              "phases": phases}
    report["kernels"] = kernel_times(dev)
    for name in phases:
        PHASES[name](report, dev)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]), sys.argv[2],
         sys.argv[3:] or ["7b", "7c"])
