"""What bounds the tensor-core SSD kernel: its time with parts taken out.

Builds copies of ``csrc/ssd_chunk.cu`` with one part of
``ssd_chunk_scan_kernel_bf16_tc`` removed or changed (text substitutions,
each checked to apply), launches each through the wrapper at mamba2-370m's
prefill shape ([64, 512, 32, 64], N = 128, Q = 256, bf16), and prints the
kernel's device ms (``chip_smoke.device_ms``) beside the unchanged
kernel's.  The ablated kernels compute wrong results; only their times are
read, as the cost of what each removed:

* ``loads_only``: no products (the chunk's TMA loads, cs / dt, the
  barriers, the stores of y and h_final);
* ``no_intra`` / ``no_state``: without the intra term / the state update;
* ``no_weights``: G' = S (no decay, no dt: the fp32 work before the split);
* ``pieces_g2``: two pieces of G' instead of three;
* ``fast_exp``: the decay by ``__expf`` (ex2.approx) instead of ``expf``.

Usage, on a machine with the card::

    python torch_tools/ssd_ablate.py OUT.json [ABLATION ...]
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import chip_smoke  # noqa: E402

_NO_STATE = [("    float ds[32];\n#pragma unroll 1\n"
              "    for (int kt = 0; kt < nt; ++kt) {",
              "    float ds[32];\n"
              "    for (int e = 0; e < 32; ++e) ds[e] = 0.0f;\n"
              "#pragma unroll 1\n    for (int kt = 0; kt < 0; ++kt) {")]
_NO_INTRA = [("      for (int kt = 0; kt <= qt; ++kt) {",
              "      for (int kt = 0; kt < 0; ++kt) {")]
ABLATIONS = {
    "base": [],
    "loads_only": _NO_STATE + _NO_INTRA + [("      if (ci > 0) {",
                                            "      if (false) {")],
    "no_intra": _NO_INTRA,
    "no_state": _NO_STATE,
    "no_weights": [
        ("""__fmul_rn(
                __fmul_rn(s[8 * ks + 2 * r],
                          expf(fminf(cq[r & 1] - ck[i].x, 0.0f))),
                dk[i].x);""", "s[8 * ks + 2 * r];"),
        ("""__fmul_rn(
                __fmul_rn(s[8 * ks + 2 * r + 1],
                          expf(fminf(cq[r & 1] - ck[i].y, 0.0f))),
                dk[i].y);""", "s[8 * ks + 2 * r + 1];")],
    "pieces_g2": [("constexpr int kPiecesG = 3;",
                   "constexpr int kPiecesG = 2;")],
    "fast_exp": [("expf(fminf(", "__expf(fminf(")],
}


def build_variants(names, out_dir) -> dict:
    """name -> the loaded library of that ablation (built in parallel)."""
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    started = {}
    for name in names:
        text = src
        for old, new in ABLATIONS[name]:
            if text.count(old) < 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"ssd_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libssd_{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", lib, path]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), lib)
    libs = {}
    for name, (proc, lib) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.abspath(lib))
    return libs


def main(path, names):
    import torch
    from repro_torch.kernels import build, common, ssd_chunk
    libs = build_variants(names, os.path.join("build", "ablate"))
    B, L, H, P, N, q = chip_smoke.SSD_CASES[0]
    ins = chip_smoke.ssd_inputs(B, L, H, P, N, seed=L + H + 1)
    for i in (0, 3, 4):
        ins[i] = ins[i].to(torch.bfloat16)
    load = build.load
    report = {"card": chip_smoke.card_line(), "shape": [B, L, H, P, N, q],
              "device_ms": {}}
    try:
        for name in names:
            build.load = (lambda lib, name=name: libs[name]
                          if lib == "ssd_chunk" else load(lib))
            common.c_entry.cache_clear()
            ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
            if ssd_chunk.ssd_chunk_scan.last_plan["path"] != "tensor_cores":
                raise RuntimeError("the serving shape left the tensor cores")
            report["device_ms"][name] = chip_smoke.device_ms(
                lambda: ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q), 5,
                "ssd_chunk_scan_kernel_bf16_tc")
            print(name, report["device_ms"][name], flush=True)
    finally:
        build.load = load
        common.c_entry.cache_clear()
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or list(ABLATIONS))
