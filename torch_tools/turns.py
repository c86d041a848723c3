"""Time one checkout of the port, for a comparison of two in turns.

Puts CHECKOUT's ``src`` first on the path (its kernels build into its own
``build/kernels``) and measures it on the card with this repository's
``chip_smoke.py``, so that both sides of a comparison run the same
harness:

* ``mcd_matmul`` at qwen3-1.7b's SwiGLU gate/up product, [M, 2048] @
  [2048, 12288], M = 64 (decode) and 8192 (prefill), p = 0.1, fp32 and
  bf16 operands, fp32 out: device ms a call (``chip_smoke.device_ms``:
  the keep-bit pass and the product) and host ms a call
  (``chip_smoke.host_ms``);
* phase 7b (``chip_smoke.lm_bf16_serving_phase``: qwen3-1.7b in bf16
  through ``BayesianEngine.generate``, graph and eager in turns, with its
  gates) and phase 7c (``chip_smoke.int8_kv_phase``: the eager decode step
  from an int8 KV cache).

Usage, on a machine with the card, both checkouts on the same card and in
turns (parent, change, change, parent)::

    python torch_tools/turns.py CHECKOUT OUT.json

Writes the numbers, the card's name and power limit to OUT.json.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def kernel_times(dev) -> list:
    import torch
    from repro_torch.kernels import mcd_matmul
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

            out.append({"kernel": "mcd_matmul", "dtype": str(dtype)[6:],
                        "M": M, "K": K, "N": N,
                        "device_ms": chip_smoke.device_ms(
                            call, 3 if M > 64 else 20, "mcd_matmul_kernel"),
                        "host_ms": chip_smoke.host_ms(call)})
            print(json.dumps(out[-1]), flush=True)
            del x
        del w
    return out


def main(tree, path):
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    import repro_torch
    from repro_torch.kernels import build
    if not repro_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["masked_activation", "mcd_matmul", "decode_attn"])
    dev = torch.device("cuda")
    report = {"tree": tree, "card": chip_smoke.card_line()}
    report["kernels"] = kernel_times(dev)
    chip_smoke.lm_bf16_serving_phase(report, dev)
    chip_smoke.int8_kv_phase(report, dev)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]), sys.argv[2])
