"""Serve a zoo LM with Bayesian uncertainty per generated token — port of
``examples/uncertainty_serving.py``.

Shows the paper's technique as a serving feature on a modern
architecture: S MCD chains folded into the batch, masks tied across decode
steps, per-token predictive entropy + mutual information.

    PYTHONPATH=src python -m repro_torch.examples.uncertainty_serving \\
        [--arch qwen3-1.7b] [--device cpu]

The default arch is olmoe-1b-7b, as the reference's; every ``--arch`` of
the registry runs, jamba's hybrid among them.  The model is the REDUCED
miniature with random fp32 weights from a ``torch.Generator`` seeded 0 on
the serving device; on the card ``BayesianEngine`` decodes through the kernels (``backend="cuda"``),
on the CPU through their plain versions.
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.models import backbone
from repro_torch.serve.engine import BayesianEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ALIASES), default="olmoe-1b-7b")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)     # CPU-sized miniature
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=args.samples, p=0.1))
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    eng = BayesianEngine(params, cfg, max_len=64, device=dev)
    res = eng.generate(prompts, args.new_tokens)

    print(f"{cfg.name}: S={args.samples} chains, masks tied per chain "
          f"across all decode steps (recomputed from the counter-RNG -- "
          f"zero state)")
    for b in range(2):
        print(f"\nrequest {b}:")
        for t in range(args.new_tokens):
            tok = int(res.tokens[b, t])
            ent = float(res.predictive_entropy[b, t])
            mi = float(res.mutual_information[b, t])
            flag = "  <-- high epistemic" if mi > 0.3 else ""
            print(f"  step {t:2d}: token={tok:6d}  H={ent:5.3f}  "
                  f"MI={mi:6.4f}{flag}")
    return res


if __name__ == "__main__":
    main()
