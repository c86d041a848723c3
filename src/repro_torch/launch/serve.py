"""Serving launcher: batched Bayesian generation with per-token uncertainty
— port of ``repro.launch.serve``.

Usage (the reduced rehearsal on the CPU, then full width on a GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --batch 8 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --no-reduced --batch 8 --prompt-len 512 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --dtype bf16 --batch 8 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --no-reduced --batch 8 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --no-reduced --dtype bf16 --batch 8 \\
      --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --no-reduced --dtype bf16 --batch 8 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --device cpu

Every arch of the registry runs, and so does an encoder–decoder
(``family="audio"``: frames of ``[batch, encoder_seq, d_model]``) or a
VLM (``family="vlm"``: patches of ``[batch, num_patches, d_model]``,
counted in ``max_len``), their embeddings drawn from ``--seed`` after
the prompts as the reference launcher draws them (in the parameters'
dtype); the registry holds no such config yet.
jamba-1.5-large-398b's published config
(72 layers, ~796 GB at bf16) fits no card, so ``--no-reduced`` is for
the others (``chip_smoke.py`` phase 16 serves its first three layers).

The flags are the reference launcher's, plus ``--device`` and
``--dtype``.  ``--reduced`` is on by default and ``--no-reduced`` reaches
the published config (the reference's ``store_true`` flag with
``default=True`` cannot be turned off).  Weights are random, drawn from
``--seed`` by the port's ``backbone.init_params`` on the serving device,
in fp32 as the reference launcher initialises them, or with ``--dtype
bf16`` in bf16, the dtype the reference's ``init_params`` builds an LM in
by default.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.core import mcd
from repro_torch.models import backbone
from repro_torch.serve.engine import BayesianEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ALIASES), default="qwen3-1.7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--p", type=float, default=None, help="override MCD p")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="the parameters' (and activations') dtype")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    mcd_cfg = cfg.mcd.replace(n_samples=args.samples,
                              **({"p": args.p} if args.p is not None else {}))
    cfg = cfg.replace(mcd=mcd_cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params = backbone.init_params(cfg, gen, device=dev, dtype=dtype)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = torch.as_tensor(rng.normal(
            size=(args.batch, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32), dtype=dtype)
    if cfg.family == "vlm":
        kw["patches"] = torch.as_tensor(rng.normal(
            size=(args.batch, cfg.num_patches, cfg.d_model)).astype(
                np.float32), dtype=dtype)

    eng = BayesianEngine(params, cfg,
                         max_len=args.prompt_len + args.new_tokens
                         + (cfg.num_patches if cfg.family == "vlm" else 0),
                         seed=args.seed, device=dev)
    res = eng.generate(prompts, args.new_tokens, **kw)
    placement = cfg.mcd.placement and mcd.placement_str(cfg.mcd.placement)
    print(f"arch={cfg.name} S={args.samples} p={cfg.mcd.p} B={placement} "
          f"dtype={args.dtype}")
    for b in range(args.batch):
        toks = res.tokens[b].cpu().numpy()
        ent = res.predictive_entropy[b].cpu().numpy()
        mi = res.mutual_information[b].cpu().numpy()
        print(f"req {b}: tokens={toks.tolist()}")
        print(f"       H(total)={np.round(ent, 3).tolist()}")
        print(f"       MI(epistemic)={np.round(mi, 4).tolist()}")
    return res


if __name__ == "__main__":
    main()
