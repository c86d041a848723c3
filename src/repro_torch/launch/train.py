"""Training launcher — port of ``repro.launch.train``.

Two modes:
  * --task ecg-ae / ecg-clf — the paper's models on the ECG5000-compatible
    dataset (paper §V hyperparameters: batch 64, lr 1e-3, p 0.125; the
    classifier H 8, NL 3, YNY; the autoencoder --hidden / --layers, YNYN).
  * --task lm --arch <id>   — a zoo architecture on a synthetic token
    stream, REDUCED by default; ``--no-reduced`` trains the published
    config (qwen3-1.7b and mamba2-370m fit one 80 GB card in fp32;
    olmoe-1b-7b's weights and AdamW state in fp32, ~110 GB, do not).  A
    MoE arch's loss carries the routers' load-balance term.

Fault tolerance: --ckpt-dir enables atomic checkpoints (every 50 steps and
at the end) and auto-resume; kill the process at any step and rerun the
same command to continue.  A checkpoint of either package's launcher
resumes in the other's: an LM's holds the reference's leaves (each
stage's repeats stacked, ``backbone.stack_repeats``), unstacked into the
port's layout at restore.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --task ecg-clf \\
      --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --task ecg-ae \\
      --device cpu --steps 20 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --task lm \\
      --arch qwen3-1.7b --no-reduced --steps 3

The flags are the reference launcher's, plus ``--device`` (CUDA unless
``cpu``) and ``--reduced`` / ``--no-reduced`` (the reference's
``store_true`` flag with ``default=True`` cannot be turned off).
Parameters are random: the ECG models' from a CPU ``torch.Generator``
seeded by ``--seed`` (the same weights on every device), an LM's from one
on the training device (``backbone.init_params``, as ``launch/serve.py``
draws them), in fp32 as the reference launcher initialises them.  The
gradients come from ``torch.autograd`` through the plain PyTorch path (the
``reference`` backend), as the reference trains through ``jax.grad`` on
its jnp path: no kernel has a backward.

Divergences from the reference, both where it cannot run as written:
  * On resume the launcher skips the batches the checkpointed steps
    consumed, so a killed run that is relaunched trains on the batches an
    uninterrupted run would (the reference restarts its data stream, so
    its resumed steps see the first batches again).
  * The LM stream's "next token = token + 1" half writes
    ``t[:, 1::2]`` from as many columns of ``t[:, 0::2]``; at an even
    ``--seq`` (its default 64 among them) the reference's assignment
    does not broadcast and raises.  At an odd ``--seq`` the stream is the
    reference's, byte for byte.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import mcd, prng
from repro_torch.data import ecg
from repro_torch.models import backbone
from repro_torch.models.layers import Ctx
from repro_torch.train import optimizer, trainer


def ecg_batches(task: str, batch_size: int, seed: int, epochs: int = 10_000):
    """(x [B, 140, 1] fp32, y [B] int32) numpy batches, epoch after epoch;
    the autoencoder trains on the normal beats only."""
    tx, ty, _, _ = ecg.make_ecg5000(seed)
    if task == "ecg-ae":        # anomaly detection: train on normal only
        tx, ty = tx[ty == 0], ty[ty == 0]
    pipe = ecg.Pipeline(tx, ty, batch_size=batch_size, seed=seed)
    for e in range(epochs):
        yield from pipe.epoch(e)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], dtype=torch.int64, device=x.device)


def make_ecg_loss(task: str, cfg):
    """``loss(params, (x, y), step) -> (mean NLL, {})``.  The masks come
    from ``cfg.mcd.seed`` at every step, rows ``arange(B)``, as the
    reference's (only its LM folds the step into the seed)."""
    if task == "ecg-ae":
        def loss(params, batch, step):
            x, _ = batch
            mean, log_var = ae.apply(params, x, _rows(x), cfg,
                                     device=x.device)
            return torch.mean(ae.gaussian_nll(mean, log_var, x)), {}
        return loss

    def loss(params, batch, step):
        x, y = batch
        logits = clf.apply(params, x, _rows(x), cfg, device=x.device)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, y.long()[:, None])[:, 0]
        return torch.mean(nll), {}
    return loss


def lm_batches(cfg, batch: int, seq: int, seed: int):
    """(tokens [B, seq], targets [B, seq]) int32 numpy batches: uniform
    tokens, each odd position the token before it + 1 (mod vocab)."""
    rng = np.random.default_rng(seed)
    while True:
        t = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
        # learnable structure: next token = (token + 1) % vocab on half
        odd = t[:, 1::2]
        odd[:] = (t[:, 0::2][:, :odd.shape[1]] + 1) % cfg.vocab_size
        yield t[:, :-1], t[:, 1:]


def make_lm_loss(cfg):
    """``loss(params, (tokens, targets), step)``: ``backbone.loss_fn``
    (remat on, chunked cross-entropy) with the step folded into the mask
    seed and rows ``arange(B)``."""
    def loss(params, batch, step):
        toks, targets = batch
        ctx = Ctx(rows=_rows(toks), seed=prng.fold_ids(cfg.mcd.seed, step),
                  cfg=cfg.mcd)
        return backbone.loss_fn(params, cfg, toks, targets, ctx)
    return loss


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=("ecg-ae", "ecg-clf", "lm"),
                    default="ecg-clf")
    ap.add_argument("--arch", choices=sorted(ALIASES))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)      # paper §V
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--placement", default=None, help="MCD B-string")
    ap.add_argument("--p", type=float, default=0.125)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=("none", "bf16", "int8"),
                    default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def setup(args, device):
    """(loss_fn, params, numpy batch iterator, TrainConfig, model config)
    for parsed ``args`` on ``device``: what :func:`main` trains."""
    tcfg = trainer.TrainConfig(
        adamw=optimizer.AdamWConfig(lr=args.lr),   # clip 3.0 / wd 1e-4
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50)
    if args.task in ("ecg-ae", "ecg-clf"):
        mcfg = mcd.MCDConfig(
            p=args.p,
            placement=args.placement or ("YNYN" if args.task == "ecg-ae"
                                         else "YNY"),
            n_samples=30, seed=args.seed)
        gen = torch.Generator().manual_seed(args.seed)
        if args.task == "ecg-ae":
            cfg = ae.AutoencoderConfig(hidden=args.hidden,
                                       num_layers=args.layers, mcd=mcfg)
            params = ae.init(gen, cfg, device=device)
        else:
            cfg = clf.ClassifierConfig(hidden=8, num_layers=3, mcd=mcfg)
            params = clf.init(gen, cfg, device=device)
        return (make_ecg_loss(args.task, cfg), params,
                ecg_batches(args.task, args.batch, args.seed), tcfg, cfg)
    cfg = get_config(args.arch or "llama3-8b", reduced=args.reduced)
    backbone.check_cfg(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = backbone.init_params(cfg, gen, device=device,
                                  dtype=torch.float32)
    return (make_lm_loss(cfg), params,
            lm_batches(cfg, args.batch, args.seq, args.seed), tcfg, cfg)


def main(argv=None):
    """Train; returns ``{"history": [...], "trainer": Trainer}``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    loss, params, np_batches, tcfg, _ = setup(args, device)
    # An LM checkpoint holds the reference's stacked [repeat, ...] leaves.
    layout = ((backbone.stack_repeats, backbone.unstack_repeats)
              if args.task == "lm" else None)
    tr = trainer.Trainer(loss, params, tcfg, layout)
    # A resumed run goes on with the batches the checkpointed steps left.
    batches = (tuple(torch.as_tensor(a, device=device) for a in b)
               for b in itertools.islice(np_batches, tr.step, None))
    hist = tr.run(batches, args.steps)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} after {tr.step} steps; "
              f"stragglers flagged: {len(tr.straggler_events)}")
    return {"history": hist, "trainer": tr}


if __name__ == "__main__":
    main()
