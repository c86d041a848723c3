"""Uncertainty-aware batched LM serving — port of
``repro.serve.engine``.

A Bayesian request is served as S MC chains folded into the batch axis:
one weight fetch feeds all S chains, and every chain draws its own tied
mask again at each decode step from the counter RNG, so the serving state
carries only (seed, row ids), never masks.  At each step the S chains'
logits are aggregated into the predictive distribution; its mean picks the
next token (greedy), the same token is fed back to every chain, and the
per-token predictive entropy and mutual information are emitted with it.

``backend="cuda"`` runs the LM's kernels (the site mask, the masked
SwiGLU gate/up product, the decode attention, the Mamba2 prefill scan; on
CPU tensors their plain versions); ``backend="reference"`` runs the plain
mirrors of the reference's jnp code (``repro_torch.models.layers``,
``repro_torch.models.mamba2``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import mcd
from repro_torch.core.uncertainty import classification_summary
from repro_torch.models import backbone, layers
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class GenerationResult:
    tokens: Any                 # [B, n_new]
    predictive_entropy: Any     # [B, n_new]  total uncertainty (nats)
    mutual_information: Any     # [B, n_new]  epistemic part
    mean_probs_last: Any        # [B, vocab]
    prefill_s: float = 0.0      # host time of the prefill, device synced
    decode_s: list = dataclasses.field(default_factory=list)  # per step
    logits: Any = None          # [n_new, S·B, vocab] with keep_logits


class BayesianEngine:
    """Static-batch S-sample serving engine for the dense and the mamba
    archs."""

    def __init__(self, params, cfg: ArchConfig, *, max_len: int = 512,
                 seed: int = 0, device=None, backend: str = "cuda"):
        layers.check_backend(backend)
        backbone.check_cfg(cfg)
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.seed = seed
        self.device = resolve_device(device)
        self.backend = backend

    def _ctx(self, batch: int, s: int) -> layers.Ctx:
        rows = mcd.sample_rows(batch, s, device=self.device)
        return layers.Ctx(rows=rows, seed=self.seed, cfg=self.cfg.mcd,
                          deterministic=not self.cfg.mcd.any_bayesian)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, n_new: int, *, teacher_tokens=None,
                 keep_logits: bool = False) -> GenerationResult:
        """prompts: [B, L] → greedy decode of n_new tokens with uncertainty.

        As the reference: n_new decode calls, each step summarising the
        logits over the S chains and feeding the argmax to every chain.
        ``teacher_tokens`` [B, n_new] feeds those tokens instead (the
        emitted tokens stay this run's argmax), so a second backend can be
        held to a first run's inputs step for step; ``keep_logits`` keeps
        the logits each step summarised.  Host times of the prefill and of
        each step (summary, argmax and decode call) are taken with the
        device synchronised.

        Each of the n_new steps decodes one position, so prompt length +
        n_new must not pass ``max_len``: the step past the cache raises
        ``ValueError`` (``backbone.decode_step``).  The JAX engine differs
        here: it clamps that step's cache write to the last slot and goes
        on, so its tokens from that step on are computed over an
        overwritten cache.
        """
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device)
        B = prompts.shape[0]
        s = max(1, cfg.mcd.n_samples if cfg.mcd.any_bayesian else 1)
        ctx = self._ctx(B, s)
        tiled = prompts[None].expand(s, *prompts.shape).reshape(s * B, -1)
        t0 = time.perf_counter()
        logits, state = backbone.prefill(self.params, cfg, tiled, ctx,
                                         self.max_len, backend=self.backend)
        self._sync()
        prefill_s = time.perf_counter() - t0

        toks, ents, mis, kept, steps = [], [], [], [], []
        probs = None
        for i in range(n_new):
            t0 = time.perf_counter()
            if keep_logits:
                kept.append(logits[:, 0].float())
            summ = classification_summary(
                logits[:, 0].reshape(s, B, -1).float())
            probs = summ.probs
            next_tok = torch.argmax(summ.probs, dim=-1).to(prompts.dtype)
            toks.append(next_tok)
            ents.append(summ.predictive_entropy)
            mis.append(summ.mutual_information)
            fed = (next_tok if teacher_tokens is None else
                   torch.as_tensor(teacher_tokens)[:, i].to(
                       device=self.device, dtype=prompts.dtype))
            fed = fed[None].expand(s, B).reshape(s * B, 1)
            logits, state = backbone.decode_step(self.params, cfg, fed, state,
                                                 ctx, self.backend)
            self._sync()
            steps.append(time.perf_counter() - t0)
        return GenerationResult(
            tokens=torch.stack(toks, dim=1),
            predictive_entropy=torch.stack(ents, dim=1),
            mutual_information=torch.stack(mis, dim=1),
            mean_probs_last=probs, prefill_s=prefill_s, decode_s=steps,
            logits=torch.stack(kept) if keep_logits else None)
