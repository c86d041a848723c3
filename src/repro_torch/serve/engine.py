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
SwiGLU gate/up product of a dense FFN or a shared expert, the decode
attention, the Mamba2 prefill scan; on CPU tensors their plain versions);
``backend="reference"`` runs the plain mirrors of the reference's jnp code
(``repro_torch.models.layers``, ``mamba2``, ``moe``, ``mla``).  The MoE
routing and expert products and MLA's latent attention are plain PyTorch
on both backends, as they are plain jnp in the reference, and read no
device value on the host, so their decode step is captured too.

On ``backend="cuda"`` a decode step is the replay of one captured CUDA
graph, the counterpart of the reference's jitted decode: a graph a (S·B
rows, ``max_len``, token dtype), captured on the first decode step over a
static token buffer and a static decode state (the caches, an
encoder–decoder's cross K/V -- ``[S·B, encoder_seq, KV, hd]`` a cross
block, fixed by the config -- and the device position, which the graph
advances itself); each ``generate`` copies its prefill's state into them
(``serve.graphs.StaticStep``; on the CPU the same buffers, run without
capture).  The prefill stays eager (it is
nearly all device time), and ``backend="reference"`` stays eager as the
oracle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import mcd
from repro_torch.core.uncertainty import classification_summary
from repro_torch.kernels import (bernoulli_mask, decode_attn, mcd_matmul,
                                 ssd_chunk)
from repro_torch.models import backbone, layers
from repro_torch.models.config import ArchConfig
from repro_torch.serve.graphs import StaticStep, copy_into

#: The kernel wrappers a decode step can launch (their counts follow
#: replays too).
_LM_KERNELS = (bernoulli_mask.masked_activation, mcd_matmul.mcd_matmul,
               decode_attn.decode_attention, ssd_chunk.ssd_chunk_scan)


@dataclasses.dataclass
class GenerationResult:
    tokens: Any                 # [B, n_new]
    predictive_entropy: Any     # [B, n_new]  total uncertainty (nats)
    mutual_information: Any     # [B, n_new]  epistemic part
    mean_probs_last: Any        # [B, vocab]
    prefill_s: float = 0.0      # host time of the prefill, device synced
    decode_s: list = dataclasses.field(default_factory=list)  # per step
    logits: Any = None          # [n_new, S·B, vocab] with keep_logits


@dataclasses.dataclass
class _DecodeGraph:
    """The static buffers of one (rows, ``max_len``, token dtype) decode
    step and the step over them: the fed tokens ``[S·B, 1]``, the decode
    state (caches and device position, advanced by the step itself) and
    the mask context (row ids) it was captured with."""

    token: torch.Tensor
    state: backbone.DecodeState
    ctx: layers.Ctx
    step: StaticStep


class BayesianEngine:
    """Static-batch S-sample serving engine for every arch of the
    registry: dense, mamba, the MoE family (``attn.moe``, ``mla.mlp`` /
    ``mla.moe``) and jamba's hybrid, whose decode state holds (k, v) caches
    and ``MambaState``s side by side; and for an encoder–decoder
    (``frames``) or a VLM (``patches``) config.  ``graphs=False`` runs
    every decode step eagerly on the ``cuda`` backend too (what the graphs
    are held to)."""

    def __init__(self, params, cfg: ArchConfig, *, max_len: int = 512,
                 seed: int = 0, device=None, backend: str = "cuda",
                 graphs: bool = True):
        layers.check_backend(backend)
        backbone.check_cfg(cfg)
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.seed = seed
        self.device = resolve_device(device)
        self.backend = backend
        # (rows, max_len, token dtype) -> _DecodeGraph; None: eager.
        self._graphs: dict | None = (
            {} if graphs and backend == "cuda" else None)
        self._pool = None

    def _ctx(self, batch: int, s: int) -> layers.Ctx:
        rows = mcd.sample_rows(batch, s, device=self.device)
        return layers.Ctx(rows=rows, seed=self.seed, cfg=self.cfg.mcd,
                          deterministic=not self.cfg.mcd.any_bayesian)

    def _decode_graph(self, batch: int, s: int, dtype) -> _DecodeGraph:
        """The decode step of S·``batch`` rows at this ``max_len`` and
        token dtype, made on first use; its state is adopted from the
        first prefill (``_adopt``)."""
        key = (s * batch, self.max_len, dtype)
        entry = self._graphs.get(key)
        if entry is None:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            token = torch.zeros((s * batch, 1), dtype=dtype,
                                device=self.device)
            entry = _DecodeGraph(token, None, self._ctx(batch, s), None)

            def fn(e=entry):
                lg, new = backbone.decode_step(self.params, self.cfg,
                                               e.token, e.state, e.ctx,
                                               self.backend)
                e.state.pos.copy_(new.pos)     # advanced inside the graph
                return lg
            entry.step = StaticStep(fn, self.device, counted=_LM_KERNELS,
                                    pool=self._pool)
            self._graphs[key] = entry
        return entry

    @staticmethod
    def _adopt(entry: _DecodeGraph, state: backbone.DecodeState) -> None:
        """Make a prefill's decode state the step's: the first prefill's
        tensors become the static state, a later one is copied in."""
        if entry.state is None:
            entry.state = state
            return
        copy_into(entry.state, state)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tile(self, a, s: int):
        """``a`` [B, ...] on the device, repeated for the S chains as the
        prompts are: [S·B, ...]."""
        a = torch.as_tensor(a, device=self.device)
        return a[None].expand(s, *a.shape).reshape(s * a.shape[0],
                                                   *a.shape[1:])

    def generate(self, prompts, n_new: int, *, frames=None, patches=None,
                 teacher_tokens=None,
                 keep_logits: bool = False) -> GenerationResult:
        """prompts: [B, L] → greedy decode of n_new tokens with uncertainty.
        ``frames`` [B, encoder_seq, D] (an encoder–decoder) and
        ``patches`` [B, num_patches, D] (a VLM) are broadcast over the S
        chains, as the reference's.

        As the reference: n_new decode calls, each step summarising the
        logits over the S chains and feeding the argmax to every chain.
        ``teacher_tokens`` [B, n_new] feeds those tokens instead (the
        emitted tokens stay this run's argmax), so a second backend can be
        held to a first run's inputs step for step; ``keep_logits`` keeps
        the logits each step summarised.  Host times of the prefill and of
        each step (summary, argmax and decode call) are taken with the
        device synchronised.

        Each of the n_new steps decodes one position, so the patches +
        prompt length + n_new must not pass ``max_len``: the step past the
        cache raises ``ValueError`` (``backbone.decode_step``).  The JAX
        engine differs here: it clamps that step's cache write to the last
        slot and goes on, so its tokens from that step on are computed over
        an overwritten cache.
        """
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device)
        B, L = prompts.shape
        s = max(1, cfg.mcd.n_samples if cfg.mcd.any_bayesian else 1)
        graph = (None if self._graphs is None
                 else self._decode_graph(B, s, prompts.dtype))
        ctx = self._ctx(B, s) if graph is None else graph.ctx
        tiled = self._tile(prompts, s)
        inputs = {k: self._tile(v, s) for k, v in
                  (("frames", frames), ("patches", patches))
                  if v is not None}
        start = L + (0 if patches is None else inputs["patches"].shape[1])
        t0 = time.perf_counter()
        logits, state = backbone.prefill(self.params, cfg, tiled, ctx,
                                         self.max_len, **inputs,
                                         backend=self.backend)
        if graph is not None:
            self._adopt(graph, state)
        self._sync()
        prefill_s = time.perf_counter() - t0
        smax = backbone.cache_positions(cfg, state.caches)

        toks, ents, mis, kept, steps = [], [], [], [], []
        probs = None
        for i in range(n_new):
            t0 = time.perf_counter()
            if smax is not None and start + i >= smax:
                raise ValueError(f"decode position {start + i} is past the "
                                 f"cache's {smax} positions")
            if keep_logits:
                # A copy: a replay overwrites the step's logits in place.
                kept.append(logits[:, 0].float().clone())
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
            if graph is None:
                logits, state = backbone.decode_step(self.params, cfg, fed,
                                                     state, ctx, self.backend)
            else:
                graph.token.copy_(fed)
                logits = (graph.step.replay() if graph.step.ready
                          else graph.step.first())
            self._sync()
            steps.append(time.perf_counter() - t0)
        return GenerationResult(
            tokens=torch.stack(toks, dim=1),
            predictive_entropy=torch.stack(ents, dim=1),
            mutual_information=torch.stack(mis, dim=1),
            mean_probs_last=probs, prefill_s=prefill_s, decode_s=steps,
            logits=torch.stack(kept) if keep_logits else None)

