"""The LM backbone over its stages — port of ``repro.models.backbone`` for
the ``attn``, ``mla`` and ``mamba`` mixers and the ``mlp`` and ``moe``
FFNs.

A model is an embedding and a sequence of stages; each stage repeats a
period of blocks (``config.Stage``).  The reference scans stacked
parameters; here each stage is a Python loop over its repeats and pattern
positions, with the same layer ids (``offset + r·period + j``) and the same
Bayesian placement per *pattern position* (:func:`_stage_bayes`: a placement
string indexes the pattern, not the layer, so ``"NY"`` over a one-block
pattern makes no layer Bayesian, as in the reference).

Parameters are unstacked: ``params["stages"][i][r][j]`` is the block dict
of stage i, repeat r, pattern position j: ``{"mixer": AttnParams |
mla.MLAParams | MambaParams, "ffn": MLPParams | moe.MoEParams}``, with no
``"ffn"`` for a bare ``mamba`` block (mamba2's).  Decode caches nest the
same way: a (k, v) pair for attention, an ``mla.MLACache`` of latents for
MLA, a ``mamba2.MambaState`` for a mamba block (jamba's stage holds both
kinds).  A checkpoint holds the reference's stacked layout instead
(:func:`stack_repeats`).  A MoE FFN returns its load-balance loss, which
``forward`` sums as the reference's scan does and ``loss_fn`` adds;
decode discards it.  Entry points:

  forward      full sequence (``collect_caches``, ``return_hidden``,
               ``remat``: each repeat's period of blocks checkpointed)
  loss_fn      next-token cross-entropy (:func:`_chunked_xent`) + aux,
               the training loss; it runs the ``reference`` backend, as
               the reference's LM reaches no kernel under grad
  prefill      forward + the decode state (KV caches padded to
               ``max_len``; a Mamba state has no sequence axis)
  decode_step  one token through the caches, updated in place; the
               position is a device int32 scalar, never read on the host,
               so a decode step can be captured as one CUDA graph

Cross-attention, encoders and patch or frame inputs are not ported yet
and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import tree_leaves, tree_map
from repro_torch.models import layers, mamba2, mla, moe
from repro_torch.models.config import ArchConfig, Stage

_MIXERS = ("attn", "mla", "mamba")
_NOT_PORTED = "cross-attention and encoders are queued (ROADMAP.md, A9)"


def _parse(kind: str) -> tuple[str, bool, str | None]:
    """kind string → (mixer, has_cross, ffn|None)."""
    parts = kind.split(".")
    mixer = parts[0]
    has_cross = "cross" in parts[1:]
    ffn = parts[-1] if parts[-1] in ("mlp", "moe") else None
    return mixer, has_cross, ffn


def _check_kind(kind: str) -> None:
    """Raise for a block this port does not run (it runs ``attn``, ``mla``
    and ``mamba``, each with or without an ``mlp`` / ``moe`` FFN)."""
    mixer, has_cross, _ = _parse(kind)
    if mixer not in _MIXERS or has_cross:
        raise NotImplementedError(f"block {kind!r}: {_NOT_PORTED}")


def check_cfg(cfg: ArchConfig) -> None:
    """Raise unless every block of ``cfg`` is one this port runs (no
    encoder stages: frame and patch inputs are not ported either)."""
    for st in cfg.stages:
        for kind in st.pattern:
            _check_kind(kind)
    if cfg.encoder_stages or cfg.num_patches:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED}")


def init_block(gen, kind: str, cfg: ArchConfig, dtype,
               device) -> dict[str, Any]:
    _check_kind(kind)
    mixer, _, ffn = _parse(kind)
    if mixer == "mamba":
        p: dict[str, Any] = {"mixer": mamba2.init_mamba(
            gen, cfg.d_model, cfg.ssm, dtype, device)}
    elif mixer == "mla":
        p = {"mixer": mla.init_mla(
            gen, cfg.d_model, cfg.num_heads, cfg.mla, dtype, device)}
    else:
        p = {"mixer": layers.init_attn(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.qk_norm, dtype, device)}
    if ffn == "mlp":
        p["ffn"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif ffn == "moe":
        p["ffn"] = moe.init_moe(gen, cfg.d_model, cfg.moe, dtype, device)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict[str, Any]:
    """Random parameters at the reference's init scales (``layers.py``
    init_attn / init_mlp / init_embed, ``mla.py`` init_mla, ``moe.py``
    init_moe, ``mamba2.py`` init_mamba), drawn
    from ``generator`` on its own device (a CUDA generator draws a
    full-width model on the card) and placed on ``device`` (default CUDA).
    Not the reference's numbers: its ``jax.random`` stream differs;
    :func:`repro_torch.bridge.from_numpy_backbone` carries its parameters
    over."""
    check_cfg(cfg)
    dev = resolve_device(device)
    return {
        "embed": layers.init_embed(generator, cfg.vocab_size, cfg.d_model,
                                   cfg.tie_embeddings, dtype, dev),
        "stages": [[tuple(init_block(generator, kind, cfg, dtype, dev)
                          for kind in st.pattern)
                    for _ in range(st.repeat)] for st in cfg.stages],
    }


def _host_stack(xs):
    return torch.stack([x.detach().cpu() for x in xs])


def stack_repeats(tree, stack=_host_stack):
    """A parameter tree of the port (or one of its shape: AdamW's moments)
    in the reference's layout, the one an LM checkpoint holds:
    ``tree["stages"][i][j]`` is pattern position j's block with every leaf
    stacked ``[repeat, ...]`` (the reference's ``init_stage``).  ``stack``
    joins one leaf's repeats: by default on the host, so checkpointing a
    full-width model takes no device memory."""
    return {**tree, "stages": [
        tuple(tree_map(lambda *xs: stack(xs), *(rep[j] for rep in sp))
              for j in range(len(sp[0])))
        for sp in tree["stages"]]}


def unstack_repeats(tree, place=lambda a: a):
    """:func:`stack_repeats` undone: repeat r of position j takes leaf
    ``[r]`` of the stacked block; ``place`` puts every leaf in place."""
    def repeats(st):
        return tree_leaves(st[0])[0].shape[0]

    return {**tree_map(place, {k: v for k, v in tree.items()
                               if k != "stages"}), "stages": [
        [tuple(tree_map(lambda a, r=r: place(a[r]), blk) for blk in st)
         for r in range(repeats(st))]
        for st in tree["stages"]]}


def _ffn_forward(p, cfg: ArchConfig, x, ctx: layers.Ctx, layer_id: int,
                 bayes: bool, backend: str):
    """The block's FFN, if any, on its residual stream.  Returns (x, aux):
    the MoE's load-balance loss, 0.0 for a dense FFN or none."""
    if "ffn" not in p:
        return x, 0.0
    m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_MLP)
    if isinstance(p["ffn"], moe.MoEParams):
        y, aux = moe.moe_forward(p["ffn"], x, cfg.moe, m, ctx.cfg.p, backend)
        return x + y, aux
    return x + layers.mlp_forward(p["ffn"], x, m, ctx.cfg.p, backend), 0.0


def _block_forward(p, kind: str, cfg: ArchConfig, x, positions,
                   ctx: layers.Ctx, layer_id: int, bayes: bool,
                   return_cache: bool = False, backend: str = "cuda"):
    """One block, full sequence.  Returns (x, aux, cache|None)."""
    _check_kind(kind)
    mixer = _parse(kind)[0]
    if mixer == "mamba":
        m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_MIXER)
        res = mamba2.mamba_forward(p["mixer"], x, cfg.ssm, m, ctx.cfg.p,
                                   cfg.d_model, return_state=return_cache,
                                   backend=backend)
    elif mixer == "mla":
        m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_ATTN)
        res = mla.mla_forward(p["mixer"], x, positions, cfg.rope_theta,
                              cfg.mla, m, ctx.cfg.p,
                              return_cache=return_cache, backend=backend)
    else:
        m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_ATTN)
        res = layers.attention_forward(
            p["mixer"], x, positions, cfg.rope_theta, causal=True, mask_in=m,
            p_drop=ctx.cfg.p, return_kv=return_cache, backend=backend)
    cache = None
    if return_cache:
        res, cache = res
    x, aux = _ffn_forward(p, cfg, x + res, ctx, layer_id, bayes, backend)
    return x, aux, cache


def _block_decode(p, kind: str, cfg: ArchConfig, x, cache, pos,
                  ctx: layers.Ctx, layer_id: int, bayes: bool,
                  backend: str = "cuda"):
    """One block, one token.  Returns (x, cache), the cache updated in
    place; a MoE's load-balance loss is discarded, as in the reference."""
    _check_kind(kind)
    mixer = _parse(kind)[0]
    if mixer == "mamba":
        m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_MIXER)
        res, cache = mamba2.mamba_decode(p["mixer"], x, cache, cfg.ssm, m,
                                         ctx.cfg.p, cfg.d_model, backend)
    elif mixer == "mla":
        m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_ATTN)
        res, cache = mla.mla_decode(p["mixer"], x, cache, pos,
                                    cfg.rope_theta, cfg.mla, m, ctx.cfg.p,
                                    backend)
    else:
        m = layers.site_mask(ctx, bayes, layer_id, layers.SITE_ATTN)
        res, cache = layers.attention_decode(p["mixer"], x, cache, pos,
                                             cfg.rope_theta, m, ctx.cfg.p,
                                             backend)
    x, _ = _ffn_forward(p, cfg, x + res, ctx, layer_id, bayes, backend)
    return x, cache


def _stage_bayes(cfg: ArchConfig, layer_offset: int,
                 stage: Stage) -> tuple[bool, ...]:
    """Bayesian on/off per pattern position (not per layer), as the
    reference: position j takes ``cfg.mcd.bayesian(layer_offset + j)``."""
    return tuple(cfg.mcd.bayesian(layer_offset + j)
                 for j in range(len(stage.pattern)))


def _stage_layers(stage: Stage, layer_offset: int):
    """(repeat r, position j, kind, layer id) in the reference's scan
    order."""
    period = len(stage.pattern)
    for r in range(stage.repeat):
        for j, kind in enumerate(stage.pattern):
            yield r, j, kind, layer_offset + r * period + j


class DecodeState(NamedTuple):
    pos: Any          # next position to write: int32 scalar on the device
    caches: Any       # caches[i][r][j] = (k, v), each [B, Smax, KV, hd],
                      # the int8 (k_i8, k_scale, v_i8, v_scale), an
                      # mla.MLACache or a mamba2.MambaState
    cross: Any = None


def _period(sp_r, stage: Stage, cfg: ArchConfig, x, positions,
            ctx: layers.Ctx, r: int, offset: int, bayes, collect: bool,
            backend: str):
    """One repeat's period of blocks (the reference's scan body).  Returns
    (x, the period's aux terms in order, caches of the period)."""
    aux = []
    caches = []
    period = len(stage.pattern)
    for j, kind in enumerate(stage.pattern):
        x, a, c = _block_forward(sp_r[j], kind, cfg, x, positions, ctx,
                                 offset + r * period + j, bayes[j],
                                 return_cache=collect, backend=backend)
        aux.append(a)
        caches.append(c)
    return x, aux, caches


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, ctx: layers.Ctx,
            *, collect_caches: bool = False, return_hidden: bool = False,
            remat: bool = False, backend: str = "cuda"):
    """Full-sequence forward.  tokens: [B, S].  Returns (logits [B, S, V]
    or the hidden state [B, S, D], aux, caches|None).

    ``remat=True`` checkpoints each repeat's period of blocks
    (``torch.utils.checkpoint``, non-reentrant) when autograd records:
    the backward recomputes a period's internals instead of keeping them.
    Masks are functions of ``(seed, rows)``, so the recompute draws the
    same bits and the gradients are those of ``remat=False``."""
    layers.check_backend(backend)
    check_cfg(cfg)
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    ckpt = remat and torch.is_grad_enabled()
    aux = 0.0
    offset = 0
    all_caches = []
    for sp, st in zip(params["stages"], cfg.stages):
        bayes = _stage_bayes(cfg, offset, st)
        caches = []
        stage_aux = 0.0     # the reference's scan carry, one a stage
        for r in range(st.repeat):
            args = (sp[r], st, cfg, x, positions, ctx, r, offset, bayes,
                    collect_caches, backend)
            x, a, c = (_ckpt.checkpoint(_period, *args, use_reentrant=False)
                       if ckpt else _period(*args))
            for term in a:
                stage_aux = stage_aux + term
            caches.append(c)
        aux = aux + stage_aux
        offset += st.num_layers
        all_caches.append(caches)
    out = x if return_hidden else layers.logits(params["embed"], x)
    if collect_caches:
        return out, aux, (all_caches, None)
    return out, aux, None


def _xent_chunk(embed_params, h, t):
    """Summed NLL of one chunk: fp32 logits → log_softmax → the targets'."""
    logp = torch.log_softmax(layers.logits(embed_params, h).float(), dim=-1)
    return -torch.gather(logp, -1, t.long()[..., None])[..., 0].sum()


def _chunked_xent(embed_params, hidden: torch.Tensor, targets: torch.Tensor,
                  chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy without keeping the full fp32 logits.

    The sequence splits into chunks of ``c`` positions, the largest divisor
    of S that is at most ``chunk`` (the reference's rule).  Under autograd
    each chunk is checkpointed, so its [B, c, V] logits live only inside
    their (recomputed) segment.  The chunks' sums add in order from an
    fp32 zero and the total divides by B·S, as the reference's scan."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    ckpt = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        h, t = hidden[:, i:i + c], targets[:, i:i + c]
        total = total + (_ckpt.checkpoint(_xent_chunk, embed_params, h, t,
                                          use_reentrant=False)
                         if ckpt else _xent_chunk(embed_params, h, t))
    return total / (B * S)


def loss_fn(params, cfg: ArchConfig, tokens: torch.Tensor,
            targets: torch.Tensor, ctx: layers.Ctx, *, remat: bool = True,
            xent_chunk: int = 512):
    """Next-token cross-entropy + aux (targets = tokens shifted).  Returns
    ``(nll + aux, {"nll": nll, "aux": aux})``, aux a 0-d fp32 tensor: the
    MoE layers' load-balance losses summed (0 for the dense and SSM
    families).  The forward runs on the ``reference``
    backend: the kernels have no backward, in this package or the
    reference's, and the reference's LM loss reaches none of them."""
    hidden, aux, _ = forward(params, cfg, tokens, ctx, remat=remat,
                             return_hidden=True, backend="reference")
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    nll = _chunked_xent(params["embed"], hidden, targets, xent_chunk)
    return nll + aux, {"nll": nll, "aux": aux}


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.float32, kv_quant: bool = False,
                     device=None):
    """One block's zero decode cache (see :func:`init_decode_state`)."""
    _check_kind(kind)
    dev = resolve_device(device)
    mixer = _parse(kind)[0]
    if mixer == "mamba":
        return mamba2.init_state(batch, cfg.d_model, cfg.ssm, dtype, dev)
    if mixer == "mla":
        return mla.init_cache(batch, max_len, cfg.mla, dtype, dev)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant:
        return tuple(torch.zeros(sh, dtype=dt, device=dev) for sh, dt in
                     ((shape, torch.int8), (shape[:3], torch.bfloat16)) * 2)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.float32, kv_quant: bool = False,
                      device=None) -> DecodeState:
    """Zero decode state: one (k, v) pair of [B, max_len, KV, hd] per
    attention layer -- with ``kv_quant`` the reference's int8 form (k_i8,
    k_scale, v_i8, v_scale): int8 codes [B, max_len, KV, hd] and bf16
    scales [B, max_len, KV] (``_block_cache_spec``) --, a zero
    ``mla.MLACache`` per MLA layer (``kv_quant`` does not apply to it, as
    in the reference) and a zero ``MambaState`` per mamba layer.  Every
    tensor is its own: the caches are updated in place."""
    check_cfg(cfg)
    dev = resolve_device(device)
    return DecodeState(pos=torch.zeros((), dtype=torch.int32, device=dev),
                       caches=[
        [[init_block_cache(cfg, kind, batch, max_len, dtype, kv_quant, dev)
          for kind in st.pattern] for _ in range(st.repeat)]
        for st in cfg.stages])


def _pad_cache_to(cache, kind: str, max_len: int):
    """Pad a (k, v) cache or an ``MLACache`` [B, S, ...] with zeros up to
    max_len positions; a Mamba state (no sequence axis) stays as it is."""
    mixer = _parse(kind)[0]
    if mixer == "mamba":
        return cache

    def pad(a):
        out = a.new_zeros((a.shape[0], max_len, *a.shape[2:]))
        out[:, :a.shape[1]] = a
        return out

    if mixer == "mla":
        return mla.MLACache(pad(cache.c_kv), pad(cache.k_rope))
    return (pad(cache[0]), pad(cache[1]))


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, ctx: layers.Ctx,
            max_len: int, *, backend: str = "cuda"):
    """Process the prompt; return (last-position logits [B, 1, V],
    DecodeState).  The masks drawn here are the ones every later
    decode_step draws again (tied across the whole request)."""
    if tokens.shape[1] > max_len:
        raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds "
                         f"max_len={max_len}")
    hidden, _, (caches, _) = forward(params, cfg, tokens, ctx,
                                     collect_caches=True, return_hidden=True,
                                     backend=backend)
    lg = layers.logits(params["embed"], hidden[:, -1:])
    padded = [[[_pad_cache_to(c, kind, max_len)
                for c, kind in zip(rep, st.pattern)] for rep in stage]
              for st, stage in zip(cfg.stages, caches)]
    pos = torch.full((), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    return lg, DecodeState(pos=pos, caches=padded)


def cache_positions(cfg: ArchConfig, caches) -> int | None:
    """Positions of the attention or MLA caches (a (k, v) cache's k, an
    ``MLACache``'s c_kv: [B, Smax, ...]); None for a model without one (a
    Mamba state has no position limit, as in the reference)."""
    for st, stage in zip(cfg.stages, caches):
        for j, kind in enumerate(st.pattern):
            if _parse(kind)[0] in ("attn", "mla"):
                return stage[0][j][0].shape[1]
    return None


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState, ctx: layers.Ctx, backend: str = "cuda"):
    """One decode step.  token: [B, 1] → (logits [B, 1, V], the state one
    position on).  The caches are updated in place; the position stays on
    the device (``state.pos``, an int32 scalar, is never read on the host),
    so the caller keeps count of the positions (``cache_positions``): a
    step past the attention caches is an index error here."""
    layers.check_backend(backend)
    pos = torch.as_tensor(state.pos, dtype=torch.int32, device=token.device)
    x = layers.embed(params["embed"], token)
    offset = 0
    for sp, st, stage_caches in zip(params["stages"], cfg.stages,
                                    state.caches):
        bayes = _stage_bayes(cfg, offset, st)
        for r, j, kind, layer_id in _stage_layers(st, offset):
            x, stage_caches[r][j] = _block_decode(
                sp[r][j], kind, cfg, x, stage_caches[r][j], pos, ctx,
                layer_id, bayes[j], backend)
        offset += st.num_layers
    lg = layers.logits(params["embed"], x)
    return lg, DecodeState(pos=pos + 1, caches=state.caches,
                           cross=state.cross)
