"""Multi-head Latent Attention (DeepSeek-V2) with absorbed decode — port of
``repro.models.mla``.

Prefill: the compressed latent ``c_kv`` is expanded into per-head K and V
and standard causal attention runs (``layers.blockwise_attention``, values
``v_head_dim`` wide against queries and keys ``nope + rope`` wide).
Decode: the *absorbed* form — the query is projected into the latent space
and attends to the cached latents directly, so a token's cache is
``kv_lora_rank + rope_head_dim`` values a layer (576 at the published
width) instead of per-head keys and values.

MCD hook: one feature mask on the block input (site ``SITE_ATTN``); on
``backend="cuda"`` the ``masked_activation`` kernel, on ``"reference"``
the bits multiplied in.  The latent attention is plain PyTorch on both
backends, as it is plain jnp in the reference.  Decode writes the new
latent into the cache in place at the device position (the reference
returns a new cache), and masks the positions past it from that tensor,
never from a host int, so a decode step can be captured.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers
from repro_torch.models.config import MLAConfig


class MLAParams(NamedTuple):
    norm: torch.Tensor       # [D]
    wq: torch.Tensor         # [D, H, nope+rope]
    w_dkv: torch.Tensor      # [D, kv_lora]
    kv_norm: torch.Tensor    # [kv_lora]
    w_krope: torch.Tensor    # [D, rope_dim]
    w_uk: torch.Tensor       # [kv_lora, H, nope]
    w_uv: torch.Tensor       # [kv_lora, H, v_dim]
    wo: torch.Tensor         # [H, v_dim, D]


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # [B, Smax, kv_lora]
    k_rope: torch.Tensor     # [B, Smax, rope_dim]


def init_mla(gen: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig, dtype, device=None) -> MLAParams:
    """Random parameters at the reference's scales, drawn from ``gen``; not
    the reference's numbers."""
    s = d_model ** -0.5
    lr = cfg.kv_lora_rank
    qdim = cfg.nope_head_dim + cfg.rope_head_dim

    def normal(shape, scale):
        return layers._normal(gen, shape, scale, dtype, device)

    return MLAParams(
        norm=layers.init_rmsnorm(d_model, dtype, device),
        wq=normal((d_model, n_heads, qdim), s),
        w_dkv=normal((d_model, lr), s),
        kv_norm=layers.init_rmsnorm(lr, dtype, device),
        w_krope=normal((d_model, cfg.rope_head_dim), s),
        w_uk=normal((lr, n_heads, cfg.nope_head_dim), lr ** -0.5),
        w_uv=normal((lr, n_heads, cfg.v_head_dim), lr ** -0.5),
        wo=normal((n_heads, cfg.v_head_dim, d_model), s))


def init_cache(batch: int, max_len: int, cfg: MLAConfig, dtype,
               device=None) -> MLACache:
    return MLACache(
        torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype,
                    device=device))


def _latents(p: MLAParams, h: torch.Tensor, positions, theta: float):
    """c_kv [B, S, kv_lora] (normalised) and k_rope [B, S, rope_dim]
    (rotated) of the masked input h [B, S, D]."""
    c_kv = layers.rmsnorm(p.kv_norm, torch.matmul(h, p.w_dkv.to(h.dtype)))
    k_rope = layers.rope(torch.matmul(h, p.w_krope.to(h.dtype))[:, :, None],
                         positions, theta)[:, :, 0]
    return c_kv, k_rope


def mla_forward(p: MLAParams, x: torch.Tensor, positions: torch.Tensor,
                theta: float, cfg: MLAConfig,
                mask_in: layers.SiteMask | None, p_drop: float,
                return_cache: bool = False, backend: str = "cuda"):
    """Full-sequence MLA (train / prefill).  x: [B, S, D] → out [B, S, D]
    (and the ``MLACache`` of the S positions with ``return_cache``)."""
    h = layers.rmsnorm(p.norm, x)
    h = layers.apply_site_mask(h, mask_in, p_drop, backend)
    q = layers._proj(h, p.wq)                             # [B, S, H, qdim]
    nope = cfg.nope_head_dim
    q_rope = layers.rope(q[..., nope:], positions, theta)
    c_kv, k_rope = _latents(p, h, positions, theta)
    k_nope = layers._proj(c_kv, p.w_uk)                   # [B, S, H, nope]
    v = layers._proj(c_kv, p.w_uv)                        # [B, S, H, v]
    B, S, H = q.shape[:3]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H,
                                                     cfg.rope_head_dim)], -1)
    qf = torch.cat([q[..., :nope], q_rope], -1)
    o = layers.blockwise_attention(qf, k, v, causal=True)
    out = layers._out_proj(o, p.wo)
    if return_cache:
        return out, MLACache(c_kv, k_rope)
    return out


def mla_decode(p: MLAParams, x: torch.Tensor, cache: MLACache,
               pos: torch.Tensor, theta: float, cfg: MLAConfig,
               mask_in: layers.SiteMask | None, p_drop: float,
               backend: str = "cuda"):
    """Absorbed one-token decode.  x: [B, 1, D]; ``pos`` the position as an
    int32 tensor on x's device.  The token's latent and rotated key are
    written into ``cache`` in place at ``pos``; returns (out [B, 1, D],
    cache).

    The reference's rounding points: the absorbed query ``q_nope · W_uk``
    and both products after the softmax in x's dtype; the two score
    products in fp32 (the fp32 views': ``preferred_element_type``) times
    ``(nope + rope)^-0.5``; the softmax weights rounded to the cache dtype
    before the fp32 product with the latents, rounded to x's dtype."""
    h = layers.rmsnorm(p.norm, x)
    h = layers.apply_site_mask(h, mask_in, p_drop, backend)
    q = layers._proj(h, p.wq)[:, 0]                       # [B, H, qdim]
    nope = cfg.nope_head_dim
    posv = torch.as_tensor(pos, dtype=torch.int32, device=x.device).reshape(1)
    q_rope = layers.rope(q[:, None, :, nope:], posv, theta)[:, 0]
    c_kv_new, k_rope_new = _latents(p, h, posv, theta)
    at = posv.long()
    cache.c_kv.index_copy_(1, at, c_kv_new.to(cache.c_kv.dtype))
    cache.k_rope.index_copy_(1, at, k_rope_new.to(cache.k_rope.dtype))
    # Absorb W_uk into the query: attention runs in the latent space.
    q_lat = torch.einsum("bnh,lnh->bnl", q[..., :nope], p.w_uk.to(q.dtype))
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    s = (torch.einsum("bnl,btl->bnt", q_lat.float(), cache.c_kv.float())
         + torch.einsum("bnr,btr->bnt", q_rope.float(),
                        cache.k_rope.float())) * scale
    valid = torch.arange(cache.c_kv.shape[1], device=x.device) <= posv
    s = torch.where(valid, s, torch.full((), -torch.inf, device=x.device))
    w = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bnt,btl->bnl", w.to(cache.c_kv.dtype).float(),
                           cache.c_kv.float()).to(x.dtype)
    o = torch.einsum("bnl,lnv->bnv", ctx_lat, p.w_uv.to(x.dtype))
    out = layers._out_proj(o[:, None], p.wo)
    return out, cache
