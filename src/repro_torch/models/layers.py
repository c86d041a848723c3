"""Transformer building blocks with MC-dropout sites — port of the dense
subset of ``repro.models.layers`` (GQA attention with qk-norm, the
decoder's cross-attention, SwiGLU, RoPE, RMSNorm, embedding and head).

Every function takes a ``backend``:

* ``"reference"`` — plain PyTorch mirrors of the reference's jnp code: the
  site mask drawn as bits (:func:`repro_torch.core.mcd.feature_mask`) and
  multiplied in, the decode softmax over the whole cache.
* ``"cuda"`` — the attention site's mask through
  :func:`repro_torch.kernels.ops.mcd_mask_apply`, the MLP's masked gate/up
  product through :func:`repro_torch.kernels.ops.mcd_dense` (fp32 out) and
  the decode softmax over the cache through
  :func:`repro_torch.kernels.ops.flash_decode_attention`.  On CPU tensors
  these run the kernels' plain versions; on CUDA tensors, the kernels.

The q/k/v/o projections, the MLP down projection and the head are
``torch.matmul`` on both backends (the reference leaves them to XLA,
outside any Pallas kernel), and so are the prefill attention, the
encoder's bidirectional attention and the cross-attention, prefill and
decode (:func:`blockwise_attention`, a plain mirror of the reference's).

A site's mask is passed as its coordinates (:class:`SiteMask`: the context,
the layer and the site), not as bits: the reference backend draws the bits
from them (the reference's ``site_mask``), the kernels draw the same bits
in registers.  The mask is tied across positions: a ``[B, S, D]``
activation flattens to ``[B·S, D]`` with each row id repeated S times, so
element (b, s, d) draws stream index ``rows[b]·D + d`` as in the reference.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.core import mcd
from repro_torch.core.mcd import MCDConfig
from repro_torch.kernels import common, ops

BACKENDS = ("cuda", "reference")

# MCD site ids (folded into the RNG key as the `gate` field).
SITE_ATTN = 0
SITE_MLP = 1
SITE_MIXER = 2
SITE_CROSS = 3


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


class Ctx:
    """Per-forward MCD context: who am I (``rows``, uint32 ids in an int64
    tensor), which draw (``seed``), the MCD config and whether masks are off
    altogether (``deterministic``)."""

    def __init__(self, rows: torch.Tensor, seed: int, cfg: MCDConfig,
                 deterministic: bool = False):
        self.rows = rows
        self.seed = int(seed)
        self.cfg = cfg
        self.deterministic = deterministic
        self._kernel_rows: dict[int, torch.Tensor] = {}

    @staticmethod
    def disabled(batch: int, device=None) -> "Ctx":
        return Ctx(torch.zeros((batch,), dtype=torch.int64, device=device),
                   0, MCDConfig(p=0.0), deterministic=True)

    def kernel_rows(self, positions: int) -> torch.Tensor:
        """The kernels' int32 row ids for a ``[B, positions, D]`` activation
        flattened to ``[B·positions, D]``: each row repeated ``positions``
        times (tied across positions), built once per width."""
        rows = self._kernel_rows.get(positions)
        if rows is None:
            rows = common.rows_to_int32(self.rows).repeat_interleave(
                positions).contiguous()
            self._kernel_rows[positions] = rows
        return rows


class SiteMask(NamedTuple):
    """One site's mask by its coordinates; :meth:`bits` draws it."""
    ctx: Ctx
    layer: int
    site: int

    def bits(self, n_feat: int, dtype) -> torch.Tensor:
        """``[B, n_feat]`` keep-mask, the reference's ``site_mask``."""
        c = self.ctx
        return mcd.feature_mask(c.seed, self.layer, c.rows, n_feat, c.cfg.p,
                                kind=mcd.KIND_FEAT, gate=self.site,
                                dtype=dtype)


def site_mask(ctx: Ctx, bayesian: bool, layer_id: int,
              site: int) -> SiteMask | None:
    """The site's mask (tied across positions), or None where it is off."""
    if ctx.deterministic or not bayesian or ctx.cfg.p == 0.0:
        return None
    return SiteMask(ctx, int(layer_id), site)


def apply_site_mask(x: torch.Tensor, mask: SiteMask | None, p: float,
                    backend: str = "cuda") -> torch.Tensor:
    """x: [B, S, D]; the mask is tied across the S positions."""
    if mask is None:
        return x
    B, S, D = x.shape
    if backend == "reference":
        return mcd.apply_mask(x, mask.bits(D, x.dtype)[:, None, :], p)
    y = ops.mcd_mask_apply(x.reshape(B * S, D), mask.ctx.kernel_rows(S),
                           mask.ctx.seed, mask.layer, mask.site, p)
    return y.reshape(B, S, D)


# --------------------------------------------------------------------------
# Normalization / RoPE / embeddings
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, 1) · scale drawn on the generator's device, then moved."""
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(scale)
    return t.to(device=device, dtype=dtype)


def init_rmsnorm(d: int, dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics, rounded to x's dtype, then scaled in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding; x: [..., S, H, hd], positions: [S] or [B, S]; the
    angles in fp32."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions.to(device=x.device,
                          dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if x.ndim == cos.ndim + 1:      # positions lacked a batch dim
        cos, sin = cos[None], sin[None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

class AttnParams(NamedTuple):
    wq: torch.Tensor   # [D, H, hd]
    wk: torch.Tensor   # [D, KV, hd]
    wv: torch.Tensor   # [D, KV, hd]
    wo: torch.Tensor   # [H, hd, D]
    q_scale: torch.Tensor | None   # qk_norm scales, [hd]
    k_scale: torch.Tensor | None
    norm: torch.Tensor             # pre-norm scale [D]


def init_attn(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool, dtype, device=None) -> AttnParams:
    s = d_model ** -0.5
    return AttnParams(
        wq=_normal(gen, (d_model, n_heads, head_dim), s, dtype, device),
        wk=_normal(gen, (d_model, n_kv, head_dim), s, dtype, device),
        wv=_normal(gen, (d_model, n_kv, head_dim), s, dtype, device),
        wo=_normal(gen, (n_heads, head_dim, d_model), s, dtype, device),
        q_scale=(torch.ones((head_dim,), dtype=dtype, device=device)
                 if qk_norm else None),
        k_scale=(torch.ones((head_dim,), dtype=dtype, device=device)
                 if qk_norm else None),
        norm=init_rmsnorm(d_model, dtype, device))


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dnh->bsnh")`` as one product."""
    B, S, D = h.shape
    return torch.matmul(h, w.to(h.dtype).reshape(D, -1)).reshape(
        B, S, *w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")`` as one product."""
    B, S = o.shape[:2]
    return torch.matmul(o.reshape(B, S, -1),
                        wo.to(o.dtype).reshape(-1, wo.shape[-1]))


def _qk_normalize(q, k, p: AttnParams):
    if p.q_scale is not None:
        q = rmsnorm(p.q_scale, q)
        k = rmsnorm(p.k_scale, k)
    return q, k


_ATTN_OVERRIDE: dict = {}


@contextlib.contextmanager
def attention_override(q_block: int | None = None,
                       kv_block: int | None = None):
    """Override the tiling of :func:`blockwise_attention` inside the
    block, as the reference's.  The roofline probes use bigger blocks so
    that a count dispatches at most 64 block bodies.  The reference also
    takes ``unroll`` (XLA counts a scanned body once); here every body
    runs and is counted, so the port has no such option."""
    old = dict(_ATTN_OVERRIDE)
    _ATTN_OVERRIDE.update({k: v for k, v in (("q_block", q_block),
                                             ("kv_block", kv_block))
                           if v is not None})
    try:
        yield
    finally:
        _ATTN_OVERRIDE.clear()
        _ATTN_OVERRIDE.update(old)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over query and KV blocks, the reference's
    blockwise form (its blocks, its update order) in plain PyTorch.  The
    scores and the P·V product are fp32 sums of the operands' fp32 views
    (the reference's ``preferred_element_type=float32``: a product of two
    bf16 values is exact in fp32), P rounded to V's dtype first.  The
    blocks are :func:`attention_override`'s where it set them.

    q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd] (GQA: H = KV · rep).
    """
    q_block = _ATTN_OVERRIDE.get("q_block", q_block)
    kv_block = _ATTN_OVERRIDE.get("kv_block", kv_block)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    rep = H // KV
    qb = common.largest_divisor(Sq, q_block)
    kb = common.largest_divisor(Skv, kv_block)
    scale = hd ** -0.5
    qr = q.reshape(B, Sq // qb, qb, KV, rep, hd)
    kr = k.reshape(B, Skv // kb, kb, KV, hd)
    vr = v.reshape(B, Skv // kb, kb, KV, hdv)
    dev = q.device
    neg_inf = torch.full((), -torch.inf, device=dev)
    zero = torch.zeros((), device=dev)
    outs = []
    for iq in range(Sq // qb):
        qi = qr[:, iq]                                  # [B, qb, KV, rep, hd]
        m = torch.full((B, KV, rep, qb), -torch.inf, device=dev)
        l = torch.zeros((B, KV, rep, qb), device=dev)
        acc = torch.zeros((B, KV, rep, qb, hdv), device=dev)
        for jk in range(Skv // kb):
            kj, vj = kr[:, jk], vr[:, jk]               # [B, kb, KV, hd]
            s = torch.einsum("bqgrh,bkgh->bgrqk", qi.float(),
                             kj.float()) * scale
            if causal:
                qpos = iq * qb + torch.arange(qb, device=dev)[:, None]
                kpos = jk * kb + torch.arange(kb, device=dev)[None, :]
                s = torch.where(qpos >= kpos, s, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, zero)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p.to(vj.dtype).float(), vj.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)            # [B, nq, KV, rep, qb, hdv]
    out = out.permute(0, 2, 3, 1, 4, 5).reshape(B, KV * rep, Sq, hdv)
    return out.transpose(1, 2).to(q.dtype)


def attention_forward(p: AttnParams, x: torch.Tensor,
                      positions: torch.Tensor, theta: float, *, causal: bool,
                      mask_in: SiteMask | None, p_drop: float,
                      return_kv: bool = False, backend: str = "cuda"):
    """Full-sequence attention (prefill).  x: [B, S, D]."""
    h = rmsnorm(p.norm, x)
    h = apply_site_mask(h, mask_in, p_drop, backend)
    q, k, v = _proj(h, p.wq), _proj(h, p.wk), _proj(h, p.wv)
    q, k = _qk_normalize(q, k, p)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    o = blockwise_attention(q, k, v, causal=causal)
    out = _out_proj(o, p.wo)
    if return_kv:
        return out, (k, v)
    return out


_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_kv(kv: torch.Tensor):
    """Per-(batch, token, head) symmetric int8, the reference's
    ``_quantize_kv`` as XLA compiles it: [B, 1, KV, hd] → (int8 codes
    [B, 1, KV, hd], bf16 scales [B, 1, KV]).  The scale is ``max|kv| ·
    float32(1/127)``: XLA rewrites the division by the constant 127 as that
    product (so the compiled reference's codes differ from a true division
    on about one element in 20,000); ``torch.round`` rounds half to even,
    as ``jnp.round``."""
    kf = kv.float()
    scale = kf.abs().amax(dim=-1) * _INV_127
    q = torch.clamp(torch.round(kf / torch.clamp(scale, min=1e-8)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 cache as the reference reads it: ``bf16(codes) ·
    bf16(scale)``, rounded to bf16 ([B, S, KV, hd])."""
    return codes.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def _decode_softmax_plain(q1, k_eff, v_eff, posv):
    """The reference's decode softmax (``attention_decode``): q cast to the
    cache dtype, fp32 scores over the whole cache (the fp32 views'
    product), positions past ``pos`` at -inf, a softmax, the weights cast
    to the cache dtype before the fp32 P·V product.  q1: [B, H, hd]."""
    B, H, hd = q1.shape
    S, KV = k_eff.shape[1], k_eff.shape[2]
    qr = q1.reshape(B, KV, H // KV, hd).to(k_eff.dtype)
    s = torch.einsum("bgrh,bkgh->bgrk", qr.float(), k_eff.float()) \
        * hd ** -0.5
    valid = torch.arange(S, device=q1.device) <= posv
    s = torch.where(valid, s, torch.full((), -torch.inf, device=q1.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgh->bgrh", w.to(v_eff.dtype).float(),
                     v_eff.float())
    return o.reshape(B, H, hd)


def attention_decode(p: AttnParams, x: torch.Tensor, cache,
                     pos: torch.Tensor, theta: float,
                     mask_in: SiteMask | None, p_drop: float,
                     backend: str = "cuda"):
    """Single-token decode with a KV cache.

    x: [B, 1, D]; cache: (k, v), each [B, Smax, KV, hd], or the int8 form
    (k_i8 [B, Smax, KV, hd], k_scale [B, Smax, KV] bf16, v_i8, v_scale);
    ``pos`` the position as a one-element int32 tensor on x's device, read
    there and never on the host (so a captured step decodes the position
    the tensor holds at each replay).  The new token's K and V (their
    codes and scales, :func:`quantize_kv`) are written into the cache **in
    place** at ``pos`` (the reference returns a new cache; a ``pos`` past
    the cache is an index error, where the reference clamps); returns (out
    [B, 1, D], cache).

    The softmax over the cache: on ``"reference"`` the reference's own
    (:func:`_decode_softmax_plain`: weights rounded to the cache dtype); on
    ``"cuda"`` ``decode_attention`` (the TPU kernel's fp32 online
    softmax).  The int8 cache is read as bf16 (:func:`dequantize_kv`, plain
    PyTorch on both backends, as the reference reads it outside any
    kernel), and the kernel then runs at bf16.
    """
    if len(cache) not in (2, 4):
        raise ValueError(f"a KV cache is (k, v) or (k_i8, k_scale, v_i8, "
                         f"v_scale), got {len(cache)} tensors")
    B = x.shape[0]
    h = rmsnorm(p.norm, x)
    h = apply_site_mask(h, mask_in, p_drop, backend)
    q, k, v = _proj(h, p.wq), _proj(h, p.wk), _proj(h, p.wv)
    q, k = _qk_normalize(q, k, p)
    posv = torch.as_tensor(pos, dtype=torch.int32,
                           device=x.device).reshape(1)
    q = rope(q, posv, theta)
    k = rope(k, posv, theta)
    at = posv.long()
    if len(cache) == 4:
        k8, ks, v8, vs = cache
        for buf, val in zip(cache, (*quantize_kv(k), *quantize_kv(v))):
            buf.index_copy_(1, at, val)
        k_eff, v_eff = dequantize_kv(k8, ks), dequantize_kv(v8, vs)
    else:
        k_eff, v_eff = cache
        k_eff.index_copy_(1, at, k.to(k_eff.dtype))
        v_eff.index_copy_(1, at, v.to(v_eff.dtype))
    q1 = q[:, 0].contiguous()                   # [B, H, hd]
    if backend == "reference":
        o = _decode_softmax_plain(q1, k_eff, v_eff, posv)
    else:
        o = ops.flash_decode_attention(q1.to(k_eff.dtype), k_eff, v_eff,
                                       posv)
    o = o.reshape(B, 1, *o.shape[1:]).to(x.dtype)
    return _out_proj(o, p.wo), cache


def cross_attention(p: AttnParams, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, mask_in: SiteMask | None,
                    p_drop: float, backend: str = "cuda") -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (whisper): the
    pre-norm, the ``SITE_CROSS`` mask, the q projection (``q_scale``'s
    norm where qk_norm is on, no RoPE), non-causal
    :func:`blockwise_attention` over all encoder positions and ``wo``.
    x: [B, S, D]; enc_k, enc_v: [B, S_enc, KV, hd].  The same plain pass
    at prefill and at each decode step, as in the reference."""
    h = rmsnorm(p.norm, x)
    h = apply_site_mask(h, mask_in, p_drop, backend)
    q = _proj(h, p.wq)
    if p.q_scale is not None:
        q = rmsnorm(p.q_scale, q)
    o = blockwise_attention(q, enc_k, enc_v, causal=False)
    return _out_proj(o, p.wo)


def cross_kv(p: AttnParams, enc_out: torch.Tensor):
    """A cross block's encoder K/V from the (normed) encoder output
    [B, S_enc, D]: ``(k, v)``, each [B, S_enc, KV, hd], k through
    ``k_scale``'s norm where qk_norm is on."""
    k, v = _proj(enc_out, p.wk), _proj(enc_out, p.wv)
    if p.k_scale is not None:
        k = rmsnorm(p.k_scale, k)
    return k, v


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

class MLPParams(NamedTuple):
    wi: torch.Tensor   # [D, 2, dff] (gate ‖ up)
    wo: torch.Tensor   # [dff, D]
    norm: torch.Tensor


def init_mlp(gen, d_model: int, d_ff: int, dtype, device=None) -> MLPParams:
    return MLPParams(
        wi=_normal(gen, (d_model, 2, d_ff), d_model ** -0.5, dtype, device),
        wo=_normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype, device),
        norm=init_rmsnorm(d_model, dtype, device))


def mlp_forward(p: MLPParams, x: torch.Tensor, mask_in: SiteMask | None,
                p_drop: float, backend: str = "cuda") -> torch.Tensor:
    """SwiGLU with the site mask on its input; the gate/up product is kept
    in fp32 (the reference's ``preferred_element_type``)."""
    h = rmsnorm(p.norm, x)
    B, S, D = h.shape
    wi = p.wi.to(h.dtype).reshape(D, -1)
    if backend == "reference":
        hm = apply_site_mask(h, mask_in, p_drop, backend)
        gu = torch.matmul(hm.float(), wi.float())
    else:
        if mask_in is None:
            rows = torch.zeros((B * S,), dtype=torch.int32, device=h.device)
            seed, layer, pd = 0, 0, 0.0
        else:
            rows = mask_in.ctx.kernel_rows(S)
            seed, layer, pd = mask_in.ctx.seed, mask_in.layer, p_drop
        gu = ops.mcd_dense(h.reshape(B * S, D), wi, rows, seed, layer,
                           SITE_MLP, pd, out_dtype=torch.float32)
    gu = gu.reshape(B, S, 2, -1)
    g, u = gu[..., 0, :], gu[..., 1, :]
    act = g * torch.sigmoid(g) * u
    return torch.matmul(act.to(h.dtype), p.wo.to(h.dtype))


# --------------------------------------------------------------------------
# Embeddings / head
# --------------------------------------------------------------------------

class EmbedParams(NamedTuple):
    table: torch.Tensor        # [V, D]
    head: torch.Tensor | None  # [D, V] (None → tied)
    final_norm: torch.Tensor


def init_embed(gen, vocab: int, d_model: int, tie: bool, dtype,
               device=None) -> EmbedParams:
    return EmbedParams(
        table=_normal(gen, (vocab, d_model), 0.02, dtype, device),
        head=(None if tie else
              _normal(gen, (d_model, vocab), d_model ** -0.5, dtype, device)),
        final_norm=init_rmsnorm(d_model, dtype, device))


def embed(p: EmbedParams, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens.long()]


def logits(p: EmbedParams, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits [B, S, V]: the product of the fp32 views (the
    reference's ``preferred_element_type=float32``)."""
    h = rmsnorm(p.final_norm, x)
    w = p.table.T if p.head is None else p.head
    return torch.matmul(h.float(), w.to(h.dtype).float())
