"""Mixture-of-Experts FFN — port of ``repro.models.moe``: sort-based
dispatch with a static capacity.

Tokens are ordered by expert id (a stable sort, so within an expert in
token order); each expert takes its first ``C`` tokens (:func:`capacity`)
and drops the rest.  The experts run as one dense product batched over E
on ``[E, C, D]`` slots, and each token sums its kept routes' outputs, each
weighted by its top-k probability renormalised over the k.

MCD hook: the router reads the *unmasked* normalised input in fp32; only
the expert input takes the site mask (``layers.apply_site_mask``: the
``masked_activation`` kernel on ``backend="cuda"``).  The shared expert,
where the config has one, is ``layers.mlp_forward`` on the block input,
with the same site mask (``mcd_matmul`` on ``"cuda"``).

Where this is written other than the reference, for the same integers and
the same sums:

* top-k is a stable descending sort: ``jax.lax.top_k`` breaks ties toward
  the lower expert id, ``torch.topk`` does not;
* the expert counts are a ``scatter_add_`` into E zeros, not ``bincount``
  (which reads its length on the host), so a decode step can be captured
  as a CUDA graph; nothing here reads a device value on the host;
* the combine: the reference scatter-adds every slot into its token in
  slot order (XLA's CPU scatter sums in update order).  Here each token
  gathers its k routes' slots, sorts them ascending and adds them one by
  one to an fp32 zero, a dropped route adding nothing: the same sum in the
  same order, without float atomics (``index_add_`` on CUDA would make two
  calls, and a graph against eager, differ in the last bits).

``moe_sharding(groups=G)`` routes within each of G token groups (capacity
a group), as the reference's; its expert and token mesh axes are accepted
and, on the port's one device, the identity.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from repro_torch.models import layers
from repro_torch.models.config import MoEConfig

_MOE_OVERRIDE: dict = {}


@contextlib.contextmanager
def moe_sharding(expert_axis=None, token_axes=None, groups: int = 1):
    """groups > 1: group-local dispatch, tokens routed within each of
    ``groups`` contiguous token groups (each with its own capacity), as the
    reference's.  ``expert_axis`` / ``token_axes`` name the mesh axes the
    reference constrains the dispatch buffers to (experts over tp,
    capacity over dp); the port has no partitioner, so on its one device
    they are the identity, as ``with_sharding_constraint`` is on the
    reference's one-device host mesh: they change no number."""
    old = dict(_MOE_OVERRIDE)
    _MOE_OVERRIDE.update(groups=groups)
    try:
        yield
    finally:
        _MOE_OVERRIDE.clear()
        _MOE_OVERRIDE.update(old)


class MoEParams(NamedTuple):
    router: torch.Tensor     # [D, E] fp32
    wi: torch.Tensor         # [E, D, 2, dffe] (gate ‖ up)
    wo: torch.Tensor         # [E, dffe, D]
    shared: layers.MLPParams | None
    norm: torch.Tensor       # [D]


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype,
             device=None) -> MoEParams:
    """Random parameters at the reference's scales (the router fp32),
    drawn from ``gen``; not the reference's numbers."""
    e, dffe = cfg.num_experts, cfg.d_ff_expert
    return MoEParams(
        router=layers._normal(gen, (d_model, e), d_model ** -0.5,
                              torch.float32, device),
        wi=layers._normal(gen, (e, d_model, 2, dffe), d_model ** -0.5,
                          dtype, device),
        wo=layers._normal(gen, (e, dffe, d_model), dffe ** -0.5, dtype,
                          device),
        shared=(layers.init_mlp(gen, d_model, cfg.num_shared * dffe, dtype,
                                device) if cfg.num_shared else None),
        norm=layers.init_rmsnorm(d_model, dtype, device))


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: at least 8, a multiple of 8."""
    c = math.ceil(num_tokens * cfg.top_k / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties toward
    the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(flat_router, router_w, k: int):
    """The router on [T, D] unmasked inputs: (probs [T, E] fp32, gate_vals
    [T, k] (the top-k probabilities renormalised over the k), gate_idx
    [T, k])."""
    logits = torch.matmul(flat_router.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _assign(flat, gate_vals, gate_idx, E: int, C: int):
    """The sort-based dispatch of [T, D] tokens to E experts of C slots:
    (x_exp [E, C, D], slot_token [E·C] (T where a slot is empty),
    slot_weight [E·C] fp32, counts [E]: routes an expert was given,
    dropped ones too)."""
    T, D = flat.shape
    K = gate_idx.shape[-1]
    dev = flat.device
    eids = gate_idx.reshape(-1)                               # [T·K]
    tids = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    wvals = gate_vals.reshape(-1)
    order = torch.argsort(eids, stable=True)
    eids_s, tids_s, w_s = eids[order], tids[order], wvals[order]
    counts = torch.zeros((E,), dtype=torch.int64, device=dev).scatter_add_(
        0, eids, torch.ones_like(eids))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=dev) - starts[eids_s]
    keep = pos_in_e < C
    slot = torch.where(keep, eids_s * C + pos_in_e, E * C)    # E·C: waste

    slot_token = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    slot_token.scatter_(0, slot, torch.where(keep, tids_s, T))
    slot_weight = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    slot_weight.scatter_(0, slot, torch.where(keep, w_s, 0.0))
    x_pad = torch.cat([flat, flat.new_zeros((1, D))], 0)
    x_exp = x_pad[slot_token[:E * C]].reshape(E, C, D)
    return x_exp, slot_token[:E * C], slot_weight[:E * C], counts


def _dispatch(flat, flat_router, router_w, cfg: MoEConfig, C: int):
    """Route one token group: flat, flat_router [T, D] → (x_exp [E, C, D],
    slot_token [E·C], slot_weight [E·C], counts [E], probs [T, E]), the
    reference's tuple."""
    probs, gate_vals, gate_idx = _route(flat_router, router_w, cfg.top_k)
    return (*_assign(flat, gate_vals, gate_idx, cfg.num_experts, C), probs)


def token_slots(slot_token: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """[T, K] int64: each token's kept slots in ascending order, then E·C
    (a slot past every real one) for each dropped route."""
    n = slot_token.shape[0]
    dev = slot_token.device
    # Slots in token order (stable: ascending within a token); empty
    # slots (token T) sort last and are cut off.
    order = torch.argsort(slot_token, stable=True)
    tok_s = slot_token[order]
    first = torch.searchsorted(tok_s, torch.arange(T, device=dev))
    j = first[:, None] + torch.arange(K, device=dev)          # [T, K]
    jc = torch.clamp(j, max=n - 1)
    mine = (j < n) & (tok_s[jc] == torch.arange(T, device=dev)[:, None])
    return torch.where(mine, order[jc], n)


def _combine(y_exp, slot_token, slot_weight, T: int, K: int):
    """[T, D] fp32: each token's kept routes, ``y · weight`` in fp32, added
    one by one in ascending slot order to an fp32 zero."""
    D = y_exp.shape[-1]
    contrib = y_exp.reshape(-1, D).float() * slot_weight[:, None]
    contrib = torch.cat([contrib, contrib.new_zeros((1, D))], 0)
    slots = token_slots(slot_token, T, K)
    out = torch.zeros((T, D), dtype=torch.float32, device=y_exp.device)
    for k in range(K):
        out = out + contrib[slots[:, k]]
    return out


# fp32 copies of the experts' gate/up weights held at once: a bf16 MoE
# layer widens its experts this many bytes at a time (jamba-1.5-large's 16
# experts are 25.8 GB in fp32; deepseek-v2-lite's 64 and olmoe's fp32
# experts take one product).
WIDEN_BYTES = 4 << 30


def _experts(x_exp: torch.Tensor, p: MoEParams) -> torch.Tensor:
    """x_exp [E, n, D] → [E, n, D]: SwiGLU per expert, batched over E; the
    gate/up product in fp32 (the fp32 views' product: the reference's
    ``preferred_element_type``), ``silu(g)·u`` rounded to x's dtype, the
    down product in x's dtype.  Where the fp32 copy of every expert's
    ``wi`` passes ``WIDEN_BYTES``, the experts are widened and multiplied
    a few at a time: each expert's product is the same fp32 product."""
    E, n, D = x_exp.shape
    dt = x_exp.dtype
    wi = p.wi.to(dt).reshape(E, D, -1)
    xf = x_exp.float()
    step = E if wi.dtype == torch.float32 else max(
        1, WIDEN_BYTES // (wi[0].numel() * 4))
    if step >= E:
        gu = torch.bmm(xf, wi.float())
    else:
        gu = xf.new_empty((E, n, wi.shape[-1]))
        for e in range(0, E, step):
            gu[e:e + step] = torch.bmm(xf[e:e + step], wi[e:e + step].float())
    gu = gu.reshape(E, n, 2, -1)
    g, u = gu[..., 0, :], gu[..., 1, :]
    act = g * torch.sigmoid(g) * u
    return torch.bmm(act.to(dt), p.wo.to(dt))


def moe_forward(p: MoEParams, x: torch.Tensor, cfg: MoEConfig,
                mask_in: layers.SiteMask | None, p_drop: float,
                backend: str = "cuda"):
    """x: [B, S, D] → (y [B, S, D], aux: the load-balance loss, a 0-d fp32
    tensor)."""
    B, S, D = x.shape
    h = layers.rmsnorm(p.norm, x)
    hm = layers.apply_site_mask(h, mask_in, p_drop, backend)
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    G = _MOE_OVERRIDE.get("groups", 1) or 1
    if T % G:
        G = 1
    Tg = T // G
    C = capacity(Tg, cfg)

    flat = hm.reshape(G, Tg, D)
    flat_router = h.reshape(G, Tg, D)            # router: unmasked, fp32
    routed = [_dispatch(flat[g], flat_router[g], p.router, cfg, C)
              for g in range(G)]
    x_exp = torch.stack([r[0] for r in routed], 1)       # [E, G, C, D]
    y_exp = _experts(x_exp.reshape(E, G * C, D), p).reshape(E, G, C, D)
    y_flat = torch.cat([
        _combine(y_exp[:, g], r[1], r[2], Tg, K)
        for g, r in enumerate(routed)], 0)
    y = y_flat.reshape(B, S, D).to(x.dtype)

    if p.shared is not None:
        y = y + layers.mlp_forward(p.shared, x, mask_in, p_drop, backend)

    # Switch-style load-balance loss, over all groups.
    counts = torch.stack([r[3] for r in routed]).sum(0)
    probs = torch.stack([r[4] for r in routed])
    f = counts.float() / max(T * K, 1)
    pmean = probs.mean(dim=(0, 1))
    aux = cfg.router_aux_weight * E * torch.sum(f * pmean)
    return y, aux
