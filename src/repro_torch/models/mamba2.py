"""Mamba2 (SSD) mixer — port of ``repro.models.mamba2``.

Prefill runs the chunked SSD algorithm: a quadratic, attention-like term
within each chunk of ``cfg.chunk`` steps and a linear recurrence of the
state [B, H, P, N] across chunks.  Decode is the one-token recurrent update
of that state and of the causal conv's last ``d_conv - 1`` inputs.

MCD hook: one feature mask on the block input (site ``SITE_MIXER``), tied
across all positions and decode steps.

Every function that masks or scans takes a ``backend`` (as
``repro_torch.models.layers``):

* ``"reference"`` — plain PyTorch mirrors of the reference's jnp code: the
  site mask drawn as bits and multiplied in, the scan :func:`_ssd_chunked`.
* ``"cuda"`` — the site mask through ``layers.apply_site_mask``
  (``masked_activation``) and the prefill scan through
  :func:`repro_torch.kernels.ops.ssd_scan` (``ssd_chunk_scan``).  On CPU
  tensors these run the kernels' plain versions.

The in- and out-projections are ``torch.matmul`` on both backends (the
reference leaves them to XLA), and so is decode, which has no kernel in the
reference.  Decode updates the state in place (the reference returns a new
one), in the reference's order of operations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import SSMConfig


class MambaParams(NamedTuple):
    norm: torch.Tensor       # [D] pre-norm
    in_proj: torch.Tensor    # [D, 2*d_inner + 2*G*N + H]
    conv_w: torch.Tensor     # [conv_dim, d_conv] depthwise
    conv_b: torch.Tensor     # [conv_dim]
    a_log: torch.Tensor      # [H]
    d_skip: torch.Tensor     # [H]
    dt_bias: torch.Tensor    # [H]
    out_norm: torch.Tensor   # [d_inner] gated-output RMSNorm
    out_proj: torch.Tensor   # [d_inner, D]


def dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * cfg.n_groups * cfg.d_state
    return d_inner, n_heads, conv_dim


def init_mamba(gen: torch.Generator, d_model: int, cfg: SSMConfig, dtype,
               device=None) -> MambaParams:
    """Random parameters at the reference's scales and constants
    (``init_mamba``), drawn from ``gen``; not the reference's numbers."""
    d_inner, n_heads, conv_dim = dims(d_model, cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.n_groups * cfg.d_state + n_heads

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    return MambaParams(
        norm=layers.init_rmsnorm(d_model, dtype, device),
        in_proj=layers._normal(gen, (d_model, d_in_proj), d_model ** -0.5,
                               dtype, device),
        conv_w=layers._normal(gen, (conv_dim, cfg.d_conv), 0.1, dtype,
                              device),
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=device),
        a_log=f32(torch.log(torch.linspace(1.0, 16.0, n_heads))),
        d_skip=f32(torch.ones((n_heads,))),
        dt_bias=f32(torch.log(torch.expm1(torch.linspace(1e-3, 0.1,
                                                         n_heads)))),
        out_norm=layers.init_rmsnorm(d_inner, dtype, device),
        out_proj=layers._normal(gen, (d_inner, d_model), d_inner ** -0.5,
                                dtype, device))


def _split_in_proj(proj: torch.Tensor, d_model: int, cfg: SSMConfig):
    d_inner, _, _ = dims(d_model, cfg)
    gn = cfg.n_groups * cfg.d_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * gn]
    dt = proj[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt


def _silu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv by shift-and-add (d_conv taps), in the
    reference's tap order: the newest tap first.  xbc: [B, L, C]."""
    d_conv = w.shape[1]
    L = xbc.shape[1]
    out = xbc * w[:, -1]
    for i in range(1, d_conv):
        shifted = torch.zeros_like(xbc)
        if i < L:
            shifted[:, i:] = xbc[:, :L - i]
        out = out + shifted * w[:, -1 - i]
    return _silu(out + b)


def _ssd_chunked(x, dt, a, bm, cm, d_skip, chunk: int, h0=None):
    """Chunked SSD scan, the reference's jnp ``_ssd_chunked`` in plain
    PyTorch: chunks of ``min(chunk, L)`` steps, L padded with zeros.

    x: [B, L, H, P]; dt: [B, L, H] (post-softplus); a: [H] (negative);
    bm, cm: [B, L, G, N]; h0: the state carried in, [B, H, P, N] (zeros
    when None), widened to fp32 as the reference's ``h_init``.  Returns (y
    [B, L, H, P], h_final [B, H, P, N]).  ``ops.ssd_scan`` and its kernel
    take no ``h0``, as the TPU kernel takes none.
    """
    B, L, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    pad = (-L) % Q

    def padded(t):
        if not pad:
            return t
        return torch.cat([t, t.new_zeros((B, pad, *t.shape[2:]))], dim=1)

    x, dt, bm, cm = padded(x), padded(dt), padded(bm), padded(cm)
    Lp = L + pad
    nc = Lp // Q
    f32 = torch.float32
    xc = x.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H).to(f32)
    bc = bm.reshape(B, nc, Q, G, N).to(f32)
    cc = cm.reshape(B, nc, Q, G, N).to(f32)

    cs = torch.cumsum(dtc * a[None, None, None, :], dim=2)
    dtx = dtc[..., None] * xc.to(f32)                # [B,nc,Q,H,P]

    # --- intra-chunk (quadratic within Q) --------------------------------
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)     # [B,nc,G,Q,Q]
    cs_h = cs.permute(0, 1, 3, 2)                            # [B,nc,H,Q]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # The reference exponentiates every (q, k) and zeroes k > q after the
    # exp; there the log-decay is positive and, summed over a long chunk,
    # exp() overflows to inf, which the backward multiplies by the zero
    # cotangent: NaN gradients (0 * inf).  Masking before the exp gives
    # the same forward values (exp(-inf) = 0) and a finite backward.
    decay = torch.exp(torch.where(tri, cs_h[..., :, None]
                                  - cs_h[..., None, :], -torch.inf))
    dh = decay.reshape(B, nc, G, rep, Q, Q)
    dtx_h = dtx.reshape(B, nc, Q, G, rep, P)
    y_intra = torch.einsum("bcgqk,bcgrqk,bckgrp->bcqgrp", scores, dh, dtx_h)
    del decay, dh                     # ~1 GB each at full width

    # --- chunk states ----------------------------------------------------
    dec_end = torch.exp(cs[..., -1:, :] - cs)                # [B,nc,Q,H]
    s_chunk = torch.einsum("bckgn,bckgr,bckgrp->bcgrpn", bc,
                           dec_end.reshape(B, nc, Q, G, rep), dtx_h)
    s_chunk = s_chunk.reshape(B, nc, H, P, N)
    chunk_decay = torch.exp(cs[:, :, -1, :])                 # [B,nc,H]

    # --- inter-chunk recurrence, the state *before* each chunk ----------
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # [B,nc,H,P,N]

    cin = torch.exp(cs).reshape(B, nc, Q, G, rep)
    y_inter = torch.einsum("bcqgn,bcqgr,bcgrpn->bcqgrp", cc, cin,
                           h_prevs.reshape(B, nc, G, rep, P, N))
    y = (y_intra + y_inter).reshape(B, Lp, H, P) \
        + d_skip[None, None, :, None] * x.to(f32)
    return y[:, :L].to(x.dtype), h


class MambaState(NamedTuple):
    ssm: torch.Tensor    # [B, H, P, N] fp32
    conv: torch.Tensor   # [B, d_conv-1, conv_dim]


def _mixer_inputs(p: MambaParams, x, cfg: SSMConfig, mask_in, p_drop,
                  d_model: int, backend: str):
    """Pre-norm, the site mask and the in-projection: (z, xbc, dt raw)."""
    h = layers.rmsnorm(p.norm, x)
    h = layers.apply_site_mask(h, mask_in, p_drop, backend)
    proj = torch.matmul(h, p.in_proj.to(h.dtype))
    return _split_in_proj(proj, d_model, cfg)


def _heads(v: torch.Tensor, d_inner: int, cfg: SSMConfig, n_heads: int):
    """Split the conv output [..., conv_dim] into x [..., H, P] and B, C
    [..., G, N]."""
    gn = cfg.n_groups * cfg.d_state
    lead = v.shape[:-1]
    xs = v[..., :d_inner].reshape(*lead, n_heads, cfg.head_dim)
    bm = v[..., d_inner:d_inner + gn].reshape(*lead, cfg.n_groups,
                                              cfg.d_state)
    cm = v[..., d_inner + gn:].reshape(*lead, cfg.n_groups, cfg.d_state)
    return xs, bm, cm


def _out(p: MambaParams, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = layers.rmsnorm(p.out_norm, y * _silu(z))
    return torch.matmul(y, p.out_proj.to(y.dtype))


def mamba_forward(p: MambaParams, x: torch.Tensor, cfg: SSMConfig,
                  mask_in: layers.SiteMask | None, p_drop: float,
                  d_model: int, return_state: bool = False,
                  backend: str = "cuda"):
    """Full-sequence mamba block. x: [B, L, D] → [B, L, D] (and the decode
    state after the last position with ``return_state``)."""
    d_inner, n_heads, _ = dims(d_model, cfg)
    z, xbc_raw, dt = _mixer_inputs(p, x, cfg, mask_in, p_drop, d_model,
                                   backend)
    xbc = _causal_conv(xbc_raw, p.conv_w.to(xbc_raw.dtype),
                       p.conv_b.to(xbc_raw.dtype))
    xs, bm, cm = _heads(xbc, d_inner, cfg, n_heads)
    dt = _softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    scan = _ssd_chunked if backend == "reference" else ops.ssd_scan
    y, h_final = scan(xs, dt, a, bm, cm, p.d_skip, cfg.chunk)
    out = _out(p, y.reshape(*y.shape[:2], d_inner), z)
    if return_state:
        # A copy: a view would keep the whole in-projection alive.
        conv_state = xbc_raw[:, -(cfg.d_conv - 1):, :].clone()
        return out, MambaState(ssm=h_final, conv=conv_state)
    return out


def init_state(batch: int, d_model: int, cfg: SSMConfig, dtype,
               device=None) -> MambaState:
    d_inner, n_heads, conv_dim = dims(d_model, cfg)
    return MambaState(
        ssm=torch.zeros((batch, n_heads, cfg.head_dim, cfg.d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                         device=device))


def mamba_decode(p: MambaParams, x: torch.Tensor, state: MambaState,
                 cfg: SSMConfig, mask_in: layers.SiteMask | None,
                 p_drop: float, d_model: int, backend: str = "cuda"):
    """One-token recurrent update. x: [B, 1, D] → (y [B, 1, D], state), the
    state updated in place."""
    d_inner, n_heads, _ = dims(d_model, cfg)
    z, xbc, dt = _mixer_inputs(p, x, cfg, mask_in, p_drop, d_model, backend)
    xbc = xbc[:, 0]                                    # [B, conv_dim]
    w = p.conv_w.to(xbc.dtype)
    hist = torch.cat([state.conv, xbc[:, None, :]], dim=1)   # [B,d_conv,C]
    conv_out = _silu(torch.einsum("bwc,cw->bc", hist, w)
                     + p.conv_b.to(xbc.dtype))
    state.conv.copy_(hist[:, 1:])
    xs, bm, cm = _heads(conv_out, d_inner, cfg, n_heads)
    dt_v = _softplus(dt[:, 0].float() + p.dt_bias)    # [B, H]
    a = -torch.exp(p.a_log)
    decay = torch.exp(dt_v * a)                        # [B, H]
    rep = n_heads // cfg.n_groups
    bm_h = torch.repeat_interleave(bm, rep, dim=1).float()   # [B, H, N]
    cm_h = torch.repeat_interleave(cm, rep, dim=1).float()
    upd = (dt_v[..., None] * xs.float())[..., None] * bm_h[:, :, None, :]
    ssm = state.ssm.mul_(decay[..., None, None]).add_(upd)
    y = torch.matmul(ssm, cm_h[..., None])[..., 0] \
        + p.d_skip[None, :, None] * xs.float()
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    return _out(p, y, z), state
