"""One-token GQA attention over a KV cache — port of
``repro.kernels.decode_attn``.

:func:`decode_attention` launches the hand-written CUDA kernel
``csrc/decode_attn.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`decode_attention_plain`, the
plain PyTorch version of the same function (a mirror of
``repro/kernels/ref.py::decode_attention``), for CPU tensors.  A CUDA tensor
never reaches the plain version: it launches the kernel or raises.

q: [B, H, hd] (after RoPE); caches: [B, S, KV, hd]; ``pos`` one position
for the whole batch.  Softmax over positions ``<= pos`` of
``(q · k) · hd^-0.5`` with q heads grouped as ``q.reshape(B, KV, rep, hd)``;
returns [B, H, hd] in q's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Plain PyTorch version: scores over the whole cache, positions past
    ``pos`` set to -inf, a softmax, then the weighted sum of V (fp32)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bgrh,bsgh->bgrs", qr, k_cache.float()) * hd ** -0.5
    valid = torch.arange(S, device=q.device) <= int(pos)
    s = torch.where(valid, s, torch.full((), -torch.inf, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgh->bgrh", w, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_void_p)
_MAX_REP, _MAX_HD = 8, 256


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Attention of one query token per row over the caches' positions
    ``0..pos``.

    CPU tensors run :func:`decode_attention_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``decode_attention.launches``):
    fp32, ``H / KV <= 8``, ``hd <= 256`` and a multiple of 4.  The kernel
    reads no position past ``pos``.
    """
    if common.check_device("decode_attention", q):
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be [B, H, hd] and the caches [B, S, KV, "
                         f"hd]; got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    pos = int(pos)
    if B < 1 or KV < 1 or H % KV or H // KV > _MAX_REP:
        raise ValueError(f"H={H} heads must group over KV={KV} heads, at "
                         f"most {_MAX_REP} to a group (B={B})")
    if hd % 4 or hd > _MAX_HD:
        raise ValueError(f"hd={hd} must be a multiple of 4 and <= {_MAX_HD}")
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache's {S} positions")
    if q.dtype != torch.float32:
        raise NotImplementedError(
            f"decode_attention takes fp32 on the card, got {q.dtype}; bf16 "
            "is queued with the serving precisions (ROADMAP.md)")
    dev = q.device
    common.check("q", q, dev, torch.float32, (B, H, hd))
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        common.check(name, t, dev, torch.float32, (B, S, KV, hd))
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    common.launch_c(decode_attention, "decode_attn", _ARGTYPES,
                    (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     out.data_ptr(), B, H, S, KV, hd, pos, hd ** -0.5,
                     common.stream(dev)),
                    f"decode_attention (B={B}, H={H}, KV={KV}, hd={hd}, "
                    f"S={S}, pos={pos})")
    return out


decode_attention.launches = 0
