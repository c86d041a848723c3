"""One-token GQA attention over a KV cache — port of
``repro.kernels.decode_attn``.

:func:`decode_attention` launches the hand-written CUDA kernel
``csrc/decode_attn.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`decode_attention_plain`, the
plain PyTorch version of the same function (a mirror of
``repro/kernels/ref.py::decode_attention``), for CPU tensors.  A CUDA tensor
never reaches the plain version: it launches the kernel or raises.

q: [B, H, hd] (after RoPE); caches: [B, S, KV, hd]; ``pos`` one position
for the whole batch, a Python int or, as the TPU kernel takes it, an int32
tensor of one element on q's device.  Softmax over positions ``<= pos`` of
``(q · k) · hd^-0.5`` with q heads grouped as ``q.reshape(B, KV, rep, hd)``;
returns [B, H, hd] in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Plain PyTorch version: scores over the whole cache, positions past
    ``pos`` (an int or a one-element tensor on q's device) set to -inf, a
    softmax, then the weighted sum of V.  Computes in fp32 (float64 for
    float64 inputs, which makes a float64 witness of the same function)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qr = q.reshape(B, KV, H // KV, hd).to(ct)
    s = torch.einsum("bgrh,bsgh->bgrs", qr, k_cache.to(ct)) * hd ** -0.5
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, torch.full((), -torch.inf, dtype=ct,
                                         device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgh->bgrh", w, v_cache.to(ct))
    return o.reshape(B, H, hd).to(q.dtype)


# The kernel's constants (csrc/decode_attn.cu): 128 threads, tiles of 16
# positions, a ring of 3 tiles; at most 8 q heads a KV head and hd <= 256.
_THREADS, _TILE, _STAGES = 128, 16, 3
_MAX_REP, _MAX_HD = 8, 256
_MIN_BLOCKS = 2 * common.SMS      # blocks a launch should have, at least
_MAX_RUN = 16                     # tiles a block walks, at most


@functools.cache
def decode_plan(B: int, H: int, KV: int, hd: int, S: int,
                elem_bytes: int = 4) -> dict:
    """How ``csrc/decode_attn.cu`` runs a launch, from the shapes alone (never
    ``pos``, so one launch shape serves every decode step and a graph can
    be captured): the position tile and ring stages, the ``splits`` of the
    cache's tiles over blocks, each a ``run`` of tiles (enough blocks to
    fill the card, and no block longer than ``_MAX_RUN`` tiles), the grid
    ``(B * KV, splits)``, the shared memory a block, and the fp32 scratch
    of partials and the merge kernel's grid when ``splits > 1``.  Cached by
    shape, so a decode step's calls build it once; the dict is shared and
    must not be changed.  ``elem_bytes`` 2: the bf16 kernel, whose ring
    holds bf16 tiles (q is widened to fp32 in shared memory; the partials
    stay fp32) and which needs hd a multiple of 8.  Raises ``ValueError``
    for a shape the kernel does not take."""
    if min(B, H, KV, hd, S) < 1:
        raise ValueError(f"empty shape: B={B}, H={H}, KV={KV}, hd={hd}, "
                         f"S={S}")
    if H % KV or H // KV > _MAX_REP:
        raise ValueError(f"H={H} heads must group over KV={KV} heads, at "
                         f"most {_MAX_REP} to a group (B={B})")
    align = 16 // elem_bytes         # a 16-byte copy: 4 fp32 or 8 bf16
    if hd % align or hd > _MAX_HD:
        raise ValueError(f"hd={hd} must be a multiple of {align} and <= "
                         f"{_MAX_HD}")
    rep = H // KV
    tiles = -(-S // _TILE)
    want = min(tiles, max(-(-_MIN_BLOCKS // (B * KV)),
                          -(-tiles // _MAX_RUN)))
    run = -(-tiles // want)
    splits = -(-tiles // run)
    smem = elem_bytes * _STAGES * 2 * _TILE * hd + 4 * rep * hd
    return {"tile": _TILE, "stages": _STAGES, "threads": _THREADS,
            "tiles": tiles, "splits": splits, "run": run,
            "grid": (B * KV, splits), "smem": smem,
            "scratch_floats": B * KV * splits * rep * (hd + 2)
            if splits > 1 else 0,
            "merge_grid": (B * KV, -(-rep * hd // _THREADS))
            if splits > 1 else None}


_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)


@functools.cache
def _ready(index: int) -> None:
    """Load the library (building it on first use) and set the kernels'
    attributes once on device ``index``, so no launch, captured or not,
    sets one."""
    with torch.cuda.device(index):
        err = common.c_entry("decode_attn", "decode_attention_init", ())()
    if err != 0:
        raise RuntimeError(f"decode_attention init failed: CUDA error {err}")


def blocks_per_sm(H: int, KV: int, hd: int, dtype=torch.float32) -> int:
    """The split kernel's resident blocks an SM at this shape and dtype
    (fp32 or bf16), as the CUDA runtime computes them (builds the kernel on
    first use; needs a card)."""
    _ready(torch.cuda.current_device())
    n = ctypes.c_int(0)
    bf16 = "_bf16" if dtype == torch.bfloat16 else ""
    err = common.c_entry("decode_attn",
                         f"decode_attention{bf16}_blocks_per_sm",
                         (ctypes.c_int,) * 3 + (ctypes.c_void_p,))(
        H, KV, hd, ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return n.value


def _pos_arg(pos, S: int, dev) -> tuple[int | None, int]:
    """``(device pointer, value)`` of ``pos``: a tensor is read on the
    device (no host read, no sync, no range check: the kernel takes any
    value), an int is checked here."""
    if isinstance(pos, torch.Tensor):
        if pos.device != dev or pos.dtype != torch.int32 or pos.numel() != 1:
            raise ValueError(f"a tensor pos must be one int32 on {dev}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        return pos.data_ptr(), 0
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache's {S} positions")
    return None, pos


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Attention of one query token per row over the caches' positions
    ``0..pos``.

    CPU tensors run :func:`decode_attention_plain`; CUDA tensors launch the
    kernel on the current stream (one count in ``decode_attention.launches``
    a call, the merge kernel included): fp32, or bf16 q, caches and out
    (its own kernel; fp32 math), ``H / KV <= 8``, ``hd <= 256`` and a
    multiple of 4 (8 at bf16); any other dtype raises.  ``pos`` is an int in ``[0, S)`` or an int32
    tensor of one element on q's device, which the kernel reads there
    (``pos >= S``: every position; ``pos < 0``: zeros, as the TPU kernel).
    The kernel reads no position past ``pos``.
    """
    common.refuse_grad("decode_attention", q, k_cache, v_cache)
    if common.check_device("decode_attention", q):
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be [B, H, hd] and the caches [B, S, KV, "
                         f"hd]; got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    act, variant = common.lm_act("decode_attention", q)
    plan = decode_plan(B, H, KV, hd, S, q.element_size())
    dev = q.device
    pos_ptr, pos_val = _pos_arg(pos, S, dev)
    for name, t, shape in (("q", q, (B, H, hd)),
                           ("k_cache", k_cache, (B, S, KV, hd)),
                           ("v_cache", v_cache, (B, S, KV, hd))):
        common.check(name, t, dev, act, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    part = (torch.empty(plan["scratch_floats"], dtype=torch.float32,
                        device=dev) if plan["splits"] > 1 else None)
    _ready(dev.index)
    common.launch_c(decode_attention, "decode_attn", _ARGTYPES,
                    (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     out.data_ptr(), None if part is None else part.data_ptr(),
                     pos_ptr, B, H, S, KV, hd, pos_val, plan["splits"],
                     plan["run"], hd ** -0.5, common.stream(dev)),
                    f"decode_attention (B={B}, H={H}, KV={KV}, hd={hd}, "
                    f"S={S}, splits={plan['splits']}, {act})", variant,
                    device=dev)
    return out


decode_attention.launches = 0
