"""Mamba2 / SSD chunked scan (n_groups = 1) — port of
``repro.kernels.ssd_chunk``.

:func:`ssd_chunk_scan` launches the hand-written CUDA kernel
``csrc/ssd_chunk.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`ssd_chunk_scan_plain`, the
plain PyTorch version of the same function (a mirror of the TPU kernel's
body, ``_kernel``: chunk by chunk, the state carried), for CPU tensors.  A
CUDA tensor never reaches the plain version: it launches the kernel or
raises.

x: [B, L, H, P]; dt: [B, L, H] (after softplus); a: [H] (negative); bm, cm:
[B, L, N]; d_skip: [H].  Returns (y [B, L, H, P] in x's dtype, h_final
[B, H, P, N] fp32).  The chunk length is the largest divisor of L that is
at most ``q_chunk`` (:func:`common.largest_divisor`), as in the TPU kernel:
it is part of the function (the rounding depends on it).  The TPU kernel's
``block_h`` tiles VMEM and changes nothing computed; it is not carried
over.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

# The kernel's shapes and tiles (csrc/ssd_chunk.cu): Q <= 256 query rows a
# block (8 warps x 2 groups of 16), P <= 64 and N <= 128 (the register
# tiles), 256 threads, a ring of 3 slots of staged tiles of 16 steps (rows of
# 256 + 4 floats) and of x (rows of 64); the scores pre-pass in 64 x 64
# tiles with rows of 64 + 4 floats.
_MAX_Q, _MAX_P, _MAX_N = 256, 64, 128
_THREADS, _BK, _TS, _ST, _STAGES = 256, 16, 256 + 4, 64, 3
_SMEM_SM = 228 * 1024      # shared memory of one SM (H100) ...
_SMEM_RESERVED = 1024      # ... of which each resident block reserves 1 KB


def ssd_plan(B: int, L: int, H: int, P: int, N: int,
             q_chunk: int = 256) -> dict:
    """How ``csrc/ssd_chunk.cu`` runs a scan: the chunk ``Q``; the cumsum
    kernel (one thread per (b, chunk, h), into a scratch shaped like dt);
    the scores pre-pass (one block per (b, chunk) and 64 x 64 tile of the
    causal half; its scratches of ``B * (L / Q) * Q * Q`` floats of C . B
    and of ``B * (L / Q) * N * Q`` of C transposed); the head kernel (one
    block of 256 threads per (b, h)); the shared memory of each and the
    head blocks an SM holds.  Raises ``ValueError`` for a shape the kernel
    does not take."""
    if min(B, L, H, P, N, q_chunk) < 1:
        raise ValueError(f"empty shape: B={B}, L={L}, H={H}, P={P}, N={N}, "
                         f"q_chunk={q_chunk}")
    if P > _MAX_P or N > _MAX_N:
        raise ValueError(f"P={P} must be <= {_MAX_P} and N={N} <= {_MAX_N}")
    Q = common.largest_divisor(L, q_chunk)
    if Q > _MAX_Q:
        raise ValueError(f"a chunk of {Q} steps at P={P}, N={N}: the "
                         f"kernel's shared memory tiles hold at most "
                         f"{_MAX_Q} query rows")
    nt = -(-Q // _ST)
    tiles = nt * (nt + 1) // 2
    smem = 4 * (_MAX_N * _MAX_P + _STAGES * (_BK * _TS + _BK * _MAX_P)
                + 4 * _MAX_Q)
    return {"Q": Q, "chunks": L // Q, "threads": _THREADS,
            "blocks": B * H, "smem": smem,
            "blocks_per_sm": min(2048 // _THREADS,
                                 _SMEM_SM // (smem + _SMEM_RESERVED)),
            "cumsum_threads": B * (L // Q) * H,
            "cumsum_blocks": -(-B * (L // Q) * H // _THREADS),
            "score_tiles": tiles, "score_blocks": B * (L // Q) * tiles,
            "score_smem": 4 * 2 * N * (_ST + 4),
            "scores_bytes": 4 * B * (L // Q) * Q * Q,
            "ct_bytes": 4 * B * (L // Q) * N * Q}


def ssd_chunk_scan_plain(x, dt, a, bm, cm, d_skip, *, q_chunk: int = 256):
    """Plain PyTorch version: the TPU kernel's body chunk by chunk, all
    (b, h) at once.  Computes in fp32 (float64 for float64 inputs, which
    makes a float64 witness of the same function)."""
    B, L, H, P = x.shape
    q = common.largest_divisor(L, q_chunk)
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    a = a.to(ct)
    d = d_skip.to(ct)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((B, H, P, bm.shape[-1]), dtype=ct, device=x.device)
    ys = []
    for c0 in range(0, L, q):
        xc = x[:, c0:c0 + q].to(ct)                      # [B, Q, H, P]
        dtc = dt[:, c0:c0 + q].to(ct)                    # [B, Q, H]
        bc = bm[:, c0:c0 + q].to(ct)                     # [B, Q, N]
        cc = cm[:, c0:c0 + q].to(ct)
        cs = torch.cumsum(dtc * a, dim=1)                # inclusive
        dtx = dtc[..., None] * xc
        # intra-chunk quadratic term; where(), not a 0/1 product: the
        # decay overflows above the diagonal
        scores = torch.einsum("bqn,bkn->bqk", cc, bc)
        decay = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])
        gate = torch.where(tri[None, :, :, None], decay,
                           torch.zeros((), dtype=ct, device=x.device))
        y = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, gate, dtx)
        # inter-chunk term from the carried state
        y = y + torch.einsum("bqn,bqh,bhpn->bqhp", cc, torch.exp(cs), state)
        # state update
        dec_end = torch.exp(cs[:, -1:, :] - cs)
        state = state * torch.exp(cs[:, -1])[..., None, None] + torch.einsum(
            "bkn,bkh,bkhp->bhpn", bc, dec_end, dtx)
        ys.append((y + d[None, None, :, None] * xc).to(x.dtype))
    return torch.cat(ys, dim=1), state


_ARGTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
# The bf16 entry also takes the four fp32 scratches (x, bm, cm widened; y).
_ARGTYPES_BF16 = (ctypes.c_void_p,) * 15 + _ARGTYPES[11:]


def blocks_per_sm() -> int:
    """The head kernel's resident blocks an SM on this card, as the CUDA
    driver computes them (builds the kernel on first use; needs a card)."""
    n = ctypes.c_int(0)
    err = common.c_entry("ssd_chunk", "ssd_chunk_scan_blocks_per_sm",
                         (ctypes.c_void_p,))(ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return n.value


def ssd_chunk_scan(x, dt, a, bm, cm, d_skip, *, q_chunk: int = 256):
    """The SSD chunked scan; see the module docstring for the shapes.

    CPU tensors run :func:`ssd_chunk_scan_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``ssd_chunk_scan.launches``):
    fp32, or bf16 x, bm and cm (dt, a and d_skip fp32; y bf16, the state
    fp32); any other dtype raises; contiguous, P <= 64, N <= 128 and a
    chunk of at most 256 steps (:func:`ssd_plan`).  The launch runs the
    cumsum kernel and the scores pre-pass into scratches allocated here,
    then the head kernel; at bf16 it first widens x, bm and cm into fp32
    scratches and last rounds y to bf16 (``csrc/ssd_chunk.cu``).
    """
    if common.check_device("ssd_chunk_scan", x):
        return ssd_chunk_scan_plain(x, dt, a, bm, cm, d_skip,
                                    q_chunk=q_chunk)
    if x.ndim != 4 or bm.ndim != 3:
        raise ValueError(f"x must be [B, L, H, P] and bm, cm [B, L, N]; got "
                         f"{tuple(x.shape)}, {tuple(bm.shape)}")
    B, L, H, P = x.shape
    N = bm.shape[-1]
    act, variant = common.lm_act("ssd_chunk_scan", x)
    plan = ssd_plan(B, L, H, P, N, q_chunk)
    Q = plan["Q"]
    dev = x.device
    f32 = torch.float32
    common.check("x", x, dev, act, (B, L, H, P))
    common.check("dt", dt, dev, f32, (B, L, H))
    common.check("a", a, dev, f32, (H,))
    common.check("bm", bm, dev, act, (B, L, N))
    common.check("cm", cm, dev, act, (B, L, N))
    common.check("d_skip", d_skip, dev, f32, (H,))
    scores = torch.empty((plan["scores_bytes"] // 4,), dtype=torch.float32,
                         device=dev)
    ct = torch.empty((plan["ct_bytes"] // 4,), dtype=torch.float32,
                     device=dev)
    cs = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    # At bf16 the fp32 launch reads widened copies and writes an fp32 y.
    wide = ([torch.empty(t.shape, dtype=f32, device=dev)
             for t in (x, bm, cm, x)] if variant else [])
    xs, bs = (wide[0], wide[1]) if variant else (x, bm)
    # 16-byte copies where every row the head kernel stages is aligned
    vec = int(xs.data_ptr() % 16 == 0 and bs.data_ptr() % 16 == 0
              and P % 4 == 0 and N % 4 == 0 and Q % 4 == 0)
    common.launch_c(ssd_chunk_scan, "ssd_chunk",
                    _ARGTYPES_BF16 if variant else _ARGTYPES,
                    (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                     cm.data_ptr(), d_skip.data_ptr(), scores.data_ptr(),
                     ct.data_ptr(), cs.data_ptr(), y.data_ptr(),
                     h_final.data_ptr(), *(t.data_ptr() for t in wide),
                     B, L, H, P, N, Q, vec, common.stream(dev)),
                    f"ssd_chunk_scan (B={B}, L={L}, H={H}, P={P}, N={N}, "
                    f"Q={Q}, {act})", variant)
    return y, h_final


ssd_chunk_scan.launches = 0
