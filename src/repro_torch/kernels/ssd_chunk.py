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
# The bf16 tensor-core kernel (``ssd_chunk_scan_kernel_bf16_tc``): two
# warpgroups, tiles of 64 steps, TMA boxes of 64 x 64 bf16 (8 KB), the
# bf16 pieces of G', of the carried state and of B' (kPiecesG, kPiecesS,
# kPiecesB).
_TC_THREADS, _TC_ROWS, _TC_BOX = 256, 64, 64 * 64 * 2
_PIECES = {"G": 3, "S": 2, "B": 2}
# its shared memory: C, B (two boxes a tile), x (one), the state's pieces
# (two boxes each), four fp32 rows of 256, an mbarrier a tile, and 1 KB for
# the alignment of the swizzle.
_TC_SMEM = (1024 + (5 * _MAX_Q // _TC_ROWS + 2 * _PIECES["S"]) * _TC_BOX
            + 4 * 4 * _MAX_Q + 8 * _MAX_Q // _TC_ROWS)


def _wgmma_flop(B, L, H, Q) -> int:
    """The tensor-core kernel's m64n64k16 products (2 * 64 * 64 * 16 flop
    each): per (b, h, chunk) and causal tile pair, S over N = 128 (8) and
    G' x (4 a piece); per query tile past the first chunk the inter term
    (8 a piece of the state); the state update (2 warpgroups x 4 a tile, a
    piece of B' each)."""
    nt = -(-Q // _TC_ROWS)
    pairs = nt * (nt + 1) // 2
    per_chunk = pairs * (8 + 4 * _PIECES["G"]) + 2 * nt * 4 * _PIECES["B"]
    inter = nt * 8 * _PIECES["S"]
    chunks = L // Q
    n = B * H * (chunks * per_chunk + (chunks - 1) * inter)
    return n * 2 * 64 * 64 * 16


def ssd_plan(B: int, L: int, H: int, P: int, N: int,
             q_chunk: int = 256, elem_bytes: int = 4,
             aligned: bool = True) -> dict:
    """How ``csrc/ssd_chunk.cu`` runs a scan.

    ``path`` "cuda_cores" for fp32: the chunk ``Q``; the cumsum kernel (one
    thread per (b, chunk, h), into a scratch shaped like dt); the scores
    pre-pass (one block per (b, chunk) and 64 x 64 tile of the causal half;
    its scratches of ``B * (L / Q) * Q * Q`` floats of C . B and of
    ``B * (L / Q) * N * Q`` of C transposed); the head kernel (one block of
    256 threads per (b, h)); the shared memory of each and the head blocks
    an SM holds.

    bf16 (``elem_bytes`` 2): ``path`` "tensor_cores" where TMA can read x,
    B and C -- P and N multiples of 8 (16-byte rows) and, ``aligned``, the
    three 16-byte aligned: the cumsum kernel, then one block of two
    warpgroups per (b, h) with the whole chunk in shared memory (``smem``,
    one block an SM), no scratch but cs; ``wgmma_flop`` its tensor-core
    work.  Else "widen": the fp32 plan run on fp32 copies of x, B and C
    (``widened_bytes``, with y's fp32 copy).

    Raises ``ValueError`` for a shape no path takes."""
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
    cumsum = {"Q": Q, "chunks": L // Q,
              "cumsum_threads": B * (L // Q) * H,
              "cumsum_blocks": -(-B * (L // Q) * H // _THREADS)}
    if elem_bytes == 2 and aligned and P % 8 == 0 and N % 8 == 0:
        return {"path": "tensor_cores", **cumsum, "threads": _TC_THREADS,
                "blocks": B * H, "smem": _TC_SMEM,
                "blocks_per_sm": _SMEM_SM // (_TC_SMEM + _SMEM_RESERVED),
                "tiles": -(-Q // _TC_ROWS), "pieces": dict(_PIECES),
                "wgmma_flop": _wgmma_flop(B, L, H, Q),
                "scores_bytes": 0, "ct_bytes": 0, "widened_bytes": 0}
    nt = -(-Q // _ST)
    tiles = nt * (nt + 1) // 2
    smem = 4 * (_MAX_N * _MAX_P + _STAGES * (_BK * _TS + _BK * _MAX_P)
                + 4 * _MAX_Q)
    return {"path": "widen" if elem_bytes == 2 else "cuda_cores", **cumsum,
            "threads": _THREADS, "blocks": B * H, "smem": smem,
            "blocks_per_sm": min(2048 // _THREADS,
                                 _SMEM_SM // (smem + _SMEM_RESERVED)),
            "score_tiles": tiles, "score_blocks": B * (L // Q) * tiles,
            "score_smem": 4 * 2 * N * (_ST + 4),
            "scores_bytes": 4 * B * (L // Q) * Q * Q,
            "ct_bytes": 4 * B * (L // Q) * N * Q,
            "widened_bytes": (4 * (2 * B * L * H * P + 2 * B * L * N)
                              if elem_bytes == 2 else 0)}


def ssd_chunk_scan_plain(x, dt, a, bm, cm, d_skip, *, q_chunk: int = 256):
    """Plain PyTorch version: the TPU kernel's body chunk by chunk, all
    (b, h) at once.  Computes in fp32 (float64 for float64 inputs, which
    makes a float64 witness of the same function); y is x's dtype."""
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
# The tensor-core entry: 9 pointers, B, L, H, P, N, Q, y_f32, the stream.
_ARGTYPES_TC = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7 + (
    ctypes.c_void_p,)


def blocks_per_sm() -> int:
    """The head kernel's resident blocks an SM on this card, as the CUDA
    driver computes them (builds the kernel on first use; needs a card)."""
    n = ctypes.c_int(0)
    err = common.c_entry("ssd_chunk", "ssd_chunk_scan_blocks_per_sm",
                         (ctypes.c_void_p,))(ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return n.value


def ssd_chunk_scan(x, dt, a, bm, cm, d_skip, *, q_chunk: int = 256,
                   y_dtype=None):
    """The SSD chunked scan; see the module docstring for the shapes.

    CPU tensors run :func:`ssd_chunk_scan_plain`; CUDA tensors launch the
    kernel on the current stream (counted in ``ssd_chunk_scan.launches``):
    fp32, or bf16 x, bm and cm (dt, a and d_skip fp32; y bf16, the state
    fp32); any other dtype raises; contiguous, P <= 64, N <= 128 and a
    chunk of at most 256 steps.  The path is :func:`ssd_plan`'s, from the
    shapes and the real pointers, and the plan launched is
    ``ssd_chunk_scan.last_plan``.  fp32 runs the cumsum kernel and the
    scores pre-pass into scratches allocated here, then the head kernel.
    bf16 runs on the tensor cores where TMA can read x, bm and cm (the
    cumsum kernel, then ``ssd_chunk_scan_kernel_bf16_tc``; no other
    scratch), else widens x, bm and cm into fp32 scratches, runs the fp32
    launch and rounds y to bf16 (``csrc/ssd_chunk.cu``).  ``y_dtype``
    torch.float32 returns the tensor-core path's y unrounded (the float64
    witness's); y is x's dtype otherwise.  (The plain version gives the
    same unrounded y from fp32 inputs: bf16 values are exact in fp32.)
    """
    common.refuse_grad("ssd_chunk_scan", x, dt, a, bm, cm, d_skip)
    if common.check_device("ssd_chunk_scan", x):
        if y_dtype is not None:
            raise ValueError("y_dtype is the CUDA tensor-core path's; on the "
                             "CPU pass fp32 inputs for an fp32 y")
        return ssd_chunk_scan_plain(x, dt, a, bm, cm, d_skip,
                                    q_chunk=q_chunk)
    if x.ndim != 4 or bm.ndim != 3:
        raise ValueError(f"x must be [B, L, H, P] and bm, cm [B, L, N]; got "
                         f"{tuple(x.shape)}, {tuple(bm.shape)}")
    B, L, H, P = x.shape
    N = bm.shape[-1]
    act, variant = common.lm_act("ssd_chunk_scan", x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, bm, cm))
    plan = ssd_plan(B, L, H, P, N, q_chunk, x.element_size(), aligned)
    Q = plan["Q"]
    dev = x.device
    f32 = torch.float32
    common.check("x", x, dev, act, (B, L, H, P))
    common.check("dt", dt, dev, f32, (B, L, H))
    common.check("a", a, dev, f32, (H,))
    common.check("bm", bm, dev, act, (B, L, N))
    common.check("cm", cm, dev, act, (B, L, N))
    common.check("d_skip", d_skip, dev, f32, (H,))
    what = f"ssd_chunk_scan (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}, {act})"
    if y_dtype not in (None, act) and not (
            y_dtype == f32 and plan["path"] == "tensor_cores"):
        raise ValueError(f"y_dtype {y_dtype}: y is {act}, or fp32 on the "
                         f"tensor-core path only ({plan['path']})")
    cs = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if plan["path"] == "tensor_cores":
        y = torch.empty(x.shape, dtype=y_dtype or act, device=dev)
        common.launch_c(ssd_chunk_scan, "ssd_chunk", _ARGTYPES_TC,
                        (x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                         bm.data_ptr(), cm.data_ptr(), d_skip.data_ptr(),
                         cs.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                         B, L, H, P, N, Q, int(y.dtype == f32),
                         common.stream(dev)), what, "bf16_tc",
                        device=dev)
        ssd_chunk_scan.last_plan = plan
        return y, h_final
    scores = torch.empty((plan["scores_bytes"] // 4,), dtype=torch.float32,
                         device=dev)
    ct = torch.empty((plan["ct_bytes"] // 4,), dtype=torch.float32,
                     device=dev)
    y = torch.empty_like(x)
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
                    what, variant, device=dev)
    ssd_chunk_scan.last_plan = plan
    return y, h_final


ssd_chunk_scan.launches = 0
ssd_chunk_scan.last_plan = None
