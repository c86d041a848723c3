"""Fused MC-dropout mask and matrix product — port of
``repro.kernels.mcd_matmul``.

:func:`mcd_matmul` launches the hand-written CUDA kernel
``csrc/mcd_matmul.cu`` (built for ``sm_90a`` by :mod:`.build`, bound with
``ctypes``) for CUDA tensors, and runs :func:`mcd_matmul_plain`, the plain
PyTorch version of the same function (a mirror of
``repro/kernels/ref.py::mcd_matmul``), for CPU tensors.  A CUDA tensor never
reaches the plain version: it launches the kernel or raises.

``y = (x ⊙ z/(1-p)) @ W`` accumulated in fp32, with the mask of
:func:`repro_torch.kernels.bernoulli_mask.masked_activation` drawn at the
global column of x (every row masked, no student exemption).  The result
is cast to ``out_dtype``: ``x.dtype`` by default, as the TPU kernel writes
it; the LM's SwiGLU asks for fp32 (``preferred_element_type``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import prng
from repro_torch.kernels import common
from repro_torch.kernels.bernoulli_mask import masked_activation_plain


def mcd_matmul_plain(x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
                     key: int, p_drop: float,
                     out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: the masked x, then an fp32 product."""
    xm = masked_activation_plain(x, rows, key, p_drop)
    y = torch.matmul(xm.float(), w.float())
    return y.to(x.dtype if out_dtype is None else out_dtype)


# The CUDA-core kernels' two tiles (csrc/mcd_matmul.cu, ``tile`` argument):
# name -> (tile id, rows, columns, threads, K step, ring stages).
TILES = {"wide": (1, 128, 128, 256, 32, 2), "narrow": (0, 64, 96, 256, 32, 3)}
# The bf16 tensor-core kernel's two tiles (``TileTc``): name -> (tile id,
# rows, columns, threads, K step, ring stages, W swizzle bytes): 64 rows
# a consumer warpgroup, and one producer warp.
TC_TILES = {"tc_wide": (2, 128, 256, 288, 64, 4, 128),
            "tc_narrow": (3, 64, 96, 160, 64, 8, 64)}
TC_GROUP_M = 8   # row blocks of a raster group (csrc kGroupM)


def matmul_plan(M: int, N: int, K: int, elem_bytes: int = 4,
                aligned: bool = True) -> dict:
    """How the kernel covers ``[M, K] @ [K, N]``: the path, the tile, its
    grid, the shared memory a block needs and the keep-bit scratch (uint32
    words).

    ``path`` "tensor_cores" for bf16 operands that TMA can read: K and N
    multiples of 8 (rows of 16 bytes) and, ``aligned``, x, W and out
    16-byte aligned.  The 128 x 256 tile of two consumer warpgroups where
    it fills every SM twice over (a prefill), else the 64 x 96 one (a
    decode step: 128 blocks for N = 12288, one wave); the grid is 1-D
    (``blocks``, walked in groups of TC_GROUP_M row blocks), ``grid`` the
    tiles it covers.  The shared memory is ``TileTc::kSmem``: a 1 KB-
    aligned ring of stages (x, W and 4 keep-bit words a row, rounded up
    to 1 KB) and two mbarriers a stage.  The keep-bit rows are padded to 4
    words for TMA.

    ``path`` "cuda_cores" for fp32, and for bf16 off that path: the
    128 x 128 tile when it fills every SM twice over, else the 64 x 96
    one.  No split of K on either: each output's sum runs in index order.
    The shared memory is ``Tile::kSmem``: the ring of raw x, W and a
    keep-bit word a thread, and the double-buffered transposed x tile; the
    entry refuses less.  The bf16 kernel (``elem_bytes`` 2) takes the same
    tiles, its ring holding the raw tiles at 2 bytes an element
    (``TileBf16::kSmem``).
    """
    if min(M, N, K) < 1:
        raise ValueError(f"empty product: M={M}, N={N}, K={K}")
    words = -(-K // 32)
    if elem_bytes == 2 and aligned and K % 8 == 0 and N % 8 == 0:
        wide = TC_TILES["tc_wide"]
        wide_blocks = -(-M // wide[1]) * -(-N // wide[2])
        name = "tc_wide" if wide_blocks >= 2 * common.SMS else "tc_narrow"
        tile, bm, bn, threads, bk, stages, _ = TC_TILES[name]
        stage = -(-(2 * (bm * bk + bk * bn) + 16 * bm) // 1024) * 1024
        grid = (-(-N // bn), -(-M // bm))
        return {"path": "tensor_cores", "tile": name, "tile_id": tile,
                "block": (bm, bn), "threads": threads, "grid": grid,
                "blocks": grid[0] * grid[1],
                "smem": 1024 + stages * stage + 16 * stages,
                "scratch_words": M * -(-words // 4) * 4}
    wide = TILES["wide"]
    wide_blocks = -(-M // wide[1]) * -(-N // wide[2])
    name = "wide" if wide_blocks >= 2 * common.SMS else "narrow"
    tile, bm, bn, threads, bk, stages = TILES[name]
    grid = (-(-N // bn), -(-M // bm))
    if grid[1] > 65535:
        raise NotImplementedError(
            f"mcd_matmul: M={M} needs {grid[1]} row blocks, above the "
            "grid's 65535; split the rows (ROADMAP.md)")
    smem = (stages * (elem_bytes * (bm * bk + bk * bn) + 4 * threads)
            + 4 * 2 * bk * (bm + 4))
    return {"path": "cuda_cores", "tile": name, "tile_id": tile,
            "block": (bm, bn), "threads": threads, "grid": grid,
            "smem": smem, "scratch_words": M * words}


_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float) + (ctypes.c_int,) * 3 \
    + (ctypes.c_void_p,)
# The bf16 entry takes one more int, out_bf16, before the stream.
_ARGTYPES_BF16 = _ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_void_p)


def mcd_matmul(x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
               key: int, p_drop: float, out_dtype=None) -> torch.Tensor:
    """x: [M, K], w: [K, N], rows: [M] uint32 row ids → [M, N].

    ``key`` is the uint32 site key; ``p_drop == 0`` is the plain product.
    CPU tensors run :func:`mcd_matmul_plain`; CUDA tensors launch the kernel
    on the current stream (counted in ``mcd_matmul.launches``): fp32
    operands and fp32 out, or bf16 operands (their own kernels: the mask in
    bf16, fp32 sums; on the tensor cores or the CUDA cores by
    :func:`matmul_plan`'s ``path``) and fp32 or bf16 out; any other dtype
    raises.  The kernel's keep-bit pass writes a scratch of the plan's
    ``scratch_words``, allocated here.  The plan of the last launch, made
    from the real pointers' alignment, is ``mcd_matmul.last_plan``.
    """
    common.refuse_grad("mcd_matmul", x, w)
    if common.check_device("mcd_matmul", x):
        return mcd_matmul_plain(x, w, rows, key, p_drop, out_dtype)
    common.check_p(p_drop)
    act, variant = common.lm_act("mcd_matmul", x)
    out_dtype = act if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, act):
        raise NotImplementedError(
            f"mcd_matmul writes fp32 or x's dtype on the card, got {act} -> "
            f"{out_dtype} (ROADMAP.md, A2)")
    if x.ndim != 2 or w.ndim != 2 or min(*x.shape, w.shape[1]) < 1:
        raise ValueError(f"x must be [M, K] and w [K, N], non-empty; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    common.check("x", x, dev, act, (M, K))
    common.check("w", w, dev, act, (K, N))
    rows32 = common.rows_arg(rows, M, dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
    plan = matmul_plan(M, N, K, x.element_size(), aligned)
    thr, scale, masked = common.mask_args(p_drop, act)
    bits = (torch.empty(plan["scratch_words"], dtype=torch.int32, device=dev)
            if masked else None)
    args = (x.data_ptr(), w.data_ptr(), rows32.data_ptr(),
            0 if bits is None else bits.data_ptr(), out.data_ptr(),
            M, N, K, int(key) & prng.MASK32, thr, scale, masked,
            plan["tile_id"], plan["smem"])
    if variant:
        args += (int(out_dtype == torch.bfloat16),)
    common.launch_c(mcd_matmul, "mcd_matmul",
                    _ARGTYPES_BF16 if variant else _ARGTYPES,
                    (*args, common.stream(dev)),
                    f"mcd_matmul (M={M}, N={N}, K={K}, {plan['tile']}, "
                    f"{act} -> {out_dtype})", variant, device=dev)
    mcd_matmul.last_plan = plan
    return out


mcd_matmul.launches = 0
mcd_matmul.last_plan = None
