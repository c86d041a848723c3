"""Host side shared by the port's kernels: the recurrent ones
(``mcd_lstm_seq``, ``mcd_gru_seq``, ``mcd_lstm_step``, ``mcd_gru_step``)
and, for the mask rule, the checks and :func:`launch_c`, the LM's
(``masked_activation``, ``mcd_matmul``, ``decode_attention``,
``ssd_chunk_scan``).

* The mask rule (:func:`gate_mask`) and the mask factors each gate view is
  multiplied by (:func:`gate_mask_factors`): the plain stream the kernels'
  own factors are held against.  A cell of G gates takes 2G keys (x side,
  then h side): 8 for the LSTM, 6 for the GRU.
* The kernels' operand forms: int32 rows (:func:`rows_to_int32`), keys and
  mask constants as launch arguments, the row tile of the block-per-rows
  kernels (:func:`tile_rows`), the sequence and step kernels' launch
  plans (warp, block, or the wide path's cluster / split,
  :func:`seq_plan`, :func:`step_plan`, :func:`wide_plan`), and the card's
  limits the launch plans respect (``SMEM_MAX``, ``SMS``).
* Operand checks and the launch rule (:func:`launch`): a CUDA tensor
  launches the kernel or raises, nothing falls back, and each launch is
  counted on its wrapper.  No kernel has a backward: every entry point
  refuses an operand that requires grad under grad mode
  (:func:`refuse_grad`), on every device.
* The card's mask factors (:func:`kernel_mask_factors`), for holding the
  kernels' bits against the plain stream.
* The serving precisions' operand rules: factors and the launch scale in
  the activation dtype, the rounded masked views (:func:`masked_view`),
  the plain versions' weights (:func:`plain_weights`) and the checks of
  quantized weight operands (:func:`check_seq_weights`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import prng
from repro_torch.kernels import build, quantize

_THREADS = 128          # target threads per block: R rows x H units
_SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 227 * 1024   # dynamic shared memory a block may take (H100)
SMS = 132               # streaming multiprocessors of an H100 SXM


def gate_mask(key: int, rows: torch.Tensor, feat_dim: int,
              p_drop: float) -> torch.Tensor:
    """Keep bits ``[B, feat_dim]``: ``mix32(key ^ mix32(row·F + col)) >= t``.

    ``rows`` holds uint32 row ids (int64 or int32 tensors; an int32 student
    row is its uint32 bit pattern).  Every row draws its bits: the student
    exemption of the recurrent kernels is :func:`gate_mask_factors`'s, and
    the LM kernels (the reference's ``ref._mask``) have none.
    """
    rows = prng.as_u32(rows)
    cols = torch.arange(feat_dim, dtype=torch.int64, device=rows.device)
    idx = (prng.mul_u32(rows[:, None], feat_dim) + cols) & prng.MASK32
    bits = prng._mix32(prng.as_u32(key, rows.device) ^ prng._mix32(idx))
    return bits >= prng.bernoulli_keep_threshold(p_drop)


def largest_divisor(n: int, at_most: int) -> int:
    """The largest divisor of ``n`` that is ``<= at_most``: the TPU
    kernels' block fit (attention blocks, SSD chunks)."""
    d = min(at_most, n)
    while n % d:
        d -= 1
    return d


def rowwise(fn, v: torch.Tensor, span: tuple[int, int] | None = None
            ) -> torch.Tensor:
    """``fn(v)`` for an elementwise ``fn``, evaluated row by row.

    PyTorch's CPU kernels run a flat tensor through a vector loop and its
    tail through a scalar loop, and their ``exp``/``tanh`` differ in the
    last bit between the two; which elements land in the tail depends on
    the batch size.  Copied into rows that cannot merge (a row stride one
    longer than the row), every row of ``v`` [B, ...] takes the same path
    whatever B, so a row's result does not depend on the rows around it —
    the CUDA kernels' property (one thread per row and unit).

    ``span=(lo, width)``: ``v`` [B, n] holds columns ``lo .. lo + n`` of
    rows ``width`` wide (one model-axis entry's slice of the hidden units,
    ``launch.rnn_shardings``).  Each element is evaluated at its own column
    of a row of the full width, so it takes the path it takes unsliced.
    """
    B = v.shape[0]
    flat = v.reshape(B, -1)
    n = flat.shape[1]
    lo, width = (0, n) if span is None else span
    alloc = torch.empty if width == n else torch.zeros
    buf = alloc((B, width + 1), dtype=v.dtype, device=v.device)[:, :-1]
    buf[:, lo:lo + n].copy_(flat)
    return fn(buf)[:, lo:lo + n].reshape(v.shape)


def rows_to_int32(rows: torch.Tensor) -> torch.Tensor:
    """uint32 row ids (any int dtype) as the kernels' int32 view, where the
    student flag (the uint32 high bit) is the sign bit."""
    r = prng.as_u32(rows)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)


def key_list(keys, n: int | None = None) -> list[int]:
    """The gate keys (a tensor or a sequence) as uint32 ints; ``n`` checks
    their count."""
    if isinstance(keys, torch.Tensor):
        keys = keys.reshape(-1).tolist()
    ks = [int(k) & prng.MASK32 for k in keys]
    if len(ks) % 2 or (n is not None and len(ks) != n):
        raise ValueError(f"keys must hold the {n or 'x-side and h-side'} "
                         f"gate keys, got {len(ks)}")
    return ks


def keys_arg(keys, n: int):
    """The ``n`` gate keys as the kernels' launch argument, a ctypes uint32
    array, built once a key tuple (the step backends launch T times a
    layer with the same keys)."""
    if isinstance(keys, torch.Tensor):
        keys = keys.reshape(-1).tolist()
    return _keys_array(tuple(keys), n)


@functools.lru_cache(maxsize=256)
def _keys_array(keys: tuple, n: int):
    return (ctypes.c_uint32 * n)(*key_list(keys, n))


def scale(p_drop: float, dtype=torch.float32) -> torch.Tensor:
    # 1/(1-p) computed in double, then rounded to the activation dtype —
    # the reference's jnp.asarray(1.0 / (1.0 - p), x.dtype).
    return torch.tensor(1.0 / (1.0 - p_drop), dtype=dtype)


@functools.lru_cache(maxsize=64)
def mask_args(p_drop: float,
              dtype=torch.float32) -> tuple[int, float, int]:
    """``(threshold, scale, masked)`` as the kernels take them, the scale
    rounded to the activation ``dtype`` (cached: a model has a few dropout
    rates and the kernels take them at every launch)."""
    masked = p_drop > 0.0
    return (prng.bernoulli_keep_threshold(p_drop),
            float(scale(p_drop, dtype)) if masked else 1.0, int(masked))


def gate_mask_factors(keys, rows: torch.Tensor, in_dim: int, hidden: int,
                      p_drop: float, dtype=torch.float32):
    """The factors each gate view is multiplied by: ``[B,G,I]``, ``[B,G,H]``
    for a cell of G gates (``len(keys) == 2G``), in the activation
    ``dtype``.

    ``1/(1-p)`` (rounded to ``dtype``) where the keep bit is set, 0 where it
    is not, and 1 for student rows or ``p_drop == 0`` — so ``x * factor``,
    rounded to ``dtype``, is the reference's ``where(det, x, where(mask,
    x * scale, 0))``.
    """
    ks = key_list(keys)
    G = len(ks) // 2
    dev = rows.device
    B = rows.shape[0]
    if p_drop <= 0.0:
        return (torch.ones((B, G, in_dim), dtype=dtype, device=dev),
                torch.ones((B, G, hidden), dtype=dtype, device=dev))
    sc = scale(p_drop, dtype).to(dev)
    det = (prng.as_u32(rows) >= 2 ** 31)[:, None, None]

    def factors(offset, feat):
        keep = torch.stack([gate_mask(ks[offset + g], rows, feat, p_drop)
                            for g in range(G)], dim=1)
        f = torch.where(keep, sc, torch.zeros((), dtype=dtype, device=dev))
        return torch.where(det, torch.ones((), dtype=dtype, device=dev), f)

    return factors(0, in_dim), factors(G, hidden)


def masked_view(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The gate views ``v[:, None, :] * f`` ([B, G, F]) as the gate sums
    take them: a bf16 product is rounded to bf16 (the reference's ``x *
    scale`` in the activation dtype, the kernels' round at the masked
    view), then held in fp32, where a bf16 value and the product of two
    are exact; an fp32 (or float64) product as it is."""
    m = v[:, None, :] * f
    return m.float() if m.dtype == torch.bfloat16 else m


def x_side_sums(x: torch.Tensor, fx: torch.Tensor,
                wx: torch.Tensor) -> torch.Tensor:
    """The plain versions' x-side gate sums: for x ``[B, I]`` (one step) or
    ``[B, T, I]`` (every step of a sequence at once), the rows' factors
    ``fx [B, G, I]`` and ``wx [I, G, H]``, the masked views
    (:func:`masked_view`) times the weights, added in index order from 0 by
    elementwise fp32 operations: ``[B, G, H]`` or ``[B, T, G, H]``.  The x
    side does not read h, so a sequence's steps are summed together, 2I
    launches a layer on the card instead of 2I a step; every element is the
    same chain of products and sums either way."""
    lead = x.shape[:-1]
    B, G, I = fx.shape
    f = fx.reshape(B, *([1] * (x.ndim - 2)), G, I)
    xg = x.unsqueeze(-2) * f                  # [..., G, I]
    xg = xg.float() if xg.dtype == torch.bfloat16 else xg
    acc = torch.zeros((*lead, G, wx.shape[-1]), device=x.device)
    for i in range(wx.shape[0]):
        acc = acc + xg[..., i, None] * wx[i]
    return acc


def plain_weights(wx, wh, act, hidden: int, weight_bits=None, wx_scale=None,
                  wh_scale=None):
    """The gate weights a plain version computes with: fp32 tensors holding
    the activation-dtype values the kernels use -- ``wx``/``wh`` cast to
    ``act``, or, with ``weight_bits`` 8 / 4, their codes dequantized as the
    sequence kernels do (:func:`repro_torch.kernels.quantize.kernel_weight`:
    ``float32(q) * scale``, rounded to ``act``)."""
    if weight_bits is None:
        return wx.to(act).float(), wh.to(act).float()
    if wx_scale is None or wh_scale is None:
        raise ValueError("weight_bits set but wx_scale/wh_scale missing")
    return tuple(quantize.kernel_weight(w, s, weight_bits, hidden=hidden,
                                        act_dtype=act).float()
                 for w, s in ((wx, wx_scale), (wh, wh_scale)))


def check_seq_weights(gates: int, dev, act, I: int, H: int, wx, wh, b,
                      weight_bits, wx_scale, wh_scale):
    """Check a sequence kernel's weight operands: ``wx [I, G, H]`` and
    ``wh [H, G, H]`` in the activation dtype, or int8 codes
    (``weight_bits`` 8) or packed int4 codes (4: uint8, last axis
    ``ceil(H/2)``) with fp32 ``[G, H]`` scales, over bf16 activations; the
    bias fp32 ``[G, H]``."""
    f32 = torch.float32
    check("b", b, dev, f32, (gates, H))
    if weight_bits is None:
        check("wx", wx, dev, act, (I, gates, H))
        check("wh", wh, dev, act, (H, gates, H))
        return
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8, 4 or None, got "
                         f"{weight_bits!r}")
    if act != torch.bfloat16:
        raise TypeError("quantized weights run over bf16 activations "
                        f"(the int8/int4 precisions), got x of {act}")
    wdt, wl = ((torch.int8, H) if weight_bits == 8
               else (torch.uint8, -(-H // 2)))
    check("wx", wx, dev, wdt, (I, gates, wl))
    check("wh", wh, dev, wdt, (H, gates, wl))
    for name, sc in (("wx_scale", wx_scale), ("wh_scale", wh_scale)):
        if sc is None:
            raise ValueError(f"weight_bits={weight_bits} needs {name}")
        check(name, sc, dev, f32, (gates, H))


#: The activation storage the kernels take: dtype -> (code, bytes).
ACT_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 2)}


def lm_act(name: str, t: torch.Tensor):
    """The activation dtype of an LM kernel's operand on the card: fp32, or
    bf16 (the reference's LM dtype), whose entry is the ``bf16`` variant;
    ``NotImplementedError`` for any other precision."""
    if t.dtype not in ACT_DTYPES:
        raise NotImplementedError(
            f"{name} takes fp32 or bf16 on the card, got {t.dtype}; no other "
            "precision of the LM kernels is planned (ROADMAP.md, A2)")
    return t.dtype, ("bf16" if t.dtype == torch.bfloat16 else "")


def act_dtype_of(t: torch.Tensor):
    """The activation dtype of a plain-version operand: bf16 stays bf16,
    every other float computes in fp32."""
    return torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32


def check_act(name: str, t: torch.Tensor):
    """The activation dtype of a kernel operand (fp32 or bf16), raising
    ``TypeError`` for any other."""
    if t.dtype not in ACT_DTYPES:
        raise TypeError(f"{name} must be torch.float32 or torch.bfloat16, "
                        f"got {t.dtype}")
    return t.dtype


def _block_rows(gates: int, in_dim: int, hidden: int) -> int | None:
    """The block path's rows a block (~128 threads, shrunk to fit shared
    memory), or None where the block path cannot take the layer."""
    if hidden > BLOCK_H_MAX:
        return None
    rows = max(1, _THREADS // hidden)
    per_row = (gates * (in_dim + hidden) + in_dim + hidden) * 4
    while rows > 1 and rows * per_row > _SMEM_DEFAULT:
        rows -= 1
    return None if rows * per_row > SMEM_MAX else rows


def tile_rows(gates: int, in_dim: int, hidden: int) -> int:
    """Batch rows per block on the block path: ~128 threads, shrunk to fit
    shared memory.  Raises ``NotImplementedError`` for a layer the block
    path cannot take (H above 1024, one thread per hidden unit; or one
    row's mask factors, x and h above a block's shared memory): those run
    on the wide path (:func:`wide_plan`)."""
    rows = _block_rows(gates, in_dim, hidden)
    if rows is None:
        raise NotImplementedError(
            f"I={in_dim}, H={hidden}: the block path holds whole rows in one "
            f"block (one thread per hidden unit, H <= {BLOCK_H_MAX}; the "
            "rows' mask factors, x and h in shared memory); such a layer "
            "runs on the wide path (common.wide_plan: a cluster split of H "
            "for the sequence kernels, unit slices for the step kernels)")
    return rows


# The wide path (csrc/mcd_wide.cuh): its constants are the source's.
WIDE_CHUNK = 128          # contraction indices a staged chunk (kWideChunk)
WIDE_ROWS_THREAD = 2      # rows a thread carries (kWideRowsThread)
WIDE_THREADS = 1024       # threads a block at most (kWideThreads)
CLUSTER_MAX = 16          # blocks a cluster (kClusterMax; > 8 non-portable)
WIDE_UNITS = 128          # target hidden units a block
WIDE_ROW_GROUPS = 8       # row groups a block at most: <= 16 rows a tile
WIDE_H_MAX = CLUSTER_MAX * WIDE_THREADS   # 16384: one unit a thread
BLOCK_H_MAX = 1024        # the block path: one thread per hidden unit


def wide_plan(gates: int, batch: int, in_dim: int, hidden: int,
              path: str) -> dict:
    """The wide path of the recurrent kernels (``csrc/mcd_wide.cuh``): the
    sequence kernels' ``"cluster"`` path and the step kernels' ``"split"``
    path, for every layer the warp and block paths refuse.

    H is cut into ``cluster`` slices of ``units`` contiguous units, one
    slice a block (``cluster`` the least power of two, up to CLUSTER_MAX,
    that makes a slice at most WIDE_UNITS units; so H up to WIDE_H_MAX
    takes one unit a thread, and no slice is empty), the
    rows into tiles of ``rows`` (WIDE_ROWS_THREAD a thread, up to
    WIDE_ROW_GROUPS row groups a block, no more than the batch needs).  A
    block has ``threads`` = units x row groups threads, each owning one
    unit (``thread_units``) and WIDE_ROWS_THREAD rows (``thread_rows``).
    On the cluster path the ``cluster`` blocks of a tile are one thread
    block cluster and ``blocks`` = tiles x cluster; each block's shared
    memory holds its units' masked h ([rows][G][units] floats) and a staged
    chunk ([rows][G][WIDE_CHUNK]).  On the split path the blocks are
    independent (the same grid) and hold the chunk alone.  Neither I nor
    the batch is bounded; H above WIDE_H_MAX raises
    ``NotImplementedError``.
    """
    if path not in ("cluster", "split"):
        raise ValueError(f"path must be 'cluster' or 'split', got {path!r}")
    if hidden > WIDE_H_MAX:
        raise NotImplementedError(
            f"H={hidden} > {WIDE_H_MAX}: the wide path takes one hidden unit "
            f"a thread in clusters of at most {CLUSTER_MAX} blocks of "
            f"{WIDE_THREADS} threads (ROADMAP.md, B1.3)")
    cluster = 1
    while cluster < min(CLUSTER_MAX, -(-hidden // WIDE_UNITS)):
        cluster *= 2
    units = -(-hidden // cluster)
    groups = max(1, min(WIDE_THREADS // units, WIDE_ROW_GROUPS,
                        -(-batch // WIDE_ROWS_THREAD)))
    rows = groups * WIDE_ROWS_THREAD
    pub = units if path == "cluster" else 0
    return {"path": path, "rows": rows, "threads": units * groups,
            "blocks": -(-batch // rows) * cluster, "cluster": cluster,
            "units": units, "thread_units": 1,
            "thread_rows": WIDE_ROWS_THREAD,
            "smem": 4 * rows * gates * (pub + WIDE_CHUNK)}


_WARP_BLOCKS = (4, 2, 1)   # warps a block on the warp path, largest first
X_RING = 8                 # x_t slots a row on the warp path (kXRing)
STEP_WARPS = 8             # warps a block on the step kernel's warp path


def seq_plan(gates: int, batch: int, in_dim: int, hidden: int,
             act_bytes: int = 4) -> dict:
    """How a sequence kernel of ``gates`` gates (``csrc/mcd_lstm_seq.cu``:
    4, ``csrc/mcd_gru_seq.cu``: 3) runs a layer: its path, the rows a
    block, the threads and blocks, and the shared memory a block needs.

    H that divides 32 takes the warp path: a row's H units are H lanes of
    one warp, ``32 // H`` rows a warp, 4, 2 or 1 warps a block -- the most
    that still make two blocks an SM, so the rows spread over every SM --
    with the layer's wx (dequantized at kernel entry, at the activation
    width ``act_bytes``: 4 for fp32, 2 for bf16, int8 and int4; padded to
    whole 4-byte words), the rows' fp32 mask factors and a ring of
    ``X_RING`` x steps a row (one 4-byte word an element, whatever the
    activation width) in shared memory.  Every other H takes the block path
    (one thread per (row, unit), :func:`tile_rows` rows a block; x and h
    held as fp32 values, a bf16 value being exact in fp32, so its plan does
    not depend on the precision), and so does an input too wide for the
    warp path's shared memory (its wx alone: ``act_bytes * gates * I * H``
    bytes).  Every layer the block path cannot take (H above 1024, or a
    row's mask factors, x and h above a block's shared memory) takes the
    cluster path (:func:`wide_plan`), whose plan does not depend on the
    precision either.  All three compute the same bits.
    """
    if min(batch, in_dim, hidden) < 1:
        raise ValueError(f"empty layer: B={batch}, I={in_dim}, H={hidden}")
    if 32 % hidden == 0:
        per_warp = 32 // hidden
        warps = -(-batch // per_warp)
        fits = []
        for wpb in _WARP_BLOCKS:
            rows = wpb * per_warp
            smem = 4 * (rows * (gates * (in_dim + hidden) + X_RING * in_dim)
                        + -(-act_bytes * gates * in_dim * hidden // 4))
            if smem <= SMEM_MAX:
                fits.append((wpb, rows, smem))
        if fits:
            wpb, rows, smem = next((f for f in fits
                                    if -(-warps // f[0]) >= 2 * SMS),
                                   fits[-1])
            return {"path": "warp", "rows": rows, "threads": 32 * wpb,
                    "blocks": -(-batch // rows), "smem": smem}
    return _block_plan(gates, batch, in_dim, hidden, "cluster")


@functools.cache
def step_plan(gates: int, batch: int, in_dim: int, hidden: int) -> dict:
    """How a step kernel of ``gates`` gates (``csrc/mcd_lstm_step.cu``: 4,
    ``csrc/mcd_gru_step.cu``: 3) runs one step: its path, the rows a
    block, the threads, blocks and shared memory a block needs (cached by
    shape, as the step backend asks the same T times a layer).

    H that divides 32 takes the warp path: a row's H units are H lanes of
    one warp, ``32 // H`` rows a warp, ``STEP_WARPS`` warps a block (fewer
    when the batch has fewer), and no shared memory.  Every other H takes
    the block path (:func:`_block_plan`), and a layer the block path cannot
    take the split path (:func:`wide_plan`).  All three compute the same
    bits.
    """
    if min(batch, in_dim, hidden) < 1:
        raise ValueError(f"empty step: B={batch}, I={in_dim}, H={hidden}")
    if 32 % hidden == 0:
        per_warp = 32 // hidden
        wpb = min(STEP_WARPS, -(-batch // per_warp))
        rows = wpb * per_warp
        return {"path": "warp", "rows": rows, "threads": 32 * wpb,
                "blocks": -(-batch // rows), "smem": 0}
    return _block_plan(gates, batch, in_dim, hidden, "split")


def _block_plan(gates: int, batch: int, in_dim: int, hidden: int,
                wide: str) -> dict:
    """The block path of the recurrent kernels: one thread per (row, unit),
    :func:`tile_rows` rows a block, the rows' mask factors, x and h in
    shared memory; or, where that does not fit, the ``wide`` path
    (:func:`wide_plan`)."""
    rows = _block_rows(gates, in_dim, hidden)
    if rows is None:
        return wide_plan(gates, batch, in_dim, hidden, wide)
    return {"path": "block", "rows": rows, "threads": rows * hidden,
            "blocks": -(-batch // rows),
            "smem": 4 * rows * (gates * (in_dim + hidden) + in_dim + hidden)}


def seq_launch(wrapper, tensors, batch: int, steps: int, in_dim: int,
               hidden: int, gates: int, keys, p_drop: float,
               act=torch.float32, weight_bits: int | None = None) -> None:
    """Launch a sequence kernel (``wrapper``: ``mcd_lstm_seq`` or
    ``mcd_gru_seq``) on the path :func:`seq_plan` picks, for activations
    of dtype ``act`` and weights of ``weight_bits`` (None: the activation
    dtype; 8: int8 codes; 4: packed int4 codes)."""
    code, nbytes = ACT_DTYPES[act]
    plan = seq_plan(gates, batch, in_dim, hidden, nbytes)
    bits = weight_bits or 8 * nbytes
    what = (f"{wrapper.__name__} (B={batch}, T={steps}, I={in_dim}, "
            f"H={hidden}, {plan['path']} path, R={plan['rows']}, {act}, "
            f"{bits}-bit weights)")
    if plan["path"] == "cluster":
        launch(wrapper, tensors,
               (batch, steps, in_dim, hidden, plan["rows"], plan["cluster"],
                plan["units"], plan["smem"], code, bits), keys, 2 * gates,
               p_drop, what, act, variant="cluster")
        return
    launch(wrapper, tensors,
           (batch, steps, in_dim, hidden, plan["rows"],
            int(plan["path"] == "warp"), plan["smem"], code, bits), keys,
           2 * gates, p_drop, what, act)


def step_launch(wrapper, tensors, batch: int, in_dim: int, hidden: int,
                gates: int, keys, p_drop: float, act=torch.float32) -> None:
    """Launch a step kernel (``wrapper``: ``mcd_lstm_step`` or
    ``mcd_gru_step``) on the path :func:`step_plan` picks, for activations
    and weights of dtype ``act``."""
    plan = step_plan(gates, batch, in_dim, hidden)
    code = ACT_DTYPES[act][0]
    what = (f"{wrapper.__name__} (B={batch}, I={in_dim}, H={hidden}, "
            f"{plan['path']} path, R={plan['rows']}, {act})")
    if plan["path"] == "split":
        launch(wrapper, tensors,
               (batch, in_dim, hidden, plan["rows"], plan["cluster"],
                plan["units"], code), keys, 2 * gates, p_drop, what, act,
               variant="split")
        return
    launch(wrapper, tensors,
           (batch, in_dim, hidden, plan["rows"], int(plan["path"] == "warp"),
            code), keys, 2 * gates, p_drop, what, act)


def check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _needs_grad(t) -> bool:
    if isinstance(t, torch.Tensor):
        return t.requires_grad
    if isinstance(t, (tuple, list)):
        return any(_needs_grad(u) for u in t)
    return False


def refuse_grad(name: str, *operands) -> None:
    """Raise when autograd would record through a kernel entry point.

    The wrappers launch into preallocated outputs, so no gradient flows
    through a kernel, and neither this package nor the reference has a
    backward kernel.  The check runs on every device -- the CPU's plain
    versions would differentiate, and a test there must see what the card
    would do.  ``operands`` may hold None and (nested) tuples."""
    if torch.is_grad_enabled() and _needs_grad(operands):
        raise RuntimeError(
            f"{name}: an operand requires grad under grad mode, and no "
            "kernel has a backward (in this package or the reference); "
            "train on backend=\"reference\", or call the kernels under "
            "torch.no_grad()")


def check_device(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (run the plain version), False for CUDA
    (launch the kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {t.device}")
    return False


def check_p(p_drop: float) -> None:
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must be in [0, 1), got {p_drop}")


def rows_arg(rows: torch.Tensor, B: int, device) -> torch.Tensor:
    """``rows`` [B] as a contiguous int32 tensor on ``device``."""
    if rows.device != device or tuple(rows.shape) != (B,):
        raise ValueError(f"rows must be [{B}] on {device}")
    return (rows if rows.dtype == torch.int32
            else rows_to_int32(rows)).contiguous()


def lengths_arg(lengths, B: int, T: int, device) -> torch.Tensor:
    """Per-row lengths [B] as a contiguous int32 tensor (``T`` for all rows
    when omitted)."""
    if lengths is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    if lengths.device != device or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}] on {device}")
    return lengths.to(torch.int32).contiguous()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def c_entry(lib: str, symbol: str, argtypes: tuple):
    """``symbol`` of the library built from ``csrc/<lib>.cu`` (first use
    builds it), declared with ``argtypes`` and an int (CUDA error) result."""
    fn = getattr(build.load(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _rnn_argtypes(n_ptr: int, n_int: int) -> tuple:
    """How every entry of the recurrent kernels is declared: ``n_ptr``
    device pointers, ``n_int`` ints, then the keys, the keep threshold, the
    scale, the masked flag and the stream."""
    P, I32 = ctypes.c_void_p, ctypes.c_int
    return (P,) * n_ptr + (I32,) * n_int + (P, ctypes.c_uint32,
                                            ctypes.c_float, I32, P)


def launch_c(wrapper, lib: str, argtypes: tuple, args, what: str,
             variant: str = "", *, device) -> None:
    """Launch ``csrc/<lib>.cu``'s ``<wrapper name>[_<variant>]_launch``
    entry (``variant`` "bf16": the LM kernels' bf16 entries; "cluster" /
    "split": the recurrent kernels' wide path) with ``args``
    (declared ``argtypes``) on ``device``, the operands' card, raise on a
    launch error, and count one launch in ``wrapper.launches``.

    A ``<<<>>>`` launch, and the entry's ``cudaFuncSetAttribute``, go to
    the host thread's current device, so the entry runs with ``device``
    made current: a launch on another card than the current one would
    otherwise run on the wrong card or fail with an invalid handle."""
    name = wrapper.__name__ + (f"_{variant}" if variant else "")
    entry = c_entry(lib, f"{name}_launch", argtypes)
    with torch.cuda.device(device):
        err = entry(*args)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1


def launch(wrapper, tensors, ints, keys, n_keys: int, p_drop: float,
           what: str, act=torch.float32, variant: str = "") -> None:
    """Launch the kernel of ``wrapper`` (``csrc/<wrapper.__name__>.cu``'s
    ``*_launch`` entry, or its ``*_<variant>_launch`` entry: the wide
    path's ``cluster`` / ``split``) on the tensors' device and its current
    stream, raise on a launch error, and count one launch in
    ``wrapper.launches``.  A ``None`` among ``tensors`` passes a null
    pointer (the scales of unquantized weights); the dropout scale is
    rounded to ``act``."""
    name = wrapper.__name__
    thr, scale, masked = mask_args(p_drop, act)
    dev = tensors[0].device
    launch_c(wrapper, name, _rnn_argtypes(len(tensors), len(ints)),
             (*[None if t is None else t.data_ptr() for t in tensors], *ints,
              keys_arg(keys, n_keys), thr, scale, masked, stream(dev)),
             what, variant, device=dev)


# The mask-export entry of each cell's gate count: the layer kernels of one
# gate count fill their factors with the same header code
# (``csrc/mcd_mask.cuh``), so one export per gate count shows the bits.
_MASK_EXPORT = {4: "mcd_lstm_seq", 3: "mcd_gru_seq"}


def kernel_mask_factors(keys, rows: torch.Tensor, in_dim: int, hidden: int,
                        p_drop: float, dtype=torch.float32):
    """The mask factors the CUDA kernels compute, exported from the card:
    ``[B,G,I]``, ``[B,G,H]`` fp32 for ``len(keys) == 2G``, the scale rounded
    to the activation ``dtype``, to hold against :func:`gate_mask_factors`.
    CUDA tensors only; not a layer launch."""
    if rows.device.type != "cuda":
        raise ValueError("kernel_mask_factors needs rows on a CUDA device")
    ks = key_list(keys)
    G = len(ks) // 2
    lib = _MASK_EXPORT[G]
    dev = rows.device
    B = rows.shape[0]
    rows32 = rows_to_int32(rows)
    fx = torch.empty((B, G, in_dim), device=dev)
    fh = torch.empty((B, G, hidden), device=dev)
    thr, sc, masked = mask_args(p_drop, dtype)
    entry = c_entry(lib, f"{lib}_masks_launch", _rnn_argtypes(3, 3))
    with torch.cuda.device(dev):
        err = entry(rows32.data_ptr(), fx.data_ptr(), fh.data_ptr(), B,
                    in_dim, hidden, keys_arg(ks, 2 * G), thr, sc, masked,
                    stream(dev))
    if err != 0:
        raise RuntimeError(f"mask export kernel launch failed: CUDA error "
                           f"{err}")
    return fx, fh
