"""Roofline analysis of counted programs (no card required) — port of
``repro.launch.analysis``.

Terms (per device, seconds) at one H100 SXM 80 GB's peaks:

  compute    = flops / PEAK_FLOPS          (bf16 tensor cores, dense)
  memory     = bytes / HBM_BW              (HBM3)
  collective = collective_bytes / ICI_BW   (one NVLink link)

The reference reads XLA's ``cost_analysis()`` of a compiled, partitioned
program.  The port has no compiler and no partitioner, so :func:`count`
runs the program itself (on fake tensors, which hold no storage, or on
real ones) under a ``TorchDispatchMode`` and counts what each aten op
does.  The reference's ``collective_bytes`` parses collectives out of HLO
text; the port has no HLO, so collective bytes come from the analytic
model (``dse.gpu_model.step_model``) only.

The peaks are module attributes, so a caller (or a test) may set others.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.ckpt.checkpoint import tree_leaves

#: Dense bf16 tensor-core peak of one H100 SXM (NVIDIA H100 data sheet,
#: 989.4 TFLOP/s without sparsity, 700 W).
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM 80 GB (NVIDIA H100 data sheet), bytes/s.
HBM_BW = 3.35e12
#: One NVLink 4 link, one direction: 900 GB/s over 18 links both ways
#: (NVIDIA H100 data sheet), the counterpart of the TPU's per-link ICI.
ICI_BW = 25e9


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_hbm: float             # per device
    bytes_collective: float      # per device (factor-weighted)
    coll_by_kind: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    memory_per_device: dict      # empty: see roofline()

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def roofline_fraction(self) -> float:
        """compute term / binding term — 1.0 means compute-bound at peak."""
        return self.t_compute / max(self.t_bound, 1e-30)


def roofline(flops: float, bytes_hbm: float,
             bytes_collective: float = 0.0) -> Roofline:
    """The three terms at this module's peaks (read at call time).  No
    collective is broken down by kind (there is no HLO to parse) and no
    memory analysis is attached: ``dryrun`` records residency itself."""
    t_c = flops / PEAK_FLOPS
    t_m = bytes_hbm / HBM_BW
    t_x = bytes_collective / ICI_BW
    bott = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return Roofline(flops=flops, bytes_hbm=bytes_hbm,
                    bytes_collective=bytes_collective, coll_by_kind={},
                    t_compute=t_c, t_memory=t_m, t_collective=t_x,
                    bottleneck=bott, memory_per_device={})


@dataclasses.dataclass
class Counts:
    """What one run of a program did, summed over its aten ops.

    ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products and
    convolutions; elementwise work counts nothing, as in FlopCounterMode).
    ``bytes``: each op's tensor operands read once and its tensor results
    written once, over the ops that move data (no view, no aliasing
    reshape, no metadata query: :func:`_moves_data`); an in-place write at
    indices counts its operands read and written, not the whole tensor it
    writes into.  This is an *unfused* count: every intermediate
    goes to memory and back, where XLA's ``bytes accessed`` is taken after
    fusion, so it bounds the traffic of a fused program from above.
    Forward and backward ops are both seen (autograd's backward dispatches
    through the same mode).  ``out`` is the program's return value.
    """
    flops: int = 0
    bytes: int = 0
    ops: int = 0                  # the ops counted: those that move data
    out: Any = dataclasses.field(default=None, repr=False, compare=False)

    def roofline(self, bytes_collective: float = 0.0) -> Roofline:
        return roofline(float(self.flops), float(self.bytes),
                        bytes_collective)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def io_bytes(args, out) -> int:
    """The bytes no program computing ``out`` from ``args`` can avoid
    moving: each distinct tensor of ``args`` read once, each tensor of
    ``out`` that is not one of them written once (a cache updated in place
    counts once, as read; the position it writes is left out).  An input
    counts whole where the program reads part of it (every expert of a
    MoE layer, routed or not; an embedding table it gathers rows of), so
    there it overstates the least traffic."""
    seen = {}
    for t in (*tree_leaves(args), *tree_leaves(out)):
        if isinstance(t, torch.Tensor):
            seen.setdefault(id(t), t)
    return _tensor_bytes(list(seen.values()))


#: Ops that move no data though their schema is no view's: reshapes whose
#: result aliases the input.
_ALIASING = ("_unsafe_view", "_reshape_alias", "lift_fresh")
#: In-place writes at indices: they read their operands and write as many
#: bytes into ``self`` (a decode step's one position of a KV cache), not
#: the whole of ``self``.
_INDEXED_WRITES = ("index_copy_", "index_put_", "scatter_", "scatter_add_",
                   "index_add_")


def _moves_data(func) -> bool:
    """An op that reads or writes memory: not a metadata query (the
    ``prim`` namespace: fake tensors answer ``.device`` through one), not
    a view, not an aliasing reshape.  Whether ``matmul`` reshapes by a
    view or by ``expand`` + ``bmm`` follows the strides of size-1 dims,
    which fake and real tensors may lay out apart; only such bookkeeping
    is left out, so the counts of the two agree."""
    return not (func.namespace == "prim" or func.is_view
                or func.overloadpacket.__name__ in _ALIASING)


class _CountMode(TorchDispatchMode):
    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _moves_data(func):
            return out
        c = self.counts
        c.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
        if packet.__name__ in _INDEXED_WRITES:
            c.bytes += 2 * _tensor_bytes((list(args[1:]), dict(kwargs)))
        else:
            c.bytes += (_tensor_bytes((list(args), dict(kwargs)))
                        + _tensor_bytes(out))
        return out


def _fake_mode_of(tree):
    from torch._subclasses.fake_tensor import FakeTensor
    for leaf in tree_leaves(tree):
        if isinstance(leaf, FakeTensor):
            return leaf.fake_mode
        rows = getattr(leaf, "rows", None)        # a layers.Ctx
        if isinstance(rows, FakeTensor):
            return rows.fake_mode
    return None


def count(fn, *args, **kwargs) -> Counts:
    """Run ``fn(*args, **kwargs)`` once and count its flops and bytes.

    Arguments that are fake tensors (``FakeTensorMode``: shapes and dtypes,
    no storage) run in their own fake mode, entered here if it is not
    already; real tensors run as they are, on their device.  The port's
    CUDA kernels are launched through ctypes, below the dispatcher, so a
    count sees only the plain path: count the ``reference`` backend."""
    counts = Counts()
    mode = _fake_mode_of((list(args), dict(kwargs)))
    outer = (mode if mode is not None
             and mode not in _get_current_dispatch_mode_stack()
             else contextlib.nullcontext())
    with outer, _CountMode(counts):
        counts.out = fn(*args, **kwargs)
    return counts


def model_flops(cfg, cell, chips: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), per device.

    N counts *active* parameters (MoE: top-k experts + shared); D = tokens
    processed by the step (train: batch·seq fwd+bwd = 6ND; prefill: 2ND;
    decode: 2N per token · batch).
    """
    n_active = active_params(cfg)
    if cell.kind == "train":
        d = cell.global_batch * cell.seq_len
        total = 6.0 * n_active * d
    elif cell.kind == "prefill":
        d = cell.global_batch * cell.seq_len
        total = 2.0 * n_active * d
    else:  # decode: one token per sequence
        total = 2.0 * n_active * cell.global_batch
    return total / chips


def active_params(cfg) -> float:
    """Active parameter count from the architecture config (no allocation)."""
    from repro_torch.models import backbone as bb
    from repro_torch.models import mamba2 as m2
    D = cfg.d_model
    hd = cfg.head_dim
    n = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)

    def block_params(kind: str) -> float:
        mixer, cross, ffn = bb._parse(kind)
        p = 0.0
        if mixer in ("attn", "enc_attn", "dec_attn"):
            p += D * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        elif mixer == "mla":
            c = cfg.mla
            p += D * cfg.num_heads * (c.nope_head_dim + c.rope_head_dim)
            p += D * (c.kv_lora_rank + c.rope_head_dim)
            p += c.kv_lora_rank * cfg.num_heads * (c.nope_head_dim
                                                   + c.v_head_dim)
            p += cfg.num_heads * c.v_head_dim * D
        elif mixer == "mamba":
            d_inner, n_heads, conv_dim = m2.dims(D, cfg.ssm)
            d_in_proj = (2 * d_inner + 2 * cfg.ssm.n_groups
                         * cfg.ssm.d_state + n_heads)
            p += D * d_in_proj + d_inner * D + conv_dim * cfg.ssm.d_conv
        if cross:
            p += D * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        if ffn == "mlp":
            p += 3 * D * cfg.d_ff
        elif ffn == "moe":
            mo = cfg.moe
            p += 3 * D * mo.d_ff_expert * (mo.top_k + mo.num_shared)
            p += D * mo.num_experts        # router
        return p

    for stage in tuple(cfg.stages) + tuple(cfg.encoder_stages):
        for kind in stage.pattern:
            n += stage.repeat * block_params(kind)
    return n
