"""Sharding rules: spec trees mirroring the port's model structures — port
of ``repro.launch.shardings``.

A spec (:class:`P`) names, for each dim of a tensor, the mesh axis it is
split over: an axis name, a tuple of names, or None (replicated).  The
specs are built *structurally* (one mirror function a parameter group),
every leaf's spec written next to the shape it shards, with divisibility
guards, as the reference's.

The trees mirror the port's own structures, which keep an LM's repeats
unstacked (``params["stages"][i][r][j]``, ``state.caches[i][r][j]``):
where the reference prefixes ``None`` for a stacked repeat dim
(``_prepend``), each repeat here holds its block's spec as it is.
``backbone.stack_repeats(tree, stack=stack_specs)`` gives the reference's
stacked layout.

The port has no partitioner: the specs say how a program *would* be laid
out over a mesh, and :func:`shard_bytes` prices that layout (the
counterpart of ``memory_analysis()``'s argument bytes).

Policy knobs (the hardware half of the paper's DSE space — the GPU
analogue of reuse factors R_x/R_h/R_d):
  * tp           — tensor-parallel axis name ("model")
  * fsdp         — shard params+grads over the data axes too (weight
                   all-gather per layer; required for ≥100B-param train)
  * zero         — shard optimizer moments over the data axes (ZeRO-1)
"""

from __future__ import annotations

import dataclasses

from repro_torch.ckpt.checkpoint import tree_leaves, tree_map
from repro_torch.models import backbone, layers, mamba2, mla, moe
from repro_torch.models.config import ArchConfig, Stage
from repro_torch.train.optimizer import AdamWState

_NOT_PORTED = "cross-attention and encoders are queued (ROADMAP.md, A9)"


class P:
    """A partition spec: one entry a dim — a mesh axis name, a tuple of
    names, or None.  Iterates, indexes and compares as the tuple of its
    entries (``tuple(P(...)) == tuple(PartitionSpec(...))``: a one-name
    tuple is kept as the name, as ``PartitionSpec`` keeps it); not a tuple
    itself, so the port's tree functions take it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1
                           else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


def stack_specs(specs) -> P:
    """``backbone.stack_repeats``'s ``stack`` for spec trees: the repeats'
    specs (all one spec) under a leading, replicated repeat dim."""
    first = specs[0]
    if any(s != first for s in specs):
        raise ValueError(f"repeats of one block disagree: {specs}")
    return P(None, *first)


@dataclasses.dataclass(frozen=True)
class Policy:
    axes: dict                      # mesh axis name → size
    dp: tuple[str, ...]             # data-parallel axes (("pod","data") or ("data",))
    tp: str = "model"
    fsdp: bool = False
    zero: bool = True

    def dp_size(self) -> int:
        out = 1
        for a in self.dp:
            out *= self.axes[a]
        return out

    def tp_size(self) -> int:
        return self.axes.get(self.tp, 1)

    def tp_if(self, dim: int):
        """tp axis if the dim is divisible, else replicate."""
        return self.tp if dim % max(self.tp_size(), 1) == 0 else None

    def dp_if(self, dim: int):
        return self.dp if dim % max(self.dp_size(), 1) == 0 else None

    def fsdp_if(self, dim: int):
        return self.dp if (self.fsdp and dim % max(self.dp_size(), 1) == 0) else None


# ---------------------------------------------------------------------------
# Parameter specs (mirror init_* structures)
# ---------------------------------------------------------------------------

def spec_attn(cfg: ArchConfig, po: Policy) -> layers.AttnParams:
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    return layers.AttnParams(
        wq=P(po.fsdp_if(D), po.tp_if(H), None),
        wk=P(po.fsdp_if(D), po.tp_if(KV), None),
        wv=P(po.fsdp_if(D), po.tp_if(KV), None),
        wo=P(po.tp_if(H), None, po.fsdp_if(D)),
        q_scale=P() if cfg.qk_norm else None,
        k_scale=P() if cfg.qk_norm else None,
        norm=P())


def spec_mlp(cfg: ArchConfig, po: Policy, d_ff: int) -> layers.MLPParams:
    D = cfg.d_model
    return layers.MLPParams(
        wi=P(po.fsdp_if(D), None, po.tp_if(d_ff)),
        wo=P(po.tp_if(d_ff), po.fsdp_if(D)),
        norm=P())


def spec_moe(cfg: ArchConfig, po: Policy) -> moe.MoEParams:
    D, E = cfg.d_model, cfg.moe.num_experts
    dffe = cfg.moe.d_ff_expert
    shared = None
    if cfg.moe.num_shared:
        shared = spec_mlp(cfg, po, cfg.moe.num_shared * dffe)
    return moe.MoEParams(
        router=P(None, None),
        wi=P(po.tp_if(E), po.fsdp_if(D), None, None),
        wo=P(po.tp_if(E), None, po.fsdp_if(D)),
        shared=shared,
        norm=P())


def spec_mla(cfg: ArchConfig, po: Policy) -> mla.MLAParams:
    H, D = cfg.num_heads, cfg.d_model
    return mla.MLAParams(
        norm=P(),
        wq=P(po.fsdp_if(D), po.tp_if(H), None),
        w_dkv=P(po.fsdp_if(D), None),
        kv_norm=P(),
        w_krope=P(None, None),
        w_uk=P(None, po.tp_if(H), None),
        w_uv=P(None, po.tp_if(H), None),
        wo=P(po.tp_if(H), None, po.fsdp_if(D)))


def spec_mamba(cfg: ArchConfig, po: Policy) -> mamba2.MambaParams:
    D = cfg.d_model
    d_inner, n_heads, conv_dim = mamba2.dims(D, cfg.ssm)
    return mamba2.MambaParams(
        norm=P(),
        in_proj=P(po.fsdp_if(D), None),
        conv_w=P(po.tp_if(conv_dim), None),
        conv_b=P(po.tp_if(conv_dim)),
        a_log=P(), d_skip=P(), dt_bias=P(),
        out_norm=P(po.tp_if(d_inner)),
        out_proj=P(po.tp_if(d_inner), po.fsdp_if(D)))


def spec_block(kind: str, cfg: ArchConfig, po: Policy) -> dict:
    """One block's specs, ``backbone.init_block``'s structure."""
    mixer, has_cross, ffn = backbone._parse(kind)
    if has_cross or mixer in ("enc_attn", "dec_attn"):
        raise NotImplementedError(f"block {kind!r}: {_NOT_PORTED}")
    out = {}
    if mixer == "attn":
        out["mixer"] = spec_attn(cfg, po)
    elif mixer == "mla":
        out["mixer"] = spec_mla(cfg, po)
    elif mixer == "mamba":
        out["mixer"] = spec_mamba(cfg, po)
    if ffn == "mlp":
        out["ffn"] = spec_mlp(cfg, po, cfg.d_ff)
    elif ffn == "moe":
        out["ffn"] = spec_moe(cfg, po)
    return out


def spec_stage(stage: Stage, cfg: ArchConfig, po: Policy) -> list:
    """A stage's specs, unstacked: one tuple of block specs a repeat."""
    return [tuple(spec_block(kind, cfg, po) for kind in stage.pattern)
            for _ in range(stage.repeat)]


def param_specs(cfg: ArchConfig, po: Policy) -> dict:
    if cfg.encoder_stages:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED}")
    V, D = cfg.vocab_size, cfg.d_model
    return {
        "embed": layers.EmbedParams(
            table=P(po.tp_if(V), po.fsdp_if(D)),
            head=None if cfg.tie_embeddings else P(po.fsdp_if(D), po.tp_if(V)),
            final_norm=P()),
        "stages": [spec_stage(s, cfg, po) for s in cfg.stages],
    }


class Stacked:
    """A stand-in for a stacked leaf ``[repeat, *shape]``: its shape, size
    and element size, no storage (``shard_bytes`` and ``optstate_specs``
    read nothing else)."""

    def __init__(self, leaves):
        first = leaves[0]
        self.shape = (len(leaves), *first.shape)
        self.dtype = first.dtype
        self._item = first.element_size()

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def element_size(self) -> int:
        return self._item

    def dim(self) -> int:
        return len(self.shape)


def stacked(tree):
    """A tree of the port's (an LM's parameters, or AdamW's moments) in the
    reference's stacked layout, each leaf a :class:`Stacked` stand-in."""
    return backbone.stack_repeats(tree, stack=Stacked) \
        if isinstance(tree, dict) and "stages" in tree else tree


def optstate_specs(pspecs, po: Policy, param_shapes) -> AdamWState:
    """ZeRO-1: moments inherit the param spec with the data axes folded into
    the first still-replicated, divisible dim.  ``param_shapes``: the
    parameter tree (tensors, fake ones too: only shapes are read).

    The moments' specs are given in the stacked layout the optimizer state
    is checkpointed in (``backbone.stack_repeats``: an LM's ``m`` and ``v``
    leaves ``[repeat, ...]``), because the fold may split the repeat dim
    over the data axes, and an unstacked tree has no such dim; price them
    with ``shard_bytes(stacked(moments), ...)``."""
    def fold(spec, shape):
        if not po.zero or po.fsdp:          # fsdp already uses the dp axes
            return spec
        parts = list(spec)
        while len(parts) < len(shape.shape):
            parts.append(None)
        for i, (axis, dim) in enumerate(zip(parts, shape.shape)):
            if axis is None and dim % max(po.dp_size(), 1) == 0 and dim > 1:
                parts[i] = po.dp
                return P(*parts)
        return spec

    stacked_specs = (backbone.stack_repeats(pspecs, stack=stack_specs)
                     if isinstance(pspecs, dict) and "stages" in pspecs
                     else pspecs)
    m = tree_map(fold, stacked_specs, stacked(param_shapes))
    return AdamWState(step=P(), m=m, v=m)


# ---------------------------------------------------------------------------
# Input / decode-state specs
# ---------------------------------------------------------------------------

def batch_spec(batch: int, po: Policy):
    """Shard the batch dim over dp axes when divisible (long_500k: batch 1)."""
    return po.dp if batch % max(po.dp_size(), 1) == 0 else None


def block_cache_spec(cfg: ArchConfig, po: Policy, kind: str, b,
                     kv_quant: bool = False):
    """One block's decode-cache specs (``backbone.init_block_cache``'s
    structure); ``b`` the batch dim's spec."""
    mixer = backbone._parse(kind)[0]
    if mixer == "attn":
        # [B, Smax, KV, hd]: prefer head sharding; else shard the
        # sequence (flash-decoding style — partial softmax + all-reduce).
        if cfg.num_kv_heads % max(po.tp_size(), 1) == 0:
            kv = P(b, None, po.tp, None)
            sc = P(b, None, po.tp)
        elif b is None:
            kv = P(None, po.dp + (po.tp,), None, None)
            sc = P(None, po.dp + (po.tp,), None)
        else:
            kv = P(b, po.tp, None, None)
            sc = P(b, po.tp, None)
        return (kv, sc, kv, sc) if kv_quant else (kv, kv)
    if mixer == "mla":
        return mla.MLACache(c_kv=P(b, None, None), k_rope=P(b, None, None))
    if mixer == "mamba":
        d_inner, n_heads, conv_dim = mamba2.dims(cfg.d_model, cfg.ssm)
        return mamba2.MambaState(
            ssm=P(b, po.tp_if(n_heads), None, None),
            conv=P(b, None, po.tp_if(conv_dim)))
    raise NotImplementedError(f"block {kind!r}: {_NOT_PORTED}")


def cache_specs(cfg: ArchConfig, po: Policy, batch: int,
                kv_quant: bool = False) -> backbone.DecodeState:
    """Specs mirroring ``backbone.init_decode_state``'s structure (one
    block's caches a repeat; no cross-attention caches: not ported)."""
    b = batch_spec(batch, po)
    for st in cfg.stages:
        for kind in st.pattern:
            if backbone._parse(kind)[1]:
                raise NotImplementedError(f"block {kind!r}: {_NOT_PORTED}")
    return backbone.DecodeState(pos=P(), caches=[
        [[block_cache_spec(cfg, po, kind, b, kv_quant) for kind in st.pattern]
         for _ in range(st.repeat)] for st in cfg.stages])


def shard_factor(spec: P, axes: dict) -> int:
    """How many ways a tensor under ``spec`` is split: the product of the
    sizes of the axes its dims name."""
    n = 1
    for part in spec:
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None:
                n *= axes[a]
    return n


def shard_bytes(tree, specs, axes: dict) -> float:
    """Per-device bytes of ``tree`` (tensors, fake ones too) laid out by
    ``specs`` (the same structure, :class:`P` leaves) over a mesh of
    ``axes`` (name → size): each tensor's bytes over its split.  A
    replicated tensor counts whole on every device."""
    total = 0.0
    for t, s in zip(tree_leaves(tree), tree_leaves(specs), strict=True):
        if len(s) > t.dim():
            raise ValueError(f"spec {s} names {len(s)} dims of a "
                             f"{t.dim()}-dim tensor")
        total += t.numel() * t.element_size() / shard_factor(s, axes)
    return total
