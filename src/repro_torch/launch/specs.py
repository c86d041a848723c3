"""Planning jobs: (arch × shape × mesh) → function + arguments + spec trees
— port of ``repro.launch.specs``.

The reference builds ``jax.ShapeDtypeStruct`` arguments with
``jax.eval_shape`` and lowers them on a forced host mesh.  Here a job's
arguments are full-width tensors built under ``FakeTensorMode`` (shapes
and dtypes, no storage: ``fake=True``, the default), or real ones on a
device (``fake=False``, ``launch.dryrun --measure``), and its function
calls the port's ``backbone`` on the ``reference`` backend, the plain
path a count can see (the kernels launch through ctypes, below the
dispatcher; the reference's dry run likewise lowers its jnp mirrors, not
its Pallas kernels).  ``launch.analysis.count`` runs a job and counts it.

Fake tensors report the device they were made for (``"cpu"`` by
default), never ``meta``: every entry point keeps its ``resolve_device``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import tree_leaves, tree_unflatten
from repro_torch.core import prng
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings
from repro_torch.launch.shardings import P
from repro_torch.models import backbone, layers
from repro_torch.models.config import ArchConfig, SHAPES, shape_applicable
from repro_torch.train import optimizer, trainer

DTYPE = torch.bfloat16       # the reference builds its jobs in bf16
BACKEND = "reference"


@dataclasses.dataclass
class LoweringJob:
    name: str
    fn: Callable
    args: tuple
    in_specs: Any
    out_specs: Any
    kind: str                      # train | prefill | decode
    notes: str = ""


@dataclasses.dataclass
class Probe:
    name: str
    fn: Callable
    args: tuple
    in_specs: Any
    multiplier: int                # how many times this body runs per step


class _Build:
    """Where a job's arguments are made: under a fresh ``FakeTensorMode``
    (``fake``; the device they report, default the CPU) or for real on
    ``resolve_device(device)`` (default CUDA); random values from a seeded
    generator on that device."""

    def __init__(self, device=None, fake: bool = True, seed: int = 0):
        self.fake = fake
        if fake:
            from torch._subclasses.fake_tensor import FakeTensorMode
            self.dev = torch.device("cpu" if device is None else device)
            self.mode = FakeTensorMode(allow_non_fake_inputs=True)
            self.gen = torch.Generator()
        else:
            self.dev = resolve_device(device)
            self.mode = contextlib.nullcontext()
            self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)

    def normal(self, shape, dtype=DTYPE):
        return torch.randn(shape, generator=self.gen, device=self.gen.device,
                           dtype=torch.float32).to(self.dev, dtype)

    def tokens(self, shape, vocab: int):
        return torch.randint(0, vocab, shape, generator=self.gen,
                             device=self.gen.device,
                             dtype=torch.int32).to(self.dev)

    def ctx(self, cfg: ArchConfig, batch: int, seed: int = 0) -> layers.Ctx:
        return layers.Ctx(rows=torch.arange(batch, dtype=torch.int64,
                                            device=self.dev),
                          seed=seed, cfg=cfg.mcd)

    def params(self, cfg: ArchConfig):
        return backbone.init_params(cfg, self.gen, device=self.dev,
                                    dtype=DTYPE)

    def block(self, cfg: ArchConfig, kind: str):
        return backbone.init_block(self.gen, kind, cfg, DTYPE, self.dev)

    def embed(self, cfg: ArchConfig):
        return layers.init_embed(self.gen, cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings, DTYPE, self.dev)


def make_policy(mesh, cfg: ArchConfig) -> shardings.Policy:
    axes = mesh_lib.axis_sizes(mesh)
    dp = mesh_lib.dp_axes(mesh)
    # FSDP for archs whose TP-sharded params would not fit one chip:
    # params_bytes / tp_size > ~4 GB → shard over data too (the
    # reference's rule, kept as it is).
    big = cfg.name.startswith("jamba")
    return shardings.Policy(axes=axes, dp=dp, tp="model", fsdp=big, zero=True)


def model_input_specs(cfg: ArchConfig, batch: int, seq: int, *,
                      with_targets: bool, po: shardings.Policy, build=None):
    """(args dict of tensors, specs dict of :class:`P`): ``build`` a
    :class:`_Build` (default fake tensors on the CPU).  An audio config
    also takes ``frames`` [batch, encoder_seq, D]; a VLM ``patches``
    [batch, num_patches, D], its tokens (and targets) then ``seq -
    num_patches`` long, as the reference's."""
    build = build or _Build()
    b = shardings.batch_spec(batch, po)
    toks = seq
    extras, espec = {}, {}
    with build.mode:
        if cfg.family == "audio":
            extras["frames"] = build.normal((batch, cfg.encoder_seq,
                                             cfg.d_model))
            espec["frames"] = P(b, None, None)
        if cfg.family == "vlm":
            toks = seq - cfg.num_patches
            extras["patches"] = build.normal((batch, cfg.num_patches,
                                              cfg.d_model))
            espec["patches"] = P(b, None, None)
        args = {"tokens": build.tokens((batch, toks), cfg.vocab_size),
                **extras}
        if with_targets:
            args["targets"] = build.tokens((batch, toks), cfg.vocab_size)
    spec = {"tokens": P(b, None), **espec}
    if with_targets:
        spec["targets"] = P(b, None)
    return args, spec


def _step_seed(cfg: ArchConfig, step: int) -> int:
    """The train step's mask seed, the launcher's ``fold_ids(seed, step)``
    folded on the host before any fake mode is entered."""
    return int(prng.fold_ids(cfg.mcd.seed, step))


def train_job(cfg: ArchConfig, shape_name: str, mesh, microbatches: int = 1,
              *, batch: int | None = None, device=None,
              fake: bool = True) -> LoweringJob:
    cell = SHAPES[shape_name]
    po = make_policy(mesh, cfg)
    batch, seq = batch or cell.global_batch, cell.seq_len
    build = _Build(device, fake)
    with build.mode:
        params = build.params(cfg)
        opt = optimizer.init(params)
        step = torch.zeros((), dtype=torch.int32, device=build.dev)
    pspecs = shardings.param_specs(cfg, po)
    ospecs = shardings.optstate_specs(pspecs, po, params)
    batch_args, batch_specs = model_input_specs(
        cfg, batch, seq, with_targets=True, po=po, build=build)
    tcfg = trainer.TrainConfig(microbatches=microbatches, log_every=0)
    seed = _step_seed(cfg, 0)       # the job's step, 0: ``step`` below

    def loss(params, b, step):
        ctx = layers.Ctx(rows=torch.arange(b["tokens"].shape[0],
                                           device=b["tokens"].device),
                         seed=seed, cfg=cfg.mcd)
        return backbone.loss_fn(params, cfg, b["tokens"], b["targets"], ctx,
                                frames=b.get("frames"),
                                patches=b.get("patches"))

    raw_step = trainer.make_train_step(loss, tcfg)

    def train_step(params, opt_state, batch_in, step):
        err = [torch.zeros((), dtype=torch.float32, device=t.device)
               for t in tree_leaves(params)]
        params, opt_state, _, metrics = raw_step(
            params, opt_state, tree_unflatten(params, err), batch_in, step)
        return params, opt_state, metrics

    in_spec = (pspecs, ospecs, batch_specs, P())
    out_spec = (pspecs, ospecs, {"loss": P(), "grad_norm": P(), "lr": P()})
    return LoweringJob(name=f"{cfg.name}:{shape_name}", fn=train_step,
                       args=(params, opt, batch_args, step), in_specs=in_spec,
                       out_specs=out_spec, kind="train")


def prefill_job(cfg: ArchConfig, shape_name: str, mesh, *,
                batch: int | None = None, device=None,
                fake: bool = True) -> LoweringJob:
    cell = SHAPES[shape_name]
    po = make_policy(mesh, cfg)
    batch, seq = batch or cell.global_batch, cell.seq_len
    build = _Build(device, fake)
    with build.mode:
        params = build.params(cfg)
        ctx = build.ctx(cfg, batch)
    pspecs = shardings.param_specs(cfg, po)
    batch_args, batch_specs = model_input_specs(
        cfg, batch, seq, with_targets=False, po=po, build=build)
    state_specs = shardings.cache_specs(cfg, po, batch)
    b = shardings.batch_spec(batch, po)

    def prefill_step(params, b_in, ctx):
        return backbone.prefill(params, cfg, b_in["tokens"], ctx, seq,
                                frames=b_in.get("frames"),
                                patches=b_in.get("patches"), backend=BACKEND)

    return LoweringJob(name=f"{cfg.name}:{shape_name}", fn=prefill_step,
                       args=(params, batch_args, ctx),
                       in_specs=(pspecs, batch_specs, P(b)),
                       out_specs=(P(b, None, None), state_specs),
                       kind="prefill")


def decode_job(cfg: ArchConfig, shape_name: str, mesh,
               kv_quant: bool = False, *, batch: int | None = None,
               device=None, fake: bool = True) -> LoweringJob:
    cell = SHAPES[shape_name]
    po = make_policy(mesh, cfg)
    batch, seq = batch or cell.global_batch, cell.seq_len
    build = _Build(device, fake)
    with build.mode:
        params = build.params(cfg)
        state = backbone.init_decode_state(cfg, batch, seq, DTYPE,
                                           kv_quant=kv_quant,
                                           device=build.dev)
        token = build.tokens((batch, 1), cfg.vocab_size)
        ctx = build.ctx(cfg, batch)
    pspecs = shardings.param_specs(cfg, po)
    state_specs = shardings.cache_specs(cfg, po, batch, kv_quant=kv_quant)
    b = shardings.batch_spec(batch, po)

    def serve_step(params, token, state, ctx):
        return backbone.decode_step(params, cfg, token, state, ctx,
                                    backend=BACKEND)

    return LoweringJob(name=f"{cfg.name}:{shape_name}", fn=serve_step,
                       args=(params, token, state, ctx),
                       in_specs=(pspecs, P(b, None), state_specs, P(b)),
                       out_specs=(P(b, None, None), state_specs),
                       kind="decode", notes=f"KV/state length {seq}")


# ---------------------------------------------------------------------------
# Roofline probes — the reference compiles each unique (stage, position)
# block (+ head + optimizer) standalone, because XLA's cost analysis counts
# a while-loop body once; the roofline composes Σ body × repeat + head +
# opt.  A count here sees every op of the whole step, so the probes are a
# second reading of the same program, by part (and the per-block unit the
# card times: launch.dryrun --measure).
# ---------------------------------------------------------------------------

def _attn_blocks_for(seq: int):
    """Probe tiling: ≤64 attention bodies regardless of seq."""
    qb = max(512, seq // 8)
    kb = max(1024, seq // 8)
    return dict(q_block=qb, kv_block=kb)


def _stage_offsets(stages, first: int = 0):
    off = first
    for st in stages:
        yield off
        off += st.num_layers


def _block_train_fn(kind, cfg, bayes):
    def fn(p, x, ekv, ctx):
        # checkpointed to match the remat of the real train step (the
        # backward recomputes the block's internals)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        x_in = x.detach().requires_grad_(True)

        def f(leaves_, x_):
            pos = torch.arange(x_.shape[1], device=x_.device)
            out, aux, _ = backbone._block_forward(
                tree_unflatten(p, leaves_), kind, cfg, x_, pos, ctx, 0,
                bayes, backend=BACKEND, enc_kv=ekv)
            return torch.sum(out.float()) + aux

        loss = _ckpt.checkpoint(f, leaves, x_in, use_reentrant=False)
        wrt = [*leaves, x_in]
        # a cross block's wk / wv are unused here: the probe is given
        # its encoder K/V (zero gradients, as the reference's jax.grad)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        return tuple(torch.zeros_like(t) if g is None else g
                     for g, t in zip(grads, wrt))
    return fn


def _block_fwd_fn(kind, cfg, bayes):
    def fn(p, x, ekv, ctx):
        pos = torch.arange(x.shape[1], device=x.device)
        out, _, _ = backbone._block_forward(p, kind, cfg, x, pos, ctx, 0,
                                            bayes, backend=BACKEND,
                                            enc_kv=ekv)
        return out
    return fn


def _block_decode_fn(kind, cfg, bayes, backend=BACKEND):
    def fn(p, x, cache, cross, pos, ctx):
        return backbone._block_decode(p, kind, cfg, x, cache, pos, ctx, 0,
                                      bayes, backend=backend, cross_kv=cross)
    return fn


def _cross_inputs(cfg: ArchConfig, kind: str, build: _Build, batch: int,
                  b, po: shardings.Policy):
    """A ``.cross`` block's encoder (k, v) [batch, encoder_seq, KV, hd] and
    their specs; (None, None) for a block without cross-attention."""
    spec = shardings.block_cross_spec(cfg, po, kind, b)
    if spec is None:
        return None, None
    shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    return (build.normal(shape), build.normal(shape)), spec


def probe_jobs(cfg: ArchConfig, shape_name: str, mesh,
               kv_quant: bool = False, *, batch: int | None = None,
               device=None, fake: bool = True) -> list[Probe]:
    """The reference's probes: ``blk{si}.{j}:{kind}`` (train: grad of the
    checkpointed block; prefill: its forward), then an encoder's
    ``enc{si}.{j}:{kind}`` at ``encoder_seq`` positions, or
    ``dec{si}.{j}:{kind}`` (one token through the block's cache at
    position seq - 1), each ``× repeat``, a ``.cross`` block given
    encoder K/V; ``head:embed+xent`` (train) or ``head:embed+logits``;
    ``opt:adamw`` (train).  Each block takes the Bayesian placement it has
    in the whole step.  ``batch`` cuts the cell's batch."""
    cell = SHAPES[shape_name]
    po = make_policy(mesh, cfg)
    batch, seq = batch or cell.global_batch, cell.seq_len
    kind_step = cell.kind
    b = shardings.batch_spec(batch, po)
    build = _Build(device, fake)
    probes: list[Probe] = []
    x_seq = seq if kind_step != "decode" else 1
    x_spec = P(b, None, None)
    with build.mode:
        ctx = build.ctx(cfg, batch)

        def add_block_probes(stages, tag, block_seq, first):
            for si, (st, off) in enumerate(zip(
                    stages, _stage_offsets(stages, first))):
                bayes = backbone._stage_bayes(cfg, off, st)
                for j, kind in enumerate(st.pattern):
                    bl_specs = shardings.spec_block(kind, cfg, po)
                    params = build.block(cfg, kind)
                    x = build.normal((batch, block_seq, cfg.d_model))
                    ekv, ekv_sp = _cross_inputs(cfg, kind, build, batch, b,
                                                po)
                    if kind_step == "decode":
                        cache = backbone.init_block_cache(
                            cfg, kind, batch, seq, DTYPE, kv_quant,
                            build.dev)
                        cache_sp = shardings.block_cache_spec(
                            cfg, po, kind, b, kv_quant)
                        pos = torch.full((), seq - 1, dtype=torch.int32,
                                         device=build.dev)
                        fn = _block_decode_fn(kind, cfg, bayes[j])
                        args = (params, x, cache, ekv, pos, ctx)
                        in_specs = (bl_specs, x_spec, cache_sp, ekv_sp, P(),
                                    P(b))
                    else:
                        make = (_block_train_fn if kind_step == "train"
                                else _block_fwd_fn)
                        fn = make(kind, cfg, bayes[j])
                        args = (params, x, ekv, ctx)
                        in_specs = (bl_specs, x_spec, ekv_sp, P(b))
                    probes.append(Probe(
                        name=f"{tag}{si}.{j}:{kind}", fn=fn, args=args,
                        in_specs=in_specs, multiplier=st.repeat))

        # --- blocks ---
        add_block_probes(cfg.stages, "dec" if kind_step == "decode"
                         else "blk", x_seq, 0)
        if cfg.encoder_stages and kind_step != "decode":
            add_block_probes(cfg.encoder_stages, "enc", cfg.encoder_seq,
                             backbone.ENCODER_LAYER_OFFSET)

        # --- embedding + head ---
        embed = build.embed(cfg)
        embed_sp = shardings.param_specs(cfg, po)["embed"]
        if kind_step == "train":
            def head_fn(ep, tokens, targets):
                # embed fwd+bwd + logits/xent fwd+bwd in one probe
                leaves = [t.detach().requires_grad_(True)
                          for t in tree_leaves(ep)]
                ep_ = tree_unflatten(ep, leaves)
                x = layers.embed(ep_, tokens)
                return torch.autograd.grad(
                    backbone._chunked_xent(ep_, x, targets), leaves)
            probes.append(Probe(
                name="head:embed+xent", fn=head_fn,
                args=(embed, build.tokens((batch, x_seq), cfg.vocab_size),
                      build.tokens((batch, x_seq), cfg.vocab_size)),
                in_specs=(embed_sp, P(b, None), P(b, None)), multiplier=1))
        else:
            out_positions = x_seq if kind_step == "prefill" else 1

            def head_fn(ep, tokens):
                return layers.logits(ep, layers.embed(ep, tokens))
            probes.append(Probe(
                name="head:embed+logits", fn=head_fn,
                args=(embed, build.tokens((batch, out_positions),
                                          cfg.vocab_size)),
                in_specs=(embed_sp, P(b, None)), multiplier=1))

        # --- optimizer update (train only) ---
        if kind_step == "train":
            params = build.params(cfg)
            opt = optimizer.init(params)
            pspecs = shardings.param_specs(cfg, po)
            ospecs = shardings.optstate_specs(pspecs, po, params)
            grads = [torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device)
                     for t in tree_leaves(params)]
            grads = tree_unflatten(params, grads)
            adamw = trainer.TrainConfig().adamw

            def opt_fn(params, grads, state):
                with torch.no_grad():
                    return optimizer.apply(adamw, params, grads, state)
            probes.append(Probe(
                name="opt:adamw", fn=opt_fn, args=(params, grads, opt),
                in_specs=(pspecs, pspecs, ospecs), multiplier=1))
    return probes


def make_job(cfg: ArchConfig, shape_name: str, mesh, *,
             microbatches: int = 1, kv_quant: bool = False,
             batch: int | None = None, device=None,
             fake: bool = True) -> LoweringJob | None:
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return None
    kw = dict(batch=batch, device=device, fake=fake)
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return train_job(cfg, shape_name, mesh, microbatches, **kw)
    if kind == "prefill":
        return prefill_job(cfg, shape_name, mesh, **kw)
    return decode_job(cfg, shape_name, mesh, kv_quant, **kw)
