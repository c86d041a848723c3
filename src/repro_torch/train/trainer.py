"""Training loop: microbatched gradient accumulation, compressed gradients,
checkpoint / auto-resume, straggler watchdog — port of
``repro.train.trainer``.

* **Microbatch accumulation** — the batch's leading axis is split into
  ``microbatches`` chunks; their fp32 gradients are summed in order and
  divided by the count, as the reference's ``lax.scan`` does.  The sums
  and the division run in place on the step's own buffers (the same
  arithmetic): at qwen3-1.7b's full width a copy of the gradients is 8 GB.
* **Gradient compression** — optional error-feedback bf16 / int8 cast of
  each gradient leaf before the optimizer; the fp32 residual is carried to
  the next step.
* **Fault tolerance** — atomic checkpoints of ``(params, AdamWState)``
  every ``ckpt_every`` steps in the reference's format and leaf names
  (``ckpt.checkpoint``), so a checkpoint of either package resumes in the
  other (an LM's through ``layout``: the reference stacks a stage's
  repeats, the port keeps one block a repeat); auto-resume from the
  latest valid step; a per-step wall-clock watchdog that records
  stragglers (> ``straggler_factor`` x the running median).

Gradients come from ``torch.autograd``.  The step runs eagerly: the
reference jits it, and the port's trained parts (two dense heads) gain
nothing from a compiler.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import tree_leaves, tree_map, tree_unflatten
from repro_torch.train import optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: optimizer.AdamWConfig = dataclasses.field(
        default_factory=optimizer.AdamWConfig)
    microbatches: int = 1
    grad_compression: str = "none"       # none | bf16 | int8
    ckpt_every: int = 100
    ckpt_dir: str | None = None
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


def _compress(g: torch.Tensor, err: torch.Tensor, mode: str):
    """Error-feedback compression of one gradient leaf (fp32 residual)."""
    if mode == "none":
        return g, err
    g32 = g.float() + err
    if mode == "bf16":
        deq = g32.to(torch.bfloat16).float()
    elif mode == "int8":
        scale = torch.clamp(torch.amax(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
    else:
        raise ValueError(mode)
    return deq.to(g.dtype), g32 - deq


def make_train_step(loss_fn: Callable, cfg: TrainConfig):
    """Build the step.

    ``loss_fn(params, batch, step) -> (loss, metrics dict)``.  The step
    maps ``(params, AdamWState, err tree, batch, step)`` to ``(params,
    AdamWState, err tree, metrics)``; the batch's leading axis is split
    into ``cfg.microbatches`` chunks.
    """

    def step_fn(params, opt_state, err, batch, step):
        nm = cfg.microbatches
        leaves = tree_leaves(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(nm):
            mb = batch if nm == 1 else tree_map(
                lambda x, i=i: x.reshape(nm, x.shape[0] // nm,
                                         *x.shape[1:])[i], batch)
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = loss_fn(tree_unflatten(params, live), mb, step)
            for a, g in zip(gsum, torch.autograd.grad(loss, live)):
                a.add_(g.float())     # the step's own sums: in place
            lsum = lsum + loss.detach()
        grads = tree_unflatten(params, [g.div_(nm) for g in gsum])
        loss = lsum / nm

        if cfg.grad_compression != "none":
            pairs = [_compress(g, e, cfg.grad_compression)
                     for g, e in zip(tree_leaves(grads), tree_leaves(err),
                                     strict=True)]
            grads = tree_unflatten(params, [p[0] for p in pairs])
            err = tree_unflatten(params, [p[1] for p in pairs])

        with torch.no_grad():
            params, opt_state, metrics = optimizer.apply(
                cfg.adamw, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, err, metrics

    return step_fn


# A checkpoint layout that writes the tree as it is.
_AS_IS = (lambda tree, stack=None: tree,
          lambda tree, place: tree_map(place, tree))


class Trainer:
    """Runs steps, checkpoints, resumes and watches for stragglers.

    ``layout``: ``(to_ckpt, from_ckpt)``, how a parameter tree (the params
    and AdamW's ``m`` and ``v``) is laid out in a checkpoint and back:
    ``to_ckpt(tree[, stack])``, ``from_ckpt(tree, place)``
    (``backbone.stack_repeats`` / ``unstack_repeats`` for an LM); None
    writes the tree as it is."""

    def __init__(self, loss_fn, params, cfg: TrainConfig, layout=None):
        self.cfg = cfg
        self.layout = layout or _AS_IS
        self.params = params
        self.opt_state = optimizer.init(params)
        self.err = (tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device),
                        params)
                    if cfg.grad_compression != "none" else
                    tree_map(lambda p: torch.zeros(
                        (), dtype=torch.float32, device=p.device), params))
        self.step = 0
        self.step_fn = make_train_step(loss_fn, cfg)
        self.step_times: list[float] = []
        self.straggler_events: list[int] = []
        if cfg.ckpt_dir:
            self._resume(tree_leaves(params)[0].device)

    def run(self, batches, num_steps: int, log=print):
        it = iter(batches)
        history = []
        while self.step < num_steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            t0 = time.monotonic()
            self.params, self.opt_state, self.err, metrics = self.step_fn(
                self.params, self.opt_state, self.err, batch, self.step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self._watchdog(dt)
            self.step += 1
            history.append(metrics)
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                log(f"step {self.step}: loss={metrics['loss']:.4f} "
                    f"gnorm={metrics['grad_norm']:.3f} ({dt*1e3:.0f} ms)")
            if (self.cfg.ckpt_dir and self.cfg.ckpt_every
                    and self.step % self.cfg.ckpt_every == 0):
                self._save()
        if self.cfg.ckpt_dir:
            self._save()
        return history

    @staticmethod
    def _each_tree(fn, params, opt_state):
        return fn(params), opt_state._replace(m=fn(opt_state.m),
                                              v=fn(opt_state.v))

    def _resume(self, device):
        to_ckpt, from_ckpt = self.layout
        like = self._each_tree(lambda t: to_ckpt(t, lambda xs: xs[0]),
                               self.params, self.opt_state)
        resumed = checkpoint.resume_or_none(self.cfg.ckpt_dir, like)
        if resumed is None:
            return

        def place(a):
            return checkpoint.place(a, device)

        self.step, (params, opt_state) = resumed
        self.params, opt_state = self._each_tree(
            lambda t: from_ckpt(t, place), params, opt_state)
        self.opt_state = opt_state._replace(step=place(opt_state.step))

    def _save(self):
        checkpoint.save(self.cfg.ckpt_dir, self.step, self._each_tree(
            self.layout[0], self.params, self.opt_state))
        checkpoint.keep_last(self.cfg.ckpt_dir, self.cfg.keep_ckpts)

    def _watchdog(self, dt: float):
        """Record steps slower than straggler_factor x the running median
        (of the last 50, once 10 are in)."""
        self.step_times.append(dt)
        window = self.step_times[-50:]
        if len(window) >= 10:
            med = sorted(window)[len(window) // 2]
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(self.step)
