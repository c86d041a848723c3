"""AdamW + global-norm clipping (paper §V: clip 3.0, weight decay 1e-4) —
port of ``repro.train.optimizer``.

Trees are dicts, lists, tuples and named tuples of tensors, walked in
``jax.tree_util`` order (``ckpt.checkpoint.tree_leaves``): the global norm
stacks the per-leaf sums in the reference's leaf order.  Moments stay fp32
whatever the parameters' dtype.  The bias corrections and the warmup
learning rate are fp32 tensors, as the reference computes them on the
device; a Python double there would move the update off the reference's
by more than an ulp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.ckpt.checkpoint import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4     # paper §V
    clip_norm: float = 3.0         # paper §V
    warmup_steps: int = 0


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any
    v: Any


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(_zeros32, params),
                      v=tree_map(_zeros32, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def apply(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    step32 = step.float()
    lr = cfg.lr
    if cfg.warmup_steps:
        lr = lr * torch.clamp(step32 / cfg.warmup_steps, max=1.0)
    b1c = 1.0 - cfg.b1 ** step32
    b2c = 1.0 - cfg.b2 ** step32

    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    new = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v), strict=True)]
    new_p, new_m, new_v = (tree_unflatten(params, [t[i] for t in new])
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm,
                                                   "lr": lr}
