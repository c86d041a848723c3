"""Recurrent classifier (paper §III-C, Fig. 6b): encoder + dense head —
port of ``repro.core.classifier``."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import linear, mcd, rnn
from repro_torch.kernels import quantize


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    input_dim: int = 1
    hidden: int = 8           # H
    num_layers: int = 3       # NL
    num_classes: int = 4
    cell: str = "lstm"        # recurrent unit (rnn.CELLS)
    mcd: mcd.MCDConfig = dataclasses.field(
        default_factory=lambda: mcd.MCDConfig(placement="YNY"))


def init(generator: torch.Generator, cfg: ClassifierConfig,
         dtype=torch.float32, device=None) -> dict[str, Any]:
    """Random parameters drawn from ``generator`` (on the CPU, so a seed
    gives the same weights whatever the device), placed on ``device``."""
    dev = resolve_device(device)
    hiddens = (cfg.hidden,) * cfg.num_layers
    return {
        "encoder": rnn.init_stack(generator, cfg.input_dim, hiddens, dtype,
                                  cell=cfg.cell, device=dev),
        "head": linear.init_dense(generator, cfg.hidden, cfg.num_classes,
                                  dtype, device=dev),
    }


def apply(params: dict[str, Any], x_seq, rows, cfg: ClassifierConfig, *,
          backend: str = "reference", initial_state=None, lengths=None,
          return_state: bool = False, precision: str | None = None,
          device=None, mesh=None, policy=None):
    """Logits [B, num_classes] for one set of MCD masks.

    ``backend`` selects the encoder path (``"reference"`` | ``"cuda_step"``
    | ``"cuda_seq"``); all draw the same masks.  ``cfg.cell`` picks the
    recurrent unit (``"lstm"`` | ``"gru"``).  ``initial_state`` / ``lengths`` /
    ``return_state`` stream a signal chunk by chunk, as in the reference.
    ``precision`` (fp32/bf16/int8/int4, None = native dtypes) casts the
    input to the activation dtype and the encoder's weights as
    ``run_stack`` does; the head runs at the activation dtype too (fp32
    sums rounded to it), so bf16 precisions give bf16 logits, as in the
    reference.  Runs on ``device`` (default CUDA).  ``mesh`` / ``policy``
    shard the encoder over a device mesh (``launch.rnn_shardings``; the
    head runs on ``mesh.home``), bit-equal to the unsharded pass.
    """
    dev = rnn.stack_device(device, mesh)
    x_seq = torch.as_tensor(x_seq, device=dev)
    if precision is not None:
        # Cast up front, so the reference masks sample in the dtype the
        # kernels materialize the 1/(1-p) scale in.
        x_seq = x_seq.to(quantize.activation_dtype(precision, x_seq.dtype))
    rows = torch.as_tensor(rows, device=dev)
    hiddens = (cfg.hidden,) * cfg.num_layers
    masks = (rnn.sample_stack_masks(cfg.mcd, rows, cfg.input_dim, hiddens,
                                    dtype=x_seq.dtype, cell=cfg.cell)
             if backend == "reference"
             else rnn.stack_mask_plan(cfg.mcd, cfg.num_layers))
    _, states = rnn.run_stack(params["encoder"], x_seq, masks, cfg.mcd.p,
                              return_sequence=False, backend=backend,
                              rows=rows, seed=cfg.mcd.seed,
                              initial_state=initial_state, lengths=lengths,
                              return_all_states=True, cell=cfg.cell,
                              precision=precision, device=dev, mesh=mesh,
                              policy=policy)
    logits = linear.dense(params["head"], states[-1][0])
    return (logits, states) if return_state else logits
