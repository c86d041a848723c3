"""Recurrent autoencoder for anomaly detection (paper §III-C, Fig. 6a) —
port of ``repro.core.autoencoder``.

Encoder: NL cascaded recurrent layers, the last of hidden size H/2 (the
bottleneck).  The bottleneck h_T is repeated over the decode positions and
decoded by NL layers of hidden size H, then a dense head at every step.
The head is heteroscedastic (mean + log-variance per feature): aleatoric
uncertainty per pass, epistemic from the S MC passes.  MCD placement
indexes the 2·NL layers encoder first (``"YNYN"``): the decoder's layers
are numbered after the encoder's, so the mask stream equals the
reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import linear, mcd, rnn
from repro_torch.kernels import quantize


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    input_dim: int = 1
    hidden: int = 16          # H
    num_layers: int = 2       # NL (per encoder / per decoder)
    cell: str = "lstm"        # recurrent unit (rnn.CELLS)
    mcd: mcd.MCDConfig = dataclasses.field(
        default_factory=lambda: mcd.MCDConfig(placement="YNYN"))
    heteroscedastic: bool = True
    # Windowed decoder: replay the bottleneck over only min(T,
    # decode_window) positions.  The replay at position t depends only on
    # the bottleneck and the time-invariant masks, so the window is
    # bit-identical to the first positions of the full replay.  None: the
    # paper's repeat-T decoder.
    decode_window: int | None = None

    def __post_init__(self):
        if self.decode_window is not None and self.decode_window < 1:
            raise ValueError(f"decode_window must be >= 1 or None, "
                             f"got {self.decode_window}")

    @property
    def encoder_hiddens(self) -> tuple[int, ...]:
        return tuple([self.hidden] * (self.num_layers - 1)
                     + [self.hidden // 2])

    @property
    def decoder_hiddens(self) -> tuple[int, ...]:
        return tuple([self.hidden] * self.num_layers)


def init(generator: torch.Generator, cfg: AutoencoderConfig,
         dtype=torch.float32, device=None) -> dict[str, Any]:
    """Random parameters drawn from ``generator`` (on the CPU, so a seed
    gives the same weights whatever the device), placed on ``device``."""
    dev = resolve_device(device)
    out_dim = 2 * cfg.input_dim if cfg.heteroscedastic else cfg.input_dim
    return {
        "encoder": rnn.init_stack(generator, cfg.input_dim,
                                  cfg.encoder_hiddens, dtype, cell=cfg.cell,
                                  device=dev),
        "decoder": rnn.init_stack(generator, cfg.hidden // 2,
                                  cfg.decoder_hiddens, dtype, cell=cfg.cell,
                                  device=dev),
        "head": linear.init_dense(generator, cfg.hidden, out_dim, dtype,
                                  device=dev),
    }


def apply(params: dict[str, Any], x_seq, rows, cfg: AutoencoderConfig, *,
          backend: str = "reference", initial_state=None, lengths=None,
          return_state: bool = False, precision: str | None = None,
          return_decoded: bool = False, device=None, mesh=None,
          policy=None):
    """Forward pass for one set of MCD masks.

    x_seq: [B, T, I]; rows: [B] mask-stream row ids.  ``backend`` selects
    the stack path (``"reference"`` | ``"cuda_step"`` | ``"cuda_seq"``);
    all draw the same masks.  ``initial_state`` resumes the per-layer
    encoder carry of a streaming session, ``lengths`` freezes ragged rows,
    ``return_state`` also returns the encoder states, ``return_decoded``
    the decoder's hidden sequence [B, W, H] (after ``log_var``).
    ``precision`` (fp32/bf16/int8/int4, None = native dtypes) serves both
    stacks at that precision, the input cast to the activation dtype up
    front; the head's outputs come out in the activation dtype.  Runs on
    ``device`` (default CUDA).  ``mesh`` / ``policy`` shard both stacks
    over a device mesh (``launch.rnn_shardings``; the head runs on
    ``mesh.home``), bit-equal to the unsharded pass.

    Returns (mean [B, W, I], log_var [B, W, I] or None)[, dec_out]
    [, encoder states] with ``W = min(T, cfg.decode_window or T)``.
    """
    dev = rnn.stack_device(device, mesh)
    x_seq = torch.as_tensor(x_seq, device=dev)
    if precision is not None:
        # Cast up front, so the reference masks sample in the dtype the
        # kernels materialize the 1/(1-p) scale in.
        x_seq = x_seq.to(quantize.activation_dtype(precision, x_seq.dtype))
    rows = torch.as_tensor(rows, device=dev)
    T = x_seq.shape[1]
    if backend == "reference":
        enc_masks = rnn.sample_stack_masks(
            cfg.mcd, rows, cfg.input_dim, cfg.encoder_hiddens,
            dtype=x_seq.dtype, cell=cfg.cell)
        dec_masks = rnn.sample_stack_masks(
            cfg.mcd, rows, cfg.hidden // 2, cfg.decoder_hiddens,
            layer_offset=cfg.num_layers, dtype=x_seq.dtype, cell=cfg.cell)
    else:  # the kernels rebuild the masks in-kernel
        enc_masks = rnn.stack_mask_plan(cfg.mcd, cfg.num_layers)
        dec_masks = rnn.stack_mask_plan(cfg.mcd, cfg.num_layers,
                                        layer_offset=cfg.num_layers)
    _, enc_states = rnn.run_stack(
        params["encoder"], x_seq, enc_masks, cfg.mcd.p,
        return_sequence=False, backend=backend, rows=rows,
        seed=cfg.mcd.seed, initial_state=initial_state, lengths=lengths,
        return_all_states=True, cell=cfg.cell, precision=precision,
        device=dev, mesh=mesh, policy=policy)
    h_T = enc_states[-1][0]
    # Repeat the bottleneck over the decode positions; the decoder replays
    # fresh per chunk and inherits `lengths` (capped at the window).
    W = T if cfg.decode_window is None else min(T, cfg.decode_window)
    dec_in = h_T[:, None, :].expand(h_T.shape[0], W, h_T.shape[1])
    dec_lengths = (lengths if lengths is None or W == T
                   else torch.clamp(torch.as_tensor(lengths, device=dev),
                                    max=W))
    dec_out, _ = rnn.run_stack(
        params["decoder"], dec_in, dec_masks, cfg.mcd.p, backend=backend,
        rows=rows, seed=cfg.mcd.seed, layer_offset=cfg.num_layers,
        lengths=dec_lengths, cell=cfg.cell, precision=precision,
        device=dev, mesh=mesh, policy=policy)
    y = linear.dense(params["head"], dec_out)
    if cfg.heteroscedastic:
        mean, log_var = torch.chunk(y, 2, dim=-1)
        out = mean, torch.clamp(log_var, -10.0, 10.0)
    else:
        out = y, None
    if return_decoded:
        out = (*out, dec_out)
    return (*out, enc_states) if return_state else out


def gaussian_nll(mean: torch.Tensor, log_var: torch.Tensor | None,
                 target: torch.Tensor) -> torch.Tensor:
    """Per-example Gaussian NLL (the paper's Fig. 1 fit metric)."""
    if log_var is None:
        return 0.5 * torch.mean((mean - target) ** 2, dim=(-2, -1))
    inv_var = torch.exp(-log_var)
    return 0.5 * torch.mean((mean - target) ** 2 * inv_var + log_var
                            + math.log(2.0 * math.pi), dim=(-2, -1))
