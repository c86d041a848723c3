"""LM backbone — port of the dense and Mamba2 subset of ``repro.models``:
``config`` (architecture dataclasses, copied verbatim), ``layers``
(attention, SwiGLU, RoPE, norms with MC-dropout sites), ``mamba2`` (the SSD
mixer) and ``backbone`` (forward, prefill, decode_step over the
stages)."""

from repro_torch.models.config import (SHAPES, ArchConfig,  # noqa: F401
                                       ShapeCell, Stage, shape_applicable,
                                       uniform_stages)
