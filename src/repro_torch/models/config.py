"""Unified architecture configuration for the assigned model zoo.

A model is described as a sequence of *stages*; each stage is a repeated
period of heterogeneous blocks (``pattern``).  Homogeneous repetition lets the
backbone scan over stacked parameters — one period of HLO regardless of depth,
which is what keeps 64–72-layer models compilable on a 512-device mesh.

Block kinds (mixer/ffn pairs):
  "attn.mlp"   GQA attention + dense SwiGLU MLP
  "attn.moe"   GQA attention + MoE FFN
  "mla.mlp"    multi-head latent attention + dense MLP
  "mla.moe"    MLA + MoE
  "mamba"      Mamba2/SSD mixer (no FFN — mamba2 arch style)
  "mamba.mlp"  Mamba2 mixer + dense MLP (jamba style)
  "mamba.moe"  Mamba2 mixer + MoE
  "enc_attn.mlp"          bidirectional self-attention (encoder)
  "dec_attn.cross.mlp"    causal self-attention + cross-attention (decoder)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.mcd import MCDConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    d_conv: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: tuple[str, ...]
    repeat: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    stages: tuple[Stage, ...]
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None     # default d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 500000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # Encoder–decoder (whisper): encoder stages listed separately.
    encoder_stages: tuple[Stage, ...] = ()
    encoder_seq: int = 0            # fixed stub frontend length (audio frames)
    # VLM: number of patch-embedding positions prepended by the stub frontend.
    num_patches: int = 0
    tie_embeddings: bool = False
    mcd: MCDConfig = dataclasses.field(
        default_factory=lambda: MCDConfig(p=0.1, placement="Y", n_samples=8))
    # True sub-quadratic support (SSM/hybrid) → eligible for long_500k.
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def uniform_stages(kind: str, n_layers: int) -> tuple[Stage, ...]:
    return (Stage(pattern=(kind,), repeat=n_layers),)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned): every LM arch is paired with all four shapes;
# ``decode_*``/``long_*`` lower serve_step, ``long_500k`` only for
# sub-quadratic archs (skip recorded in the roofline table + DESIGN.md).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(applicable?, reason-if-not) for one (arch × shape) cell."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k dense-attention decode "
                       "is out of regime (see DESIGN.md §5); run for SSM/hybrid only")
    return True, ""
