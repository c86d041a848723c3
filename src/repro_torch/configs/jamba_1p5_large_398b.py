"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

Period of 8 layers: 1 attention + 7 mamba; MoE FFN on every other layer
(4 per period → 36 of 72).  [arXiv:2403.19887]
"""

from repro_torch.core.mcd import MCDConfig
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig, Stage

_PERIOD = ("attn.moe", "mamba.mlp", "mamba.moe", "mamba.mlp",
           "mamba.moe", "mamba.mlp", "mamba.moe", "mamba.mlp")

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    stages=(Stage(pattern=_PERIOD, repeat=9),),          # 72 layers
    d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
    vocab_size=65536, rope_theta=10000.0,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    sub_quadratic=True,
    mcd=MCDConfig(p=0.1, placement="Y", n_samples=8),
)

REDUCED = CONFIG.replace(
    name="jamba-reduced",
    stages=(Stage(pattern=_PERIOD, repeat=1),),
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, capacity_factor=8.0),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
)
