"""olmoe-1b-7b [moe] — 64 experts top-8, d_ff_expert=1024. [arXiv:2409.02060]"""

from repro_torch.core.mcd import MCDConfig
from repro_torch.models.config import ArchConfig, MoEConfig, uniform_stages

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    stages=uniform_stages("attn.moe", 16),
    d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1024,
    vocab_size=50304, qk_norm=True, rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    mcd=MCDConfig(p=0.1, placement="Y", n_samples=8),
)

REDUCED = CONFIG.replace(
    name="olmoe-reduced",
    stages=uniform_stages("attn.moe", 2),
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0),
)
