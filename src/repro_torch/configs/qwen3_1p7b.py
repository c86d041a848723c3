"""qwen3-1.7b [dense] — GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B]"""

from repro_torch.core.mcd import MCDConfig
from repro_torch.models.config import ArchConfig, uniform_stages

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    stages=uniform_stages("attn.mlp", 28),
    d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128, d_ff=6144,
    vocab_size=151936, qk_norm=True, rope_theta=1000000.0,
    mcd=MCDConfig(p=0.1, placement="Y", n_samples=8),
)

REDUCED = CONFIG.replace(
    name="qwen3-1.7b-reduced",
    stages=uniform_stages("attn.mlp", 2),
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256,
)
