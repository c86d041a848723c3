"""llama3-8b [dense] — GQA kv=8, 128k vocab. [arXiv:2407.21783]"""

from repro_torch.core.mcd import MCDConfig
from repro_torch.models.config import ArchConfig, uniform_stages

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    stages=uniform_stages("attn.mlp", 32),
    d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
    vocab_size=128256, rope_theta=500000.0,
    mcd=MCDConfig(p=0.1, placement="Y", n_samples=8),
)

REDUCED = CONFIG.replace(
    name="llama3-8b-reduced",
    stages=uniform_stages("attn.mlp", 2),
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256,
)
