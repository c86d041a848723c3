"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed top-6 + 2 shared.

Layer 0 uses a dense MLP (published config d_ff=10944); layers 1..26 use MoE
with per-expert d_ff=1408.  [arXiv:2405.04434]
"""


from repro_torch.core.mcd import MCDConfig
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    stages=(Stage(pattern=("mla.mlp",), repeat=1),
            Stage(pattern=("mla.moe",), repeat=26)),
    d_model=2048, num_heads=16, num_kv_heads=16, d_ff=10944,
    vocab_size=102400, rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    mcd=MCDConfig(p=0.1, placement="Y", n_samples=8),
)

REDUCED = CONFIG.replace(
    name="deepseek-v2-lite-reduced",
    stages=(Stage(pattern=("mla.mlp",), repeat=1),
            Stage(pattern=("mla.moe",), repeat=2)),
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=1,
                  capacity_factor=8.0),
    mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16),
)
