"""mamba2-370m [ssm] — attention-free SSD. [arXiv:2405.21060]

48 mamba blocks, d_model=1024, ssm_state=128, expand=2 → d_inner=2048,
head_dim=64 → 32 SSD heads.  num_heads/num_kv_heads/d_ff are unused
(attn-free; the paper's MCD technique applies to the in-projections —
DESIGN.md §5).
"""

from repro_torch.core.mcd import MCDConfig
from repro_torch.models.config import ArchConfig, SSMConfig, uniform_stages

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    stages=uniform_stages("mamba", 48),
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    sub_quadratic=True,
    mcd=MCDConfig(p=0.1, placement="Y", n_samples=8),
)

REDUCED = CONFIG.replace(
    name="mamba2-reduced",
    stages=uniform_stages("mamba", 3),
    d_model=64, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
)
