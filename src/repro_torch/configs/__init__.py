"""Assigned-architecture registry — port of ``repro.configs``: ``--arch
<id>`` resolves here.

Each module exports CONFIG (the exact published configuration) and REDUCED
(a same-family miniature for CPU tests), copied verbatim from the reference
(data only).  The port serves every one of them: the dense ``attn.mlp``
archs, mamba2-370m, the MoE family (olmoe-1b-7b's ``attn.moe``,
deepseek-v2-lite-16b's ``mla.mlp`` / ``mla.moe``) and jamba's hybrid
(``attn.moe``, ``mamba.mlp``, ``mamba.moe``).
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "llama3_8b",
    "qwen3_1p7b",
    "jamba_1p5_large_398b",
    "mamba2_370m",
    "deepseek_v2_lite_16b",
    "olmoe_1b_7b",
)

# accept the assignment-sheet spellings too
ALIASES = {
    "llama3-8b": "llama3_8b",
    "qwen3-1.7b": "qwen3_1p7b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}


def get_config(name: str, reduced: bool = False):
    key = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.REDUCED if reduced else mod.CONFIG
