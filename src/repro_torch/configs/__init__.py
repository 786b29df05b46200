"""Architecture registry: one module per architecture.

``get(name)`` returns the full-size ArchConfig; ``registry()`` lists all.
The names and aliases are the reference's.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "whisper_medium",
    "mamba2_780m",
    "internlm2_1_8b",
    "llama3_2_1b",
    "codeqwen1_5_7b",
    "qwen2_5_32b",
    "deepseek_moe_16b",
    "qwen3_moe_30b_a3b",
    "zamba2_2_7b",
    "llava_next_mistral_7b",
]

ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "whisper-medium": "whisper_medium",
    "mamba2-780m": "mamba2_780m",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3.2-1b": "llama3_2_1b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
})


def get(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def registry() -> dict:
    return {a: get(a) for a in ARCH_IDS}
