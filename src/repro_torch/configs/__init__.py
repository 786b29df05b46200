"""Architecture registry: one module per ported architecture.

``get(name)`` returns the full-size ArchConfig.  The names are the
reference's; an architecture whose family the port does not run yet
raises, naming its ROADMAP item.
"""

from __future__ import annotations

import importlib

ARCH_IDS = ["llama3_2_1b"]

# every architecture of the reference; those not in ARCH_IDS wait for
# their family (ROADMAP.md §1 item 10)
KNOWN_IDS = [
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

ALIASES = {a.replace("_", "-"): a for a in KNOWN_IDS}
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
        if mod_name in KNOWN_IDS:
            raise NotImplementedError(
                f"{name!r} is not ported yet: its family waits for "
                "ROADMAP.md §1 item 10 (LLM stack)")
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG

