"""Architecture configs, by the reference's ids (its registry mirrored:
`ARCH_IDS` in its order, the paper's own `llama31_8b` reachable through
`ALIASES` only, `all_arch_names()`).

Each module exposes CONFIG (the published configuration) and
smoke_config() (a reduced same-family variant for CPU tests).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "internlm2_1_8b",
    "granite_8b",
    "qwen3_32b",
    "stablelm_12b",
    "llama4_maverick_400b_a17b",
    "granite_moe_3b_a800m",
    "whisper_tiny",
    "internvl2_2b",
    "xlstm_125m",
    "zamba2_1_2b",
]

# canonical ids as published (dashes) -> module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-32b": "qwen3_32b",
    "granite-8b": "granite_8b",
    "stablelm-12b": "stablelm_12b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "whisper-tiny": "whisper_tiny",
    "internvl2-2b": "internvl2_2b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama31-8b": "llama31_8b",
})


def _module(name: str):
    name = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke_config()


def all_arch_names():
    return [i.replace("_", "-") for i in ARCH_IDS]
