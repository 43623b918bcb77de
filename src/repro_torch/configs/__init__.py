"""Architecture configs ported so far, by the reference's ids.

Each module exposes CONFIG (the published configuration) and
smoke_config() (a reduced same-family variant for CPU tests). The
other architectures arrive with the slices that port their families.
"""

from __future__ import annotations

import importlib

ARCH_IDS = ["internlm2_1_8b", "llama4_maverick_400b_a17b",
            "granite_moe_3b_a800m"]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({
    "internlm2-1.8b": "internlm2_1_8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
})


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; the port has "
            f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke_config()
