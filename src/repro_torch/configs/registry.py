"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures the port serves resolve; the reference's other
architectures raise with the list of what the port has.
"""

from __future__ import annotations

from . import qwen2_1_5b, zamba2_2_7b
from .base import ModelConfig

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get(name: str, smoke: bool = False) -> ModelConfig:
    key = name.removesuffix("-smoke")
    if key not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet; "
                       f"ported: {', '.join(ARCH_IDS)}")
    mod = _MODULES[key]
    return mod.SMOKE if (smoke or name.endswith("-smoke")) else mod.CONFIG
