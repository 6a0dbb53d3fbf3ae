"""Architecture registry of the port. Twin of ``repro.configs``.

The port serves three of the reference's ten configurations: ``hymba-1.5b``
(every layer runs attention and SSD heads in parallel), ``smollm-135m``
(attention only) and ``mamba2-1.3b`` (SSD only). The other seven need MoE,
MLA, M-RoPE or frame inputs and come with the rest of the ML stack.
"""
from ..models.config import ArchConfig
from . import hymba_1_5b, mamba2_1_3b, smollm_135m

_MODULES = [hymba_1_5b, smollm_135m, mamba2_1_3b]

ARCHS: dict[str, ArchConfig] = {m.ARCH.name: m.ARCH for m in _MODULES}
SMOKES: dict[str, ArchConfig] = {m.ARCH.name: m.SMOKE for m in _MODULES}

# the reference's other configurations, not ported yet
LATER = (
    "deepseek-v2-236b", "moonshot-v1-16b-a3b", "stablelm-1.6b",
    "starcoder2-7b", "qwen1.5-32b", "musicgen-medium", "qwen2-vl-72b",
)


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else ARCHS
    if name in LATER:
        raise KeyError(
            f"{name!r} is not ported yet: it comes with the rest of the ML "
            "stack (ROADMAP.md, queue 1, 'the rest of the ML stack')"
        )
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "LATER", "SMOKES", "get_arch"]
