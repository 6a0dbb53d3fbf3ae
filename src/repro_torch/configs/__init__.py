"""Architecture registry of the port. Twin of ``repro.configs``.

The port serves seven of the reference's ten configurations: ``hymba-1.5b``
(every layer runs attention and SSD heads in parallel), ``mamba2-1.3b``
(SSD only), the dense attention models ``smollm-135m``, ``stablelm-1.6b``,
``starcoder2-7b`` and ``qwen1.5-32b``, and the Mixture-of-Experts model
``moonshot-v1-16b-a3b``. The other three need what the port does not have
yet (ROADMAP.md, queue 1, item 6 step 3): ``deepseek-v2-236b`` multi-head
latent attention (MLA), ``musicgen-medium`` frame inputs, and
``qwen2-vl-72b`` frame inputs and M-RoPE positions.
"""
from ..models.config import ArchConfig
from . import (
    hymba_1_5b,
    mamba2_1_3b,
    moonshot_v1_16b,
    qwen1_5_32b,
    smollm_135m,
    stablelm_1_6b,
    starcoder2_7b,
)

_MODULES = [
    hymba_1_5b,
    moonshot_v1_16b,
    smollm_135m,
    stablelm_1_6b,
    starcoder2_7b,
    qwen1_5_32b,
    mamba2_1_3b,
]

ARCHS: dict[str, ArchConfig] = {m.ARCH.name: m.ARCH for m in _MODULES}
SMOKES: dict[str, ArchConfig] = {m.ARCH.name: m.SMOKE for m in _MODULES}

# the reference's other configurations, and what each needs first
LATER = {
    "deepseek-v2-236b": "multi-head latent attention (MLA)",
    "musicgen-medium": "frame inputs",
    "qwen2-vl-72b": "frame inputs and M-RoPE positions",
}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else ARCHS
    if name in LATER:
        raise KeyError(
            f"{name!r} is not ported yet: it needs {LATER[name]} "
            "(ROADMAP.md, queue 1, item 6 step 3)"
        )
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "LATER", "SMOKES", "get_arch"]
