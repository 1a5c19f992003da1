"""Workload configurations: the QuClassi paper settings
(``quclassi_paper``) and the LM architectures the port serves, one module
each, registered in ``base`` (``base.get(name)`` loads them lazily)."""
from __future__ import annotations

import importlib

#: only the architectures this port runs; the reference registers more
_MODULES = (
    "smollm_360m",
    "qwen3_4b",
    "granite_34b",
    "nemotron_4_340b",
    "granite_moe_3b_a800m",
    "deepseek_v3_671b",
    "jamba_v0_1_52b",
    "xlstm_125m",
    "phi_3_vision_4_2b",
    "musicgen_large",
)

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
