"""Architecture registry. The port holds only the architectures whose path
it runs so far; ``ROADMAP.md`` lists the rest."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, str] = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}


def get(arch: str) -> ArchSpec:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).SPEC
