"""Architecture and input-shape registry. The port holds the architectures
whose path it runs so far; ``ROADMAP.md`` lists the rest."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, str] = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get(arch: str) -> ArchSpec:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).SPEC


def all_specs() -> dict[str, ArchSpec]:
    return {name: get(name) for name in ARCHS}
