"""Architecture and input-shape registry: the JAX package's ten
architectures."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, str] = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
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
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).SPEC


def all_specs() -> dict[str, ArchSpec]:
    return {name: get(name) for name in ARCHS}


def pairs(include_skips: bool = False):
    """The 40 (arch x shape) assignments; skips yield (pair, reason)."""
    for arch in ARCHS:
        spec = get(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and spec.long_ctx == "skip":
                if include_skips:
                    yield (arch, shape.name), spec.notes
                continue
            yield (arch, shape.name), None
