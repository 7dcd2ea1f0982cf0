from repro_torch.configs.base import ArchSpec
from repro_torch.configs.registry import (ARCHS, SHAPES, InputShape,
                                          all_specs, get)

__all__ = ["ARCHS", "ArchSpec", "InputShape", "SHAPES", "all_specs", "get"]
