from repro_torch.configs.base import ArchSpec
from repro_torch.configs.registry import ARCHS, get

__all__ = ["ARCHS", "ArchSpec", "get"]
