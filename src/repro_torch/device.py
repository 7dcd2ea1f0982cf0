"""Device policy shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device`` to a ``torch.device``.

    Entry points default to ``"cuda"`` and never fall back to the CPU on their
    own: without a card this raises, and a caller that wants the CPU says so
    with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
