"""Device policy shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device`` to a ``torch.device``.

    Entry points default to ``"cuda"`` and never fall back to the CPU on their
    own: without a card this raises, and a caller that wants the CPU says so
    with ``device="cpu"``. ``"meta"`` builds shapes and dtypes only, with
    no storage and no arithmetic (the dry run's trace,
    :mod:`repro_torch.launch.dryrun`)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
