"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

``KERNEL_ORACLES`` is the port's kernel registry, the counterpart of
``repro.kernels.KERNEL_ORACLES``: every kernel wrapper is listed with its
plain version in :mod:`repro_torch.kernels.ref`, its CUDA source under
``csrc/`` and the test module that holds the two together.
:func:`check_kernel_oracles` is its self-test.
"""
from __future__ import annotations

import re
from pathlib import Path

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention_multi import paged_attention_multi
from repro_torch.kernels.ref import (attention_ref, paged_attention_multi_ref,
                                     paged_attention_ref, rglru_ref)
from repro_torch.kernels.rglru_scan import rglru_scan

# kernel wrapper -> (plain version in kernels/ref.py, parity test module)
KERNEL_ORACLES: dict[str, tuple[str, str]] = {
    "paged_attention": ("paged_attention_ref", "tests/test_torch_kernels.py"),
    "paged_attention_multi": ("paged_attention_multi_ref",
                              "tests/test_torch_kernels.py"),
    "flash_attention": ("attention_ref", "tests/test_torch_flash_rglru.py"),
    "rglru_scan": ("rglru_ref", "tests/test_torch_flash_rglru.py"),
}

_PKG = Path(__file__).resolve().parent
_ROOT = _PKG.parents[2]


def check_kernel_oracles(registry: dict[str, tuple[str, str]] | None = None,
                         ) -> list[str]:
    """Problems with the registry (empty when it is sound): every CUDA
    source has an entry, every entry names a wrapper exported here, a C
    entry point ``<kernel>_launch`` in a source, a plain version that
    exists in ``ref``, and a test module that mentions both."""
    registry = KERNEL_ORACLES if registry is None else registry
    problems = []
    sources = sorted((_PKG / "csrc").glob("*.cu"))
    for src in sources:
        if src.stem not in registry:
            problems.append(f"csrc/{src.name} has no KERNEL_ORACLES entry")
    for kernel, (oracle, test) in sorted(registry.items()):
        if not callable(globals().get(kernel)):
            problems.append(f"{kernel}: no wrapper exported by "
                            "repro_torch.kernels")
        if not any(re.search(rf"\b{kernel}_launch\b", src.read_text())
                   for src in sources):
            problems.append(f"{kernel}: no {kernel}_launch entry point in "
                            "csrc/")
        if not callable(getattr(ref, oracle, None)):
            problems.append(f"{kernel}: plain version {oracle} missing "
                            "from repro_torch.kernels.ref")
        path = _ROOT / test
        if not path.is_file():
            problems.append(f"{kernel}: test module {test} missing")
        elif not all(re.search(rf"\b{name}\b", path.read_text())
                     for name in (kernel, oracle)):
            problems.append(f"{kernel}: {test} does not name both "
                            f"{kernel} and {oracle}")
    return problems


__all__ = ["KERNEL_ORACLES", "attention_ref", "check_kernel_oracles",
           "flash_attention", "paged_attention", "paged_attention_multi",
           "paged_attention_multi_ref", "paged_attention_ref", "rglru_ref",
           "rglru_scan"]
