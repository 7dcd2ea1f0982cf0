"""Roofline of a dry-run step on one NVIDIA H100: the counterpart of
``repro.launch.roofline``, with the same arithmetic and the card's
constants in place of the TPU's.

Hardware model (NVIDIA H100 SXM, data-sheet peaks at the full 700 W power
limit; a card set below that limit runs slower under load):
    peak compute  989 TFLOP/s bf16 dense, tensor cores, per card
    HBM bandwidth 3.35 TB/s HBM3 per card
    NVLink        450 GB/s per direction per card

The three terms, per device:

    compute    = flops / peak
    memory     = hbm_bytes / hbm_bw
    collective = collective_bytes / link_bw

The counts come from :mod:`repro_torch.launch.trace_analysis` (one traced
run of the step on ``meta`` tensors), not from compiled HLO. So the JAX
module's HLO text parsers, ``shape_bytes`` and ``collective_bytes``, have
no torch meaning and are not ported: a traced run's tensor bytes are its
tensors' ``nbytes``, and its collective bytes are counted where the mix is
called (:func:`repro_torch.launch.dryrun.counted_mix`).
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet (dense, without sparsity): 989.4 TFLOP/s
# bf16/fp16 on the tensor cores
PEAK_FLOPS = 989e12       # bf16 FLOP/s per card
# the same data sheet: 80 GB HBM3 at 3.35 TB/s
HBM_BW = 3.35e12          # B/s per card
# the same data sheet: NVLink 900 GB/s per card, both directions together
LINK_BW = 450e9           # B/s per card and direction


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
        }


def model_flops(spec, shape, n_chips: int) -> float:
    """MODEL_FLOPS = 6·N·tokens (train) / 2·N·tokens (inference), N = active
    params — the 'useful' flops yardstick for the whole job."""
    cfg = spec.config
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def useful_ratio(spec, shape, flops_per_device: float, n_chips: int) -> float:
    total = flops_per_device * n_chips
    mf = model_flops(spec, shape, n_chips)
    return mf / total if total else 0.0
