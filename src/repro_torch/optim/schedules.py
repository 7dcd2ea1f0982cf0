"""LR schedules, including MiniCPM's WSD (Warmup-Stable-Decay,
arXiv:2404.06395): the counterpart of ``repro.optim.schedules``. Each
returns ``f(step) -> lr``, a 0-d f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * \
            (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd_schedule(lr: float, total_steps: int, warmup_frac: float = 0.01,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long flat stage, sharp
    exponential decay over the final ``decay_frac`` of training
    (MiniCPM)."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step):
        step = _f32(step)
        warm = lr * step / warmup
        decay_t = torch.clamp((step - decay_start)
                              / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = lr * torch.exp(math.log(final_frac) * decay_t)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start,
                                       torch.tensor(lr, dtype=torch.float32),
                                       decay))
    return f
