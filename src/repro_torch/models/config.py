"""ModelConfig — the architecture fields the port's dense path reads.

The field names are the JAX package's, so a test can build both configs
from the same overrides; ``dtype`` and ``param_dtype`` are ``torch.dtype``s.
The port runs the ``dense`` family so far; the fields other families need
come back with the slice that first runs them (``ROADMAP.md``). ``family``,
``window``, ``norm``, ``act``, ``qkv_bias`` and ``logits_softcap`` are kept
so that ``models.transformer.require_dense`` can reject a config that needs
more than the port has."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None      # sliding-window attention (SWA variant)

    # --- numerics -------------------------------------------------------------
    norm: str = "rmsnorm"
    act: str = "swiglu"
    dtype: torch.dtype = torch.bfloat16       # activation dtype
    param_dtype: torch.dtype = torch.float32
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
