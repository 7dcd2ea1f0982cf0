"""ModelConfig — the architecture fields the port's model paths read.

The field names are the JAX package's, so a test can build both configs
from the same overrides; ``dtype`` and ``param_dtype`` are ``torch.dtype``s.
The port runs the ``dense``, ``hybrid`` (RecurrentGemma) and ``ssm``
(RWKV-6) families so far; the fields other families need come back with
the slice that first runs them (``ROADMAP.md``). ``window``, ``norm``,
``qkv_bias`` and ``logits_softcap`` are kept so that
``models.transformer.require_ported`` can reject a config that needs more
than the port has."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "dense", "hybrid" or "ssm" in the port
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

    # --- hybrid (RecurrentGemma) ---------------------------------------------
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int | None = None
    conv1d_width: int = 4
    local_window: int = 2048

    # --- numerics -------------------------------------------------------------
    norm: str = "rmsnorm"
    act: str = "swiglu"            # swiglu | gelu
    dtype: torch.dtype = torch.bfloat16       # activation dtype
    param_dtype: torch.dtype = torch.float32
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "hybrid" and not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("rec", "rec", "attn"))
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
