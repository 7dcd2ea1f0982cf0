"""ModelConfig — the architecture fields the port's model paths read.

The field names are the JAX package's, so a test can build both configs
from the same overrides; ``dtype`` and ``param_dtype`` are ``torch.dtype``s.
Every family of the JAX package is here: ``dense`` (with QKV bias, and
with a sliding ``window`` for the ``long_500k`` variants), ``moe``,
``hybrid`` (RecurrentGemma), ``ssm`` (RWKV-6), ``vlm`` (early fusion of
image embeddings) and ``audio`` (Whisper's encoder-decoder). The JAX
field ``remat`` is a memory policy of its scanned layers and has no
counterpart here."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
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

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1            # dispatch groups with their own capacity

    # --- hybrid (RecurrentGemma) ---------------------------------------------
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int | None = None
    conv1d_width: int = 4
    local_window: int = 2048

    # --- encoder-decoder (Whisper) -------------------------------------------
    is_encdec: bool = False
    n_enc_layers: int = 0
    src_len: int = 1500            # audio frames after the conv frontend (stub)

    # --- frontend stubs -------------------------------------------------------
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_img_tokens: int = 0          # vlm: image embeddings fused per sample

    # --- numerics -------------------------------------------------------------
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    dtype: torch.dtype = torch.bfloat16       # activation dtype
    param_dtype: torch.dtype = torch.float32
    logits_softcap: float = 0.0    # grok-style tanh soft-capping

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("moe",) and not (self.n_experts and self.top_k):
            raise ValueError(f"{self.name}: moe family needs n_experts/top_k")
        if self.family == "hybrid" and not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("rec", "rec", "attn"))
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter count (the JAX package's MODEL_FLOPS = 6·N·D accounting)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        D, F, Dh = self.d_model, self.d_ff, self.head_dim
        H, Hkv = self.n_heads, self.n_kv_heads
        attn = D * (H * Dh) + 2 * D * (Hkv * Dh) + (H * Dh) * D
        mlp = 3 * D * F if self.act == "swiglu" else 2 * D * F
        if self.family == "moe":
            e = self.n_experts if not active_only else self.top_k
            mlp = mlp * e + D * self.n_experts   # experts + router
        per_layer = attn + mlp + 2 * D
        if self.family == "ssm":  # rwkv6: time-mix ~4 D² + decay lora + channel-mix
            per_layer = 4 * D * D + 2 * D * D + 2 * D * F + 2 * D
        if self.family == "hybrid":
            rnn = self.lru_width or D
            rec_layer = (2 * D * rnn + rnn * D + self.conv1d_width * rnn
                         + 3 * rnn + mlp + 2 * D)
            att_layer = attn + mlp + 2 * D
            n_rec = sum(1 for i in range(self.n_layers)
                        if self.block_pattern[i % len(self.block_pattern)]
                        == "rec")
            body = n_rec * rec_layer + (self.n_layers - n_rec) * att_layer
        else:
            body = self.n_layers * per_layer
        total = body + self.vocab * D + D  # embedding, final norm
        if self.is_encdec:
            enc_layer = attn + mlp + 2 * D
            cross = attn + D
            total += self.n_enc_layers * enc_layer + self.n_layers * cross
        return int(total)
