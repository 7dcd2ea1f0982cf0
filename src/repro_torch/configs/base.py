"""ArchSpec: a registered architecture's ModelConfig, its framework-level
policy and its test-size cut."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    # How the decentralized bilevel trainer maps nodes onto the mesh:
    #   'dp'      — per-node parameter copies, node axis = data (the
    #               paper's setting)
    #   'fsdp_gt' — params sharded inside a node, gradient tracking between
    #               node groups (the JAX package's mesh placement)
    train_mode: str = "dp"
    # long_500k handling: 'native' (state/window built in), 'swa' (run the
    # sliding-window variant, window below), 'skip' (full-attention enc-dec)
    long_ctx: str = "swa"
    swa_window: int = 4096
    notes: str = ""

    @property
    def name(self) -> str:
        return self.config.name

    def model_for_shape(self, shape: str) -> ModelConfig:
        """Shape-specific model variant: long_500k swaps in sliding-window
        attention for full-attention decoder archs."""
        cfg = self.config
        if shape == "long_500k":
            if self.long_ctx == "skip":
                raise ValueError(f"{cfg.name} skips long_500k ({self.notes})")
            if self.long_ctx == "swa":
                cfg = cfg.with_overrides(window=self.swa_window)
        return cfg

    def reduced(self) -> ModelConfig:
        """Smoke-test variant: 2 layers (the hybrid family: one block of
        its pattern), d_model ≤ 256, ≤ 4 heads, d_ff ≤ 512, vocab ≤ 512,
        f32 — same wiring. The JAX package's ``ArchSpec.reduced`` cut for the
        families the port runs (dense, hybrid, ssm), so tests compare like
        with like."""
        cfg = self.config
        d_model = min(cfg.d_model, 256)
        n_heads = max(min(cfg.n_heads, 4), 1)
        while d_model % n_heads:
            n_heads -= 1
        n_kv = max(1, min(cfg.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw = dict(
            n_layers=len(cfg.block_pattern) if cfg.family == "hybrid" else 2,
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(cfg.d_ff, 512), vocab=min(cfg.vocab, 512),
            dtype=torch.float32, param_dtype=torch.float32)
        if cfg.family == "hybrid":
            kw.update(lru_width=d_model, local_window=64)
        return cfg.with_overrides(**kw)
