"""qwen2.5-3b [dense] — GQA (kv=2), QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936,
        qkv_bias=True, rope_theta=1e6,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="dp", long_ctx="swa",
    notes="GQA kv=2, QKV bias")
