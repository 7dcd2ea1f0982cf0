"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(config=ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16))
