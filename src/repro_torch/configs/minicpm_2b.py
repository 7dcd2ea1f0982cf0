"""minicpm-2b [dense] — llama-like arch trained with the WSD schedule.
[arXiv:2404.06395]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="dp", long_ctx="swa",
    notes="MHA (kv=heads), WSD schedule")
