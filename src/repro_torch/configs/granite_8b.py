"""granite-8b [dense] — llama-arch, code. [arXiv:2405.04324]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="dp", long_ctx="swa",
    notes="GQA kv=8")
