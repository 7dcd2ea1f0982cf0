"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000,
        block_pattern=("rec", "rec", "attn"),
        lru_width=2560, conv1d_width=4, local_window=2048,
        act="gelu",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="dp", long_ctx="native",
    notes="long_500k native: RG-LRU state + 2048-window local attention")
