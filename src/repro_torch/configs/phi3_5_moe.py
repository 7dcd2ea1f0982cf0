"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064,
        n_experts=16, top_k=2,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="fsdp_gt", long_ctx="swa",
    notes="expert-parallel: 16 experts over the 16-wide model axis")
