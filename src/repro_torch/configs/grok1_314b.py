"""grok-1-314b [moe] — 8 experts, top-2, logits soft-capping.
[hf:xai-org/grok-1]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072,
        n_experts=8, top_k=2, logits_softcap=30.0,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="fsdp_gt", long_ctx="swa",
    notes="E=8 does not divide the 16-wide model axis: experts stay unsharded "
          "and d_ff is tensor-parallel inside each expert")
