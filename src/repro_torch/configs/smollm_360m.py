"""smollm-360m [dense] — llama-arch small, GQA with 5 KV heads.
[hf:HuggingFaceTB/SmolLM-135M]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(config=ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152,
    dtype=torch.bfloat16, param_dtype=torch.float32))
