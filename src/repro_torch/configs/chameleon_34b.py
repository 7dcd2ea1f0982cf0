"""chameleon-34b [vlm] — early-fusion, VQ image tokens. [arXiv:2405.09818]

Early fusion: image patches are VQ-tokenized into the shared 65536 vocab; the
vision tokenizer is the stubbed frontend, and the serving engine supplies
zero patch-token *embeddings* at the first ``n_img_tokens`` positions.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=65536,
        n_img_tokens=1024, rope_theta=1e4,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    train_mode="fsdp_gt", long_ctx="swa",
    notes="34B: per-node copies exceed a 16-way TP shard; gradient tracking "
          "runs over the pod axis (DESIGN.md §3)")
