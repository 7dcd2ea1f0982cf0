"""whisper-tiny [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is the stubbed frontend: the
serving engine supplies zero frame embeddings [B, 1500, 384].
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51865,
        is_encdec=True, n_enc_layers=4, src_len=1500,
        norm="layernorm", act="gelu",
        dtype=torch.bfloat16, param_dtype=torch.float32),
    train_mode="dp", long_ctx="skip",
    notes="enc-dec with full self+cross attention on both sides; no "
          "sub-quadratic variant implemented, long_500k skipped (DESIGN.md §4)")
