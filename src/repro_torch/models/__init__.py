"""repro_torch.models — the dense decoder in PyTorch."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, init_cache,
                                            init_params, layer_params,
                                            prefill)

__all__ = ["ModelConfig", "decode_step", "init_cache", "init_params",
           "layer_params", "prefill"]
