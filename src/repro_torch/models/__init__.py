"""repro_torch.models — the dense, hybrid and ssm decoders in PyTorch."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (chunked_ce, decode_step, forward,
                                            init_cache, init_params,
                                            layer_params, loss_fn,
                                            param_count, prefill)

__all__ = ["ModelConfig", "chunked_ce", "decode_step", "forward",
           "init_cache", "init_params", "layer_params", "loss_fn",
           "param_count", "prefill"]
