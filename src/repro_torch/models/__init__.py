"""repro_torch.models — every family of the JAX package in PyTorch."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (cache_batch_axes,
                                            cache_capacity_axes, chunked_ce,
                                            decode_step, forward, init_cache,
                                            init_params, layer_params,
                                            loss_fn, param_count, prefill)

__all__ = ["ModelConfig", "cache_batch_axes", "cache_capacity_axes",
           "chunked_ce", "decode_step", "forward", "init_cache",
           "init_params", "layer_params", "loss_fn", "param_count",
           "prefill"]
