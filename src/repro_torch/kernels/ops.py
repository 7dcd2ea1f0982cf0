"""The model's dispatch points for the kernels of the prefill path, the
counterparts of ``repro.kernels.ops.attention`` (layout q [B, H, S, Dh],
k/v [B, Hkv, S, Dh]) and ``repro.kernels.ops.rglru`` (a/x [B, S, R]).

The JAX package runs its Pallas kernel on the TPU and the plain version
elsewhere; here each call runs the CUDA kernel on CUDA tensors and the plain
version on CPU tensors — the kernel wrappers' own dispatch. There is no
other branch: a build or launch failure raises, and nothing falls back.
"""
from repro_torch.kernels.flash_attention import flash_attention as attention
from repro_torch.kernels.rglru_scan import rglru_scan as rglru

__all__ = ["attention", "rglru"]
