"""The RG-LRU linear recurrence: the CUDA kernel's wrapper.

The kernel (``rglru_scan_kernel`` in ``csrc/rglru_scan.cu``) replaces the
TPU kernel ``repro.kernels.rglru_scan.rglru_scan``; the source's note gives
the bound and the design. This wrapper validates the arguments, allocates
the output, launches on the current stream and counts the launch. CPU
tensors go to the plain version (:func:`repro_torch.kernels.ref.rglru_ref`);
CUDA tensors go to the kernel, and nowhere else.

The two differ in the carry: the kernel keeps h in f32, as the TPU kernel
does; the plain version keeps it in the inputs' dtype, as the JAX model's
``lax.scan`` does. In f32 they agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import fold
from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = build.load("rglru_scan").rglru_scan_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]  # a x h B S R dtype
    fn.restype = i32                                    # stream
    return fn


def check_args(a, x):
    """Raise on what the kernel does not take: a and x ``[B, S, R]`` of one
    shape and dtype on one device, contiguous."""
    if a.dim() != 3 or x.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"a and x must be one [B, S, R] shape; got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}")
    if a.dtype not in _DTYPE_CODES or x.dtype != a.dtype:
        raise TypeError(f"a and x must share one dtype of "
                        f"{list(_DTYPE_CODES)}; got {a.dtype}, {x.dtype}")
    if a.device != x.device:
        raise ValueError("a and x must be on one device")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("a and x must be contiguous")


def rglru_scan(a, x):
    """``h_t = a_t * h_{t-1} + x_t`` from ``h_0 = 0``: a/x [B, S, R] -> h
    [B, S, R] in a's dtype. ``rglru_scan.launches`` counts the kernel
    launches (CPU calls to the plain version, and meta calls to its folded
    copy, are not counted)."""
    check_args(a, x)
    if a.device.type == "cpu":
        return rglru_ref(a, x)
    if a.device.type == "meta":   # a dry run's trace (repro_torch.fold)
        return fold.rglru(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {a.device}")
    B, S, R = a.shape
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = _launcher()(a.data_ptr(), x.data_ptr(), out.data_ptr(), B, S,
                          R, _DTYPE_CODES[a.dtype],
                          torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
