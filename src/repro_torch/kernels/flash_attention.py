"""Blocked prefill attention: the CUDA kernel's wrapper.

The kernel (``flash_attention_kernel`` in ``csrc/flash_attention.cu``)
replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention``;
the source's note gives the bound and the design. This wrapper validates the
arguments, allocates the output with q's strides, launches on the current
stream and counts the launch. CPU tensors go to the plain version
(:func:`repro_torch.kernels.ref.attention_ref`); CUDA tensors go to the
kernel, and nowhere else.

The kernel reads every tensor through its batch, head and sequence strides,
so q/k/v may be ``[B, S, H, Dh]`` tensors viewed as ``[B, H, S, Dh]``
(``x.transpose(1, 2)``) without a copy; the output then has the same
layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


@functools.cache
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp,               # q k v out
                   i32, i32, i32, i32, i32, i32,  # B H Hkv Sq Skv Dh
                   ctypes.POINTER(ctypes.c_longlong),  # 12 strides
                   i32, i32, ctypes.c_float, i32, vp]  # causal window scale
    fn.restype = i32                                   # dtype stream
    return fn


def check_args(q, k, v, window):
    """Raise on what the kernel does not take: q ``[B, H, Sq, Dh]``, k/v
    ``[B, Hkv, Skv, Dh]`` of one dtype on one device, Dh in ``HEAD_DIMS``,
    the channel axis contiguous and every other stride and base 16-byte
    aligned, ``window`` None or positive."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, H, Sq, Dh] and k/v [B, Hkv, Skv, "
                         f"Dh]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[1] \
            or min(B, H, Sq, k.shape[2]) < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPE_CODES)};"
                        f" got {q.dtype}, {k.dtype}, {v.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} is not one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or positive, got {window}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must be on one device")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernel stages rows with 16-byte loads
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: channels must be contiguous and the "
                             f"other strides {t.stride()[:3]} and the base "
                             "16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """Causal, sliding-window or full attention with grouped KV heads.

    q: [B, H, Sq, Dh]; k/v: [B, Hkv, Skv, Dh], any strides with contiguous
    channels. Query head h reads KV head ``h * Hkv // H``; query i and key j
    sit at positions i and j; ``window`` masks keys at or before
    ``i - window``. Returns [B, H, Sq, Dh] in q's dtype, laid out like q.
    ``flash_attention.launches`` counts the kernel launches (CPU calls to the
    plain version are not counted).
    """
    check_args(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)   # q's strides: q is dense, never overlapping
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Hkv, Sq, Skv, Dh, strides, int(causal),
            0 if window is None else int(window), Dh ** -0.5,
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
