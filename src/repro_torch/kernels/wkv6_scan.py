"""The RWKV-6 WKV scan: the CUDA kernel's wrapper.

The kernel (``wkv6_scan_kernel`` in ``csrc/wkv6_scan.cu``) replaces the TPU
kernel ``repro.kernels.wkv6_scan.wkv6_scan``; the source's note gives the
bound and the design. This wrapper validates the arguments, allocates y and
the final state, launches on the current stream and counts the launch. CPU
tensors go to the plain version
(:func:`repro_torch.kernels.ref.wkv6_scan_ref`); CUDA tensors go to the
kernel, and nowhere else.

Unlike the TPU kernel, which starts from a zero state and returns y only,
this one takes the model's layout and carries the state across calls, as
the model's decode needs: r/k/v/w ``[B, S, H, Dh]`` read through their
strides (the model's per-head views need no copy), an initial state ``s0``
and the final state returned beside y. Both versions carry the state in
f32 and round its update the same way, so the final states agree bit for
bit; y differs by the summation order of a Dh-term dot product.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import fold
from repro_torch.kernels import build
from repro_torch.kernels.ref import wkv6_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


@functools.cache
def _launcher():
    fn = build.load("wkv6_scan").wkv6_scan_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,    # r k v w u s0 y s_out
                   i32, i32, i32, i32,                # B S H Dh
                   ctypes.POINTER(ctypes.c_longlong),  # 12 strides
                   i32, vp]                           # dtype stream
    fn.restype = i32
    return fn


def check_args(r, k, v, w, u, s0):
    """Raise on what the kernel does not take: r/k/v ``[B, S, H, Dh]`` of
    one dtype, w of that shape in f32, channels contiguous; u ``[H, Dh]``
    f32 and s0 ``[B, H, Dh, Dh]`` f32 (or None), contiguous; Dh in
    ``HEAD_DIMS``, S at least 1; all on one device."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r/k/v/w must be one [B, S, H, Dh] shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, Dh = r.shape
    if min(B, S, H) < 1 or Dh not in HEAD_DIMS:
        raise ValueError(f"need B, S, H >= 1 and Dh in {HEAD_DIMS}; got "
                         f"{tuple(r.shape)}")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"r/k/v must share one dtype of {list(_DTYPE_CODES)}"
                        f"; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32; got {w.dtype}, {u.dtype}")
    if tuple(u.shape) != (H, Dh):
        raise ValueError(f"u must be [H, Dh] = {(H, Dh)}; got "
                         f"{tuple(u.shape)}")
    if s0 is not None and (tuple(s0.shape) != (B, H, Dh, Dh)
                           or s0.dtype != torch.float32):
        raise ValueError(f"s0 must be float32 [B, H, Dh, Dh] = "
                         f"{(B, H, Dh, Dh)}; got {s0.dtype} "
                         f"{tuple(s0.shape)}")
    given = [t for t in (r, k, v, w, u, s0) if t is not None]
    if len({t.device for t in given}) != 1:
        raise ValueError("r, k, v, w, u and s0 must be on one device")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("r/k/v/w: channels must be contiguous")
    if not u.is_contiguous() or (s0 is not None and not s0.is_contiguous()):
        raise ValueError("u and s0 must be contiguous")


def wkv6_scan(r, k, v, w, u, s0=None):
    """The WKV recurrence ``y_t = r_t · (S_t + (u ⊙ k_t) v_tᵀ)``,
    ``S_{t+1} = diag(w_t) S_t + k_t v_tᵀ`` from ``S_0 = s0`` (zeros when
    None).

    r/k/v: ``[B, S, H, Dh]`` in f32 or bf16, any strides with contiguous
    channels; w: the decay, same shape, f32; u: the bonus ``[H, Dh]`` f32;
    s0: ``[B, H, Dh, Dh]`` f32 or None. Returns (y ``[B, S, H, Dh]`` in r's
    dtype, S_T ``[B, H, Dh, Dh]`` f32, a new tensor). ``wkv6_scan.launches``
    counts the kernel launches (CPU calls to the plain version, and meta
    calls to its folded copy, are not counted).
    """
    check_args(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, s0)
    if r.device.type == "meta":   # a dry run's trace (repro_torch.fold)
        return fold.wkv6_scan(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan runs on cuda or cpu, not {r.device}")
    B, S, H, Dh = r.shape
    y = torch.empty((B, S, H, Dh), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, Dh, Dh), dtype=torch.float32,
                        device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (r, k, v, w) for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        err = _launcher()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), B, S, H, Dh, strides,
            _DTYPE_CODES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_scan launch failed: CUDA error {err}")
    wkv6_scan.launches += 1
    return y, s_out


wkv6_scan.launches = 0
