"""Paged decode attention: the CUDA kernel's wrapper.

The kernel (``paged_attention_decode_kernel`` in ``csrc/paged_attention.cu``,
the Q = 1 case of that file's paged-attention body) replaces the TPU kernel
``repro.kernels.paged_attention.paged_attention``; the source's note gives
the bound and the design. This wrapper validates the arguments, allocates the
output, launches on the current stream and counts the launch. CPU tensors go
to the plain version (:func:`repro_torch.kernels.ref.paged_attention_ref`);
CUDA tensors go to the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


@functools.cache
def _launcher():
    fn = build.load("paged_attention").paged_attention_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp,   # q k v tables lengths out
                   i32, i32, i32, i32,       # B H Hkv Dh
                   i32, i32, i32, i32,       # L block_size n_pages layer
                   ctypes.c_float, i32, vp]  # scale dtype stream
    fn.restype = i32
    return fn


def check_args(q, k_pages, v_pages, tables, lengths, layer, *,
               window: bool = False):
    """Raise on what the kernels do not take. ``q`` is ``[B, H, Dh]``, or
    ``[B, Q, H, Dh]`` with ``window=True``."""
    q_layout = "[B, Q, H, Dh]" if window else "[B, H, Dh]"
    if q.dim() != (4 if window else 3) or k_pages.dim() != 5:
        raise ValueError(f"q must be {q_layout} and the pools "
                         f"[N+1, bs, L, Hkv, Dh]; got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    _, _, L, Hkv, Dh_kv = k_pages.shape
    if B < 1:
        # the kernel launches one block row per slot; an empty batch would
        # launch nothing
        raise ValueError("q must hold at least one slot")
    if v_pages.shape != k_pages.shape or Dh_kv != Dh or H % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or tables.shape[1] < 1 \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"tables must be [B, n_pages>=1] and lengths [B]; "
                         f"got {tuple(tables.shape)}, {tuple(lengths.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of "
                        f"{list(_DTYPE_CODES)}; got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if Dh > MAX_HEAD_DIM or Dh % 8:
        # the kernel stages K/V rows with 16-byte loads
        raise ValueError(f"head_dim {Dh} must be a multiple of 8 and at "
                         f"most {MAX_HEAD_DIM}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    args = (q, k_pages, v_pages, tables, lengths)
    if len({t.device for t in args}) != 1:
        raise ValueError("all arguments must be on one device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all arguments must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, tables, lengths, layer=0):
    """Block-table decode attention for one new token per slot.

    q: [B, H, Dh] — the new token's queries (RoPE already applied).
    k_pages/v_pages: [num_blocks + 1, block_size, L, Hkv, Dh] physical pool
      (the trailing block is trash).
    tables: [B, n_pages] int32 — each slot's block table (possibly clamped to
      the live high-water page count); unallocated entries point at trash.
    lengths: [B] int32 — valid KV positions per slot (``idx + 1`` after the
      tail append; 0 for dead slots, which then emit zeros).
    layer: which transformer layer of the pool to read.

    Returns [B, H, Dh] in q's dtype. ``paged_attention.launches`` counts the
    kernel launches (CPU calls to the plain version are not counted).
    """
    check_args(q, k_pages, v_pages, tables, lengths, layer)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, tables, lengths,
                                   layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, H, Dh = q.shape
    _, block_size, L, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, Hkv, Dh, L, block_size, tables.shape[1], int(layer),
            Dh ** -0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
