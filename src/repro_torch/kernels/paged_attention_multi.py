"""Paged attention over a speculative verify window: the CUDA kernel's
wrapper.

The kernel (``paged_attention_multi_kernel`` in ``csrc/paged_attention.cu``,
the paged-attention body at Q rows, built into the same library as the
decode kernel) replaces the TPU kernel
``repro.kernels.paged_attention.paged_attention_multi``; the source's note
gives the bound and the design. This wrapper validates the arguments,
allocates the output, launches on the current stream and counts the launch.
CPU tensors go to the plain version
(:func:`repro_torch.kernels.ref.paged_attention_multi_ref`); CUDA tensors go
to the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import _DTYPE_CODES, check_args
from repro_torch.kernels.ref import paged_attention_multi_ref


@functools.cache
def _launcher():
    fn = build.load("paged_attention").paged_attention_multi_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp,   # q k v tables lengths out
                   i32, i32, i32, i32, i32,  # B Q H Hkv Dh
                   i32, i32, i32, i32,       # L block_size n_pages layer
                   ctypes.c_float, i32, vp]  # scale dtype stream
    fn.restype = i32
    return fn


def paged_attention_multi(q, k_pages, v_pages, tables, lengths, layer=0):
    """Block-table attention for a window of Q tokens per slot.

    q: [B, Q, H, Dh] — per slot, the current token and Q - 1 draft
      candidates (RoPE applied), whose K/V are already in the pool at
      positions ``lengths - Q .. lengths - 1``. Any Q: the kernel cuts a KV
      head's Q * G rows into tiles of at most 64.
    k_pages/v_pages: [num_blocks + 1, block_size, L, Hkv, Dh] physical pool
      (the trailing block is trash).
    tables: [B, n_pages] int32 block tables (possibly clamped to the live
      high-water page count).
    lengths: [B] int32 — valid KV positions per slot after all Q appends (0
      for dead slots). Row ``r`` attends positions ``< lengths - (Q-1-r)``,
      clamped to the table's coverage; a row with nothing to attend emits
      zeros.
    layer: which transformer layer of the pool to read.

    Returns [B, Q, H, Dh] in q's dtype. ``paged_attention_multi.launches``
    counts the kernel launches (CPU calls to the plain version are not
    counted).
    """
    check_args(q, k_pages, v_pages, tables, lengths, layer, window=True)
    B, Q, H, Dh = q.shape
    _, block_size, L, Hkv, _ = k_pages.shape
    if Q < 1:
        raise ValueError(f"window Q={Q}: the window holds at least one "
                         "token")
    if q.device.type == "cpu":
        return paged_attention_multi_ref(q, k_pages, v_pages, tables,
                                         lengths, layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_multi runs on cuda or cpu, not "
                         f"{q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Q, H, Hkv, Dh, L, block_size, tables.shape[1], int(layer),
            Dh ** -0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_multi launch failed: CUDA "
                           f"error {err}")
    paged_attention_multi.launches += 1
    return out


paged_attention_multi.launches = 0
