"""Folding of the sequential scans, for counting a step without running
every one of its time steps.

The port's recurrences (the RG-LRU and WKV scans) are Python loops over the
sequence. The JAX package's dry run counts a ``lax.scan`` body once and
multiplies it by the loop's trip count; an eager trace has no loop to
multiply, and a 4 096-step WKV scan under the trainer's derivatives
dispatches tens of millions of operators. Inside :func:`folded` each such
loop runs only its first ``m`` steps and fills the rest of its output with
its last step's, detached (:func:`pad`), so the rest of the model sees the
shapes it always does and no derivative flows into the filler.
Every scan step after the first (which starts from a constant state)
dispatches the same operators on the same shapes, in the forward pass and
in every derivative pass, so each count of a run is an affine function of
``m`` from ``m`` = 2 on, and two runs (``m`` = 2, 3) give it at ``m`` = the
sequence length (:func:`repro_torch.launch.trace_analysis.analyze`).

The training forward's loops (``models.rglru.scan_steps``,
``models.rwkv6.wkv_scan``) call :func:`steps` and :func:`pad` themselves.
The kernel wrappers take :func:`rglru` and :func:`wkv6_scan` on ``meta``
tensors: copies of their plain versions in ``kernels/ref.py`` that
dispatch the same operators step by step and fold, so the references the
kernels are held against have no fold mode.
Outside :func:`folded` the loops run every step and :func:`pad` returns its
list unchanged.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

import torch

_tls = threading.local()


def steps(n: int) -> int:
    """How many of a scan's ``n`` steps to run: all of them, or ``m`` inside
    :func:`folded`."""
    m = getattr(_tls, "m", None)
    return n if m is None else min(m, n)


def pad(items: list, n: int) -> list:
    """``items`` (a scan's per-step outputs) to length ``n``, repeating the
    last, detached: the list itself unless a fold cut it short."""
    if len(items) == n:
        return items
    return items + [items[-1].detach()] * (n - len(items))


@contextlib.contextmanager
def folded(m: int):
    """Run every scan of the block for its first ``m`` steps."""
    old = getattr(_tls, "m", None)
    _tls.m = m
    try:
        yield
    finally:
        _tls.m = old


def rglru(a, x):
    """:func:`repro_torch.kernels.ref.rglru_ref`, folded: a/x [B, S, R] ->
    h [B, S, R]."""
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(steps(a.shape[1])):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    return torch.stack(pad(hs, a.shape[1]), dim=1)


def wkv6_scan(r, k, v, w, u, s0=None):
    """:func:`repro_torch.kernels.ref.wkv6_scan_ref`, folded: r/k/v/w
    ``[B, S, H, Dh]``, u ``[H, Dh]``, s0 ``[B, H, Dh, Dh]`` or None -> (y
    ``[B, S, H, Dh]`` in r's dtype, the state after the last step run)."""
    B, S, H, Dh = r.shape
    state = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    rt, kt, vt, wt = (t.float().transpose(1, 2) for t in (r, k, v, w))
    u = u.float()[..., :, None]
    ys = []
    for r_t, k_t, v_t, w_t in itertools.islice(
            zip(*(t.unbind(-2) for t in (rt, kt, vt, wt))), steps(S)):
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append((r_t[..., None, :] @ (state + u * kv))[..., 0, :])
        state = w_t[..., :, None] * state + kv
    y = torch.stack(pad(ys, S), dim=-2)
    return y.transpose(1, 2).to(r.dtype), state
