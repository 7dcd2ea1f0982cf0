"""Communication compression for the gossip step (beyond-paper extension).

The mixing step becomes

    X_{t+1} ← X_t + (W − I) C(X_t)        (compressed-gossip form)

where ``C`` is a per-leaf sparsifier. Only the compressed values would cross
the network, so communicated bytes drop by the keep-ratio while the self
term stays exact.

The counterpart of ``repro.core.compression``. Every function acts on
node-stacked trees (leading axis K). The only state, the EF21 accumulators
of :class:`ErrorFeedbackMix`, is carried by the engine, one slot per mix
call site (:meth:`ErrorFeedbackMix.state0`, :meth:`ErrorFeedbackMix.bind`).
:func:`ef21_update` is the innovation rule that
:class:`repro_torch.core.async_gossip.AsyncGossipMix` shares.

* Top-k keeps every entry whose magnitude reaches the k-th largest of its
  node, so ties keep every tied entry, as the JAX package's threshold does.
* The random mask of a leaf is fixed: it is drawn once from a
  ``torch.Generator`` seeded by ``seed`` and the blake2s digest of the
  leaf's path, kept, and reused on every call. It is never drawn while a
  CUDA graph is captured. (Its bits are not the JAX package's, whose mask
  comes from threefry; its law is.)

The shard-local ``ring_wmi_local`` waits with the ``ring_local`` backend
(``ROADMAP.md``, queue 1, item 6).
"""
from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.hypergrad import (tree_add, tree_map, tree_sub,
                                        weak_scalar)
from repro_torch.core.tracking import MixFn, contract
from repro_torch.device import resolve_device


def path_seed(path) -> int:
    """Stable 31-bit digest of a pytree key path: the JAX package's
    ``_path_seed`` (the key path printed the same way, ``['w'][0]``)."""
    digest = hashlib.blake2s(pytree.keystr(path).encode()).digest()
    return int.from_bytes(digest[:4], "little") % (2 ** 31)


def _check_ratio(ratio: float) -> None:
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"keep ratio must lie in (0, 1], got {ratio}")


def topk_sparsify(ratio: float) -> Callable:
    """Keep the top ``ratio`` fraction of entries by magnitude, per node and
    per leaf (deterministic; the classic top-k compressor)."""
    _check_ratio(ratio)

    def compress(tree):
        def leaf(a):
            if ratio >= 1.0:
                return a
            flat = a.reshape(a.shape[0], -1)           # [K, d]
            k = max(int(flat.shape[1] * ratio), 1)
            # threshold = k-th largest magnitude per node
            mag = flat.abs()
            thresh = torch.topk(mag, k, dim=1).values[:, -1:]
            return (flat * (mag >= thresh)).reshape(a.shape).to(a.dtype)
        return tree_map(leaf, tree)

    return compress


def random_sparsify(ratio: float, seed: int = 0,
                    rescale: bool = True) -> Callable:
    """Keep a random ``ratio`` fraction (unbiased up to 1/ratio scaling).

    ``rescale=False`` drops the 1/ratio factor, giving the *contractive*
    (biased) variant: ‖v − C(v)‖ ≤ ‖v‖. Error feedback requires it — with
    the unbiased rescale the EF21 accumulator update h' = h + C(v − h)
    overshoots kept coordinates by 1/ratio and diverges geometrically.

    Each leaf's mask is drawn on the first call that meets the leaf's path
    and shape and kept for every later call."""
    _check_ratio(ratio)
    masks: dict = {}

    def mask_for(path, a):
        key = (pytree.keystr(path), tuple(a.shape), a.device)
        if key not in masks:
            if a.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "random_sparsify: a leaf's mask must be drawn before "
                    "the CUDA graph is captured (warm the step up first)")
            s = np.random.SeedSequence([seed, path_seed(path)])
            gen = torch.Generator().manual_seed(int(s.generate_state(1)[0]))
            masks[key] = (torch.rand(a.shape, generator=gen) < ratio).to(
                a.device)
        return masks[key]

    def compress(tree):
        def leaf(path, a):
            if ratio >= 1.0:
                return a
            kept = a * mask_for(path, a)
            return (kept / weak_scalar(ratio, a) if rescale else kept).to(
                a.dtype)
        return pytree.tree_map_with_path(leaf, tree)

    return compress


def compressed_mix(W, compressor: Callable, device="cuda") -> MixFn:
    """Gossip with compressed neighbor contributions:
    mix(A) = A + (W − I) C(A).  Exact when C = identity."""
    Wm = _w_minus_i(W, device)

    def mix(tree):
        comp = compressor(tree)
        return tree_map(lambda a, c: (a + contract(Wm, c)).to(a.dtype),
                        tree, comp)

    return mix


def ef21_update(h, fresh, compressor: Callable):
    """The EF21 innovation rule: ``h' = h + C(fresh − h)``.

    ``h`` is the receiver's proxy of the sender's value; only ``C(fresh −
    h)`` crosses the network. Shared by :class:`ErrorFeedbackMix` and the
    stale-gossip composition in
    :class:`repro_torch.core.async_gossip.AsyncGossipMix`."""
    return tree_add(h, compressor(tree_sub(fresh, h)))


def _w_minus_i(W, device) -> torch.Tensor:
    Wn = np.asarray(W)
    return torch.as_tensor(Wn - np.eye(Wn.shape[0]), dtype=torch.float32).to(
        resolve_device(device))


def dense_wmi(W, device="cuda") -> Callable:
    """``tree ↦ (W − I)·tree`` by contraction with the full K×K matrix (in
    f32 for a bf16 tree, not cast back, as the JAX package's)."""
    Wm = _w_minus_i(W, device)

    def apply(tree):
        return tree_map(lambda hh: contract(Wm, hh), tree)

    return apply


def ring_wmi_rolled(self_weight: float = 1.0 / 3.0) -> Callable:
    """``(W − I)·tree`` for the ring, W-free via ``torch.roll``."""
    nb = (1.0 - self_weight) / 2.0

    def apply(tree):
        def leaf(h):
            w, s = weak_scalar(nb, h), weak_scalar(1.0 - self_weight, h)
            return (w * torch.roll(h, 1, dims=0)
                    + w * torch.roll(h, -1, dims=0) - s * h)
        return tree_map(leaf, tree)

    return apply


class ErrorFeedbackMix:
    """EF21-style stateful compressed gossip (Richtárik et al., 2021).

    Plain ``compressed_mix`` communicates C(A) directly, so the gossip fixed
    point is biased by the compression error. Error feedback keeps, per
    gossip call site, a device-resident proxy ``h`` of what the neighbors
    have reconstructed so far and only compresses the *innovation*:

        c_t = C(A_t − h_{t−1});   h_t = h_{t−1} + c_t
        mix(A_t) = A_t + (W − I) h_t

    The ``(W − I)·h`` product is the dense contraction with ``W``, or the
    given ``wmi``. The engine threads the per-call-site accumulators
    through its steps via :meth:`bind` / :meth:`state0`; a direct
    ``__call__`` is the stateless ``h ≡ 0`` case (identical to plain
    ``compressed_mix``), used for the t = 0 init.
    """

    stateful = True

    def __init__(self, W, compressor: Callable, wmi: Callable | None = None,
                 device="cuda"):
        if W is None and wmi is None:
            raise ValueError("ErrorFeedbackMix needs W or an explicit wmi")
        self.device = resolve_device(device)
        self.wmi = dense_wmi(W, self.device) if wmi is None else wmi
        self.compressor = compressor

    def state0(self, site, site_index: int):
        """The t = 0 slot of one call site: a zero accumulator shaped like
        ``site`` (a tree of tensors of the mixed tree's shapes and dtypes,
        on any device), on the mix's device."""
        del site_index
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=self.device), site)

    def apply(self, tree, h):
        """One EF21 update: (mixed tree, updated accumulator)."""
        h_new = ef21_update(h, tree, self.compressor)
        wh = self.wmi(h_new)
        mixed = tree_map(lambda a, d: (a + d).to(a.dtype), tree, wh)
        return mixed, h_new

    def __call__(self, tree):
        h0 = tree_map(torch.zeros_like, tree)
        return self.apply(tree, h0)[0]

    def bind(self, states, draws=None):
        """Close over per-call-site accumulators for one step.

        ``states`` is a sequence of ``h`` trees consumed in call order (the
        call order inside an algorithm step is fixed, so site *i* is always
        the same mixed variable); ``draws`` is unused (the mix draws
        nothing). Returns ``(mix, out)``, where ``out`` collects the
        updated accumulators in the same order."""
        del draws
        it = iter(states)
        out: list = []

        def mix(tree):
            mixed, h_new = self.apply(tree, next(it))
            out.append(h_new)
            return mixed

        return mix, out


def neighbor_degree(W) -> int:
    """Max number of neighbors a node sends to under mixing matrix W: the
    count of nonzero off-diagonal entries in its densest row."""
    Wn = np.asarray(W)
    off = (np.abs(Wn) > 0) & ~np.eye(Wn.shape[0], dtype=bool)
    return int(off.sum(axis=1).max())


def comm_bytes_per_mix(tree, ratio: float, W=None) -> int:
    """Communicated payload per gossip round per node:
    degree · ratio · (values + indices).

    The neighbor degree comes from the mixing matrix ``W`` (nonzero
    off-diagonal entries per row); W=None assumes the 2-neighbor ring the
    paper benchmarks on."""
    degree = 2 if W is None else neighbor_degree(W)
    total = 0
    for a in pytree.tree_leaves(tree):
        d = a.numel() // a.shape[0]
        kept = max(int(d * ratio), 1)
        per_entry = a.element_size() + (4 if ratio < 1.0 else 0)  # + index
        total += degree * kept * per_entry
    return total
