"""FLOPs, HBM traffic and peak memory of one run of a function, counted on
``meta`` tensors: the counterpart of ``repro.launch.hlo_analysis``.

The JAX package compiles a step and walks its optimized HLO. The port's
steps are eager PyTorch, so :func:`analyze` runs the function once on
``meta`` tensors (shapes, dtypes and strides, no storage, no arithmetic)
under a ``TorchDispatchMode`` that sees every aten operator the run
dispatches, below ``torch.func``'s transforms, and counts three things:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s count, taken
  from its registry of formulas operator by operator: the 2·M·N·K rule that
  the HLO walker applies to every ``dot`` (matmuls, batched matmuls,
  convolutions and attention; elementwise work is not counted, as in the
  JAX walker). The tests hold it equal to ``FlopCounterMode`` itself.
* **traffic_bytes**: the sum over operators of the bytes of their tensor
  inputs and outputs, the unfused model: each eager operator reads its
  inputs from HBM and writes its outputs there, which is what the port's
  eager and graph-replayed steps do (a CUDA graph replays the same
  kernels). View and metadata operators move nothing and are skipped
  (the HLO walker's ``_SKIP_TRAFFIC``); slices, gathers, copies and casts
  count their result bytes once; in-place index and scatter updates count
  the update.
* **peak_bytes**: the largest total of live tensor storage during the run,
  the inputs included, each storage counted once while any tensor on it
  is alive (tracked with ``weakref`` callbacks). It stands in for XLA's
  argument + temp - alias.

Kernel dispatch: a ``meta`` tensor takes each kernel wrapper's plain
version (as the CPU does), so a prefill counts the plain attention and
scans, as the JAX dry run on host devices counts its einsum references.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import fold

aten = torch.ops.aten

# queries that read metadata only
_METADATA = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
# no bytes move: views that are not flagged as such, and allocation
# without a write
_NO_TRAFFIC = {
    aten._unsafe_view.default, aten.lift_fresh.default,
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.set_.source_Storage_storage_offset,
}
# read only what they return: the result bytes, once
_RESULT_ONLY = {
    aten.index_select.default, aten.gather.default, aten.index.Tensor,
    aten.clone.default, aten._to_copy.default, aten.copy.default,
    aten.copy_.default, aten.embedding.default, aten.narrow_copy.default,
    aten.repeat.default, aten.flip.default, aten.roll.default,
    aten.expand_copy.default, aten.slice_copy.Tensor,
}
# in-place updates: the argument that holds the update
_UPDATE_ARG = {
    aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
    aten.index_add_.default: 3, aten.index_copy_.default: 3,
    aten.scatter_.src: 3, aten.scatter_add_.default: 3,
    aten.scatter_reduce_.two: 3, aten.masked_scatter_.default: 2,
}


def _tensors(tree) -> list:
    """The tensors of an operator's arguments or results: a tensor, or
    (nested) lists, tuples and dicts of them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for t in tree:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (list, tuple, dict)):
            out.extend(_tensors(t))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _traffic(func, args, kwargs, out) -> int:
    if func in _NO_TRAFFIC or getattr(func, "is_view", False):
        return 0
    if func in _RESULT_ONLY:
        return sum(_nbytes(t) for t in _tensors(out))
    if func in _UPDATE_ARG:
        return _nbytes(args[_UPDATE_ARG[func]])
    if func is aten.scatter_.value:
        # a scalar written at every index
        return args[2].numel() * args[0].element_size()
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in _tensors(out)))


class _Counter(TorchDispatchMode):
    """Flops, traffic and live storage of every operator the run
    dispatches."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list] = {}   # storage -> [tensors, nbytes]
        self._weak: dict[int, weakref.ref] = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [0, st.nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        ref = weakref.ref(t, self._release)
        self._weak[id(ref)] = (ref, key)

    def _release(self, ref) -> None:
        _, key = self._weak.pop(id(ref))
        entry = self._refs[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _METADATA:
            return out
        self.ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        self.traffic += _traffic(func, args, kwargs, out)
        for t in _tensors(out):
            self.track(t)
        return out


def as_meta(tree):
    """Every tensor leaf of ``tree`` as a fresh ``meta`` tensor of the same
    shape, strides and dtype (each leaf its own storage, as the step's
    real inputs are)."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                                   dtype=t.dtype, device="meta")
    return pytree.tree_map(one, tree)


def analyze(fn, *args, scan_len: int | None = None) -> dict:
    """Run ``fn(*args)`` on ``meta`` copies of ``args`` and count its flops,
    HBM traffic and peak live bytes (the module docstring).

    Returns ``{"flops", "traffic_bytes", "peak_bytes", "argument_bytes",
    "output_bytes", "ops"}``, all global (the whole step on one device);
    ``argument_bytes`` and ``output_bytes`` sum the leaves' ``nbytes``.

    ``scan_len``: the length of the sequential scans ``fn`` runs (the
    sequence length of a hybrid or ssm model's step). The run is then made
    twice with every scan folded to its first 2 and 3 steps
    (:mod:`repro_torch.fold`), and each count is extrapolated along the
    line through the two to ``scan_len`` steps: exact for the additive
    counts, and for the peak while the same point of the run holds it. (A
    scan's first step starts from a constant state, so its derivatives
    differ from the later steps', which are all alike: the line starts at
    2 steps.)"""
    if scan_len is None or scan_len <= 3:
        return _analyze_once(fn, args)
    with fold.folded(2):
        two = _analyze_once(fn, args)
    with fold.folded(3):
        three = _analyze_once(fn, args)
    return {k: two[k] + (scan_len - 2) * (three[k] - two[k]) for k in two}


def _analyze_once(fn, args) -> dict:
    args = as_meta(args)
    counter = _Counter()
    for t in _tensors(args):
        counter.track(t)
    argument_bytes = sum(_nbytes(t) for t in _tensors(args))
    with counter:
        out = fn(*args)
    result = {
        "flops": int(counter.flops),
        "traffic_bytes": int(counter.traffic),
        "peak_bytes": int(counter.peak),
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(sum(_nbytes(t) for t in _tensors(out))),
        "ops": counter.ops,
    }
    del out
    return result
