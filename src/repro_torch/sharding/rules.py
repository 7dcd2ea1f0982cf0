"""Partitioning rules: parameter, batch and cache partition specs per
architecture. The counterpart of ``repro.sharding.rules``, rule for rule.

A :class:`PartitionSpec` lists, per tensor dimension, the mesh axes that
shard it: ``None``, an axis name, or a tuple of names, as JAX's does.
:func:`to_placements` turns a spec into DTensor placements, one ``Shard``
or ``Replicate`` per mesh axis (placement objects only: no process group is
made), and :func:`local_shape` gives the shard each chip holds.

Conventions (production mesh: data=16, model=16, optional pod=2):
  * Tensor parallelism over ``model``: attention head projections and MLP
    d_ff are column-sharded on the way in, row-sharded on the way out.
  * MoE expert parallelism over ``model`` when n_experts divides the axis;
    otherwise experts stay replicated and d_ff is tensor-parallel per expert
    (grok-1: E=8 on a 16-wide axis).
  * Vocab embedding: vocab-sharded when divisible, else d_model-sharded
    (minicpm 122753, whisper 51865 are not divisible by 16).
  * ``dp`` train mode: a leading node axis K (the decentralized
    participants) sharded over ``data``; each node's copy is tensor-sharded
    over ``model``.
  * ``fsdp_gt`` mode: node axis = ``pod``; inside a node parameters are
    additionally sharded over ``data`` (FSDP) on a non-TP dimension.

Every dim is sharded only when divisible by the mesh-axis size (``_ok``).
The rules match on parameter paths (``"embed" in path``, a leaf's name and
its parent's); the port's parameter trees carry the JAX trees' keys, so the
paths, and the specs, come out the same.
"""
from __future__ import annotations

from typing import Any

from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import Mesh

Tree = Any


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor: each entry ``None``, an axis
    name, or a tuple of names (major to minor). A one-name tuple is stored
    as the name and an empty one as ``None``, as JAX normalises them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _ok(dim: int, mesh: Mesh, axis: str | None) -> str | None:
    if axis is None or axis not in mesh.axis_names:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _path_str(path) -> str:
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
        else:
            out.append(str(p))
    return "/".join(out)


_EMBED_DATA = [True]  # toggled by the dry-run's --no-embed-fsdp variant


def _param_spec(cfg, path: str, shape: tuple[int, ...], mesh: Mesh,
                fsdp: bool) -> PartitionSpec:
    """Spec for one parameter leaf WITHOUT the node axis (added by caller).

    ``shape`` excludes the node axis but includes the stacked L/block axis
    for layer weights (first dim) — rules below index from the trailing
    dims.
    """
    data = "data" if fsdp else None
    nd = len(shape)

    def tail_spec(*tail):
        return P(*([None] * (nd - len(tail)) + list(tail)))

    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    # ---- embedding --------------------------------------------------------
    if "embed" in path:
        v, d = shape
        edata = data if _EMBED_DATA[0] else None
        if _ok(v, mesh, "model"):
            return P("model", _ok(d, mesh, edata))
        return P(_ok(v, mesh, edata), _ok(d, mesh, "model"))

    # ---- norms / biases / small vectors -----------------------------------
    if "norm" in path or name in ("b", "bias", "conv_b", "lam", "u", "w0",
                                  "ln_scale") or name.startswith("mu_"):
        return P(*([None] * nd))

    # ---- MoE --------------------------------------------------------------
    if parent == "moe" or (nd >= 3 and name in ("wi", "wg", "wo")
                           and "moe" in path):
        if name == "router":
            return tail_spec(_ok(shape[-2], mesh, data), None)
        e, d1, d2 = shape[-3], shape[-2], shape[-1]
        if _ok(e, mesh, "model"):
            return tail_spec("model", _ok(d1, mesh, data), None)
        # tensor-parallel experts: shard d_ff
        if name in ("wi", "wg"):  # [E, D, F]
            return tail_spec(None, _ok(d1, mesh, data),
                             _ok(d2, mesh, "model"))
        return tail_spec(None, _ok(d1, mesh, "model"), _ok(d2, mesh, data))

    # ---- attention --------------------------------------------------------
    if parent in ("attn", "cross") or "/attn/" in path or "/cross/" in path:
        if name == "w" or nd >= 2:
            d_in, d_out = shape[-2], shape[-1]
            if "wo" in path:
                return tail_spec(_ok(d_in, mesh, "model"),
                                 _ok(d_out, mesh, data))
            return tail_spec(_ok(d_in, mesh, data),
                             _ok(d_out, mesh, "model"))

    # ---- MLP --------------------------------------------------------------
    if name in ("wi", "wg"):
        return tail_spec(_ok(shape[-2], mesh, data),
                         _ok(shape[-1], mesh, "model"))
    if name == "wo":
        return tail_spec(_ok(shape[-2], mesh, "model"),
                         _ok(shape[-1], mesh, data))

    # ---- RG-LRU -----------------------------------------------------------
    if name in ("w_in_x", "w_in_g"):
        return tail_spec(_ok(shape[-2], mesh, data),
                         _ok(shape[-1], mesh, "model"))
    if name == "w_out":
        return tail_spec(_ok(shape[-2], mesh, "model"),
                         _ok(shape[-1], mesh, data))
    if name == "conv_w":
        return tail_spec(None, _ok(shape[-1], mesh, "model"))
    if parent in ("w_a", "w_i"):
        if name == "w":
            return tail_spec(_ok(shape[-2], mesh, data),
                             _ok(shape[-1], mesh, "model"))
        return P(*([None] * nd))

    # ---- RWKV -------------------------------------------------------------
    if name in ("w_r", "w_k", "w_v", "w_g"):
        return tail_spec(_ok(shape[-2], mesh, data),
                         _ok(shape[-1], mesh, "model"))
    if name == "w_o":
        return tail_spec(_ok(shape[-2], mesh, "model"),
                         _ok(shape[-1], mesh, data))
    if name in ("wA", "wB"):
        return P(*([None] * nd))

    # ---- fallback: biggest dim on model if divisible ----------------------
    if nd >= 2:
        return tail_spec(_ok(shape[-2], mesh, data),
                         _ok(shape[-1], mesh, "model"))
    return P(*([None] * nd))


def _node_ax(node_axis, mesh: Mesh):
    """Normalize a node-axis selector (str | tuple | None) against the
    mesh."""
    if node_axis is None:
        return None
    if isinstance(node_axis, str):
        node_axis = (node_axis,)
    present = tuple(a for a in node_axis if a in mesh.axis_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def param_pspecs(cfg, params_shape: Tree, mesh: Mesh, *,
                 node_axis: str | tuple | None = None,
                 fsdp: bool = False) -> Tree:
    """PartitionSpec tree matching ``params_shape`` (tensors of any device,
    ``meta`` included: only their shapes are read).

    node_axis: name(s) of the mesh axes carrying the leading decentralized
    node dimension on every leaf (None = no node axis, e.g. serving)."""
    ax = _node_ax(node_axis, mesh)

    def leaf(path, s):
        shape = tuple(s.shape)
        if node_axis is not None:
            spec = _param_spec(cfg, _path_str(path), shape[1:], mesh, fsdp)
            return P(ax, *spec)
        return _param_spec(cfg, _path_str(path), shape, mesh, fsdp)

    return pytree.tree_map_with_path(leaf, params_shape)


def batch_pspecs(batch_shape: Tree, mesh: Mesh, *,
                 node_axis: str | tuple | None,
                 batch_axes: tuple[str, ...]) -> Tree:
    """Tokens/labels/extras: leading node axis (optional) then batch dim
    sharded over ``batch_axes`` (when divisible)."""
    ax = _node_ax(node_axis, mesh)

    def leaf(s):
        shape = tuple(s.shape)
        dims: list = []
        rest = shape
        if node_axis is not None:
            dims.append(ax)
            rest = shape[1:]
        if rest:
            size = 1
            for a in batch_axes:
                size *= _axis_size(mesh, a)
            dims.append(tuple(batch_axes) if batch_axes and
                        rest[0] % size == 0 and size > 1 else None)
            dims.extend([None] * (len(rest) - 1))
        return P(*dims)

    return pytree.tree_map(leaf, batch_shape)


def cache_pspecs(cache_shape: Tree, mesh: Mesh, *, batch: int) -> Tree:
    """Decode cache: [L, B, S, H, Dh]-style leaves. Shard B over data when
    divisible; otherwise shard the longest remaining dim over data
    (sequence-parallel cache for long_500k's batch=1); heads/model-dim over
    model. A leaf without a shape (the cache's ``idx``) is replicated."""
    dsz, msz = _axis_size(mesh, "data"), _axis_size(mesh, "model")

    def leaf(s):
        shape = tuple(getattr(s, "shape", ()))
        if not shape:
            return P()
        dims = [None] * len(shape)
        # find the batch dim: first dim equal to `batch` after the L dim
        try:
            bdim = next(i for i, d in enumerate(shape)
                        if d == batch and i >= 1)
        except StopIteration:
            bdim = None
        used_data = False
        if bdim is not None and batch % dsz == 0 and dsz > 1:
            dims[bdim] = "data"
            used_data = True
        # model axis: largest dim (excluding L and batch) divisible by msz
        cand = [(d, i) for i, d in enumerate(shape)
                if i != bdim and i >= 1 and d % msz == 0 and d >= msz]
        if cand:
            _, i = max(cand)
            dims[i] = "model"
            if not used_data:
                rest = [(d, j) for d, j in cand if j != i and d % dsz == 0]
                if rest:
                    dims[max(rest)[1]] = "data"
        return P(*dims)

    return pytree.tree_map(leaf, cache_shape)


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec: PartitionSpec, mesh: Mesh) -> tuple[int, ...]:
    """The shard of a ``shape`` tensor that one chip holds under ``spec``:
    each dim divided by the sizes of the mesh axes that shard it (dims past
    the spec's length are whole). Raises if a dim does not divide."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for i, entry in enumerate(spec):
        n = 1
        for a in _axes_of(entry):
            n *= _axis_size(mesh, a)
        if out[i] % n:
            raise ValueError(f"dim {i} of {shape} does not divide over "
                             f"{entry} ({n} shards)")
        out[i] //= n
    return tuple(out)


def to_placements(spec_tree: Tree, mesh: Mesh) -> Tree:
    """Each spec as DTensor placements, one per mesh axis in mesh order:
    ``Shard(d)`` where tensor dim ``d`` names that axis, else
    ``Replicate()`` (the counterpart of ``to_shardings``'
    ``NamedSharding``; placement objects only, no process group)."""
    from torch.distributed.tensor import Replicate, Shard

    def one(spec):
        where = {a: d for d, entry in enumerate(spec)
                 for a in _axes_of(entry)}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in mesh.axis_names)

    return pytree.tree_map(one, spec_tree, is_leaf=_is_spec)
