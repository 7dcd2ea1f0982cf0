"""Dry run on an H100 roofline: count every (arch x input shape x mesh) step
without allocating it. The counterpart of ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k \\
      --debug-mesh
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both]
  python -m repro_torch.launch.dryrun --arch ... --shape ... --mix ring \\
      --tag ringmix

Results land in ``build/dryrun/<arch>__<shape>__<mesh>[__tag].json`` under
the repository (``--out-dir`` elsewhere).

The JAX package lowers and compiles each step for its mesh and reads XLA's
memory and cost analyses. The port has no compiler to ask: each step runs
once on ``meta`` tensors under :func:`repro_torch.launch.trace_analysis.
analyze` (flops, unfused HBM traffic, peak live bytes), the whole step on
one device, and the mesh enters through the partition specs of
:mod:`repro_torch.sharding.rules`. So:

* ``memory.argument_bytes`` is exact: every input leaf's shard under its
  spec (:func:`~repro_torch.sharding.rules.local_shape`);
* per-device flops and traffic are the traced global counts divided by the
  chips. XLA's per-device count also holds the work a device repeats where
  a dimension does not divide (a replicated head, an unsharded vocab);
  this count does not;
* the peak per device is the arguments' shard plus the traced peak's
  temporaries divided by the chips (exact on one card);
* collective bytes are those of the mix the step is handed, counted at each
  call (:func:`counted_mix`): every node receives its two ring neighbours'
  shards of the mixed tree, 2 x the tree's local bytes, when the nodes sit
  on more than one device; 0 when all of them share each device (one card).
  Collectives a DTensor execution of the model's own tensor and FSDP
  sharding would add are not counted (that execution waits on
  ``ROADMAP.md``, queue 1, item 6).

Keys of the JAX result that have no meaning here are written as ``null``
and named under ``notes``: ``compile_s`` (nothing is compiled; ``trace_s``
is the trace's seconds), ``memory.alias_bytes`` (an eager step aliases no
input to an output) and ``xla_cost_reference``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import SHAPES, InputShape, get, pairs
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh
from repro_torch.launch.roofline import Roofline, model_flops, useful_ratio
from repro_torch.launch.trace_analysis import analyze, as_meta
from repro_torch.models import init_params
from repro_torch.serve.steps import (cache_specs, make_decode_step,
                                     make_prefill_step)
from repro_torch.sharding import rules
from repro_torch.sharding.hints import hints
from repro_torch.sharding.rules import (P, batch_pspecs, cache_pspecs,
                                        local_shape, param_pspecs)
from repro_torch.train.decentral import (TrainerConfig, make_mix,
                                         make_step_fns, node_keys_spec,
                                         state_shape, step_batch_specs)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")
# families whose steps run sequential scans (the RG-LRU, the WKV)
SCAN_FAMILIES = ("hybrid", "ssm")
NOTES = {
    "compile_s": "no compiler: the step is traced once on meta tensors "
                 "(trace_s)",
    "memory.alias_bytes": "an eager step aliases no input to an output",
    "xla_cost_reference": "no XLA cost analysis",
    "per_device": "flops and traffic are the global trace's over n_chips; "
                  "XLA's per-device count adds work repeated where a dim "
                  "does not divide",
    "traffic": "unfused: every operator reads its inputs and writes its "
               "outputs",
    "collectives": "the mix's ring exchange only",
}
# The JAX dry run's --act-model shards the activations' last dim on "model"
# through sharding.hints.constrain, which changes XLA's compiled placement.
# The port's constrain is the identity and its models do not call it, so
# the variant would change no count.
ACT_MODEL_WAITS = ("act_model: the activation constraint changes no count "
                   "until the port executes DTensor placements (ROADMAP.md, "
                   "queue 1, item 6)")


@dataclasses.dataclass
class Step:
    """A step to dry-run: ``fn(*args)`` with ``args`` as ``meta`` tensors,
    the partition specs of the inputs (and, where placed, the outputs), the
    activation hints, the counted mix of a train step and the scan length
    of a hybrid or ssm step."""
    fn: object
    args: tuple
    in_specs: tuple
    out_specs: object
    hints: dict
    mix: object = None
    scan_len: int | None = None


def _node_axes(spec, mesh: Mesh):
    names = mesh.axis_names
    if spec.train_mode == "fsdp_gt":
        axes = tuple(a for a in ("pod",) if a in names)
    else:
        axes = tuple(a for a in ("pod", "data") if a in names)
    K = 1
    for a in axes:
        K *= mesh.shape[a]
    return axes, K


def _activation_hints(spec, cfg, mesh: Mesh, *, serve: bool = False) -> dict:
    """Sharding hints for intermediates SPMD tends to replicate.

    fsdp_gt (and serving on any mesh): activations [B, S, D] batch-sharded
    over data(+pod); MoE dispatch buffers expert-parallel when E divides
    the model axis, token-sharded otherwise (grok: E=8 on a 16-wide
    axis)."""
    names = mesh.axis_names
    out = {}
    if spec.train_mode == "fsdp_gt" or serve:
        baxes = tuple(a for a in ("pod", "data") if a in names)
        if baxes:
            out["act"] = P(baxes, None, None)
    if cfg.family == "moe":
        msz = mesh.shape.get("model", 1)
        dax = "data" if "data" in names else None
        grouped = getattr(cfg, "moe_groups", 1) > 1
        if cfg.n_experts % msz == 0 and msz > 1:
            out["moe_ecd"] = P("model", dax, None)
            out["moe_ecf"] = P("model", dax, None)
            if grouped:
                out["moe_egcd"] = P("model", dax, None, None)
                out["moe_egcf"] = P("model", dax, None, None)
        else:
            out["moe_ecd"] = P(None, dax, "model")
            out["moe_ecf"] = P(None, dax, "model")
            if grouped:
                out["moe_egcd"] = P(None, dax, None, "model")
                out["moe_egcf"] = P(None, dax, None, "model")
    return out


def _batch_extra_specs(cfg, n: int, seq: int) -> dict:
    extras = {}
    if cfg.family == "vlm":
        ni = min(cfg.n_img_tokens, seq)
        extras["image_embeds"] = torch.empty((n, ni, cfg.d_model),
                                             dtype=cfg.dtype, device="meta")
        extras["image_pos"] = torch.empty((n, ni), dtype=torch.int32,
                                          device="meta")
    if cfg.family == "audio":
        extras["src_embeds"] = torch.empty((n, cfg.src_len, cfg.d_model),
                                           dtype=cfg.dtype, device="meta")
    return extras


def _local_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes of one device's shards of ``tree``'s tensors under ``specs``."""
    leaves = pytree.tree_leaves(tree)
    spec_leaves = pytree.tree_leaves(specs, is_leaf=rules._is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} "
                         f"specs")
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, spec_leaves)
               if isinstance(t, torch.Tensor))


def counted_mix(mix, local_bytes, crosses: bool):
    """``mix`` that records, at each call, the bytes one device receives:
    its nodes' two ring neighbours' shards of the mixed tree (2 x
    ``local_bytes(tree)``) when the nodes span devices (``crosses``), else
    0. ``.calls`` lists the counts."""
    def counted(tree):
        counted.calls.append(2 * local_bytes(tree) if crosses else 0)
        return mix(tree)

    counted.calls = []
    return counted


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def train_step(spec, mesh: Mesh, tc: TrainerConfig, K: int, per_node: int,
               seq: int) -> Step:
    """The trainer's step (``tc.algo``) over K nodes of ``per_node`` rows of
    ``seq`` tokens on ``mesh``: the state, step batch and J̃ of
    :func:`state_shape`, :func:`step_batch_specs` and :func:`node_keys_spec`,
    their specs, and the mix counted (:func:`counted_mix`)."""
    cfg = spec.config
    node_axes, K_mesh = _node_axes(spec, mesh)
    fsdp = spec.train_mode == "fsdp_gt"
    _, _, step = make_step_fns(cfg, tc)

    st_sh = state_shape(cfg, tc, K)
    batch_sh = step_batch_specs(cfg, tc, K, per_node, seq)
    keys_sh = node_keys_spec(K)

    # node_axes may be empty (fsdp_gt on a single pod: K=1, node dim present
    # but unsharded) — pass the tuple so param_pspecs still strips the dim.
    ax = node_axes if node_axes else None
    x_spec = P(ax, None)
    y_specs = param_pspecs(cfg, st_sh.y, mesh, node_axis=node_axes,
                           fsdp=fsdp)
    st_specs = st_sh._replace(
        x=x_spec, u=x_spec, zf=x_spec,
        y=y_specs, v=y_specs, zg=y_specs,
        **({"x_prev": x_spec, "y_prev": y_specs}
           if hasattr(st_sh, "x_prev") else {}))
    batch_axes = ("data",) if fsdp else ()
    b_specs = batch_pspecs(batch_sh, mesh, node_axis=node_axes,
                           batch_axes=batch_axes)
    k_spec = P(ax) if ax else P(None)

    def tree_bytes(tree):
        if isinstance(tree, torch.Tensor):
            return _local_bytes(tree, x_spec, mesh)
        return _local_bytes(tree, param_pspecs(
            cfg, tree, mesh, node_axis=node_axes, fsdp=fsdp), mesh)

    mix = counted_mix(make_mix(tc, K, device="meta"), tree_bytes,
                      crosses=K_mesh > 1)

    def fn(state, batch, jtilde):
        mix.calls.clear()   # a folded trace runs the step twice
        return step(mix, state, batch, jtilde)

    return Step(fn, (st_sh, batch_sh, keys_sh), (st_specs, b_specs, k_spec),
                st_specs, _activation_hints(spec, cfg, mesh), mix,
                seq if cfg.family in SCAN_FAMILIES else None)


def build_train(spec, shape: InputShape, mesh: Mesh,
                tc: TrainerConfig) -> Step:
    """:func:`train_step` at the registry shape: K from the mesh's node
    axes, the global batch split over the nodes."""
    _, K = _node_axes(spec, mesh)
    return train_step(spec, mesh, tc, K, max(shape.global_batch // K, 1),
                      shape.seq_len)


def _serve_params(spec, cfg, mesh: Mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_sh = as_meta(p)
    fsdp = spec.train_mode == "fsdp_gt"
    return p_sh, param_pspecs(cfg, p_sh, mesh, node_axis=None, fsdp=fsdp)


def build_prefill(spec, shape: InputShape, mesh: Mesh) -> Step:
    cfg = spec.model_for_shape(shape.name)
    B, S = shape.global_batch, shape.seq_len
    capacity = min(S, cfg.window or S)
    fn = make_prefill_step(cfg, capacity)
    p_sh, p_specs = _serve_params(spec, cfg, mesh)
    batch_sh = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                      device="meta")}
    batch_sh.update(_batch_extra_specs(cfg, B, S))
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    b_specs = batch_pspecs(batch_sh, mesh, node_axis=None,
                           batch_axes=batch_axes)
    return Step(fn, (p_sh, batch_sh), (p_specs, b_specs), None,
                _activation_hints(spec, cfg, mesh, serve=True),
                scan_len=S if cfg.family in SCAN_FAMILIES else None)


def build_decode(spec, shape: InputShape, mesh: Mesh) -> Step:
    cfg = spec.model_for_shape(shape.name)
    B, S = shape.global_batch, shape.seq_len
    capacity = min(S, cfg.window or S)
    if cfg.family == "hybrid":
        capacity = min(capacity, max(cfg.local_window, 1))
    fn = make_decode_step(cfg)
    p_sh, p_specs = _serve_params(spec, cfg, mesh)
    tok_sh = torch.empty((B, 1), dtype=torch.int32, device="meta")
    c_sh = cache_specs(cfg, B, capacity)
    c_specs = cache_pspecs(c_sh, mesh, batch=B)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    t_spec = batch_pspecs({"t": tok_sh}, mesh, node_axis=None,
                          batch_axes=batch_axes)["t"]
    h = _activation_hints(spec, cfg, mesh, serve=True)
    h.pop("act", None)  # decode activations are [B,1,D]; leave to SPMD
    return Step(fn, (p_sh, tok_sh, c_sh), (p_specs, t_spec, c_specs), None,
                h)


# ---------------------------------------------------------------------------
# Run one (arch, shape, mesh)
# ---------------------------------------------------------------------------

def _mesh_name(mesh: Mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def run_pair(arch: str, shape_name: str | None = None, *,
             multi_pod: bool = False, mesh: Mesh | None = None,
             tc: TrainerConfig | None = None, tag: str = "",
             out_dir: str | None = None, verbose: bool = True,
             variant: dict | None = None,
             train_shape: tuple[int, int, int] | None = None,
             reduced: bool = False) -> dict:
    """Dry-run ``arch`` at ``shape_name`` on ``mesh`` (the production mesh
    by default) and write the result's JSON; returns it.

    variant: perf-iteration knobs — {embed_fsdp: bool, capacity_factor:
    float, moe_groups: int}; ``act_model`` raises ``NotImplementedError``
    (:data:`ACT_MODEL_WAITS`). ``train_shape=(K, per_node, seq)`` dry-runs
    the trainer's step at that shape instead of a registry shape (K nodes,
    whatever the mesh's node axes hold); ``reduced`` takes the arch's
    ``.reduced()`` config."""
    variant = variant or {}
    if variant.get("act_model"):
        raise NotImplementedError(ACT_MODEL_WAITS)
    rules._EMBED_DATA[0] = variant.get("embed_fsdp", True)
    spec = get(arch)
    overrides = {}
    if variant.get("capacity_factor"):
        overrides["capacity_factor"] = float(variant["capacity_factor"])
    if variant.get("moe_groups"):
        overrides["moe_groups"] = int(variant["moe_groups"])
    cfg = spec.reduced() if reduced else spec.config
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    spec = dataclasses.replace(spec, config=cfg)
    tc = tc or TrainerConfig()
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    n_chips = mesh.size
    mesh_name = _mesh_name(mesh)

    if train_shape is not None:
        K, per_node, seq = train_shape
        shape = InputShape(f"train_{K}x{per_node}x{seq}", seq, K * per_node,
                           "train")
    else:
        shape = SHAPES[shape_name]

    t0 = time.time()
    if train_shape is not None:
        st = train_step(spec, mesh, tc, *train_shape)
    elif shape.kind == "train":
        st = build_train(spec, shape, mesh, tc)
    elif shape.kind == "prefill":
        st = build_prefill(spec, shape, mesh)
    else:
        st = build_decode(spec, shape, mesh)

    hint = st.hints
    with hints(**hint):
        acc = analyze(st.fn, *st.args, scan_len=st.scan_len)
    trace_s = time.time() - t0

    arg_dev = _local_bytes(st.args, st.in_specs, mesh)
    out_dev = (acc["output_bytes"] / n_chips if st.out_specs is None
               else _local_bytes(st.args[0], st.out_specs, mesh))
    temp_dev = (acc["peak_bytes"] - acc["argument_bytes"]) / n_chips
    coll = float(sum(st.mix.calls)) if st.mix is not None else 0.0
    rl = Roofline(flops_per_device=acc["flops"] / n_chips,
                  hbm_bytes_per_device=acc["traffic_bytes"] / n_chips,
                  collective_bytes_per_device=coll)
    mf = model_flops(spec, shape, n_chips)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "n_chips": n_chips, "kind": shape.kind,
        "train_mode": spec.train_mode, "tag": tag,
        "reduced": reduced,
        "compile_s": None,
        "trace_s": trace_s,
        "memory": {
            "argument_bytes": arg_dev,
            "output_bytes": out_dev,
            "temp_bytes": temp_dev,
            "alias_bytes": None,
            "peak_per_device_bytes": arg_dev + temp_dev,
            "peak_per_device_gb": round((arg_dev + temp_dev) / 2**30, 3),
        },
        "roofline": rl.as_dict(),
        "collectives": {
            "total_bytes": coll,
            "mix_calls": 0 if st.mix is None else len(st.mix.calls),
        },
        "xla_cost_reference": None,
        "model_flops_global": mf,
        "useful_ratio": round(
            useful_ratio(spec, shape, rl.flops_per_device, n_chips), 4),
        "global": {k: acc[k] for k in ("flops", "traffic_bytes",
                                       "peak_bytes", "argument_bytes",
                                       "output_bytes", "ops")},
        "hints": {k: list(v) for k, v in hint.items()},
        "notes": NOTES,
    }
    if out_dir is None:
        out_dir = RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape.name}__{mesh_name}" + (f"__{tag}" if tag
                                                   else "")
    with open(os.path.join(out_dir, fname + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        r = result["roofline"]
        print(f"[ok] {arch:22s} {shape.name:12s} mesh={mesh_name:10s} "
              f"trace={trace_s:6.1f}s "
              f"mem/dev={result['memory']['peak_per_device_gb']:9.2f}GB "
              f"t_comp={r['t_compute_s']:.2e} t_mem={r['t_memory_s']:.2e} "
              f"t_coll={r['t_collective_s']:.2e} dom={r['dominant']}",
              flush=True)
    return result


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="tiny 2x2 (or 2x2x2) mesh for tests")
    ap.add_argument("--algo", default="mdbo")
    ap.add_argument("--mix", default="dense", choices=["dense", "ring"])
    ap.add_argument("--J", type=int, default=2)
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-embed-fsdp", action="store_true")
    ap.add_argument("--act-model", action="store_true",
                    help="not ported: raises (ROADMAP.md queue 1 item 6)")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    if args.act_model:
        raise NotImplementedError(ACT_MODEL_WAITS)

    tc = TrainerConfig(algo=args.algo, J=args.J, mix=args.mix)

    def mesh_for(mp):
        if args.debug_mesh:
            return make_debug_mesh(multi_pod=mp)
        return make_production_mesh(multi_pod=mp)

    pods = [False, True] if args.both else [args.multi_pod]
    todo = []
    if args.all:
        for (arch, shape_name), skip in pairs(include_skips=True):
            if skip is None:
                todo.append((arch, shape_name))
            else:
                print(f"[skip] {arch} {shape_name}: {skip}")
    else:
        todo.append((args.arch, args.shape))

    failures = []
    for mp in pods:
        mesh = mesh_for(mp)
        for arch, shape_name in todo:
            try:
                run_pair(arch, shape_name, mesh=mesh, tc=tc, tag=args.tag,
                         out_dir=args.out_dir,
                         variant={"embed_fsdp": not args.no_embed_fsdp,
                                  "capacity_factor": args.capacity_factor,
                                  "moe_groups": args.moe_groups})
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"[FAIL] {arch} {shape_name} multi_pod={mp}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
