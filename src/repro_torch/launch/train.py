"""CLI trainer on the Engine: decentralized bilevel (MDBO/VRDBO) or
single-level GT-SGD over K nodes on one device.

The run loop is :meth:`repro_torch.core.engine.Engine.run`, with
``--dispatch fused`` by default: on the card every ``--eval-every``
interval is one CUDA graph replay, its LM batches drawn on the card
(``data.make_device_lm_sampler``) before the replay. Checkpoints are written
at eval boundaries through ``repro_torch.checkpoint.save``, in the JAX
package's format. Weights are random, drawn from ``--seed``.

  python -m repro_torch.launch.train --arch smollm-360m --steps 10
  python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --device cpu --steps 4 --eval-every 2
  python -m repro_torch.launch.train --arch rwkv6-1.6b --reduced \\
      --device cpu --algo vrdbo
  python -m repro_torch.launch.train --arch whisper-tiny --steps 10
  python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --reduced

Every registered architecture trains; the vlm and audio families' batches
carry the modality stubs (``data.lm_batch_extras``). phi3.5-moe-42b-a6.6b,
grok-1-314b and chameleon-34b are ``train_mode="fsdp_gt"`` in the JAX
package, sharded over a mesh. The port places them
(``repro_torch.sharding.rules``, counted by ``repro_torch.launch.dryrun``)
but does not yet execute it (DTensor/FSDP over several cards,
``ROADMAP.md`` queue 1, item 8, after item 6): K copies of their full
width do not fit one card, so on one card they train with ``--reduced``;
without it they run out of card memory.

``--metrics DIR`` writes ``metrics.jsonl`` and ``metrics.prom`` into DIR
and ``--trace-dir DIR`` a Perfetto-loadable ``trace.json``, as the JAX CLI
does (``repro_torch.obs.cli_recorder``). ``--torch-profile`` brackets the
run in ``torch.profiler`` (CUDA kernels on a card) and writes
``torch_profile.json`` into ``--trace-dir``, the counterpart of the JAX
CLI's ``--jax-profile``; it refuses to run without ``--trace-dir``.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from repro_torch.checkpoint import save
from repro_torch.configs import get
from repro_torch.core.common import HParams
from repro_torch.data import make_device_lm_sampler, make_node_batch
from repro_torch.device import resolve_device
from repro_torch.models import param_count
from repro_torch.obs import cli_recorder, torch_profile
from repro_torch.train import TrainerConfig, make_trainer_engine


def main(argv: list[str] | None = None, on_eval=None):
    """Parse ``argv`` (the command line when None), train, print one row
    per eval; returns ``(RunResult, Engine)``. ``on_eval(t, state)``, for
    callers in the same process, runs at every eval after the CLI's own
    hook (under fused dispatch on the card ``state`` is the graph's
    buffers, valid until the next chunk)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model variant")
    ap.add_argument("--algo", default="mdbo",
                    choices=["mdbo", "vrdbo", "gt_sgd"])
    ap.add_argument("--mix", default="ring", choices=["ring", "dense"])
    ap.add_argument("--dispatch", default="fused",
                    choices=["fused", "per_step"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-node batch")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=5,
                    help="steps per fused chunk / eval + checkpoint boundary")
    ap.add_argument("--J", type=int, default=2)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--beta1", type=float, default=0.05)
    ap.add_argument("--beta2", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="write metrics.jsonl + metrics.prom into DIR")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write a Perfetto-loadable trace.json into DIR")
    ap.add_argument("--torch-profile", action="store_true",
                    help="additionally capture a torch.profiler device "
                         "trace into --trace-dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.torch_profile and not args.trace_dir:
        raise SystemExit("--torch-profile needs --trace-dir")

    device = resolve_device(args.device)
    spec = get(args.arch)
    cfg = spec.reduced() if args.reduced else spec.config
    tc = TrainerConfig(algo=args.algo, J=args.J, mix=args.mix,
                       hp=HParams(eta=args.eta, beta1=args.beta1,
                                  beta2=args.beta2))
    K = args.nodes
    recorder, finalize_obs = cli_recorder(args.metrics, args.trace_dir)
    _, eng = make_trainer_engine(cfg, tc, K, dispatch=args.dispatch,
                                 recorder=recorder, device=device)
    sampler = make_device_lm_sampler(cfg, tc, K, args.batch, args.seq)
    eval_batch = make_node_batch(
        cfg, torch.Generator(device=device).manual_seed(args.seed + 17),
        args.batch, args.seq)

    def at_eval(t, state):
        if t == 0:
            print(f"arch={cfg.name} algo={args.algo} K={K} "
                  f"dispatch={args.dispatch} "
                  f"params/node={param_count(state.y) // K:,}", flush=True)
        elif args.ckpt_dir:
            save(args.ckpt_dir, t, {"x": state.x, "y": state.y})
        if on_eval is not None:
            on_eval(t, state)

    with (torch_profile(args.trace_dir) if args.torch_profile
          else contextlib.nullcontext()):
        res = eng.run(sampler, eval_batch, steps=args.steps, seed=args.seed,
                      eval_every=args.eval_every, on_eval=at_eval)
    for row in res.as_rows():
        print(f"step {row['step']:4d} val-loss={row['upper_loss']:.4f} "
              f"train-obj={row['lower_loss']:.4f} "
              f"consensus_x={row['consensus_x']:.2e}", flush=True)
    print(f"wall={res.wall_time_s:.1f}s "
          f"({args.steps / max(res.wall_time_s, 1e-9):.2f} steps/s)")
    for p in finalize_obs():
        print("obs:", p)
    if args.ckpt_dir:
        print("checkpoints in", args.ckpt_dir)
    return res, eng


if __name__ == "__main__":
    main()
