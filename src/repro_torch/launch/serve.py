"""CLI serving driver for the port: paged KV over the CUDA paged-attention
kernel, or continuous batching over slot caches; every prefill runs the
CUDA flash-attention kernel (and, for the hybrid family, the RG-LRU scan).

  python -m repro_torch.launch.serve --arch smollm-360m --requests 8
  python -m repro_torch.launch.serve --arch smollm-360m --reduced \\
      --device cpu --block-size 8 --num-blocks 16
  python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --mode continuous

Weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--mode", choices=("paged", "continuous"),
                    default="paged",
                    help="paged KV (dense family) or continuous batching "
                         "over slot caches (dense and hybrid)")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode tokens per chunk")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per block (paged mode)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks in the pool "
                         "(paged mode; default: "
                         "max_batch*capacity/block_size)")
    ap.add_argument("--kv-impl", choices=("auto", "kernel"), default="auto",
                    help="paged attention: the CUDA kernel (its plain "
                         "version for --device cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get(args.arch)
    cfg = spec.reduced() if args.reduced else spec.config
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)
    eng = ServeEngine(cfg, params, capacity=args.capacity,
                      max_batch=args.max_batch, mode=args.mode,
                      decode_chunk=args.decode_chunk,
                      block_size=args.block_size, num_blocks=args.num_blocks,
                      kv_impl=args.kv_impl, device=device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(3, 10))
        eng.submit(prompt, max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    total_toks = sum(len(v) for v in results.values())
    for rid, toks in sorted(results.items()):
        print(f"req {rid}: {toks}")
    print(f"{total_toks} tokens in {dt:.2f}s "
          f"({total_toks / dt:.1f} tok/s, {args.requests} requests, "
          f"mode={args.mode}, device={device})")
    print("  " + ", ".join(f"{k}={v}" for k, v in eng.stats.items()))


if __name__ == "__main__":
    main()
