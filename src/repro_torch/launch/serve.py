"""CLI serving driver for the port: continuous batching over slot caches
(the default, as in the JAX package's CLI), paged KV over the CUDA
paged-attention kernel or the gather/scatter reference, and the legacy
cohort drain. Every attention prefill runs the CUDA flash-attention kernel,
the hybrid family's recurrent prefill the RG-LRU scan, and every rwkv6
prefill and decode step the WKV scan.

  python -m repro_torch.launch.serve --arch smollm-360m --mode paged \\
      --requests 8
  python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \\
      --device cpu --mode cohort
  python -m repro_torch.launch.serve --arch smollm-360m --reduced \\
      --device cpu --mode paged --block-size 8 --num-blocks 16 \\
      --kv-impl reference --metrics out/
  python -m repro_torch.launch.serve --arch recurrentgemma-2b
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --reduced \\
      --device cpu

Weights are random, drawn from ``--seed``. ``--metrics DIR`` writes
``metrics.jsonl`` and ``metrics.prom``, ``--trace-dir DIR`` a
Perfetto-loadable ``trace.json`` (the JAX CLI's files).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.obs import cli_recorder
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import KV_IMPLS


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--mode", choices=("continuous", "cohort", "paged"),
                    default="continuous")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode tokens per chunk")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per block (paged mode)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks in the pool "
                         "(paged mode; default: "
                         "max_batch*capacity/block_size)")
    ap.add_argument("--kv-impl", choices=KV_IMPLS, default="auto",
                    help="paged attention: the CUDA kernel (auto, kernel "
                         "and pallas; its plain version for --device cpu), "
                         "or the gather/scatter reference")
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="write metrics.jsonl + metrics.prom into DIR")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write a Perfetto-loadable trace.json into DIR")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get(args.arch)
    cfg = spec.reduced() if args.reduced else spec.config
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)
    recorder, finalize_obs = cli_recorder(args.metrics, args.trace_dir)
    eng = ServeEngine(cfg, params, capacity=args.capacity,
                      max_batch=args.max_batch, mode=args.mode,
                      decode_chunk=args.decode_chunk,
                      block_size=args.block_size, num_blocks=args.num_blocks,
                      kv_impl=args.kv_impl, recorder=recorder, device=device)
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
    for p in finalize_obs():
        print("obs:", p)


if __name__ == "__main__":
    main()
