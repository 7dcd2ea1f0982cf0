"""Time the verify-window kernel ``paged_attention_multi`` of two checkouts
on one card, in one call, in the order parent, change, change, parent
(``--rounds`` times).

Each run is a fresh process in its checkout: it builds that checkout's
``csrc/paged_attention.cu`` and runs its ``chip_smoke.check_multi_kernel``
(the smoke run's phase 7a: smollm-360m's heads, 15 over 5 of 64, at the
speculative window Q 4 in bf16, checked against the plain version and
timed with CUDA events, L2 cold). Prints each run's time and the card's
name and power limit. Needs a CUDA card.

  python3 tools/ab_window_kernel.py PARENT_ROOT [CHANGE_ROOT] [--rounds N]

``CHANGE_ROOT`` defaults to this checkout; ``PARENT_ROOT`` is a checkout
of the parent commit, e.g. unpacked with ``git archive`` into ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = """
import json, sys, torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.configs import get
from repro_torch.kernels import build
build.build(["paged_attention"])
row = chip_smoke.check_multi_kernel(torch, get(chip_smoke.ARCH).config)
print("ROW " + json.dumps(row))
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                         capture_output=True, text=True, check=True).stdout
    for line in out.splitlines():
        if line.startswith("[7a]"):
            print(f"  {line}")
    return json.loads(out.split("ROW ", 1)[1].splitlines()[0])


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    parent, change = map(os.path.abspath, (args.parent, args.change))
    times = []
    order = [("parent", parent), ("change", change), ("change", change),
             ("parent", parent)] * args.rounds
    for label, root in order:
        print(f"[ab] {label}: {root}", flush=True)
        row = run(root)
        times.append((label, row["ms"]))
        print(f"[ab] {label}: paged_attention_multi {row['ms']:.5f} ms "
              f"(bound {row['bound_ms']:.5f} ms, max_abs_err "
              f"{row['max_abs_err']:.3e})", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for label in ("parent", "change"):
        ms = sorted(t for lab, t in times if lab == label)
        print(f"[ab] {label}: median {ms[len(ms) // 2]:.5f} ms over "
              f"{len(ms)} runs, min {ms[0]:.5f}, max {ms[-1]:.5f}")
    print("[ab] " + json.dumps({"runs": times}) + f" {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
