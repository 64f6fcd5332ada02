#!/usr/bin/env python3
"""Run one cell of the benchmark once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit) and the same checks as the last lines of standard error.  Exits
non-zero, printing no result, without the devices, or if JAX, jaxlib,
flax or the JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's and the harness's build caches stay inside the checkout;
# transformers-style libraries must not load flax
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from harness import cell as C

    spec = C.Cell.find(args.workload, ROOT)
    chips = int(spec.entry.get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    out = C.run_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace), T_START, ROOT, cell=spec)
    out.pop("_run")
    found = C.loaded_jax_modules()
    if found:
        print(f"bench: JAX modules loaded in the measuring process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for line in C.check_lines(out):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
