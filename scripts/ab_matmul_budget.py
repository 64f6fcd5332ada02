#!/usr/bin/env python3
"""The cluster matmul's unbudgeted general branch against an earlier
commit's, and the general kernels' registers and spills.

    python3 scripts/ab_matmul_budget.py --parent DIR

``DIR`` is a checkout of an earlier commit (``git archive`` of it unpacked
into a git-ignored directory, e.g. ``build/parent``).  For each general
shape of ``chip_smoke.py`` phase 7 (float32 and bfloat16, A aligned or
one element past a 16-byte boundary) the parent's wrapper and kernel and
this checkout's (``kernel.matmul(a, b)``, no budget) are timed in turns
(parent, change, change, parent, parent, change; ``chip_smoke.Timer``:
the L2 flushed, median of 20) and their outputs compared bit for bit.
Then this checkout's two cluster-matmul sources (``cluster_matmul.cu`` and
``cluster_matmul_budgeted.cu``) are compiled once more with ``-Xptxas
-v`` and each general kernel's registers and spill bytes are printed.
One JSON object a line, each with the card's name and power limit.  It
needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: phase 7's general-branch cases: (m, k, n), type, bytes A lies past a
#: 16-byte boundary
SHAPES = [((127, 127, 127), "float32", 0), ((256, 256, 256), "float32", 4),
          ((768, 768, 768), "float32", 4), ((1000, 1032, 776), "float32", 4),
          ((4096, 4096, 4096), "float32", 4),
          ((1024, 4096, 11008), "float32", 4),
          ((127, 127, 127), "bfloat16", 0), ((100, 36, 20), "bfloat16", 0),
          ((768, 768, 768), "bfloat16", 2),
          ((4096, 4096, 4096), "bfloat16", 2),
          ((1024, 4095, 11007), "bfloat16", 0),
          ((128, 8192, 128), "bfloat16", 2)]
TURNS = ("parent", "change", "change", "parent", "parent", "change")


def _parent_module(parent: Path):
    path = (parent / "src" / "repro_torch" / "kernels" / "cluster_matmul"
            / "kernel.py").resolve()
    spec = importlib.util.spec_from_file_location("parent_matmul", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(source: Path, nvcc: str, flags) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    general kernel ``ptxas -v`` reports for ``source``."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [nvcc, *flags, "-Xptxas", "-v", "-o", str(Path(tmp) / "v.so"),
             str(source)], capture_output=True, text=True, check=True)
    lines = (out.stdout + out.stderr).splitlines()
    rows = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*general_kernel\S*)'",
                      line)
        if not m:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", lines[i + 2] if i + 2 < len(lines)
                          else "")
        regs = re.search(r"Used (\d+) registers",
                         lines[i + 3] if i + 3 < len(lines) else "")
        rows.append((m.group(1), int(regs.group(1)) if regs else None,
                     *(map(int, spill.groups()) if spill else (None, None))))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_matmul_budget: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.cluster_matmul import kernel as CK
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    PK = _parent_module(args.parent)
    launch.build([CK.SOURCE, CK.BUDGETED_SOURCE, PK.SOURCE])
    timer = CS.Timer()
    sides = {"parent": PK, "change": CK}
    for (m, k, n), dt, off in SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        b = (torch.randn(k, n, generator=g, device="cuda")
             / k ** 0.5).to(dtype)
        if off:
            skip = off // a.element_size()
            a = torch.empty(m * k + skip, dtype=dtype,
                            device="cuda")[skip:].view(m, k).copy_(a)
        assert CK.route(dtype, m, k, n, aligned=not off) == CK.GENERAL
        ms = {side: [] for side in sides}
        for side in TURNS:
            mod = sides[side]
            ms[side].append(timer.ms(lambda: mod.matmul(a, b)))
        print(json.dumps({
            "card": card, "m": m, "k": k, "n": n, "dtype": dt,
            "a_offset_bytes": off, "parent_ms": ms["parent"],
            "change_ms": ms["change"],
            "bit_equal": bool(torch.equal(PK.matmul(a, b),
                                          CK.matmul(a, b)))}), flush=True)
    nvcc = launch._nvcc()
    for source in (CK.SOURCE, CK.BUDGETED_SOURCE):
        for name, regs, st, ld in registers(source, nvcc, launch.NVCC_FLAGS):
            print(json.dumps({"card": card, "source": source.name,
                              "kernel": name, "registers": regs,
                              "spill_store_bytes": st,
                              "spill_load_bytes": ld}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
