#!/usr/bin/env python3
"""A/B of the redesigned attention kernels against variants of themselves,
or of the split-KV decode against an earlier commit's paged decode.

    python3 scripts/ab_kernel_variants.py
    python3 scripts/ab_kernel_variants.py --parent DIR

Each variant is a kernel source of the checkout with one text edit, built
with ``nvcc`` like the kernel itself (``kernels.launch``) under a name of
its own in ``build/kernels/``; every variant is timed twice in this one
process, in turns (A, B, ..., B, A), so all numbers come from one card.

* Flash attention forward at gemma2-2b's geometry (``chip_smoke.py`` phase
  9: BH=16, S=T=4096, hd 256, G=2, bf16, cap 50, causal, window 0), ms per
  call by ``chip_smoke.Timer`` and max |err| against the plain version on
  flat and sharp inputs: ``as_is``, and ``tanhf`` (the softcap through
  ``cap * tanhf(x / cap)``).
* Split-KV paged decode at phase 3's C=1 bf16 cases (bf16 and int8 pool),
  device microseconds per call under ``torch.profiler`` (the L2 flushed
  and the device kept busy before each call): ``as_is``; ``fp32_cores``
  (bf16 q on the float32 branch, one head per warp, 32-token spans);
  ``no_mma`` (the tensor-core branch without its two products);
  ``no_combine`` (every split writes its own partial as the output, no
  ticket, no combine); ``exit_only`` (every block exits after reading
  its lane's lengths).  Only ``as_is``, ``tanhf`` and ``fp32_cores``
  compute the function; the others time what is left without a part.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive``) it runs only this: the paged-attention wrapper of DIR
(its module and its ``.cu``) against this checkout's, in turns (parent,
change, change, parent).  At phase 3's C=1 bf16 cases on both pools: ms
per call by ``chip_smoke.Timer``, SDPA's ms by the same timer in the same
turn, and host microseconds per ``paged_prefill_fwd`` call (200 calls
enqueued back to back, the device never holding the host back).  Then the
phase-5 serving workload (yi-6b, bf16 pool) with either wrapper behind
``ops``, in turns P, N, N, P, P, N, N, P after one warm run each: median
wall ms of the decode iterations per run, and the launches of the side's
kernel.

Prints one JSON object per measurement.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: (text, replacement, times found) per variant, applied to the source
FLASH_VARIANTS = {
    "as_is": [],
    "tanhf": [("        if (cap != 0.f) x = cap - __fdividef(two_cap, "
               "exp2f(x * k2) + 1.f);\n",
               "        if (cap != 0.f) x = cap * tanhf(x / cap);\n", 1)],
}
SPLIT_VARIANTS = {
    "as_is": [],
    "fp32_cores": [
        ("  } else if (q_dtype == 1 && (kv_dtype == 1 || int8_pool)) {\n",
         "  } else if (q_dtype == 1 && kv_dtype == 1) {\n"
         "    e = SPLIT_DISPATCH(__nv_bfloat16, __nv_bfloat16);\n"
         "  } else if (q_dtype == 1 && int8_pool) {\n"
         "    e = SPLIT_DISPATCH(__nv_bfloat16, int8_t);\n"
         "  } else if (false) {\n", 1),
        ("  return q_dtype == 1 ? split::kTcSpan : split::kSpan;",
         "  return split::kSpan;", 1),
        ("  return q_dtype == 1 ? split::kTcRows : split::kHeads;",
         "  return split::kHeads;", 1)],
    "no_mma": [
        ("  for (int ks = 0; ks < HD / 16; ++ks) {\n    uint32_t qf[4], kb[4];",
         "  for (int ks = 0; ks < 0; ++ks) {\n    uint32_t qf[4], kb[4];", 1),
        ("  for (int dp = 0; dp < HD / 16; ++dp) {\n    uint32_t vb[4];",
         "  for (int dp = 0; dp < 0; ++dp) {\n    uint32_t vb[4];", 1)],
    "no_combine": [
        ("    if (n_live == 1) {   // the lane's only split: the output as "
         "it stands\n      dst[i]",
         "    if (true) {\n      dst[i]", 1),
        ("  if (n_live == 1) return;\n  if (!last_split(",
         "  return;\n  if (!last_split(", 1)],
    "exit_only": [
        ("  if (split >= n_live) return;                    // past the "
         "lane's end\n", "  return;\n", 2)],
}


def variant_source(src: Path, edits, name: str) -> Path:
    text = src.read_text()
    for old, new, n in edits:
        found = text.count(old)
        if found != n:
            raise RuntimeError(f"{name}: {old[:60]!r} found {found} times, "
                               f"want {n}")
        text = text.replace(old, new)
    out = ROOT / "build" / "kernels" / "variants" / f"{src.stem}_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def device_us(fn, flush: torch.Tensor, name_part: str, reps: int = 20):
    """Mean device time of the kernels whose names hold ``name_part``, one
    call at a time after an L2 flush and a device-side sleep."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(200_000)
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if name_part in e.key) / reps


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn``: ``n`` calls enqueued back to
    back (fewer launches than the device's queue holds), the sync after
    them untimed."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def parent_ab(parent: Path, card: str) -> None:
    """The paged-attention wrapper and kernel of the checkout ``parent``
    against this one's (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    from repro_torch.models.model import init_params
    from repro_torch.runtime import make_engine
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_serve import _drive
    path = (parent / "src" / "repro_torch" / "kernels" / "paged_attention"
            / "kernel.py").resolve()
    spec = importlib.util.spec_from_file_location("parent_paged_kernel",
                                                  path)
    PK = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(PK)
    sides = {"parent": PK, "change": K}
    launch.build([PK.SOURCE, K.SOURCE])
    timer = CS.Timer()

    cases = {pool: CS.attention_case(1, torch.bfloat16, pool == "int8")
             for pool in ("bf16", "int8")}
    for side in ("parent", "change", "change", "parent"):
        mod = sides[side]
        for pool, c in cases.items():
            def run(c=c, mod=mod):
                return mod.paged_prefill_fwd(
                    c["q"], c["kv"], c["padded"], c["counts"], c["lens"],
                    c["q_start"], kv_scales=c["scales"])
            sc = c["scales"]
            plain = R.paged_prefill_ref(
                c["q"], c["kv"][:, 0], c["kv"][:, 1],
                mask_block_table(c["padded"], c["counts"]), c["lens"],
                c["q_start"], **({} if sc is None else
                                 dict(k_scales=sc[:, 0], v_scales=sc[:, 1])))
            out = run()
            torch.cuda.synchronize()
            print(json.dumps({
                "card": card, "part": "kernel", "side": side, "pool": pool,
                "C": 1, "q": "bfloat16",
                "route": mod.route(torch.bfloat16, 1),
                "ms": timer.ms(run),
                "sdpa_ms": timer.ms(CS.sdpa_call(c, 1)),
                "host_us_per_call": host_us(run),
                "max_abs_err": (out.float() - plain.float()).abs().max()
                .item()}), flush=True)
    del cases

    cfg = get_config("yi-6b")
    model = init_params(cfg, seed=0)
    ecfg, requests = CS.serve_workload(cfg)
    try:
        for side in ("parent", "change"):        # warm either side once
            ops.K = sides[side]
            _drive(make_engine(cfg, model, ecfg), requests, profiled=False)
        for side in ("parent", "change", "change", "parent") * 2:
            mod = ops.K = sides[side]
            counter = mod.launches
            counter.reset()
            rows = _drive(make_engine(cfg, model, ecfg), requests,
                          profiled=False)
            decode = [w for kind, w in rows if kind == "decode"]
            print(json.dumps({
                "card": card, "part": "serve_decode_wall", "side": side,
                "pool": "bf16", "decode_iterations": len(decode),
                "decode_wall_ms_median": statistics.median(decode),
                "decode_wall_ms_mean": statistics.fmean(decode),
                "paged_launches": counter.n}), flush=True)
    finally:
        ops.K = K


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit: A/B its paged "
                    "decode against this one instead of the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.parent is not None:
        parent_ab(args.parent, card)
        return 0
    flash_src, split_src = FK.SOURCE, K.SOURCE
    flash = {n: variant_source(flash_src, e, n)
             for n, e in FLASH_VARIANTS.items()}
    split = {n: variant_source(split_src, e, n)
             for n, e in SPLIT_VARIANTS.items()}
    launch.build([*flash.values(), *split.values()])
    timer = CS.Timer()

    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for scale_name, qk in (("flat", 0.3), ("sharp", CS.FLASH_SHARP)):
        q = (torch.randn(16, 4096, 256, generator=g, device="cuda")
             * qk).bfloat16()
        k = (torch.randn(8, 4096, 256, generator=g, device="cuda")
             * qk).bfloat16()
        v = torch.randn(8, 4096, 256, generator=g, device="cuda").bfloat16()
        ref = FR.flash_attention_ref(q, k.repeat_interleave(2, 0),
                                     v.repeat_interleave(2, 0), cap=50.0)
        inputs[scale_name] = (q, k, v, ref)
    order = list(flash) + list(flash)[::-1]
    for name in order:
        FK.SOURCE = flash[name]
        FK._library.cache_clear()
        errs = {}
        for scale_name, (q, k, v, ref) in inputs.items():
            out = FK.flash_attention_fwd(q, k, v, cap=50.0, groups=2)
            torch.cuda.synchronize()
            errs[scale_name] = (out.float() - ref.float()).abs().max().item()
        q, k, v, _ = inputs["flat"]
        ms = timer.ms(lambda: FK.flash_attention_fwd(q, k, v, cap=50.0,
                                                     groups=2))
        print(json.dumps({"card": card, "kernel": "flash_tc", "variant": name,
                          "ms": ms, "max_abs_err": errs}), flush=True)
    FK.SOURCE = flash_src
    FK._library.cache_clear()
    del inputs

    cases = {pool: CS.attention_case(1, torch.bfloat16, pool == "int8")
             for pool in ("bf16", "int8")}
    plain = {}
    for pool, c in cases.items():
        sc = c["scales"]
        scales = {} if sc is None else dict(k_scales=sc[:, 0],
                                            v_scales=sc[:, 1])
        plain[pool] = R.paged_prefill_ref(
            c["q"], c["kv"][:, 0], c["kv"][:, 1],
            mask_block_table(c["padded"], c["counts"]), c["lens"],
            c["q_start"], **scales)
    order = list(split) + list(split)[::-1]
    for name in order:
        K.SOURCE = split[name]
        K._library.cache_clear()
        K._split_plan.cache_clear()
        for pool, c in cases.items():
            def run(c=c):
                return K.paged_prefill_fwd(
                    c["q"], c["kv"], c["padded"], c["counts"], c["lens"],
                    c["q_start"], kv_scales=c["scales"])
            out = run()
            torch.cuda.synchronize()
            err = (out.float() - plain[pool].float()).abs().max().item()
            us = device_us(run, timer.flush, "paged_decode_split")
            print(json.dumps({"card": card, "kernel": "split_kv_decode",
                              "variant": name, "pool": pool,
                              "device_us": us, "max_abs_err": err}),
                  flush=True)
    K.SOURCE = split_src
    K._library.cache_clear()
    K._split_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
