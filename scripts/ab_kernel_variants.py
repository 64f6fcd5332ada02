#!/usr/bin/env python3
"""A/B of the redesigned kernels against variants of themselves, or
against an earlier commit's kernels.

    python3 scripts/ab_kernel_variants.py \
        [--parts flash,split,prefill_f32_variants]
    python3 scripts/ab_kernel_variants.py --parent DIR \
        [--parts prefill_f32,decode,serve,matmul_f32_general,flash_f32]

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
* The FP32-core paged prefill (``prefill_f32_variants``) at phase 3's
  float32-q cases on the float32 pool, C=5 and C=128, ms by
  ``chip_smoke.Timer`` and max |err| against the plain version:
  ``as_is``, ``threads_128`` / ``threads_512`` (8 or 2 rows a thread),
  ``lanes_interleaved`` (blocks started lanes first, each lane's last
  row block first), and, timing only, ``s_bcast`` (q and K reads from
  one address), ``no_s``, ``no_pv``, ``no_s_pv`` (without the products),
  ``no_stage`` (no K/V copies after tile 0), ``no_softmax`` (no shuffles
  or exp2).

* The general float32 cluster matmul (``matmul_f32_general``): 127^3,
  and 256^3, 768^3, 1000 x 1032 x 776, 4096^3 and yi-6b's MLP product
  with A 4 bytes past a 16-byte boundary (the route's general branch),
  ms by ``chip_smoke.Timer`` and max |err| against the plain version, in
  turns: the parent's kernel (with ``--parent``), then the plan variants
  ``as_is``, ``min_split_1`` / ``min_split_2`` (splits of at least 1 or
  2 K tiles, not 4), ``no_split`` (64 x 64 tiles, K not split) and ``tile_128``
  (128 x 128 tiles, K not split), and, timing only, ``exit_only`` (every
  block exits at once), ``no_fma`` (no FMAs) and ``no_copies`` (no copies
  past the first stages; at the three small shapes only), then the same
  reversed; then, at the
  five shapes with aligned A, ``general_aligned`` (the route's pick:
  the general kernel as planned) and, with ``--parent``,
  ``parent_aligned`` (the parent's route and kernel: in a checkout that
  still has the float32 ring branch, the ring) in turns, and
  ``torch.matmul`` at every shape.
* The FP32-core flash forward (``flash_f32``): phase 10's two float32
  calls (BH=16, S=T=512, hd 256, G=2, cap 50, window 0 / 128),
  ``tests/test_kernels.py``'s three shapes x five masks in float32 and at
  hd 32 in bfloat16, ms by ``chip_smoke.Timer`` and max |err| against
  the plain version, in turns: the parent's kernel (with ``--parent``),
  then ``as_is``, ``no_split`` (one block a query tile), ``one_slot``
  (one K and one V slot at every hd) and ``tanhf`` (the cap through
  ``cap * tanhf(x / cap)``),
  and, timing only, ``no_s``, ``no_pv`` (without a product) and
  ``no_copies`` (no K/V copies past the first slots), then the same
  reversed; then the library call (SDPA or the compiled
  ``flex_attention``, ``chip_smoke.flash_library``) once a case.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive``) it runs this: the paged-attention wrapper of DIR
(its module and its ``.cu``) against this checkout's, in turns (parent,
change, change, parent).  ``prefill_f32``: phase 3's float32-q cases
at C=5 and C=128, flat and sharp, on both pools (the FP32-core kernel),
ms per call by ``chip_smoke.Timer`` and max |err| against the plain
version.  ``decode``: phase 3's C=1 bf16 cases on both pools: ms per call
by the same timer, SDPA's ms by the same timer in the same turn, and
host microseconds per ``paged_prefill_fwd`` call (200 calls enqueued back
to back, the device never holding the host back).  ``serve``: the
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

#: source variants of the general float32 cluster matmul; all but as_is
#: time what is left without a part (wrong values)
MATMUL_GENERAL_VARIANTS = {
    "as_is": [],
    "exit_only": [
        ("  const int n_kt = max(0, min(k_tiles, kt0 + per) - kt0);\n",
         "  const int n_kt = max(0, min(k_tiles, kt0 + per) - kt0);\n"
         "  if (n_kt >= 0) return;\n", 1)],
    "no_fma": [("      fma_outer(acc, a[kk & 1], b[kk & 1]);\n", "", 1)],
    "no_copies": [("    if (nt < n_kt) load_tile(kt0 + nt, nt % kStages);\n",
                   "", 1)],
}
#: source variants of the FP32-core flash kernel
FLASH_F32_VARIANTS = {
    "as_is": [],
    "one_slot": [("  static constexpr int kSlots = HD * int(sizeof(T)) >= "
                  "1024 ? 1 : 2;", "  static constexpr int kSlots = 1;", 1)],
    "tanhf": [("        if (cap != 0.f) x = cap - __fdividef(two_cap, 1.f + "
               "exp2f(k2 * x));\n",
               "        if (cap != 0.f) x = cap * tanhf(x / cap);\n", 1)],
    # timing only (wrong values): no S products, no P.V, no K/V copies
    # past the first slots
    "no_s": [("    for (int d = 0; d < HD; d += 4) {\n      float "
              "qv[kRT][4], kv4[4][4];", "    for (int d = 0; d < 0; d += 4) "
              "{\n      float qv[kRT][4], kv4[4][4];", 1)],
    "no_pv": [("    for (int t4 = 0; t4 < kTok; t4 += 4) {\n      float "
               "pv[kRT][4];", "    for (int t4 = 0; t4 < 0; t4 += 4) {\n      "
               "float pv[kRT][4];", 1)],
    "no_copies": [("    if (it > 0) stage_v(it - 1 + kSlots);", "", 1),
                  ("    stage_k(it + kSlots);", "", 1)],
}
#: variants whose values are wrong by design: they time what is left
TIMING_ONLY = {"s_bcast", "no_s",
               "no_pv", "no_s_pv", "no_stage", "no_softmax", "exit_only",
               "no_fma", "no_copies", "no_s", "no_pv"}
_NO_S = [("    for (int d = 0; d < HD; d += 4) {\n      float qv[kRT][4]",
          "    for (int d = 0; d < 0; d += 4) {\n      float qv[kRT][4]", 1)]
_NO_PV = [("    for (int t4 = 0; t4 < kTok; t4 += 4) {\n      float pv[kRT]",
           "    for (int t4 = 0; t4 < 0; t4 += 4) {\n      float pv[kRT]", 1)]
_THREADS = "constexpr int kThreads = 256;        // a kTY x 16 thread grid"
PREFILL_VARIANTS = {
    "as_is": [],
    "threads_128": [(_THREADS, "constexpr int kThreads = 128;", 1)],
    "threads_512": [(_THREADS, "constexpr int kThreads = 512;", 1)],
    "lanes_interleaved": [(
        "  const int b = blockIdx.z, kh = blockIdx.y;\n"
        "  const int rows = C * G;\n"
        "  const int row0 = blockIdx.x * kRows;\n  // thread (ty, tx)",
        "  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *"
        " blockIdx.z);\n"
        "  const int b = lin % gridDim.z, kh = (lin / gridDim.z) % gridDim.y;\n"
        "  const int rows = C * G;\n"
        "  const int row0 = (gridDim.x - 1 - lin / (gridDim.z * gridDim.y)) *"
        " kRows;\n  // thread (ty, tx)", 1)],
    # timing only (wrong values): q and K reads from one address per load;
    # no S products; no P.V; no copies after tile 0; no softmax shuffles
    # or exp2
    "s_bcast": [
        ("load_vec(qv[i], qs + (ty + kTY * i) * kLd + d);",
         "load_vec(qv[i], qs + d + 4 * i);", 1),
        ("load_vec(kv4[j], ks + (tx + 16 * j) * kLd + d);",
         "load_vec(kv4[j], ks + d + 4 * j);", 1)],
    "no_s": _NO_S,
    "no_pv": _NO_PV,
    "no_s_pv": _NO_S + _NO_PV,
    "no_stage": [("    if (it + 1 < n_tiles) {   // so its stage takes tile "
                  "it+1\n", "    if (false) {\n", 1)],
    "no_softmax": [
        ("      for (int o = 8; o > 0; o >>= 1)\n"
         "        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));\n", "", 1),
        ("      for (int o = 8; o > 0; o >>= 1) sum += "
         "__shfl_xor_sync(kFull, sum, o);\n", "", 1),
        ("exp2f(s[i][j] - m_new)", "(s[i][j] - m_new)", 1)],
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


def parent_ab(parent: Path, card: str, parts) -> None:
    """The paged-attention wrapper and kernel of the checkout ``parent``
    against this one's (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    path = (parent / "src" / "repro_torch" / "kernels" / "paged_attention"
            / "kernel.py").resolve()
    spec = importlib.util.spec_from_file_location("parent_paged_kernel",
                                                  path)
    PK = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(PK)
    sides = {"parent": PK, "change": K}
    launch.build([PK.SOURCE, K.SOURCE])
    timer = CS.Timer()

    if "prefill_f32" in parts:
        cases = {(C, pool, sharp): CS.attention_case(
                     C, torch.float32, pool == "int8", sharp=sharp)
                 for C in (5, 128) for pool in ("f32", "int8")
                 for sharp in (False, True)}
        plain = {}
        for key, c in cases.items():
            sc = c["scales"]
            plain[key] = R.paged_prefill_ref(
                c["q"], c["kv"][:, 0], c["kv"][:, 1],
                mask_block_table(c["padded"], c["counts"]), c["lens"],
                c["q_start"], **({} if sc is None else
                                 dict(k_scales=sc[:, 0], v_scales=sc[:, 1])))
        for side in ("parent", "change", "change", "parent"):
            mod = sides[side]
            for (C, pool, sharp), c in cases.items():
                def run(c=c, mod=mod):
                    return mod.paged_prefill_fwd(
                        c["q"], c["kv"], c["padded"], c["counts"],
                        c["lens"], c["q_start"], kv_scales=c["scales"])
                out = run()
                torch.cuda.synchronize()
                print(json.dumps({
                    "card": card, "part": "prefill_f32", "side": side,
                    "pool": pool, "C": C, "sharp": sharp, "q": "float32",
                    "route": mod.route(torch.float32, C),
                    "ms": timer.ms(run),
                    "bound_ms": c["flops"] / CS.PEAK_OPS_PER_S[
                        torch.float32] * 1e3,
                    "max_abs_err": (out - plain[C, pool, sharp]).abs().max()
                    .item()}), flush=True)
        del cases, plain
    if "decode" in parts:
        decode_ab(sides, card, timer)
    if "serve" in parts:
        serve_ab(sides, K, card)


def decode_ab(sides: dict, card: str, timer) -> None:
    """Phase 3's C=1 bf16 cases through either side's paged-attention
    wrapper (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
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


def serve_ab(sides: dict, K, card: str) -> None:
    """Decode wall of the phase-5 serving workload with either side's
    paged-attention wrapper behind ``ops`` (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models.model import init_params
    from repro_torch.runtime import make_engine
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_serve import _drive
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


def prefill_f32_variants_ab(card: str) -> None:
    """The FP32-core paged prefill against variants of its source at
    phase 3's float32-q cases (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    src = K.SOURCE
    paged = {n: variant_source(src, e, "f32_" + n)
             for n, e in PREFILL_VARIANTS.items()}
    launch.build(paged.values())
    timer = CS.Timer()
    cases = {C: CS.attention_case(C, torch.float32) for C in (5, 128)}
    plain = {C: R.paged_prefill_ref(
        c["q"], c["kv"][:, 0], c["kv"][:, 1],
        mask_block_table(c["padded"], c["counts"]), c["lens"],
        c["q_start"]) for C, c in cases.items()}
    for name in list(paged) + list(paged)[::-1]:
        K.SOURCE = paged[name]
        K._library.cache_clear()
        for C, c in cases.items():
            def run(c=c):
                return K.paged_prefill_fwd(c["q"], c["kv"], c["padded"],
                                           c["counts"], c["lens"],
                                           c["q_start"])
            out = run()
            torch.cuda.synchronize()
            print(json.dumps({
                "card": card, "kernel": "paged_prefill_fp32_cores",
                "variant": name, "timing_only": name in TIMING_ONLY,
                "pool": "f32", "C": C, "ms": timer.ms(run),
                "max_abs_err": (out - plain[C]).abs().max().item()}),
                flush=True)
    K.SOURCE = src
    K._library.cache_clear()


def _parent_module(parent: Path, package: str, name: str):
    """The wrapper module ``kernels/<package>/kernel.py`` of the checkout
    ``parent``, loaded under ``name`` (its source is the parent's own)."""
    path = (parent / "src" / "repro_torch" / "kernels" / package
            / "kernel.py").resolve()
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def matmul_f32_general_ab(card: str, parent) -> None:
    """The general float32 branch against the parent's and its plan
    variants (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.cluster_matmul import ref as CR
    PK = _parent_module(parent, "cluster_matmul", "parent_matmul") \
        if parent else None
    src = CK.SOURCE
    sources = {n: variant_source(src, e, "general_" + n)
               for n, e in MATMUL_GENERAL_VARIANTS.items()}
    launch.build(list(sources.values()) + ([PK.SOURCE] if PK else []))
    timer = CS.Timer()
    plan, min_tiles = CK.general_plan, CK.MIN_SPLIT_TILES
    # (source, plan, fewest K tiles a split)
    variants = {
        "as_is": ("as_is", plan, min_tiles),
        "min_split_1": ("as_is", plan, 1), "min_split_2": ("as_is", plan, 2),
        "no_split": ("as_is", lambda m, k, n: (64, 1)
                     if plan(m, k, n)[0] == 64 else (128, 1), 1),
        "tile_128": ("as_is", lambda m, k, n: (128, 1), 1),
        **{n: (n, plan, 1) for n in MATMUL_GENERAL_VARIANTS if n != "as_is"}}
    order = (["parent"] if PK else []) + list(variants) \
        + list(variants)[::-1] + (["parent"] if PK else [])
    shapes = [((127, 127, 127), False), ((256, 256, 256), True),
              ((768, 768, 768), True), ((1000, 1032, 776), True),
              ((4096, 4096, 4096), True), ((1024, 4096, 11008), True)]
    try:
        for (m, k, n), offset in shapes:
            g = torch.Generator(device="cuda").manual_seed(0)
            a = torch.randn(m, k, generator=g, device="cuda")
            b = torch.randn(k, n, generator=g, device="cuda") / k ** 0.5
            x = a
            if offset:
                x = torch.empty(m * k + 1, device="cuda")[1:].view(m, k)
                x.copy_(a)
            ref = CR.cluster_matmul_ref(a, b)
            for name in order:
                if name in TIMING_ONLY and m * n * k >= 1024 ** 3:
                    continue     # their parts are read at the small shapes
                mod = PK if name == "parent" else CK
                if name != "parent":
                    source, CK.general_plan, CK.MIN_SPLIT_TILES = \
                        variants[name]
                    CK.SOURCE = sources[source]
                    CK._library.cache_clear()
                assert mod.route(torch.float32, m, k, n,
                                 aligned=not offset) == "general"
                out = mod.matmul(x, b)
                torch.cuda.synchronize()
                print(json.dumps({
                    "card": card, "kernel": "cluster_matmul_f32_general",
                    "variant": name, "timing_only": name in TIMING_ONLY,
                    "m": m, "k": k, "n": n,
                    "a_offset_bytes": 4 * offset,
                    "plan": None if name == "parent"
                    else CK.general_plan(m, k, n),
                    "ms": timer.ms(lambda: mod.matmul(x, b)),
                    "max_abs_err": (out - ref).abs().max().item()}),
                    flush=True)
            CK.general_plan, CK.MIN_SPLIT_TILES = plan, min_tiles
            CK.SOURCE = sources["as_is"]
            CK._library.cache_clear()
            if offset:
                # aligned A: the general kernel as planned (the route's
                # pick) and the parent's route and kernel, in turns
                for name in (["parent_aligned"] if PK else []) \
                        + ["general_aligned", "general_aligned"] \
                        + (["parent_aligned"] if PK else []):
                    mod = PK if name == "parent_aligned" else CK
                    out = mod.matmul(a, b)
                    torch.cuda.synchronize()
                    print(json.dumps({
                        "card": card, "kernel": "cluster_matmul_f32",
                        "variant": name, "m": m, "k": k, "n": n,
                        "branch": mod.route(torch.float32, m, k, n),
                        "ms": timer.ms(lambda: mod.matmul(a, b)),
                        "max_abs_err": (out - ref).abs().max().item()}),
                        flush=True)
            print(json.dumps({
                "card": card, "kernel": "torch.matmul", "m": m, "k": k,
                "n": n, "ms": timer.ms(lambda: torch.matmul(a, b))}),
                flush=True)
    finally:
        CK.general_plan, CK.MIN_SPLIT_TILES = plan, min_tiles
        CK.SOURCE = src
        CK._library.cache_clear()


def flash_f32_ab(card: str, parent) -> None:
    """The FP32-core flash forward against the parent's and its variants
    (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    PK = _parent_module(parent, "flash_attention", "parent_flash") \
        if parent else None
    src = FK.SOURCE
    sources = {n: variant_source(src, e, "f32_" + n)
               for n, e in FLASH_F32_VARIANTS.items()}
    launch.build(list(sources.values()) + ([PK.SOURCE] if PK else []))
    timer = CS.Timer()
    plan = FK.fp32_plan
    # (source, plan)
    variants = {"as_is": ("as_is", plan),
                "no_split": ("as_is", lambda *a: (0, 1)),
                **{n: (n, plan) for n in ("one_slot", "tanhf", "no_s",
                                          "no_pv", "no_copies")}}
    order = (["parent"] if PK else []) + list(variants) \
        + list(variants)[::-1] + (["parent"] if PK else [])
    cases = [(16, 512, 512, 256, 2, torch.float32, True, w, 50.0)
             for w in (0, 128)]
    cases += [(BH, S, T, d, 1, dtype, causal, window, cap)
              for (BH, S, T, d) in CS.FLASH_SHAPES
              for (causal, window, cap) in CS.FLASH_MASKS
              for dtype in (torch.float32, torch.bfloat16)
              if dtype == torch.float32 or d == 32]
    inputs = []
    for BH, S, T, d, G, dtype, causal, window, cap in cases:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = (torch.randn(BH, S, d, generator=g, device="cuda") * 0.3
             ).to(dtype)
        k = (torch.randn(BH // G, T, d, generator=g, device="cuda") * 0.3
             ).to(dtype)
        v = torch.randn(BH // G, T, d, generator=g, device="cuda").to(dtype)
        ref = FR.flash_attention_ref(
            q, k.repeat_interleave(G, 0), v.repeat_interleave(G, 0),
            causal=causal, window=window, cap=cap)
        inputs.append((q, k, v, ref))
    try:
        for name in order:
            mod = PK if name == "parent" else FK
            if name != "parent":
                source, FK.fp32_plan = variants[name]
                FK.SOURCE = sources[source]
                FK._library.cache_clear()
            for (BH, S, T, d, G, dtype, causal, window, cap), (
                    q, k, v, ref) in zip(cases, inputs):
                def run(q=q, k=k, v=v, mod=mod, causal=causal,
                        window=window, cap=cap, G=G):
                    return mod.flash_attention_fwd(
                        q, k, v, causal=causal, window=window, cap=cap,
                        groups=G)
                out = run()
                torch.cuda.synchronize()
                print(json.dumps({
                    "card": card, "kernel": "flash_fp32_cores",
                    "variant": name, "timing_only": name in TIMING_ONLY,
                    "BH": BH, "S": S, "T": T, "d": d,
                    "G": G, "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "window": window, "cap": cap,
                    "plan": None if name == "parent"
                    else FK.fp32_plan(BH, S, T, d, causal, window),
                    "ms": timer.ms(run),
                    "max_abs_err": (out.float() - ref.float()).abs().max()
                    .item()}), flush=True)
    finally:
        FK.SOURCE, FK.fp32_plan = src, plan
        FK._library.cache_clear()
    from torch import _dynamo
    with _dynamo.config.patch(recompile_limit=64,
                              fail_on_recompile_limit_hit=True):
        for (BH, S, T, d, G, dtype, causal, window, cap), (
                q, k, v, _) in zip(cases, inputs):
            library = CS.flash_library(q, k, v, causal, window, cap)
            print(json.dumps({
                "card": card, "kernel": "flex_attention" if cap else "sdpa",
                "BH": BH, "S": S, "T": T, "d": d, "G": G,
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "window": window, "cap": cap, "ms": timer.ms(library)}),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit: A/B its paged "
                    "attention against this one instead of the variants")
    ap.add_argument("--parts", default=None,
                    help="comma-separated parts to run (default: all of "
                    "the mode's: flash, split, "
                    "prefill_f32_variants, matmul_f32_general, "
                    "flash_f32; with --parent prefill_f32, decode, serve, "
                    "matmul_f32_general, flash_f32)")
    args = ap.parse_args()
    modes = {False: ("flash", "split", "prefill_f32_variants",
                     "matmul_f32_general", "flash_f32"),
             True: ("prefill_f32", "decode", "serve", "matmul_f32_general",
                    "flash_f32")}[args.parent is not None]
    parts = modes if args.parts is None else tuple(args.parts.split(","))
    if not set(parts) <= set(modes):
        ap.error(f"--parts {args.parts}: this mode runs {modes}")
    if not torch.cuda.is_available():
        print("ab_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "matmul_f32_general" in parts:
        matmul_f32_general_ab(card, args.parent)
    if "flash_f32" in parts:
        flash_f32_ab(card, args.parent)
    if args.parent is not None:
        if set(parts) & {"prefill_f32", "decode", "serve"}:
            parent_ab(args.parent, card, parts)
        return 0
    if "flash" in parts:
        flash_ab(card)
    if "split" in parts:
        split_ab(card)
    if "prefill_f32_variants" in parts:
        prefill_f32_variants_ab(card)
    return 0


def flash_ab(card: str) -> None:
    """The flash tensor-core kernel against its variants at gemma2-2b's
    geometry (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    flash_src = FK.SOURCE
    flash = {n: variant_source(flash_src, e, n)
             for n, e in FLASH_VARIANTS.items()}
    launch.build(flash.values())
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


def split_ab(card: str) -> None:
    """The split-KV decode kernel against its variants at phase 3's C=1
    bf16 cases (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    split_src = K.SOURCE
    split = {n: variant_source(split_src, e, n)
             for n, e in SPLIT_VARIANTS.items()}
    launch.build(split.values())
    timer = CS.Timer()

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


if __name__ == "__main__":
    sys.exit(main())
