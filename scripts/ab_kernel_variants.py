#!/usr/bin/env python3
"""A/B of the redesigned kernels against variants of themselves, or
against an earlier commit's kernels.

    python3 scripts/ab_kernel_variants.py \
        [--parts flash,split,prefill_f32_variants,matmul_bf16_general,
                 flash_tc]
    python3 scripts/ab_kernel_variants.py --parent DIR \
        [--parts prefill_f32,decode,serve,matmul_f32_general,flash_f32,
                 matmul_bf16_general,flash_tc]

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
* The general bfloat16 cluster matmul (``matmul_bf16_general``): phase
  7's bf16 general shapes (100 x 36 x 20, 127^3, 1024 x 4095 x 11007)
  and 256^3, 768^3, 1000 x 1032 x 776, 4096^3, yi-6b's MLP product and
  128 x 8192 x 128 with A 2 bytes past a 16-byte boundary, ms by
  ``chip_smoke.Timer`` and max |err| against the plain version, in
  turns: the parent's kernel
  (with ``--parent``), then ``as_is``, ``u16_loads`` (an operand whose
  rows allow no 4-byte access loaded by 2-byte loads instead of aligned
  4-byte words realigned with ``__byte_perm``; only where one does),
  ``a_regs`` (A's width from its base and row pitch, K not shifted: a
  base 2 bytes off takes A through registers; only where that changes
  A's access),
  the plan variants ``split_2`` (splits of at least 2 K tiles of 32
  aiming at four blocks an SM, not 8 tiles and one block), ``no_split``
  and ``tile_128`` (only where their plan differs) and, timing only at
  shapes of 768^3 or more, ``no_mma`` and ``no_regs``, then the
  same reversed (a variant whose launch fails is recorded as such); then
  the route's A/B at phase 7's aligned bf16 shapes whose grids are under
  a wave (128^3 to 1000 x 1032 x 776), and at 4096^3 and the MLP
  product: the general kernel as planned and the wgmma kernel, each
  forced, in turns (G, W, W, G); and ``torch.matmul`` at every shape.
  With ``--parent`` it then times every case phase 7 had before this
  part existed (``MATMUL_SHAPES`` in both types, ``MATMUL_OFFSET_F32``
  with A 4 bytes off) through the parent's wrapper and this one's, each
  on its own route, in turns (P, N, N, P).
* The FP32-core flash forward (``flash_f32``): phase 10's two float32
  calls (BH=16, S=T=512, hd 256, G=2, cap 50, window 0 / 128),
  deepseek-v2's float32 MLA call (q/k 192, v 128, BH 256, causal,
  S=T=512) and the same at BH 8 (split), ``tests/test_kernels.py``'s
  three shapes and hd 16 x five masks in float32 and at hd 16 and 32 in
  bfloat16, ms by ``chip_smoke.Timer`` and max |err| against the plain
  version, in turns: the parent's kernel (with ``--parent``; at MLA its
  route, as ``flash_tc``'s),
  then ``as_is``, ``no_split`` (one block a query tile), ``one_slot``
  (one K and one V slot at every hd) and ``tanhf``
  (the cap through ``cap * tanhf(x / cap)``),
  and, timing only, ``no_s``, ``no_pv`` (without a product) and
  ``no_copies`` (no K/V copies past the first slots), then the same
  reversed; then the library call (SDPA or the compiled
  ``flex_attention``, ``chip_smoke.flash_library``) once a case, and a
  ``summary`` line a case: each side's median, and whether ``as_is``
  equals the parent bit for bit (with the largest difference).

* The tensor-core flash forward (``flash_tc``) at the main path's bf16
  calls (``chip_smoke.py`` phase 9): hd 64 at whisper-medium's three
  (``WHISPER_FLASH``), hymba-1.5b's (G = 5, window 2048, S=T=3072) and
  train_100m's (G = 2, causal, S=T=256); deepseek-v2's MLA (BH 256, q/k
  192, v 128, causal, S=T=512); gemma2-2b's (hd 256, G = 2, cap 50,
  S=T=4096) and phase 13's drafts (hd 128, G = 8, S=T=320 / 576).  ms
  by ``chip_smoke.Timer`` and max |err| against the plain version on
  flat and sharp inputs, in turns (A, B, ..., B, A): ``as_is`` (the
  plan ``kernel.tc_plan`` picks), the hd-64 cases also under each plan
  forced (``wide``: three consumers, ``narrow``: two, both 128-key tiles)
  and under each tile plan of ``FLASH_TC_PLANS`` (the source's
  ``Plan64Wide`` line rewritten, that plan forced), and, with
  ``--parent``, the parent's kernel at every case (at MLA its route: its
  own (192, 128) where its ``head_dims`` says so, else q, k and v
  zero-padded to hd 256, the hd-256 kernel, the output sliced to 128).  The other cases run ``as_is`` and the parent only (the plans
  change no other instantiation).  Each JSON line is one timing; a
  ``summary`` line a case gives the median of each side's turns, SDPA's
  median, and whether the parent's and this tree's outputs are equal
  bit for bit.  First, every build's tensor-core entries with their
  registers, spills and whether ptxas serialized their wgmma (``ptxas
  -v``); a plan whose setmaxnreg sum the entry's registers cannot hold is
  not launched (it would wait forever).

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
import itertools
import json
import re
import statistics
import subprocess
import sys
import tempfile
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
#: source variants of the general bfloat16 cluster matmul: ``u16_loads``
#: fills a register chunk by eight 2-byte loads, not four or five aligned
#: 4-byte words (it computes the function); timing only: ``no_mma`` (no
#: products) and ``no_regs`` (no register-path loads or stores past the
#: first tile)
MATMUL_BF16_VARIANTS = {
    "as_is": [],
    "no_mma": [("          mma_16816(acc[mi][ni], af[mi], bfr[ni][0], "
                "bfr[ni][1]);\n", "          ;\n", 1)],
    "no_regs": [("    if (next) load_regs(kt0 + it + 1);\n", "", 1),
                ("    if (next) store_regs((it + 1) % kStages);\n", "", 1)],
    "u16_loads": [
        ("  static constexpr int kWords = 5;",
         "  static constexpr int kWords = 8;", 1),
        ("      const unsigned int* q = reinterpret_cast<const unsigned int*>"
         "(g - mis);\n#pragma unroll\n      for (int i = 0; i < 5; ++i)\n"
         "        w[j][i] = v > 0 && 2 * i - mis < v ? __ldg(q + i) : 0u;\n",
         "      const unsigned short* q = reinterpret_cast<const unsigned "
         "short*>(g);\n#pragma unroll\n      for (int i = 0; i < 8; ++i)\n"
         "        w[j][i] = i < v ? __ldg(q + i) : 0u;\n", 1),
        ("      info |= uint32_t(v | mis << 4) << (5 * j);",
         "      info |= uint32_t(v) << (5 * j);", 1),
        ("        o[i] = mis ? __byte_perm(w[j][i], w[j][i + 1], 0x5432) : "
         "w[j][i];",
         "        o[i] = w[j][2 * i] | w[j][2 * i + 1] << 16;", 1)],
}
#: aligned bf16 products the route A/B runs on both branches: phase 7's
#: whose 128 x 128 grids are under a wave, then two that fill waves
ROUTE_SHAPES = [(64, 64, 64), (128, 128, 128), (256, 256, 256),
                (256, 384, 512), (384, 256, 128), (768, 768, 768),
                (1000, 1032, 776), (4096, 4096, 4096), (1024, 4096, 11008)]
#: source variants of the FP32-core flash kernel
FLASH_F32_VARIANTS = {
    "as_is": [],
    "one_slot": [("  static constexpr int kSlots = kQ + kP + 2 * (kK + kV) "
                  "<= kSmemLimit ? 2 : 1;", "  static constexpr int kSlots = "
                  "1;", 1)],
    "tanhf": [("        if (cap != 0.f) x = cap - __fdividef(two_cap, 1.f + "
               "exp2f(k2 * x));\n",
               "        if (cap != 0.f) x = cap * tanhf(x / cap);\n", 1)],
    # timing only (wrong values): no S products, no P.V, no K/V copies
    # past the first slots
    "no_s": [("    for (int d = 0; d < DK; d += 4) {\n      float "
              "qv[kRT][4], kv4[4][4];", "    for (int d = 0; d < 0; d += 4) "
              "{\n      float qv[kRT][4], kv4[4][4];", 1)],
    "no_pv": [("    for (int t4 = 0; t4 < kTok; t4 += 4) {\n      float "
               "pv[kRT][4];", "    for (int t4 = 0; t4 < 0; t4 += 4) {\n      "
               "float pv[kRT][4];", 1)],
    "no_copies": [("    if (it > 0) stage_v(it - 1 + kSlots);", "", 1),
                  ("    stage_k(it + kSlots);", "", 1)],
}
#: tile plans the tensor-core flash kernel's hd-64 ``Plan64Wide`` is
#: rewritten to (``flash_tc``): (consumer warpgroups, keys a tile, ring
#: stages, blocks an SM, registers a consumer / producer thread), as
#: ``tc::TilePlan`` takes them.  The source's own two plans are the sides
#: ``wide`` (3, 128, 2, 1, 160, 24) and ``narrow`` (2, 128, 2, 1, 240, 24)
FLASH_TC_PLANS = {
    "c2_k64_s2": (2, 64, 2, 1, 240, 24),    # hd 128's plan, the parent's
    "c3_k64_s2": (3, 64, 2, 1, 160, 24),
    "c3_k128_s3": (3, 128, 3, 1, 160, 24),
    "c2_k64_s4": (2, 64, 4, 1, 240, 24),
    "c2_k64_b2": (2, 64, 2, 2, 104, 24),    # two blocks an SM
}
FLASH_TC_PLAN_LINE = "using Plan64Wide = TilePlan<"
#: variants whose values are wrong by design: they time what is left
TIMING_ONLY = {"s_bcast", "no_s",
               "no_pv", "no_s_pv", "no_stage", "no_softmax", "exit_only",
               "no_fma", "no_copies", "no_s", "no_pv", "no_mma", "no_regs"}
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


def ptxas_reports(sources: dict, entry: str) -> dict:
    """Per name of ``sources`` (name -> .cu), (kernel, registers, spill
    store bytes, spill load bytes, why ptxas serialized its wgmma or None)
    of every entry whose mangled name holds ``entry``, as ``ptxas -v``
    reports them: one ``nvcc`` a source, all started together."""
    from repro_torch.kernels import launch
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [launch._nvcc(), *launch.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in sources.items()}
        outs = {name: proc.communicate()[0] for name, proc in procs.items()}
    rows = {}
    for name, out in outs.items():
        lines = out.splitlines()
        rows[name] = []
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S*)'", line)
            if not m or entry not in m.group(1):
                continue
            tail = " ".join(lines[i + 1:i + 4])
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", tail)
            regs = re.search(r"Used (\d+) registers", tail)
            rows[name].append((m.group(1),
                               int(regs.group(1)) if regs else None,
                               *(map(int, spill.groups()) if spill
                                 else (None, None)),
                               next((ln.split("serialized", 1)[1].strip()
                                     for ln in lines if m.group(1) in ln
                                     and "serialized" in ln), None)))
    return rows


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


def _padded_by(mod, dtype, dk: int, dv: int) -> int:
    """The hd a flash wrapper ``mod`` (this checkout's or a parent's) runs
    a (dk, dv) call at when it does not take the pair as it is (its
    ``head_dims``; 256 for a wrapper older than that), else 0."""
    if dk == dv:
        return 0
    dims = getattr(mod, "head_dims", None)
    got = dims(dtype, dk, dv) if dims else (256, 256)
    return 0 if got == (dk, dv) else got[0]


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


def matmul_bf16_general_ab(card: str, parent) -> None:
    """The general bfloat16 branch against the parent's, its variants and
    the wgmma branch (see the module docstring)."""
    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.cluster_matmul import ref as CR
    PK = _parent_module(parent, "cluster_matmul", "parent_matmul_bf16") \
        if parent else None
    src = CK.SOURCE
    sources = {n: variant_source(src, e, "bf16_" + n)
               for n, e in MATMUL_BF16_VARIANTS.items()}
    launch.build(list(sources.values()) + ([PK.SOURCE] if PK else []))
    timer = CS.Timer()
    bf16 = torch.bfloat16
    plan, route = CK.general_plan, CK.route
    split_rule = (CK.MIN_SPLIT_TILES_BF16, CK.SPLIT_BLOCKS_PER_SM_BF16)
    a_access = CK.a_access

    def unshifted(address, row_bytes):
        return CK.access_width(address, row_bytes), 0

    # (source, plan, (fewest K tiles a split, blocks an SM), A's access)
    variants = {
        "as_is": ("as_is", plan, split_rule, a_access),
        "u16_loads": ("u16_loads", plan, split_rule, a_access),
        "a_regs": ("as_is", plan, split_rule, unshifted),
        "split_2": ("as_is", plan, (2, 4), a_access),
        "no_split": ("as_is", lambda m, k, n, dtype: (64, 1)
                     if plan(m, k, n, dtype)[0] == 64 else (128, 1),
                     split_rule, a_access),
        "tile_128": ("as_is", lambda m, k, n, dtype: (128, 1), split_rule,
                     a_access),
        "no_mma": ("no_mma", plan, split_rule, a_access),
        "no_regs": ("no_regs", plan, split_rule, a_access)}

    def use(name):
        source, CK.general_plan, (CK.MIN_SPLIT_TILES_BF16,
                                  CK.SPLIT_BLOCKS_PER_SM_BF16), \
            CK.a_access = variants[name]
        CK.SOURCE = sources[source]
        CK._library.cache_clear()

    def planned(name, m, k, n, x):
        use(name)
        shift = CK.a_access(x.data_ptr(), 2 * k)[1]
        return CK.general_plan(m, k + shift, n, bf16)

    def inputs(m, k, n, a_off):
        g = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn(m, k, generator=g, device="cuda").to(bf16)
        b = (torch.randn(k, n, generator=g, device="cuda")
             / k ** 0.5).to(bf16)
        x = a
        if a_off:
            x = torch.empty(m * k + a_off // 2, dtype=bf16,
                            device="cuda")[a_off // 2:].view(m, k)
            x.copy_(a)
        return x, b, CR.cluster_matmul_ref(a, b).float()

    def record(kernel, name, m, k, n, a_off, fn, ref, **extra):
        row = {"card": card, "kernel": kernel, "variant": name, "m": m,
               "k": k, "n": n, "a_offset_bytes": a_off,
               "timing_only": name in TIMING_ONLY, **extra}
        try:
            out = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:      # a variant's launch refused
            print(json.dumps({**row, "error": str(e)}), flush=True)
            return
        print(json.dumps({
            **row, "ms": timer.ms(fn),
            "max_abs_err": (out.float() - ref).abs().max().item()}),
            flush=True)

    shapes = [(100, 36, 20, 0), (127, 127, 127, 0), (256, 256, 256, 2),
              (768, 768, 768, 2), (1000, 1032, 776, 2),
              (4096, 4096, 4096, 2), (1024, 4096, 11008, 2),
              (1024, 4095, 11007, 0), (128, 8192, 128, 2)]
    try:
        for m, k, n, a_off in shapes:
            x, b, ref = inputs(m, k, n, a_off)
            access = {v: (variants[v][3](x.data_ptr(), 2 * k),
                          CK.access_width(b.data_ptr(), 2 * n))
                      for v in variants}
            # variants that change nothing at this shape are not run
            base = planned("as_is", m, k, n, x)
            names = [v for v in variants if v == "as_is"
                     or (v == "u16_loads" and 2 in (access[v][0][0],
                                                    access[v][1]))
                     or (v == "a_regs" and access[v] != access["as_is"])
                     or (variants[v][0] == "as_is" and v != "a_regs"
                         and planned(v, m, k, n, x) != base)
                     or (v in TIMING_ONLY and m * k * n >= 768 ** 3)]
            order = (["parent"] if PK else []) + names + names[::-1] \
                + (["parent"] if PK else [])
            for name in order:
                mod = PK if name == "parent" else CK
                if name != "parent":
                    use(name)
                assert mod.route(bf16, m, k, n, aligned=not a_off) \
                    == "general"
                record("cluster_matmul_bf16_general", name, m, k, n, a_off,
                       lambda: mod.matmul(x, b), ref,
                       access=None if name == "parent" else access[name],
                       plan=None if name == "parent"
                       else planned(name, m, k, n, x))
            use("as_is")
            record("torch.matmul", None, m, k, n, a_off,
                   lambda: torch.matmul(x, b), ref)
        # the route: aligned products under a wave, and two that fill
        # waves, on either branch
        for m, k, n in ROUTE_SHAPES:
            x, b, ref = inputs(m, k, n, 0)
            for branch in (CK.GENERAL, CK.WGMMA, CK.WGMMA, CK.GENERAL):
                CK.route = lambda *_, branch=branch, **__: branch
                record("cluster_matmul_bf16_route", branch, m, k, n, 0,
                       lambda: CK.matmul(x, b), ref,
                       plan=planned("as_is", m, k, n, x)
                       if branch == CK.GENERAL else None)
            CK.route = route
            record("torch.matmul", None, m, k, n, 0,
                   lambda: torch.matmul(x, b), ref)
        if not PK:
            return
        # every earlier phase-7 case: the parent's route and kernel
        # against this checkout's, in turns
        cases = [(m, k, n, dt, 0) for (m, k, n) in CS.MATMUL_SHAPES
                 for dt in (torch.float32, bf16)]
        cases += [(m, k, n, torch.float32, 4)
                  for (m, k, n) in CS.MATMUL_OFFSET_F32]
        for m, k, n, dt, a_off in cases:
            g = torch.Generator(device="cuda").manual_seed(0)
            a = torch.randn(m, k, generator=g, device="cuda").to(dt)
            b = (torch.randn(k, n, generator=g, device="cuda")
                 / k ** 0.5).to(dt)
            x = a
            if a_off:
                x = torch.empty(m * k + 1, dtype=dt, device="cuda")[1:] \
                    .view(m, k).copy_(a)
            ref = CR.cluster_matmul_ref(a, b).float()
            for name in ("parent", "new", "new", "parent"):
                mod = PK if name == "parent" else CK
                record("cluster_matmul_phase7", name, m, k, n, a_off,
                       lambda: mod.matmul(x, b), ref,
                       dtype=str(dt).replace("torch.", ""),
                       branch=mod.route(dt, m, k, n, aligned=not a_off))
    finally:
        CK.general_plan, CK.route, CK.a_access = plan, route, a_access
        CK.MIN_SPLIT_TILES_BF16, CK.SPLIT_BLOCKS_PER_SM_BF16 = split_rule
        CK.SOURCE = src
        CK._library.cache_clear()


def flash_f32_ab(card: str, parent) -> None:
    """The FP32-core flash forward against the parent's and its variants
    (see the module docstring)."""
    import math

    import torch.nn.functional as F

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
    # (BH, S, T, dk, dv, groups, dtype, causal, window, cap): phase 10's
    # two calls, deepseek-v2's float32 MLA call (phase 9) and a grid of 8
    # heads that the plan splits, then test_kernels' shapes and hd 16
    cases = [(16, 512, 512, 256, 256, 2, torch.float32, True, w, 50.0)
             for w in (0, 128)]
    cases += [(BH, CS.DS_PROMPT, CS.DS_PROMPT, 192, 128, 1, torch.float32,
               True, 0, 0.0) for BH in (CS.DS_B * 128, 8)]
    cases += [(BH, S, T, d, d, 1, dtype, causal, window, cap)
              for (BH, S, T, d) in CS.FLASH_SHAPES + [(2, 128, 128, 16)]
              for (causal, window, cap) in CS.FLASH_MASKS
              for dtype in (torch.float32, torch.bfloat16)
              if dtype == torch.float32 or d <= 32]
    inputs = []
    for BH, S, T, d, dv, G, dtype, causal, window, cap in cases:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = (torch.randn(BH, S, d, generator=g, device="cuda") * 0.3
             ).to(dtype)
        k = (torch.randn(BH // G, T, d, generator=g, device="cuda") * 0.3
             ).to(dtype)
        v = torch.randn(BH // G, T, dv, generator=g, device="cuda").to(dtype)
        ref = FR.flash_attention_ref(
            q, k.repeat_interleave(G, 0), v.repeat_interleave(G, 0),
            causal=causal, window=window, cap=cap)
        inputs.append((q, k, v, ref))

    def call(mod, q, k, v, causal, window, cap, G):
        d, dv = q.shape[-1], v.shape[-1]
        kw = dict(causal=causal, window=window, cap=cap, groups=G,
                  scale=1 / math.sqrt(d))
        hd = _padded_by(mod, q.dtype, d, dv)
        if hd:     # the wrapper's route for the pair: pad, slice
            return mod.flash_attention_fwd(
                *(F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v)),
                **kw)[..., :dv]
        return mod.flash_attention_fwd(q, k, v, **kw)

    times, outs = {}, {}
    try:
        for name in order:
            mod = PK if name == "parent" else FK
            if name != "parent":
                source, FK.fp32_plan = variants[name]
                FK.SOURCE = sources[source]
                FK._library.cache_clear()
            for c, (BH, S, T, d, dv, G, dtype, causal, window, cap), (
                    q, k, v, ref) in zip(itertools.count(), cases, inputs):
                def run(q=q, k=k, v=v, mod=mod, causal=causal,
                        window=window, cap=cap, G=G):
                    return call(mod, q, k, v, causal, window, cap, G)
                out = run()
                torch.cuda.synchronize()
                if name in ("parent", "as_is"):
                    outs[name, c] = out
                ms = timer.ms(run)
                times.setdefault((name, c), []).append(ms)
                print(json.dumps({
                    "card": card, "kernel": "flash_fp32_cores",
                    "variant": name, "timing_only": name in TIMING_ONLY,
                    "BH": BH, "S": S, "T": T, "d": d, "dv": dv,
                    "G": G, "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "window": window, "cap": cap,
                    "plan": None if name == "parent"
                    else FK.fp32_plan(BH, S, T, d, causal, window, dv),
                    "ms": ms,
                    "max_abs_err": (out.float() - ref.float()).abs().max()
                    .item()}), flush=True)
    finally:
        FK.SOURCE, FK.fp32_plan = src, plan
        FK._library.cache_clear()
    from torch import _dynamo
    with _dynamo.config.patch(recompile_limit=64,
                              fail_on_recompile_limit_hit=True):
        for c, (BH, S, T, d, dv, G, dtype, causal, window, cap), (
                q, k, v, _) in zip(itertools.count(), cases, inputs):
            library = CS.flash_library(q, k, v, causal, window, cap)
            lib_ms = timer.ms(library)
            print(json.dumps({
                "card": card, "kernel": "flex_attention" if cap else "sdpa",
                "BH": BH, "S": S, "T": T, "d": d, "dv": dv, "G": G,
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "window": window, "cap": cap, "ms": lib_ms}), flush=True)
            # each side's median, and whether this tree's output is the
            # parent's bit for bit (MLA: the parent padded to hd 256)
            med = {side: statistics.median(t)
                   for (side, n), t in times.items() if n == c}
            parent_out = outs.get(("parent", c))
            print(json.dumps({
                "card": card, "kernel": "flash_fp32_cores", "summary": c,
                "BH": BH, "S": S, "T": T, "d": d, "dv": dv, "G": G,
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "window": window, "cap": cap, "median_ms": med,
                "library_ms": lib_ms,
                "bit_equal_to_parent": None if parent_out is None
                else torch.equal(parent_out, outs["as_is", c]),
                "max_abs_diff_to_parent": None if parent_out is None
                else (parent_out.float() - outs["as_is", c].float()).abs()
                .max().item()}), flush=True)


def flash_tc_ab(card: str, parent) -> None:
    """The tensor-core flash forward's hd-64 tile plans, and the parent's
    kernel, at the main path's bf16 calls (see the module docstring)."""
    import math

    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import launch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    PK = _parent_module(parent, "flash_attention", "parent_flash") \
        if parent else None
    src = FK.SOURCE
    line = next(ln for ln in src.read_text().splitlines()
                if FLASH_TC_PLAN_LINE in ln)
    sources = {"as_is": src, **{n: variant_source(
        src, [(line, f"{FLASH_TC_PLAN_LINE}{', '.join(map(str, plan))}>;",
               1)], "tc_" + n) for n, plan in FLASH_TC_PLANS.items()}}
    launch.build(list(sources.values()) + ([PK.SOURCE] if PK else []))
    # side -> (source, the hd-64 plan forced: 0 wide, 1 narrow, None the
    # route's)
    sides = {"as_is": ("as_is", None), "wide": ("as_is", 0),
             "narrow": ("as_is", 1), **{n: (n, 0) for n in FLASH_TC_PLANS}}
    for name, rows in ptxas_reports(
            {**sources, **({"parent": PK.SOURCE} if PK else {})},
            "flash_fwd_tc_kernel").items():
        for kernel, regs, st, ld, serialized in rows:
            print(json.dumps({"card": card, "kernel": "flash_tc",
                              "side": name, "entry": kernel,
                              "registers": regs, "spill_store_bytes": st,
                              "spill_load_bytes": ld,
                              "wgmma_serialized": serialized}), flush=True)
            # setmaxnreg.inc waits for registers the block does not hold
            # if the entry count is below the plan's sum: such a plan
            # would hang, so it is not launched
            m = re.search(r"TilePlanILi(\d+)ELi\d+ELi\d+ELi\d+ELi(\d+)E"
                          r"Li(\d+)E", kernel)
            if m and name in sides:
                c, creg, preg = map(int, m.groups())
                if (regs or 0) * 128 * (c + 1) < 128 * (c * creg + preg):
                    print(json.dumps({"card": card, "side": name,
                                      "skipped": f"{regs} registers at "
                                      "entry hold no setmaxnreg plan "
                                      f"{m.group(0)}"}), flush=True)
                    sides.pop(name)
    timer = CS.Timer()
    # (name, BH, S, T, dk, dv, groups, causal, window, cap)
    cases = [(f"whisper_{i}", *shape[:3], 64, 64, 1, causal, 0, 0.0)
             for i, (shape, causal) in enumerate(CS.WHISPER_FLASH)]
    cases += [("hymba", 50, CS.PREFILL_S, CS.PREFILL_S, 64, 64, 5, True,
               2048, 0.0),
              ("train_100m", *CS.TRAIN_100M_FLASH[0][:3], 64, 64,
               CS.TRAIN_100M_FLASH[1], True, 0, 0.0),
              ("mla", CS.DS_B * 128, CS.DS_PROMPT, CS.DS_PROMPT, 192, 128, 1,
               True, 0, 0.0),
              ("gemma2", 16, 4096, 4096, 256, 256, 2, True, 0, 50.0)]
    cases += [(f"draft_{S}", 32, S, S, 128, 128, 8, True, 0, 0.0)
              for S in (320, 576)]
    inputs = {}
    for name, BH, S, T, dk, dv, G, causal, window, cap in cases:
        g = torch.Generator(device="cuda").manual_seed(0)
        for sharp, qk in (("flat", 0.3), ("sharp", CS.FLASH_SHARP)):
            q = (torch.randn(BH, S, dk, generator=g, device="cuda") * qk
                 ).bfloat16()
            k = (torch.randn(BH // G, T, dk, generator=g, device="cuda")
                 * qk).bfloat16()
            v = torch.randn(BH // G, T, dv, generator=g, device="cuda"
                            ).bfloat16()
            ref = FR.flash_attention_ref(
                q, k.repeat_interleave(G, 0), v.repeat_interleave(G, 0),
                causal=causal, window=window, cap=cap)
            inputs[name, sharp] = (q, k, v, ref)

    def call(mod, name, q, k, v):
        _, BH, S, T, dk, dv, G, causal, window, cap = next(
            c for c in cases if c[0] == name)
        kw = dict(causal=causal, window=window, cap=cap, groups=G,
                  scale=1 / math.sqrt(dk))
        hd = _padded_by(mod, q.dtype, dk, dv)
        if hd:    # the wrapper's route for the pair: pad, slice
            return mod.flash_attention_fwd(
                *(F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v)),
                **kw)[..., :dv]
        return mod.flash_attention_fwd(q, k, v, **kw)

    order = (["parent"] if PK else []) + list(sides) + list(sides)[::-1] \
        + (["parent"] if PK else [])
    plan = FK.tc_plan
    times, outs = {}, {}
    try:
        for side in order:
            mod = PK if side == "parent" else FK
            if side != "parent":
                source, forced = sides[side]
                FK.SOURCE = sources[source]
                FK._library.cache_clear()
                FK.tc_plan = plan if forced is None else (
                    lambda BH, S, dk, dv, i=forced: FK.TC_PLANS[dk, dv][
                        min(i, len(FK.TC_PLANS[dk, dv]) - 1)])
            for name, BH, S, T, dk, dv, *_ in cases:
                if side not in ("parent", "as_is") and dk != 64:
                    continue
                errs, passes = {}, {}
                tol = CS.FLASH_TOL[torch.bfloat16]
                for sharp in ("flat", "sharp"):
                    q, k, v, ref = inputs[name, sharp]
                    out = call(mod, name, q, k, v)
                    torch.cuda.synchronize()
                    errs[sharp] = (out.float() - ref.float()).abs().max() \
                        .item()
                    passes[sharp] = torch.allclose(
                        out.float(), ref.float(), rtol=tol, atol=tol)
                    if side in ("parent", "as_is"):
                        outs[side, name, sharp] = out
                q, k, v, _ = inputs[name, "flat"]
                ms = timer.ms(lambda: call(mod, name, q, k, v))
                times.setdefault((side, name), []).append(ms)
                print(json.dumps({
                    "card": card, "kernel": "flash_tc", "side": side,
                    "plan": None if side == "parent" else
                    FK.tc_plan(BH, S, dk, dv), "case": name,
                    "BH": BH, "S": S, "T": T, "dk": dk, "dv": dv, "ms": ms,
                    "max_abs_err": errs, "passes": passes}), flush=True)
    finally:
        FK.SOURCE, FK.tc_plan = src, plan
        FK._library.cache_clear()
    for name, BH, S, T, dk, dv, G, causal, window, cap in cases:
        q, k, v, _ = inputs[name, "flat"]
        sdpa = None if cap else timer.ms(
            CS.flash_library(q, k, v, causal, window, cap))
        med = {side: statistics.median(t) for (side, n), t in times.items()
               if n == name}
        equal = {sharp: torch.equal(outs["parent", name, sharp],
                                    outs["as_is", name, sharp])
                 for sharp in ("flat", "sharp")} if PK else None
        print(json.dumps({"card": card, "kernel": "flash_tc",
                          "summary": name, "median_ms": med,
                          "sdpa_ms": sdpa, "bit_equal_to_parent": equal}),
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
                    "flash_f32, matmul_bf16_general, flash_tc; with "
                    "--parent prefill_f32, decode, serve, "
                    "matmul_f32_general, flash_f32, matmul_bf16_general, "
                    "flash_tc)")
    args = ap.parse_args()
    modes = {False: ("flash", "split", "prefill_f32_variants",
                     "matmul_f32_general", "flash_f32",
                     "matmul_bf16_general", "flash_tc"),
             True: ("prefill_f32", "decode", "serve", "matmul_f32_general",
                    "flash_f32", "matmul_bf16_general", "flash_tc")}[
        args.parent is not None]
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
    if "matmul_bf16_general" in parts:
        matmul_bf16_general_ab(card, args.parent)
    if "flash_tc" in parts:
        flash_tc_ab(card, args.parent)
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
