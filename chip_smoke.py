#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (a failure raises and the script exits
non-zero without printing the final result line):

1. info: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN.
2. build: the paged-attention, cluster-matmul and flash-attention CUDA
   kernels, compiled from the checkout's sources with ``nvcc`` for
   ``sm_90a``, one compiler per source, all started together.
3. kernel vs plain: the paged-attention kernels against their
   plain-PyTorch version at yi-6b attention geometry (B=8, H=32, Kv=4,
   hd=128, page 16, a 1,024-page pool, ragged lengths 1..1,024 with an
   empty lane and aliased shared-prefix pages), C in {1, 5, 128} (5: the
   verify width) with q in float32 and bfloat16, on a pool in q's type
   and on an int8 pool with its scales, and every case but float32 C=1
   again with q scaled so that scores have std 4 (``PAGED_SHARP``); each
   case prints the kernel it took (split-KV for
   C = 1, tensor cores for bf16 q with C > 1, FP32 cores for f32 q with
   C > 1; the counts must agree), its times, bytes, FLOPs and roofline
   bound.
4. engine parity: the same weights (yi-6b widths, 2 layers) served by the
   CUDA engine (kernel) and the CPU engine (plain version) in lockstep,
   with a shared prefix and a forced preemption: float32 greedy on a
   float32 pool, float32 with an int8 pool and speculative decoding
   (``spec_k=4``, drafts replayed from the first run's tokens), bfloat16
   greedy (its chunks on the tensor-core kernel, float32 chunks on the
   FP32-core kernel, decode on the split-KV kernel), then with the odd
   rids sampling (temperature 0.8, top-k 40, top-p 0.9, seed 100 + rid;
   the preempted lane samples) in float32 on a float32 pool and in
   bfloat16 on an int8 pool with ``spec_k=4`` (sampling lanes must not
   draft), each again at half the chunk, which must give the same
   streams (draws are keyed by position); tokens must agree, excusing
   only the first flip of a stream at a near-tie: the two engines'
   logits at that position must agree within 6e-2 (bf16) or 1e-5 (f32)
   times the largest logit (else the phase fails), and the
   CPU's margin between the two tokens (on its logits, or when sampled
   on its lg + gumbel) must be under 10x the two engines' disagreement
   on that pair (plus 1e-5 when sampled).  Then the bfloat16 weights as
   a ``DraftModelDrafter`` on the card (every self-attention on the
   tensor-core flash kernel) and on the CPU, from one 340-token context
   (S=352): the logits must agree as above and four proposals must be
   equal but for a near-tie.  Then the float32 engines again in lockstep
   with the prefix cache spilling to a 4-page host tier that cascades
   into a 16-page disk tier (six tenants' 64-token prompts visited twice
   on a 16-page pool), each under a ``FaultInjector`` with planned
   transient and persistent I/O faults, a seeded rate of transient ones
   and a corrupt put at a forced preemption: tokens, results and errors,
   retry counters, ``cache_stats()``, the injectors' reports and every
   traced host row must be equal, and the corrupted request alone must
   fail, by its checksum.  Last, the threefry draws of 8 keys x 64,000
   on the card must equal the CPU's bit for bit.
5. serve: yi-6b at full width (32 layers, bf16, random weights from seed
   0) serves 12 requests with a shared prefix and a forced preemption;
   the kernels must carry every layer of every iteration: the tensor-core
   kernel every prefill iteration, the split-KV kernel every decode one.
6. serve int8 + speculation: the same model and workload with
   ``kv_dtype="int8"`` and ``spec_k=4`` (the default n-gram drafter),
   then an ``echo_wave`` of requests that repeat a token pattern of the
   model's own; the int8 pool's kernels must carry every layer of every
   iteration (tensor cores: prefill and verify; split-KV: decode) and
   the drafter must propose.
7. cluster matmul vs plain: the cluster-matmul CUDA kernel against its
   plain version in float32 and bfloat16 at ``tests/test_kernels.py``'s
   shapes, 64^3, the demo's 256^3, Fig.5's 768^3, 4096^3, yi-6b's MLP
   product (1024 x 4096 @ 4096 x 11008), 100 x 36 x 20 (which breaks
   TMA's 16-byte rule), 1000 x 1032 x 776 (partial tiles in every
   dimension), 127^3 (rows of no whole 16-byte chunks), and 256^3,
   768^3, 1000 x 1032 x 776, 4096^3 and yi-6b's product with A one
   element past a 16-byte boundary (4 bytes in float32, 2 in bfloat16;
   in bfloat16 also 128 x 8192 x 128, K split), and 1024 x 4095 x 11007
   in bfloat16 (k and n odd), with the branch each took (wgmma for bf16
   with k, n multiples of 8 and 16-byte-aligned bases; general otherwise
   and for every float32 product, with the tile and K splits its plan
   picks and, in bf16, A's access width and K shift and B's access
   width: the counts must agree) and times beside ``torch.matmul``'s and
   the roofline bound.
8. offload path: the offload demo (copy-based vs zero-copy SVM through
   the cluster matmul, 256^2 float32), the same two modes at 4096^2 in
   float32 and bfloat16 and at 127^2 in float32 and bfloat16, Fig.5's
   four benchmarks on the card and Fig.6's traced RAB programs (host
   only, its assertions must hold); the kernel must carry every product
   (two launches per run: 4096^2 bf16 on its wgmma branch, the rest on
   the general one: 4096^2 float32 on 128 x 128 tiles, the demo's 256^2
   and 127^2 float32 with K split over blocks) and the plain version must
   never run; copy-mode and zero-copy outputs must be equal, and each is
   then held against the plain version.
9. flash kernels vs plain: the flash-attention CUDA kernels against
   their plain version at ``tests/test_kernels.py``'s three shapes x five
   (causal, window, cap) masks x {float32, bfloat16}, at gemma2-2b's
   geometry (B=2, H=8, Kv=4, S=T=4096, hd 256, bf16, cap 50, window 0
   and 4096; the tensor-core kernel), at phase 13's draft forwards
   (yi-6b: H=32 over Kv=4, hd 128, bf16, causal, at the shortest and the
   longest S its drafts reached; the tensor-core kernel) and at phase
   10's float32 calls (S=512, window 0 and 128; the FP32-core kernel),
   each capped case, gemma2's and the drafts' again with q and k scaled
   so that scores reach the cap's range (``FLASH_SHARP``); each case
   prints the kernel its route picked
   (the counts must agree), with times beside the plain version and the
   library call (SDPA without a cap, the compiled ``flex_attention`` with
   a softcap score_mod with one; an FP32-core case also prints the key
   splits its plan picks, and the counts must show them); then the op's
   gradients against plain autograd.
10. train parity: one ``make_train_step`` on the same float32 weights at
   gemma2-2b's widths (d 2304, 8/4 heads, hd 256, d_ff 9216) with one
   local/global pair, on the card (kernel) and on the CPU (plain); every
   flash forward on the card takes the FP32-core kernel, its key walks
   split over blocks as its plan says.
11. trainer: ``Trainer.run_with_recovery`` at phase 10's size (bf16) on
   the card with an injected failure; it must restart from the last
   commit and end at ``total_steps``.
12. train, full size: gemma2-2b as registered (26 layers, vocab 256,000,
   bf16 with a float32 master) takes a few steps at ``train_4k``'s
   S=4096, batch 2; the tensor-core flash kernel must carry every
   self-attention forward (26 layers x (forward + checkpoint recompute)
   per step) and the plain version must never run a forward.
13. front door, sampling and a draft model (run after phase 6, while
   the full-width model is loaded): phase 5's engine and requests with
   ``spec_k=4`` and a ``DraftModelDrafter`` drafting with the target's
   own weights (warmed up by one draft), served through ``FrontDoor``
   on the engine's ``MonotonicClock`` with seeded exponential arrivals
   (mean gap 0.05 s); odd rids sample (temperature 0.8, top-k 40, top-p
   0.95).  It
   prints ``latency_report``'s TTFT and TPOT percentiles, tokens/s,
   each rejected draft's top-2 margin, and the sampler's device ms and
   launches at a decode iteration's shape beside an all-greedy
   iteration's argmax.  The tensor-core flash kernel must carry every
   draft forward (the plain version none) and the paged kernels every
   layer of every iteration; sampling lanes must not draft; at least 80%
   of the drafts must be accepted; replaying the same schedule must give
   the same streams; greedy rids must give phase 5's tokens, excusing
   near-ties between the verify and the decode path as phase 4 does;
   and phase 5 (all greedy) must never have entered the sampler.
14. tiers and faults at full width (run after phase 13): three waves
   (phase 5's requests, 12 of other prompts that evict their prefixes,
   phase 5's prompts again) on a 384-page pool (1 MiB pages) that spills
   into a 96-page host tier and a 512-page disk tier in an owned temp
   directory, served three times: fault-free, under a seeded rate (0.05)
   of transient I/O faults (which must give the fault-free tokens), and
   with a persistent put fault planned at rid 1's forced preemption (rid
   1 alone must end in ``"error"``); every run must hit the host and the
   disk tier, and ``assert_faults_contained`` and
   ``assert_tier_conservation`` must hold.  It prints demoted and
   promoted pages and bytes, host ms per demoted and per promoted page,
   iteration wall medians and the paged kernels' launches, which must
   carry every layer of every iteration.
15. planner and load generator: the card's HBM byte rate (a 1 GiB copy)
   and bf16 rate (an 8192^3 product), the constants of
   ``repro_torch.launch.mesh``; ``load_gen``'s workload through the
   full-width engine on a ``VirtualClock``, which ``planner.simulate``
   must reproduce exactly (iterations, virtual duration, TTFT/TPOT
   percentiles, goodput); and the ``AnalyticCostModel``'s predicted
   prefill and decode iteration ms at the measured peaks beside phase
   5's measured medians, with ``Calibration.from_trace`` of phase 5's
   trace (recorded, not gated).

Then the script's time, one JSON line ``{"kernels": [...]}`` (the
paged-attention split-KV
decode kernel, FP32-core kernel and tensor-core kernel, each on both pool
types; the cluster matmul's general float32 kernel (K split, and on 128
x 128 tiles), its wgmma branch and its general bfloat16 kernel; the
flash kernel
on the tensor cores and on the FP32 cores) and, last, the result line
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the
repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and
#: the operation rate by input type (bf16 on the tensor cores, float32
#: outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: a sampled token may differ between two engines on the same logits only
#: where the top two of lg + gumbel are nearer than this: 10x the largest
#: gap measured between two backends' Gumbel draws (9.5e-7)
NEAR_TIE = 1e-5
#: phase 4's draft context: 340 tokens, bucketed to S=352, inside the
#: range of phase 13's draft lengths
DRAFT_CTX = 340
#: kernel-vs-plain tolerances: tests/test_kernels.py's f32 bar and its
#: bf16 TOL
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: two paths' whole-model logits, relative to the largest: the
#: whole-model bars of tests/test_torch_train.py (gradients against the
#: reference's); a bf16 model's rounding alone spreads the logits by
#: ~2% of the largest (``TOL``), and a wrong path by tens of percent
MODEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 6e-2}
L2_FLUSH_BYTES = 64 << 20          # more than the L2 (50 MB, data sheet)
#: device cycles the timer sleeps before each start event: ~0.1 ms at the
#: H100's 1.98 GHz boost clock, more than a wrapper's host work
SLEEP_CYCLES = 200_000
#: cluster-matmul tolerances (rtol = atol): tests/test_kernels.py's TOL
MATMUL_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
#: (m, k, n): tests/test_kernels.py's three, 64^3, the offload demo's
#: 256^3, Fig.5's 768^3, 4096^3, yi-6b's MLP up/gate product at 1,024
#: tokens (d 4096, d_ff 11008), one that breaks TMA's 16-byte rule (k, n
#: not multiples of 8), one with partial tiles in every dimension
#: (outside the reference's tile contract, so called through ``kernel``)
#: and phase 8's 127^3, whose rows are no whole 16-byte chunks
MATMUL_SHAPES = [(128, 128, 128), (256, 384, 512), (384, 256, 128),
                 (64, 64, 64), (256, 256, 256), (768, 768, 768),
                 (4096, 4096, 4096), (1024, 4096, 11008), (100, 36, 20),
                 (1000, 1032, 776), (127, 127, 127)]
#: shapes whose rows are no whole 16-byte chunks, so both types take the
#: general branch (every float32 shape takes it)
MATMUL_ODD = {(127, 127, 127)}
#: the branch each bf16 shape must take (the rest of MATMUL_SHAPES: wgmma)
MATMUL_GENERAL_BF16 = {(100, 36, 20)} | MATMUL_ODD
#: float32 products with A 4 bytes past a 16-byte boundary, which must
#: send them to the general branch (the alignment half of the route): the
#: offload demo's 256^3, Fig.5's 768^3 and 1000 x 1032 x 776 (grids under
#: a wave: 64 x 64 tiles, K split), 4096^3 and yi-6b's MLP product (128 x
#: 128 tiles)
MATMUL_OFFSET_F32 = [(256, 256, 256), (768, 768, 768), (1000, 1032, 776),
                     (4096, 4096, 4096), (1024, 4096, 11008)]
#: the same five in bfloat16 with A 2 bytes past a 16-byte boundary (the
#: general kernel's A by 16-byte copies, its K tiles one element early),
#: and one all-odd large product (k and n odd: both operands through
#: registers)
MATMUL_OFFSET_BF16 = MATMUL_OFFSET_F32
MATMUL_ODD_BF16 = [(1024, 4095, 11007)]
#: a deep product on a small grid in bfloat16 with A 2 bytes off: 4 tiles
#: of 64 x 64, K split over blocks
MATMUL_DEEP_BF16 = [(128, 8192, 128)]
#: score std of phase 3's "sharp" cases (q scaled by PAGED_SHARP / rms of
#: the pool's K): a dropped or misplaced K tile then moves an output by
#: O(|v|); at q*0.3 the scores have std 0.15, nearly flat, and a
#: dropped tile of a long lane can hide under the bf16 bar
PAGED_SHARP = 4.0
#: flash-attention tolerances (rtol = atol): tests/test_kernels.py's TOL;
#: gradients: its grad tests' 2e-3
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
FLASH_GRAD_TOL = 2e-3
#: (BH, S, T, hd): tests/test_kernels.py's flash shapes
FLASH_SHAPES = [(2, 128, 128, 64), (4, 256, 128, 32), (1, 128, 384, 128)]
#: (causal, window, cap): its five masks
FLASH_MASKS = [(True, 0, 0.0), (False, 0, 0.0), (True, 64, 0.0),
               (True, 0, 50.0), (True, 32, 30.0)]
#: q and k scale of the "sharp" cases: scores of std 16 reach the caps'
#: range (30, 50) and make the softmax peaky, so a dropped cap or a
#: dropped key tile moves an output by O(|v|) (at test_kernels' 0.3 the
#: scores have std 0.09, a cap of 30 moves them by < 5e-5 and gemma2's
#: S=4096 outputs are averages of about 0.02)
FLASH_SHARP = 4.0
#: gemma2-2b cut for phases 10-11 (the CPU side must fit in host memory
#: and finish in seconds): one local/global pair, a 16,384-token
#: vocabulary, S=512 with the window cut to 128 so the local layer's mask
#: bites, batch 2
TRAIN_CUTS = dict(num_layers=2, vocab_size=16384, sliding_window=128)
TRAIN_SMALL_S, TRAIN_SMALL_B = 512, 2
#: phase 12: train_4k's S=4096 with the batch cut from 256 to 2, and the
#: number of steps (the first one warms up)
TRAIN_FULL_B, TRAIN_FULL_STEPS = 2, 4


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------------------------------------------------------- timing --
class Timer:
    """Median device time of one call, measured with CUDA events around
    each call, the L2 cache flushed before every call (the serving path
    meets each layer's pages cold).  A device-side sleep of ~0.1 ms
    before the start event keeps the device busy while the host enqueues
    the call, so a call shorter than its own host work (a decode kernel,
    SDPA at C=1) is timed on the device, not on the host's clock."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in times)


# --------------------------------------------------------------- phase 3 --
def attention_case(C: int, dtype: torch.dtype, int8: bool = False,
                   seed: int = 0, sharp: bool = False) -> dict:
    """Inputs at yi-6b attention geometry, as the engine feeds the kernel:
    lane b holds ``lengths[b]`` tokens of which its last ``n_new`` are
    this step's queries (q_start = lengths - n_new); lanes 1..5 share a
    128-token prefix (8 aliased physical pages); the last lane is
    empty.  With ``int8`` the pool is int8 with (P, 2, Kv) float32
    scales, as the quantized engine keeps it.  q ~ N(0, 0.09), or with
    ``sharp`` scaled so the scores have std ``PAGED_SHARP``."""
    from repro_torch.kernels.paged_attention.ops import (
        page_counts_for, pad_block_table,
    )
    B, H, Kv, hd, page, P, n_pages = 8, 32, 4, 128, 16, 1024, 64
    rng = np.random.default_rng(seed)
    lengths = np.array([1, 17, 130, 300, 511, 777, 1024, 0], np.int32)
    n_new = np.minimum(C, lengths).astype(np.int32)
    q_start = (lengths - n_new).astype(np.int32)
    perm = rng.permutation(P)
    shared, private = perm[:8], list(perm[8:])
    bt = np.full((B, n_pages), -1, np.int32)
    for b, ln in enumerate(lengths):
        for lp in range(-(-int(ln) // page)):
            bt[b, lp] = shared[lp] if (1 <= b <= 5 and lp < 8) \
                else private.pop()
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, C, H, hd), np.float32)
                         ).to(dev)
    if int8:
        kv = torch.from_numpy(rng.integers(-127, 128, (P, 2, page, Kv, hd))
                              .astype(np.int8)).to(dev)
        scales = torch.from_numpy(rng.uniform(
            1e-3, 2e-2, (P, 2, Kv)).astype(np.float32)).to(dev)
        k = kv[:, 0].float() * scales[:, 0, None, :, None]
    else:
        kv = torch.from_numpy(rng.standard_normal(
            (P, 2, page, Kv, hd), np.float32) * 0.5).to(dev, dtype)
        scales = None
        k = kv[:, 0].float()
    # a score is q.k / sqrt(hd): its std is q's std times k's rms
    q_std = PAGED_SHARP / k.pow(2).mean().sqrt().item() if sharp else 0.3
    q = (q * q_std).to(dtype)
    lens = torch.from_numpy(lengths).to(dev)
    counts = page_counts_for(lens, page)
    table = torch.from_numpy(bt).to(dev)
    # bytes the function must move: q in, out back, and every distinct
    # pool page a lane can see (K and V, with an int8 page's 2*Kv float32
    # scales), read once; the int32 tables
    visible = {int(p) for p in bt[bt >= 0]}
    elt = torch.finfo(dtype).bits // 8
    page_bytes = 2 * page * Kv * hd * (1 if int8 else elt) \
        + (2 * Kv * 4 if int8 else 0)
    nbytes = (2 * q.numel() * elt + len(visible) * page_bytes
              + bt.size * 4 + 3 * B * 4)
    # operations: QK^T and PV over each query row's visible tokens
    vis = np.clip(np.minimum(lengths[:, None],
                             q_start[:, None] + np.arange(C)[None, :] + 1),
                  0, None)
    flops = 4 * hd * H * int(vis.sum())
    return dict(q=q, kv=kv, scales=scales,
                padded=pad_block_table(table, counts), counts=counts,
                lens=lens,
                q_start=torch.from_numpy(q_start).to(dev),
                bytes=int(nbytes), flops=int(flops))


def sdpa_call(case: dict, C: int):
    """One PyTorch call computing the same attention on dense K/V gathered
    (and, from an int8 pool, dequantized to q's type) beforehand; the
    gather is not timed: the library yardstick."""
    import torch.nn.functional as F
    q, kv, padded = case["q"], case["kv"], case["padded"]
    B, _, H, hd = q.shape
    kv = kv[padded.long()]                        # (B, n_pages, 2, page, ..)
    if case["scales"] is not None:
        sc = case["scales"][padded.long()]        # (B, n_pages, 2, Kv)
        kv = (kv.float() * sc[:, :, :, None, :, None]).to(q.dtype)
    k = kv[:, :, 0].flatten(1, 2).transpose(1, 2).contiguous()
    v = kv[:, :, 1].flatten(1, 2).transpose(1, 2).contiguous()
    T = k.shape[2]
    tok = torch.arange(T, device=q.device)
    qpos = case["q_start"][:, None] + torch.arange(C, device=q.device)
    mask = (tok[None, None, :] < case["lens"][:, None, None]) & \
        (tok[None, None, :] <= qpos[..., None])
    qh = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask[:, None], enable_gqa=True)


#: phase 3's (C, q dtype, sharp) cases, each on both pool types
PAGED_CASES = [(C, dtype, sharp) for C in (1, 5, 128)
               for dtype in (torch.float32, torch.bfloat16)
               for sharp in (False, True)
               if not sharp or dtype == torch.bfloat16 or C > 1]


def phase_kernel(timer: Timer) -> list:
    return [kernel_case(timer, C, dtype, int8, sharp) for int8 in (False, True)
            for C, dtype, sharp in PAGED_CASES]


def kernel_case(timer: Timer, C: int, dtype: torch.dtype, int8: bool,
                sharp: bool = False) -> dict:
    """One case of phase 3: the kernel its route picks (on the int8 pool
    with ``int8``) against its plain version, then timed beside the plain
    version and SDPA, with its bytes, FLOPs and roofline bound."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    c = attention_case(C, dtype, int8, sharp=sharp)
    route = K.route(dtype, C)
    name = f"C={C} q={str(dtype).replace('torch.', '')} " \
        f"kv={'int8' if int8 else 'same'}{' sharp' if sharp else ''}"
    args = (c["q"], c["kv"], c["padded"], c["counts"], c["lens"],
            c["q_start"])
    masked = mask_block_table(c["padded"], c["counts"])
    sc = c["scales"]
    scales = {} if sc is None else dict(k_scales=sc[:, 0], v_scales=sc[:, 1])

    def kernel():
        return K.paged_prefill_fwd(*args, kv_scales=sc)

    def plain():
        return R.paged_prefill_ref(c["q"], c["kv"][:, 0], c["kv"][:, 1],
                                   masked, c["lens"], c["q_start"], **scales)

    pool = K.int8_launches if int8 else K.launches
    counters = (pool, K.tc_launches, K.split_launches)
    before = [c.n for c in counters]
    out = kernel()
    torch.cuda.synchronize()
    got = tuple(c.n - n0 for c, n0 in zip(counters, before))
    check(got == (1, int(route == K.TENSOR_CORES), int(route == K.SPLIT_KV)),
          f"{name}: route {route} but (pool, tensor-core, split-KV) "
          f"launches {got}")
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    check(bool(torch.isfinite(out.float()).all()),
          f"{name}: non-finite kernel output")
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"{name}: kernel vs plain max |err| {err}")
    ms = timer.ms(kernel)
    plain_ms = timer.ms(plain, reps=5)
    library_ms = timer.ms(sdpa_call(c, C))
    t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = c["flops"] / PEAK_OPS_PER_S[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(C=C, dtype=str(dtype).replace("torch.", ""),
               kv="int8" if int8 else "same", sharp=sharp, kernel=route,
               max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
               tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bytes=c["bytes"], flops=c["flops"], bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               share_of_bound=bound_ms / ms)
    print(f"kernel {name}: kernel={route} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bytes={c['bytes']} flops={c['flops']} bound_ms={bound_ms:.5f} "
          f"({row['bound_by']}) share_of_bound={row['share_of_bound']:.4f} "
          f"max_abs_err={err:.3g} max_abs_ref={row['max_abs_ref']:.3g} "
          f"tol={tol}", flush=True)
    return row


# --------------------------------------------------------------- phase 4 --
def _lockstep(engines, requests, preempt_rid: int, preempt_after: int):
    """Serve ``requests`` on every engine in lockstep (one ``step()`` each
    per round), preempting ``preempt_rid`` on all of them once it has
    ``preempt_after`` output tokens.  Returns each engine's tokens."""
    outs = [{r.rid: [] for r in requests} for _ in engines]
    for e in engines:
        for r in requests:
            e.submit(r)
    preempted = False
    busy = True
    while busy:
        busy = False
        for e, out in zip(engines, outs):
            busy |= e.step()
            for d in e.poll_deltas():
                out[d.rid].extend(d.tokens)
        if not preempted and len(outs[0][preempt_rid]) >= preempt_after:
            for e in engines:
                check(e.preempt(preempt_rid), "forced preemption missed")
            preempted = True
    return outs


def parity_models(dtype: str = "float32"):
    """Phase 4's weights (``dtype``) at yi-6b widths x 2 layers, on the CPU
    and (a copy) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=2,
                              param_dtype=dtype)
    cpu_model = init_params(cfg, seed=0, device="cpu")
    return cfg, cpu_model, copy.deepcopy(cpu_model).to("cuda")


class ReplayDrafter:
    """Proposes each request's greedy continuation from an earlier run
    (``known``: {prompt: tokens}), with the last draft of every call at an
    odd context length corrupted, so verification both accepts and
    rejects.  With random weights an n-gram drafter finds nothing to copy
    at a 64,000-token vocabulary; this one is deterministic in the
    context, so two engines that agree see the same drafts."""

    def __init__(self, known: dict, vocab: int):
        self.known, self.vocab = known, vocab

    def propose(self, ctx, k):
        for prompt, cont in self.known.items():
            n = len(prompt)
            if tuple(ctx[:n]) == prompt and \
                    list(ctx[n:]) == list(cont[:len(ctx) - n]):
                d = list(cont[len(ctx) - n:len(ctx) - n + k])
                if d and len(ctx) % 2:
                    d[-1] = (d[-1] + 1) % self.vocab
                return d
        return []


def sampling_for(rid: int, sampled: bool, top_p: float = 0.9,
                 max_new: int = 8):
    """Phase 4's and 13's requests: greedy, or with ``sampled`` the odd
    rids at temperature 0.8, top-k 40, top-p ``top_p``, seed 100 + rid."""
    from repro_torch.runtime import SamplingParams
    if sampled and rid % 2:
        return SamplingParams(temperature=0.8, top_k=40, top_p=top_p,
                              seed=100 + rid, max_new=max_new)
    return SamplingParams(max_new=max_new)


def logits_agree(rows, dtype: torch.dtype, label: str) -> tuple:
    """Two paths' float32 logits ``rows`` (the reference's last) must
    agree within the whole-model tolerance of the weights' type relative
    to the logits' scale: max |a - b| <= ``MODEL_TOL[dtype]`` x max |b|.
    Returns (that difference, its bound)."""
    a, b = (r.double().cpu() for r in rows)
    diff = (a - b).abs().max().item()
    gate = MODEL_TOL[dtype] * b.abs().max().item()
    check(diff <= gate, f"{label}: the two paths' logits differ by "
                        f"{diff:.3g} > {MODEL_TOL[dtype]} x max|logit| = "
                        f"{gate:.3g}")
    return diff, gate


def keep_margin(row: torch.Tensor, sp, z: int) -> float:
    """How far token ``z`` lies inside (>= 0) or outside (< 0) the top-k /
    top-p truncation of the float32 logits ``row``, by the sampler's own
    float32 steps (``server._sample_scores``): cut by top-k, its logit
    over the temperature less the k-th largest; else its log-probability
    less the log of the nucleus threshold."""
    lg = row.float().cpu() / max(sp.temperature, 1e-6)
    if sp.top_k > 0:
        kth = torch.sort(lg, descending=True).values[
            min(max(sp.top_k - 1, 0), lg.numel() - 1)]
        if lg[z] < kth:
            return (lg[z] - kth).item()
        lg = torch.where(lg < kth, -torch.inf, lg)
    e = torch.exp(lg - lg.max())
    probs = e / e.sum()
    desc = torch.sort(probs, descending=True).values
    keep = (torch.cumsum(desc, 0) - desc) < sp.top_p
    thresh = torch.where(keep, desc, torch.inf).min()
    return (torch.log(probs[z]) - torch.log(thresh)).item()


def flip_margin(rows, x: int, y: int, sp, pos: int, dtype: torch.dtype,
                label: str) -> tuple:
    """Whether token ``x`` (the first path's) against ``y`` (the
    reference's) at position ``pos`` is a near-tie, from the two paths'
    float32 logits ``rows`` (the reference's last), each computed at that
    position alone.  First the rows must agree (``logits_agree``), so a
    wrong path cannot excuse itself.  Then the reference's margin between
    the two tokens (greedy: on its logits; sampled: on its ``lg +
    gumbel``, ``server._sample_scores``) must be under 10x the two rows'
    disagreement on that same pair, plus, when sampled, ``NEAR_TIE`` (the
    gap two devices' Gumbel draws may differ by).  When sampled, a token
    that the top-k / top-p truncation keeps on one side and cuts on the
    other is weighed the same way on its ``keep_margin`` instead (a
    near-tie at the truncation's edge); one cut on both sides is no
    near-tie.  Returns (excused, the numbers as text)."""
    from repro_torch.runtime.server import _sample_scores
    diff, gate = logits_agree(rows, dtype, label)
    gated = f"logit diff {diff:.3g} <= {gate:.3g}"
    scores = [r.double().cpu() for r in rows]
    slack = 0.0
    if not sp.greedy:
        kept = [[keep_margin(r, sp, z) for r in rows] for z in (x, y)]
        if any(min(m) < 0 for m in kept):
            ok = all(max(m) >= 0 and (min(m) >= 0 or abs(min(m)) < 10 * (
                max(m) - min(m))) for m in kept)
            return ok, (f"truncation edge: keep margins (first path, "
                        f"reference) {kept[0]} for {x}, {kept[1]} for "
                        f"{y}; {gated}")
        scores = [_sample_scores(
            r.float()[None], torch.tensor([sp.seed & 0xFFFFFFFF]),
            torch.tensor([pos]), torch.tensor([sp.temperature]),
            torch.tensor([sp.top_k], dtype=torch.int32),
            torch.tensor([sp.top_p]))[0].double() for r in scores]
        slack = NEAR_TIE
    sa, sb = scores
    margin = (sb[y] - sb[x]).item()
    bound = 10 * abs(((sa[y] - sa[x]) - (sb[y] - sb[x])).item()) + slack
    ok = abs(margin) < bound
    return ok, (f"reference margin {margin:.3g}, bound {bound:.3g} "
                f"(ratio {bound / max(abs(margin), 1e-30):.3g}); {gated}")


def excuse_first_flip(label: str, prompt, a, b, rows_at, sp,
                      dtype: torch.dtype) -> bool:
    """The first position where the streams ``a`` and ``b`` (the
    reference's) of one request differ must be a near-tie
    (``flip_margin``; ``rows_at(ctx)`` gives both paths' logits after the
    context ``ctx``).  Past it the two contexts differ and the streams are
    not compared.  Returns whether they differed (and were excused)."""
    check(len(a) == len(b), f"{label}: lengths {len(a)}, {len(b)}")
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return False
    ctx = tuple(prompt) + tuple(b[:j])
    ok, numbers = flip_margin(rows_at(ctx), a[j], b[j], sp, len(ctx),
                              dtype, f"{label} token {j}")
    check(ok, f"{label} token {j}: {a[j]} != {b[j]}, {numbers}")
    print(f"{label} token {j} excused: {numbers}", flush=True)
    return True


def rerun_rows(make_pair, rid: int, sp):
    """``rows_at`` for ``excuse_first_flip``: the request's context served
    alone for one token (a sampled draw keeps its key: it is keyed by
    position) on each engine of ``make_pair()``, their last logits."""
    from repro_torch.runtime import GenerationRequest

    def rows_at(ctx):
        one = GenerationRequest(rid, ctx,
                                dataclasses.replace(sp, max_new=1))
        rows = []
        for e in make_pair():
            e.submit(one)
            e.run()
            rows.append(e.last_logits[0])
        return rows
    return rows_at


def phase_parity(models, kv_dtype: str = "bf16", spec_k: int = 0,
                 known=None, sampled: bool = False, chunk: int = 16
                 ) -> tuple:
    """The CUDA engine against the CPU engine on the same weights and
    requests (a shared 32-token prefix, a forced preemption).  With
    ``spec_k`` both speculate with a ``ReplayDrafter`` of ``known``
    ({prompt: greedy tokens} from an earlier run).  With ``sampled`` the
    odd rids sample (``sampling_for``): the sampler must run and those
    lanes must never draft.  On bfloat16 weights the CUDA engine's chunk
    steps must take the tensor-core kernel.  Decode steps must take the
    split-KV kernel, float32 chunks the FP32-core kernel.  Tokens must
    agree but for near-ties (``excuse_first_flip``).  Returns (excused
    positions, {prompt: the CPU engine's tokens}, the CUDA engine's
    launches by kernel, {rid: (CUDA tokens, CPU tokens)})."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, GenerationRequest, make_engine,
    )
    from repro_torch.runtime import server as S
    cfg, cpu_model, gpu_model = models
    ecfg = EngineConfig(cache=CacheConfig(num_pages=64, page_size=16,
                                          max_pages_per_seq=8,
                                          kv_dtype=kv_dtype),
                        max_lanes=2, chunk=chunk, spec_k=spec_k,
                        drafter=ReplayDrafter(known, cfg.vocab_size)
                        if spec_k else None)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 32).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(8, 33))).tolist()
               for _ in range(4)]
    requests = [GenerationRequest(rid, tuple(p),
                                  sampling_for(rid, sampled))
                for rid, p in enumerate(prompts)]

    def engines(chunk: int = chunk):
        spec = dataclasses.replace(ecfg, chunk=chunk)
        return [make_engine(cfg, gpu_model, spec),
                make_engine(cfg, cpu_model, spec, device="cpu")]

    pair = engines()
    counters = (K.launches, K.int8_launches, K.tc_launches, K.split_launches,
                S.sampler_calls)
    before = [c.n for c in counters]
    # with sampling the preempted lane is a sampling one
    gpu_out, cpu_out = _lockstep(pair, requests,
                                 preempt_rid=1 if sampled else 0,
                                 preempt_after=3)
    same, int8, tc_launches, split_launches, sampler = (
        c.n - b for c, b in zip(counters, before))
    check((sampler > 0) == sampled,
          f"sampled={sampled}: the sampler ran {sampler} times")
    fp32_core = same + int8 - tc_launches - split_launches
    bf16 = cfg.param_dtype == "bfloat16"
    check((tc_launches > 0) == bf16,
          f"{cfg.param_dtype} parity: {tc_launches} tensor-core launches")
    check(spec_k or split_launches > 0,
          f"{cfg.param_dtype} parity: no decode step took the split-KV "
          "kernel")
    check((fp32_core > 0) == (not bf16),
          f"{cfg.param_dtype} parity: {fp32_core} FP32-core launches")
    dtype = getattr(torch, cfg.param_dtype)
    label = f"parity {cfg.param_dtype} kv {kv_dtype} spec_k={spec_k}"
    excused = 0
    for r in requests:
        a, b = gpu_out[r.rid], cpu_out[r.rid]
        check(len(a) == len(b) == 8, f"rid {r.rid}: lengths {len(a)}, "
                                     f"{len(b)}")
        excused += excuse_first_flip(
            f"{label} CUDA vs CPU rid {r.rid}", r.prompt, a, b,
            rerun_rows(engines, r.rid, r.sampling), r.sampling, dtype)
    halved_excused = 0
    if sampled:
        # draws are keyed by position: half the chunk, the same streams on
        # each device (a flip only at a near-tie between the two chunkings)
        halved = _lockstep(engines(chunk // 2), requests, preempt_rid=1,
                           preempt_after=3)
        for d, name in enumerate(("CUDA", "CPU")):
            def make_pair(d=d):
                return [engines(chunk // 2)[d], engines(chunk)[d]]
            for r in requests:
                halved_excused += excuse_first_flip(
                    f"{label} {name} chunk {chunk // 2} vs {chunk} rid "
                    f"{r.rid}", r.prompt, halved[d][r.rid],
                    (gpu_out, cpu_out)[d][r.rid],
                    rerun_rows(make_pair, r.rid, r.sampling), r.sampling,
                    dtype)
        print(f"parity: chunk {chunk // 2} gives the chunk-{chunk} streams "
              f"on both devices, excused_positions={halved_excused}",
              flush=True)
    g, c = pair
    check(g.preemptions >= 1 and c.preemptions >= 1, "no preemption")
    check(g.cache_stats().prefix_hit_tokens > 0, "no prefix hit")
    spec = [(e.spec_proposed, e.spec_accepted, e.spec_rejected)
            for e in pair]
    if spec_k:
        check(c.spec_accepted > 0 and c.spec_rejected > 0,
              f"speculation accepted {c.spec_accepted} and rejected "
              f"{c.spec_rejected} drafts (both must happen)")
        drafted = [res.rid for e in pair for res in e.finished
                   if sampled and res.rid % 2 and res.spec_proposed]
        check(not drafted, f"sampled lanes drafted: rids {drafted}")
    if not excused:
        check((g.iterations, g.h2d_events, g.d2h_events, spec[0])
              == (c.iterations, c.h2d_events, c.d2h_events, spec[1]),
              "CUDA and CPU engines scheduled differently")
    n_tok = sum(len(v) for v in cpu_out.values())
    print(f"parity: yi-6b widths x 2 layers {cfg.param_dtype}, kv "
          f"{kv_dtype}, spec_k={spec_k}, sampled={sampled}, chunk={chunk}, "
          f"sampler_calls={sampler}, {len(requests)} requests, "
          f"{n_tok} tokens, tensor_core_launches={tc_launches}, "
          f"split_kv_launches={split_launches}, "
          f"fp32_core_launches={fp32_core}, "
          f"identical={excused == 0}, excused_positions={excused}, "
          f"prefix_hit_tokens={g.cache_stats().prefix_hit_tokens}, "
          f"preemptions={g.preemptions}, iterations={g.iterations}, "
          f"spec_proposed/accepted/rejected cuda={spec[0]} cpu={spec[1]}",
          flush=True)
    return excused, {tuple(r.prompt): cpu_out[r.rid] for r in requests}, \
        dict(tc_launches=tc_launches, split_launches=split_launches,
             fp32_core_launches=fp32_core), \
        {r.rid: (gpu_out[r.rid], cpu_out[r.rid]) for r in requests}


# ----------------------------------------------- phase 4: tiers and faults --
def tier_parity_workload(cfg) -> list:
    """Phase 4's tiered traffic: six tenants' 64-token system prompts (4
    pages of 16), each visited twice with its own 8-token tail, 4 new
    tokens each: 30 pages of prefixes for a 24-page pool, so evictions
    spill and the second visits hit host and disk."""
    from repro_torch.runtime import GenerationRequest, SamplingParams
    rng = np.random.default_rng(4)
    systems = [rng.integers(0, cfg.vocab_size, 64).tolist()
               for _ in range(6)]
    return [GenerationRequest(
        rep * 6 + t, tuple(s + rng.integers(0, cfg.vocab_size, 8).tolist()),
        SamplingParams(max_new=4))
        for rep in range(2) for t, s in enumerate(systems)]


#: phase 4's planned faults, by backing-store op index: transient I/O
#: faults and a persistent one on a tier fetch (ops counted from the
#: run's start; a corrupt put is added at the forced preemption)
TIER_PARITY_PLAN = {1: ("io", False), 2: ("io", False), 9: ("io", True)}


def phase_tier_parity(models, devices=("cuda", "cpu")) -> dict:
    """Phase 4's float32 weights served in lockstep by the CUDA engine and
    the CPU engine with the prefix cache spilling into a 4-page host tier
    that cascades into a 16-page disk tier, each engine with its own
    ``FaultInjector``: transient and persistent I/O faults at planned ops,
    a seeded rate (0.15) of transient ones, and a corrupt put planned at
    the first put of a forced preemption (rid 3 at 2 tokens), which the
    checksum must catch at its swap-in.  Tokens, results and errors,
    retry counters, ``cache_stats()``, the injectors' reports and every
    traced host row must be equal, and ``assert_faults_contained`` must
    hold.  ``assert_tier_conservation`` is compared, not required: here
    a fetch fault after an earlier hit's successful fetch re-plans the
    admission, and the reference drops the fetched payload without a
    trace event (the port keeps that behaviour, so the two traces stay
    comparable).  Returns the CUDA engine's paged launches by kernel."""
    from repro_torch.core.analysis import (
        assert_faults_contained, assert_tier_conservation, layer1_decode,
    )
    from repro_torch.core.tracing import TraceBuffer
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, FaultInjector, FaultSpec, make_engine,
    )
    cfg, cpu_model, gpu_model = models
    requests = tier_parity_workload(cfg)
    engines = []
    for model, dev in zip((gpu_model, cpu_model), devices):
        inj = FaultInjector(seed=7, rate=0.15, kinds=(FaultSpec("io"),),
                            plan={i: FaultSpec(k, persistent=p)
                                  for i, (k, p) in TIER_PARITY_PLAN.items()})
        engines.append(make_engine(cfg, model, EngineConfig(
            cache=CacheConfig(num_pages=16, page_size=16,
                              max_pages_per_seq=8, host_tier_pages=4,
                              disk_tier_pages=16),
            max_lanes=2, chunk=32, fault_injector=inj, swap_retries=3),
            tracer=TraceBuffer(capacity=1 << 16), device=dev))
    counters = (K.launches, K.tc_launches, K.split_launches)
    before = [c.n for c in counters]
    outs = [{r.rid: [] for r in requests} for _ in engines]
    try:
        for e in engines:
            for r in requests:
                e.submit(r)
        preempted, busy = False, True
        while busy:
            busy = False
            for e, out in zip(engines, outs):
                busy |= e.step()
                for d in e.poll_deltas():
                    out[d.rid].extend(d.tokens)
            if not preempted and len(outs[0][3]) >= 2:
                for e in engines:
                    e.faults.plan[e.faults.ops] = FaultSpec("corrupt",
                                                            op="put")
                    check(e.preempt(3), "forced preemption missed")
                preempted = True
        sides = []
        for e, out in zip(engines, outs):
            rows = e.tracer.drain()
            events = layer1_decode(rows)
            check(assert_faults_contained(events),
                  "tier parity: a faulted request was lost")
            e.pool.check_invariants()
            e.backing.check_invariants()
            sides.append(dict(
                tokens=out,
                results={r.rid: (r.tokens, r.finish_reason, r.error)
                         for r in e.finished},
                counters=dict(iterations=e.iterations, h2d=e.h2d_events,
                              d2h=e.d2h_events, preemptions=e.preemptions,
                              fault_retries=e.fault_retries,
                              recovered_faults=e.recovered_faults,
                              errors=e.errors),
                stats=dataclasses.asdict(e.cache_stats()),
                faults=e.faults.report(), rows=rows.tolist(),
                conserved=assert_tier_conservation(events)))
    finally:
        for e in engines:
            e.close()
    launches, tc, split = (c.n - b for c, b in zip(counters, before))
    g, c = sides
    for key in ("tokens", "results", "counters", "stats", "faults", "rows",
                "conserved"):
        check(g[key] == c[key], f"tier parity: {key} differ: CUDA "
                                f"{str(g[key])[:300]} CPU {str(c[key])[:300]}")
    st, rep = c["stats"], c["faults"]
    errs = [rid for rid, r in c["results"].items() if r[1] == "error"]
    check(errs == [3] and "checksum" in c["results"][3][2],
          f"tier parity: errors {errs} (rid 3 must fail its checksum)")
    check(all(r[1] == "length" for rid, r in c["results"].items()
              if rid != 3), "tier parity: a survivor did not finish")
    check(rep["by_kind"]["io"] >= 3 and rep["by_kind"]["corrupt"] == 1
          and rep["persistent_sites"] >= 1, f"tier parity: faults {rep}")
    check(c["counters"]["recovered_faults"] > 0,
          "tier parity: no transient fault was recovered")
    check(st["hits_host_pages"] > 0 and st["hits_disk_pages"] > 0
          and st["dropped_entries"] > 0,
          f"tier parity: tiers not exercised: {st}")
    if devices[0] == "cuda":
        check(launches > 0 and tc == 0 and split > 0,
              f"tier parity: launches {launches} (tensor cores {tc}, "
              f"split-KV {split})")
    print(f"tier parity: yi-6b widths x 2 layers float32, CUDA == CPU: "
          f"{len(requests)} requests, tokens, results, counters "
          f"{c['counters']}, cache_stats {st}, faults {rep}, "
          f"{len(c['rows'])} host rows, tier conservation "
          f"{c['conserved']}; fp32_core_launches="
          f"{launches - tc - split} split_kv_launches={split}", flush=True)
    return dict(fp32_core_launches=launches - tc - split,
                split_launches=split)


# --------------------------------------------------------------- phase 5 --
def serve_workload(cfg, kv_dtype: str = "bf16", spec_k: int = 0):
    """Phases 5 and 6's engine spec and requests: 12 greedy requests of
    300-700 prompt tokens and 32 new tokens each; rids 0, 8, 9 and 10
    share a 256-token prefix (0 runs in the first wave and publishes it,
    the other three are admitted after it finishes)."""
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
    )
    ecfg = EngineConfig(cache=CacheConfig(num_pages=1024, page_size=16,
                                          max_pages_per_seq=64,
                                          kv_dtype=kv_dtype),
                        max_lanes=8, chunk=128, spec_k=spec_k)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    requests = []
    for rid in range(12):
        n = int(rng.integers(300, 701))
        head = prefix if rid in (0, 8, 9, 10) else \
            rng.integers(0, cfg.vocab_size, 256).tolist()
        prompt = head + rng.integers(0, cfg.vocab_size, n - 256).tolist()
        requests.append(GenerationRequest(rid, tuple(prompt),
                                          SamplingParams(max_new=32)))
    return ecfg, requests


def echo_wave(requests, results) -> list:
    """Requests that repeat a token pattern the model itself produced:
    for each served request whose greedy continuation repeats a token of
    its history (first at index m), its prompt plus the continuation's
    first m tokens.  Greedy decode then emits that repeated token first,
    so the n-gram drafter finds it in the history; the prompt's full
    pages are prefix-cache hits, so every such request finishes its
    prefill in one chunk and they all decode together."""
    from repro_torch.runtime import GenerationRequest, SamplingParams
    wave = []
    for r in requests:
        toks = list(results[r.rid])
        seen = set(r.prompt)
        for m, t in enumerate(toks):
            if m and t in seen:
                wave.append(GenerationRequest(
                    100 + r.rid, tuple(r.prompt) + tuple(toks[:m]),
                    SamplingParams(max_new=len(toks) - m)))
                break
            seen.add(t)
    return wave


def phase_serve(cfg, model, kv_dtype: str = "bf16", spec_k: int = 0
                ) -> tuple:
    """Serve the workload at full width; the kernels of the pool's type
    must carry every layer of every iteration (their counts are read from
    0 just before the run and just after): the tensor-core kernel every
    prefill and verify iteration, the split-KV kernel every decode one;
    the plain version must never run.  With ``spec_k`` an ``echo_wave``
    follows once the workload is served.  Returns (metrics, {rid:
    tokens}, the run: each iteration's kind, wall ms, prefill tokens fed,
    decoding lanes and resident context tokens before it; the engine's
    trace rows and spec)."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.runtime import make_engine
    torch.cuda.reset_peak_memory_stats()
    ecfg, requests = serve_workload(cfg, kv_dtype, spec_k)
    engine = make_engine(cfg, model, ecfg)
    streamed = {}
    iter_ms = {"prefill": [], "decode": [], "verify": []}
    iters = []

    def drive(reqs, preempt_rid=None):
        for r in reqs:
            engine.submit(r)
            streamed[r.rid] = []
        preempted = preempt_rid is None
        while True:
            before = (engine.prefill_tokens, engine.spec_iterations)
            lanes = [r for r in engine.lanes if r is not None]
            ctx = sum(engine.pool.seq_len.get(r.rid, 0) for r in lanes)
            decoding = sum(r.fed >= len(r.prompt) for r in lanes)
            t = time.perf_counter()
            busy = engine.step()      # ends in the iteration's D2H pull
            dt = (time.perf_counter() - t) * 1e3
            if not busy:
                break
            kind = "prefill" if engine.prefill_tokens > before[0] else \
                "verify" if engine.spec_iterations > before[1] else "decode"
            iter_ms[kind].append(dt)
            iters.append(dict(kind=kind, ms=dt, ctx=ctx, decode=decoding,
                              prefill=engine.prefill_tokens - before[0]))
            for d in engine.poll_deltas():
                streamed[d.rid].extend(d.tokens)
            if not preempted and len(streamed[preempt_rid]) >= 8:
                check(engine.preempt(preempt_rid),
                      "forced preemption missed")
                preempted = True
        for d in engine.poll_deltas():
            streamed[d.rid].extend(d.tokens)

    for counter in (K.launches, K.int8_launches, K.tc_launches,
                    K.split_launches, R.calls):
        counter.reset()
    t_start = time.perf_counter()
    drive(requests, preempt_rid=1)
    wave = echo_wave(requests, streamed) if spec_k else []
    drive(wave)
    wall = time.perf_counter() - t_start
    ours, other = (K.int8_launches, K.launches) if kv_dtype == "int8" \
        else (K.launches, K.int8_launches)
    launches, other_launches, plain_calls = ours.n, other.n, R.calls.n
    tc_launches, split_launches = K.tc_launches.n, K.split_launches.n

    results = {r.rid: r for r in engine.finished}
    n_req = len(requests) + len(wave)
    check(len(results) == n_req,
          f"{len(results)} of {n_req} requests finished")
    for rid, res in results.items():
        check(res.finish_reason == "length",
              f"rid {rid} finished {res.finish_reason}")
        check(list(res.tokens) == streamed[rid],
              f"rid {rid}: streamed deltas != result tokens")
        check(all(0 <= t < cfg.vocab_size for t in res.tokens),
              f"rid {rid}: token out of vocabulary")
    check(bool(torch.isfinite(engine.last_logits).all()),
          "non-finite logits")
    stats = engine.cache_stats()
    check(stats.prefix_hit_tokens > 0, "no prefix-cache hit")
    check(engine.preemptions >= 1, "no preemption")
    check(engine.pool.stats["swapped_in"] > 0, "no swap-in")
    check(launches == cfg.num_layers * engine.iterations,
          f"{kv_dtype} kernel launches {launches} != {cfg.num_layers} "
          f"layers x {engine.iterations} iterations")
    n_chunked = len(iter_ms["prefill"]) + len(iter_ms["verify"])
    check(tc_launches == cfg.num_layers * n_chunked,
          f"{kv_dtype} tensor-core launches {tc_launches} != "
          f"{cfg.num_layers} layers x {n_chunked} prefill and verify "
          "iterations")
    check(split_launches == cfg.num_layers * len(iter_ms["decode"]),
          f"{kv_dtype} split-KV launches {split_launches} != "
          f"{cfg.num_layers} layers x {len(iter_ms['decode'])} decode "
          "iterations")
    check(launches == tc_launches + split_launches,
          f"{kv_dtype}: {launches - tc_launches - split_launches} launches "
          "of the FP32-core kernel (bf16 q takes the other two)")
    check(other_launches == 0,
          f"the other pool type's kernel branch ran {other_launches} times")
    check(plain_calls == 0, f"plain attention called {plain_calls} times")
    if spec_k:
        check(engine.spec_proposed > 0, "the drafter never proposed")
    out_tokens = sum(len(r.tokens) for r in results.values())
    row = dict(kv_dtype=kv_dtype, spec_k=spec_k, requests=n_req,
               echo_requests=len(wave), iterations=engine.iterations,
               **{f"{k}_iterations": len(v) for k, v in iter_ms.items()},
               **{f"{k}_iter_ms_median": statistics.median(v)
                  for k, v in iter_ms.items() if v},
               output_tokens=out_tokens,
               output_tokens_per_s=out_tokens / wall, wall_s=wall,
               spec_proposed=engine.spec_proposed,
               spec_accepted=engine.spec_accepted,
               acceptance=(engine.spec_accepted / engine.spec_proposed
                           if engine.spec_proposed else 0.0),
               bytes_per_token=stats.bytes_per_token,
               prefix_hit_tokens=stats.prefix_hit_tokens,
               preemptions=engine.preemptions,
               swapped_in_pages=engine.pool.stats["swapped_in"],
               h2d_events=engine.h2d_events, d2h_events=engine.d2h_events,
               kernel_launches=launches, tc_launches=tc_launches,
               split_launches=split_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print(f"serve: yi-6b 32 layers bf16, kv {kv_dtype}, spec_k={spec_k}, "
          f"{n_req} requests: "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in row.items()), flush=True)
    return row, {rid: res.tokens for rid, res in results.items()}, dict(
        iters=iters, rows=engine.tracer.drain(), ecfg=ecfg)


# ------------------------------------------------------ phases 4 and 13 --
def phase_draft_parity(models, k: int = 4) -> dict:
    """Phase 4's bfloat16 weights as a ``DraftModelDrafter`` on the card
    (every self-attention on the tensor-core flash kernel, the plain
    version none) and on the CPU (the plain version), from one random
    context of ``DRAFT_CTX`` tokens (bucketed inside phase 13's draft
    lengths): the logits after the context must agree
    (``logits_agree``) and the ``k`` proposals must be equal but for a
    near-tie (``excuse_first_flip``)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.runtime import DraftModelDrafter, SamplingParams
    from repro_torch.runtime.speculative import _last_logits
    cfg, cpu_model, gpu_model = models
    dtype = getattr(torch, cfg.param_dtype)
    rng = np.random.default_rng(4)
    ctx = rng.integers(0, cfg.vocab_size, DRAFT_CTX).tolist()
    drafters = [DraftModelDrafter(cfg, m, target_vocab=cfg.vocab_size)
                for m in (gpu_model, cpu_model)]
    counters = (FK.launches, FK.tc_launches, FO.plain_forwards)
    before = [c.n for c in counters]
    a = drafters[0].propose(ctx, k)
    got = tuple(c.n - n0 for c, n0 in zip(counters, before))
    want = (cfg.num_layers * k, cfg.num_layers * k, 0)
    check(got == want, f"draft parity: flash (launches, tensor-core, plain "
                       f"forwards) {got}, want {want}")
    b = drafters[1].propose(ctx, k)

    def rows_at(c):
        toks = list(c) + [0] * (-len(c) % drafters[0].bucket
                                or drafters[0].bucket)
        return [_last_logits(cfg, m, torch.tensor([toks], device=dev),
                             len(c))
                for m, dev in ((gpu_model, "cuda"), (cpu_model, "cpu"))]

    diff, gate = logits_agree(rows_at(ctx), dtype, "draft parity")
    excused = excuse_first_flip("draft parity", ctx, a, b, rows_at,
                                SamplingParams(), dtype)
    S = DRAFT_CTX + (-DRAFT_CTX % drafters[0].bucket)
    print(f"draft parity: yi-6b widths x {cfg.num_layers} layers "
          f"{cfg.param_dtype}, context {DRAFT_CTX} (S={S}), {k} proposals "
          f"CUDA {a} CPU {b}, flash tensor-core launches {got[1]}, logit "
          f"diff {diff:.3g} <= {gate:.3g}, excused={int(excused)}",
          flush=True)
    return dict(S=S, logit_diff=diff, logit_gate=gate, excused=excused)


def phase_prng_bits():
    """The port's threefry draws for 8 keys x V=64,000 on the card against
    the CPU's: keys, bits and uniforms bit for bit, Gumbel draws within
    1e-6 (their logarithms are each device's)."""
    from repro_torch.runtime import prng
    lanes = torch.arange(8)
    keys = prng.fold_in(prng.prng_key(lanes * 7919 + 100), lanes * 131)
    V = 64000
    for name, fn in (("random_bits", prng.random_bits),
                     ("uniform", prng.uniform)):
        cpu, gpu = fn(keys, V), fn(keys.cuda(), V).cpu()
        check(torch.equal(cpu, gpu), f"prng.{name}: CUDA != CPU")
    diff = (prng.gumbel(keys.cuda(), V).cpu()
            - prng.gumbel(keys, V)).abs().max().item()
    check(diff <= 1e-6, f"prng.gumbel: CUDA vs CPU max |diff| {diff:.3g}")
    print(f"prng: 8 keys x V={V}: random_bits and uniform bit-equal on CUDA "
          f"and CPU, gumbel max |diff| {diff:.3g}", flush=True)


class RecordingDrafter:
    """Wraps a drafter and records each proposal as (rid, context length,
    drafts), the rid found by the prompt the context starts with, and the
    host seconds of each proposal per draft token (each token is read
    back, so they include the device's)."""

    def __init__(self, inner, prompts: dict):
        self.inner, self.prompts = inner, prompts
        self.calls = []
        self.seconds = []

    def propose(self, ctx, k):
        t = time.perf_counter()
        drafts = self.inner.propose(ctx, k)
        self.seconds.append((time.perf_counter() - t) / max(len(drafts), 1))
        rid = next(rid for rid, p in self.prompts.items()
                   if tuple(ctx[:len(p)]) == p)
        self.calls.append((rid, len(ctx), list(drafts)))
        return drafts


def sampler_cost(timer: Timer, vocab: int) -> dict:
    """One token selection at a decode iteration's shape (8 lanes x
    ``vocab`` float32 logits): the sampler with every other lane sampling
    (temperature 0.8, top-k 40, top-p 0.95), and an all-greedy
    iteration's argmax.  For each: ms between CUDA events around the call
    (``Timer``; with hundreds of launches the device waits on the host's
    enqueue in between), and under ``torch.profiler`` its device launches
    and busy ms (the sum of their durations)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.server import _select
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((8, vocab), generator=g, device="cuda") * 3
    lanes = torch.arange(8, device="cuda")
    sampling = (lanes.long() * 7919 + 100,
                torch.where(lanes % 2 == 1, 0.8, 0.0).float(),
                torch.full((8,), 40, dtype=torch.int32, device="cuda"),
                torch.full((8,), 0.95, device="cuda"))
    pos = torch.full((8,), 700, dtype=torch.int32, device="cuda")
    out = {}
    for name, smp in (("sampled", sampling), ("greedy", None)):
        def fn():
            return _select(logits, pos, smp)
        ms = timer.ms(fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out[f"{name}_select_ms"] = ms
        out[f"{name}_select_busy_ms"] = sum(
            e.device_time_total for e in kernels) / 1e3
        out[f"{name}_select_launches"] = len(kernels)
    return out


def phase_frontdoor(cfg, model, phase5: dict, timer: Timer) -> dict:
    """Phase 5's engine and requests at full width with ``spec_k=4`` and a
    ``DraftModelDrafter`` drafting with the target's own weights, served
    through ``FrontDoor`` on the engine's ``MonotonicClock`` with seeded
    exponential arrivals (mean gap 0.05 s); odd rids sample (temperature
    0.8, top-k 40, top-p 0.95, seed 100 + rid).  The tensor-core flash
    kernel must carry every draft forward and the paged kernels every
    layer of every iteration; sampling lanes must never draft; at least
    80% of the drafts must be accepted; a replay of the same schedule
    (on a ``VirtualClock``, each request submitted at the iteration it
    was) must give the same streams; greedy rids must give phase 5's
    tokens but for near-ties (``flip_margin``: the chunk path a verify
    step takes against the decode path phase 5 took)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.runtime import (
        Arrival, DraftModelDrafter, FrontDoor, GenerationRequest,
        MonotonicClock, SamplingParams, VirtualClock, latency_report,
        make_engine,
    )
    from repro_torch.runtime import server as S
    from repro_torch.runtime.speculative import _last_logits
    t_phase = time.perf_counter()
    ecfg, base = serve_workload(cfg, spec_k=4)
    requests = [GenerationRequest(r.rid, r.prompt, sampling_for(
        r.rid, True, top_p=0.95, max_new=32)) for r in base]
    prompts = {r.rid: r.prompt for r in requests}
    gaps = np.random.default_rng(3).exponential(0.05, len(requests))

    def serve(clock, times, iter_time_s=0.0):
        drafter = RecordingDrafter(DraftModelDrafter(
            cfg, model, target_vocab=cfg.vocab_size), prompts)
        engine = make_engine(cfg, model, dataclasses.replace(
            ecfg, drafter=drafter, clock=clock))
        kinds, submitted = [], {}
        step, submit = engine.step, engine.submit

        def counted_step():
            before = (engine.prefill_tokens, engine.spec_iterations,
                      engine.iterations)
            busy = step()
            if engine.iterations > before[2]:
                kinds.append(
                    "prefill" if engine.prefill_tokens > before[0] else
                    "verify" if engine.spec_iterations > before[1] else
                    "decode")
            return busy

        def recorded_submit(req):
            submitted[req.rid] = engine.iterations
            submit(req)

        engine.step, engine.submit = counted_step, recorded_submit
        t0 = clock.now()
        arrivals = [Arrival(t=t0 + float(t), request=r)
                    for t, r in zip(times, requests)]
        records = FrontDoor(engine, iter_time_s=iter_time_s).serve(arrivals)
        torch.cuda.synchronize()
        return engine, drafter, records, kinds, submitted

    # a server warms up before it takes traffic: the first draft forward
    # of the process loads the flash kernel and the full-sequence GEMMs'
    # kernels (over a second, once)
    t = time.perf_counter()
    DraftModelDrafter(cfg, model).propose(requests[1].prompt, 1)
    warmup_s = time.perf_counter() - t
    counters = (K.launches, K.int8_launches, K.tc_launches, K.split_launches,
                R.calls, FK.launches, FK.tc_launches, FO.plain_forwards,
                S.sampler_calls)
    for c in counters:
        c.reset()
    engine, drafter, records, kinds, submitted = serve(
        MonotonicClock(), np.cumsum(gaps))
    (launches, int8_launches, tc_launches, split_launches, plain_calls,
     flash, flash_tc, flash_plain, sampler) = (c.n for c in counters)
    results = {r.rid: r for r in engine.finished}
    L_ = cfg.num_layers
    check(len(results) == len(requests) and all(
        r.finish_reason == "length" and len(r.tokens) == 32
        and all(0 <= t < cfg.vocab_size for t in r.tokens)
        for r in results.values()), "phase 13: a request did not finish "
                                    "with 32 in-vocabulary tokens")
    n = {k: kinds.count(k) for k in ("prefill", "decode", "verify")}
    check(launches == L_ * engine.iterations
          and tc_launches == L_ * (n["prefill"] + n["verify"])
          and split_launches == L_ * n["decode"]
          and int8_launches == plain_calls == 0,
          f"phase 13: paged launches {launches} (tensor cores "
          f"{tc_launches}, split-KV {split_launches}, int8 "
          f"{int8_launches}, plain {plain_calls}) for {L_} layers x {n}")
    forwards = sum(len(d) for _, _, d in drafter.calls)
    check(forwards > 0 and flash == flash_tc == L_ * forwards
          and flash_plain == 0,
          f"phase 13: flash launches {flash} (tensor cores {flash_tc}, "
          f"plain {flash_plain}) for {L_} layers x {forwards} draft "
          "forwards")
    check(sampler > 0, "phase 13: the sampler never ran")
    sampled_drafts = [c for c in drafter.calls if c[0] % 2]
    check(not sampled_drafts and all(
        results[rid].spec_proposed == 0 for rid in prompts if rid % 2),
        f"phase 13: sampling lanes drafted {sampled_drafts[:3]}")
    acceptance = engine.spec_accepted / max(engine.spec_proposed, 1)
    check(engine.spec_proposed > 0 and acceptance >= 0.8,
          f"phase 13: self-draft accepted {engine.spec_accepted} of "
          f"{engine.spec_proposed}")
    for rid, n_ctx, drafts in drafter.calls:
        toks = list(results[rid].tokens)
        o = n_ctx - len(prompts[rid])
        m = next((i for i, (d, t) in enumerate(zip(drafts, toks[o:]))
                  if d != t), None)
        if m is None:
            continue
        ctx = list(prompts[rid]) + toks[:o + m]
        pad = [0] * (-len(ctx) % 32 or 32)
        top2 = torch.topk(_last_logits(cfg, model, torch.tensor(
            [ctx + pad], device="cuda"), len(ctx)).double(), 2).values
        print(f"frontdoor: rid {rid} position {len(ctx)}: draft "
              f"{drafts[m]} rejected for {toks[o + m]}, the draft's top-2 "
              f"margin {(top2[0] - top2[1]).item():.4g}", flush=True)
    report = latency_report(records, slo_ttft_s=1.0, slo_tpot_s=0.1)
    out_tokens = sum(r.tokens for r in records.values())
    span = max(r.finish_t for r in records.values()) - \
        min(r.arrive_t for r in records.values())

    # the same schedule again: each request submitted at the iteration it
    # was, on a virtual clock charged one second an iteration
    order = [float(submitted[r.rid]) for r in requests]
    replay, _, _, replay_kinds, _ = serve(VirtualClock(), order, 1.0)
    again = {r.rid: r.tokens for r in replay.finished}
    check(replay_kinds == kinds and again == {
        rid: r.tokens for rid, r in results.items()},
        "phase 13: the replayed schedule changed a stream")

    # greedy rids against phase 5: a token may come from a decode step
    # (split-KV kernel) in one run and from a chunk or verify step
    # (tensor-core kernel) in the other, so a flip is excused at a near-tie
    # between the two paths.  Both rows are computed with the same context:
    # the context but its last token is served first (its full pages enter
    # the prefix cache), then the whole context with the chunk cut to 1
    # (the decode path) or to 5 (a verify step's width), so only the
    # tokens past its last full page run, through the path's kernel
    plain = dataclasses.replace(ecfg, spec_k=0)

    def row_at(ctx: tuple, chunk: int) -> torch.Tensor:
        e = make_engine(cfg, model, plain)
        e.submit(GenerationRequest(0, ctx[:-1], SamplingParams(max_new=1)))
        e.run()
        e.chunk = chunk
        e.submit(GenerationRequest(1, ctx, SamplingParams(max_new=1)))
        hit = e.run()[-1].prefix_hit_tokens
        check(hit >= len(ctx) - 16, f"phase 13: the rerun reused {hit} of "
                                    f"{len(ctx)} tokens")
        return e.last_logits[0]

    excused = 0
    for rid in sorted(prompts):
        if rid % 2:
            continue
        a, b = list(results[rid].tokens), list(phase5[rid])
        check(a[:1] == b[:1], f"phase 13: rid {rid}'s first token differs")
        excused += excuse_first_flip(
            f"frontdoor: rid {rid} vs phase 5", prompts[rid], a, b,
            lambda ctx: [row_at(ctx, 5), row_at(ctx, 1)], SamplingParams(),
            getattr(torch, cfg.param_dtype))
    # the draft forwards' bucketed lengths, for phase 9's cases
    bucket = drafter.inner.bucket
    lengths = sorted({n + i + (-(n + i) % bucket or bucket)
                      for _, n, d in drafter.calls for i in range(len(d))})
    row = dict(
        requests=len(requests), iterations=engine.iterations,
        **{f"{k}_iterations": v for k, v in n.items()},
        output_tokens=out_tokens, output_tokens_per_s=out_tokens / span,
        span_s=span, **{k: report[k] for k in (
            "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
            "slo_goodput")},
        spec_proposed=engine.spec_proposed,
        spec_accepted=engine.spec_accepted, acceptance=acceptance,
        draft_warmup_s=warmup_s, draft_forwards=forwards, draft_s=sum(
            t * len(c[2]) for t, c in zip(drafter.seconds, drafter.calls)),
        draft_ms_per_forward_median=1e3 * statistics.median(drafter.seconds),
        draft_ms_per_forward_max=1e3 * max(drafter.seconds),
        draft_ms_per_forward_first=1e3 * drafter.seconds[0],
        flash_tc_launches=flash_tc, draft_lengths=lengths,
        paged_launches=launches, tc_launches=tc_launches,
        split_launches=split_launches, sampler_calls=sampler,
        excused_vs_phase5=excused, **sampler_cost(timer, cfg.vocab_size),
        phase_s=time.perf_counter() - t_phase)
    print("frontdoor: yi-6b 32 layers bf16, spec_k=4 self-draft, 12 "
          "requests (odd rids sampled): "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in row.items()), flush=True)
    return row


# -------------------------------------------------------------- phase 14 --
def tier_waves(cfg) -> tuple:
    """Phase 14's traffic: phase 5's 12 requests, then 12 requests of
    other prompts (300-700 tokens, 8 new tokens each) that evict their
    prefixes, then phase 5's prompts again (8 new tokens each), whose
    prefixes come back from the host and disk tiers."""
    from repro_torch.runtime import GenerationRequest, SamplingParams
    _, first = serve_workload(cfg)
    rng = np.random.default_rng(5)
    evict = [GenerationRequest(100 + i, tuple(rng.integers(
        0, cfg.vocab_size, int(rng.integers(300, 701))).tolist()),
        SamplingParams(max_new=8)) for i in range(12)]
    again = [GenerationRequest(200 + r.rid, r.prompt,
                               SamplingParams(max_new=8)) for r in first]
    return first, evict, again


#: phase 14's tiers: a 384-page pool (1 MiB pages at yi-6b's width, page
#: 16), about the 8 lanes' lifetime reservations, so evictions spill into
#: a 96-page host tier that cascades into a 512-page disk tier
TIER_FULL = dict(num_pages=384, host_tier_pages=96, disk_tier_pages=512)
#: its transient fault rate (io, retried in place)
TIER_FULL_RATE = 0.05


def tier_move_costs(cfg, device: str = "cuda", reps: int = 20) -> dict:
    """Host ms (medians of ``reps``) of the parts of one page's tier
    moves at ``cfg``'s width (bf16, page 16): the D2H pull and the H2D
    upload the engine makes (``server._to_host``, ``_from_host`` of the
    stacked pages, each with a device sync), the CRC32 the store takes
    of it, and a ``DiskTier`` write and read of it (one raw-bytes file in
    an owned temp dir)."""
    import zlib
    from repro_torch.core.offload import DiskTier
    from repro_torch.runtime.server import _from_host, _to_host
    L_, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    page = torch.randn((L_, 2, 16, kv, hd), device=device).to(
        torch.bfloat16)
    tier = DiskTier()
    times = {k: [] for k in ("d2h", "crc32", "disk_write", "disk_read",
                             "h2d")}

    def clock(name, fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t))
        return out
    try:
        for i in range(reps):
            arr = clock("d2h", lambda: _to_host(page))
            clock("crc32", lambda: zlib.crc32(arr.tobytes()))
            clock("disk_write", lambda: tier.store(("cache", i), arr))
            back = clock("disk_read", lambda: tier.load(("cache", i)))
            # the engine's upload path: its pages stacked into one array
            clock("h2d", lambda: _from_host(np.stack([back], axis=1),
                                            torch.bfloat16,
                                            torch.device(device)))
            tier.delete(("cache", i))
    finally:
        tier.close()
    return {f"{k}_ms": statistics.median(v) for k, v in times.items()} | {
        "page_bytes": page.numel() * page.element_size()}


def phase_tiers(cfg, model, device: str = "cuda") -> dict:
    """The tiered prefix cache and fault handling at full width: three
    runs of ``tier_waves`` (rid 1 preempted at 8 tokens) on phase 5's
    engine cut to ``TIER_FULL`` with an owned temp directory for the
    disk tier: fault-free; under a seeded rate of transient I/O faults,
    which must give the fault-free tokens; and with a persistent put
    fault planned at rid 1's preemption as well, which must end rid 1
    alone in ``"error"`` and every other request by its length, with
    ``assert_faults_contained`` and ``assert_tier_conservation`` holding
    on its trace.  Every run must hit the host and the disk tier, and the
    bf16 pool's kernels must carry every layer of every iteration (their
    counts read from 0 around the three runs).  Then the parts of one
    page's tier move, timed alone (``tier_move_costs``)."""
    from repro_torch.core.analysis import (
        assert_faults_contained, assert_tier_conservation, layer1_decode,
    )
    from repro_torch.core.tracing import TraceBuffer
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, FaultInjector, FaultSpec, make_engine,
    )
    t_phase = time.perf_counter()
    base, _ = serve_workload(cfg)
    # a new spec, not a replace: the spec mirrors its cache knobs in flat
    # fields, which a replace would fold back over the new cache
    ecfg = EngineConfig(
        cache=CacheConfig(page_size=base.cache.page_size,
                          max_pages_per_seq=base.cache.max_pages_per_seq,
                          **TIER_FULL),
        max_lanes=base.max_lanes, chunk=base.chunk, swap_retries=4)
    waves = tier_waves(cfg)
    n_req = sum(len(w) for w in waves)
    kinds: list = []

    def run(rate: float, persistent: bool) -> dict:
        inj = FaultInjector(seed=11, rate=rate, kinds=(FaultSpec("io"),))
        engine = make_engine(cfg, model, dataclasses.replace(
            ecfg, fault_injector=inj), tracer=TraceBuffer(),
            device=device)
        spent = {"demote": 0.0, "promote": 0.0}

        def timed(name, fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[name] += time.perf_counter() - t
            return call

        # host time of the tier moves: the D2H pull and park of demoted
        # pages; the fetch (host or disk, CRC) and H2D upload of promoted
        engine._drain_tier_ops = timed("demote", engine._drain_tier_ops)
        engine._resolve_spilled_hits = timed("promote",
                                             engine._resolve_spilled_hits)
        engine._begin_promotion = timed("promote", engine._begin_promotion)
        tokens = {}
        iter_ms = {"prefill": [], "decode": []}
        t0 = time.perf_counter()
        try:
            for w, wave in enumerate(waves):
                for r in wave:
                    engine.submit(r)
                    tokens[r.rid] = []
                preempted = w > 0
                while True:
                    before = engine.prefill_tokens
                    t = time.perf_counter()
                    busy = engine.step()
                    dt = (time.perf_counter() - t) * 1e3
                    if not busy:
                        break
                    kind = "prefill" if engine.prefill_tokens > before \
                        else "decode"
                    iter_ms[kind].append(dt)
                    kinds.append(kind)
                    for d in engine.poll_deltas():
                        tokens[d.rid].extend(d.tokens)
                    if not preempted and len(tokens[1]) >= 8:
                        if persistent:
                            inj.plan[inj.ops] = FaultSpec(
                                "io", op="put", persistent=True)
                        check(engine.preempt(1), "forced preemption missed")
                        preempted = True
                for d in engine.poll_deltas():
                    tokens[d.rid].extend(d.tokens)
            wall = time.perf_counter() - t0
            st = engine.cache_stats()
            events = layer1_decode(engine.tracer.drain())
            engine.pool.check_invariants()
            engine.backing.check_invariants()
            results = {r.rid: r for r in engine.finished}
        finally:
            engine.close()
        check(len(results) == n_req, f"phase 14: {len(results)} of {n_req} "
                                     "requests finished")
        check(st.hits_host_pages > 0 and st.hits_disk_pages > 0,
              f"phase 14: tier hits host {st.hits_host_pages}, disk "
              f"{st.hits_disk_pages}: {st}")
        check(assert_faults_contained(events),
              "phase 14: a faulted request was lost")
        check(assert_tier_conservation(events),
              "phase 14: a tier move contradicted the residency")
        for rid, res in results.items():
            check(list(res.tokens) == tokens[rid],
                  f"phase 14: rid {rid}: streamed deltas != result tokens")
        return dict(
            tokens=tokens, wall_s=wall, faults=inj.report(),
            reasons={rid: r.finish_reason for rid, r in results.items()},
            errors=engine.errors, fault_retries=engine.fault_retries,
            recovered_faults=engine.recovered_faults,
            iterations=engine.iterations, stats=st, spent=spent,
            iter_ms=iter_ms, prefill_tokens=engine.prefill_tokens)

    counters = (K.launches, K.int8_launches, K.tc_launches,
                K.split_launches, R.calls)
    for c in counters:
        c.reset()
    clean = run(0.0, False)
    transient = run(TIER_FULL_RATE, False)
    faulted = run(TIER_FULL_RATE, True)
    launches, int8_launches, tc, split, plain = (c.n for c in counters)
    L_ = cfg.num_layers
    iterations = sum(r["iterations"] for r in (clean, transient, faulted))
    if device == "cuda":
        check(launches == L_ * iterations
              and tc == L_ * kinds.count("prefill")
              and split == L_ * kinds.count("decode")
              and int8_launches == plain == 0,
              f"phase 14: paged launches {launches} (tensor cores {tc}, "
              f"split-KV {split}, int8 {int8_launches}, plain {plain}) for "
              f"{L_} layers x {iterations} iterations")
    check(all(r == "length" for r in clean["reasons"].values())
          and all(r == "length" for r in transient["reasons"].values()),
          "phase 14: a request of a run without persistent faults did "
          "not finish by its length")
    check(transient["faults"]["injected"] > 0
          and transient["recovered_faults"] > 0
          and transient["errors"] == 0,
          f"phase 14: transient faults {transient['faults']}, recovered "
          f"{transient['recovered_faults']}, errors {transient['errors']}")
    check(transient["tokens"] == clean["tokens"],
          "phase 14: transient faults changed a token")
    errs = sorted(rid for rid, r in faulted["reasons"].items()
                  if r == "error")
    check(errs == [1] and faulted["errors"] == 1
          and faulted["faults"]["persistent_sites"] == 1,
          f"phase 14: errors {errs} (only the planned rid 1 may fail)")
    check(all(r == "length" for rid, r in faulted["reasons"].items()
              if rid != 1), "phase 14: a survivor did not finish by its "
                            "length")
    out = {}
    for name, r in (("clean", clean), ("transient", transient),
                    ("faulted", faulted)):
        st = r["stats"]
        row = dict(
            iterations=r["iterations"], wall_s=r["wall_s"],
            prefill_iterations=len(r["iter_ms"]["prefill"]),
            decode_iterations=len(r["iter_ms"]["decode"]),
            prefill_iter_ms_median=statistics.median(
                r["iter_ms"]["prefill"]),
            decode_iter_ms_median=statistics.median(r["iter_ms"]["decode"]),
            hits_device_pages=st.hits_device_pages,
            hits_host_pages=st.hits_host_pages,
            hits_disk_pages=st.hits_disk_pages, miss_pages=st.miss_pages,
            demoted_pages=st.demoted_pages,
            promoted_pages=st.promoted_pages,
            bytes_demoted=st.bytes_demoted,
            bytes_promoted=st.bytes_promoted,
            dropped_entries=st.dropped_entries,
            host_ms_per_demoted_page=1e3 * r["spent"]["demote"]
            / max(st.demoted_pages, 1),
            host_ms_per_promoted_page=1e3 * r["spent"]["promote"]
            / max(st.promoted_pages, 1),
            injected=r["faults"]["injected"],
            fault_retries=r["fault_retries"],
            recovered_faults=r["recovered_faults"], errors=r["errors"])
        print(f"tiers {name}: yi-6b 32 layers bf16, {n_req} requests, "
              f"pool {TIER_FULL['num_pages']} pages of "
              f"{st.bytes_per_token * 16 / 2**20:.2f} MiB, host "
              f"{TIER_FULL['host_tier_pages']}, disk "
              f"{TIER_FULL['disk_tier_pages']}: "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in row.items()),
              flush=True)
        out[name] = row
    out.update(paged_launches=launches, tc_launches=tc,
               split_launches=split,
               phase_s=time.perf_counter() - t_phase)
    print(f"tiers: paged launches {launches} (tensor cores {tc}, split-KV "
          f"{split}) over {iterations} iterations in "
          f"{out['phase_s']:.2f} s", flush=True)
    parts = tier_move_costs(cfg, device)
    print("tiers: one page's move, host ms (median of 20): " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in parts.items()), flush=True)
    out["move_costs"] = parts
    return out


# -------------------------------------------------------------- phase 15 --
#: phase 15's peak measurements: a device-to-device copy of 1 GiB (read
#: once, written once) and a bf16 product of 8192^3
PEAK_COPY_BYTES = 1 << 30
PEAK_GEMM = 8192


def measure_peaks(timer: Timer) -> dict:
    """The card's HBM byte rate (a 1 GiB ``copy_``: 2 GiB moved) and its
    bf16 tensor-core rate (``torch.matmul`` at 8192^3), from median
    CUDA-event times (``Timer``)."""
    src = torch.ones(PEAK_COPY_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = timer.ms(lambda: dst.copy_(src), reps=10)
    check(torch.equal(dst, src), "phase 15: the copy is wrong")
    del src, dst
    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn((PEAK_GEMM, PEAK_GEMM), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    gemm_ms = timer.ms(lambda: a @ b, reps=10)
    del a, b
    torch.cuda.empty_cache()
    return dict(copy_ms=copy_ms, gemm_ms=gemm_ms,
                hbm_bytes_per_s=2 * PEAK_COPY_BYTES / (copy_ms / 1e3),
                bf16_flops_per_s=2 * PEAK_GEMM ** 3 / (gemm_ms / 1e3))


#: phase 15's load: ``load_gen``'s default workload (16 requests at 50 per
#: virtual second, prompts 8-24, 2-8 new tokens, 4 lanes, chunk 8, a
#: 12-token budget, 0.01 virtual s an iteration) on pages of 16
LOAD_PAGE = 16


def phase_planner(cfg, model, phase5: dict, peaks: dict, smi: str,
                  device: str = "cuda") -> dict:
    """The planner and the load generator on the card: ``load_gen``'s
    workload served by the full-width engine through the front door on a
    ``VirtualClock``, and ``planner.simulate`` on the same
    ``WorkloadSpec`` and engine spec, which must give its iterations,
    virtual duration, TTFT/TPOT percentiles and goodput exactly (the
    paged kernels must carry every layer of every iteration); then
    ``Calibration.from_trace`` on phase 5's trace and the
    ``AnalyticCostModel``'s predicted prefill and decode iteration ms at
    the measured peaks beside phase 5's measured medians (recorded, not
    gated)."""
    from repro_torch.core.analysis import layer1_decode
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.launch import load_gen, mesh
    from repro_torch.planner import (
        AnalyticCostModel, Calibration, FixedIterationCost, IterationStats,
        WorkloadSpec, simulate,
    )
    spec = WorkloadSpec(rate_rps=50.0, requests=16, prompt_min=8,
                        prompt_max=24, output_min=2, output_max=8, seed=0)
    knobs = dict(page_size=LOAD_PAGE, max_lanes=4, chunk=8,
                 token_budget=12)
    iter_time_s, slo = 0.01, dict(slo_ttft_s=0.25, slo_tpot_s=0.05)
    counters = (K.launches, K.tc_launches, K.split_launches, R.calls)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    served = load_gen.run_load_gen(cfg=cfg, params=model, spec=spec,
                                   iter_time_s=iter_time_s, device=device,
                                   **knobs, **slo)
    serve_s = time.perf_counter() - t
    launches, tc, split, plain = (c.n for c in counters)
    arrivals = spec.sample_arrivals(cfg.vocab_size)
    longest = max(len(a.prompt) + a.max_new for a in arrivals)
    t = time.perf_counter()
    predicted = simulate(arrivals, load_gen.engine_config(longest, **knobs),
                         iteration_cost=FixedIterationCost(iter_time_s),
                         **slo)
    simulate_s = time.perf_counter() - t
    keys = ("requests", "completed", "iterations", "virtual_duration_s",
            "ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "tpot_p50_s",
            "tpot_p95_s", "tpot_p99_s", "slo_goodput")
    diff = {k: (served[k], predicted[k]) for k in keys
            if served[k] != predicted[k]}
    check(not diff, f"phase 15: simulate differs from the engine: {diff}")
    L_ = cfg.num_layers
    if device == "cuda":
        check(launches == L_ * served["iterations"] and tc + split ==
              launches and tc > 0 and split > 0 and plain == 0,
              f"phase 15: paged launches {launches} (tensor cores {tc}, "
              f"split-KV {split}, plain {plain}) for {L_} layers x "
              f"{served['iterations']} iterations")
    print(f"planner: load_gen on yi-6b 32 layers bf16 ({serve_s:.2f} s) "
          f"== simulate ({1e3 * simulate_s:.2f} ms): "
          + " ".join(f"{k}={served[k]}" for k in keys)
          + f"; paged launches {launches} (tensor cores {tc}, split-KV "
            f"{split})", flush=True)

    # phase 5's iterations priced by the roofline at the measured peaks
    iters, ecfg = phase5["iters"], phase5["ecfg"]
    cost = AnalyticCostModel.for_engine(
        cfg, ecfg, peak_flops=peaks["bf16_flops_per_s"],
        hbm_bw=peaks["hbm_bytes_per_s"])
    row = {}
    for kind in ("prefill", "decode"):
        own = [it for it in iters if it["kind"] == kind]
        row[f"{kind}_iterations"] = len(own)
        row[f"{kind}_measured_ms_median"] = statistics.median(
            it["ms"] for it in own)
        row[f"{kind}_predicted_ms_median"] = statistics.median(
            1e3 * cost(IterationStats(
                prefill_tokens=it["prefill"], decode_lanes=it["decode"],
                spec_tokens=0, context_tokens=it["ctx"],
                active_clusters=1)) for it in own)
    median_s = statistics.median(it["ms"] for it in iters) / 1e3
    cal = Calibration.from_trace(layer1_decode(phase5["rows"]),
                                 iter_time_s=median_s)
    row.update(calibration_iter_time_s=cal.iter_time_s,
               mean_service_iters=cal.mean_service_iters,
               mean_queue_delay_iters=cal.mean_queue_delay_iters)
    print(f"planner: {smi}: measured hbm_bytes_per_s="
          f"{peaks['hbm_bytes_per_s']:.6g} (copy {peaks['copy_ms']:.4f} ms), "
          f"bf16_flops_per_s={peaks['bf16_flops_per_s']:.6g} (8192^3 "
          f"{peaks['gemm_ms']:.4f} ms); launch.mesh HBM_BW={mesh.HBM_BW:.6g} "
          f"PEAK_FLOPS_BF16={mesh.PEAK_FLOPS_BF16:.6g}", flush=True)
    print("planner: phase 5's iterations, AnalyticCostModel at the measured "
          "peaks vs measured: " + " ".join(
              f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
              for k, v in row.items()), flush=True)
    return dict(served={k: served[k] for k in keys}, paged_launches=launches,
                tc_launches=tc, split_launches=split, **row, **peaks)


# --------------------------------------------------------------- phase 7 --
def matmul_case(timer: Timer, m: int, k: int, n: int, dtype: torch.dtype,
                seed: int = 0, offset: bool = False) -> dict:
    """One case of phase 7: the cluster-matmul kernel (the branch its
    route picks, checked by the counts) against its plain version on A ~
    N(0, 1), B ~ N(0, 1/k) (an initialised weight's scale, so C is of unit
    scale and two valid float32 summation orders differ far below the
    bar), then timed beside the plain version and ``torch.matmul``, with
    its bytes, operations and roofline bound.  With ``offset`` A lies one
    element (4 bytes in float32, 2 in bfloat16) past a 16-byte boundary
    (same values), which routes it to the general branch.  A product on
    the general branch prints its tile and K splits (``general_plan``)
    and, in bfloat16, A's access width and K shift (``a_access``) and
    B's access width (``access_width``); the counts show whether it
    split."""
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.cluster_matmul import ref as CR
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    b = (torch.randn(k, n, generator=g, device="cuda")
         / math.sqrt(k)).to(dtype)
    if offset:
        a = torch.empty(m * k + 1, dtype=dtype, device="cuda")[1:] \
            .view(m, k).copy_(a)
    dt = str(dtype).replace("torch.", "")
    name = f"cluster_matmul {m}x{k}x{n} {dt}{' offset' if offset else ''}"
    branch = CK.route(dtype, m, k, n, aligned=not offset)
    if offset or dtype == torch.float32 or (m, k, n) in MATMUL_GENERAL_BF16 \
            or (m, k, n) in MATMUL_ODD_BF16:
        want = CK.GENERAL
    else:
        want = CK.WGMMA
    check(branch == want, f"{name}: routed to {branch}, want {want}")
    # bf16 on the general branch: A's (width, K shift), B's width
    widths = (CK.a_access(a.data_ptr(), 2 * k),
              CK.access_width(b.data_ptr(), 2 * n)) \
        if branch == CK.GENERAL and dtype == torch.bfloat16 else None
    tile, splits = CK.general_plan(m, k + (widths[0][1] if widths else 0),
                                   n, dtype) \
        if branch == CK.GENERAL else (0, 1)
    counters = (CK.launches, CK.wgmma_launches, CK.split_launches)
    before = [c.n for c in counters]
    out = CK.matmul(a, b)
    torch.cuda.synchronize()
    got = tuple(c.n - n0 for c, n0 in zip(counters, before))
    check(got == (1, int(branch == CK.WGMMA), int(splits > 1)),
          f"{name}: counts (all, wgmma, split) {got} do not show one "
          f"{branch} launch with {splits} splits")
    ref = CR.cluster_matmul_ref(a, b)
    err = (out.float() - ref.float()).abs().max().item()
    tol = MATMUL_TOL[dtype]
    check(out.dtype == dtype and tuple(out.shape) == (m, n),
          f"{name}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()),
          f"{name}: non-finite kernel output")
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"{name}: kernel vs plain max |err| {err}")
    ms = timer.ms(lambda: CK.matmul(a, b))
    plain_ms = timer.ms(lambda: CR.cluster_matmul_ref(a, b), reps=5)
    library_ms = timer.ms(lambda: torch.matmul(a, b))
    nbytes = (m * k + k * n + m * n) * a.element_size()
    flops = 2 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(m=m, k=k, n=n, dtype=dt, offset=offset, branch=branch,
               tile=tile, splits=splits, widths=widths, launches=got,
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bytes=nbytes,
               flops=flops, bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               share_of_bound=bound_ms / ms,
               tflops=flops / (ms * 1e-3) / 1e12)
    print(f"kernel {name}: branch={branch} tile={tile} splits={splits} "
          f"widths((a, shift), b)={widths} "
          f"launches(all, wgmma, split)={got} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bytes={nbytes} flops={flops} "
          f"bound_ms={bound_ms:.5f} ({row['bound_by']}) "
          f"share_of_bound={row['share_of_bound']:.4f} "
          f"tflops={row['tflops']:.2f} max_abs_err={err:.3g} tol={tol}",
          flush=True)
    return row


def phase_matmul(timer: Timer) -> list:
    return [matmul_case(timer, m, k, n, dtype)
            for (m, k, n) in MATMUL_SHAPES
            for dtype in (torch.float32, torch.bfloat16)] + [
        matmul_case(timer, m, k, n, torch.float32, offset=True)
        for (m, k, n) in MATMUL_OFFSET_F32] + [
        matmul_case(timer, m, k, n, torch.bfloat16, offset=True)
        for (m, k, n) in MATMUL_OFFSET_BF16 + MATMUL_DEEP_BF16] + [
        matmul_case(timer, m, k, n, torch.bfloat16)
        for (m, k, n) in MATMUL_ODD_BF16]


# --------------------------------------------------------------- phase 8 --
def offload_pair(dtype: torch.dtype, size: int = 4096, seed: int = 1
                 ) -> dict:
    """Copy mode then zero-copy mode of one ``size``^2 cluster matmul
    through ``OffloadTarget`` on the card; the two outputs must be equal
    (one deterministic kernel on the same inputs) and the traced protocol
    complete.  bfloat16 host arrays are CPU tensors (numpy has no
    bfloat16)."""
    from repro_torch.core import OffloadTarget, TraceBuffer
    from repro_torch.core.analysis import layer1_decode
    from repro_torch.kernels.cluster_matmul import cluster_matmul
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((size, size), dtype=np.float32)
    b = rng.standard_normal((size, size), dtype=np.float32) / np.float32(
        math.sqrt(size))
    host = (a, b) if dtype == torch.float32 else \
        tuple(torch.from_numpy(x).to(dtype) for x in (a, b))
    tgt = OffloadTarget(tracer=TraceBuffer())
    out_c, rep_c = tgt.run_copy_based(cluster_matmul, *host)
    handles = [tgt.svm.share(torch.as_tensor(x).to(tgt.device))
               for x in host]
    out_h, rep_z = tgt.run_zero_copy(cluster_matmul, *handles)
    zero = tgt.svm.deref(out_h)
    dt = str(dtype).replace("torch.", "")
    elt = torch.finfo(dtype).bits // 8
    check(torch.equal(torch.as_tensor(out_c), zero.cpu()),
          f"offload {size}^2 {dt}: copy-mode output != zero-copy output")
    check((rep_c.bytes_to, rep_c.bytes_from)
          == (2 * size * size * elt, size * size * elt),
          f"offload {size}^2 {dt}: bytes {rep_c.bytes_to}, "
          f"{rep_c.bytes_from}")
    n_events = len(layer1_decode(tgt.tracer.drain()))
    check(n_events == 10, f"offload {size}^2 {dt}: {n_events} events")
    rows = {}
    for rep in (rep_c, rep_z):
        rows[rep.mode] = dict(
            offload_ms=rep.offload_s * 1e3, kernel_ms=rep.kernel_s * 1e3,
            writeback_ms=rep.writeback_s * 1e3, total_ms=rep.total_s * 1e3,
            bytes_to=rep.bytes_to, bytes_from=rep.bytes_from)
        print(f"offload {size}^2 {dt} {rep.mode}: "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in rows[rep.mode].items()),
              flush=True)
    return dict(size=size, dtype=dt, zero=zero,
                inputs=[tgt.svm.deref(h) for h in handles], **rows)


def offload_counts(dtype: torch.dtype, size: int) -> tuple:
    """The (launches, wgmma, split) counts one offload run of a
    ``size``^2 product must add: two launches (copy mode, zero-copy), on
    the branch the route picks for aligned bases (tensors fresh from the
    allocator) and, on the general branch, split as its plan says."""
    from repro_torch.kernels.cluster_matmul import kernel as CK
    branch = CK.route(dtype, size, size, size)
    split = branch == CK.GENERAL \
        and CK.general_plan(size, size, size, dtype)[1] > 1
    return (2, 2 * (branch == CK.WGMMA), 2 * split)


def phase_offload(smi: str) -> dict:
    """The offload path on the card: the demo, then 4096^2 in float32 and
    bfloat16, then 127^2 in float32 and bfloat16; the kernel's counts are
    read from 0 just before and just after, and must be two per run (on
    the wgmma branch for 4096^2 bfloat16, the general one for the rest:
    unsplit on 128 x 128 tiles for 4096^2 float32, with K split over
    blocks for the demo's 256^2 and 127^2 float32, whose grids are under
    a wave; 127^2 bfloat16 on the tensor cores, unsplit (4 K tiles of
    32), both operands through registers, their rows no whole 4-byte
    words) with the plain version never called; then
    each run's output is held against the plain version.  Then Fig.5 on
    the card and Fig.6 on the host."""
    from repro_torch.hero import (fig5_svm_offload, fig6_event_tracing,
                                  svm_offload_demo)
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.cluster_matmul import ref as CR
    counters = (CK.launches, CK.wgmma_launches, CK.split_launches)
    for counter in counters + (CR.calls,):
        counter.reset()
    rep_c, rep_z, (a, b), demo_out = svm_offload_demo.main()
    got = tuple(c.n for c in counters)
    want = offload_counts(torch.float32, 256)
    check(got == want, f"demo: (launches, wgmma, split) {got}, want "
                       f"{want}")
    demo = dict(size=256, dtype="float32", zero=demo_out,
                inputs=[torch.from_numpy(x).cuda() for x in (a, b)],
                copy_total_ms=rep_c.total_s * 1e3,
                zero_copy_total_ms=rep_z.total_s * 1e3, launches=got)
    pairs = []
    for dtype, size in ((torch.float32, 4096), (torch.bfloat16, 4096),
                        (torch.float32, 127), (torch.bfloat16, 127)):
        before = [c.n for c in counters]
        pairs.append(offload_pair(dtype, size))
        got = tuple(c.n - n0 for c, n0 in zip(counters, before))
        want = offload_counts(dtype, size)
        check(got == want, f"offload {size}^2 {dtype}: (launches, wgmma, "
                           f"split) {got}, want {want}")
        pairs[-1]["launches"] = got
    for size in (127, 256):
        check(offload_counts(torch.float32, size) == (2, 0, 2),
              f"{size}^2 float32 must take the general branch, K split")
    check(offload_counts(torch.bfloat16, 127) == (2, 0, 0),
          "127^2 bfloat16 must take the general branch, K unsplit")
    check(offload_counts(torch.bfloat16, 4096) == (2, 2, 0),
          "4096^2 bfloat16 must take the wgmma branch")
    check(CK.general_plan(4096, 4096, 4096) == (128, 1),
          "4096^2 float32 must take the general branch's 128 x 128 tiles")
    launches, plain_calls = CK.launches.n, CR.calls.n
    wgmma_launches, split_launches = CK.wgmma_launches.n, CK.split_launches.n
    check(plain_calls == 0, f"plain matmul called {plain_calls} times")
    # the path's outputs against the plain version (after the count)
    for p in [demo] + pairs:
        z, (a, b) = p.pop("zero"), p.pop("inputs")
        ref = CR.cluster_matmul_ref(a, b)
        tol = MATMUL_TOL[z.dtype]
        p["max_abs_err"] = (z.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(z.float()).all())
              and torch.allclose(z.float(), ref.float(), rtol=tol, atol=tol),
              f"offload {p['size']}^2 {p['dtype']}: output vs plain max "
              f"|err| {p['max_abs_err']}")
        print(f"offload {p['size']}^2 {p['dtype']}: output vs plain "
              f"max_abs_err={p['max_abs_err']:.3g} tol={tol}", flush=True)
    print(f"offload: demo copy total {rep_c.total_s * 1e3:.4f} ms, "
          f"zero-copy total {rep_z.total_s * 1e3:.4f} ms; "
          f"kernel launches={launches} (wgmma {wgmma_launches}, general "
          f"split-K {split_launches}) "
          f"plain_calls={plain_calls}", flush=True)
    rows = fig5_svm_offload.run_benchmarks()
    for r in rows:
        check(r["copy_total_s"] > 0 and r["svm_total_s"] > 0,
              f"fig5 {r['bench']}: non-positive time")
        print(f"fig5 [{smi}] " + " ".join(
            f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items()), flush=True)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        results = fig6_event_tracing.main()
    check(all(results.values()), f"fig6 assertions {results}")
    print(f"fig6 (host): {len(text.getvalue().splitlines())} lines, "
          f"assertions {results}", flush=True)
    return dict(launches=launches, wgmma_launches=wgmma_launches,
                split_launches=split_launches,
                plain_calls=plain_calls, demo=demo,
                pairs=pairs, fig5=rows, fig6=results)


# --------------------------------------------------------------- phase 9 --
def flash_library(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, cap: float):
    """One PyTorch call computing what the kernel computes on the same
    unexpanded GQA inputs: without a cap, ``scaled_dot_product_attention``
    (its ``is_causal`` is top-left aligned, as the kernel's iotas); with
    one, the compiled ``flex_attention`` with a ``cap * tanh(s / cap)``
    score_mod and a causal / window block mask (built here, outside the
    timed call, as SDPA's boolean mask is)."""
    import torch.nn.functional as F
    q4, k4, v4 = q[None], k[None], v[None]
    S, T = q.shape[1], k.shape[1]
    if not cap:
        if causal and not window:
            return lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True)
        from repro_torch.kernels.flash_attention import ref as FR
        am = None if not (causal or window) else \
            FR.visible_mask(S, T, causal, window, "cuda")
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=am, enable_gqa=True)
    from torch.nn.attention.flex_attention import (
        create_block_mask, flex_attention,
    )

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx if causal else kv_idx >= 0
        if window:
            ok = ok & (q_idx - kv_idx < window)
        return ok

    block_mask = None if not (causal or window) else create_block_mask(
        mask_mod, None, None, S, T, device="cuda")
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q4, k4, v4, score_mod=score_mod,
                        block_mask=block_mask, enable_gqa=True)


def flash_case(timer: Timer, BH: int, S: int, T: int, d: int,
               dtype: torch.dtype, causal: bool, window: int, cap: float,
               groups: int = 1, qk: float = 0.3, seed: int = 0) -> dict:
    """One case of phase 9: the flash kernel against its plain version
    (K/V repeated by ``groups`` for it), then timed beside the plain
    version and the library call (``flash_library``, itself held against
    the plain version and its error recorded), with its bytes, operations
    (4 hd per visible (query, key) pair per head) and roofline bound.  q
    and k are N(0, qk^2): scores have std qk^2 (0.09 at the default, as
    tests/test_kernels.py draws them; 16 at ``FLASH_SHARP``, where the
    cap bites and the softmax is peaky).  v is N(0, 1)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(BH, S, d, generator=g, device="cuda") * qk).to(dtype)
    k = (torch.randn(BH // groups, T, d, generator=g, device="cuda")
         * qk).to(dtype)
    v = torch.randn(BH // groups, T, d, generator=g, device="cuda").to(dtype)
    dt = str(dtype).replace("torch.", "")
    route = FK.route(dtype, d)
    name = (f"flash BH={BH} S={S} T={T} d={d} G={groups} {dt} "
            f"causal={causal} window={window} cap={cap} qk={qk}")

    def kernel():
        return FK.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      cap=cap, groups=groups)

    def plain():
        return FR.flash_attention_ref(
            q, k.repeat_interleave(groups, 0), v.repeat_interleave(groups, 0),
            causal=causal, window=window, cap=cap)

    span, splits = FK.fp32_plan(BH, S, T, d, causal, window) \
        if route == FK.FP32_CORES else (0, 1)
    counters = (FK.launches, FK.tc_launches, FK.split_launches)
    before = [c.n for c in counters]
    out = kernel()
    torch.cuda.synchronize()
    got = tuple(c.n - n0 for c, n0 in zip(counters, before))
    check(got == (1, int(route == FK.TENSOR_CORES), int(splits > 1)),
          f"{name}: route {route} with {splits} splits but (launches, "
          f"tensor-core, split) {got}")
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = FLASH_TOL[dtype]
    check(out.dtype == dtype and out.shape == q.shape,
          f"{name}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()),
          f"{name}: non-finite kernel output")
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"{name}: kernel vs plain max |err| {err}")
    del out
    library = flash_library(q, k, v, causal, window, cap)
    t0 = time.perf_counter()
    lib_out = library().squeeze(0)
    torch.cuda.synchronize()
    library_first_s = time.perf_counter() - t0
    library_err = (lib_out.float() - ref.float()).abs().max().item()
    del ref, lib_out
    ms = timer.ms(kernel)
    plain_ms = timer.ms(plain, reps=5)
    library_ms = timer.ms(library)
    pairs = int(FR.visible_mask(S, T, causal, window, "cuda").sum())
    flops = 4 * d * BH * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(BH=BH, S=S, T=T, d=d, groups=groups, dtype=dt,
               causal=causal, window=window, cap=cap, qk=qk, kernel=route,
               span_keys=span, splits=splits, max_abs_err=err,
               ref_max_abs=ref_max, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="flex_attention" if cap else "sdpa",
               library_max_abs_err=library_err,
               library_first_call_s=library_first_s,
               bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               share_of_bound=bound_ms / ms,
               tflops=flops / (ms * 1e-3) / 1e12)
    print(f"kernel {name}: kernel={route} splits={splits} "
          f"span_keys={span} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} ({row['library']}, max_abs_err "
          f"{library_err:.3g}, first call {library_first_s:.2f} s) "
          f"bytes={nbytes} flops={flops} "
          f"bound_ms={bound_ms:.5f} ({row['bound_by']}) "
          f"share_of_bound={row['share_of_bound']:.4f} "
          f"tflops={row['tflops']:.2f} max_abs_err={err:.3g} "
          f"ref_max_abs={ref_max:.3g} tol={tol}", flush=True)
    return row


def flash_grads():
    """The op's gradients (the kernel's forward, the recompute backward)
    against plain autograd through the plain version, on (out ** 2).sum()
    so the forward's output enters them: the grad tests' shapes and a
    gemma2 layer's head geometry at S=512 with its cap and a window."""
    from repro_torch.kernels.flash_attention import mha_flash
    from repro_torch.kernels.flash_attention import ref as FR
    worst = 0.0
    for (B, S, H, Kv, hd, window, cap) in ((2, 128, 2, 2, 32, 0, 0.0),
                                           (2, 128, 4, 2, 32, 0, 0.0),
                                           (1, 512, 8, 4, 256, 128, 50.0)):
        g = torch.Generator(device="cuda").manual_seed(B * S + H)
        base = [torch.randn(B, S, h, hd, generator=g, device="cuda") * sc
                for h, sc in ((H, 0.3), (Kv, 0.3), (Kv, 1.0))]
        grads = []
        for use_kernel in (True, False):
            ts = [t.clone().requires_grad_(True) for t in base]
            if use_kernel:
                out = mha_flash(*ts, causal=True, window=window, cap=cap)
            else:
                G = H // Kv
                qf = ts[0].transpose(1, 2).reshape(B * H, S, hd)
                kf, vf = (t.transpose(1, 2).reshape(B * Kv, S, hd)
                          .repeat_interleave(G, 0) for t in ts[1:])
                out = FR.flash_attention_ref(qf, kf, vf, causal=True,
                                             window=window, cap=cap)
            (out.float() ** 2).sum().backward()
            grads.append([t.grad for t in ts])
        for a, b in zip(*grads):
            err = (a - b).abs().max().item()
            worst = max(worst, err)
            check(torch.allclose(a, b, rtol=FLASH_GRAD_TOL,
                                 atol=FLASH_GRAD_TOL),
                  f"flash grads B={B} S={S} H={H} Kv={Kv} hd={hd}: max "
                  f"|err| {err}")
    print(f"flash grads vs plain autograd: max_abs_err={worst:.3g} "
          f"tol={FLASH_GRAD_TOL}", flush=True)
    return worst


def phase_flash(timer: Timer, draft: tuple) -> dict:
    """test_kernels' cases, then the capped ones again with sharp scores,
    then gemma2-2b's geometry (B=2 x H=8 flat heads over B x Kv=4 KV
    rows, S=T=4096, hd 256, cap 50, windows 0 and 4096) at both scales
    (the tensor-core kernel), then phase 13's draft forwards (``draft``:
    flat heads, groups, hd and the shortest and longest bucketed S; causal,
    no window, no cap) at both scales (the tensor-core kernel), then the
    float32 calls of phase 10 (S=512, windows 0 and 128; the FP32-core
    kernel).
    Each capped (shape, type, mask) compiles its own ``flex_attention``,
    more than dynamo's default limit of 8 recompiles; past the limit flex
    would run unfused and its time would not be the library's, so the
    limit is raised and hitting it fails the phase."""
    import torch._dynamo
    with torch._dynamo.config.patch(recompile_limit=64,
                                    fail_on_recompile_limit_hit=True):
        return flash_cases(timer, draft)


def flash_cases(timer: Timer, draft: tuple) -> dict:
    cases = [flash_case(timer, BH, S, T, d, dtype, causal, window, cap)
             for (BH, S, T, d) in FLASH_SHAPES
             for (causal, window, cap) in FLASH_MASKS
             for dtype in (torch.float32, torch.bfloat16)]
    sharp = [flash_case(timer, BH, S, T, d, dtype, causal, window, cap,
                        qk=FLASH_SHARP)
             for (BH, S, T, d) in FLASH_SHAPES
             for (causal, window, cap) in FLASH_MASKS if cap
             for dtype in (torch.float32, torch.bfloat16)]
    gemma = [flash_case(timer, 16, 4096, 4096, 256, torch.bfloat16, True,
                        window, 50.0, groups=2, qk=qk)
             for qk in (0.3, FLASH_SHARP) for window in (0, 4096)]
    check(all(c["kernel"] == "tensor_cores" for c in gemma),
          "gemma2-2b's bf16 cases must run on the tensor cores")
    BH, groups, d, lengths = draft
    drafts = [flash_case(timer, BH, S, S, d, torch.bfloat16, True, 0, 0.0,
                         groups=groups, qk=qk)
              for S in lengths for qk in (0.3, FLASH_SHARP)]
    check(all(c["kernel"] == "tensor_cores" for c in drafts),
          "phase 13's draft forwards must run on the tensor cores")
    # the float32 calls phase 10's CUDA step makes (gemma2-2b widths, S
    # 512, its global and its local layer): the FP32-core kernel's path
    small = [flash_case(timer, TRAIN_SMALL_B * 8, TRAIN_SMALL_S,
                        TRAIN_SMALL_S, 256, torch.float32, True, window,
                        50.0, groups=2)
             for window in (0, TRAIN_CUTS["sliding_window"])]
    check(all(c["kernel"] == "fp32_cores" for c in cases + sharp + small
              if c["dtype"] == "float32"),
          "float32 cases must run on the FP32 cores")
    return dict(cases=cases + sharp + gemma + drafts + small, gemma=gemma,
                drafts=drafts, small=small,
                grad_max_abs_err=flash_grads())


# -------------------------------------------------------------- phase 10 --
def train_small_cfg(dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gemma2-2b"), param_dtype=dtype,
                               **TRAIN_CUTS)


def train_small_batch(cfg, step: int = 0) -> dict:
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import MarkovChainData
    shape = ShapeSpec("train_small", TRAIN_SMALL_S, TRAIN_SMALL_B, "train")
    return MarkovChainData(cfg, shape, seed=0).batch(step)


def phase_train_parity() -> dict:
    """One train step on the same float32 weights on the card (flash
    kernel) and on the CPU (plain version).  Loss within 1e-5 and grad
    norm within 1e-4 (relative); each updated leaf: every element within
    one full AdamW update (2.1 lr) plus 1e-6 |p|, and all but 1e-4 of
    them within 1e-3 lr plus 1e-6 |p| (the step-1 update is g / (|g| +
    eps), sign-like, so an element whose gradient is within its own
    summation error of zero may flip); m (0.1 x the clipped gradient)
    within 1e-3 of the leaf's largest |m|."""
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    from repro_torch.configs import get_config
    cfg = train_small_cfg("float32")
    full = get_config("gemma2-2b")
    for k, v in TRAIN_CUTS.items():
        print(f"train parity cut: {k} {getattr(full, k)} -> {v}",
              flush=True)
    print(f"train parity cut: batch 256 -> {TRAIN_SMALL_B}, S 4096 -> "
          f"{TRAIN_SMALL_S}", flush=True)
    print(f"train parity cut: param_dtype {full.param_dtype} -> float32",
          flush=True)
    cpu_model = M.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = train_small_batch(cfg)
    opt = ST.default_opt_cfg(cfg)
    from repro_torch.kernels.flash_attention import kernel as FK
    for counter in (FK.launches, FK.tc_launches, FK.split_launches):
        counter.reset()
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = ST.init_train_state(cfg, opt, params=model)
        t0 = time.perf_counter()
        state, m = ST.make_train_step(cfg, opt)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (state, {k: float(v) for k, v in m.items()},
                    time.perf_counter() - t0)
    (gs, gm, gt), (cs, cm, ct) = out["cuda"], out["cpu"]
    lr = cm["lr"]
    rel_loss = abs(gm["loss"] - cm["loss"]) / abs(cm["loss"])
    rel_norm = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
    worst_p, worst_m, loose = 0.0, 0.0, 0
    for path in ST.named_params(cs["params"]):
        p_g = gs["params"].param(path).detach().cpu()
        p_c = cs["params"].param(path).detach()
        p0 = cpu_model.param(path).detach().abs()      # updated in place:
        p0 = torch.maximum(p0, p_c.abs())              # |p| either side
        diff = (p_g - p_c).abs()
        worst_p = max(worst_p, (diff / lr).max().item())
        check(bool((diff <= 1e-6 * p0 + 2.1 * lr).all()),
              f"train parity {path}: an update differs by more than one "
              f"step ({diff.max().item():.3g}, lr {lr:.3g})")
        n_loose = int((diff > 1e-6 * p0 + 1e-3 * lr).sum())
        loose += n_loose
        check(n_loose <= max(1, 1e-4 * diff.numel()),
              f"train parity {path}: {n_loose} of {diff.numel()} elements "
              "beyond 1e-3 lr")
        m_g = gs["opt"]["m"][path].cpu()
        m_c = cs["opt"]["m"][path]
        err = ((m_g - m_c).abs().max() / m_c.abs().max().clamp(min=1e-30))
        worst_m = max(worst_m, err.item())
        check(err.item() <= 1e-3, f"train parity {path}: m rel err {err}")
    check(math.isfinite(gm["loss"]) and rel_loss <= 1e-5,
          f"train parity: loss {gm['loss']} vs {cm['loss']}")
    check(rel_norm <= 1e-4,
          f"train parity: grad norm {gm['grad_norm']} vs {cm['grad_norm']}")
    flash = (FK.launches.n, FK.tc_launches.n, FK.split_launches.n)
    # each layer's forward runs twice (forward, checkpoint recompute)
    heads = TRAIN_SMALL_B * cfg.num_heads
    want = (2 * cfg.num_layers, 0, 2 * sum(
        FK.fp32_plan(heads, TRAIN_SMALL_S, TRAIN_SMALL_S,
                     cfg.resolved_head_dim, True,
                     M._layer_window(cfg, i))[1] > 1
        for i in range(cfg.num_layers)))
    check(flash == want,
          f"train parity: flash (launches, tensor-core, split) {flash}, "
          f"want {want}: every one on the FP32 cores")
    row = dict(loss_cuda=gm["loss"], loss_cpu=cm["loss"], rel_loss=rel_loss,
               flash_fp32_core_launches=flash[0],
               flash_fp32_split_launches=flash[2],
               grad_norm_cuda=gm["grad_norm"], grad_norm_cpu=cm["grad_norm"],
               rel_grad_norm=rel_norm, lr=lr,
               max_param_diff_over_lr=worst_p, params_beyond_1e3_lr=loose,
               max_m_rel_err=worst_m, cuda_step_s=gt, cpu_step_s=ct)
    print("train parity: gemma2-2b widths x 2 layers f32: " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    return row


# -------------------------------------------------------------- phase 11 --
def phase_trainer() -> dict:
    """``Trainer.run_with_recovery`` on the card at phase 10's size, bf16
    weights: 5 steps, a checkpoint every 2, a failure injected at step 3;
    it must restart once, from the step-2 commit, and end at step 5.  The
    checkpoints go to a temporary directory, deleted afterwards."""
    import shutil
    import tempfile
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import MarkovChainData
    from repro_torch.checkpoint import latest_step
    from repro_torch.runtime.trainer import (
        FailureInjector, Trainer, TrainerConfig,
    )
    cfg = train_small_cfg("bfloat16")
    shape = ShapeSpec("train_small", TRAIN_SMALL_S, TRAIN_SMALL_B, "train")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr = Trainer(cfg, shape, MarkovChainData(cfg, shape, seed=0),
                     TrainerConfig(total_steps=5, ckpt_every=2,
                                   ckpt_dir=ckpt, log_every=1))
        t0 = time.perf_counter()
        res = tr.run_with_recovery(FailureInjector([3]))
        wall = time.perf_counter() - t0
        steps = [m["step"] for m in res["metrics"]]
        losses = [m["loss"] for m in res["metrics"]]
        check((res["final_step"], res["restarts"]) == (5, 1),
              f"trainer: final_step {res['final_step']}, restarts "
              f"{res['restarts']}")
        check(steps == [0, 1, 2, 2, 3, 4],
              f"trainer: logged steps {steps} (want a replay from 2)")
        check(latest_step(ckpt) == 5, f"trainer: last commit "
              f"{latest_step(ckpt)}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        replay = abs(losses[3] - losses[2]) / abs(losses[2])
        check(replay <= 1e-3, f"trainer: step 2 replayed at loss "
              f"{losses[3]} against {losses[2]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    row = dict(final_step=res["final_step"], restarts=res["restarts"],
               logged_steps=steps, losses=losses, replay_rel_diff=replay,
               wall_s=wall)
    print(f"trainer: {row}", flush=True)
    return row


# -------------------------------------------------------------- phase 12 --
def phase_train_full() -> dict:
    """gemma2-2b as registered takes ``TRAIN_FULL_STEPS`` train steps at
    S=4096 on the card; counts are read from 0 just before the steps and
    just after."""
    from repro_torch.configs import SHAPES, ShapeSpec, get_config, \
        param_count
    from repro_torch.data import MarkovChainData
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import steps as ST
    cfg = get_config("gemma2-2b")
    S = SHAPES["train_4k"].seq_len
    print(f"train full: reduced batch from 256 (train_4k) to "
          f"{TRAIN_FULL_B}; S={S}, {cfg.num_layers} layers, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype} params, float32 master",
          flush=True)
    shape = ShapeSpec("train_4k", S, TRAIN_FULL_B, "train")
    data = MarkovChainData(cfg, shape, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = ST.default_opt_cfg(cfg)
    state = ST.init_train_state(cfg, opt, seed=0)
    step_fn = ST.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch(i).items()} for i in range(TRAIN_FULL_STEPS)]
    for c in (FK.launches, FK.tc_launches, FO.plain_forwards,
              FO.backward_recomputes):
        c.reset()
    step_s, losses = [], []
    for b in batches:
        t = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
    launches, plain_fwd, recomputes = (FK.launches.n, FO.plain_forwards.n,
                                       FO.backward_recomputes.n)
    tc_launches = FK.tc_launches.n
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(batches)
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    want = cfg.num_layers * 2 * n_steps
    check(launches == want, f"flash launches {launches} != {cfg.num_layers}"
          f" layers x (forward + recompute) x {n_steps} steps = {want}")
    check(tc_launches == want, f"tensor-core flash launches {tc_launches} "
          f"!= {want}")
    check(plain_fwd == 0, f"plain flash forward ran {plain_fwd} times")
    check(recomputes == cfg.num_layers * n_steps,
          f"backward recomputes {recomputes}")
    tokens = TRAIN_FULL_B * S
    med = statistics.median(step_s[1:])
    n_params = param_count(cfg)
    row = dict(batch=TRAIN_FULL_B, seq=S, steps=n_steps, losses=losses,
               step_s=step_s, step_ms_median=med * 1e3,
               tokens_per_s=tokens / med,
               model_flop_share=6 * n_params * tokens / med / 989e12,
               params=n_params, peak_memory_bytes=peak,
               init_s=init_s, flash_launches=launches,
               flash_tc_launches=tc_launches,
               plain_forwards=plain_fwd, backward_recomputes=recomputes)
    print("train full: gemma2-2b " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    del state, batches
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------------ main --
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_script = time.perf_counter()

    def done(phase: str):
        print(f"{phase} done at {time.perf_counter() - t_script:.2f} s",
              flush=True)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import launch
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as K

    # 1. info
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"info: torch {torch.__version__} cuda {torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    launch.build([K.SOURCE, CK.SOURCE, FK.SOURCE])
    print("build: " + ", ".join(
        f"{src.name} -> {launch.library_path(src).name}"
        for src in (K.SOURCE, CK.SOURCE, FK.SOURCE))
        + f" in {time.perf_counter() - t0:.2f} s", flush=True)

    done("phase 2")

    # 3-6
    timer = Timer()
    cases = phase_kernel(timer)
    done("phase 3")
    parity = parity_models()
    _, known, parity_f32, _ = phase_parity(parity)
    _, _, parity_int8, _ = phase_parity(parity, kv_dtype="int8", spec_k=4,
                                        known=known)
    phase_parity(parity, sampled=True)
    tier_parity = phase_tier_parity(parity)
    parity = parity_models("bfloat16")
    _, known, _, _ = phase_parity(parity)
    phase_parity(parity, kv_dtype="int8", spec_k=4, known=known,
                 sampled=True)
    phase_draft_parity(parity)
    phase_prng_bits()
    del parity
    done("phase 4")
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"init: yi-6b bf16 weights in {time.perf_counter() - t0:.2f} s",
          flush=True)
    from repro_torch.runtime import server as S
    S.sampler_calls.reset()
    serve, phase5, phase5_run = phase_serve(cfg, model)
    check(S.sampler_calls.n == 0,
          f"phase 5 (all greedy) entered the sampler {S.sampler_calls.n} "
          "times")
    done("phase 5")
    serve8, _, _ = phase_serve(cfg, model, kv_dtype="int8", spec_k=4)
    done("phase 6")
    frontdoor = phase_frontdoor(cfg, model, phase5, timer)
    done("phase 13")
    tiers = phase_tiers(cfg, model)
    done("phase 14")
    peaks = measure_peaks(timer)
    planner = phase_planner(cfg, model, phase5_run, peaks, smi)
    done("phase 15")
    del model
    torch.cuda.empty_cache()

    # 7-8
    mm_cases = phase_matmul(timer)
    done("phase 7")
    offload = phase_offload(smi)
    done("phase 8")

    # 9-12
    lengths = frontdoor["draft_lengths"]
    flash = phase_flash(timer, (
        cfg.num_heads, cfg.num_heads // cfg.num_kv_heads,
        cfg.resolved_head_dim, (lengths[0], lengths[-1])))
    done("phase 9")
    parity_train = phase_train_parity()
    done("phase 10")
    phase_trainer()
    done("phase 11")
    train = phase_train_full()
    done("phase 12")

    def entry(name, kernel, kv, C, dtype, launches, replaces):
        """A paged-attention kernel on one pool type: its head case is
        the main path's (C=1 decode or C=128 chunk, flat, q of
        ``dtype``); its error the largest of its cases."""
        own = [c for c in cases if c["kv"] == kv and c["kernel"] == kernel]
        head = next(c for c in own if c["C"] == C and not c["sharp"]
                    and c["dtype"] == dtype)
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in own),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "held_against_plain": True,
            "cases": own,
        }

    from repro_torch.kernels.paged_attention.kernel import (
        FP32_CORES, SPLIT_KV, TENSOR_CORES)
    decode_fwd = "src/repro/kernels/paged_attention/kernel.py:61"
    prefill = "src/repro/kernels/paged_attention/kernel.py:222"
    quant = "src/repro/kernels/paged_attention/kernel.py:113-121"
    # the bf16 pool's kernels carry phases 5, 13, 14 and 15
    kernels = [
        entry("paged_attention_decode_split", SPLIT_KV, "same", 1,
              "bfloat16", serve["split_launches"]
              + frontdoor["split_launches"] + tiers["split_launches"]
              + planner["split_launches"], decode_fwd),
        entry("paged_attention_decode_split_int8", SPLIT_KV, "int8", 1,
              "bfloat16", serve8["split_launches"], quant),
        entry("paged_attention", FP32_CORES, "same", 128, "float32",
              parity_f32["fp32_core_launches"]
              + tier_parity["fp32_core_launches"], prefill),
        entry("paged_attention_int8", FP32_CORES, "int8", 128, "float32",
              parity_int8["fp32_core_launches"], quant),
        entry("paged_attention_prefill_tc", TENSOR_CORES, "same", 128,
              "bfloat16", serve["tc_launches"] + frontdoor["tc_launches"]
              + tiers["tc_launches"] + planner["tc_launches"], prefill),
        entry("paged_attention_prefill_tc_int8", TENSOR_CORES, "int8", 128,
              "bfloat16", serve8["tc_launches"], quant),
    ]
    # the cluster matmul: the general float32 kernel split (64 x 64 tiles;
    # its main-path cases phase 8's demo and 127^2 float32 offload) and on
    # 128 x 128 tiles (phase 8's 4096^2 float32 offload), the wgmma branch
    # (4096^2 bfloat16) and the general bfloat16 kernel (127^2 bfloat16);
    # each with the launches of its phase-8 runs, its main-path
    # case and the largest error of its cases
    f32_big, bf16_big, f32_odd, bf16_odd = (
        p["launches"] for p in offload["pairs"])
    demo = offload["demo"]["launches"]
    for name, branch, tiles, dtype, shape, launches, split in (
            ("cluster_matmul", CK.GENERAL, (64,), "float32",
             (127, 127, 127), demo[0] + f32_odd[0], demo[2] + f32_odd[2]),
            ("cluster_matmul_f32_tile128", CK.GENERAL, (128,), "float32",
             (4096, 4096, 4096), f32_big[0], f32_big[2]),
            ("cluster_matmul_wgmma", CK.WGMMA, (0,), "bfloat16",
             (4096, 4096, 4096), bf16_big[1], 0),
            ("cluster_matmul_bf16", CK.GENERAL, (64, 128), "bfloat16",
             (127, 127, 127), bf16_odd[0], bf16_odd[2])):
        own = [c for c in mm_cases if c["branch"] == branch
               and c["tile"] in tiles and c["dtype"] == dtype]
        head = next(c for c in own if (c["m"], c["k"], c["n"]) == shape
                    and not c["offset"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/cluster_matmul/csrc/"
                      "cluster_matmul.cu",
            "replaces": "src/repro/kernels/cluster_matmul/kernel.py:48",
            "launches": launches, "split_launches": split,
            "max_abs_err": max(c["max_abs_err"] for c in own),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "held_against_plain": True,
            "cases": own,
        })
    # flash on the tensor cores: the main path's case is gemma2-2b's
    # global (window 0) layer, its error the largest of gemma2's four
    # cases (both scales, both windows) and phase 13's draft cases, its
    # launches phase 12's and phase 13's draft forwards; on the FP32
    # cores: phase 10's float32 global layer, its error the largest of its
    # float32 cases
    for name, kernel, head, launches, split in (
            ("flash_attention_tc", "tensor_cores", flash["gemma"][0],
             train["flash_tc_launches"] + frontdoor["flash_tc_launches"],
             0),
            ("flash_attention", "fp32_cores", flash["small"][0],
             parity_train["flash_fp32_core_launches"],
             parity_train["flash_fp32_split_launches"])):
        own = [c for c in flash["cases"] if c["kernel"] == kernel]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
            "launches": launches, "split_launches": split,
            "max_abs_err": max(c["max_abs_err"] for c in (
                flash["gemma"] + flash["drafts"]
                if kernel == "tensor_cores" else own)),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "held_against_plain": True,
            "grad_max_abs_err": flash["grad_max_abs_err"],
            "cases": own,
        })
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_script:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
