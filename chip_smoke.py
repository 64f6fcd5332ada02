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
   CUDA engine (kernel) and the CPU engine (plain version): float32
   greedy on a float32 pool, float32 with an int8 pool and speculative
   decoding (``spec_k=4``, drafts replayed from the first run's tokens),
   and bfloat16 greedy (its chunks on the tensor-core kernel, float32
   chunks on the FP32-core kernel, decode on the split-KV kernel); greedy
   tokens must agree, excusing only near-ties.
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
   TMA's 16-byte rule) and 1000 x 1032 x 776 (partial tiles in every
   dimension), 127^3 (rows of no whole 16-byte chunks), and 256^3,
   768^3, 1000 x 1032 x 776, 4096^3 and yi-6b's product in float32 with
   A 4 bytes past a 16-byte boundary, with the branch each took (wgmma
   for bf16 with k, n multiples of 8 and 16-byte-aligned bases; general
   otherwise and for every float32 product, in float32 with the tile and
   K splits its plan picks: the counts must agree) and times beside
   ``torch.matmul``'s and the roofline bound.
8. offload path: the offload demo (copy-based vs zero-copy SVM through
   the cluster matmul, 256^2 float32), the same two modes at 4096^2 in
   float32 and bfloat16 and at 127^2 in float32, Fig.5's four benchmarks
   on the card and Fig.6's traced RAB programs (host only, its assertions
   must hold); the kernel must carry every product (two launches per
   run: the bf16 ones on its wgmma branch, the float32 ones on the
   general one: 4096^2 on 128 x 128 tiles, the demo's 256^2 and 127^2
   with K split over blocks) and the plain version must never run; each
   of these
   outputs is then held against the plain version.
9. flash kernels vs plain: the flash-attention CUDA kernels against
   their plain version at ``tests/test_kernels.py``'s three shapes x five
   (causal, window, cap) masks x {float32, bfloat16}, at gemma2-2b's
   geometry (B=2, H=8, Kv=4, S=T=4096, hd 256, bf16, cap 50, window 0
   and 4096; the tensor-core kernel) and at phase 10's float32 calls
   (S=512, window 0 and 128; the FP32-core kernel), each capped case and
   gemma2's again with q and k scaled so that scores reach the cap's
   range (``FLASH_SHARP``); each case prints the kernel its route picked
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

Then one JSON line ``{"kernels": [...]}`` (the paged-attention split-KV
decode kernel, FP32-core kernel and tensor-core kernel, each on both pool
types; the cluster matmul's general kernel (K split, and on 128 x 128
tiles) and its wgmma branch; the
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
#: kernel-vs-plain tolerances: tests/test_kernels.py's f32 bar and its
#: bf16 TOL
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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


def phase_parity(models, kv_dtype: str = "bf16", spec_k: int = 0,
                 known=None) -> tuple:
    """The CUDA engine against the CPU engine on the same weights and
    requests (a shared 32-token prefix, a forced preemption).  With
    ``spec_k`` both speculate with a ``ReplayDrafter`` of ``known``
    ({prompt: greedy tokens} from an earlier run).  On bfloat16 weights
    the CUDA engine's chunk steps must take the tensor-core kernel.
    Decode steps must take the split-KV kernel, float32 chunks the
    FP32-core kernel.  Returns (excused positions, {prompt: the CPU
    engine's tokens}, the CUDA engine's launches by kernel)."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
        make_engine,
    )
    cfg, cpu_model, gpu_model = models
    ecfg = EngineConfig(cache=CacheConfig(num_pages=64, page_size=16,
                                          max_pages_per_seq=8,
                                          kv_dtype=kv_dtype),
                        max_lanes=2, chunk=16, spec_k=spec_k,
                        drafter=ReplayDrafter(known, cfg.vocab_size)
                        if spec_k else None)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 32).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(8, 33))).tolist()
               for _ in range(4)]
    requests = [GenerationRequest(rid, tuple(p), SamplingParams(max_new=8))
                for rid, p in enumerate(prompts)]

    def engines():
        return [make_engine(cfg, gpu_model, ecfg),
                make_engine(cfg, cpu_model, ecfg, device="cpu")]

    pair = engines()
    counters = (K.launches, K.int8_launches, K.tc_launches, K.split_launches)
    before = [c.n for c in counters]
    gpu_out, cpu_out = _lockstep(pair, requests, preempt_rid=0,
                                 preempt_after=3)
    same, int8, tc_launches, split_launches = (
        c.n - b for c, b in zip(counters, before))
    fp32_core = same + int8 - tc_launches - split_launches
    bf16 = cfg.param_dtype == "bfloat16"
    check((tc_launches > 0) == bf16,
          f"{cfg.param_dtype} parity: {tc_launches} tensor-core launches")
    check(spec_k or split_launches > 0,
          f"{cfg.param_dtype} parity: no decode step took the split-KV "
          "kernel")
    check((fp32_core > 0) == (not bf16),
          f"{cfg.param_dtype} parity: {fp32_core} FP32-core launches")
    excused = 0
    for r in requests:
        a, b = gpu_out[r.rid], cpu_out[r.rid]
        check(len(a) == len(b) == 8, f"rid {r.rid}: lengths {len(a)}, "
                                     f"{len(b)}")
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        # a flip is excused only at a near-tie: re-run the position alone
        # on both devices and compare the CPU's top-2 margin with the
        # largest logit difference between the two
        one = GenerationRequest(r.rid, tuple(r.prompt) + tuple(b[:j]),
                                SamplingParams(max_new=1))
        rows = []
        for e in engines():
            e.submit(one)
            e.run()
            rows.append(e.last_logits[0].double().cpu())
        diff = (rows[0] - rows[1]).abs().max().item()
        top2 = torch.topk(rows[1], 2).values
        margin = (top2[0] - top2[1]).item()
        check(margin < 10 * diff,
              f"{kv_dtype} spec_k={spec_k} rid {r.rid} token {j}: CUDA "
              f"{a[j]} != CPU {b[j]} with CPU top-2 margin {margin:.3g} "
              f">= 10 x max logit diff {diff:.3g}")
        excused += 1
    g, c = pair
    check(g.preemptions >= 1 and c.preemptions >= 1, "no preemption")
    check(g.cache_stats().prefix_hit_tokens > 0, "no prefix hit")
    spec = [(e.spec_proposed, e.spec_accepted, e.spec_rejected)
            for e in pair]
    if spec_k:
        check(c.spec_accepted > 0 and c.spec_rejected > 0,
              f"speculation accepted {c.spec_accepted} and rejected "
              f"{c.spec_rejected} drafts (both must happen)")
    if not excused:
        check((g.iterations, g.h2d_events, g.d2h_events, spec[0])
              == (c.iterations, c.h2d_events, c.d2h_events, spec[1]),
              "CUDA and CPU engines scheduled differently")
    n_tok = sum(len(v) for v in cpu_out.values())
    print(f"parity: yi-6b widths x 2 layers {cfg.param_dtype}, kv "
          f"{kv_dtype}, spec_k={spec_k}, {len(requests)} requests, "
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
             fp32_core_launches=fp32_core)


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
    tokens})."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.runtime import make_engine
    torch.cuda.reset_peak_memory_stats()
    ecfg, requests = serve_workload(cfg, kv_dtype, spec_k)
    engine = make_engine(cfg, model, ecfg)
    streamed = {}
    iter_ms = {"prefill": [], "decode": [], "verify": []}

    def drive(reqs, preempt_rid=None):
        for r in reqs:
            engine.submit(r)
            streamed[r.rid] = []
        preempted = preempt_rid is None
        while True:
            before = (engine.prefill_tokens, engine.spec_iterations)
            t = time.perf_counter()
            busy = engine.step()      # ends in the iteration's D2H pull
            dt = (time.perf_counter() - t) * 1e3
            if not busy:
                break
            kind = "prefill" if engine.prefill_tokens > before[0] else \
                "verify" if engine.spec_iterations > before[1] else "decode"
            iter_ms[kind].append(dt)
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
    return row, {rid: res.tokens for rid, res in results.items()}


# --------------------------------------------------------------- phase 7 --
def matmul_case(timer: Timer, m: int, k: int, n: int, dtype: torch.dtype,
                seed: int = 0, offset: bool = False) -> dict:
    """One case of phase 7: the cluster-matmul kernel (the branch its
    route picks, checked by the counts) against its plain version on A ~
    N(0, 1), B ~ N(0, 1/k) (an initialised weight's scale, so C is of unit
    scale and two valid float32 summation orders differ far below the
    bar), then timed beside the plain version and ``torch.matmul``, with
    its bytes, operations and roofline bound.  With ``offset`` A lies 4
    bytes past a 16-byte boundary (same values), which routes it to the
    general branch.  A float32 product on the general branch prints its
    tile and K splits (``general_plan``), and the counts show whether it
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
    if offset or dtype == torch.float32 or (m, k, n) in MATMUL_GENERAL_BF16:
        want = CK.GENERAL
    else:
        want = CK.WGMMA
    check(branch == want, f"{name}: routed to {branch}, want {want}")
    tile, splits = CK.general_plan(m, k, n) \
        if branch == CK.GENERAL and dtype == torch.float32 else (0, 1)
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
               tile=tile, splits=splits, launches=got, max_abs_err=err,
               tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bytes=nbytes,
               flops=flops, bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               share_of_bound=bound_ms / ms,
               tflops=flops / (ms * 1e-3) / 1e12)
    print(f"kernel {name}: branch={branch} tile={tile} splits={splits} "
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
        for (m, k, n) in MATMUL_OFFSET_F32]


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
    allocator) and, on the general branch in float32, split as its plan
    says."""
    from repro_torch.kernels.cluster_matmul import kernel as CK
    branch = CK.route(dtype, size, size, size)
    split = branch == CK.GENERAL and dtype == torch.float32 \
        and CK.general_plan(size, size, size)[1] > 1
    return (2, 2 * (branch == CK.WGMMA), 2 * split)


def phase_offload(smi: str) -> dict:
    """The offload path on the card: the demo, then 4096^2 in float32 and
    bfloat16, then 127^2 in float32; the kernel's counts are read from 0
    just before and just after, and must be two per run (on the wgmma
    branch for bfloat16, the general one for float32: unsplit on 128 x
    128 tiles for 4096^2, with K split over blocks for the demo's 256^2
    and 127^2, whose grids are under a wave) with the
    plain version never called; then each run's output is held against
    the plain version.  Then Fig.5 on the card and Fig.6 on the host."""
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
                zero_copy_total_ms=rep_z.total_s * 1e3)
    pairs = []
    for dtype, size in ((torch.float32, 4096), (torch.bfloat16, 4096),
                        (torch.float32, 127)):
        before = [c.n for c in counters]
        pairs.append(offload_pair(dtype, size))
        got = tuple(c.n - n0 for c, n0 in zip(counters, before))
        want = offload_counts(dtype, size)
        check(got == want, f"offload {size}^2 {dtype}: (launches, wgmma, "
                           f"split) {got}, want {want}")
    for size in (127, 256):
        check(offload_counts(torch.float32, size) == (2, 0, 2),
              f"{size}^2 float32 must take the general branch, K split")
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


def phase_flash(timer: Timer) -> dict:
    """test_kernels' cases, then the capped ones again with sharp scores,
    then gemma2-2b's geometry (B=2 x H=8 flat heads over B x Kv=4 KV
    rows, S=T=4096, hd 256, cap 50, windows 0 and 4096) at both scales
    (the tensor-core kernel), then the float32 calls of phase 10 (S=512,
    windows 0 and 128; the FP32-core kernel).
    Each capped (shape, type, mask) compiles its own ``flex_attention``,
    more than dynamo's default limit of 8 recompiles; past the limit flex
    would run unfused and its time would not be the library's, so the
    limit is raised and hitting it fails the phase."""
    import torch._dynamo
    with torch._dynamo.config.patch(recompile_limit=64,
                                    fail_on_recompile_limit_hit=True):
        return flash_cases(timer)


def flash_cases(timer: Timer) -> dict:
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
    # the float32 calls phase 10's CUDA step makes (gemma2-2b widths, S
    # 512, its global and its local layer): the FP32-core kernel's path
    small = [flash_case(timer, TRAIN_SMALL_B * 8, TRAIN_SMALL_S,
                        TRAIN_SMALL_S, 256, torch.float32, True, window,
                        50.0, groups=2)
             for window in (0, TRAIN_CUTS["sliding_window"])]
    check(all(c["kernel"] == "fp32_cores" for c in cases + sharp + small
              if c["dtype"] == "float32"),
          "float32 cases must run on the FP32 cores")
    return dict(cases=cases + sharp + gemma + small, gemma=gemma,
                small=small, grad_max_abs_err=flash_grads())


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
    _, known, parity_f32 = phase_parity(parity)
    _, _, parity_int8 = phase_parity(parity, kv_dtype="int8", spec_k=4,
                                     known=known)
    parity = parity_models("bfloat16")
    phase_parity(parity)
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
    serve, _ = phase_serve(cfg, model)
    done("phase 5")
    serve8, _ = phase_serve(cfg, model, kv_dtype="int8", spec_k=4)
    done("phase 6")
    del model
    torch.cuda.empty_cache()

    # 7-8
    mm_cases = phase_matmul(timer)
    done("phase 7")
    offload = phase_offload(smi)
    done("phase 8")

    # 9-12
    flash = phase_flash(timer)
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
    kernels = [
        entry("paged_attention_decode_split", SPLIT_KV, "same", 1,
              "bfloat16", serve["split_launches"], decode_fwd),
        entry("paged_attention_decode_split_int8", SPLIT_KV, "int8", 1,
              "bfloat16", serve8["split_launches"], quant),
        entry("paged_attention", FP32_CORES, "same", 128, "float32",
              parity_f32["fp32_core_launches"], prefill),
        entry("paged_attention_int8", FP32_CORES, "int8", 128, "float32",
              parity_int8["fp32_core_launches"], quant),
        entry("paged_attention_prefill_tc", TENSOR_CORES, "same", 128,
              "bfloat16", serve["tc_launches"], prefill),
        entry("paged_attention_prefill_tc_int8", TENSOR_CORES, "int8", 128,
              "bfloat16", serve8["tc_launches"], quant),
    ]
    # the cluster matmul: the general kernel split (64 x 64 tiles; its
    # main-path case phase 8's 127^2 float32 offload) and on 128 x 128
    # tiles (phase 8's 4096^2 float32 offload: the general launches
    # without a split, which phase 8's counts tie to it), and the wgmma
    # branch; each with its main-path case and the largest error of its
    # cases
    general = offload["launches"] - offload["wgmma_launches"]
    for name, branch, tiles, dtype, shape, launches, split in (
            ("cluster_matmul", CK.GENERAL, (0, 64), "float32",
             (127, 127, 127), offload["split_launches"],
             offload["split_launches"]),
            ("cluster_matmul_f32_tile128", CK.GENERAL, (128,), "float32",
             (4096, 4096, 4096), general - offload["split_launches"], 0),
            ("cluster_matmul_wgmma", CK.WGMMA, (0,), "bfloat16",
             (4096, 4096, 4096), offload["wgmma_launches"], 0)):
        own = [c for c in mm_cases
               if c["branch"] == branch and c["tile"] in tiles]
        head = next(c for c in own if (c["m"], c["k"], c["n"]) == shape
                    and c["dtype"] == dtype)
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
    # cases (both scales, both windows); on the FP32 cores: phase 10's
    # float32 global layer, its error the largest of its float32 cases
    for name, kernel, head, launches, split in (
            ("flash_attention_tc", "tensor_cores", flash["gemma"][0],
             train["flash_tc_launches"], 0),
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
                flash["gemma"] if kernel == "tensor_cores" else own)),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "held_against_plain": True,
            "grad_max_abs_err": flash["grad_max_abs_err"],
            "cases": own,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
