#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (a failure raises and the script exits
non-zero without printing the final result line):

1. info: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN.
2. build: the paged-attention, cluster-matmul (its grid-stride
   instantiations, which an SM budget launches, as a second source) and
   flash-attention CUDA kernels, compiled from the checkout's sources
   with ``nvcc`` for ``sm_90a``, one compiler per source, all started
   together.
3. kernel vs plain: the paged-attention kernels against their
   plain-PyTorch version at yi-6b attention geometry (B=8, H=32, Kv=4,
   hd=128, page 16, a 1,024-page pool, ragged lengths 1..1,024 with an
   empty lane and aliased shared-prefix pages; the pool drawn on the
   card), C in {1, 5, 128} (5: the
   verify width) with q in float32 and bfloat16, on a pool in q's type
   and on an int8 pool with its scales, and every case but float32 C=1
   again with q scaled so that scores have std 4 (``PAGED_SHARP``); each
   case prints the kernel it took (split-KV for
   C = 1, tensor cores for bf16 q with C > 1, FP32 cores for f32 q with
   C > 1; the counts must agree), its times, bytes, FLOPs and roofline
   bound.  The same cases again at olmoe-1b-7b's geometry (H = Kv = 16,
   G = 1), whose lanes include the rows the engine pads with (an idle
   lane holding 130 tokens, a lane feeding half its C rows): every row,
   pad rows included, must be finite and within the bar.  Then, with q
   in bfloat16 at C in {1, 128}, flat and sharp, on both pool types, at
   one head shard's geometry of yi-6b split over 2 head shards (H = 16,
   Kv = 2) and over 4 (H = 8, Kv = 1): the sharded engine's calls.  Then
   at pixtral-12b's geometry (H = 32, Kv = 8, G = 4) with q in bfloat16
   at C in {1, 5, 128}, flat and sharp, on both pool types.
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
   only the first flip of a stream at a near-tie, weighed on the rows
   the two engines drew that token from in the lockstep (recorded on
   every step, a verify step's accepted drafts and bonus included; a
   flip with no row fails): the two engines'
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
   fail, by its checksum.  Then the threefry draws of 8 keys x 64,000
   on the card must equal the CPU's bit for bit.  Last, olmoe-1b-7b's
   widths x 2 layers (d 2048, 16/16 heads, 64 experts top-8,
   ``moe_d_ff`` 1024) at capacity factor 0.5: float32 greedy on a
   float32 pool with chunk 64 (whose chunk steps must drop assignments,
   alike on both devices) equal token for token under the near-tie
   rule; then bfloat16 greedy and bfloat16 on an int8 pool with
   ``spec_k=4``, the CPU making the card's expert choices (one bf16
   routing swap moves a random-weight olmoe's logits by a large share):
   router logits and every token's logits within ``logits_agree``'s bar
   until a stream's first flip, which must be a near-tie on the same
   step's rows; it prints the share of (row, layer) top-k expert sets
   the two devices chose alike on their own.  The half-chunk check is
   not applied to MoE: capacity depends on the step's row count.
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
   longest S its drafts reached; the tensor-core kernel), at hymba-1.5b's
   geometry (B=2, H=25 over Kv=5, hd 64, bf16, causal, window 2048,
   S=T=3072; the tensor-core kernel, the window skipping leading key
   tiles), at whisper-medium's three calls (B=4 x H=16, G = 1, hd 64,
   bf16: the encoder's non-causal S=T=1,500, the cross-attention's
   non-causal S=448 over T=1,500 and the decoder's causal S=T=448; the
   tensor-core kernel, partial last key and query tiles), at
   deepseek-v2-236b's MLA call (B=2 x H=128, G = 1, q/k head dim 192, v
   head dim 128, causal, S=T=512: in bfloat16 on the tensor-core
   kernel's own (192, 128) instantiation, no pad, one launch, the old
   route (zero pads to hd 256, the hd-256 kernel, the slice) timed
   beside it; in float32 on the FP32-core kernel's own (192, 128)
   instantiation the same way, and again at B x H = 8 heads, where the
   plan splits the key walks; bytes and operations counted on the
   unpadded operands, 2 (dk + dv) operations a visible pair and head), at
   train_100m's call (B=8 x H=10 over Kv=5, hd 64, bf16, causal,
   S=T=256; the tensor-core kernel) and at phase
   10's float32 calls (S=512, window 0 and 128; the
   FP32-core kernel), each capped case, gemma2's, the drafts',
   hymba's, whisper's, MLA's and train_100m's again with q and k scaled
   so that scores reach the cap's range (``FLASH_SHARP``); each case
   prints the kernel its route picked
   (the counts must agree), with times beside the plain version and the
   library call (SDPA without a cap, the compiled ``flex_attention`` with
   a softcap score_mod with one, only at gemma2's and phase 10's global
   layers: each capped shape and mask compiles its own, for seconds; an
   FP32-core case also prints the key
   splits its plan picks, and the counts must show them); then the op's
   gradients against plain autograd (MLA's unequal head dims among
   them).
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
16. MoE serve (after phase 15, yi-6b freed first): olmoe-1b-7b as
   registered (16 layers, d 2048, 64 experts top-8, vocab 50,304, bf16,
   random weights from seed 0) serves phase 5's workload, then phase 6's
   (int8 pages, ``spec_k=4``, echo wave); the paged kernels must carry
   every layer of every iteration.  It prints tokens/s, iteration
   medians, paged launches per iteration, peak memory, KV bytes per
   token and the first prefill iteration's dropped assignments.
17. recurrent families (after phase 16, olmoe freed first): (a)
   hymba-1.5b's widths x 2 layers and xlstm-350m's x 8 (one sLSTM
   group) in float32, the same weights on the card and the CPU:
   ``prefill_logits`` of a 40-token prompt within 1e-5 x the largest
   |logit| (4e-5 for xlstm, whose float32 evaluation is itself ~1e-5
   off a float64 one on each device: ``LOCK_TOL``; hymba's attention on
   the FP32-core flash kernel), then the
   prompt fed by ``decode_forward`` and 16 greedy steps, each step's
   logits within twice that (``LOCK_STEP_TOL``), tokens equal
   under phase 4's near-tie rule; hymba again with its window cut to 32
   so the ring wraps.  Then each as registered (bf16, random weights
   from seed 0): (b) ``prefill_logits`` at B=2, S=3072, the tensor-core
   flash kernel carrying all 32 hymba layers and the plain version none,
   with one layer's attention and Mamba scan (xlstm: sLSTM and mLSTM)
   timed apart; (c) 64 prompt tokens fed by ``decode_forward``, whose
   last logits must equal ``prefill_logits`` of the same tokens within
   6e-2 x the largest |logit| on the bf16 model at 8 layers of full
   width and on float32 weights at 16 layers (``DEC_F32_LAYERS``)
   (``DEC_TOL``; the bf16 model as registered drifts further and is
   recorded), then 32 greedy
   steps of the bf16 model (ms per step); (d)
   one decode step at decode_32k (B=128, position 32,767, the cache
   filled from a seed, ``kpos`` holding the last 2,048 positions): ms
   per step, tokens/s, the roofline's cache bytes and their bound at
   ``launch/mesh.py``'s HBM rate, peak memory.
18. sharded engine (``ShardedPagedServer``, all shards on the one card):
   (a) (run after phase 4's float32 tier case, on its weights) phase 4's
   float32 requests with a forced preemption served in lockstep by the
   sharded engine on the card, the unsharded engine on the card with as
   many lanes and pages, and the sharded engine on the CPU, at (clusters,
   heads) = (2, 2) and (4, 1), and at (2, 1) on int8 pages with
   ``spec_k=4`` and replayed drafts: tokens equal under phase 4's
   near-tie rule, the two sharded engines' iterations, transfers and
   spec counters equal, ``ClusterPagedPool.check_invariants()`` after
   every step, every cluster used, every shard's tensors on the card and
   every shard's kernel on every layer of every iteration, the plain
   version never.  (b) (after phase 15, while yi-6b is loaded) phase 5's
   requests cut to 16 new tokens, at full width at (1, 1) with 8 lanes x
   1,024 pages, (2, 1) with 4 x 512 a cluster, (4, 1) with 2 x 256 and
   (2, 2) with 4 x 512: tokens equal to the first 16 of phase 5's under
   the near-tie rule, every cluster
   dispatched to, every shard's kernel on every layer of every
   iteration; it prints each mesh's ``cluster_report()``, tokens/s,
   iteration medians, kernel launches of a prefill and a decode
   iteration (``torch.profiler``) and peak memory, which at (2, 2) and
   (4, 1) must stay within (1, 1)'s plus their extra pool bytes (the
   weights are held once).
19. frontend families (after phase 18 (b), yi-6b freed first): (a)
   float32 at full width, the same weights on the card and the CPU:
   whisper-medium with 2 encoder and 2 decoder layers (the encoder's
   output of 2 x 1,500 seeded frames and ``prefill_logits`` of a
   16-token prompt within 1e-5 x the largest value, every encoder,
   self- and cross-attention on the FP32-core flash kernel, the plain
   version none; then the prompt fed by ``decode_forward`` against the
   ``encdec_cross_cache`` and 8 greedy steps under phase 17's lockstep
   rule), and pixtral-12b with 2 layers through ``PagedServer`` on
   phase 4's workload (tokens identical, the paged kernels on every
   layer of every iteration).  (b) whisper-medium as registered (24 +
   24 layers, bf16, seed 0): ``encode_frontend`` of 4 x 1,500 seeded
   frames, ``encdec_cross_cache``, ``prefill_logits`` over its 448-token
   text context (the tensor-core flash kernel carrying 24 encoder + 24
   self + 24 cross calls, the plain version none), then the context's
   first 64 tokens fed by ``decode_forward`` and 32 greedy steps: the
   decode path's logits within 6e-2 x the largest of a prefill's of the
   same tokens (``DEC_TOL``); it prints
   encode, prefill and decode ms, decode tokens/s, the cache's K/V
   bytes (equal to ``roofline.cache_bytes``) and peak memory.  (c)
   pixtral-12b as registered (40 layers, vocab 131,072, bf16, seed 0,
   drawn on the card) serves phase 5's workload (every request
   finishes, the paged kernels on every layer of every iteration; a
   prefill and a decode iteration profiled), then ``prefill_logits`` of
   a 320-token prompt with 256 patch embeddings at its head (the
   tensor-core flash kernel on all 40 layers) against ``decode_forward``
   fed the same prompt with the patches as ``inputs_embeds``, within
   ``DEC_TOL``.
20. deepseek-v2-236b (after phase 19, pixtral freed first): (a) its
   registered widths (d 5120, 128 heads, kv_lora 512, q_lora 1536, nope
   128, rope 64, v 128, vocab 102,400, 2 shared experts, top-6, d_ff
   12,288, expert d_ff 1,536) cut to 2 layers (the dense first layer
   and one MoE layer) and 16 routed experts, so that a float32 copy fits
   in host RAM, the same weights on the card and on the CPU:
   ``prefill_logits`` of a 2 x 64-token prompt within 1e-5 x the largest
   |logit| (the FP32-core flash kernel carrying both MLA layers at their
   own head dims, no pad and no slice, each call's output held against
   the plain version on its inputs within 2e-4; the plain version none),
   then the prompt fed by ``decode_forward`` and 8 greedy steps under
   phase 17's lockstep rule.
   (b) bf16 at the registered widths and 160 experts, cut to 6 layers
   (the dense first layer and 5 MoE layers), drawn on the card from seed
   0: ``prefill_logits`` of a 2 x 512-token prompt (the tensor-core flash
   kernel on all 6 layers at MLA's own head dims, the plain version none,
   each call's output held against the plain version on its inputs
   within the bf16 bar; its capacity drops printed), then the prompt's
   first 128 tokens fed by ``decode_forward`` and 32 greedy steps.  Capacity routing drops
   assignments of the prompt's last tokens that the dropless decode
   keeps, and a bf16 router flips near-ties between the two paths, so
   the decode path's logits after those tokens are held within
   ``DEC_TOL`` of their prefill at a capacity that drops nothing, the
   decode routing their rows as that prefill did (``FollowPrefillRouting``; how often its own top-6 agreed is
   printed); it prints prefill ms, decode ms a step and tokens/s, the
   compressed cache's bytes (equal to ``roofline.cache_bytes``), peak
   memory, and the launches and busy ms of one profiled decode step
   beside its floor on weight bytes (the dropless step reads all 160
   experts of every MoE layer).
21. dry-run against the card (last, after phase 12): the sharded step's
   dry-run (``launch.dryrun``: DTensors of fake tensors on a fake
   process group, traced in subprocesses started together before phase
   17, on the host's idle cores) held against the same step run on the
   card.  (a)
   yi-6b ``decode_step`` at its registered widths, B=8 against a
   32,768-slot cache, on a one-device mesh: the bytes the card's tensors
   requested of the caching allocator once params, cache and batch are
   placed equal the dry-run's argument bytes within 0.1%
   (``memory_allocated``, its blocks rounded up, printed beside them),
   ``FlopCounterMode`` over
   the card's step equals its ``cost.flops`` exactly, and the step
   launches no hand-written kernel.  (b) gemma2-2b's train step at
   phase 12's cut (S=4096, B=2): argument bytes within 0.1%, the card's
   count equals ``cost.flops - kernel_flops`` exactly (the flash
   forward is a ctypes launch ``FlopCounterMode`` cannot see; its
   recompute in the backward is the plain version and counts on both
   sides), and over a second step, outside ``FlopCounterMode``,
   ``max_memory_allocated`` (and the requested peak) less what was
   resident before, printed beside the predicted argument + temp bytes, the tensor-core flash kernel launched twice a
   layer and the plain forward never.  (c) yi-6b ``decode_32k`` and
   deepseek-v2-236b ``train_4k`` at full size on the single-pod (16, 16)
   mesh under megatron: per-device argument + temp bytes against 80 GB,
   collective bytes and the three roofline terms at ``launch.mesh``'s
   measured peaks and NVLink's data-sheet rate (``dryrun full:`` lines).
   Prints the phase's seconds.
22. the last entry points (after phase 21): (a) Fig.4's measured half
   (``hero.fig4_cluster_speedup``): a row-tiled float32 product at
   1024^3 and 2048^3 over 1, 2, 4 and 8 clusters sharing the card, each
   on its own stream with a budget of the card's SMs // 8
   (``core.cluster.make_card_clusters``), the cluster matmul kernel
   within that budget as each cluster's body (its grid at most budget x
   the blocks an SM holds, walking its tiles by grid stride); prints per
   count the wall (launches queued behind a sleep, and paced by the
   host), each cluster's own time, the speedup over one cluster, the
   bound on a cluster's SM share, each budget's blocks an SM, and the
   card's name and power limit.  The budgeted launches are counted over
   that run alone; every count's C must agree with the plain version and
   with one unbudgeted call within 2e-4, the wall for n >= 2 clusters
   must be under 0.8 x the sum of the clusters' own times (their
   launches overlap), and a budget on a wgmma product must raise.  (b)
   ``launch.train_100m`` at full width (10 layers, d 640, 10 heads over
   5 KV heads, hd 64, vocab 50,304, bf16): 60 steps at batch 8 x seq
   256, a checkpoint every 20 steps; the tensor-core flash kernel must
   carry every attention forward and recompute (20 a step), the plain
   version none, and the loss must decrease; prints step ms, flash
   launches a step, first and last loss.  (c) ``launch.serve_paged``'s
   schedule (the reference's smoke config, bf16 weights from seed 0 on
   the card, carried to the CPU): the card's engine and the CPU's must
   give equal iterations, transfers, preemptions, prefix hits, RAB and
   pool stats, and equal tokens but for a stream's first flip at a
   near-tie (phase 4's rule); the paged kernels carry every layer of
   every iteration.  Phase 22 takes ~1 min.

Then the script's time, one JSON line ``{"kernels": [...]}`` (the
paged-attention split-KV
decode kernel, FP32-core kernel and tensor-core kernel, each on both pool
types; the cluster matmul's general float32 kernel (K split, and on 128
x 128 tiles), the same within an SM budget (phase 22 (a)), its wgmma
branch and its general bfloat16 kernel; the
flash kernel
on the tensor cores and on the FP32 cores; phases 19-22's
launches are in their counts) and, last, the result line
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the
repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
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
#: phase 3's attention geometries: (H, Kv) at hd 128; olmoe's is G = 1,
#: pixtral-12b's G = 4 (phase 19's engine); "yi-6b/hN" is one head shard
#: of yi-6b split over N head shards (the sharded engine's kernel calls,
#: phase 18)
PAGED_GEOMS = {"yi-6b": (32, 4), "olmoe-1b-7b": (16, 16),
               "yi-6b/h2": (16, 2), "yi-6b/h4": (8, 1),
               "pixtral-12b": (32, 8)}


def attention_case(C: int, dtype: torch.dtype, int8: bool = False,
                   seed: int = 0, sharp: bool = False,
                   geom: str = "yi-6b") -> dict:
    """Inputs at ``geom``'s attention geometry (``PAGED_GEOMS``), as the
    engine feeds the kernel: lane b holds ``lengths[b]`` tokens of which
    its last ``n_new`` are this step's queries (q_start = lengths -
    n_new); lanes 1..5 share a 128-token prefix (8 aliased physical
    pages); the last lane is empty.  At olmoe's geometry the step also
    has the rows the engine pads with: lane 2 is idle (n_new = 0, all its
    rows past its 130 tokens) and lane 4 feeds only ceil(C / 2) of its C
    rows; a row past n_new sees every token of its lane (``pad``: (B, C)
    marks them).  A head shard's geometry ("yi-6b/hN") keeps yi-6b's
    lanes and pool with fewer heads.  With ``int8`` the pool is int8
    with (P, 2, Kv) float32 scales, as the quantized engine keeps it.
    q ~ N(0, 0.09), or with ``sharp`` scaled so the scores have std
    ``PAGED_SHARP``.  The tables and q come from numpy's generator, the
    pool from the card's, both seeded with ``seed``."""
    from repro_torch.kernels.paged_attention.ops import (
        page_counts_for, pad_block_table,
    )
    H, Kv = PAGED_GEOMS[geom]
    B, hd, page, P, n_pages = 8, 128, 16, 1024, 64
    rng = np.random.default_rng(seed)
    lengths = np.array([1, 17, 130, 300, 511, 777, 1024, 0], np.int32)
    n_new = np.minimum(C, lengths).astype(np.int32)
    if geom == "olmoe-1b-7b":
        n_new[2] = 0
        n_new[4] = -(-C // 2)
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
    # the pool is drawn on the card: numpy took ~0.5 s a case for it
    g = torch.Generator(device=dev).manual_seed(seed)
    if int8:
        kv = torch.randint(-127, 128, (P, 2, page, Kv, hd), generator=g,
                           dtype=torch.int8, device=dev)
        scales = torch.empty((P, 2, Kv), device=dev).uniform_(
            1e-3, 2e-2, generator=g)
        k = kv[:, 0].float() * scales[:, 0, None, :, None]
    else:
        kv = (torch.randn((P, 2, page, Kv, hd), generator=g, device=dev)
              * 0.5).to(dtype)
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
    pad = torch.from_numpy(np.arange(C)[None, :] >= n_new[:, None]).to(dev)
    return dict(q=q, kv=kv, scales=scales,
                padded=pad_block_table(table, counts), counts=counts,
                lens=lens,
                q_start=torch.from_numpy(q_start).to(dev), pad=pad,
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


#: the head-shard geometries' cases: the full-width sharded engine's
#: decode (C=1) and prefill (C=128) calls, bf16 q
SHARD_CASES = [(C, torch.bfloat16, sharp) for C in (1, 128)
               for sharp in (False, True)]
#: pixtral-12b's cases: its bf16 engine's decode (C=1), verify (C=5) and
#: prefill (C=128) calls
PIXTRAL_CASES = [(C, torch.bfloat16, sharp) for C in (1, 5, 128)
                 for sharp in (False, True)]


def geom_cases(geom: str) -> list:
    if "/" in geom:
        return SHARD_CASES
    return PIXTRAL_CASES if geom == "pixtral-12b" else PAGED_CASES


def phase_kernel(timer: Timer) -> list:
    return [kernel_case(timer, C, dtype, int8, sharp, geom)
            for geom in PAGED_GEOMS for int8 in (False, True)
            for C, dtype, sharp in geom_cases(geom)]


def kernel_case(timer: Timer, C: int, dtype: torch.dtype, int8: bool,
                sharp: bool = False, geom: str = "yi-6b") -> dict:
    """One case of phase 3: the kernel its route picks (on the int8 pool
    with ``int8``) against its plain version, then timed beside the plain
    version and SDPA, with its bytes, FLOPs and roofline bound.  The
    rows the engine pads with (``attention_case``'s ``pad``) are held to
    the same bar as every row; their error is reported apart."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ops import mask_block_table
    c = attention_case(C, dtype, int8, sharp=sharp, geom=geom)
    route = K.route(dtype, C)
    name = f"{geom} C={C} q={str(dtype).replace('torch.', '')} " \
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
    pad = c["pad"]
    pad_rows = int(pad.sum())
    pad_err = (out.float() - ref.float())[pad].abs().max().item() \
        if pad_rows else 0.0
    ms = timer.ms(kernel)
    plain_ms = timer.ms(plain, reps=5)
    library_ms = timer.ms(sdpa_call(c, C))
    t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = c["flops"] / PEAK_OPS_PER_S[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(geom=geom, C=C, dtype=str(dtype).replace("torch.", ""),
               kv="int8" if int8 else "same", sharp=sharp, kernel=route,
               pad_rows=pad_rows, pad_max_abs_err=pad_err,
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
          f"pad_rows={pad_rows} pad_max_abs_err={pad_err:.3g} "
          f"tol={tol}", flush=True)
    return row


# --------------------------------------------------------------- phase 4 --
class StepRows:
    """While active, records for every engine that steps (it wraps
    ``PagedServer.step``, which ``ShardedPagedServer.step`` calls too, so
    it also sees engines that ``generate()`` drives) the float32 logits
    row, on the host, that each emitted token was drawn from:
    ``rows[engine]`` is {rid: {position in the rid's stream: row}}.  A
    chunk or decode step's token comes from its lane's ``last_logits``, a
    verify step's j-th token from its lane's ``verify_logits[lane, j]``.
    It reads what the step appended to each request's ``SeqState.out``:
    of the lanes and the queue before the step (a lane that finishes
    leaves ``lanes``; a request admitted in the step was queued; a
    preempted one is queued with the output it kept) and of the lanes
    after it.  One D2H copy a step; the step itself is untouched."""

    def __enter__(self):
        from repro_torch.runtime.server import PagedServer
        self._cls, self._real = PagedServer, PagedServer.step
        self.rows = {}

        def step(engine):
            seqs = [r for r in engine.lanes if r is not None]
            seqs += list(engine.queue)
            before = {id(r): len(r.out) for r in seqs}
            spec0 = engine.spec_iterations
            busy = self._real(engine)
            seqs += [r for r in engine.lanes
                     if r is not None and id(r) not in before]
            self._take(engine, seqs, before,
                       engine.spec_iterations != spec0)
            return busy
        PagedServer.step = step
        return self

    def __exit__(self, *exc):
        self._cls.step = self._real

    def _take(self, engine, seqs, before, verify: bool):
        got = self.rows.setdefault(engine, {})
        emitted = [(r, before.get(id(r), 0)) for r in seqs
                   if len(r.out) > before.get(id(r), 0)]
        lanes, cols, where = [], [], []
        for r, n0 in emitted:
            check(r.lane >= 0, f"rid {r.rid} emitted without a lane")
            check(verify or len(r.out) == n0 + 1,
                  f"rid {r.rid}: a chunk step emitted "
                  f"{len(r.out) - n0} tokens")
            for j in range(len(r.out) - n0):
                lanes.append(r.lane)
                cols.append(j)
                where.append((r.rid, n0 + j))
        if not where:
            return
        lanes = torch.tensor(lanes, device=engine.last_logits.device)
        if verify:
            picked = engine.verify_logits[lanes, torch.tensor(
                cols, device=lanes.device)]
        else:
            picked = engine.last_logits[lanes]
        for (rid, pos), row in zip(where, picked.float().cpu()):
            got.setdefault(rid, {})[pos] = row


def _lockstep(engines, requests, preempt_rid: int, preempt_after: int,
              counters=(), rows=None):
    """Serve ``requests`` on every engine in lockstep (one ``step()`` each
    per round), preempting ``preempt_rid`` on all of them once it has
    ``preempt_after`` output tokens; a sharded engine's
    ``ClusterPagedPool`` invariants are checked after each of its steps.
    Returns each engine's tokens, and with ``counters`` (launch counters)
    also each engine's launches by counter.  With ``rows`` (a list of one
    dict per engine) each engine's dict takes {rid: {position: the float32
    logits row, on the host, that the lane drew that output token from}}
    for every token it emits, a verify step's included (``StepRows``)."""
    outs = [{r.rid: [] for r in requests} for _ in engines]
    launched = [[0] * len(counters) for _ in engines]
    for e in engines:
        for r in requests:
            e.submit(r)
    preempted = False
    busy = True
    with StepRows() if rows is not None else contextlib.nullcontext() \
            as rec:
        while busy:
            busy = False
            for k, (e, out) in enumerate(zip(engines, outs)):
                before = [c.n for c in counters]
                busy |= e.step()
                launched[k] = [n + c.n - b for n, c, b in
                               zip(launched[k], counters, before)]
                if hasattr(e, "cpool"):
                    e.cpool.check_invariants()
                for d in e.poll_deltas():
                    out[d.rid].extend(d.tokens)
            if not preempted and \
                    len(outs[0][preempt_rid]) >= preempt_after:
                for e in engines:
                    check(e.preempt(preempt_rid), "forced preemption missed")
                preempted = True
    if rows is not None:
        for mine, e in zip(rows, engines):
            mine.update(rec.rows.get(e, {}))
    return (outs, launched) if counters else outs


def host_and_card(cfg) -> tuple:
    """The same weights on the CPU and on the card: drawn on the card
    from seed 0, then copied to the host (the host's generator takes
    ~10-20 s for one of phases 4, 19 and 20's models)."""
    from repro_torch.models.model import init_params
    model = init_params(cfg, seed=0)
    return copy.deepcopy(model).to("cpu"), model


def parity_models(dtype: str = "float32"):
    """Phase 4's weights (``dtype``) at yi-6b widths x 2 layers, on the CPU
    and on the card: float32 drawn on the card (``host_and_card``);
    bfloat16 still drawn by the host's generator and copied to the card.
    Drawn on the card, the bf16 int8 + ``spec_k=4`` sampled lockstep met
    a flip its rerun cannot weigh (a token at the top-p edge of the
    lockstep's row, which the rerun's int8 pages, re-packed as its own
    chunks wrote them, keep)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=2,
                              param_dtype=dtype)
    if dtype == "float32":
        return (cfg, *host_and_card(cfg))
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


def logits_agree(rows, dtype: torch.dtype, label: str,
                 tol: float = 0.0) -> tuple:
    """Two paths' float32 logits ``rows`` (the reference's last) must
    agree within the whole-model tolerance of the weights' type relative
    to the logits' scale: max |a - b| <= ``MODEL_TOL[dtype]`` (or ``tol``)
    x max |b|.  Returns (that difference, its bound)."""
    tol = tol or MODEL_TOL[dtype]
    a, b = (r.double().cpu() for r in rows)
    diff = (a - b).abs().max().item()
    gate = tol * b.abs().max().item()
    check(diff <= gate, f"{label}: the two paths' logits differ by "
                        f"{diff:.3g} > {tol} x max|logit| = {gate:.3g}")
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
                label: str, tol: float = 0.0) -> tuple:
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
    near-tie.  ``tol`` replaces ``MODEL_TOL[dtype]``.  Returns (excused,
    the numbers as text)."""
    from repro_torch.runtime.server import _sample_scores
    diff, gate = logits_agree(rows, dtype, label, tol)
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


def excuse_first_flip(label: str, prompt, a, b, rows, sp,
                      dtype: torch.dtype) -> bool:
    """The first position where the streams ``a`` and ``b`` (the
    reference's) of one request differ must be a near-tie
    (``flip_margin``).  ``rows`` is either the two runs' own {position:
    logits row} (``StepRows``, as ``_lockstep(rows=...)`` keeps them):
    up to the flip the two contexts are equal, so those are the rows the
    two tokens were drawn from, and a flip without a row on both sides
    fails the check; or, for callers whose two sides compute that
    position through different paths (phase 13 against phase 5, draft
    parity's drafter forwards), a function giving both paths' rows after
    the context ``ctx``.  Past the flip the two contexts differ and the
    streams are not compared.  Returns whether they differed (and were
    excused)."""
    check(len(a) == len(b), f"{label}: lengths {len(a)}, {len(b)}")
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return False
    ctx = tuple(prompt) + tuple(b[:j])
    if callable(rows):
        rows, source = rows(ctx), "the two paths' rows"
    else:
        check(all(j in r for r in rows),
              f"{label} token {j}: {a[j]} != {b[j]} and the lockstep "
              f"recorded no row there on "
              f"{[k for k, r in enumerate(rows) if j not in r]}")
        rows, source = [r[j] for r in rows], "the lockstep's own rows"
    ok, numbers = flip_margin(rows, a[j], b[j], sp, len(ctx), dtype,
                              f"{label} token {j}")
    check(ok, f"{label} token {j}: {a[j]} != {b[j]}, weighed on {source}: "
              f"{numbers}")
    print(f"{label} token {j} excused, weighed on {source}: {numbers}",
          flush=True)
    return True


def parity_requests(cfg, sampled: bool = False) -> list:
    """Phase 4's four requests: a shared 32-token prefix and 8-32 tokens
    of their own, 8 new tokens each (``sampling_for``)."""
    from repro_torch.runtime import GenerationRequest
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 32).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(8, 33))).tolist()
               for _ in range(4)]
    return [GenerationRequest(rid, tuple(p), sampling_for(rid, sampled))
            for rid, p in enumerate(prompts)]


def path_row(engine, ctx: tuple, chunk: int) -> torch.Tensor:
    """The float32 logits after ``ctx`` on a fresh ``engine``, its last
    tokens through one path: the context but its last token is served
    first (its full pages enter the prefix cache), then the whole context
    with the chunk cut to ``chunk`` (1: the decode path, the split-KV
    kernel; 5: a verify step's width; 128: a prefill chunk's), so only
    the tokens past its last full page run, through that path's
    kernel."""
    from repro_torch.runtime import GenerationRequest, SamplingParams
    engine.submit(GenerationRequest(0, ctx[:-1], SamplingParams(max_new=1)))
    engine.run()
    engine.chunk = chunk
    engine.submit(GenerationRequest(1, ctx, SamplingParams(max_new=1)))
    seq = engine.queue[-1]
    hit = engine.run()[-1].prefix_hit_tokens
    check(hit >= len(ctx) - engine.page_size,
          f"the rerun reused {hit} of {len(ctx)} tokens")
    return engine.last_logits[seq.lane]


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
    agree but for near-ties (``excuse_first_flip``, on the rows each
    engine drew the token from, a verify step's included).  Returns
    (excused positions, {prompt: the CPU engine's tokens}, the CUDA
    engine's launches by kernel, in all and its iterations, {rid: (CUDA
    tokens, CPU tokens)})."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.runtime import CacheConfig, EngineConfig, make_engine
    from repro_torch.runtime import server as S
    cfg, cpu_model, gpu_model = models
    ecfg = EngineConfig(cache=CacheConfig(num_pages=64, page_size=16,
                                          max_pages_per_seq=8,
                                          kv_dtype=kv_dtype),
                        max_lanes=2, chunk=chunk, spec_k=spec_k,
                        drafter=ReplayDrafter(known, cfg.vocab_size)
                        if spec_k else None)
    requests = parity_requests(cfg, sampled)

    def engines(chunk: int = chunk):
        spec = dataclasses.replace(ecfg, chunk=chunk)
        return [make_engine(cfg, gpu_model, spec),
                make_engine(cfg, cpu_model, spec, device="cpu")]

    pair = engines()
    counters = (K.launches, K.int8_launches, K.tc_launches, K.split_launches,
                S.sampler_calls)
    before = [c.n for c in counters]
    # with sampling the preempted lane is a sampling one; each engine's
    # rows are kept to weigh a flip on (excuse_first_flip)
    rows = [{}, {}]
    gpu_out, cpu_out = _lockstep(pair, requests,
                                 preempt_rid=1 if sampled else 0,
                                 preempt_after=3, rows=rows)
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
            [rw.get(r.rid, {}) for rw in rows], r.sampling, dtype)
    halved_excused = 0
    if sampled:
        # draws are keyed by position: half the chunk, the same streams on
        # each device (a flip only at a near-tie between the two chunkings)
        halved_rows = [{}, {}]
        halved = _lockstep(engines(chunk // 2), requests, preempt_rid=1,
                           preempt_after=3, rows=halved_rows)
        for d, name in enumerate(("CUDA", "CPU")):
            for r in requests:
                halved_excused += excuse_first_flip(
                    f"{label} {name} chunk {chunk // 2} vs {chunk} rid "
                    f"{r.rid}", r.prompt, halved[d][r.rid],
                    (gpu_out, cpu_out)[d][r.rid],
                    [halved_rows[d].get(r.rid, {}), rows[d].get(r.rid, {})],
                    r.sampling, dtype)
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
    print(f"parity: {cfg.name} widths x 2 layers {cfg.param_dtype}, kv "
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
             fp32_core_launches=fp32_core, launches=same + int8,
             iterations=g.iterations), \
        {r.rid: (gpu_out[r.rid], cpu_out[r.rid]) for r in requests}


# ------------------------------------------------------ phase 4: MoE --
@dataclasses.dataclass
class Route:
    """One MoE layer call: its device, the top-k expert ids it computed
    (T, k), its float32 router logits (T, E) and the capacity C of its T
    rows."""
    device: str
    idx: torch.Tensor
    logits: torch.Tensor
    C: int

    def dropped(self) -> int:
        """Assignments past their expert's C slots."""
        load = torch.bincount(self.idx.reshape(-1),
                              minlength=self.logits.shape[1])
        return int((load - self.C).clamp(min=0).sum())


class RouteRecorder:
    """Records every MoE layer call while active (it wraps
    ``repro_torch.models.moe._route``) as a ``Route``; the tensors stay
    on their device until read, so recording adds no sync to the step.
    With ``follow`` the CPU's n-th call routes to the expert ids of the
    card's n-th call (the card steps first in each lockstep round), its
    gates the softmax of its own logits at those ids, while its own top-k
    is recorded; from the first call whose shape differs from the card's
    (the schedules parted) it routes on its own again."""

    def __init__(self, follow: bool = False):
        self.calls = []
        self.follow = follow
        self.parted_at = None        # the CPU call where following ended

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._moe, self._real = MOE, MOE._route

        def spy(cfg, router, xf):
            vals, idx = self._real(cfg, router, xf)
            logits = xf.float() @ router
            call = Route(router.device.type, idx.clone(), logits,
                         MOE._capacity(cfg, xf.shape[0]))
            self.calls.append(call)
            if not self.follow or call.device != "cpu" or \
                    self.parted_at is not None:
                return vals, idx
            n = len(self.on("cpu")) - 1
            card = self.on("cuda")
            if n >= len(card) or card[n].idx.shape != idx.shape:
                self.parted_at = n
                return vals, idx
            forced = card[n].idx.to(xf.device)
            return logits.gather(1, forced), forced
        MOE._route = spy
        return self

    def __exit__(self, *exc):
        self._moe._route = self._real

    def on(self, device: str) -> list:
        return [c for c in self.calls if c.device == device]

    def agreement(self) -> tuple:
        """(rows whose top-k set the card and the CPU agree on, rows
        compared), over the calls the two devices made in the same order
        at the same row count (every row of a call, pad rows included;
        the CPU's own top-k, also where it follows the card's)."""
        same = total = 0
        for a, b in zip(self.on("cuda"), self.on("cpu")):
            if a.idx.shape != b.idx.shape:
                continue
            ia = torch.sort(a.idx.cpu(), dim=-1).values
            ib = torch.sort(b.idx.cpu(), dim=-1).values
            same += int((ia == ib).all(dim=-1).sum())
            total += ia.shape[0]
        return same, total


def moe_lockstep(models, kv_dtype: str = "bf16", spec_k: int = 0,
                 known=None) -> tuple:
    """``phase_parity``'s lockstep for bfloat16 MoE weights, with the CPU
    engine making the card's expert choices (``RouteRecorder(follow=
    True)``): a bf16 rounding can swap two experts of nearly equal
    router logits, and one swapped expert moves the logits by a large
    share (the experts' outputs dwarf the residual at this init), so
    only the routing is aligned, not the arithmetic.  Every MoE call's
    router logits must then agree within ``logits_agree``'s bar until the
    round in which a first token flip appears (past it that lane feeds
    another token); every token's logits (the row it was drawn from,
    recorded by ``StepRows`` on both devices) must agree within it too
    until its stream's first flip, which must be a near-tie by
    ``flip_margin`` on those rows.  Prints the share of (row, layer)
    top-k sets the two devices chose alike on their own.  Returns
    ({prompt: CPU tokens}, the card's launches by kernel)."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, GenerationRequest, make_engine,
    )
    cfg, cpu_model, gpu_model = models
    dtype = getattr(torch, cfg.param_dtype)
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
    requests = [GenerationRequest(rid, tuple(p), sampling_for(rid, False))
                for rid, p in enumerate(prompts)]
    pair = [make_engine(cfg, gpu_model, ecfg),
            make_engine(cfg, cpu_model, ecfg, device="cpu")]
    outs = [{r.rid: [] for r in requests} for _ in pair]
    for e in pair:
        for r in requests:
            e.submit(r)
    counters = (K.tc_launches, K.split_launches)
    before = [c.n for c in counters]
    preempted, busy = False, True
    flip_calls = None       # CPU layer calls up to the round of a first flip
    with RouteRecorder(follow=True) as rec, StepRows() as cap:
        while busy:
            busy = False
            for e, out in zip(pair, outs):
                busy |= e.step()
                for d in e.poll_deltas():
                    out[d.rid].extend(d.tokens)
            if flip_calls is None and any(
                    x != y for rid in outs[0]
                    for x, y in zip(outs[0][rid], outs[1][rid])):
                flip_calls = len(rec.on("cpu"))
            if not preempted and len(outs[0][0]) >= 3:
                for e in pair:
                    check(e.preempt(0), "forced preemption missed")
                preempted = True
    tc_launches, split_launches = (c.n - b for c, b in zip(counters, before))
    rows = [cap.rows[e] for e in pair]
    # past the round of the first flip a lane's input token differs
    worst = 0.0
    n_calls = min(x for x in (rec.parted_at, flip_calls,
                              len(rec.on("cpu"))) if x is not None)
    for i, (a, b) in enumerate(zip(rec.on("cuda"), rec.on("cpu"))):
        if i >= n_calls:
            break
        diff, gate = logits_agree((a.logits, b.logits), dtype,
                                  f"MoE router logits, call {i}")
        worst = max(worst, diff / gate)
    label = f"moe lockstep {cfg.param_dtype} kv {kv_dtype} spec_k={spec_k}"
    excused = compared = 0
    for r in requests:
        a, b = outs[0][r.rid], outs[1][r.rid]
        check(len(a) == len(b) == 8, f"{label} rid {r.rid}: lengths "
                                     f"{len(a)}, {len(b)}")
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        for i in range(len(a) if j is None else j):
            logits_agree((rows[0][r.rid][i], rows[1][r.rid][i]), dtype,
                         f"{label} rid {r.rid} token {i}")
            compared += 1
        if j is not None:
            pos = len(r.prompt) + j
            ok, numbers = flip_margin(
                (rows[0][r.rid][j], rows[1][r.rid][j]), a[j], b[j],
                r.sampling, pos, dtype, f"{label} rid {r.rid} token {j}")
            check(ok, f"{label} rid {r.rid} token {j}: {a[j]} != {b[j]}, "
                      f"{numbers}")
            print(f"{label} rid {r.rid} token {j} excused: {numbers}",
                  flush=True)
            excused += 1
    same, total = rec.agreement()
    g, c = pair
    check(g.preemptions >= 1 and g.cache_stats().prefix_hit_tokens > 0,
          f"{label}: no preemption or no prefix hit")
    check(tc_launches > 0 and (spec_k or split_launches > 0),
          f"{label}: tensor-core launches {tc_launches}, split-KV "
          f"{split_launches}")
    if spec_k:
        check(c.spec_accepted > 0 and c.spec_rejected > 0,
              f"{label}: speculation accepted {c.spec_accepted} and "
              f"rejected {c.spec_rejected} drafts (both must happen)")
    dropped = [sum(x.dropped() for x in rec.on(d)) for d in ("cuda", "cpu")]
    print(f"{label}: {cfg.name} widths x 2 layers, {len(requests)} "
          f"requests, tokens compared {compared}, excused_positions="
          f"{excused}, the CPU followed the card's routing for "
          f"{rec.parted_at if rec.parted_at is not None else 'all'} of "
          f"{len(rec.on('cpu'))} calls, router logits within "
          f"{worst:.3g} of the bar in the {n_calls} calls before a first "
          f"flip; on their own the devices chose the "
          f"same top-k set on {same} of {total} (row, layer) pairs "
          f"({same / max(total, 1):.4f}); dropped {dropped[0]} (cuda) / "
          f"{dropped[1]} (cpu); tensor_core_launches={tc_launches}, "
          f"split_kv_launches={split_launches}, spec_proposed/accepted/"
          f"rejected cuda={g.spec_proposed, g.spec_accepted, g.spec_rejected}"
          f" cpu={c.spec_proposed, c.spec_accepted, c.spec_rejected}",
          flush=True)
    return {tuple(r.prompt): outs[1][r.rid] for r in requests}, \
        dict(tc_launches=tc_launches, split_launches=split_launches)


#: phase 4's olmoe engines: olmoe-1b-7b's widths x 2 layers, capacity
#: factor 0.5 and chunk 64 so that a chunk step's 128 rows get C = 8
#: slots an expert for a mean load of 16 (the floor of 8 hides drops at
#: chunk 16: C = 8 for a mean load of 4)
MOE_PARITY_CF, MOE_PARITY_CHUNK = 0.5, 64


def moe_parity_models(dtype: str):
    """Phase 4's MoE weights (``dtype``) at olmoe-1b-7b widths x 2 layers,
    drawn on the card (``host_and_card``): its bfloat16 lockstep weighs a
    flip on the lockstep's own rows, not on a rerun."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=2,
                              param_dtype=dtype,
                              moe_capacity_factor=MOE_PARITY_CF)
    return (cfg, *host_and_card(cfg))


def phase_moe_parity() -> dict:
    """olmoe's engines CUDA vs CPU in lockstep (``phase_parity``'s
    workload, prefix and preemption): float32 greedy on a float32 pool,
    whose chunk steps must drop assignments on both devices alike; then
    bfloat16 greedy and bfloat16 on an int8 pool with ``spec_k=4``
    (drafts replayed from the bfloat16 run) through ``moe_lockstep``.
    Returns the card's launches by kernel of each run."""
    models = moe_parity_models("float32")
    with RouteRecorder() as rec:
        excused, _, f32, _ = phase_parity(models, chunk=MOE_PARITY_CHUNK)
    drops = {dev: [c.dropped() for c in rec.on(dev)]
             for dev in ("cuda", "cpu")}
    same, total = rec.agreement()
    check(sum(drops["cuda"]) > 0, "MoE parity f32: no step dropped an "
                                  "assignment")
    if not excused:
        check(drops["cuda"] == drops["cpu"],
              "MoE parity f32: the two devices dropped differently")
    print(f"moe parity: float32 dropped {sum(drops['cuda'])} (cuda) / "
          f"{sum(drops['cpu'])} (cpu) assignments in "
          f"{sum(d > 0 for d in drops['cuda'])} of {len(drops['cuda'])} "
          f"layer calls; top-k sets agree on {same} of {total} rows",
          flush=True)
    del models
    models = moe_parity_models("bfloat16")
    known, bf16 = moe_lockstep(models)
    _, int8 = moe_lockstep(models, kv_dtype="int8", spec_k=4, known=known)
    del models
    return dict(f32=f32, bf16=bf16, int8=int8)


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
def serve_workload(cfg, kv_dtype: str = "bf16", spec_k: int = 0,
                   max_new: int = 32):
    """Phases 5 and 6's engine spec and requests: 12 greedy requests of
    300-700 prompt tokens and ``max_new`` (32) new tokens each; rids 0,
    8, 9 and 10 share a 256-token prefix (0 runs in the first wave and
    publishes it, the other three are admitted after it finishes)."""
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
                                          SamplingParams(max_new=max_new)))
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


def phase_serve(cfg, model, kv_dtype: str = "bf16", spec_k: int = 0,
                mesh: tuple = None, probe: bool = False,
                max_new: int = 32) -> tuple:
    """Serve the workload at full width; the kernels of the pool's type
    must carry every layer of every iteration (their counts are read from
    0 just before the run and just after): the tensor-core kernel every
    prefill and verify iteration, the split-KV kernel every decode one;
    the plain version must never run.  With ``spec_k`` an ``echo_wave``
    follows once the workload is served.  For an MoE model the first
    iteration (a prefill) runs under a ``RouteRecorder`` and its dropped
    assignments are reported.  With ``mesh`` (clusters, heads, lanes and
    pages a cluster) the sharded engine serves it: every (cluster, head)
    shard's kernel carries every layer of every iteration.  With ``mesh``
    or ``probe``, afterwards two more requests are served, a prefill and
    a decode iteration of them under ``torch.profiler`` to count the
    kernels an iteration launches and their busy ms (every cluster runs
    every iteration, busy or not).  Returns (metrics, {rid:
    tokens}, the run: each iteration's kind, wall ms, prefill tokens fed,
    decoding lanes and resident context tokens before it; the engine's
    trace rows and spec)."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.runtime import make_engine
    torch.cuda.reset_peak_memory_stats()
    ecfg, requests = serve_workload(cfg, kv_dtype, spec_k, max_new)
    shards = 1
    if mesh is not None:
        C, H, lanes, pages = mesh
        # the flat num_pages too: replace() would fold the old one back
        ecfg = dataclasses.replace(
            ecfg, clusters=C, heads=H, sharded=True, max_lanes=lanes,
            num_pages=pages,
            cache=dataclasses.replace(ecfg.cache, num_pages=pages))
        shards = C * H
    engine = make_engine(cfg, model, ecfg)
    streamed = {}
    iter_ms = {"prefill": [], "decode": [], "verify": []}
    iters = []
    first = RouteRecorder()

    def step() -> bool:
        if iters or not cfg.moe_num_experts:
            return engine.step()
        with first:
            return engine.step()

    def drive(reqs, preempt_rid=None):
        for r in reqs:
            engine.submit(r)
            streamed[r.rid] = []
        preempted = preempt_rid is None
        while True:
            before = (engine.prefill_tokens, engine.spec_iterations)
            lanes = [r for r in engine.lanes if r is not None]
            ctx = sum(engine._pool(r).seq_len.get(r.rid, 0) for r in lanes)
            decoding = sum(r.fed >= len(r.prompt) for r in lanes)
            t = time.perf_counter()
            busy = step()             # ends in the iteration's D2H pull
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
    kinds = [it["kind"] for it in iters]
    per = cfg.num_layers * shards      # kernel calls an iteration
    check(launches == per * engine.iterations,
          f"{kv_dtype} kernel launches {launches} != {cfg.num_layers} "
          f"layers x {shards} shards x {engine.iterations} iterations")
    n_chunked = kinds.count("prefill") + kinds.count("verify")
    check(tc_launches == per * n_chunked,
          f"{kv_dtype} tensor-core launches {tc_launches} != "
          f"{cfg.num_layers} layers x {shards} shards x {n_chunked} "
          "prefill and verify iterations")
    check(split_launches == per * kinds.count("decode"),
          f"{kv_dtype} split-KV launches {split_launches} != "
          f"{cfg.num_layers} layers x {shards} shards x "
          f"{kinds.count('decode')} decode iterations")
    check(launches == tc_launches + split_launches,
          f"{kv_dtype}: {launches - tc_launches - split_launches} launches "
          "of the FP32-core kernel (bf16 q takes the other two)")
    check(other_launches == 0,
          f"the other pool type's kernel branch ran {other_launches} times")
    check(plain_calls == 0, f"plain attention called {plain_calls} times")
    if spec_k:
        check(engine.spec_proposed > 0, "the drafter never proposed")
    out_tokens = sum(len(r.tokens) for r in results.values())
    first_dropped = sum(c.dropped() for c in first.on("cuda"))
    check(not cfg.moe_num_experts or len(first.calls) == cfg.num_layers,
          f"the first iteration made {len(first.calls)} MoE layer calls")
    row = dict(kv_dtype=kv_dtype, spec_k=spec_k, requests=n_req,
               echo_requests=len(wave), iterations=engine.iterations,
               **{f"{k}_iterations": kinds.count(k) for k in iter_ms},
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
               paged_launches_per_iteration=launches / engine.iterations,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    rows = engine.tracer.drain()
    if mesh is not None or probe:
        probed, busy_ms = {}, {}
        for r in requests[:2]:
            engine.submit(dataclasses.replace(r, rid=1000 + r.rid))
        while len(probed) < 2:
            fed = engine.prefill_tokens
            busy, launched, ms = count_launches(engine.step)
            check(busy, "the launch probe's requests finished unprobed")
            kind = "prefill" if engine.prefill_tokens > fed else "decode"
            if kind not in probed:
                probed[kind], busy_ms[kind] = launched, ms
        engine.run()
        row.update(launches_per_iteration=probed,
                   device_busy_ms_per_iteration=busy_ms)
    if mesh is not None:
        row.update(clusters=mesh[0], heads=mesh[1], lanes_per_cluster=lanes,
                   pages_per_cluster=pages,
                   cluster_report=engine.cluster_report(),
                   pool_bytes=sum(t.numel() * t.element_size()
                                  for c in range(mesh[0])
                                  for pair in engine._shard_pools(c)
                                  for t in pair if t is not None))
    if cfg.moe_num_experts:
        row.update(first_prefill_rows=first.calls[0].idx.shape[0],
                   first_prefill_capacity=first.calls[0].C,
                   first_prefill_dropped=first_dropped,
                   first_prefill_assignments=cfg.num_layers
                   * first.calls[0].idx.numel())
    print(f"serve: {cfg.name} {cfg.num_layers} layers {cfg.param_dtype}, "
          f"kv {kv_dtype}, spec_k={spec_k}, {n_req} requests: "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in row.items()), flush=True)
    return row, {rid: res.tokens for rid, res in results.items()}, dict(
        iters=iters, rows=rows, ecfg=ecfg)


# --------------------------------------------------------------- phase 18 --
#: (a): the sharded engine's float32 lockstep at yi-6b widths x 2 layers:
#: (clusters, heads, kv dtype, spec_k); lanes and pages are per cluster
SHARDED_LOCK = [(2, 2, "bf16", 0), (4, 1, "bf16", 0), (2, 1, "int8", 4)]
#: (b): yi-6b as registered on phase 5's workload, all shards on the one
#: card: (clusters, heads, lanes a cluster, pages a cluster)
SHARDED_FULL = [(1, 1, 8, 1024), (2, 1, 4, 512), (4, 1, 2, 256),
                (2, 2, 4, 512)]
#: (b)'s new tokens a request: the first 16 of phase 5's 32.  They were
#: all 32 until the whole script passed 1,200 s on a slower host; the
#: four meshes' runs and their flips' reruns took ~110 s
SHARDED_NEW = 16


def count_launches(fn) -> tuple:
    """(``fn()``, the kernels it launched on the card, their summed device
    ms): ``torch.profiler`` device events, counted as
    ``scripts/profile_torch_serve.py`` counts them (0 if the profiler sees
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, len(dev), sum(e.device_time_total for e in dev) / 1e3


def on_card(engine) -> bool:
    """Every shard's slab, the lane state and every head shard's weight
    views on the card: no shard quietly on the CPU."""
    tensors = [t for c in range(engine.clusters)
               for pair in engine._shard_pools(c) for t in pair
               if t is not None]
    tensors += [engine.bt_dev, engine.len_dev, engine.active_dev,
                engine.last_tok]
    for shard in engine.head_attn or ():
        tensors += [v for layer in shard for v in layer.values()]
    return all(t.is_cuda for t in tensors)


def phase_sharded_lockstep(models, known: dict) -> dict:
    """Phase 18 (a): phase 4's float32 weights and requests (a shared
    prefix, rid 0 preempted after 3 tokens) on the sharded engine on the
    card, the unsharded engine on the card holding as many lanes and
    pages, and the sharded engine on the CPU, in lockstep, at each
    ``SHARDED_LOCK`` mesh (int8 pages with ``spec_k=4`` and a
    ``ReplayDrafter`` of ``known`` at (2, 1)).  Tokens must agree but for
    near-ties (``excuse_first_flip``, on the rows each engine drew the
    token from in the lockstep); the sharded engines' iterations,
    transfers and spec counters must be equal; every cluster must be
    used; on the card every shard's kernel must carry every layer of
    every iteration and the plain version never run.  Returns the card's
    launches by kernel."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.runtime import (
        CacheConfig, EngineConfig, ShardedPagedServer, make_engine,
    )
    cfg, cpu_model, gpu_model = models
    requests = parity_requests(cfg)
    counters = (K.launches, K.int8_launches, K.tc_launches,
                K.split_launches, R.calls)
    total = dict(fp32_core_launches=0, split_launches=0,
                 fp32_core_int8_launches=0, split_int8_launches=0)
    for C, H, kv_dtype, spec_k in SHARDED_LOCK:
        spec = dict(cache=CacheConfig(num_pages=64, page_size=16,
                                      max_pages_per_seq=8,
                                      kv_dtype=kv_dtype),
                    max_lanes=2, chunk=16, spec_k=spec_k,
                    drafter=ReplayDrafter(known, cfg.vocab_size)
                    if spec_k else None)
        sharded = EngineConfig(clusters=C, heads=H, sharded=True, **spec)
        # the unsharded engine with the mesh's lanes and pages: a lane
        # drafts only while nothing waits, so they decide the drafts
        flat = EngineConfig(**dict(
            spec, max_lanes=2 * C,
            cache=dataclasses.replace(spec["cache"], num_pages=64 * C)))
        engines = [make_engine(cfg, gpu_model, sharded),
                   make_engine(cfg, gpu_model, flat),
                   make_engine(cfg, cpu_model, sharded, device="cpu")]
        g = engines[0]
        check(isinstance(g, ShardedPagedServer) and on_card(g),
              f"({C}, {H}): a shard is not on the card")
        rows = [{}, {}, {}]
        outs, launched = _lockstep(engines, requests, preempt_rid=0,
                                   preempt_after=3, counters=counters,
                                   rows=rows)
        same, int8, tc, split, plain = launched[0]
        kernel = int8 if kv_dtype == "int8" else same
        label = f"sharded ({C}, {H}) float32 kv {kv_dtype} spec_k={spec_k}"
        check(kernel == cfg.num_layers * C * H * g.iterations,
              f"{label}: {kernel} kernel launches != {cfg.num_layers} "
              f"layers x {C * H} shards x {g.iterations} iterations")
        other_pool = same if kv_dtype == "int8" else int8
        check(plain == 0 and tc == 0 and other_pool == 0,
              f"{label}: plain {plain}, tensor-core {tc}, other pool type "
              f"{other_pool} launches")
        check(split > 0, f"{label}: no decode step took the split-KV kernel")
        pre = "" if kv_dtype == "bf16" else "_int8"
        total[f"fp32_core{pre}_launches"] += kernel - split
        total[f"split{pre}_launches"] += split
        excused = 0
        dtype = torch.float32
        for other, name in ((1, "unsharded CUDA"), (2, "sharded CPU")):
            for r in requests:
                a, b = outs[0][r.rid], outs[other][r.rid]
                check(len(a) == len(b) == 8,
                      f"{label} rid {r.rid}: lengths {len(a)}, {len(b)}")
                excused += excuse_first_flip(
                    f"{label} vs {name} rid {r.rid}", r.prompt, a, b,
                    [rows[0].get(r.rid, {}), rows[other].get(r.rid, {})],
                    r.sampling, dtype)
        c = engines[2]
        counts = [(e.iterations, e.h2d_events, e.d2h_events,
                   e.spec_proposed, e.spec_accepted, e.spec_rejected)
                  for e in (g, c)]
        if not excused:
            check(counts[0] == counts[1],
                  f"{label}: the card's and the CPU's sharded engines "
                  f"scheduled differently: {counts}")
        used = {r.cluster for r in g.finished}
        check(len(used) == C, f"{label}: clusters used {sorted(used)}")
        check(g.preemptions >= 1, f"{label}: no preemption")
        if spec_k:
            check(g.spec_accepted > 0 and g.spec_rejected > 0,
                  f"{label}: speculation accepted {g.spec_accepted} and "
                  f"rejected {g.spec_rejected}")
        print(f"sharded lockstep: {label}: identical={excused == 0}, "
              f"excused_positions={excused}, iterations/h2d/d2h/spec card "
              f"{counts[0]} cpu {counts[1]}, unsharded card iterations "
              f"{engines[1].iterations}, clusters used {sorted(used)}, "
              f"kernel_launches={kernel}, split_kv_launches={split}, "
              f"prefix_hit_tokens={g.cache_stats().prefix_hit_tokens}",
              flush=True)
    return total


def excuse_path_flip(label: str, prompt, a, b, makers: dict,
                     dtype: torch.dtype) -> bool:
    """``excuse_first_flip`` for two greedy runs whose schedules differ:
    the same position's token may come from a decode step in one run and
    from a prefill chunk in the other, so the streams' first flip is
    weighed against every legitimate evaluation of its context.  On each
    engine of ``makers`` (the mesh's and the unsharded, the reference
    last) the context runs through the decode path and through a
    128-token chunk (``path_row``); every row must agree with the
    reference's decode-path row (``logits_agree``), and the pair rule of
    ``flip_margin`` must hold against the row that disagrees with it
    most on the two tokens.  Returns whether they differed (and were
    excused)."""
    from repro_torch.runtime import SamplingParams
    check(len(a) == len(b), f"{label}: lengths {len(a)}, {len(b)}")
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return False
    ctx = tuple(prompt) + tuple(b[:j])
    x, y = a[j], b[j]
    rows = {f"{name} {path}": path_row(make(), ctx, chunk)
            for name, make in makers.items()
            for path, chunk in (("decode", 1), ("chunk", 128))}
    ref = rows.pop(f"{list(makers)[-1]} decode")
    for name, row in rows.items():
        logits_agree([row, ref], dtype, f"{label} token {j} ({name})")

    def disagreement(row):
        return abs(((row[y] - row[x]) - (ref[y] - ref[x])).item())
    name = max(rows, key=lambda k: disagreement(rows[k]))
    ok, numbers = flip_margin([rows[name], ref], x, y, SamplingParams(),
                              len(ctx), dtype, f"{label} token {j}")
    check(ok, f"{label} token {j}: {x} != {y}, against the {name} row: "
              f"{numbers}")
    print(f"{label} token {j} excused against the {name} row: {numbers}",
          flush=True)
    return True


def phase_sharded_serve(cfg, model, phase5_tokens: dict) -> dict:
    """Phase 18 (b): yi-6b as registered serves phase 5's requests, cut to
    ``SHARDED_NEW`` new tokens, on the sharded engine at each
    ``SHARDED_FULL`` mesh, every shard on the one card (``phase_serve``
    with ``mesh``).  The tokens must be the first of phase 5's unsharded
    run's but for near-ties (``excuse_path_flip``: the meshes
    schedule the workload differently, so a token decoded in one run may
    come from a prefill chunk in the other); every cluster must be
    dispatched to (``layer2_cluster_balance``); the peak memory at (2, 2)
    and (4, 1) must stay within (1, 1)'s plus their extra pool bytes
    (the weights are held once, whatever the mesh).  Prints each mesh's
    ``cluster_report()``, tokens/s, iteration walls, launches an
    iteration and peak memory.  Returns the runs by mesh."""
    from repro_torch.core.analysis import (
        layer1_decode, layer2_cluster_balance,
    )
    from repro_torch.runtime import make_engine
    runs = {}
    dtype = getattr(torch, cfg.param_dtype)
    for mesh in SHARDED_FULL:
        C, H = mesh[:2]
        gc.collect()
        torch.cuda.empty_cache()
        row, tokens, run = phase_serve(cfg, model, mesh=mesh,
                                       max_new=SHARDED_NEW)
        label = f"sharded full ({C}, {H})"
        # a rerun on one cluster of the mesh: each cluster runs the same
        # program on its own lanes, so one cluster's engine (as many lanes,
        # pages and heads) gives a request alone the mesh's numerics
        # without stepping the idle clusters
        one = dataclasses.replace(run["ecfg"], clusters=1)
        flat, requests = serve_workload(cfg, max_new=SHARDED_NEW)
        excused = 0
        for r in requests:
            excused += excuse_path_flip(
                f"{label} vs phase 5 rid {r.rid}", r.prompt,
                list(tokens[r.rid]),
                list(phase5_tokens[r.rid][:SHARDED_NEW]),
                {"mesh": lambda: make_engine(cfg, model, one),
                 "unsharded": lambda: make_engine(cfg, model, flat)}, dtype)
        bal = layer2_cluster_balance(layer1_decode(run["rows"]),
                                     n_clusters=C)
        idle = [c for c, v in bal["clusters"].items() if not v["dispatches"]]
        check(not idle, f"{label}: clusters {idle} never dispatched to")
        row.update(excused_positions=excused,
                   dispatch_balance=bal["balance"])
        runs[mesh[:2]] = row
        print(f"sharded full: ({C}, {H}) {mesh[2]} lanes x {mesh[3]} pages "
              f"a cluster: identical_to_phase5={excused == 0}, "
              f"excused_positions={excused}, "
              f"tokens_per_s={row['output_tokens_per_s']:.4f}, "
              f"prefill/decode iteration ms (median) "
              f"{row.get('prefill_iter_ms_median', 0.0):.4f} / "
              f"{row.get('decode_iter_ms_median', 0.0):.4f}, "
              f"launches an iteration {row['launches_per_iteration']}, "
              f"device busy ms an iteration "
              f"{row['device_busy_ms_per_iteration']}, "
              f"paged launches an iteration "
              f"{row['paged_launches_per_iteration']:.1f}, "
              f"peak {row['max_memory_allocated']}, "
              f"pool {row['pool_bytes']}, dispatch balance "
              f"{bal['balance']:.4f}, cluster_report "
              f"{json.dumps(row['cluster_report'])}", flush=True)
    one = runs[(1, 1)]
    for mesh in ((2, 2), (4, 1)):
        r = runs[mesh]
        extra = r["pool_bytes"] - one["pool_bytes"]
        check(r["max_memory_allocated"] <= one["max_memory_allocated"]
              + extra,
              f"sharded full {mesh}: peak {r['max_memory_allocated']} > "
              f"(1, 1)'s {one['max_memory_allocated']} + {extra} extra "
              "pool bytes: are the weights copied per shard?")
    return runs


# ------------------------------------------------------ phases 4 and 13 --
def phase_draft_parity(models, k: int = 4) -> dict:
    """Phase 4's bfloat16 weights as a ``DraftModelDrafter`` on the card
    (every self-attention on the tensor-core flash kernel, the plain
    version none) and on the CPU (the plain version), from one random
    context of ``DRAFT_CTX`` tokens (bucketed inside phase 13's draft
    lengths): the logits after the context must agree
    (``logits_agree``) and the ``k`` proposals must be equal but for a
    near-tie (``excuse_first_flip``, on each drafter's own forward over
    the context up to the flip: a drafter's rows are its model's, not an
    engine step's)."""
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
        return path_row(make_engine(cfg, model, plain), ctx, chunk)

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


# -------------------------------------------------------------- phase 16 --
def phase_moe_serve() -> tuple:
    """olmoe-1b-7b as registered (16 layers, d 2048, 16/16 heads at hd
    128, 64 experts top-8, vocab 50,304, bf16, random weights from seed
    0) serving phase 5's workload, then phase 6's (int8 pages,
    ``spec_k=4``, the echo wave), through ``phase_serve``: the paged
    kernels must carry every layer of every iteration.  Returns the two
    runs' metrics."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("olmoe-1b-7b")
    resident = torch.cuda.memory_allocated()
    check(resident < 4 << 30, f"phase 16: {resident} bytes still allocated "
                              "before olmoe's weights (yi-6b not freed)")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"init: olmoe-1b-7b bf16 weights in "
          f"{time.perf_counter() - t0:.2f} s, {resident} bytes allocated "
          f"before, {torch.cuda.memory_allocated()} after", flush=True)
    serve, _, _ = phase_serve(cfg, model)
    serve8, _, _ = phase_serve(cfg, model, kv_dtype="int8", spec_k=4)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return serve, serve8


# -------------------------------------------------------------- phase 17 --
#: phase 17's families, at full width
RECURRENT = ("hymba-1.5b", "xlstm-350m")
#: (a) lockstep depths (hymba x 2 layers; xlstm x 8, one sLSTM group),
#: lanes, the prompt fed by decode, the greedy steps after it, and the
#: window that makes hymba's ring wrap within them
LOCK_DEPTH = {"hymba-1.5b": 2, "xlstm-350m": 8}
#: (a)'s bar on two devices' float32 prefill logits, of the largest
#: |logit|: ``MODEL_TOL``'s 1e-5 for hymba.  xlstm's float32 evaluation
#: is itself that far from a float64 one: at these 8 layers and this
#: prompt the CPU's logits stand 1.02e-5 x max off the same weights in
#: float64 and the card's 9.13e-6 (the residual stream 9e-7 off after
#: the sLSTM cell, 1.69e-4 after the seventh mLSTM cell;
#: ``scripts/float64_check.py --parts lockstep --device cuda``), so the
#: two devices may differ by their sum, ~1.9e-5 (1.67e-5 measured)
LOCK_TOL = {"hymba-1.5b": MODEL_TOL[torch.float32], "xlstm-350m": 4e-5}
#: the bar on each decode step's logits before a lane's first flip:
#: twice ``LOCK_TOL``.  A step's logits carry the whole prompt's
#: rounding through the recurrent state, and each device's own distance
#: from float64 peaks on a few steps: hymba lane 0 step 12 (CPU 9.42e-6,
#: card 3.51e-6; the devices 1.27e-5 apart), xlstm lane 1 step 4 (CPU
#: 5.69e-5, card 1.27e-5; 4.42e-5 apart) and lane 0 step 1 (CPU 3.8e-5;
#: 4.76e-5 apart).  Twice the bar covers the sum of both devices'
#: largest distances (1.29e-5 and 7.53e-5)
LOCK_STEP_TOL = {k: 2 * v for k, v in LOCK_TOL.items()}
LOCK_B, LOCK_PROMPT, LOCK_STEPS, LOCK_WINDOW = 2, 40, 16, 32
#: (b) the full-width prefill; (c) the prompt fed by decode and the greedy
#: steps timed after it.  The prompt was 256 tokens until the whole script
#: passed 1,200 s on a slower host: fed one token a step through three
#: models of each family, it took ~60 s
PREFILL_B, PREFILL_S = 2, 3072
DEC_B, DEC_PROMPT, DEC_STEPS = 2, 64, 32
#: (d) timed steps at decode_32k
D32K_STEPS = 5
#: (c)'s bar, of the largest |logit|: ``MODEL_TOL``'s bf16 bar, held on
#: the bf16 model at ``DEC_GATE_LAYERS`` layers of full width and on
#: float32 weights at ``DEC_F32_LAYERS`` layers.  As registered, a bf16
#: model's decode and prefill drift further apart (random weights amplify
#: the rounding layer by layer, in the reference as in the port), so that
#: difference is recorded
DEC_TOL = MODEL_TOL[torch.bfloat16]
DEC_GATE_LAYERS = 8
#: the float32 gate's depth: 16 of hymba's 32 alike layers and of
#: xlstm's 24 (two of its three sLSTM groups).  It ran as registered until
#: the script neared 1,100 s on a slower host; the prompt fed one token a
#: step through the float32 model was its longest part
DEC_F32_LAYERS = 16


def recurrent_prompt(cfg, B: int, S: int, seed: int,
                     device="cuda") -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         dtype=torch.int32).to(device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (``b`` the reference)."""
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def greedy_decode(cfg, model, prompt: torch.Tensor, steps: int,
                  frames: torch.Tensor = None) -> tuple:
    """``prompt`` (B, P) fed one token a step by ``decode_forward`` from an
    empty cache of P + steps - 1 positions, then ``steps`` greedy tokens.
    An encoder-decoder's cross cache is ``encdec_cross_cache`` of
    ``frames`` (B, F, d); a patch frontend's ``frames`` (B, Fs, d) are
    fed as ``inputs_embeds`` at positions < Fs, as ``forward_fullseq``
    puts them in place of those tokens.  Returns (tokens (steps lists of
    B), the float32 logits (B, V) that chose each token, on the host,
    seconds of each step after the prompt)."""
    from repro_torch.models import model as M
    dev = prompt.device
    B, P = prompt.shape
    cache = M.init_cache(cfg, B, P + steps - 1, dev)
    patches = frames if cfg.frontend == "patch" else None
    if cfg.block_kind == "encdec":
        cache["xk"], cache["xv"] = M.encdec_cross_cache(cfg, model, frames)

    def pos(t):
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    for t in range(P):
        embeds = patches[:, t:t + 1] if patches is not None and \
            t < patches.shape[1] else None
        logits, cache = M.decode_forward(cfg, model, cache,
                                         prompt[:, t:t + 1], pos(t),
                                         inputs_embeds=embeds)
    toks, rows, step_s = [], [], []
    for j in range(steps):
        rows.append(logits[:, 0].float().cpu())
        nxt = logits[:, 0].argmax(dim=-1).to(torch.int32)
        toks.append(nxt.tolist())
        if j == steps - 1:
            break
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = M.decode_forward(cfg, model, cache, nxt[:, None],
                                         pos(P + j))
        sync(dev)
        step_s.append(time.perf_counter() - t0)
    return toks, rows, step_s


def recurrent_lockstep(arch: str, window: int = 0) -> dict:
    """(a): the arch's widths at ``LOCK_DEPTH`` layers in float32, the same
    weights on both devices: ``prefill_logits`` of a ``LOCK_PROMPT``-token
    prompt within ``LOCK_TOL`` x the largest |logit|;
    then the prompt fed by ``decode_forward`` and ``LOCK_STEPS`` greedy
    steps, tokens equal under phase 4's rule: a lane's first flip must be
    a near-tie (``flip_margin``, whose rows must agree within
    ``LOCK_TOL``); each earlier step's logits within
    ``LOCK_STEP_TOL`` x the largest |logit|.  ``window`` replaces the
    sliding window (hymba's ring then wraps)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import model as M
    kw = {"sliding_window": window} if window else {}
    cfg = dataclasses.replace(get_config(arch), num_layers=LOCK_DEPTH[arch],
                              param_dtype="float32", **kw)
    label = f"lockstep {arch}" + (f" window {window}" if window else "")
    ref_model = M.init_params(cfg, seed=0, device="cpu")
    model = copy.deepcopy(ref_model).to("cuda")
    prompt = recurrent_prompt(cfg, LOCK_B, LOCK_PROMPT, 17, "cpu")
    FK.launches.reset()
    FO.plain_forwards.reset()
    with torch.no_grad():
        a = M.prefill_logits(cfg, model, {"tokens": prompt.cuda()})
        torch.cuda.synchronize()
        launches, plain = FK.launches.n, FO.plain_forwards.n
        b = M.prefill_logits(cfg, ref_model, {"tokens": prompt})
    prefill_diff, gate = logits_agree([a[:, 0], b[:, 0]], torch.float32,
                                      f"{label} prefill", LOCK_TOL[arch])
    attn = cfg.num_layers if cfg.block_kind == "hymba" else 0
    check(launches == attn and plain == 0,
          f"{label}: prefill made {launches} flash launches and "
          f"{plain} plain forwards on the card; want {attn} and 0")
    ta, ra, _ = greedy_decode(cfg, model, prompt.cuda(), LOCK_STEPS)
    tb, rb, _ = greedy_decode(cfg, ref_model, prompt, LOCK_STEPS)
    flips, rel = lockstep_streams(label, (ta, ra), (tb, rb), LOCK_PROMPT,
                                  LOCK_TOL[arch], LOCK_STEP_TOL[arch])
    if window:
        check(window < LOCK_PROMPT + LOCK_STEPS - 1,
              f"{label}: the ring of {window} slots does not wrap")
    row = dict(arch=arch, layers=cfg.num_layers, window=cfg.sliding_window,
               prefill_max_abs_diff=prefill_diff, prefill_gate=gate,
               decode_rel_diff=rel, flips=flips, flash_launches=launches,
               tokens=ta)
    print(f"{label}: prefill logits max |diff| {prefill_diff:.3g} <= "
          f"{gate:.3g}; {LOCK_STEPS} greedy steps x {LOCK_B} lanes after a "
          f"{LOCK_PROMPT}-token prompt fed by decode, flips excused "
          f"{flips}; flash launches {launches}; each step's logits max "
          f"|diff| / max |logit| per lane (before a flip, <= "
          f"{LOCK_STEP_TOL[arch]:.3g}): "
          + json.dumps([[float(f"{x:.3g}") for x in r] for r in rel]),
          flush=True)
    return row


def lockstep_streams(label: str, a: tuple, b: tuple, prompt_len: int,
                     tol: float, step_tol: float) -> tuple:
    """Two devices' greedy streams (``greedy_decode``'s tokens and rows;
    ``b`` the reference): each lane's first flip must be a near-tie
    (``flip_margin`` on that step's rows, which must agree within
    ``tol``), each earlier step's logits within ``step_tol`` x the
    largest |logit|.  Returns (flips, per lane the steps' max |diff| /
    max |logit|)."""
    from repro_torch.runtime import SamplingParams
    (ta, ra), (tb, rb) = a, b
    flips, rel = 0, []
    for lane in range(len(ta[0])):
        sa = [t[lane] for t in ta]
        sb = [t[lane] for t in tb]
        j = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y),
                 None)
        rel.append([((ra[s][lane].double() - rb[s][lane].double()).abs()
                     .max() / rb[s][lane].double().abs().max()).item()
                    for s in range(len(ta) if j is None else j)])
        worst = max(rel[-1], default=0.0)
        check(worst <= step_tol,
              f"{label} lane {lane}: a step's logits differ by {worst:.3g} "
              f"x max|logit| > {step_tol}")
        if j is not None:
            ok, numbers = flip_margin([ra[j][lane], rb[j][lane]], sa[j],
                                      sb[j], SamplingParams(),
                                      prompt_len + j, torch.float32,
                                      f"{label} lane {lane} step {j}", tol)
            check(ok, f"{label} lane {lane} step {j}: {sa[j]} != {sb[j]}, "
                      f"{numbers}")
            print(f"{label} lane {lane} step {j} excused: {numbers}",
                  flush=True)
            flips += 1
    return flips, rel


def recurrent_breakdown(cfg, model, prompt: torch.Tensor,
                        timer: Timer) -> dict:
    """Device ms of one layer's blocks on layer 0's normed input at the
    prefill's shape: hymba's attention (the flash kernel and its
    projections) and Mamba scan; xlstm's sLSTM and mLSTM cells."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    x = L.embed_tokens(cfg, model.embed, prompt)
    if cfg.block_kind == "hymba":
        lp = model.layers[0]
        h = L.norm_forward(cfg, lp["ln1"], x)
        parts = {"attention": lambda: A.gqa_fullseq(
            cfg, lp["attn"], h, None, window=cfg.sliding_window),
            "mamba": lambda: S.mamba_fullseq(cfg, lp["mamba"], h)}
        per = {"attention": cfg.num_layers, "mamba": cfg.num_layers}
    else:
        h = L.norm_forward(cfg, model.slstm_layers[0]["ln1"], x)
        parts = {"slstm": lambda: S.slstm_fullseq(
            cfg, model.slstm_layers[0]["cell"], h),
            "mlstm": lambda: S.mlstm_fullseq(
            cfg, model.mlstm_layers[0]["cell"], h)}
        per = {"slstm": len(model.slstm_layers),
               "mlstm": len(model.mlstm_layers)}
    with torch.no_grad():
        return {k: dict(ms=timer.ms(fn, reps=3, warmup=1), layers=per[k])
                for k, fn in parts.items()}


def fill_decode_cache(cfg, cache, pos: int, seed: int):
    """A full cache at position ``pos`` from ``seed``: K/V and recurrent
    state drawn N(0, 0.1^2) (sLSTM's normaliser from U(1, 2), stabilisers
    0), every ``kpos`` holding the positions ``pos - W`` .. ``pos - 1``
    at their ring slots.  Returns the bytes the cache holds."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for key, val in cache.items():
        if key.startswith("kpos"):
            W = val.shape[1]
            s = torch.arange(W, device=val.device)
            val.copy_((pos - W + (s - (pos - W)) % W).to(val.dtype))
            continue
        for name, ts in (val.items() if isinstance(val, dict)
                         else [(key, val)]):
            for t in ts:
                if name == "m":
                    t.zero_()
                elif key == "slstm" and name == "n":
                    t.uniform_(1.0, 2.0, generator=g)
                else:
                    t.normal_(0.0, 0.1, generator=g)
    return sum(t.numel() * t.element_size() for t in _tensor_leaves(cache))


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, list):
        yield from tree
    else:
        yield tree


def recurrent_full(cfg, timer: Timer) -> dict:
    """(b)-(d) for one arch as registered (bf16, random weights from seed
    0): the full-width prefill, decode against prefill, one decode step
    at decode_32k."""
    from repro_torch.configs import SHAPES
    from repro_torch.core import roofline as R
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.launch import mesh
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    arch = cfg.name
    hymba = cfg.block_kind == "hymba"
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    row = dict(arch=arch, layers=cfg.num_layers,
               init_s=time.perf_counter() - t0,
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()))

    # (b) full-width prefill: the tensor-core flash kernel carries every
    # hymba layer, the plain version none
    prompt = recurrent_prompt(cfg, PREFILL_B, PREFILL_S, 18)
    runs = []
    for c in (FK.launches, FK.tc_launches, FO.plain_forwards):
        c.reset()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = M.prefill_logits(cfg, model, {"tokens": prompt})
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if not runs[1:]:
            launches, tc, plain = (FK.launches.n, FK.tc_launches.n,
                                   FO.plain_forwards.n)
    want = cfg.num_layers if hymba else 0
    check(launches == tc == want and plain == 0,
          f"{arch} prefill: flash launches {launches}, tensor-core {tc}, "
          f"plain forwards {plain}; want {want}, {want}, 0")
    check(tuple(logits.shape) == (PREFILL_B, 1, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {tuple(logits.shape)} {logits.dtype}")
    row.update(prefill_first_s=runs[0], prefill_s=runs[1],
               prefill_tokens_per_s=PREFILL_B * PREFILL_S / runs[1],
               prefill_flash_launches=launches, prefill_tc_launches=tc,
               breakdown=recurrent_breakdown(cfg, model, prompt, timer))
    del logits

    # (c) decode against prefill, held to ``DEC_TOL``: the bf16 model at
    # ``DEC_GATE_LAYERS`` layers, float32 weights at ``DEC_F32_LAYERS``;
    # the bf16 model as registered is recorded and its greedy steps timed
    prompt = recurrent_prompt(cfg, DEC_B, DEC_PROMPT, 19)
    for c in (FK.launches, FK.tc_launches):
        c.reset()
    gates = {}
    for label, dc in (
            ("bf16", dataclasses.replace(cfg, num_layers=DEC_GATE_LAYERS)),
            ("f32", dataclasses.replace(
                cfg, param_dtype="float32",
                num_layers=min(cfg.num_layers, DEC_F32_LAYERS)))):
        dm = M.init_params(dc, seed=0)
        with torch.no_grad():
            want = M.prefill_logits(dc, dm, {"tokens": prompt})[:, 0]
        _, drows, _ = greedy_decode(dc, dm, prompt, 1)
        diff, gate = logits_agree(
            [drows[0], want.cpu()], torch.float32,
            f"{arch} {label} x {dc.num_layers} layers decode vs prefill",
            DEC_TOL)
        gates[label] = dict(layers=dc.num_layers, max_abs_diff=diff,
                            gate=gate, rel=diff / gate * DEC_TOL)
        del dm, want
    row["prefill_dec_fp32_launches"] = FK.launches.n - FK.tc_launches.n
    row["prefill_dec_tc_launches"] = FK.tc_launches.n
    FK.tc_launches.reset()
    with torch.no_grad():
        want = M.prefill_logits(cfg, model, {"tokens": prompt})[:, 0]
    row["prefill_dec_tc_launches"] += FK.tc_launches.n
    t0 = time.perf_counter()
    toks, rows, step_s = greedy_decode(cfg, model, prompt, DEC_STEPS)
    row["decode_total_s"] = time.perf_counter() - t0
    check(all(0 <= t < cfg.vocab_size for ts in toks for t in ts),
          f"{arch}: greedy tokens out of range")
    row.update(decode_vs_prefill=gates,
               decode_vs_prefill_bf16_full_rel=rel_diff(rows[0], want),
               decode_step_ms_median=statistics.median(step_s) * 1e3,
               decode_tokens=toks[:8])

    # (d) one decode step at decode_32k
    shape = SHAPES["decode_32k"]
    B, pos = shape.global_batch, shape.seq_len - 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = M.init_cache(cfg, B, shape.seq_len)
    held = fill_decode_cache(cfg, cache, pos, 20)
    batch = ST.make_batch(cfg, shape,
                          torch.Generator(device="cuda").manual_seed(21))
    step = ST.make_decode_step(cfg)
    times = []
    for i in range(D32K_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(model, cache, batch)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch} decode_32k logits {tuple(logits.shape)}")
    if hymba:
        check(int(cache["kpos"][0, pos % cache["kpos"].shape[1]]) == pos,
              f"{arch} decode_32k: the step's slot does not hold {pos}")
    step_ms = statistics.median(times) * 1e3
    cache_bytes = R.cache_bytes(cfg, shape)
    step_bytes = R.analytic_bytes(cfg, shape, 1)
    row.update(decode_32k=dict(
        batch=B, pos=pos, step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
        tokens_per_s=B / (step_ms * 1e-3), cache_bytes_roofline=cache_bytes,
        cache_bytes_held=held, cache_bound_ms=cache_bytes / mesh.HBM_BW * 1e3,
        step_bytes_roofline=step_bytes,
        step_bound_ms=step_bytes / mesh.HBM_BW * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated()))
    del cache, logits, model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"recurrent full: {arch} " + json.dumps(row), flush=True)
    return row


def phase_recurrent(timer: Timer) -> dict:
    """(a) for both families (hymba again with a 32-slot ring), then
    (b)-(d) for each as registered."""
    from repro_torch.configs import get_config
    lock = [recurrent_lockstep(a) for a in RECURRENT]
    lock.append(recurrent_lockstep("hymba-1.5b", window=LOCK_WINDOW))
    full = {a: recurrent_full(get_config(a), timer) for a in RECURRENT}
    return dict(lockstep=lock, full=full,
                fp32_core_launches=sum(r["flash_launches"] for r in lock)
                + sum(r["prefill_dec_fp32_launches"] for r in full.values()),
                tc_launches=sum(r["prefill_tc_launches"]
                                + r["prefill_dec_tc_launches"]
                                for r in full.values()))


# -------------------------------------------------------------- phase 19 --
#: (a) the frontend families' float32 lockstep at full width: whisper's
#: encoder and decoder layers (and pixtral's layers, on phase 4's
#: engine workload), lanes, the prompt and the greedy steps after it
FRONT_LOCK_LAYERS = 2
FRONT_LOCK_B, FRONT_LOCK_PROMPT, FRONT_LOCK_STEPS = 2, 16, 8
#: (b) whisper-medium as registered: lanes, its 448-token text context
#: (prefilled), greedy steps, and the context's first tokens fed by
#: decode before them.  All 448 were fed until the whole script passed
#: 1,200 s on a slower host (480 steps through 24 + 24 layers: ~20 s)
WHISPER_B, WHISPER_TEXT, WHISPER_STEPS = 4, 448, 32
WHISPER_DEC_TEXT = 64
#: (c) pixtral-12b's model API: lanes, a prompt whose first
#: ``frontend_seq`` (256) positions are patch embeddings, greedy steps.
#: The prompt was 512 tokens until the whole script passed 1,200 s on a
#: slower host (fed one token a step through 40 layers, it took 35 s)
PIXTRAL_B, PIXTRAL_PROMPT, PIXTRAL_STEPS = 2, 320, 8


def frontend_frames(cfg, B: int, seed: int, device="cuda") -> torch.Tensor:
    """Stub frontend embeddings (B, frontend_seq, d) at the data
    pipeline's scale (normal x 0.02), float32 (the model casts them to
    its weights' type), from a seeded generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, cfg.frontend_seq, cfg.d_model), generator=g,
                       device=device) * 0.02


def whisper_lockstep() -> dict:
    """(a) whisper-medium's widths at ``FRONT_LOCK_LAYERS`` encoder and
    decoder layers in float32, the same weights and frames on both
    devices: the encoder's output and ``prefill_logits`` of a
    ``FRONT_LOCK_PROMPT``-token prompt within ``MODEL_TOL`` (1e-5) x
    their largest |value|; then the prompt fed by ``decode_forward``
    (the cross cache from ``encdec_cross_cache``) and
    ``FRONT_LOCK_STEPS`` greedy steps, compared by ``lockstep_streams``
    with each step's logits within twice that.  On the card the FP32-core
    flash kernel carries the encoder's self-attention and the decoder's
    self- and cross-attention of every layer, the plain version none."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import model as M
    cfg = dataclasses.replace(
        get_config("whisper-medium"), num_layers=FRONT_LOCK_LAYERS,
        encoder_layers=FRONT_LOCK_LAYERS, param_dtype="float32")
    label, tol = "lockstep whisper-medium", MODEL_TOL[torch.float32]
    ref_model, model = host_and_card(cfg)
    batch = {"tokens": recurrent_prompt(cfg, FRONT_LOCK_B,
                                        FRONT_LOCK_PROMPT, 22, "cpu"),
             "frontend": frontend_frames(cfg, FRONT_LOCK_B, 21, "cpu")}
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    n0, plain0 = FK.launches.n, FO.plain_forwards.n
    with torch.no_grad():
        enc = M.encode_frontend(cfg, model, dev_batch["frontend"])
        torch.cuda.synchronize()
        enc_launches = FK.launches.n - n0
        a = M.prefill_logits(cfg, model, dev_batch)
        torch.cuda.synchronize()
        launches = FK.launches.n - n0 - enc_launches
        plain = FO.plain_forwards.n - plain0
        enc_ref = M.encode_frontend(cfg, ref_model, batch["frontend"])
        b = M.prefill_logits(cfg, ref_model, batch)
    enc_diff, enc_gate = logits_agree([enc, enc_ref], torch.float32,
                                      f"{label} encoder", tol)
    prefill_diff, gate = logits_agree([a[:, 0], b[:, 0]], torch.float32,
                                      f"{label} prefill", tol)
    want = cfg.encoder_layers + 2 * cfg.num_layers
    check(enc_launches == cfg.encoder_layers and launches == want
          and plain == 0,
          f"{label}: flash launches {enc_launches} (encode), "
          f"{launches} (prefill) and {plain} plain forwards on the "
          f"card; want {cfg.encoder_layers}, {want} and 0")
    ta, ra, _ = greedy_decode(cfg, model, dev_batch["tokens"],
                              FRONT_LOCK_STEPS, dev_batch["frontend"])
    tb, rb, _ = greedy_decode(cfg, ref_model, batch["tokens"],
                              FRONT_LOCK_STEPS, batch["frontend"])
    flips, rel = lockstep_streams(label, (ta, ra), (tb, rb),
                                  FRONT_LOCK_PROMPT, tol, 2 * tol)
    row = dict(arch="whisper-medium", layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers,
               encoder_max_abs_diff=enc_diff, encoder_gate=enc_gate,
               prefill_max_abs_diff=prefill_diff, prefill_gate=gate,
               decode_rel_diff=rel, flips=flips,
               prefill_flash_launches=launches,
               fp32_core_launches=FK.launches.n - n0, tokens=ta)
    print(f"{label}: encoder max |diff| {enc_diff:.3g} <= {enc_gate:.3g}; "
          f"prefill logits max |diff| {prefill_diff:.3g} <= {gate:.3g}; "
          f"{FRONT_LOCK_STEPS} greedy steps x {FRONT_LOCK_B} lanes after a "
          f"{FRONT_LOCK_PROMPT}-token prompt fed by decode, flips excused "
          f"{flips}; flash launches encode {enc_launches}, prefill "
          f"{launches}, in all {row['fp32_core_launches']}; each step's "
          f"logits max |diff| / max |logit| per lane: "
          + json.dumps([[float(f"{x:.3g}") for x in r] for r in rel]),
          flush=True)
    return row


def pixtral_lockstep() -> dict:
    """(a) pixtral-12b's widths at ``FRONT_LOCK_LAYERS`` layers in float32
    served by the CUDA and the CPU ``PagedServer`` on phase 4's workload
    (``phase_parity``): tokens identical, and the paged kernels carrying
    every layer of every iteration of the CUDA engine."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("pixtral-12b"),
                              num_layers=FRONT_LOCK_LAYERS,
                              param_dtype="float32")
    models = (cfg, *host_and_card(cfg))
    excused, _, launched, _ = phase_parity(models)
    check(excused == 0, f"pixtral-12b lockstep: {excused} tokens differ")
    check(launched["launches"] == cfg.num_layers * launched["iterations"],
          f"pixtral-12b lockstep: {launched['launches']} paged launches "
          f"for {cfg.num_layers} layers x {launched['iterations']} "
          "iterations")
    return launched


def whisper_full() -> dict:
    """(b) whisper-medium as registered (24 + 24 layers, bf16, random
    weights from seed 0): ``encode_frontend`` of ``WHISPER_B`` x 1,500
    seeded frames and ``encdec_cross_cache``, ``prefill_logits`` over
    its ``WHISPER_TEXT``-token text context (the tensor-core flash kernel
    carrying 24 encoder, 24 self- and 24 cross-attention calls, the
    plain version none), then the context's first ``WHISPER_DEC_TEXT``
    tokens fed by ``decode_forward`` and ``WHISPER_STEPS`` greedy steps:
    the decode path's logits after them within ``DEC_TOL`` x the largest
    of ``prefill_logits``' of the same tokens.
    That bar sees the frames and the prompts: handing each lane the next
    lane's frames, or the next lane's prompt, must move
    ``prefill_logits`` by more than it.  It prints encode, prefill and
    decode ms, decode tokens/s, the K/V the cache holds beside
    ``roofline.cache_bytes`` and peak memory."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core import roofline as R
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import model as M
    cfg = get_config("whisper-medium")
    B, P, steps = WHISPER_B, WHISPER_TEXT, WHISPER_STEPS
    torch.cuda.reset_peak_memory_stats()
    tc0 = FK.tc_launches.n
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    row = dict(arch=cfg.name, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers, batch=B, text=P,
               frames=cfg.frontend_seq, init_s=time.perf_counter() - t0,
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()))
    frames = frontend_frames(cfg, B, 23)
    prompt = recurrent_prompt(cfg, B, P, 24)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    encode_s = []
    for _ in range(2):              # the first call warms up
        enc, dt = timed(lambda: M.encode_frontend(cfg, model, frames))
        encode_s.append(dt)
    check(tuple(enc.shape) == (B, cfg.frontend_seq, cfg.d_model)
          and bool(torch.isfinite(enc.float()).all()),
          f"{cfg.name} encoder output {tuple(enc.shape)}")
    (xk, _), cross_s = timed(lambda: M.encdec_cross_cache(cfg, model,
                                                          frames))
    check(len(xk) == cfg.num_layers and tuple(xk[0].shape) == (
        B, cfg.frontend_seq, cfg.num_kv_heads, cfg.resolved_head_dim),
        f"{cfg.name} cross cache {len(xk)} x {tuple(xk[0].shape)}")
    del enc, xk
    batch = {"tokens": prompt, "frontend": frames}
    prefill_s = []
    for _ in range(2):              # the launches of the second call
        before = (FK.launches.n, FK.tc_launches.n, FO.plain_forwards.n)
        logits, dt = timed(lambda: M.prefill_logits(cfg, model, batch))
        prefill_s.append(dt)
        launches, tc, plain = (c.n - b for c, b in zip(
            (FK.launches, FK.tc_launches, FO.plain_forwards), before))
    want = cfg.encoder_layers + 2 * cfg.num_layers
    check(launches == tc == want and plain == 0,
          f"{cfg.name} prefill: flash launches {launches}, tensor-core "
          f"{tc}, plain forwards {plain}; want {want}, {want}, 0")
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill logits {tuple(logits.shape)}")
    moved = {}
    for name, other in (("frames", {"tokens": prompt,
                                    "frontend": frames.roll(1, 0)}),
                        ("prompt", {"tokens": prompt.roll(1, 0),
                                    "frontend": frames})):
        rolled, _ = timed(lambda: M.prefill_logits(cfg, model, other))
        moved[name] = rel_diff(rolled[:, 0], logits[:, 0])
        check(moved[name] > DEC_TOL,
              f"{cfg.name}: each lane given the next lane's {name} moves "
              f"prefill's logits by {moved[name]:.3g} of their largest, "
              f"not more than the decode bar {DEC_TOL}")
    del rolled
    dec = prompt[:, :WHISPER_DEC_TEXT]
    want, _ = timed(lambda: M.prefill_logits(cfg, model, {
        "tokens": dec, "frontend": frames}))
    t0 = time.perf_counter()
    toks, rows, step_s = greedy_decode(cfg, model, dec, steps, frames)
    decode_total = time.perf_counter() - t0
    diff, gate = logits_agree([rows[0], want[:, 0].cpu()], torch.float32,
                              f"{cfg.name} decode vs prefill", DEC_TOL)
    check(all(0 <= t < cfg.vocab_size for ts in toks for t in ts),
          f"{cfg.name}: greedy tokens out of range")
    T = P + steps - 1
    cache = M.init_cache(cfg, B, T)
    held = sum(t.numel() * t.element_size() for k in ("k", "v", "xk", "xv")
               for t in cache[k])
    roof = R.cache_bytes(cfg, ShapeSpec("whisper_text", T, B, "decode"))
    check(held == roof,
          f"{cfg.name}: the cache holds {held} K/V bytes, the roofline "
          f"counts {roof}")
    step_ms = statistics.median(step_s) * 1e3
    row.update(encode_s=encode_s, cross_cache_s=cross_s,
               prefill_s=prefill_s, prefill_flash_launches=launches,
               prefill_tc_launches=tc,
               decode_vs_prefill=dict(text=WHISPER_DEC_TEXT,
                                      max_abs_diff=diff, gate=gate,
                                      rel=diff / gate * DEC_TOL),
               prefill_moved_by_rolled=moved,
               decode_total_s=decode_total, decode_step_ms_median=step_ms,
               decode_tokens_per_s=B / (step_ms * 1e-3),
               decode_tokens=toks[:4], cache_kv_bytes_held=held,
               cache_bytes_roofline=roof,
               tc_launches=FK.tc_launches.n - tc0,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del cache, model, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    print(f"frontend full: {cfg.name} " + json.dumps(row), flush=True)
    return row


def pixtral_api(cfg, model) -> dict:
    """(c)'s model API: ``prefill_logits`` of ``PIXTRAL_B`` prompts of
    ``PIXTRAL_PROMPT`` tokens with ``frontend_seq`` patch embeddings at
    their head (the tensor-core flash kernel carrying every layer, the
    plain version none) against ``decode_forward`` fed the same prompts
    step by step, the patch embeddings as ``inputs_embeds`` at those
    positions: its logits after the prompt within ``DEC_TOL`` x the
    largest of ``prefill_logits``'; then ``PIXTRAL_STEPS`` greedy steps,
    timed."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import model as M
    B, P, steps = PIXTRAL_B, PIXTRAL_PROMPT, PIXTRAL_STEPS
    prompt = recurrent_prompt(cfg, B, P, 25)
    patches = frontend_frames(cfg, B, 26)
    n0, tc0, plain0 = FK.launches.n, FK.tc_launches.n, FO.plain_forwards.n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = M.prefill_logits(cfg, model, {"tokens": prompt,
                                             "frontend": patches})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches, tc = FK.launches.n - n0, FK.tc_launches.n - tc0
    plain = FO.plain_forwards.n - plain0
    check(launches == tc == cfg.num_layers and plain == 0,
          f"{cfg.name} prefill: flash launches {launches}, tensor-core "
          f"{tc}, plain forwards {plain}; want {cfg.num_layers}, "
          f"{cfg.num_layers}, 0")
    toks, rows, step_s = greedy_decode(cfg, model, prompt, steps, patches)
    diff, gate = logits_agree([rows[0], want[:, 0].cpu()], torch.float32,
                              f"{cfg.name} decode vs prefill", DEC_TOL)
    step_ms = statistics.median(step_s) * 1e3
    return dict(batch=B, prompt=P, patches=cfg.frontend_seq,
                prefill_s=prefill_s, prefill_flash_launches=launches,
                tc_launches=tc,
                decode_vs_prefill=dict(max_abs_diff=diff, gate=gate,
                                       rel=diff / gate * DEC_TOL),
                decode_step_ms_median=step_ms,
                decode_tokens_per_s=B / (step_ms * 1e-3),
                decode_tokens=toks[:4])


def pixtral_full() -> dict:
    """(c) pixtral-12b as registered (40 layers, d 5120, 32/8 heads at hd
    128, vocab 131,072, bf16, random weights from seed 0, drawn on the
    card): phase 5's workload through ``PagedServer`` (``phase_serve``,
    with a prefill and a decode iteration profiled), then its model API
    (``pixtral_api``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("pixtral-12b")
    resident = torch.cuda.memory_allocated()
    check(resident < 4 << 30, f"phase 19: {resident} bytes still allocated "
                              "before pixtral-12b's weights")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init: pixtral-12b bf16 weights in {init_s:.2f} s, "
          f"{torch.cuda.memory_allocated()} bytes allocated", flush=True)
    serve, _, _ = phase_serve(cfg, model, probe=True)
    api = pixtral_api(cfg, model)
    row = dict(arch=cfg.name, layers=cfg.num_layers, init_s=init_s,
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()),
               serve=serve, api=api,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"frontend full: {cfg.name} " + json.dumps(row), flush=True)
    return row


def phase_frontends() -> dict:
    """(a) both families' float32 lockstep, then (b) whisper-medium and
    (c) pixtral-12b as registered, each freed before the next."""
    whisper_lock = whisper_lockstep()
    pixtral_lock = pixtral_lockstep()
    gc.collect()
    torch.cuda.empty_cache()
    whisper = whisper_full()
    pixtral = pixtral_full()
    return dict(whisper_lock=whisper_lock, pixtral_lock=pixtral_lock,
                whisper=whisper, pixtral=pixtral,
                fp32_core_launches=whisper_lock["fp32_core_launches"],
                tc_launches=whisper["tc_launches"]
                + pixtral["api"]["tc_launches"])


# -------------------------------------------------------------- phase 20 --
#: (a) deepseek-v2-236b's float32 lockstep: its registered widths cut to
#: the dense first layer and one MoE layer, and to 16 routed experts, so
#: that a float32 copy (7.8 GB) fits in host RAM beside the card's; lanes,
#: the prompt and the greedy steps after it
DS_LOCK_CUTS = dict(num_layers=2, moe_num_experts=16)
DS_LOCK_B, DS_LOCK_PROMPT, DS_LOCK_STEPS = 2, 64, 8
#: (b) bf16 at the registered widths and 160 routed experts, cut to the
#: dense first layer and 5 MoE layers (42.5 GB of weights; all 60 layers
#: would be ~470 GB); lanes, the prompt (prefilled, then fed by decode)
#: and the greedy steps after it
DS_LAYERS = 6
DS_B, DS_PROMPT, DS_STEPS = 2, 512, 32
#: the prompt's first tokens fed by decode before the greedy steps.  All
#: 512 were fed until the whole script passed 1,200 s on a slower host
DS_DEC_PROMPT = 128


class FollowPrefillRouting:
    """While active, a prefill's MoE calls are recorded (each layer's
    top-k expert ids, (B*S, k)); once ``decode`` is set, the decode
    path's n-th MoE call (step t = n // layers, MoE layer n % layers)
    routes each lane's row to the experts that prefill chose for its
    position t, gates from the decode's own router logits at them, for
    the first S steps, and counts the rows whose own top-k set agreed.
    Past step S it routes on its own (it wraps
    ``repro_torch.models.moe._route``)."""

    def __init__(self, B: int, S: int):
        self.B, self.S = B, S
        self.prefill, self.decode = [], False
        self.calls = self.agree = self.rows = 0

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._moe, self._real = MOE, MOE._route

        def spy(cfg, router, xf):
            vals, idx = self._real(cfg, router, xf)
            if not self.decode:
                self.prefill.append(idx)
                return vals, idx
            layers = len(self.prefill)
            t, j = divmod(self.calls, layers)
            self.calls += 1
            if t >= self.S:
                return vals, idx
            forced = self.prefill[j].view(self.B, self.S, -1)[:, t]
            same = (torch.sort(idx, dim=-1).values
                    == torch.sort(forced, dim=-1).values).all(dim=-1)
            self.agree += int(same.sum())
            self.rows += idx.shape[0]
            logits = xf.float() @ router
            return logits.gather(1, forced), forced
        MOE._route = spy
        return self

    def __exit__(self, *exc):
        self._moe._route = self._real


def deepseek_lockstep() -> dict:
    """(a) deepseek-v2-236b's registered widths at ``DS_LOCK_CUTS`` in
    float32, the same weights on both devices: ``prefill_logits`` of a
    ``DS_LOCK_PROMPT``-token prompt within ``MODEL_TOL`` (1e-5) x the
    largest |logit| (on the card the FP32-core flash kernel carrying both
    MLA layers at their own head dims, q/k 192 and v 128 with no pad and
    the output its own, each call held against the plain version on its
    inputs; the plain version none), then the prompt fed by
    ``decode_forward`` and ``DS_LOCK_STEPS`` greedy steps, compared by
    ``lockstep_streams`` with each step's logits within twice that."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              param_dtype="float32", **DS_LOCK_CUTS)
    label, tol = "lockstep deepseek-v2-236b", MODEL_TOL[torch.float32]
    t0 = time.perf_counter()
    ref_model, model = host_and_card(cfg)
    init_s = time.perf_counter() - t0
    prompt = recurrent_prompt(cfg, DS_LOCK_B, DS_LOCK_PROMPT, 27, "cpu")
    n0, tc0, plain0 = FK.launches.n, FK.tc_launches.n, FO.plain_forwards.n
    with torch.no_grad():
        with FlashCalls() as flash:
            a = M.prefill_logits(cfg, model, {"tokens": prompt.cuda()})
            torch.cuda.synchronize()
        launches, tc = FK.launches.n - n0, FK.tc_launches.n - tc0
        plain = FO.plain_forwards.n - plain0
        b = M.prefill_logits(cfg, ref_model, {"tokens": prompt})
    prefill_diff, gate = logits_agree([a[:, 0], b[:, 0]], torch.float32,
                                      f"{label} prefill", tol)
    check(launches == cfg.num_layers and tc == 0 and plain == 0,
          f"{label}: prefill made {launches} flash launches ({tc} on the "
          f"tensor cores) and {plain} plain forwards on the card; want "
          f"{cfg.num_layers}, 0 and 0")
    # every MLA layer's float32 call at its own head dims (q/k 192, v 128:
    # no pad, the output the kernel's own, no slice), held against the
    # plain version
    dk = cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
    native = [(q.shape[-1], k.shape[-1], v.shape[-1], out.shape[-1],
               out._base is None and out.is_contiguous())
              for q, k, v, kw, out in flash.calls]
    check(native == [(dk, dk, cfg.mla_v_head_dim, cfg.mla_v_head_dim,
                      True)] * cfg.num_layers
          and all(q.dtype == torch.float32 for q, *_ in flash.calls),
          f"{label} prefill: flash calls (q, k, v, out head dims, own "
          f"output) {native}")
    flash_err = flash.against_plain(f"{label} prefill")
    del flash
    ta, ra, _ = greedy_decode(cfg, model, prompt.cuda(), DS_LOCK_STEPS)
    tb, rb, _ = greedy_decode(cfg, ref_model, prompt, DS_LOCK_STEPS)
    flips, rel = lockstep_streams(label, (ta, ra), (tb, rb), DS_LOCK_PROMPT,
                                  tol, 2 * tol)
    row = dict(arch=cfg.name, layers=cfg.num_layers,
               experts=cfg.moe_num_experts, init_s=init_s,
               prefill_max_abs_diff=prefill_diff, prefill_gate=gate,
               decode_rel_diff=rel, flips=flips,
               fp32_core_launches=launches, flash_max_abs_err=flash_err,
               tokens=ta)
    print(f"{label}: {cfg.num_layers} layers, {cfg.moe_num_experts} "
          f"experts; prefill logits max |diff| {prefill_diff:.3g} <= "
          f"{gate:.3g}; {DS_LOCK_STEPS} greedy steps x {DS_LOCK_B} lanes "
          f"after a {DS_LOCK_PROMPT}-token prompt fed by decode, flips "
          f"excused {flips}; flash launches {launches} at (q/k {dk}, v "
          f"{cfg.mla_v_head_dim}), no pad, max |err| vs plain "
          f"{flash_err:.3g}; each step's logits "
          "max |diff| / max |logit| per lane: "
          + json.dumps([[float(f"{x:.3g}") for x in r] for r in rel]),
          flush=True)
    del model, ref_model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def deepseek_full() -> dict:
    """(b) deepseek-v2-236b at the registered widths and 160 experts, cut
    to ``DS_LAYERS`` layers, bf16, drawn on the card from seed 0:
    ``prefill_logits`` of ``DS_B`` x ``DS_PROMPT`` tokens (timed, the
    tensor-core flash kernel carrying every MLA layer, the plain version
    none; its capacity drops counted), then the prompt's first
    ``DS_DEC_PROMPT`` tokens fed by ``decode_forward`` and ``DS_STEPS``
    greedy steps.  The decode path's logits after them are held within
    ``DEC_TOL`` x the largest of a prefill of the same tokens at capacity
    factor E / k (no assignment drops), the decode routing their rows to
    that prefill's experts (``FollowPrefillRouting``).  It prints the compressed cache's bytes
    beside ``roofline.cache_bytes``, peak memory, and the launches and
    busy ms of one profiled decode step at a full cache beside the step's
    floor on weight bytes."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core import roofline as R
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=DS_LAYERS)
    B, P, steps = DS_B, DS_PROMPT, DS_STEPS
    resident = torch.cuda.memory_allocated()
    check(resident < 4 << 30, f"phase 20: {resident} bytes still allocated "
                              "before deepseek-v2-236b's weights")
    torch.cuda.reset_peak_memory_stats()
    tc0 = FK.tc_launches.n
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    table = model.embed["table"]
    row = dict(arch=cfg.name, layers=cfg.num_layers,
               experts=cfg.moe_num_experts, batch=B, prompt=P,
               init_s=time.perf_counter() - t0,
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()),
               init_peak_bytes=torch.cuda.max_memory_allocated())
    print(f"init: deepseek-v2-236b x {cfg.num_layers} layers bf16 weights "
          f"in {row['init_s']:.2f} s, {row['weight_bytes']} bytes",
          flush=True)
    prompt = recurrent_prompt(cfg, B, P, 28)
    batch = {"tokens": prompt}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    prefill_s = []
    with RouteRecorder() as rec:     # the first call also warms up
        logits, dt = timed(lambda: M.prefill_logits(cfg, model, batch))
    prefill_s.append(dt)
    dropped = [c.dropped() for c in rec.calls]
    before = (FK.launches.n, FK.tc_launches.n, FO.plain_forwards.n)
    with FlashCalls() as flash:
        logits, dt = timed(lambda: M.prefill_logits(cfg, model, batch))
    prefill_s.append(dt)
    launches, tc, plain = (c.n - b for c, b in zip(
        (FK.launches, FK.tc_launches, FO.plain_forwards), before))
    check(launches == tc == cfg.num_layers and plain == 0,
          f"{cfg.name} prefill: flash launches {launches}, tensor-core "
          f"{tc}, plain forwards {plain}; want {cfg.num_layers}, "
          f"{cfg.num_layers}, 0")
    # every MLA layer's call at its own head dims (q/k 192, v 128: no pad,
    # the output the kernel's own), held against the plain version
    flash_err = flash.against_plain(f"{cfg.name} prefill")
    check(all(q.shape[-1] == cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
              and v.shape[-1] == out.shape[-1] == cfg.mla_v_head_dim
              for q, k, v, kw, out in flash.calls),
          f"{cfg.name} prefill: flash calls at head dims "
          f"{[(c[0].shape[-1], c[2].shape[-1]) for c in flash.calls]}")
    del flash
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill logits {tuple(logits.shape)}")
    nodrop = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    Pd = DS_DEC_PROMPT
    dec = {"tokens": prompt[:, :Pd]}
    dropping, _ = timed(lambda: M.prefill_logits(cfg, model, dec))
    follow = FollowPrefillRouting(B, Pd)
    with follow:
        want, _ = timed(lambda: M.prefill_logits(nodrop, model, dec))
        follow.decode = True
        t0 = time.perf_counter()
        toks, rows, step_s = greedy_decode(cfg, model, dec["tokens"], steps)
        decode_total = time.perf_counter() - t0
    check(follow.rows == B * Pd * (cfg.num_layers - 1),
          f"{cfg.name}: {follow.rows} decode rows followed the prefill's "
          f"routing, want {B * Pd * (cfg.num_layers - 1)}")
    diff, gate = logits_agree([rows[0], want[:, 0].cpu()], torch.float32,
                              f"{cfg.name} decode vs prefill", DEC_TOL)
    check(all(0 <= t < cfg.vocab_size for ts in toks for t in ts),
          f"{cfg.name}: greedy tokens out of range")
    T = P + steps
    cache = M.init_cache(cfg, B, T)
    fill_decode_cache(cfg, cache, T - 1, 29)
    held = sum(t.numel() * t.element_size() for k in ("c", "rope")
               for t in cache[k])
    roof = R.cache_bytes(cfg, ShapeSpec("deepseek_decode", T, B, "decode"))
    check(held == roof,
          f"{cfg.name}: the cache holds {held} bytes, the roofline counts "
          f"{roof}")
    tok = torch.tensor(toks[-1], dtype=torch.int32, device="cuda")[:, None]
    pos = torch.full((B,), T - 1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        (step_logits, _), step_launches, busy_ms = count_launches(
            lambda: M.decode_forward(cfg, model, cache, tok, pos))
    check(bool(torch.isfinite(step_logits).all()),
          f"{cfg.name}: the profiled decode step's logits are not finite")
    read = row["weight_bytes"] - table.numel() * table.element_size() \
        + B * cfg.d_model * table.element_size()
    step_ms = statistics.median(step_s) * 1e3
    row.update(prefill_s=prefill_s, prefill_dropped=dropped,
               prefill_flash_launches=launches, prefill_tc_launches=tc,
               prefill_flash_max_abs_err=flash_err,
               decode_vs_prefill=dict(prompt=Pd, max_abs_diff=diff,
                                      gate=gate, rel=diff / gate * DEC_TOL),
               decode_vs_dropping_prefill=rel_diff(rows[0], dropping[:, 0]),
               decode_own_routing_agreed=[follow.agree, follow.rows],
               decode_total_s=decode_total, decode_step_ms_median=step_ms,
               decode_tokens_per_s=B / (step_ms * 1e-3),
               decode_tokens=[t for t in toks[:4]], cache_bytes_held=held,
               cache_bytes_roofline=roof, profiled_step=dict(
                   launches=step_launches, busy_ms=busy_ms,
                   weight_bytes_read=read,
                   floor_ms=read / HBM_BYTES_PER_S * 1e3),
               tc_launches=FK.tc_launches.n - tc0,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del cache, model, logits, want, dropping, step_logits, table
    gc.collect()
    torch.cuda.empty_cache()
    print(f"deepseek full: {cfg.name} " + json.dumps(row), flush=True)
    return row


def phase_deepseek() -> dict:
    """(a) the float32 lockstep, then (b) the bf16 model at the cut
    depth."""
    lock = deepseek_lockstep()
    full = deepseek_full()
    return dict(lock=lock, full=full,
                fp32_core_launches=lock["fp32_core_launches"],
                tc_launches=full["tc_launches"])


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


class FlashCalls:
    """While active, records every call of the flash kernel's wrapper
    (``kernel.flash_attention_fwd``, through which ``ops`` reaches it):
    its operands, keywords and output, kept by reference (no copy, no
    device work) so that a timed run stays as it is; the launches and
    their counts are the wrapper's own.  ``against_plain`` then holds each
    output against the plain version on the same operands."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel as FK
        self.calls, self._fk, self._fn = [], FK, FK.flash_attention_fwd

        def record(q, k, v, **kw):
            out = self._fn(q, k, v, **kw)
            self.calls.append((q, k, v, kw, out))
            return out

        FK.flash_attention_fwd = record
        return self

    def __exit__(self, *exc):
        self._fk.flash_attention_fwd = self._fn

    def against_plain(self, label: str) -> float:
        """The largest |kernel - plain| over the recorded calls; fails
        past the output type's ``FLASH_TOL``."""
        from repro_torch.kernels.flash_attention import ref as FR
        worst = 0.0
        for q, k, v, kw, out in self.calls:
            G = kw.get("groups", 1)
            ref = FR.flash_attention_ref(
                q, k.repeat_interleave(G, 0), v.repeat_interleave(G, 0),
                causal=kw.get("causal", True), window=kw.get("window", 0),
                cap=kw.get("cap", 0.0), scale=kw.get("scale"))
            tol = FLASH_TOL[out.dtype]
            err = (out.float() - ref.float()).abs().max().item()
            check(torch.allclose(out.float(), ref.float(), rtol=tol,
                                 atol=tol),
                  f"{label}: flash call {tuple(q.shape)} x "
                  f"{tuple(v.shape)} vs plain max |err| {err}")
            worst = max(worst, err)
            del ref
        print(f"{label}: {len(self.calls)} flash calls vs plain: "
              f"max_abs_err={worst:.3g}", flush=True)
        return worst


#: whisper-medium's three flash calls at B=4 x H=16 flat heads (G = 1),
#: hd 64, its 1,500 frames and its 448-token text context: ((BH, S, T,
#: hd), causal) of the encoder's self-attention, the decoder's
#: cross-attention (S != T, both partial last tiles) and its causal
#: self-attention
WHISPER_FLASH = [((64, 1500, 1500, 64), False), ((64, 448, 1500, 64), False),
                 ((64, 448, 448, 64), True)]
#: train_100m's flash call (``launch/train_100m.py``: B=8 x H=10 flat
#: heads over B x Kv=5 KV rows, hd 64, causal, S=T=256): (BH, S, T, hd),
#: groups
TRAIN_100M_FLASH = ((8 * 10, 256, 256, 64), 2)



def flash_case(timer: Timer, BH: int, S: int, T: int, d: int,
               dtype: torch.dtype, causal: bool, window: int, cap: float,
               groups: int = 1, qk: float = 0.3, seed: int = 0,
               dv: int = 0, library: bool = True) -> dict:
    """One case of phase 9: the flash kernel against its plain version
    (K/V repeated by ``groups`` for it), then timed beside the plain
    version and the library call (``flash_library``, itself held against
    the plain version and its error recorded), with its bytes, operations
    (2 (d + dv) per visible (query, key) pair per head: 4 hd where v's
    head dim is q's) and roofline bound.  q and k are N(0, qk^2): scores
    have std qk^2 (0.09 at the default, as tests/test_kernels.py draws
    them; 16 at ``FLASH_SHARP``, where the cap bites and the softmax is
    peaky).  v is N(0, 1), of head dim ``dv`` (``d`` if 0); where that
    is not ``d`` the op (``ops.flash_attention``) runs and is timed whole
    at the scale 1/sqrt(d): the kernel on the operands as they are where
    it has the pair (MLA in either type: no pad, its output the kernel's
    own), else on q, k and v zero-padded to ``kernel.head_dims``; the
    plain version and the library call take the unpadded operands.  The
    padded route's parts are timed alone, the pads to hd 256 and the
    kernel on the padded operands, and on the native route the whole old
    route (pads, kernel, slice) beside them.  Without ``library`` the
    library call is not made (its fields are None): a capped case
    compiles its own ``flex_attention``, 3-20 s each on the card's
    host."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR
    dv = dv or d
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(BH, S, d, generator=g, device="cuda") * qk).to(dtype)
    k = (torch.randn(BH // groups, T, d, generator=g, device="cuda")
         * qk).to(dtype)
    v = torch.randn(BH // groups, T, dv, generator=g, device="cuda").to(dtype)
    dt = str(dtype).replace("torch.", "")
    hd, hdv = FK.head_dims(dtype, d, dv)
    route = FK.route(dtype, d, dv)
    native = dv != d and hd == d
    name = (f"flash BH={BH} S={S} T={T} d={d}"
            + (f" dv={dv} (native)" if native else f" dv={dv} (padded to "
               f"{hd})" if dv != d else "")
            + f" G={groups} {dt} causal={causal} window={window} cap={cap} "
            f"qk={qk}")

    def kernel():
        if dv != d:
            with torch.no_grad():
                return FO.flash_attention(q, k, v, causal, window, cap,
                                          groups, scale=1 / math.sqrt(d))
        return FK.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      cap=cap, groups=groups)

    def plain():
        return FR.flash_attention_ref(
            q, k.repeat_interleave(groups, 0), v.repeat_interleave(groups, 0),
            causal=causal, window=window, cap=cap)

    span, splits = FK.fp32_plan(BH, S, T, hd, causal, window, hdv) \
        if route == FK.FP32_CORES else (0, 1)
    tc_plan = FK.tc_plan(BH, S, d, dv) if route == FK.TENSOR_CORES else None
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
    check(out.dtype == dtype and tuple(out.shape) == (BH, S, dv),
          f"{name}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()),
          f"{name}: non-finite kernel output")
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"{name}: kernel vs plain max |err| {err}")
    if native:      # the kernel's own output: no pad of the operands, no
        # slice of a wider output
        check(all(a is b for a, b in zip(FO.pad_head_dims(q, k, v),
                                         (q, k, v)))
              and out._base is None and out.is_contiguous(),
              f"{name}: the native route padded or sliced")
    del out
    library_ms = library_err = library_first_s = None
    if library:
        lib = flash_library(q, k, v, causal, window, cap)
        t0 = time.perf_counter()
        lib_out = lib().squeeze(0)
        torch.cuda.synchronize()
        library_first_s = time.perf_counter() - t0
        library_err = (lib_out.float() - ref.float()).abs().max().item()
        del lib_out
    del ref
    ms = timer.ms(kernel)
    parts = {}
    if dv != d:     # the padded route's parts: the pads, the kernel alone
        width = FK.HEAD_DIMS[-1] if native else hd

        def pad():
            return [F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v)]

        def padded_route():
            return FK.flash_attention_fwd(
                *pad(), causal=causal, window=window, cap=cap,
                groups=groups, scale=1 / math.sqrt(d))[..., :dv]

        padded = pad()
        parts = dict(pad_ms=timer.ms(pad),
                     padded_kernel_ms=timer.ms(lambda: FK.flash_attention_fwd(
                         *padded, causal=causal, window=window, cap=cap,
                         groups=groups, scale=1 / math.sqrt(d))))
        if native:
            parts["padded_route_ms"] = timer.ms(padded_route)
        del padded
    plain_ms = timer.ms(plain, reps=5)
    if library:
        library_ms = timer.ms(lib)
    pairs = int(FR.visible_mask(S, T, causal, window, "cuda").sum())
    flops = 2 * (d + dv) * BH * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + BH * S * dv) \
        * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(BH=BH, S=S, T=T, d=d, dv=dv, padded_hd=hd, native=native,
               groups=groups, dtype=dt,
               causal=causal, window=window, cap=cap, qk=qk, kernel=route,
               span_keys=span, splits=splits,
               tc_plan=tc_plan and tc_plan._asdict(), max_abs_err=err,
               ref_max_abs=ref_max, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library=("flex_attention" if cap else "sdpa")
               if library else None,
               library_max_abs_err=library_err,
               library_first_call_s=library_first_s,
               bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               share_of_bound=bound_ms / ms,
               tflops=flops / (ms * 1e-3) / 1e12, **parts)
    print(f"kernel {name}: kernel={route} splits={splits} "
          f"span_keys={span} "
          + (f"tc_plan={tuple(tc_plan)} " if tc_plan else "")
          + f"ms={ms:.4f} "
          + "".join(f"{k}={v:.4f} " for k, v in parts.items())
          + f"plain_ms={plain_ms:.4f} "
          + (f"library_ms={library_ms:.4f} ({row['library']}, max_abs_err "
             f"{library_err:.3g}, first call {library_first_s:.2f} s) "
             if library_ms is not None else "library_ms=None (not timed) ")
          + f"bytes={nbytes} flops={flops} "
          f"bound_ms={bound_ms:.5f} ({row['bound_by']}) "
          f"share_of_bound={row['share_of_bound']:.4f} "
          f"tflops={row['tflops']:.2f} max_abs_err={err:.3g} "
          f"ref_max_abs={ref_max:.3g} tol={tol}", flush=True)
    return row


def flash_grads():
    """The op's gradients (the kernel's forward, the recompute backward)
    against plain autograd through the plain version, on (out ** 2).sum()
    so the forward's output enters them: the grad tests' shapes, a
    gemma2 layer's head geometry at S=512 with its cap and a window, and
    MLA's q/k head dim 192 beside v's 128 (the FP32-core kernel's own
    (192, 128) instantiation)."""
    from repro_torch.kernels.flash_attention import mha_flash
    from repro_torch.kernels.flash_attention import ref as FR
    worst = 0.0
    for (B, S, H, Kv, hd, dv, window, cap) in (
            (2, 128, 2, 2, 32, 32, 0, 0.0), (2, 128, 4, 2, 32, 32, 0, 0.0),
            (1, 512, 8, 4, 256, 256, 128, 50.0),
            (2, 128, 4, 4, 192, 128, 0, 0.0)):
        g = torch.Generator(device="cuda").manual_seed(B * S + H)
        base = [torch.randn(B, S, h, e, generator=g, device="cuda") * sc
                for h, e, sc in ((H, hd, 0.3), (Kv, hd, 0.3), (Kv, dv, 1.0))]
        grads = []
        for use_kernel in (True, False):
            ts = [t.clone().requires_grad_(True) for t in base]
            if use_kernel:
                out = mha_flash(*ts, causal=True, window=window, cap=cap)
            else:
                G = H // Kv
                qf = ts[0].transpose(1, 2).reshape(B * H, S, hd)
                kf, vf = (t.transpose(1, 2).reshape(B * Kv, S, -1)
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
                  f"flash grads B={B} S={S} H={H} Kv={Kv} hd={hd} dv={dv}: "
                  f"max |err| {err}")
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
    The library call is timed beside every uncapped case (SDPA) and, of
    the capped ones, beside the windowless global layers of gemma2 and of
    phase 10, the kernels line's head cases: each capped (shape, type,
    mask) compiles its own ``flex_attention``, 3-20 s of the host's time
    each (the twelve at test_kernels' shapes took 85 s, for calls of a
    few microseconds).  Past
    dynamo's limit of recompiles flex would run unfused and its time would
    not be the library's, so the limit is raised and hitting it fails the
    phase."""
    import torch._dynamo
    with torch._dynamo.config.patch(recompile_limit=64,
                                    fail_on_recompile_limit_hit=True):
        return flash_cases(timer, draft)


def flash_cases(timer: Timer, draft: tuple) -> dict:
    cases = [flash_case(timer, BH, S, T, d, dtype, causal, window, cap,
                        library=not cap)
             for (BH, S, T, d) in FLASH_SHAPES
             for (causal, window, cap) in FLASH_MASKS
             for dtype in (torch.float32, torch.bfloat16)]
    sharp = [flash_case(timer, BH, S, T, d, dtype, causal, window, cap,
                        qk=FLASH_SHARP, library=False)
             for (BH, S, T, d) in FLASH_SHAPES
             for (causal, window, cap) in FLASH_MASKS if cap
             for dtype in (torch.float32, torch.bfloat16)]
    gemma = [flash_case(timer, 16, 4096, 4096, 256, torch.bfloat16, True,
                        window, 50.0, groups=2, qk=qk, library=not window)
             for qk in (0.3, FLASH_SHARP) for window in (0, 4096)]
    check(all(c["kernel"] == "tensor_cores" for c in gemma),
          "gemma2-2b's bf16 cases must run on the tensor cores")
    BH, groups, d, lengths = draft
    drafts = [flash_case(timer, BH, S, S, d, torch.bfloat16, True, 0, 0.0,
                         groups=groups, qk=qk)
              for S in lengths for qk in (0.3, FLASH_SHARP)]
    check(all(c["kernel"] == "tensor_cores" for c in drafts),
          "phase 13's draft forwards must run on the tensor cores")
    # hymba-1.5b's self-attention (phase 17's prefill): B=2 x H=25 flat
    # heads over B x Kv=5 KV rows (G = 5), hd 64, window 2048 at S=3072,
    # where the window skips the leading key tiles of the later rows
    hymba = [flash_case(timer, 2 * 25, PREFILL_S, PREFILL_S, 64,
                        torch.bfloat16, True, 2048, 0.0, groups=5, qk=qk)
             for qk in (0.3, FLASH_SHARP)]
    check(all(c["kernel"] == "tensor_cores" for c in hymba),
          "hymba-1.5b's bf16 cases must run on the tensor cores")
    whisper = [flash_case(timer, *shape, torch.bfloat16, causal, 0, 0.0,
                          qk=qk)
               for shape, causal in WHISPER_FLASH
               for qk in (0.3, FLASH_SHARP)]
    check(all(c["kernel"] == "tensor_cores" for c in whisper),
          "whisper-medium's bf16 cases must run on the tensor cores")
    # deepseek-v2-236b's MLA (phase 20's prefill): B=2 x H=128 flat heads
    # (G = 1), q/k head dim 192, v 128, causal, S=T=512, in both types,
    # each on its kernel's own (192, 128) instantiation (bf16 on the
    # tensor cores, float32 on the FP32 cores), and float32 again at 8
    # heads, where the FP32-core plan splits the key walks
    mla = [flash_case(timer, BH, DS_PROMPT, DS_PROMPT, 192, dtype,
                      True, 0, 0.0, qk=qk, dv=128)
           for dtype, BH in ((torch.bfloat16, DS_B * 128),
                             (torch.float32, DS_B * 128),
                             (torch.float32, 8))
           for qk in (0.3, FLASH_SHARP)]
    check(all((c["kernel"], c["padded_hd"], c["native"]) == (
        "tensor_cores" if c["dtype"] == "bfloat16" else "fp32_cores", 192,
        True) for c in mla) and any(c["splits"] > 1 for c in mla),
          "MLA's flash calls: each type must run natively, bf16 on the "
          "tensor cores, float32 on the FP32 cores (split at 8 heads)")
    # train_100m's attention (phase 22 (b)'s steps): hd 64, G = 2
    (BH, S, T, d), groups = TRAIN_100M_FLASH
    train100m = [flash_case(timer, BH, S, T, d, torch.bfloat16, True, 0, 0.0,
                            groups=groups, qk=qk)
                 for qk in (0.3, FLASH_SHARP)]
    check(all(c["kernel"] == "tensor_cores" for c in train100m),
          "train_100m's bf16 cases must run on the tensor cores")
    # the float32 calls phase 10's CUDA step makes (gemma2-2b widths, S
    # 512, its global and its local layer): the FP32-core kernel's path
    small = [flash_case(timer, TRAIN_SMALL_B * 8, TRAIN_SMALL_S,
                        TRAIN_SMALL_S, 256, torch.float32, True, window,
                        50.0, groups=2, library=not window)
             for window in (0, TRAIN_CUTS["sliding_window"])]
    check(all(c["kernel"] == "fp32_cores" for c in cases + sharp + small
              if c["dtype"] == "float32"),
          "float32 cases must run on the FP32 cores")
    return dict(cases=cases + sharp + gemma + drafts + hymba + whisper
                + mla + train100m + small, gemma=gemma, drafts=drafts,
                hymba=hymba, whisper=whisper, mla=mla, train100m=train100m,
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
    cpu_model, gpu_model = host_and_card(cfg)
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


# -------------------------------------------------------------- phase 21 --
#: phase 21's one-device cells: yi-6b decode (B=8 against 32,768 slots)
#: and gemma2-2b train at phase 12's cut
DRYRUN_DECODE = ("yi-6b", 32_768, 8, "decode")
DRYRUN_TRAIN = ("gemma2-2b", 4_096, TRAIN_FULL_B, "train")
#: phase 21 (c): full-size cells on the single-pod (16, 16) mesh
DRYRUN_FULL = (("yi-6b", "decode_32k"), ("deepseek-v2-236b", "train_4k"))
#: card memory the per-device bytes are held against
CARD_BYTES = 80e9

_TRACE_ONE = r"""
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import trace_step
arch, S, B, kind = json.loads(sys.argv[1])
rec = trace_step(get_config(arch), ShapeSpec(kind, S, B, kind),
                 mesh_lib.make_local_mesh(1, 1))
mesh_lib.release_fake_world()
print(json.dumps(rec))
"""


def _spawn_traces() -> dict:
    """Phase 21's dry-runs, each in a process of its own, all started at
    once, early (before phase 17), so that they trace on the host's idle
    cores while the card runs phases 17-11: the two one-device cells and
    the full-size cells (through the dry-run's CLI, which writes their
    records).  Their output goes to temporary files, so that none blocks
    on a full pipe before phase 21 reads it, and every one still running
    when the script exits is killed."""
    import atexit
    import os
    import tempfile
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    argv = {cell: [sys.executable, "-c", _TRACE_ONE, json.dumps(cell)]
            for cell in (DRYRUN_DECODE, DRYRUN_TRAIN)}
    for arch, shape in DRYRUN_FULL:
        argv[(arch, shape)] = [sys.executable, "-m",
                               "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--mesh", "single"]
    procs = {}
    for key, cmd in argv.items():
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        # at the lowest priority: phase 17's host-bound decode loops share
        # the cores with them
        procs[key] = (subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=out, stderr=err, text=True,
            preexec_fn=lambda: os.nice(19)), out, err)

    def stop():
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    return procs


def _collect(procs: dict, key, timeout: float = 600) -> str:
    proc, out, err = procs[key]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p, _, _ in procs.values():
            p.kill()
        raise
    out.seek(0)
    err.seek(0)
    check(proc.returncode == 0,
          f"phase 21 trace {key}: {err.read()[-3000:]}")
    return out.read()


def _requested() -> int:
    """The bytes the live tensors asked the caching allocator for (its
    ``memory_allocated`` counts its blocks, rounded up)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _placed(fn) -> tuple:
    """(what ``fn`` returns, the card bytes it left allocated: requested
    by the tensors, and in the allocator's blocks)."""
    gc.collect()
    torch.cuda.synchronize()
    base, base_blocks = _requested(), torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, _requested() - base, torch.cuda.memory_allocated() \
        - base_blocks


def phase_dryrun(smi: str, procs: dict) -> dict:
    """Phase 21 (see the module docstring); ``procs``: its dry-runs, as
    ``_spawn_traces`` started them."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.hero import roofline_table as RT
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    t_phase = time.perf_counter()
    out = {}
    # flash (all, tensor cores), its plain forward and recompute, paged
    # (bf16 / f32 pool, int8 pool), the cluster matmul
    counters = (FK.launches, FK.tc_launches, FO.plain_forwards,
                FO.backward_recomputes, PK.launches, PK.int8_launches,
                CK.launches)

    # (a) yi-6b decode: the dry-run on a one-device mesh, the step on the
    # card
    arch, T, B, kind = DRYRUN_DECODE
    cfg = get_config(arch)
    shape = ShapeSpec(kind, T, B, kind)
    (params, cache, batch), placed, blocks = _placed(lambda: (
        M.init_params(cfg, seed=0), M.init_cache(cfg, B, T),
        ST.make_batch(cfg, shape, torch.Generator("cuda").manual_seed(0))))
    for c in counters:
        c.reset()
    with FlopCounterMode(display=False) as fc:
        logits, cache = ST.make_decode_step(cfg)(params, cache, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    launched = [c.n for c in counters]
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "phase 21 (a) logits")
    del params, cache, batch, logits
    rec = json.loads(_collect(procs, DRYRUN_DECODE).strip().splitlines()[-1])
    args = rec["memory"]["argument_size_in_bytes"]
    row = dict(arch=arch, B=B, T=T, card_bytes=placed, dryrun_bytes=args,
               bytes_rel=(placed - args) / args, card_blocks=blocks,
               blocks_rel=(blocks - args) / args, card_flops=card_flops,
               dryrun_flops=rec["cost"]["flops"],
               kernel_flops=rec["kernel_flops"],
               temp_bytes=rec["memory"]["temp_size_in_bytes"],
               trace_s=rec["trace_s"], launches=launched)
    print(f"dryrun decode: {smi} " + json.dumps(row), flush=True)
    check(abs(placed - args) <= 1e-3 * args,
          f"phase 21 (a): {placed} bytes placed, dry-run {args}")
    check(card_flops == rec["cost"]["flops"] and rec["kernel_flops"] == 0,
          f"phase 21 (a): card {card_flops} FLOPs, dry-run "
          f"{rec['cost']['flops']}")
    check(launched == [0] * len(counters),
          f"phase 21 (a): decode_forward launched {launched}")
    out["decode"] = row

    # (b) gemma2-2b train at phase 12's cut
    arch, S, B, kind = DRYRUN_TRAIN
    cfg = get_config(arch)
    shape = ShapeSpec("train_4k", S, B, kind)
    opt = ST.default_opt_cfg(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    check(resident < 4 << 30, f"phase 21 (b): {resident} bytes still "
          "allocated before it")
    (state, batch), placed, blocks = _placed(lambda: (
        ST.init_train_state(cfg, opt, seed=0),
        ST.make_batch(cfg, shape, torch.Generator("cuda").manual_seed(0))))
    step = ST.make_train_step(cfg, opt)
    for c in counters:
        c.reset()
    with FlopCounterMode(display=False) as fc:
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    launched = [c.n for c in counters]
    check(math.isfinite(float(metrics["loss"])), "phase 21 (b) loss")
    # the peak of a second step, outside FlopCounterMode (which holds
    # more alive)
    del metrics
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    requested_peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    check(math.isfinite(float(metrics["loss"])), "phase 21 (b) loss")
    tc_launches = FK.tc_launches.n          # both steps'
    check(tc_launches == 2 * launched[1], f"phase 21 (b): {tc_launches} "
          "tensor-core flash launches over two steps")
    del state, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    rec = json.loads(_collect(procs, DRYRUN_TRAIN).strip().splitlines()[-1])
    mem = rec["memory"]
    args = mem["argument_size_in_bytes"]
    predicted = args + mem["temp_size_in_bytes"]
    row = dict(arch=arch, B=B, S=S, card_bytes=placed, dryrun_bytes=args,
               bytes_rel=(placed - args) / args, card_blocks=blocks,
               blocks_rel=(blocks - args) / args, card_flops=card_flops,
               dryrun_flops=rec["cost"]["flops"],
               kernel_flops=rec["kernel_flops"], card_peak=peak,
               card_requested_peak=requested_peak, resident=resident,
               predicted_peak=predicted,
               peak_gap=peak - resident - predicted,
               peak_rel=(peak - resident - predicted) / predicted,
               trace_s=rec["trace_s"], flash_tc_launches=tc_launches,
               launches=launched)
    print(f"dryrun train: {smi} " + json.dumps(row), flush=True)
    check(abs(placed - args) <= 1e-3 * args,
          f"phase 21 (b): {placed} bytes placed, dry-run {args}")
    check(card_flops == rec["cost"]["flops"] - rec["kernel_flops"],
          f"phase 21 (b): card {card_flops} FLOPs, dry-run "
          f"{rec['cost']['flops']} - kernel {rec['kernel_flops']}")
    check(launched[0] == launched[1] == 2 * cfg.num_layers
          and launched[2] == 0 and launched[3] == cfg.num_layers
          and launched[4:] == [0, 0, 0],
          f"phase 21 (b): launches {launched}")
    out["train"] = row

    # (c) full-size cells on the (16, 16) mesh
    out["full"] = []
    for arch, shape_name in DRYRUN_FULL:
        _collect(procs, (arch, shape_name))
        rec = RT.load_cell(arch, shape_name, "single")
        check(rec is not None and rec["status"] == "ok",
              f"phase 21 (c) {arch} {shape_name}: {rec}")
        r = RT.analyze_cell(arch, shape_name, "single")
        mem = rec["memory"]
        dev = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        row = dict(arch=arch, shape=shape_name, devices=rec["devices"],
                   args_bytes=mem["argument_size_in_bytes"],
                   temp_bytes=mem["temp_size_in_bytes"], device_bytes=dev,
                   card_share=dev / CARD_BYTES, fits=dev <= CARD_BYTES,
                   flops=rec["cost"]["flops"],
                   collective_bytes=rec["collective_bytes"],
                   t_compute=r["t_compute"], t_memory=r["t_memory"],
                   t_collective=r["t_collective"], dominant=r["dominant"],
                   trace_s=rec["trace_s"])
        print(f"dryrun full: {smi} " + json.dumps(row), flush=True)
        out["full"].append(row)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dryrun: phase 21 in {out['phase_s']:.2f} s", flush=True)
    return out


# ------------------------------------------------------------------ main --
# -------------------------------------------------------------- phase 22 --
#: phase 22 (a): a cluster's launches must overlap: the wall of n clusters
#: under this share of the sum of their own times
OVERLAP_SHARE = 0.8
#: phase 22 (b): train_100m at full width, and its checkpoint interval
T100M_STEPS, T100M_BATCH, T100M_SEQ, T100M_CKPT = 60, 8, 256, 20


def phase_fig4(timer: Timer, smi: str) -> dict:
    """(a) Fig.4's measured half on the card: ``hero.fig4_cluster_speedup``
    at 1, 2, 4 and 8 SM-budgeted clusters, 1024^3 and 2048^3 float32.  The
    budgeted launches are counted over that run alone; then each count's
    C is held against the plain version and against one unbudgeted
    kernel call at the f32 matmul bar, and for n >= 2 the wall must be
    under ``OVERLAP_SHARE`` x the sum of the clusters' own times.  A
    budget on a wgmma-routed product must raise, and two bf16 products
    on the general branch within a budget must agree with the plain
    version at the bf16 bar.  Then one cluster's
    block at each count and size is timed alone within its budget,
    unbudgeted and by ``torch.matmul``; the kernels line's case is 1024^3
    over 8 clusters (a 128 x 1024 @ 1024 x 1024 block within 16 SMs),
    also timed by its plain version."""
    from repro_torch.hero import fig4_cluster_speedup as F4
    from repro_torch.kernels.cluster_matmul import kernel as CK
    from repro_torch.kernels.cluster_matmul import ref as CR
    tol = MATMUL_TOL[torch.float32]
    x = torch.zeros(256, 256, dtype=torch.bfloat16, device="cuda")
    refused = None
    try:
        CK.matmul(x, x, sms=16)
    except ValueError as e:
        refused = e
    check(refused is not None, "a budget on a wgmma product did not raise")
    print(f"fig4: a budget on the wgmma branch raises: {refused}",
          flush=True)
    for c in (CK.launches, CK.budgeted_launches, CK.wgmma_launches):
        c.reset()
    t0 = time.perf_counter()
    rows = [r for size in F4.SIZES for r in F4.measure(size, "cuda")]
    wall_s = time.perf_counter() - t0
    launches, budgeted = CK.launches.n, CK.budgeted_launches.n
    check(budgeted > 0 and launches == budgeted and
          CK.wgmma_launches.n == 0,
          f"fig4: {budgeted} budgeted of {launches} launches, "
          f"{CK.wgmma_launches.n} wgmma")
    F4.print_measured(rows, smi)
    errs = []
    for size in F4.SIZES:
        a, b = F4.operands(size, "cuda")
        plain = CR.cluster_matmul_ref(a, b).float()
        whole = CK.matmul(a, b).float()
        for r in (r for r in rows if r["size"] == size):
            n, out = r["n_clusters"], r["out"].float()
            err = (out - plain).abs().max().item()
            err_whole = (out - whole).abs().max().item()
            check(out.shape == (size, size)
                  and bool(torch.isfinite(out).all()),
                  f"fig4 {size}^3 x {n}: output {tuple(out.shape)}")
            check(torch.allclose(out, plain, rtol=tol, atol=tol),
                  f"fig4 {size}^3 x {n}: vs plain max |err| {err}")
            check(torch.allclose(out, whole, rtol=tol, atol=tol),
                  f"fig4 {size}^3 x {n}: vs one unbudgeted call max |err| "
                  f"{err_whole}")
            own = sum(r["cluster_ms"])
            if n > 1:
                check(r["wall_ms"] < OVERLAP_SHARE * own,
                      f"fig4 {size}^3 x {n}: the clusters did not overlap: "
                      f"wall {r['wall_ms']:.4f} ms >= {OVERLAP_SHARE} x "
                      f"their own {own:.4f} ms")
            r.update(max_abs_err=err, max_abs_err_unbudgeted=err_whole,
                     overlap=r["wall_ms"] / own)
            errs.append(err)
            print(f"fig4 {size}^3 x {n}: sms={r['sms']} "
                  f"resident_blocks={r['resident']} tile={r['tile']} "
                  f"splits={r['splits']} wall_ms={r['wall_ms']:.4f} "
                  f"wall_host_paced_ms={r['wall_host_paced_ms']:.4f} "
                  f"enqueue_ms={r['enqueue_ms']:.4f} "
                  f"cluster_ms={[round(t, 4) for t in r['cluster_ms']]} "
                  f"speedup={r['speedup']:.3f} bound_ms={r['bound_ms']:.5f} "
                  f"wall/own={r['overlap']:.3f} max_abs_err={err:.3g} "
                  f"vs_unbudgeted={err_whole:.3g}", flush=True)
    # the bf16 general kernel within a budget too (Fig.4 is float32):
    # 127^3 (both operands through registers) and 768^3 with A 2 bytes off
    # 16 (16-byte copies, K tiles shifted), against the plain version at
    # the bf16 bar
    bar = MATMUL_TOL[torch.bfloat16]
    for m, k, off in ((127, 127, 0), (768, 768, 1)):
        g = torch.Generator(device="cuda").manual_seed(3)
        a = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        b = (torch.randn(k, m, generator=g, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        if off:
            a = torch.empty(m * k + off, dtype=torch.bfloat16,
                            device="cuda")[off:].view(m, k).copy_(a)
        check(CK.route(torch.bfloat16, m, k, m, aligned=not off)
              == CK.GENERAL, f"bf16 {m}^3: not on the general branch")
        out = CK.matmul(a, b, sms=16).float()
        plain = CR.cluster_matmul_ref(a, b).float()
        err = (out - plain).abs().max().item()
        check(torch.allclose(out, plain, rtol=bar, atol=bar),
              f"fig4: budgeted bf16 {m}^3 vs plain max |err| {err}")
        print(f"fig4: budgeted bf16 {m}^3 (A {2 * off} bytes off 16) "
              f"max_abs_err={err:.3g} tol={bar}", flush=True)
    # one cluster's block at each count and size, timed alone (L2
    # flushed): within its budget, unbudgeted and by torch.matmul; the
    # kernels line's case is 1024^3 over 8 clusters
    for r in rows:
        size, n, sms = r["size"], r["n_clusters"], r["sms"]
        a, b = F4.operands(size, "cuda")
        at = a[:size // n]
        r.update(block_ms=timer.ms(lambda: CK.matmul(at, b, sms=sms)),
                 block_unbudgeted_ms=timer.ms(lambda: CK.matmul(at, b)),
                 block_library_ms=timer.ms(lambda: torch.matmul(at, b)))
        print(f"fig4 block {size // n}x{size}x{size} within {sms} SMs: "
              f"ms={r['block_ms']:.4f} unbudgeted_ms="
              f"{r['block_unbudgeted_ms']:.4f} library_ms="
              f"{r['block_library_ms']:.4f} bound_share_ms="
              f"{r['bound_ms']:.5f}", flush=True)
    head = next(r for r in rows if (r["size"], r["n_clusters"]) == (1024, 8))
    a, b = F4.operands(1024, "cuda")
    at = a[:head["m"]]
    m, k, n_cols = head["m"], 1024, 1024
    nbytes = (m * k + k * n_cols + m * n_cols) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n_cols / PEAK_OPS_PER_S[torch.float32] * 1e3
    case = dict(
        m=m, k=k, n=n_cols, sms=head["sms"], max_abs_err=max(errs),
        ms=head["block_ms"], unbudgeted_ms=head["block_unbudgeted_ms"],
        plain_ms=timer.ms(lambda: CR.cluster_matmul_ref(at, b), reps=5),
        library_ms=head["block_library_ms"], bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_share_ms=head["bound_ms"])
    print("fig4 kernel case: " + " ".join(
        f"{k_}={v:.5g}" if isinstance(v, float) else f"{k_}={v}"
        for k_, v in case.items()), flush=True)
    for r in rows:
        del r["out"]
    return dict(rows=rows, launches=launches, budgeted_launches=budgeted,
                wall_s=wall_s, case=case)


def phase_train_100m(device="cuda") -> dict:
    """(b) ``launch.train_100m`` at full width (10 layers, d 640, 10 heads
    of 64 over 5 KV heads, vocab 50,304, bf16 with a float32 master):
    ``T100M_STEPS`` steps at batch ``T100M_BATCH`` x seq ``T100M_SEQ``
    through ``Trainer.run_with_recovery``, a checkpoint every
    ``T100M_CKPT`` steps into a temporary directory (deleted afterwards).
    The flash kernel's tensor-core branch must carry every attention
    forward and its recompute (2 x 10 a step), the plain forward none;
    the loss must decrease (the entry point raises otherwise)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.launch import train_100m as T100
    cfg = T100.model_100m()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_t100m_")
    counters = (FK.launches, FK.tc_launches, FO.plain_forwards,
                FO.backward_recomputes)
    try:
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        res = T100.main(["--steps", str(T100M_STEPS), "--batch",
                         str(T100M_BATCH), "--seq", str(T100M_SEQ),
                         "--ckpt", ckpt, "--ckpt-every", str(T100M_CKPT),
                         "--device", str(device)])
        wall = time.perf_counter() - t0
        launches, tc, plain, recomputes = (c.n for c in counters)
        committed = sorted(int(d.name.split("_")[1]) for d in
                           Path(ckpt).iterdir() if (d / "COMMITTED").exists())
        last = latest_step(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    steps = res["final_step"]
    check(steps == T100M_STEPS and res["restarts"] == 0,
          f"train_100m: {steps} steps, {res['restarts']} restarts")
    check(committed == list(range(T100M_CKPT, T100M_STEPS + 1, T100M_CKPT))
          and last == T100M_STEPS, f"train_100m: commits {committed}")
    on_card = torch.device(device).type == "cuda"
    calls = 2 * cfg.num_layers * steps
    want = (calls, 0) if on_card else (0, calls)
    check((launches, plain) == want and tc == launches,
          f"train_100m: flash launches {launches} (tensor cores {tc}), plain "
          f"forwards {plain}, want {want}: 2 x {cfg.num_layers} layers x "
          f"{steps} steps")
    losses = [m["loss"] for m in res["metrics"]]
    step_ms = [m["step_s"] * 1e3 for m in res["metrics"][1:]]
    tokens = T100M_BATCH * T100M_SEQ
    med = statistics.median(step_ms)
    row = dict(steps=steps, batch=T100M_BATCH, seq=T100M_SEQ,
               params_estimate=T100.param_estimate(cfg),
               step_ms_median=med, tokens_per_s=tokens / med * 1e3,
               first_loss=losses[0], last_loss=losses[-1],
               flash_launches=launches, flash_tc_launches=tc,
               flash_launches_per_step=launches / steps,
               backward_recomputes=recomputes, checkpoints=committed,
               wall_s=wall, logged_steps=len(losses))
    print("train_100m: " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    return row


def phase_serve_paged(device="cuda") -> dict:
    """(c) ``launch.serve_paged``'s schedule (the reference's smoke config,
    bf16 weights from seed 0 drawn on ``device``, then carried to the
    CPU) served on ``device`` and on the CPU: iterations, transfers,
    preemptions, RAB / pool / backing-store stats and every request's
    finish reason, prefix-hit tokens and preemptions must be equal, and
    its tokens too, but for a stream's first flip at a near-tie
    (``excuse_first_flip``: phase 4's rule, on the rows each engine drew
    the token from, recorded by ``StepRows`` around both runs).  On the
    card the paged kernels must carry every layer of every iteration
    (tensor cores for the chunks, split-KV for the decodes)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as KR
    from repro_torch.launch import serve_paged as SP
    from repro_torch.models.model import init_params
    from repro_torch.runtime import SamplingParams
    cfg = get_config("yi-6b").smoke()
    model = init_params(cfg, seed=0, device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    counters = (K.launches, K.tc_launches, K.split_launches, KR.calls)
    for c in counters:
        c.reset()
    with StepRows() as rec:
        card = SP.run(cfg, model, device=device)
        launches, tc, split, plain = (c.n for c in counters)
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = SP.run(cfg, cpu_model, device="cpu")
    check(len(rec.rows) == 2, f"serve_paged: {len(rec.rows)} engines "
                              "stepped, not 2")
    rows = list(rec.rows.values())      # the card's, then the CPU's
    for key in ("iterations", "h2d", "d2h", "preemptions", "rab", "pool",
                "backing", "lifecycles"):
        check(card[key] == cpu[key],
              f"serve_paged {key}: {card[key]} != CPU {cpu[key]}")
    check(card["preemptions"] >= 1, "serve_paged: no preemption")
    requests = {r.rid: r for r in SP.requests(8)}
    flips = 0
    for rid, got in card["results"].items():
        want = cpu["results"][rid]
        for key in ("finish_reason", "prefix_hit_tokens", "preemptions"):
            check(got[key] == want[key],
                  f"serve_paged rid {rid} {key}: {got[key]} != {want[key]}")
        if rid == SP.VIP["rid"]:
            prompt, sp = tuple(SP.VIP["prompt"]), SamplingParams(max_new=6)
        else:
            prompt, sp = tuple(requests[rid].prompt), requests[rid].sampling
        flips += excuse_first_flip(
            f"serve_paged rid {rid}", prompt, got["tokens"], want["tokens"],
            [r.get(rid, {}) for r in rows], sp, torch.bfloat16)
    on_card = torch.device(device).type == "cuda"
    n_layers = cfg.num_layers
    if on_card:
        check(launches == tc + split and plain == 0 and tc > 0 and split > 0
              and launches % n_layers == 0,
              f"serve_paged: paged launches {launches} (tensor cores {tc}, "
              f"split-KV {split}), plain {plain}")
    row = dict(iterations=card["iterations"], preemptions=card["preemptions"],
               prefix_hit_tokens=card["pool"]["prefix_hit_tokens"],
               tokens=sum(len(r["tokens"]) for r in card["results"].values()),
               flips_excused=flips, paged_launches=launches, tc_launches=tc,
               split_launches=split, plain_calls=plain)
    print(f"serve_paged: {row}", flush=True)
    return row


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
    sources = (K.SOURCE, CK.SOURCE, CK.BUDGETED_SOURCE, FK.SOURCE)
    launch.build(sources)
    print("build: " + ", ".join(
        f"{src.name} -> {launch.library_path(src).name}"
        for src in sources)
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
    sharded_lock = phase_sharded_lockstep(parity, known)
    done("phase 18a")
    parity = parity_models("bfloat16")
    _, known, _, _ = phase_parity(parity)
    phase_parity(parity, kv_dtype="int8", spec_k=4, known=known,
                 sampled=True)
    phase_draft_parity(parity)
    phase_prng_bits()
    del parity
    moe_parity = phase_moe_parity()
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
    sharded_full = phase_sharded_serve(cfg, model, phase5)
    done("phase 18b")
    del model
    gc.collect()            # the engines' reference cycles hold the weights
    torch.cuda.empty_cache()
    frontends = phase_frontends()
    done("phase 19")
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = phase_deepseek()
    done("phase 20")
    gc.collect()
    torch.cuda.empty_cache()
    moe_serve, moe_serve8 = phase_moe_serve()
    done("phase 16")
    gc.collect()
    torch.cuda.empty_cache()
    traces = _spawn_traces()        # phase 21's, on the host's idle cores
    recurrent = phase_recurrent(timer)
    done("phase 17")

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
    dryrun = phase_dryrun(smi, traces)
    done("phase 21")
    fig4 = phase_fig4(timer, smi)
    train100m = phase_train_100m()
    serve_paged = phase_serve_paged()
    done("phase 22")

    def entry(name, kernel, kv, C, dtype, launches, replaces):
        """A paged-attention kernel on one pool type: its head case is
        the main path's (C=1 decode or C=128 chunk, flat, q of
        ``dtype``); its error the largest of its cases."""
        own = [c for c in cases if c["kv"] == kv and c["kernel"] == kernel]
        head = next(c for c in own if c["C"] == C and not c["sharp"]
                    and c["dtype"] == dtype and c["geom"] == "yi-6b")
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
    # the bf16 pool's kernels carry phases 5, 13, 14, 15, 16, 18 (b) and
    # 19 (c), the int8 pool's phases 6 and 16 (and 18 (a)'s decode), the
    # FP32-core kernel phase 4's float32 engines (yi-6b's and olmoe's),
    # phase 18 (a)'s sharded ones and phase 19 (a)'s pixtral engine
    full = sharded_full.values()
    pix_lock, pix_serve = frontends["pixtral_lock"], \
        frontends["pixtral"]["serve"]
    kernels = [
        entry("paged_attention_decode_split", SPLIT_KV, "same", 1,
              "bfloat16", serve["split_launches"]
              + frontdoor["split_launches"] + tiers["split_launches"]
              + planner["split_launches"] + moe_serve["split_launches"]
              + sum(r["split_launches"] for r in full)
              + sharded_lock["split_launches"] + pix_serve["split_launches"]
              + pix_lock["split_launches"] + serve_paged["split_launches"],
              decode_fwd),
        entry("paged_attention_decode_split_int8", SPLIT_KV, "int8", 1,
              "bfloat16", serve8["split_launches"]
              + moe_serve8["split_launches"]
              + sharded_lock["split_int8_launches"], quant),
        entry("paged_attention", FP32_CORES, "same", 128, "float32",
              parity_f32["fp32_core_launches"]
              + tier_parity["fp32_core_launches"]
              + moe_parity["f32"]["fp32_core_launches"]
              + sharded_lock["fp32_core_launches"]
              + pix_lock["fp32_core_launches"], prefill),
        entry("paged_attention_int8", FP32_CORES, "int8", 128, "float32",
              parity_int8["fp32_core_launches"]
              + sharded_lock["fp32_core_int8_launches"], quant),
        entry("paged_attention_prefill_tc", TENSOR_CORES, "same", 128,
              "bfloat16", serve["tc_launches"] + frontdoor["tc_launches"]
              + tiers["tc_launches"] + planner["tc_launches"]
              + moe_serve["tc_launches"]
              + sum(r["tc_launches"] for r in full)
              + pix_serve["tc_launches"] + serve_paged["tc_launches"],
              prefill),
        entry("paged_attention_prefill_tc_int8", TENSOR_CORES, "int8", 128,
              "bfloat16", serve8["tc_launches"] + moe_serve8["tc_launches"],
              quant),
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
    # the general float32 kernel within an SM budget: phase 22 (a)'s Fig.4
    # clusters, its case one cluster's block of 1024^3 over 8, its error
    # the largest over every count and size against the plain version
    case = fig4["case"]
    kernels.append({
        "name": "cluster_matmul_budgeted", "route": "cuda",
        "source": "src/repro_torch/kernels/cluster_matmul/csrc/"
                  "cluster_matmul.cu",
        "replaces": "src/repro/kernels/cluster_matmul/kernel.py:48",
        "launches": fig4["budgeted_launches"],
        "max_abs_err": case["max_abs_err"], "ms": case["ms"],
        "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "library_ms": case["library_ms"],
        "held_against_plain": True, "sms": case["sms"],
        "unbudgeted_ms": case["unbudgeted_ms"],
        "bound_share_ms": case["bound_share_ms"], "cases": fig4["rows"],
    })
    # flash on the tensor cores: the main path's case is gemma2-2b's
    # global (window 0) layer, its error the largest of gemma2's four
    # cases (both scales, both windows), phase 13's draft cases, hymba's,
    # whisper's, train_100m's and bf16 MLA's, its launches phase 12's, phase 13's draft forwards,
    # phase 17's hymba prefills, phase 19's whisper and pixtral calls,
    # phase 20 (b)'s MLA prefills and phase 21 (b)'s train step; on the FP32 cores: phase 10's float32
    # global layer, its error the largest of its float32 cases (MLA's
    # among them), its launches phase 10's, phase 17's float32 hymba
    # lockstep prefills, phase 19 (a)'s float32 whisper and phase 20
    # (a)'s float32 MLA prefill
    for name, kernel, head, launches, split in (
            ("flash_attention_tc", "tensor_cores", flash["gemma"][0],
             train["flash_tc_launches"] + frontdoor["flash_tc_launches"]
             + recurrent["tc_launches"] + frontends["tc_launches"]
             + deepseek["tc_launches"]
             + dryrun["train"]["flash_tc_launches"]
             + train100m["flash_tc_launches"], 0),
            ("flash_attention", "fp32_cores", flash["small"][0],
             parity_train["flash_fp32_core_launches"]
             + recurrent["fp32_core_launches"]
             + frontends["fp32_core_launches"]
             + deepseek["fp32_core_launches"],
             parity_train["flash_fp32_split_launches"])):
        own = [c for c in flash["cases"] if c["kernel"] == kernel]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
            "launches": launches, "split_launches": split,
            "max_abs_err": max(c["max_abs_err"] for c in (
                flash["gemma"] + flash["drafts"] + flash["hymba"]
                + flash["whisper"] + flash["train100m"]
                + [c for c in flash["mla"] if c["kernel"] == kernel]
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
