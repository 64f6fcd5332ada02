// Cluster matmul for Hopper (sm_90a): C = A @ B, f32 accumulation, C in
// A's type.
//
// Replaces the TPU kernel src/repro/kernels/cluster_matmul/kernel.py::
// matmul (its pl.pallas_call, body _kernel): HERO's cluster program
// (§3.2), which DMAs a row tile of A and a column tile of B from DRAM
// into the cluster's L1 scratchpad, computes the C tile locally and
// writes it back.  A (m, k) and B (k, n) are row-major and of one type,
// float32 or bfloat16; C (m, n) is written once, rounded from the float32
// accumulator to that type (round to nearest even for bfloat16, as
// .astype does).
//
// Two branches, chosen by the wrapper (kernel.py::route) from the type,
// the shape and the base addresses alone, never on a failure:
//
// The wgmma branch (bfloat16, k and n multiples of 8: TMA's 16-byte row
// pitch for A, B and C).  What bounds it: at the shapes the offload path
// and a model MLP meet (768^3 to 4096^3, 1024 x 4096 x 11008) the product
// does 2mnk operations on (mk + kn + mn) elements, far above the card's
// ridge point, so it is bound by the tensor cores' 989 TFLOP/s.  Only
// wgmma reaches that rate, and only when its operands arrive without the
// threads' help, so the design is Hopper's usual one:
//   * a block owns a 128 x 256 tile of C (grid in a grouped order: 8 tile
//     rows walk the tile columns together, so the B panels they share stay
//     in L2).  128 x 256 rather than 128 x 128: each stage's 48 KB then
//     feeds 2 x 64 x 256 x 64 multiply-adds, 1.3x the operations per
//     shared-memory byte, and the 128 accumulators per thread fit in the
//     232 registers setmaxnreg gives a consumer;
//   * a ring of 4 shared-memory stages, each an A tile (128 x 64) and a B
//     tile (64 x 256), loaded by TMA (cp.async.bulk.tensor) with 128-byte
//     swizzle; TMA zero-fills past the matrices' edges, so ragged m, k and
//     n need no masks in the main loop;
//   * warp specialisation: warpgroup 2 is the producer (setmaxnreg down to
//     40; one thread keeps the ring full, completing each stage on its
//     "full" mbarrier with the transaction bytes), warpgroups 0 and 1 are
//     the consumers (setmaxnreg up to 232), each running
//     wgmma.mma_async m64n256k16 on its 64 rows with float32 accumulators
//     in registers, keeping one k-tile's wgmmas in flight and releasing a
//     stage on its "empty" mbarrier once they are waited on;
//   * the epilogue rounds to bf16 (nearest even), stages the tile in the
//     ring's shared memory and writes C with 16-byte stores, masking rows
//     past m and columns past n.
// Where it can go wrong, and what guards it:
//   * B is row-major (k, n): for wgmma it is MN-major, so its descriptor
//     sets the transpose bit and its strides follow CUTLASS's canonical
//     MN-major 128-byte-swizzle layout: LBO = 8 KB from one 64-column TMA
//     box to the next along n, SBO = 1 KB from one 8-row group to the
//     next along k.  A is K-major: SBO = 1 KB, LBO unused, and a 16-deep
//     k step advances the start address by 32 bytes inside the swizzled
//     128-byte rows.  A swapped stride is silently wrong, so the tests and
//     chip_smoke.py phase 7 hold shapes with m != k != n;
//   * the tensor maps (cuTensorMapEncodeTiled) hold the matrices'
//     addresses, so they are encoded on the host at every call and passed
//     as __grid_constant__ parameters.  The function is a driver-API one;
//     this library is not linked against libcuda but reaches it through
//     the runtime's cudaGetDriverEntryPoint(ByVersion);
//   * TMA needs 16-byte-aligned bases and 16-byte row pitches: k % 8 == 0
//     (A), n % 8 == 0 (B, and C's 16-byte stores); the wrapper routes
//     every other bf16 shape to the general branch, and the C entry
//     refuses them.
//
// The general branch: every float32 product (namespace gen), and the
// bfloat16 shapes the wgmma branch cannot take.  What bounds the float32
// half: 2mnk operations on the FP32 cores (67 TFLOP/s; no TF32, the
// reference is a float32 jnp.dot, and its 2e-4 bar holds true float32
// FMAs), and below a wave of the card, the depth of K one block walks.
// The first kernel here reached 55% of that bound at 4096^3 because its
// loads were synchronous (a tile staged, a barrier, 16 k of FMAs, a
// barrier: no load in flight under the FMAs), and with fixed 128 x 128
// tiles 127^3 ran on 1 block of 132 SMs and 256^3 to 1000 x 1032 x 776
// on 4-56, each walking K alone (2.6-3.9x behind cuBLAS there).  A
// second float32 kernel for aligned shapes (16-byte cp.async.cg copies of
// B, A through registers) fixed the loads only where rows were whole
// 16-byte chunks; this kernel beat it at every shape timed, aligned ones
// included (PERF.md §6), and took its place.  The design:
//   * a cp.async ring of 4-byte copies: cp.async.ca 4-byte copies need
//     only the 4-byte alignment every float has, so A and B go through a
//     4-stage ring (3 tiles of 16 k in flight) at any base and row
//     pitch, with no 16-byte global access anywhere; the zero-fill form
//     (src-size 0) covers rows past m, columns past n and K past its end,
//     so the FMAs are unmasked.  A 4-byte copy can transpose, so A lands
//     as At[k][m] directly (a warp copies 16 k of two rows: 64 contiguous
//     bytes each; rows of BM + 4 floats keep the fragment reads 16-byte);
//   * warps of 64 x 32 of C, lanes as 8 x 4, each thread an 8 x 8 block
//     of accumulators: two 16-byte shared reads of A and two of B per k
//     (64 FFMA to 4 LDS.128), the fragments of k+1 read under the FMAs of
//     k (two register sets), so shared-memory latency hides under the
//     FMAs of the same warp;
//   * tiles from the grid (kernel.py::general_plan): 128 x 128 (8 warps,
//     two blocks an SM, 128 registers a thread) where those tiles fill a
//     wave of 132 SMs, in a grouped order (8 tile rows walk the tile
//     columns together, so neighbouring blocks share A and B panels in
//     L2); else 64 x 64 (2 warps, up to 6 blocks an SM), with K split
//     over about four blocks an SM, no split empty;
//   * split-K in one launch, deterministic: a split writes its float32
//     partial tile to scratch, takes a ticket (__threadfence, atomicAdd),
//     and the tile's last split sums the partials in split order, ((p_0 +
//     p_1) + p_2) + ..., whichever finishes last, then resets the ticket
//     to 0; no float atomics on C, so a product repeats bit for bit (the
//     offload path's copy-mode and zero-copy outputs must be equal);
//   * C leaves by 4-byte stores, masked per element.
// What still holds it back (PERF.md §6): at 4096^3 it reaches ~65% of the
// FP32 bound, against cuBLAS's ~77%.  The shared reads are the cost: the
// aligned kernel it replaced, with the same inner loop, took 2.47 ms at
// 4096^3 with its fragments made in registers (wrong values, timing
// only) against 3.38 with them read.  Next step: fewer shared reads per
// FMA (a larger tile a thread) without losing the warps that hide their
// latency.  The small products sit at 1.24-1.41x cuBLAS: what is left
// there is the launch and the split's partials, a few microseconds each.
//
// The bfloat16 half (namespace bf) takes every bf16 product the wgmma
// branch does not: any m, k, n (k = 0 too) and bases aligned only to 2
// bytes.  What bounds it: 2mnk operations on the tensor cores, which
// mma.sync reaches at about half of wgmma's 989 TFLOP/s, and below a wave
// of the card the depth of K one block walks.  The design, mirroring the
// float32 half:
//   * mma.sync.m16n8k16 (bf16 in, float32 accumulators in registers), fed
//     by ldmatrix.x4 for A (As[m][k]) and ldmatrix.x4.trans for the
//     row-major B (Bs[k][n]); rows padded by 16 bytes so ldmatrix's 8 rows
//     hit distinct banks.  4 warps as 2 x 2: 64 x 64 of C a warp in 128 x
//     128 tiles (8 ldmatrix.x4 per 32 MMAs), 32 x 32 in 64 x 64 tiles;
//   * loads in flight at any alignment: the wrapper passes each
//     operand's access width w in {16, 8, 4, 2} bytes and the kernel is
//     templated on the pair.  B's w divides its base and row pitch; A's
//     divides its row pitch, and A's K tiles start (base mod w) / 2
//     elements early, so a base 2 bytes off 16 with rows of whole
//     16-byte chunks still copies 16 bytes at a time (A's neighbours
//     outside [0, K) are zeroed, never multiplied: a NaN there would
//     survive B's zero rows).  w >= 4 goes through a 4-stage cp.async
//     ring (3 tiles of 32 k in flight) of w-byte copies, zero-filled past
//     the edges, so the MMAs are unmasked.  w = 2 (rows of an odd number
//     of elements, or B's base 2 bytes off 4) cannot use cp.async: the
//     operand's next tile is loaded into registers before this tile's
//     MMAs as aligned 4-byte words and stored after them, realigned with
//     __byte_perm, 16 bytes a store (2-byte loads instead were slower at
//     every shape timed);
//   * tiles and split-K from the grid (general_plan with the dtype:
//     32-deep K tiles, splits of at least 4 of them, up to one block an
//     SM, since a split's partial costs more than a 64 x 64 tile's walk
//     on the tensor cores saves), and the float32 half's one-launch
//     deterministic combine of float32 partials, then one rounding to
//     bf16;
//   * C straight from registers: each accumulator pair rounded to a
//     __nv_bfloat162 and stored as 4 bytes where C's rows start 4-byte
//     aligned (n even), else 2 bytes, masked per element.
// What still holds it back (PERF.md §6, row 3e): mma.sync itself, which
// cannot pass half of wgmma's rate; and for rows of an odd number of
// elements the register path, whose loads for a tile have only the
// previous tile's MMAs to hide under.
//
// An SM budget (the general branch, both types; Fig.4's clusters sharing
// one card): the wrapper passes max_blocks = budget x the blocks an SM
// holds (cluster_matmul_resident, from cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), and the launch takes a second instantiation of the
// kernel whose grid holds min(items, max_blocks) blocks, each walking the
// (tile, split) items by grid stride.  The per-item body is the same
// function in both (inlined), so an unbudgeted launch runs exactly the
// kernel of one item a block.  A budget caps the blocks in flight; the
// hardware scheduler, not this code, places them on SMs.  This file is
// built twice, as two libraries whose nvcc runs go in parallel: as it is
// (one item a block, and the wgmma branch), and through
// cluster_matmul_budgeted.cu, which defines CLUSTER_MATMUL_BUDGETED (the
// grid-stride instantiations alone), so each build compiles half the
// general kernels.
//
// Plain C interface (loaded with ctypes): cluster_matmul_launch (general,
// both types) and cluster_matmul_wgmma_launch return cudaGetLastError()
// after the launch; 0 means launched.  The budgeted build exports
// cluster_matmul_launch (max_blocks > 0) and cluster_matmul_resident (the
// budgeted kernel's blocks an SM) instead.

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#ifdef CLUSTER_MATMUL_BUDGETED
constexpr bool kBudgeted = true;    // the grid-stride instantiations
#else
constexpr bool kBudgeted = false;   // one item a block
#endif

// --------------------------------------------- f32, general (any shape) --
namespace gen {

constexpr int kBK = 16;              // K per stage
constexpr int kStages = 4;           // ring depth: 3 tiles in flight
constexpr int kGroupM = 8;           // tile rows per L2 group

// A block owns a BM x BN tile of C: warps of 64 x 32 (lanes as 8 x 4,
// each thread 8 rows x 8 columns), so 128 x 128 is
// 8 warps and 64 x 64 two.
template <int BM, int BN>
struct Cfg {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = (BM / 64) * kWarpsN * 32;
  // A transposed, At[k][m] (rows of BM + 4 floats, the fragment reads
  // stay 16-byte), B as in memory
  static constexpr int kAtLd = BM + 4;
  static constexpr int kA = kBK * kAtLd;                   // floats
  static constexpr int kStage = kA + kBK * BN;             // floats
  static constexpr size_t kSmem = size_t(kStages) * kStage * 4;
  // 4-byte copies a thread issues per stage, of A and of B
  static constexpr int kACopies = BM * kBK / kThreads;
  static constexpr int kBCopies = kBK * BN / kThreads;
  static_assert(kACopies * kThreads == BM * kBK &&
                kBCopies * kThreads == kBK * BN &&
                kThreads % kBK == 0 && kThreads % BN == 0, "whole copies");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared (a shared-space address), asynchronously,
// through L1; bytes = 0 writes a zero (the zero-fill form: rows past M,
// columns past N, K past its end).  4-byte copies need only the 4-byte
// alignment every float has.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fma_outer(float (&acc)[8][8],
                                          const float (&a)[8],
                                          const float (&b)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// The next of a thread's copies: p + step, opaque to the compiler, so it
// keeps one running address and does not hoist one per copy (which cost
// the registers the accumulators need)
template <typename T>
__device__ __forceinline__ const T* step_ptr(const T* p, size_t step) {
  p += step;
  asm volatile("" : "+l"(p));
  return p;
}

// Whether this block is the last of its tile's `splits` blocks to finish:
// its ticket is taken after its partial is visible device-wide, and the
// last block puts the counter back to 0 for the next launch.  Every
// thread of the block calls it.
__device__ __forceinline__ bool last_split(int* ticket, int splits,
                                           int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1) == splits - 1;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Item (tile, split) = (item / splits, item % splits): the splits of a
// tile are neighbours in the item order, so they run together.  With
// splits == 1 the block writes its tile of C; otherwise (64 x 64 tiles
// only) it writes its float32 partial to part[item], and the tile's last
// block to finish sums the partials in split order (0, 1, ...) into C.
// Every thread of the block calls it; it primes the shared-memory ring
// itself, so a block can take one item after another.
template <int BM, int BN>
__device__ __forceinline__ void f32_general_item(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, float* __restrict__ part,
    int* __restrict__ tickets, int M, int N, int K, int splits, int item) {
  using G = Cfg<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_flag;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / G::kWarpsN, wn = warp % G::kWarpsN;
  const int lm = lane / 4, ln = lane % 4;
  const int tile = item / splits, split = item % splits;

  // grouped tile order: kGroupM tile rows walk the tile columns together
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int group_rows = min(tiles_m - first_m, kGroupM);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % group_rows) * BM;
  const int n0 = (in_group / group_rows) * BN;
  // this split's K tiles (the wrapper leaves no split empty)
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  const int kt0 = split * per;
  const int n_kt = max(0, min(k_tiles, kt0 + per) - kt0);

  auto row_of = [&](int i) {
    return wm * 64 + (i / 4) * 32 + lm * 4 + i % 4;
  };
  const int col0 = wn * 32 + ln * 4;   // and + 16

  // A: a warp copies 16 k of two rows (64 contiguous bytes each) and
  // writes them transposed; B: a warp copies 32 contiguous columns of one
  // k.  A thread's k (A) and column (B) are fixed, its rows step by
  // kARows (A) and kBRows (B).
  constexpr int kARows = G::kThreads / kBK, kBRows = G::kThreads / BN;
  const int a_k = tid % kBK, a_r = tid / kBK;
  const int b_n = tid % BN, b_k = tid / BN;
  const uint32_t smem0 = smem_u32(smem);
  const size_t a_step = size_t(kARows) * K, b_step = size_t(kBRows) * N;
  const bool b_col = n0 + b_n < N;
  auto load_tile = [&](int kt, int slot) {
    const uint32_t at = smem0 + 4 * (slot * G::kStage);
    const uint32_t bt = at + 4 * G::kA;
    const int k0 = kt * kBK;
    const bool a_in = k0 + a_k < K;
    const float* pa = A + (size_t(m0 + a_r) * K + k0 + a_k);
#pragma unroll
    for (int j = 0; j < G::kACopies; ++j) {
      const bool in = a_in && m0 + a_r + j * kARows < M;
      cp_async4(at + 4 * (a_k * G::kAtLd + a_r + j * kARows), in ? pa : A,
                in ? 4 : 0);
      pa = step_ptr(pa, a_step);
    }
    const float* pb = B + (size_t(k0 + b_k) * N + n0 + b_n);
#pragma unroll
    for (int j = 0; j < G::kBCopies; ++j) {
      const bool in = b_col && k0 + b_k + j * kBRows < K;
      cp_async4(bt + 4 * ((b_k + j * kBRows) * BN + b_n), in ? pb : B,
                in ? 4 : 0);
      pb = step_ptr(pb, b_step);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // prologue: tiles 0 .. kStages-2 in flight (one commit group each, empty
  // past the last tile, so the wait below counts groups uniformly)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_tile(kt0 + s, s);
    cp_async_commit();
  }

  for (int it = 0; it < n_kt; ++it) {
    const int slot = it % kStages;
    cp_async_wait<kStages - 2>();   // tile it's copies have landed
    __syncthreads();                      // ... for every thread; and tile
                                          // it-1, whose slot is refilled
                                          // next, is read
    const int nt = it + kStages - 1;
    if (nt < n_kt) load_tile(kt0 + nt, nt % kStages);
    cp_async_commit();

    const float* at = smem + slot * G::kStage;
    const float* bt = at + G::kA;
    // fragments of kk+1 are read while the FMAs of kk run
    float a[2][8], b[2][8];
    auto load_frag = [&](float (&da)[8], float (&db)[8], int kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          at + kk * G::kAtLd + row_of(0));
      const float4 a1 = *reinterpret_cast<const float4*>(
          at + kk * G::kAtLd + row_of(4));
      const float4 b0 = *reinterpret_cast<const float4*>(bt + kk * BN + col0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bt + kk * BN + col0 + 16);
      da[0] = a0.x; da[1] = a0.y; da[2] = a0.z; da[3] = a0.w;
      da[4] = a1.x; da[5] = a1.y; da[6] = a1.z; da[7] = a1.w;
      db[0] = b0.x; db[1] = b0.y; db[2] = b0.z; db[3] = b0.w;
      db[4] = b1.x; db[5] = b1.y; db[6] = b1.z; db[7] = b1.w;
    };
    load_frag(a[0], b[0], 0);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk + 1 < kBK) load_frag(a[(kk + 1) & 1], b[(kk + 1) & 1], kk + 1);
      fma_outer(acc, a[kk & 1], b[kk & 1]);
    }
  }
  cp_async_wait<0>();

  // C (n % 4 may be anything: 4-byte stores, masked per element)
  auto store_c = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + row_of(i);
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gn = n0 + col0 + 16 * (j / 4) + j % 4;
        if (gn < N) C[size_t(gm) * N + gn] = acc[i][j];
      }
    }
  };
  // 128 x 128 tiles fill the card unsplit (the wrapper's plan), so only
  // the 64 x 64 kernel compiles the split path (its combine's loads in
  // flight cost the larger kernel's main loop registers: 3.47 ms against
  // 3.27 at 4096^3)
  if (BM == 128 || splits == 1) {
    store_c();
    return;
  }
  // the partial, 16 bytes at a time, into this item's slot
  float* mine = part + size_t(item) * BM * BN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(mine + row_of(i) * BN + col0 + 16 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  if (!last_split(tickets + tile, splits, &last_flag)) return;
  // the last block: C = ((p_0 + p_1) + p_2) + ..., the same order
  // whichever block finishes last, so the result repeats run to run.
  // Partials are read past L1 (__ldcg): other SMs wrote them.
  // A split's 16 loads are independent of each other, so they are in
  // flight together.
  for (int s = 0; s < splits; ++s) {
    const float* slot = part + (size_t(tile) * splits + s) * BM * BN;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            slot + row_of(i) * BN + col0 + 16 * h));
        float* c = &acc[i][4 * h];
        c[0] = s ? c[0] + p.x : p.x;
        c[1] = s ? c[1] + p.y : p.y;
        c[2] = s ? c[2] + p.z : p.z;
        c[3] = s ? c[3] + p.w : p.w;
      }
  }
  store_c();
}

// kStride false: one item a block, the grid holding every item (no
// budget).  kStride true (an SM budget): a grid of at most budget x
// resident blocks, each walking the items by grid stride, item = block,
// block + grid, ...; the split-K tickets and the combine are the same
// per item, so the result does not depend on which block takes which.
template <int BM, int BN, bool kStride>
__global__ void __launch_bounds__(Cfg<BM, BN>::kThreads,
                                  512 / Cfg<BM, BN>::kThreads)
matmul_f32_general_kernel(const float* __restrict__ A,
                          const float* __restrict__ B, float* __restrict__ C,
                          float* __restrict__ part, int* __restrict__ tickets,
                          int M, int N, int K, int splits, int items) {
  if constexpr (kStride) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      f32_general_item<BM, BN>(A, B, C, part, tickets, M, N, K, splits,
                               item);
      __syncthreads();   // the ring and the flag are free for the next item
    }
  } else {
    f32_general_item<BM, BN>(A, B, C, part, tickets, M, N, K, splits,
                             int(blockIdx.x));
  }
}

// Above 48 KB a block needs the opt-in, once per kernel and process.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess) done = true;
  return e;
}

// This build's kernel (kBudgeted: the grid-stride one); with `resident`
// it reports the blocks one SM holds at once instead of launching.
template <int BM, int BN>
cudaError_t launch(const float* a, const float* b, float* c, float* part,
                   int* tickets, int m, int n, int k, int splits,
                   int max_blocks, cudaStream_t stream,
                   int* resident = nullptr) {
  using G = Cfg<BM, BN>;
  auto kernel = matmul_f32_general_kernel<BM, BN, kBudgeted>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, G::kSmem, opted_in);
  if (e != cudaSuccess) return e;
  if (resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         G::kThreads,
                                                         G::kSmem);
  const long long items =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN) * splits;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid = kBudgeted && items > max_blocks ? max_blocks : items;
  kernel<<<unsigned(grid), G::kThreads, G::kSmem, stream>>>(
      a, b, c, part, tickets, m, n, k, splits, int(items));
  return cudaGetLastError();
}

}  // namespace gen

// ------------------------------------------- bf16, general (any shape) --
namespace bf {

using bf16 = __nv_bfloat16;
using gen::smem_u32;

constexpr int kBK = 32;              // K per stage: two m16n8k16 steps
constexpr int kStages = 4;           // ring depth: 3 tiles in flight
constexpr int kThreads = 128;        // 4 warps as 2 x 2
constexpr int kPad = 8;              // row padding (elements): 16 bytes, so
                                     // ldmatrix's 8 rows hit distinct banks
constexpr int kGroupM = 8;           // tile rows per L2 group

// A block owns a BM x BN tile of C, its 4 warps BM/2 x BN/2 each (kMI x
// kNI mma tiles of 16 x 8).  A stage holds A as in memory, As[m][k] in
// rows of kBK + 8 elements, then B as in memory, Bs[k][n] in rows of BN +
// 8: both row pitches are 16 bytes past a multiple of 128, so the 8 rows
// an ldmatrix reads lie in distinct banks.
template <int BM, int BN>
struct Cfg {
  static constexpr int kWM = BM / 2, kWN = BN / 2;
  static constexpr int kMI = kWM / 16, kNI = kWN / 8;
  static constexpr int kALd = kBK + kPad, kBLd = BN + kPad;
  static constexpr int kA = BM * kALd;                  // elements
  static constexpr int kStage = kA + kBK * kBLd;        // elements
  static constexpr size_t kSmem = size_t(kStages) * kStage * 2;
  static_assert(kNI % 2 == 0 && (kA * 2) % 16 == 0 &&
                (kStage * 2) % 16 == 0, "16-byte rows and stages");
};

// W-byte copy global -> shared (a shared-space address), asynchronously;
// bytes = 0 writes zeros (the zero-fill form).  16 bytes bypass L1 (.cg),
// 8 and 4 go through it (.ca: .cg takes 16 only).
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
                 "l"(src), "n"(W), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's ROWS x COLS tile of a row-major matrix (COLS along its
// rows) into a stage with rows of LD elements, by accesses of W bytes.  W
// = 16, 8 or 4: cp.async copies of kE = W / 2 elements, the columns from
// `cols` on zero-filled (the src-size form); a copy that starts before
// column 0 (a shifted A) is made whole: an aligned access never leaves
// the page of an element it holds.  W = 2 (rows of an odd number of elements):
// cp.async cannot copy, so a thread loads chunks of 8 elements into
// registers as the aligned 4-byte words that hold them (five when the
// chunk starts 2 bytes past a word, four otherwise; a word that holds no
// element of the matrix is not read), and later realigns them with
// __byte_perm, zeroes the elements outside the matrix and stores each
// chunk with one 16-byte shared store.  A thread's column is fixed; its
// rows step by kRowStep.  `g` is its first element's address, `row0`
// that element's row in the matrix (negative above it), `n_rows` the
// matrix's rows, `cols` the columns left from the thread's column;
// `pitch` the matrix's row length.
template <int ROWS, int COLS, int LD, int W>
struct Operand {
  static constexpr bool kRegs = W == 2;
  static constexpr int kE = kRegs ? 8 : W / 2;
  static constexpr int kPerRow = COLS / kE;
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kCopies = ROWS / kRowStep;
  static constexpr int kWords = 5;     // registers a chunk's loads fill
  static_assert(kPerRow * kE == COLS && kRowStep * kPerRow == kThreads &&
                kCopies * kRowStep == ROWS, "whole copies");
  static_assert(!kRegs || kCopies * 5 <= 32, "info: 5 bits a chunk");

  static __device__ __forceinline__ void copy(uint32_t dst, const bf16* g,
                                              const bf16* base, size_t pitch,
                                              int row0, int n_rows,
                                              int cols) {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int r = row0 + j * kRowStep;
      const bool in = cols > 0 && r >= 0 && r < n_rows;
      cp_async<W>(dst + 2 * j * kRowStep * LD, in ? g : base,
                  in ? 2 * min(cols, kE) : 0);
      g = gen::step_ptr(g, kRowStep * pitch);
    }
  }

  // info: per chunk j, bits 5j.. hold its elements inside the matrix (0-8)
  // and bit 5j + 4 whether it starts 2 bytes past a word
  static __device__ __forceinline__ void load(
      uint32_t (&w)[kCopies][kWords], uint32_t& info, const bf16* g,
      size_t pitch, int row0, int n_rows, int cols) {
    info = 0;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int r = row0 + j * kRowStep;
      const int v = r >= 0 && r < n_rows ? min(max(cols, 0), 8) : 0;
      const int mis = int(reinterpret_cast<uintptr_t>(g) >> 1) & 1;
      const unsigned int* q = reinterpret_cast<const unsigned int*>(g - mis);
#pragma unroll
      for (int i = 0; i < 5; ++i)
        w[j][i] = v > 0 && 2 * i - mis < v ? __ldg(q + i) : 0u;
      info |= uint32_t(v | mis << 4) << (5 * j);
      g = gen::step_ptr(g, kRowStep * pitch);
    }
  }

  static __device__ __forceinline__ void store(
      uint32_t dst, const uint32_t (&w)[kCopies][kWords], uint32_t info) {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int v = (info >> (5 * j)) & 15, mis = (info >> (5 * j + 4)) & 1;
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = mis ? __byte_perm(w[j][i], w[j][i + 1], 0x5432) : w[j][i];
        if (v < 8)
          o[i] &= (2 * i < v ? 0xFFFFu : 0u) |
                  (2 * i + 1 < v ? 0xFFFF0000u : 0u);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                       dst + 2 * j * kRowStep * LD), "r"(o[0]), "r"(o[1]),
                   "r"(o[2]), "r"(o[3]) : "memory");
    }
  }
};

// Item (tile, split) = (item / splits, item % splits), as in gen: with
// splits == 1 the block writes its tile of C; otherwise (64 x 64 tiles
// only) it writes its float32 partial to part[item], and the tile's last
// block to finish sums the partials in split order into C.  Every thread
// of the block calls it; it primes the ring (and, for a shifted A, zeroes
// A's leading elements) itself, so a block can take one item after
// another.
// WA, WB: the access widths (bytes) of A and B.  WB divides B's base
// address and row pitch; WA divides A's row pitch, and A's K tiles start
// `sa` elements early (K tile kt covers k in [32kt - sa, 32kt - sa +
// 32)), sa = (A's base mod WA) / 2, so that every copy of A is
// WA-aligned: a base 2 bytes off 16 with rows of whole 16-byte chunks
// still copies 16 bytes at a time.  B's rows follow the same k; A's
// elements outside [0, K) are zeroed, not copied (B's rows there are
// zero, but A's neighbours may hold any bits, a NaN among them): past K by
// the copies' src-size, before 0 in shared memory by the thread that
// copied them.
template <int BM, int BN, int WA, int WB>
__device__ __forceinline__ void bf16_general_item(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    bf16* __restrict__ C, float* __restrict__ part,
    int* __restrict__ tickets, int M, int N, int K, int sa, int splits,
    int item) {
  using G = Cfg<BM, BN>;
  using OA = Operand<BM, kBK, G::kALd, WA>;
  using OB = Operand<kBK, BN, G::kBLd, WB>;
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ int last_flag;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int tile = item / splits, split = item % splits;

  // grouped tile order: kGroupM tile rows walk the tile columns together
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int group_rows = min(tiles_m - first_m, kGroupM);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % group_rows) * BM;
  const int n0 = (in_group / group_rows) * BN;
  // this split's K tiles (the wrapper leaves no split empty)
  const int k_tiles = (K + sa + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  const int kt0 = split * per;
  const int n_kt = max(0, min(k_tiles, kt0 + per) - kt0);

  // this thread's row and column in each operand's tile, and where they
  // land in a stage (a byte offset); K tile kt starts at k = 32kt - sa
  const int a_r = tid / OA::kPerRow, a_c = (tid % OA::kPerRow) * OA::kE;
  const int b_r = tid / OB::kPerRow, b_c = (tid % OB::kPerRow) * OB::kE;
  const uint32_t smem0 = smem_u32(smem);
  const uint32_t a_dst = 2 * (a_r * G::kALd + a_c);
  const uint32_t b_dst = 2 * (G::kA + b_r * G::kBLd + b_c);
  auto a_src = [&](int kt) {
    return A + (ptrdiff_t(m0 + a_r) * K + ptrdiff_t(kt) * kBK + a_c - sa);
  };
  auto b_src = [&](int kt) {
    return B + (ptrdiff_t(kt * kBK - sa + b_r) * N + n0 + b_c);
  };
  // the cp.async operands of K tile kt into stage `slot`
  auto copy_tile = [&](int kt, int slot) {
    const uint32_t st = smem0 + 2 * slot * G::kStage;
    const int k0 = kt * kBK - sa;
    if constexpr (!OA::kRegs)
      OA::copy(st + a_dst, a_src(kt), A, K, m0 + a_r, M, K - k0 - a_c);
    if constexpr (!OB::kRegs)
      OB::copy(st + b_dst, b_src(kt), B, N, k0 + b_r, K, N - n0 - b_c);
  };
  // the register operands: loads of K tile kt, then their stores
  uint32_t ra[OA::kCopies][OA::kWords], rb[OB::kCopies][OB::kWords];
  uint32_t ia = 0, ib = 0;
  auto load_regs = [&](int kt) {
    const int k0 = kt * kBK - sa;
    if constexpr (OA::kRegs)
      OA::load(ra, ia, a_src(kt), K, m0 + a_r, M, K - k0 - a_c);
    if constexpr (OB::kRegs)
      OB::load(rb, ib, b_src(kt), N, k0 + b_r, K, N - n0 - b_c);
  };
  auto store_regs = [&](int slot) {
    const uint32_t st = smem0 + 2 * slot * G::kStage;
    if constexpr (OA::kRegs) OA::store(st + a_dst, ra, ia);
    if constexpr (OB::kRegs) OB::store(st + b_dst, rb, ib);
  };
  constexpr bool kAnyRegs = OA::kRegs || OB::kRegs;

  float acc[G::kMI][G::kNI][4];
#pragma unroll
  for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // prologue: the cp.async operands of tiles 0 .. kStages-2 in flight (one
  // commit group each, empty past the last tile, so the wait below counts
  // groups uniformly); the register operands of tile 0 stored
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) copy_tile(kt0 + s, s);
    gen::cp_async_commit();
  }
  if (kAnyRegs && n_kt > 0) {
    load_regs(kt0);
    store_regs(0);
  }
  // a shifted A's first tile: a thread whose copies straddle k = 0 zeroes
  // the sa elements before it once its own copies have landed (the loop's
  // first barrier publishes them); copies that straddle k = K were cut at
  // K by their src-size
  if constexpr (!OA::kRegs) {
    if (sa > 0 && kt0 == 0 && n_kt > 0 && a_c == 0) {
      gen::cp_async_wait<kStages - 2>();
#pragma unroll
      for (int j = 0; j < OA::kCopies; ++j)
        for (int c = 0; c < sa; ++c)
          smem[(a_r + j * OA::kRowStep) * G::kALd + c] =
              __float2bfloat16(0.f);
    }
  }

  for (int it = 0; it < n_kt; ++it) {
    const int slot = it % kStages;
    gen::cp_async_wait<kStages - 2>();   // tile it's copies have landed
    __syncthreads();                     // ... for every thread, with its
                                         // register stores; and tile it-1,
                                         // whose slot is refilled next, is
                                         // read
    const int nt = it + kStages - 1;
    if (nt < n_kt) copy_tile(kt0 + nt, nt % kStages);
    gen::cp_async_commit();
    // the register operands of tile it+1 are loaded before this tile's
    // MMAs and stored after them, so their loads are in flight under them
    const bool next = kAnyRegs && it + 1 < n_kt;
    if (next) load_regs(kt0 + it + 1);

    const bf16* as = smem + slot * G::kStage;
    const bf16* bs = as + G::kA;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[G::kMI][4], bfr[G::kNI][2];
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi)
        ldmatrix_x4(af[mi], as + (wm * G::kWM + mi * 16 + lane % 8 +
                                  ((lane / 8) % 2) * 8) * G::kALd +
                                ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < G::kNI / 2; ++nj) {
        uint32_t r[4];   // k lo / hi of columns 16nj..+7, then +8..+15
        ldmatrix_x4_trans(r, bs + (ks * 16 + lane % 8 +
                                   ((lane / 8) % 2) * 8) * G::kBLd +
                                 wn * G::kWN + nj * 16 + (lane / 16) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::kNI; ++ni)
          mma_16816(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    if (next) store_regs((it + 1) % kStages);
  }
  gen::cp_async_wait<0>();

  // accumulator (mi, ni, 2h + e) holds row row_of(mi, h), column
  // col_of(ni) + e of the block's tile
  auto row_of = [&](int mi, int h) {
    return wm * G::kWM + mi * 16 + lane / 4 + 8 * h;
  };
  auto col_of = [&](int ni) { return wn * G::kWN + ni * 8 + 2 * (lane % 4); };
  // C straight from registers, rounded to bf16 (nearest even): a pair of
  // columns as one 4-byte store where C's rows start 4-byte aligned (n
  // even), else element by element; masked at the edges
  auto store_c = [&]() {
    const bool pairs =
        N % 2 == 0 && reinterpret_cast<uintptr_t>(C) % 4 == 0;
#pragma unroll
    for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + row_of(mi, h);
        if (gm >= M) continue;
        bf16* crow = C + size_t(gm) * N;
#pragma unroll
        for (int ni = 0; ni < G::kNI; ++ni) {
          const int gn = n0 + col_of(ni);
          const float x = acc[mi][ni][2 * h], y = acc[mi][ni][2 * h + 1];
          if (pairs) {
            if (gn < N)
              *reinterpret_cast<__nv_bfloat162*>(crow + gn) =
                  __floats2bfloat162_rn(x, y);
          } else {
            if (gn < N) crow[gn] = __float2bfloat16_rn(x);
            if (gn + 1 < N) crow[gn + 1] = __float2bfloat16_rn(y);
          }
        }
      }
  };
  // 128 x 128 tiles fill the card unsplit (the wrapper's plan), so only
  // the 64 x 64 kernel compiles the split path, as in gen
  if (BM == 128 || splits == 1) {
    store_c();
    return;
  }
  float* mine = part + size_t(item) * BM * BN;
#pragma unroll
  for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < G::kNI; ++ni)
        *reinterpret_cast<float2*>(mine + row_of(mi, h) * BN + col_of(ni)) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  if (!gen::last_split(tickets + tile, splits, &last_flag)) return;
  // the last block: C = ((p_0 + p_1) + p_2) + ... in float32, whichever
  // block finishes last, then one rounding to bf16; partials read past L1
  for (int s = 0; s < splits; ++s) {
    const float* slot = part + (size_t(tile) * splits + s) * BM * BN;
#pragma unroll
    for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < G::kNI; ++ni) {
          const float2 p = __ldcg(reinterpret_cast<const float2*>(
              slot + row_of(mi, h) * BN + col_of(ni)));
          float* c = &acc[mi][ni][2 * h];
          c[0] = s ? c[0] + p.x : p.x;
          c[1] = s ? c[1] + p.y : p.y;
        }
  }
  store_c();
}

// One item a block (kStride false), or a grid-stride walk of the items
// under an SM budget (kStride true), as gen's kernel.
template <int BM, int BN, int WA, int WB, bool kStride>
__global__ void __launch_bounds__(kThreads, BM == 128 ? 2 : 4)
matmul_bf16_general_kernel(const bf16* __restrict__ A,
                           const bf16* __restrict__ B, bf16* __restrict__ C,
                           float* __restrict__ part, int* __restrict__ tickets,
                           int M, int N, int K, int sa, int splits,
                           int items) {
  if constexpr (kStride) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      bf16_general_item<BM, BN, WA, WB>(A, B, C, part, tickets, M, N, K, sa,
                                        splits, item);
      __syncthreads();   // the ring and the flag are free for the next item
    }
  } else {
    bf16_general_item<BM, BN, WA, WB>(A, B, C, part, tickets, M, N, K, sa,
                                      splits, int(blockIdx.x));
  }
}

struct Args {
  const bf16* a;
  const bf16* b;
  bf16* c;
  float* part;
  int* tickets;
  int m, n, k, sa, splits;
  int max_blocks;      // the budgeted build's grid cap (blocks)
  int* resident;       // non-null: report the kernel's blocks an SM
                       // holds instead of launching
  cudaStream_t stream;
};

template <int BM, int WA, int WB>
cudaError_t launch(const Args& p) {
  using G = Cfg<BM, BM>;
  auto kernel = matmul_bf16_general_kernel<BM, BM, WA, WB, kBudgeted>;
  static bool opted_in = false;
  const cudaError_t e = gen::opt_in(kernel, G::kSmem, opted_in);
  if (e != cudaSuccess) return e;
  if (p.resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(p.resident, kernel,
                                                         kThreads, G::kSmem);
  const long long items = (long long)((p.m + BM - 1) / BM) *
                          ((p.n + BM - 1) / BM) * p.splits;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid =
      kBudgeted && items > p.max_blocks ? p.max_blocks : items;
  kernel<<<unsigned(grid), kThreads, G::kSmem, p.stream>>>(
      p.a, p.b, p.c, p.part, p.tickets, p.m, p.n, p.k, p.sa, p.splits,
      int(items));
  return cudaGetLastError();
}

template <int BM, int WA>
cudaError_t launch_wb(int wb, const Args& p) {
  switch (wb) {
    case 16: return launch<BM, WA, 16>(p);
    case 8: return launch<BM, WA, 8>(p);
    case 4: return launch<BM, WA, 4>(p);
    default: return launch<BM, WA, 2>(p);
  }
}

template <int BM>
cudaError_t launch_wa(int wa, int wb, const Args& p) {
  switch (wa) {
    case 16: return launch_wb<BM, 16>(wb, p);
    case 8: return launch_wb<BM, 8>(wb, p);
    case 4: return launch_wb<BM, 4>(wb, p);
    default: return launch_wb<BM, 2>(wb, p);
  }
}

// Whether w is an access width (2, 4, 8 or 16 bytes) that divides both a
// matrix's row pitch and its base address, that base taken `shift`
// elements early (0 <= shift < w / 2).
inline bool access_fits(int w, const void* base, long long pitch_bytes,
                        int shift) {
  return (w == 2 || w == 4 || w == 8 || w == 16) && shift >= 0 &&
         (shift == 0 || 2 * shift < w) && pitch_bytes % w == 0 &&
         (reinterpret_cast<uintptr_t>(base) - 2 * shift) % w == 0;
}

}  // namespace bf

#ifndef CLUSTER_MATMUL_BUDGETED
// ------------------------------------------------------- bf16, wgmma --
namespace wg {

constexpr int kBM = 128;             // rows of C per block (2 x 64)
constexpr int kBN = 256;             // columns of C per block
constexpr int kBK = 64;              // K per stage: one 128-byte row of A
constexpr int kBoxN = 64;            // B's TMA box: 64 columns (128 bytes)
constexpr int kStages = 4;
constexpr int kConsumers = 2;        // warpgroups running wgmma
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2;          // 16 KB
constexpr int kBBytes = kBK * kBN * 2;          // 32 KB: 4 boxes of 8 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kCLd = kBN + 8;        // epilogue staging row (elements):
                                     // 528 bytes, conflict-free pair stores
constexpr int kGroupM = 8;           // tile rows per L2 group
// the 1 KB the swizzled tiles' alignment may cost, the ring, 2 x kStages
// mbarriers
constexpr size_t kSmem = 1024 + size_t(kStages) * kStageBytes +
                         2 * kStages * sizeof(uint64_t);
static_assert(kConsumers * 64 * kCLd * 2 <= kStages * kStageBytes,
              "the epilogue stages C in the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), and
// layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence, commit and wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256, f32) += A (64 x 16, K-major) . B (16 x 256, MN-major).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         __nv_bfloat16* __restrict__ C, int M, int N,
                         int K) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte-swizzled TMA tiles and their descriptors want 1 KB alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  // grouped tile order: kGroupM tile rows walk the tile columns together
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (int(blockIdx.x) / per_group) * kGroupM;
  const int group_rows = min(tiles_m - first_m, kGroupM);
  const int in_group = int(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % group_rows) * kBM;
  const int n0 = (in_group / group_rows) * kBN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);             // the producer's expect_tx
      mbar_init(&empty[s], kConsumers);   // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        uint8_t* a = smem + s * kStageBytes;
        uint8_t* b = a + kABytes;
        // the full box bytes land whatever the edge (TMA zero-fills)
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(a, &map_a, &full[s], kt * kBK, m0);
#pragma unroll
        for (int j = 0; j < kBN / kBoxN; ++j)
          tma_load_2d(b + j * kBK * 128, &map_b, &full[s], n0 + j * kBoxN,
                      kt * kBK);
      }
    }
  } else {
    // ------------------------------------------------ consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint8_t* a = smem + s * kStageBytes + wgi * 64 * 128;
      const uint8_t* b = smem + s * kStageBytes + kABytes;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // A: +32 bytes per 16-deep step inside the 128-byte rows;
        // B: +16 rows of 128 bytes
        wgmma_m64n256k16(d, gmma_desc(a + kk * 32, 16, 1024),
                         gmma_desc(b + kk * 16 * 128, kBK * 128, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // keep this k-tile's wgmmas in flight; the previous tile's are done
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);

    // epilogue: every load was consumed and every wgmma has read its
    // operands once both consumers pass this barrier, so the ring is free
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
    __nv_bfloat16* cs =
        reinterpret_cast<__nv_bfloat16*>(smem) + wgi * 64 * kCLd;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator i holds row 16*warp + lane/4 + 8*((i/2)%2) and column
    // 8*(i/4) + 2*(lane%4) + i%2 of the warpgroup's 64 x 256
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int r = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kCLd + c) =
          __floats2bfloat162_rn(d[i], d[i + 1]);
    }
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wgi) : "memory");
    const int row0 = m0 + wgi * 64;
#pragma unroll 4
    for (int e = t; e < 64 * (kBN / 8); e += 128) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      const int gm = row0 + r, gn = n0 + c;
      if (gm < M && gn < N)   // n % 8 == 0: a chunk is all in or all out
        *reinterpret_cast<uint4*>(C + size_t(gm) * N + gn) =
            *reinterpret_cast<const uint4*>(cs + r * kCLd + c);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !p)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A row-major (rows, cols) bf16 matrix, boxes of (box_rows, box_cols)
// with 128-byte swizzle (box_cols * 2 == 128).
bool encode_2d(EncodeTiled fn, CUtensorMap* map, const void* base, int rows,
               int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t pitch[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, pitch, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
#endif  // CLUSTER_MATMUL_BUDGETED

// The general branch, any shape.  dtype: 0 = float32, 1 = bfloat16 (A, B
// and C alike).  `tile` 128 (128 x 128 tiles, splits 1) or 64 (64 x 64)
// and `splits` >= 1 K splits; with splits > 1, `part` holds tiles *
// splits * tile^2 float32 partials and `tickets` tiles int32 zeros (every
// launch leaves them zero), and no split may be empty: (splits - 1) *
// ceil(k_tiles / splits) < k_tiles for k_tiles = ceil(k / 16) (float32)
// or ceil((k + sa) / 32) (bfloat16).  float32 needs 4-byte-aligned bases
// and ignores wa, wb, sa; bfloat16 takes wa and wb, the access widths (2,
// 4, 8 or 16 bytes) of A and B: wb divides B's base address and row pitch
// (2n bytes), wa divides A's row pitch (2k bytes) and A's base address
// taken sa elements early (0 <= sa < wa / 2; sa = 0 with wa = 2).
// `max_blocks`: 0 in this build, the grid cap (> 0) in the budgeted one.
// Anything else is refused with cudaErrorInvalidValue.  Launches on
// `stream`; does not synchronise.
extern "C" int cluster_matmul_launch(int dtype, const void* a, const void* b,
                                     void* c, int m, int n, int k, int tile,
                                     int splits, int wa, int wb, int sa,
                                     int max_blocks, void* part,
                                     void* tickets, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || splits < 1 ||
      (kBudgeted ? max_blocks < 1 : max_blocks != 0) ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (dtype == 0) sa = 0;
  const int bk = dtype == 0 ? gen::kBK : bf::kBK;
  const int k_tiles = (k + sa + bk - 1) / bk;
  if (splits > 1 &&
      (!part || !tickets ||
       (splits - 1) * ((k_tiles + splits - 1) / splits) >= k_tiles))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fp = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0) {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fc = static_cast<float*>(c);
    cudaError_t e = cudaErrorInvalidValue;
    if (tile == 128 && splits == 1)
      e = gen::launch<128, 128>(fa, fb, fc, fp, tk, m, n, k, splits,
                                max_blocks, s);
    else if (tile == 64)
      e = gen::launch<64, 64>(fa, fb, fc, fp, tk, m, n, k, splits,
                              max_blocks, s);
    return int(e);
  }
  if (!(tile == 64 || (tile == 128 && splits == 1)) ||
      !bf::access_fits(wa, a, 2LL * k, sa) ||
      !bf::access_fits(wb, b, 2LL * n, 0) ||
      reinterpret_cast<uintptr_t>(c) % 2)
    return int(cudaErrorInvalidValue);
  const bf::Args p{static_cast<const bf::bf16*>(a),
                   static_cast<const bf::bf16*>(b), static_cast<bf::bf16*>(c),
                   fp, tk, m, n, k, sa, splits, max_blocks, nullptr, s};
  return int(tile == 128 ? bf::launch_wa<128>(wa, wb, p)
                         : bf::launch_wa<64>(wa, wb, p));
}

#ifdef CLUSTER_MATMUL_BUDGETED
// The blocks of the general kernel's grid-stride (budgeted) form that one
// SM holds at once, for a tile (64 or 128) and, in bfloat16 (dtype 1),
// A's and B's access widths: cudaOccupancyMaxActiveBlocksPerMultiprocessor
// with the kernel's threads and shared memory.  The wrapper caps a
// budgeted grid at budget x this.
extern "C" int cluster_matmul_resident(int dtype, int tile, int wa, int wb,
                                       int* blocks) {
  if (!blocks || (tile != 64 && tile != 128)) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(tile == 128
                   ? gen::launch<128, 128>(nullptr, nullptr, nullptr, nullptr,
                                           nullptr, 0, 0, 0, 1, 0, nullptr,
                                           blocks)
                   : gen::launch<64, 64>(nullptr, nullptr, nullptr, nullptr,
                                         nullptr, 0, 0, 0, 1, 0, nullptr,
                                         blocks));
  if (dtype != 1) return int(cudaErrorInvalidValue);
  bf::Args p{};
  p.resident = blocks;
  return int(tile == 128 ? bf::launch_wa<128>(wa, wb, p)
                         : bf::launch_wa<64>(wa, wb, p));
}
#else

// The wgmma branch: bfloat16 A (m, k), B (k, n), C (m, n), row-major, with
// k % 8 == 0, n % 8 == 0 and 16-byte-aligned bases (TMA's rule; anything
// else is refused with cudaErrorInvalidValue: the wrapper's route sends
// such shapes to cluster_matmul_launch).  Encodes the two tensor maps,
// then launches on `stream`; does not synchronise.
extern "C" int cluster_matmul_wgmma_launch(const void* a, const void* b,
                                           void* c, int m, int n, int k,
                                           void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return int(cudaErrorInvalidValue);
  wg::EncodeTiled fn;
  cudaError_t e = wg::encode_fn(&fn);
  if (e != cudaSuccess) return int(e);
  CUtensorMap map_a, map_b;
  if (!wg::encode_2d(fn, &map_a, a, m, k, wg::kBM, wg::kBK) ||
      !wg::encode_2d(fn, &map_b, b, k, n, wg::kBK, wg::kBoxN))
    return int(cudaErrorInvalidValue);
  static bool opted_in = false;
  if (!opted_in) {
    e = cudaFuncSetAttribute(wg::matmul_bf16_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(wg::kSmem));
    if (e != cudaSuccess) return int(e);
    opted_in = true;
  }
  const long long tiles = (long long)((m + wg::kBM - 1) / wg::kBM) *
                          ((n + wg::kBN - 1) / wg::kBN);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  wg::matmul_bf16_wgmma_kernel<<<unsigned(tiles), wg::kThreads, wg::kSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
#endif  // CLUSTER_MATMUL_BUDGETED
