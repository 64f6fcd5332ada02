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
//   bfloat16 shapes the wgmma branch cannot take run a separate kernel:
//   32 K per step on the tensor cores through WMMA (mma.sync, 16 x 16 x
//   16 bf16 fragments, float32 accumulators in registers), 8 warps as 2 x
//   4, each owning 64 x 32 of C of a 128 x 128 tile, operands staged
//   synchronously in shared memory and zero-filled past the edges; the
//   epilogue stages each 16 x 16 fragment through shared memory to round
//   and bounds-check it.
//
// Plain C interface (loaded with ctypes): cluster_matmul_launch (general,
// both types) and cluster_matmul_wgmma_launch return cudaGetLastError()
// after the launch; 0 means launched.

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;             // rows of C per block
constexpr int kBN = 128;             // columns of C per block

// --------------------------------------------------------------- bf16 --
constexpr int kBK16 = 32;            // K per step
constexpr int kLdA = kBK16 + 8;      // As row stride (elements): a multiple
constexpr int kLdB = kBN + 8;        // of 8, and 16-row fragment offsets
                                     // stay 32-byte aligned

__global__ void __launch_bounds__(kThreads)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B,
                   __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK16 * kLdB];
  __shared__ __align__(32) float Cs[kThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;   // warp's C: rows wm*64, cols wn*32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK16) {
#pragma unroll
    for (int i = 0; i < kBM * kBK16 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK16, c = e % kBK16;
      const int gm = m0 + r, gk = k0 + c;
      As[r * kLdA + c] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : zero;
    }
#pragma unroll
    for (int i = 0; i < kBK16 * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * kLdB + c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + wn * 32 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int gm = m0 + wm * 64 + i * 16 + e / 16;
        const int gn = n0 + wn * 32 + j * 16 + e % 16;
        if (gm < M && gn < N)
          C[(size_t)gm * N + gn] = __float2bfloat16_rn(Cs[warp][e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

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
__device__ __forceinline__ const float* step_ptr(const float* p,
                                                 size_t step) {
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

// Block (tile, split) = (blockIdx.x / splits, blockIdx.x % splits): the
// splits of a tile are neighbours in the grid, so they run together.
// With splits == 1 the block writes its tile of C; otherwise (64 x 64
// tiles only) it writes its float32 partial to part[blockIdx.x], and the
// tile's last block to finish sums the partials in split order (0, 1,
// ...) into C.
template <int BM, int BN>
__global__ void __launch_bounds__(Cfg<BM, BN>::kThreads,
                                  512 / Cfg<BM, BN>::kThreads)
matmul_f32_general_kernel(const float* __restrict__ A,
                          const float* __restrict__ B, float* __restrict__ C,
                          float* __restrict__ part, int* __restrict__ tickets,
                          int M, int N, int K, int splits) {
  using G = Cfg<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_flag;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / G::kWarpsN, wn = warp % G::kWarpsN;
  const int lm = lane / 4, ln = lane % 4;
  const int tile = int(blockIdx.x) / splits, split = int(blockIdx.x) % splits;

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
  // the partial, 16 bytes at a time, into this block's slot
  float* mine = part + size_t(blockIdx.x) * BM * BN;
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

template <int BM, int BN>
cudaError_t launch(const float* a, const float* b, float* c, float* part,
                   int* tickets, int m, int n, int k, int splits,
                   cudaStream_t stream) {
  using G = Cfg<BM, BN>;
  auto kernel = matmul_f32_general_kernel<BM, BN>;
  static bool opted_in = false;   // above 48 KB a block needs the opt-in
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::kSmem));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const long long blocks =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN) * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), G::kThreads, G::kSmem, stream>>>(
      a, b, c, part, tickets, m, n, k, splits);
  return cudaGetLastError();
}

}  // namespace gen

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

// The general branch, any shape and any 4-byte-aligned bases.  dtype: 0 =
// float32, 1 = bfloat16 (A, B and C alike).  float32 takes `tile` 128
// (128 x 128 tiles, splits 1) or 64 (64 x 64) and `splits` >= 1 K
// splits; with splits > 1, `part` holds tiles * splits * tile^2 float32 partials and
// `tickets` tiles int32 zeros (every launch leaves them zero), and no
// split may be empty: (splits - 1) * ceil(k_tiles / splits) < k_tiles for
// k_tiles = ceil(k / 16).  bfloat16 takes tile 128 and splits 1 only.
// Anything else is refused with cudaErrorInvalidValue.  Launches on
// `stream`; does not synchronise.
extern "C" int cluster_matmul_launch(int dtype, const void* a, const void* b,
                                     void* c, int m, int n, int k, int tile,
                                     int splits, void* part, void* tickets,
                                     void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || splits < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int k_tiles = (k + gen::kBK - 1) / gen::kBK;
    if (splits > 1 &&
        (!part || !tickets ||
         (splits - 1) * ((k_tiles + splits - 1) / splits) >= k_tiles))
      return int(cudaErrorInvalidValue);
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fc = static_cast<float*>(c);
    float* fp = static_cast<float*>(part);
    int* tk = static_cast<int*>(tickets);
    cudaError_t e = cudaErrorInvalidValue;
    if (tile == 128 && splits == 1)
      e = gen::launch<128, 128>(fa, fb, fc, fp, tk, m, n, k, splits, s);
    else if (tile == 64)
      e = gen::launch<64, 64>(fa, fb, fc, fp, tk, m, n, k, splits, s);
    return int(e);
  }
  if (dtype != 1 || tile != 128 || splits != 1)
    return int(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_bf16_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

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
