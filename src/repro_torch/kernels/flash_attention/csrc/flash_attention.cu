// Flash attention forward for Hopper (sm_90a): dense causal / windowed /
// softcapped attention with an online softmax, GQA without expanding K/V.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _kernel (the pl.pallas_call in flash_attention_fwd), which the port's
// training path enters through ops.flash_attention / mha_flash for the
// forward of every full-sequence self-attention layer.
//
// What it computes, per flat query head b (KV-major: head b reads KV row
// b / groups) and query row i (qpos = i, kpos = t, iotas aligned
// top-left):
//     s[t] = cap * tanh((q_i . k_t) * scale / cap)      (no tanh if cap=0)
//     visible(t) = t < T && (!causal || t <= i) && (!window || i - t < window)
//     out_i = sum_t p[t] v_t / l,   p[t] = exp(s[t] - m), l = sum_t p[t]
// with the reference's online softmax: m, l and the accumulator in
// float32, masked scores NEG_INF = -1e30 and their probabilities zeroed,
// p rounded to v's type before P.V (the reference's p.astype(v.dtype)),
// and a row with no visible key (l == 0) giving 0.  The output is in q's
// type (float32 or bfloat16).
//
// Two kernels, chosen by the wrapper (kernel.py::route) from the type and
// hd alone, never on a failure: bfloat16 with hd in {64, 128, 256} runs on
// the tensor cores (namespace tc); float32 (whose 2e-4 bar is out of bf16
// and TF32 reach) and bf16 at hd 16 and 32 run on the FP32 cores
// (namespace fp32).
//
// What bounds it on the card: attention at S = 4096 reuses every K/V tile
// across 64 query rows, so it is bound by operations (4 hd per visible
// (query, key) pair), at the tensor cores' ~989 TFLOP/s in bf16.
//
// The tensor-core kernel (TMA + wgmma; the FlashAttention-3 arrangement
// without its intra-warpgroup overlap):
//   * one block of three warpgroups owns 128 query rows of one flat head:
//     warpgroups 0 and 1 are consumers (setmaxnreg 240) with 64 rows each,
//     warpgroup 2 the producer (setmaxnreg 24), one of whose threads keeps
//     the ring full;
//   * Q (128 x hd) is loaded once by TMA and stays in shared memory; K and
//     V tiles of 64 keys go through a 2-stage ring, each tile hd / 64 TMA
//     boxes of 64 columns (128 bytes, 128-byte swizzle) x 64 rows, each
//     stage with "full" (expect_tx) and "empty" (every consumer thread)
//     mbarriers for K and for V apart, so K of the next tile lands while V
//     of this one is read.  3-D tensor maps (hd, rows, head) zero-fill
//     rows past S and T inside each head, so any S and T are right;
//   * S = Q . K^T is wgmma m64n64k16 over hd with both operands K-major
//     in shared memory; O += P . V is wgmma m64n{hd}k16 over the 64 keys
//     with P the A operand straight from registers (S's accumulator
//     layout is the A fragment's, packed to bf16) and V the MN-major B
//     operand (transpose bit, LBO 8 KB from one 64-column box to the
//     next, SBO 1 KB), so S never goes through shared memory;
//   * the online softmax runs on the accumulator in registers: each thread
//     holds two rows, the row max and sum reduce over the 4 threads of a
//     quad; exp2 of log2-scaled scores; the cap as cap - 2 cap / (e^(2x /
//     cap) + 1) with exp2 and a fast divide, a few float32 ulps of cap
//     from tanhf (tanh.approx would move a capped logit by ~0.02; tanhf
//     made the gemma2 call 1.4x slower, scripts/ab_kernel_variants.py);
//     p rounded to bf16 for P.V while l sums it unrounded;
//   * only edge tiles are masked element by element (the causal diagonal,
//     the window's first tile, keys past T); a consumer skips a tile none
//     of its rows can see, still releasing its stage.  The walk bounds are
//     the FP32-core kernel's, and the heaviest causal tiles start first;
//   * registers: O is hd / 2 float32 a thread (128 at hd 256), S 32, P 16.
//   What still holds it back: each consumer runs S, softmax and P.V in
//   turn (the two consumers overlap each other, not their own MMA with
//   their softmax), two stages hold one tile of prefetch at hd 256, and
//   the epilogue writes O from registers with 4-byte stores.  Next step: the
//   FlashAttention-3 ping-pong (S of tile j + 1 issued before the softmax
//   of tile j) and a TMA store of O.
//
// The FP32-core kernel (namespace fp32): float32 at every hd (its 2e-4
// bar is out of bf16's and TF32's reach) and bf16 at hd 16 and 32.  What
// bounds it: 4 hd operations per visible (query, key) pair on the FP32
// cores (67 TFLOP/s).  Its first kernel ran at 14-15% of that: it staged
// K, waited, scored, staged V into the same buffer, waited (four
// barriers a 32-key tile, no copy in flight), read 6 shared words per 32
// FMAs in S and 20 per 64 in P.V at hd 256, took tanhf and expf per
// score, and its grid (ceil(S / 64) x BH blocks) filled 2-128 of 132 SMs
// with the causal tiles' walks in turn.  This design (row 1f's, the
// paged FP32-core kernel's, for dense K/V):
//   * a block of 256 threads (a 16 x 16 grid) owns 64 query rows of one
//     flat head; S = q.K^T in 64-key tiles, each thread 4 rows x 4 keys
//     (rows ty + 16i, keys tx + 16j), q and K read 16 bytes along d at a
//     time: 8 reads feed 64 FMAs; P goes to shared memory; O += P.V with
//     each thread 4 rows x hd/16 dims, p read 4 keys at a time and V 16
//     bytes at a time (20 reads feed 256 FMAs at hd 256);
//   * K and V in separate cp.async stages, each with its own commit
//     group: K of tile j+1 is issued once S of tile j has read K, and
//     lands under P.V of j; V of j+1 is issued once P.V of j is done and
//     lands under S of j+1.  Two slots each where they fit, one each at
//     hd 256 in float32 (q 66.6 KB + K 66.6 + V 65.5 + P 20.5 = 219 KB, one
//     block an SM); bf16 tiles stay bf16 in shared memory (whole 16-byte
//     chunks of 32- or 64-byte rows) and are widened as fragments are
//     read.  Two barriers a tile;
//   * the online softmax per row across the row's 16 threads (a half-warp)
//     with shuffles, in log2 units with exp2, the cap through the tensor-
//     core kernel's cap - 2 cap / (e^(2x/cap) + 1) (a few float32 ulps of
//     cap from tanhf); masks only on tiles some (row, key) of the block
//     may not see; p rounded to v's type for P.V while l sums it
//     unrounded; a row that sees nothing writes 0;
//   * split-KV where the grid is under a wave (kernel.py::fp32_plan): a
//     query tile's walk is cut into spans of whole key tiles, one block a
//     span; a block with one live span writes the output, otherwise it
//     writes its float32 partial (m, l, acc) and takes a ticket
//     (__threadfence, atomicAdd), and the tile's last span to finish
//     combines the partials by log-sum-exp in span order (a span that saw
//     nothing of a row weighs 0, a row that saw nothing stays 0, never
//     NaN) and resets the ticket.  Query tiles are issued last-first, so
//     the causal grid's heaviest tiles start first.
//   What still holds it back (PERF.md §6): a 64 x 64 tile at hd 256 takes
//   ~18 us, ~40% of an SM's FMA rate, and one block fits an SM there; at
//   phase 10's global call S is ~0.042 ms and P.V ~0.031 of 0.128.  A
//   warp of 4 rows x 8 keys (fewer shared wavefronts) timed the same, so
//   shared bandwidth is not what bounds it.
//
// Plain C interface (loaded with ctypes): flash_attention_launch (FP32
// cores) and flash_attention_tc_launch (tensor cores) return
// cudaGetLastError() after the launch; 0 means launched.  q/k/v must be
// 16-byte aligned and contiguous (the wrapper checks): rows are read 16
// bytes at a time, which needs hd * element size to be a multiple of 16
// (every supported hd is).

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the reference's p.astype(v.dtype) leaves it, back in float32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 4) return x;
  else return __bfloat162float(__float2bfloat16(x));
}

// ----------------------------------------------------------- FP32 cores --
// float32 q, k, v at every head dim and bfloat16 at hd 16 and 32; see the
// design note at the top of the file.
namespace fp32 {

constexpr int kThreads = 256;        // a 16 x 16 thread grid
constexpr int kRows = 64;            // query rows per block
constexpr int kTok = 64;             // keys per K/V tile
constexpr int kTY = kThreads / 16;   // thread rows of the grid
constexpr int kRT = kRows / kTY;     // query rows of a thread
constexpr int kPLd = kTok + 16;      // P rows (floats): a warp's two rows
                                     // of p land in disjoint banks
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes: the q tile, P, and kSlots K slots
// and kSlots V slots, all in the inputs' own type (bf16 rows are widened
// as fragments are read).  q and K rows carry a 16-byte pad, so the 8
// rows a quarter-warp reads 16 bytes of start in 8 different bank groups.
// Two slots of each where they fit; at hd 256 in float32 one of each
// (q 66.6 KB, K 66.6 KB, V 65.5 KB, P 20.5 KB: 219 KB).
template <typename T, int HD>
struct Smem {
  static constexpr int kSlots = HD * int(sizeof(T)) >= 1024 ? 1 : 2;
  static constexpr int kLd = HD + 16 / int(sizeof(T));   // q and K rows
  static constexpr int kQ = kRows * kLd * int(sizeof(T));
  static constexpr int kP = kRows * kPLd * 4;
  static constexpr int kK = kTok * kLd * int(sizeof(T));
  static constexpr int kV = kTok * HD * int(sizeof(T));
  static constexpr int kBytes = kQ + kP + kSlots * (kK + kV);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, through L2 only; bytes = 0
// writes 16 zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// N consecutive elements of shared memory, widened to float32: float32
// 16, 8 or 4 bytes at once, bf16 8, 4 or 2
template <int N>
__device__ __forceinline__ void load_vec(float (&d)[N], const float* s) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = s[0];
  }
}
template <int N>
__device__ __forceinline__ void load_vec(float (&d)[N],
                                         const __nv_bfloat16* s) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(s);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    d[0] = lo.x; d[1] = lo.y; d[2] = hi.x; d[3] = hi.y;
  } else if constexpr (N == 2) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(s));
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = __bfloat162float(s[0]);
  }
}

// kRows rows [row0, row0 + kRows) of a (rows, HD) matrix of T into a
// shared tile of row pitch LD (elements), by 16-byte cp.async; rows at or
// past `limit` are zero-filled
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int row0, int limit) {
  constexpr int kE = 16 / int(sizeof(T));          // elements a copy
  constexpr int kChunks = HD / kE;                 // copies a row
  constexpr int kCopies = kRows * kChunks;
#pragma unroll
  for (int j = 0; j < (kCopies + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (kCopies % kThreads && i >= kCopies) break;
    const int r = i / kChunks, ch = i - r * kChunks;
    const bool in = row0 + r < limit;
    cp_async16(dst + r * LD + ch * kE,
               in ? src + size_t(row0 + r) * HD + ch * kE : src,
               in ? 16 : 0);
  }
}

// Whether this block is the last of its query tile's n_live live splits
// to finish: its ticket is taken after its partials are visible
// device-wide, and the last block puts the counter back to 0 for the next
// launch.  Every thread of the block calls it.
__device__ __forceinline__ bool last_split(int* ticket, int n_live,
                                           int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1) == n_live - 1;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Block (blockIdx.x, blockIdx.y) = (query tile x split, flat head b): the
// query tiles are issued last-first (the heaviest causal ones start
// first), each tile's splits together.  A split walks `span` key tiles of
// its query tile's walk; with one live split it writes the output, with
// more it writes its partial (m, l, acc) and the tile's last split to
// finish combines them in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ part_ml,
                      float* __restrict__ part_acc, int* __restrict__ tickets,
                      int S, int T_len, int groups, int causal, int window,
                      float cap, float scale, int span) {
  using L = Smem<T, HD>;
  constexpr int kLd = L::kLd;
  constexpr int kSlots = L::kSlots;
  constexpr int kD = HD / 16;              // P.V dims of a thread
  constexpr int kVec = kD < 4 ? kD : 4;    // ... read kVec at a time
  constexpr int kGroups = kD / kVec;       // ... in groups 16*kVec apart
  const int q_tiles = (S + kRows - 1) / kRows;
  const int n_splits = int(gridDim.x) / q_tiles;
  const int tile = q_tiles - 1 - int(blockIdx.x) / n_splits;
  const int split = int(blockIdx.x) % n_splits;
  const int b = blockIdx.y;
  const int q0 = tile * kRows;
  // thread (ty, tx): rows ty + kTY i of the tile, keys tx + 16j of a key
  // tile; a row's 16 threads are one half-warp
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // the keys any row of this tile may see, in kTok tiles from k_lo; this
  // split's share of them
  const int last_row = min(q0 + kRows, S) - 1;
  const int k_hi = causal ? min(T_len, last_row + 1) : T_len;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTok - 1) / kTok : 0;
  const int per = n_splits > 1 ? span : max(n_tiles, 1);
  const int n_live = max(1, (n_tiles + per - 1) / per);
  if (split >= n_live) return;                 // past the walk's end
  const int t0 = split * per;
  const int n_it = max(0, min(n_tiles, t0 + per) - t0);

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_flag;
  T* qs = reinterpret_cast<T*>(smem);
  float* ps = reinterpret_cast<float*>(smem + L::kQ);
  uint8_t* ring = smem + L::kQ + L::kP;
  auto k_slot = [&](int s) {
    return reinterpret_cast<T*>(ring + s * (L::kK + L::kV));
  };
  auto v_slot = [&](int s) {
    return reinterpret_cast<T*>(ring + s * (L::kK + L::kV) + L::kK);
  };
  const T* kb = k + size_t(b / groups) * T_len * HD;
  const T* vb = v + size_t(b / groups) * T_len * HD;
  auto stage_k = [&](int it) {
    if (it < n_it)
      stage<T, HD, kLd>(k_slot(it % kSlots), kb, k_lo + (t0 + it) * kTok,
                        k_hi);
  };
  auto stage_v = [&](int it) {
    if (it < n_it)
      stage<T, HD, HD>(v_slot(it % kSlots), vb, k_lo + (t0 + it) * kTok,
                       k_hi);
  };

  // commit groups, in order: q and K0, V0, ..., K(kSlots-1), V(kSlots-1);
  // then in step it, V(it-1+kSlots) (none at it = 0) and K(it+kSlots).
  // Counting them, K(it) and V(it) have landed once at most 2 kSlots - 2
  // younger groups are pending, and K(it) alone, for it < kSlots (the
  // prologue's), once 2 kSlots - 1 are: the first S does not wait for V0
  stage<T, HD, kLd>(qs, q + size_t(b) * S * HD, q0, S);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    stage_k(s);
    cp_async_commit();
    stage_v(s);
    cp_async_commit();
  }

  // the softcap as cap - 2 cap / (e^(2x/cap) + 1) through exp2 and a fast
  // divide (the tensor-core kernel's), scores then in log2 units
  const float two_cap = 2.f * cap;
  const float k2 = cap != 0.f ? 2.f * kLog2e / cap : 0.f;
  float m[kRT], l[kRT], acc[kRT][kD];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[i][d] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const T* ks = k_slot(it % kSlots);
    const T* vs = v_slot(it % kSlots);
    if (it < kSlots)
      cp_async_wait<2 * kSlots - 1>();   // K(it) (and q) landed ...
    else
      cp_async_wait<2 * kSlots - 2>();
    __syncthreads();   // ... for every thread; P.V of it-1 is done, so
    if (it > 0) stage_v(it - 1 + kSlots);   // its V slot takes a tile
    cp_async_commit();

    // S = q . K^T: kRT rows x 4 keys a thread, 4 elements of q and of K
    // at a time
    float s[kRT][4];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[kRT][4], kv4[4][4];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        load_vec(qv[i], qs + (ty + kTY * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_vec(kv4[j], ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = fmaf(qv[i][e], kv4[j][e], s[i][j]);
    }

    // scale, cap, log2 units; mask only a tile that some (row, key) of
    // the block may not see: keys past k_hi, the causal diagonal, the
    // window's edge; online softmax across the row's 16 threads
    const int k0 = k_lo + (t0 + it) * kTok;
    const bool edge = k0 + kTok > k_hi || (causal && k0 + kTok - 1 > q0) ||
                      (window && last_row - k0 >= window);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int row = ty + kTY * i, qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap - __fdividef(two_cap, 1.f + exp2f(k2 * x));
        x *= kLog2e;
        if (edge) {
          const int key = k0 + tx + 16 * j;
          const bool ok = key < T_len && (!causal || key <= qpos) &&
                          (!window || qpos - key < window);
          x = ok ? x : kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // p = exp(s - m), 0 where masked; l sums it as is, P.V takes it
        // rounded to v's type (the reference's p.astype(v.dtype))
        const float p = s[i][j] == kNegInf ? 0.f : exp2f(s[i][j] - m_new);
        sum += p;
        ps[row * kPLd + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[i][d] *= alpha;
    }
    cp_async_wait<2 * kSlots - 2>();   // V(it) landed ...
    __syncthreads();   // ... for every thread, P is complete, and K(it)
    stage_k(it + kSlots);              // is read: its slot takes a tile
    cp_async_commit();

    // O += P . V: kRT rows x kD dims a thread, p 4 keys at a time
#pragma unroll 4
    for (int t4 = 0; t4 < kTok; t4 += 4) {
      float pv[kRT][4];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        load_vec(pv[i], ps + (ty + kTY * i) * kPLd + t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float vv[kVec];
          load_vec(vv, vs + (t4 + e) * HD + g * 16 * kVec + tx * kVec);
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[i][g * kVec + x] =
                  fmaf(pv[i][e], vv[x], acc[i][g * kVec + x]);
        }
      }
    }
  }
  cp_async_wait<0>();   // an empty walk's q copies are still in flight

  // this thread's dims of a row: g * 16 kVec + tx kVec + x
  auto store_row = [&](int row, const float (&o)[kD], float l_row) {
    const float inv = 1.f / (l_row == 0.f ? 1.f : l_row);   // nothing seen
    T* dst = out + (size_t(b) * S + q0 + row) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      T* d = dst + g * 16 * kVec + tx * kVec;
      if constexpr (sizeof(T) == 4 && kVec == 4) {   // 16-byte rows
        *reinterpret_cast<float4*>(d) =
            make_float4(o[4 * g] * inv, o[4 * g + 1] * inv,
                        o[4 * g + 2] * inv, o[4 * g + 3] * inv);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          d[x] = from_f32<T>(o[g * kVec + x] * inv);
      }
    }
  };
  if (n_live == 1) {
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      if (q0 + ty + kTY * i < S) store_row(ty + kTY * i, acc[i], l[i]);
    return;
  }

  // the partial (m in log2 units, l, acc) of this split, in float32
  const size_t slot0 = (size_t(b) * q_tiles + tile) * n_splits;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const size_t r = (slot0 + split) * kRows + ty + kTY * i;
    if (tx == 0) {
      part_ml[2 * r] = m[i];
      part_ml[2 * r + 1] = l[i];
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        part_acc[r * HD + g * 16 * kVec + tx * kVec + x] =
            acc[i][g * kVec + x];
  }
  if (!last_split(tickets + size_t(b) * q_tiles + tile, n_live, &last_flag))
    return;
  // log-sum-exp combine in split order: m = max m_s, l = sum l_s 2^(m_s -
  // m), acc = sum acc_s 2^(m_s - m).  A split that saw nothing of a row
  // (m_s = NEG_INF, l_s = 0, acc_s = 0) weighs 0, or 1 times zeros if all
  // did: the row is 0, never NaN.  Partials are read past L1 (__ldcg):
  // other SMs wrote them; a split's loads for all the thread's rows and
  // dims are independent, so they are in flight together.
  float mx[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    mx[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[i][d] = 0.f;
  }
  for (int sp = 0; sp < n_live; ++sp)
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      mx[i] = fmaxf(mx[i], __ldcg(part_ml +
                                  2 * ((slot0 + sp) * kRows + ty + kTY * i)));
  for (int sp = 0; sp < n_live; ++sp) {
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const size_t r = (slot0 + sp) * kRows + ty + kTY * i;
      const float w = exp2f(__ldcg(part_ml + 2 * r) - mx[i]);
      l[i] = fmaf(__ldcg(part_ml + 2 * r + 1), w, l[i]);
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          acc[i][g * kVec + x] = fmaf(
              __ldcg(part_acc + r * HD + g * 16 * kVec + tx * kVec + x), w,
              acc[i][g * kVec + x]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    if (q0 + ty + kTY * i < S) store_row(ty + kTY * i, acc[i], l[i]);
}

// The largest number of key tiles any query tile walks (the grid needs
// ceil(that / span) splits)
inline int max_walk(int S, int T_len, int causal, int window) {
  int most = 0;
  for (int q0 = 0; q0 < S; q0 += kRows) {
    const int last_row = min(q0 + kRows, S) - 1;
    const int k_hi = causal ? min(T_len, last_row + 1) : T_len;
    const int k_lo = window ? max(0, q0 - window + 1) : 0;
    if (k_hi > k_lo) most = max(most, (k_hi - k_lo + kTok - 1) / kTok);
  }
  return most;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* part_ml, float* part_acc, int* tickets, int BH,
                   int S, int T_len, int groups, int causal, int window,
                   float cap, float scale, int span_keys, int n_splits,
                   cudaStream_t stream) {
  const int q_tiles = (S + kRows - 1) / kRows;
  int span = 0;
  if (n_splits > 1) {
    // whole key tiles a split, enough splits for the longest walk, and
    // the partials' scratch
    if (span_keys < kTok || span_keys % kTok || !part_ml || !part_acc ||
        !tickets)
      return cudaErrorInvalidValue;
    span = span_keys / kTok;
    if ((long long)n_splits * span < max_walk(S, T_len, causal, window))
      return cudaErrorInvalidValue;
  }
  if ((long long)q_tiles * n_splits > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_fp32_kernel<T, HD>;
  constexpr int smem = Smem<T, HD>::kBytes;
  static bool opted_in = false;   // above 48 KB a block needs the opt-in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid(q_tiles * n_splits, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part_ml, part_acc,
      tickets, S, T_len, groups, causal, window, cap, scale, span);
  return cudaGetLastError();
}

}  // namespace fp32

// -------------------------------------------------- tensor cores, bf16 --
// q, k, v bfloat16 with hd in {64, 128, 256}; see the design note at the
// top of the file.
namespace tc {

constexpr int kConsumers = 2;        // warpgroups running wgmma, 64 rows each
constexpr int kBQ = 64 * kConsumers; // query rows per block
constexpr int kBK = 64;              // keys per K/V tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int kBoxes = HD / 64;                // 64-column boxes
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;       // one K or V tile
  // the 1 KB the swizzled tiles' alignment may cost, Q, the K and V rings,
  // then full/empty mbarriers: Q's, and K's and V's per stage
  static constexpr size_t kBytes = 1024 + size_t(kQBytes) +
                                   2 * size_t(kStages) * kTileBytes +
                                   (1 + 4 * kStages) * sizeof(uint64_t);
};

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

// One box of a 3-D tensor map (columns, rows, head) into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
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

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma's fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) += A (64 x 16, K-major, shared) . B (16 x 64, K-major,
// shared): S = Q . K^T, K rows being B's columns.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) . B (16 x 64,
// MN-major, shared): O += P . V with P straight from the softmax.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) . B (16 x 128,
// MN-major, shared): O += P . V with P straight from the softmax.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16, registers) . B (16 x 256,
// MN-major, shared): O += P . V with P straight from the softmax.
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 256) wgmma_rs_m64n256k16(o, a, desc_b);
  else if constexpr (HD == 128) wgmma_rs_m64n128k16(o, a, desc_b);
  else wgmma_rs_m64n64k16(o, a, desc_b);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ out, int S, int T_len,
                    int groups, int causal, int window, float cap,
                    float scale) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte-swizzled TMA tiles and their descriptors want 1 KB alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                          // kBoxes x (kBQ rows x 128 B)
  uint8_t* ks = qs + L::kQBytes;               // kStages x (kBoxes x 8 KB)
  uint8_t* vs = ks + kStages * L::kTileBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + kStages * L::kTileBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int tile = gridDim.x - 1 - blockIdx.x;   // heaviest causal first
  const int b = blockIdx.y;
  const int q0 = tile * kBQ;
  // the keys any row of this block may see
  const int last_row = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? min(T_len, last_row + 1) : T_len;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);                  // the producer's expect_tx
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers * 128);  // every consumer thread
      mbar_init(&empty_v[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers * 128) {
      const int kvb = b / groups;
      // the full box bytes land whatever the edge (TMA zero-fills rows
      // past S and T)
      mbar_expect_tx(full_q, L::kQBytes);
      for (int j = 0; j < L::kBoxes; ++j)
        tma_load_3d(qs + j * kBQ * 128, &map_q, full_q, 64 * j, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = k_lo + it * kBK;
        const uint32_t parity = ((it / kStages) - 1) & 1;
        if (it >= kStages) mbar_wait(&empty_k[s], parity);
        mbar_expect_tx(&full_k[s], L::kTileBytes);
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load_3d(ks + s * L::kTileBytes + j * kBK * 128, &map_k,
                      &full_k[s], 64 * j, k0, kvb);
        if (it >= kStages) mbar_wait(&empty_v[s], parity);
        mbar_expect_tx(&full_v[s], L::kTileBytes);
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load_3d(vs + s * L::kTileBytes + j * kBK * 128, &map_v,
                      &full_v[s], 64 * j, k0, kvb);
      }
    }
    return;
  }

  // -------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = q0 + wgi * 64;                 // this warpgroup's rows
  // this thread's two rows: lane/4 and lane/4 + 8 of its warp's 16
  const int row_a = r0 + 16 * warp + lane / 4, row_b = row_a + 8;
  const bool wg_live = r0 < S;
  // the keys the warpgroup's rows may see: a tile outside is skipped
  const int k_first_w = window ? r0 - window + 1 : 0;
  const int k_last_w = causal ? r0 + 63 : T_len - 1;
  // the softcap as cap - 2 cap / (e^(2x/cap) + 1): exp2 and a fast
  // divide, within a few float32 ulps of cap (~1e-5 at cap 50) of
  // cap * tanhf(x / cap) and a quarter of its operations
  const float two_cap = 2.f * cap;
  const float k2 = cap != 0.f ? 2.f * kLog2e / cap : 0.f;
  const uint8_t* q_w = qs + wgi * 64 * 128;     // its rows of every box

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  mbar_wait(full_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = k_lo + it * kBK;
    bool live = wg_live && k0 <= k_last_w && k0 + kBK > k_first_w;
    // S = Q . K^T: m64n64k16 over hd; A and B K-major, +32 bytes per
    // 16-deep step inside a box's 128-byte rows, then the next box
    float sc[32];
    mbar_wait(&full_k[s], parity);
    if (live) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      const uint8_t* kt = ks + s * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64k16(
            sc, gmma_desc(q_w + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
            gmma_desc(kt + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
    }
    mbar_arrive(&empty_k[s]);

    // softmax: accumulator i holds row row_a (i/2 even) or row_b and key
    // k0 + 8*(i/4) + 2*(lane%4) + i%2
    uint32_t pa[kBK / 16][4];
    if (live) {
      // only a tile that some (row, key) of the warpgroup may not see is
      // masked element by element: the causal diagonal, the window's
      // first tile, and keys past T
      const bool edge = k0 + kBK > T_len || (causal && k0 + kBK - 1 > r0) ||
                        (window && r0 + 63 - k0 >= window);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale;
        if (cap != 0.f) x = cap - __fdividef(two_cap, exp2f(x * k2) + 1.f);
        x *= kLog2e;
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int row = (i / 2) % 2 ? row_b : row_a;
          const bool ok = key < T_len && (!causal || key <= row) &&
                          (!window || row - key < window);
          x = ok ? x : kNegInf;
        }
        sc[i] = x;
        if ((i / 2) % 2) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, d));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, d));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
      // p = exp(s - m), 0 where masked; l sums p as is, P.V takes it
      // rounded to bf16 (the reference's p.astype(v.dtype))
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i / 2) % 2;
        const float p = sc[i] == kNegInf ? 0.f
                                         : exp2f(sc[i] - (hi ? m_b : m_a));
        if (hi) l_b += p;
        else l_a += p;
        sc[i] = p;
      }
      // 16 keys 16kk.. are the A operand of P.V's k-step kk: rows lo/hi x
      // keys lo (8 values of n-block 2kk), then keys hi (n-block 2kk + 1)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= (i / 2) % 2 ? al_b : al_a;
    }

    // O += P . V: V MN-major (keys x hd row-major), LBO = 8 KB from one
    // 64-column box to the next, SBO = 1 KB, +16 rows per 16-key step
    mbar_wait(&full_v[s], parity);
    if (live) {
      fence_regs(o);
      wgmma_fence();
      const uint8_t* vt = vs + s * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk], gmma_desc(vt + kk * 16 * 128, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    mbar_arrive(&empty_v[s]);
  }

  if (!wg_live) return;
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, d);
    l_b += __shfl_xor_sync(kFull, l_b, d);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);   // fully masked -> 0
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  // accumulator i holds row row_a or row_b and column 8*(i/4) +
  // 2*(lane%4) + i%2: each quad writes 16 contiguous bytes of a row
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const bool hi = (i / 2) % 2;
    const int row = hi ? row_b : row_a;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    const float inv = hi ? inv_b : inv_a;
    if (row < S)
      *reinterpret_cast<uint32_t*>(out + (size_t(b) * S + row) * HD + col) =
          pack_bf16(o[i] * inv, o[i + 1] * inv);
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

// A (heads, rows, hd) bf16 tensor, boxes of 64 columns (128 bytes, the
// 128-byte swizzle) x box_rows rows x one head; rows past `rows` read as
// zeros.
bool encode_3d(EncodeTiled fn, CUtensorMap* map, const void* base, int heads,
               int rows, int hd, int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t pitch[2] = {cuuint64_t(hd) * 2,
                               cuuint64_t(rows) * cuuint64_t(hd) * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, pitch, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k,
                   const void* v, void* out, int BH, int S, int T_len,
                   int groups, int causal, int window, float cap, float scale,
                   cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!encode_3d(fn, &map_q, q, BH, S, HD, kBQ) ||
      !encode_3d(fn, &map_k, k, BH / groups, T_len, HD, kBK) ||
      !encode_3d(fn, &map_v, v, BH / groups, T_len, HD, kBK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<HD>;
  constexpr size_t smem = Smem<HD>::kBytes;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), S, T_len,
      groups, causal, window, cap, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The FP32-core kernel.  Element-type codes: 0 = float32, 1 = bfloat16
// (q, k, v and out share it).  q/out are (BH, S, hd), k/v (BH / groups, T,
// hd), contiguous device tensors; window = 0 and cap = 0 switch those
// masks off.  bfloat16 takes hd 16 and 32 only (wider heads run on the
// tensor cores, below).  n_splits > 1 splits each query tile's walk into
// spans of span_keys keys (a multiple of 64), n_splits of them enough for
// the longest walk; then part_ml holds BH * ceil(S / 64) * n_splits * 64 *
// 2 float32, part_acc the same times hd / 2, and tickets BH * ceil(S / 64)
// int32 zeros (every launch leaves them zero).  Any other call is refused
// with cudaErrorInvalidValue.  Launches on `stream`; does not synchronise.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, void* part_ml,
                                      void* part_acc, void* tickets, int BH,
                                      int S, int T_len, int hd, int groups,
                                      int causal, int window, float cap,
                                      float scale, int span_keys,
                                      int n_splits, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || T_len < 0 || groups < 1 ||
      BH % groups || n_splits < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
#define FLASH_FP32(T_, HD_)                                                 \
  fp32::launch<T_, HD_>(q, k, v, out, ml, acc, tk, BH, S, T_len, groups,    \
                        causal, window, cap, scale, span_keys, n_splits, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (hd) {
      case 16: e = FLASH_FP32(float, 16); break;
      case 32: e = FLASH_FP32(float, 32); break;
      case 64: e = FLASH_FP32(float, 64); break;
      case 128: e = FLASH_FP32(float, 128); break;
      case 256: e = FLASH_FP32(float, 256); break;
      default: break;
    }
  } else if (dtype == 1 && hd == 16) {
    e = FLASH_FP32(__nv_bfloat16, 16);
  } else if (dtype == 1 && hd == 32) {
    e = FLASH_FP32(__nv_bfloat16, 32);
  }
#undef FLASH_FP32
  return static_cast<int>(e);
}

// The tensor-core kernel: q, k, v and out bfloat16, hd in {64, 128, 256},
// T >= 1, 16-byte-aligned bases (TMA's rule; anything else is refused with
// cudaErrorInvalidValue: the wrapper's route sends bf16 with other head
// dims to flash_attention_launch).  Encodes the three tensor maps, then
// launches on `stream`; does not synchronise.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int BH,
                                         int S, int T_len, int hd,
                                         int groups, int causal, int window,
                                         float cap, float scale,
                                         void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || T_len < 1 || groups < 1 ||
      BH % groups ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return int(cudaErrorInvalidValue);
  tc::EncodeTiled fn;
  cudaError_t e = tc::encode_fn(&fn);
  if (e != cudaSuccess) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      e = tc::launch<64>(fn, q, k, v, out, BH, S, T_len, groups, causal,
                         window, cap, scale, s);
      break;
    case 128:
      e = tc::launch<128>(fn, q, k, v, out, BH, S, T_len, groups, causal,
                          window, cap, scale, s);
      break;
    case 256:
      e = tc::launch<256>(fn, q, k, v, out, BH, S, T_len, groups, causal,
                          window, cap, scale, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
