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
// and TF32 reach) and bf16 at hd 16 and 32 run on the FP32 cores.
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
// The FP32-core kernel (simple and exact first):
//   * The Pallas grid carries (m, l, acc) across its sequential K axis in
//     VMEM; CUDA blocks run unordered.  So one block of 256 threads owns a
//     tile of kBQ = 64 query rows of one flat head and walks that head's
//     K/V itself, kBK = 32 keys at a time, from its first visible key (a
//     window starts the walk at q0 - window + 1) to its last (causal
//     stops it at the tile's last row).  Partial tiles are masked, so
//     any S and T are right.  Tiles are issued last-first, so the causal
//     grid's heaviest blocks start first.
//   * The Q tile sits in shared memory as float32 for the whole walk; K
//     and V tiles take turns in one float32 buffer (rows padded by 4
//     floats, so 16-byte reads of 8 different rows hit 32 banks).
//   * Scores: thread (ty, tx) computes rows {ty, ty+32} x keys {tx + 8j}
//     with 16-byte shared loads and FP32 FMAs; the 8 threads of a row
//     reduce its max and sum with shuffles and keep (m, l) in registers.
//   * P.V: thread (rg, dg) owns rows {rg + 16i} x dims {dg + 16c} of the
//     float32 accumulator in registers (64 values at hd 256), rescaled by
//     each tile's alpha, then summed over the tile's P (shared) and V.
//   * Shared memory: (64 + 32) x (hd + 4) + 64 x 33 + 128 floats = 106 KB
//     at hd 256 (above the 48 KB default: dynamic shared memory with the
//     opt-in), so two blocks fit on an SM.
//   It runs on the FP32 cores (67 TFLOP/s peak) with synchronous staging,
//   far above the operations bound; it stays for float32, whose bar the
//   tensor cores cannot meet.  Next step: a cp.async ring.
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

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 32;              // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;         // padded P row (floats)
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
  return to_f32(from_f32<T>(x));
}

// max / sum over the 8 lanes of a row group (lanes 8g .. 8g+7)
__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ + kBK) * (HD + 4) + size_t(kBQ) * kPS +
                          2 * kBQ);
}

// rows [row0, row0 + n_rows) of a (rows_total, HD) matrix of T into a
// float32 (n_rows, HD + 4) shared tile, zero past rows_total
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int row0, int n_rows,
                                           int rows_total, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  constexpr int kStride = HD + 4;
  for (int i = threadIdx.x; i < n_rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int d0 = (i - r * kVecPerRow) * kVec;
    float f[kVec];
    if (row0 + r < rows_total) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + size_t(row0 + r) * HD + d0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * kStride + d0);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      out[j] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2],
                           f[4 * j + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S,
                 int T_len, int groups, int causal, int window, float cap,
                 float scale) {
  constexpr int kStride = HD + 4;
  constexpr int kDims = HD / 16;     // accumulator dims per thread
  const int tile = gridDim.x - 1 - blockIdx.x;   // heaviest causal first
  const int b = blockIdx.y;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;                          // [kBQ][kStride]
  float* kv = qs + kBQ * kStride;            // [kBK][kStride], K then V
  float* ps = kv + kBK * kStride;            // [kBQ][kPS]
  float* alpha_s = ps + kBQ * kPS;           // [kBQ]
  float* l_s = alpha_s + kBQ;                // [kBQ]

  const T* qb = q + size_t(b) * S * HD;
  const T* kb = k + size_t(b / groups) * T_len * HD;
  const T* vb = v + size_t(b / groups) * T_len * HD;

  // the keys any row of this tile may see
  const int last_row = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? min(T_len, last_row + 1) : T_len;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  stage_rows<T, HD>(qb, q0, kBQ, S, qs);

  // score layout: rows {ty, ty + 32} x keys {tx + 8j}
  const int ty = tid >> 3;
  const int tx = tid & 7;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  // P.V layout: rows {rg + 16i} x dims {dg + 16c}
  const int rg = tid >> 4;
  const int dg = tid & 15;
  float acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();   // Q staged / the previous tile's V and P consumed
    stage_rows<T, HD>(kb, k0, kBK, k_hi, kv);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    const float* qr0 = qs + ty * kStride;
    const float* qr1 = qs + (ty + 32) * kStride;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(qr0 + d);
      const float4 a1 = *reinterpret_cast<const float4*>(qr1 + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kv + (tx + 8 * j) * kStride + d);
        s[0][j] = fmaf(a0.x, kk.x, s[0][j]);
        s[0][j] = fmaf(a0.y, kk.y, s[0][j]);
        s[0][j] = fmaf(a0.z, kk.z, s[0][j]);
        s[0][j] = fmaf(a0.w, kk.w, s[0][j]);
        s[1][j] = fmaf(a1.x, kk.x, s[1][j]);
        s[1][j] = fmaf(a1.y, kk.y, s[1][j]);
        s[1][j] = fmaf(a1.z, kk.z, s[1][j]);
        s[1][j] = fmaf(a1.w, kk.w, s[1][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ty + 32 * r;
      const int qpos = q0 + row;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        valid[j] = qpos < S && kpos < k_hi && (!causal || kpos <= qpos) &&
                   (!window || qpos - kpos < window);
        float x = s[r][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        s[r][j] = valid[j] ? x : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m_run[r], group8_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[r][j] - m_new) : 0.f;
        sum += p;
        ps[row * kPS + tx + 8 * j] = round_to<T>(p);
      }
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + group8_sum(sum);
      m_run[r] = m_new;
      if (tx == 0) alpha_s[row] = alpha;
    }
    __syncthreads();   // P and alpha written; K no longer read
    stage_rows<T, HD>(vb, k0, kBK, k_hi, kv);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[rg + 16 * i];
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(rg + 16 * i) * kPS + t];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const float vv = kv[t * kStride + dg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  if (tx == 0) {
    l_s[ty] = l_run[0];
    l_s[ty + 32] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg + 16 * i;
    if (q0 + row >= S) continue;
    const float l = l_s[row];
    const float denom = l == 0.f ? 1.f : l;   // fully masked -> 0
    T* dst = out + (size_t(b) * S + q0 + row) * HD;
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      dst[dg + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int S, int T_len, int groups, int causal,
                   int window, float cap, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  static bool opted_in = false;   // above 48 KB a block needs the opt-in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, groups,
      causal, window, cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int BH, int S, int T_len, int groups,
                        int causal, int window, float cap, float scale,
                        cudaStream_t stream) {
#define FLASH_LAUNCH(HD_)                                                    \
  launch<T, HD_>(q, k, v, out, BH, S, T_len, groups, causal, window, cap,   \
                 scale, stream)
  switch (hd) {
    case 16: return FLASH_LAUNCH(16);
    case 32: return FLASH_LAUNCH(32);
    case 64: return FLASH_LAUNCH(64);
    case 128: return FLASH_LAUNCH(128);
    case 256: return FLASH_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
}

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

// Element-type codes: 0 = float32, 1 = bfloat16 (q, k, v and out share
// it).  q/out are (BH, S, hd), k/v (BH / groups, T, hd), contiguous device
// tensors; window = 0 and cap = 0 switch those masks off.  bfloat16 takes
// hd 16 and 32 only (wider heads run on the tensor cores, below); any
// other call is refused with cudaErrorInvalidValue.  Launches on
// `stream`; does not synchronise.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, int BH, int S, int T_len,
                                      int hd, int groups, int causal,
                                      int window, float cap, float scale,
                                      void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || T_len < 0 || groups < 1 ||
      BH % groups)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    e = dispatch_hd<float>(hd, q, k, v, out, BH, S, T_len, groups, causal,
                           window, cap, scale, s);
  } else if (dtype == 1 && hd == 16) {
    e = launch<__nv_bfloat16, 16>(q, k, v, out, BH, S, T_len, groups, causal,
                                  window, cap, scale, s);
  } else if (dtype == 1 && hd == 32) {
    e = launch<__nv_bfloat16, 32>(q, k, v, out, BH, S, T_len, groups, causal,
                                  window, cap, scale, s);
  }
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
