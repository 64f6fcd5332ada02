// Paged attention for Hopper (sm_90a): chunked prefill and decode over a
// fused, paged K/V pool reached through a block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py::
// _prefill_kernel (the pl.pallas_call in paged_prefill_fwd), which the
// reference enters as paged_prefill_fwd for prompt chunks and as
// paged_decode_fwd (C = 1, q_start = len - 1) for decode: both its
// bf16/f32 branch and its int8 branch (quant=True, kernel.py:113-121),
// where the pool holds int8 pages and kv_scales (P, 2, Kv) float32 one
// scale per (page, K/V, kv head).
//
// What it computes, per lane b, query token c (position qpos = q_start[b]
// + c) and query head h = k*G + g (GQA is kv-major, G = H / Kv):
//     out = softmax_t(q . K[t] * scale) V[t]   over t with
//           t < lengths[b] && t <= qpos,
// where token t lives in physical page block_table[b, t / page], slot
// t % page.  Scores, the online softmax (m, l, acc) and the output
// accumulation are float32; a row with no visible token outputs 0.  On an
// int8 pool K[t] = k_int8[t] * kv_scales[page, 0, k] (V with index 1),
// the dequantization the reference does in its fetch.
//
// Two kernels, chosen by the wrapper (kernel.py::route) from q's type
// and C alone, never on a failure: the tensor-core kernel takes bf16 q
// with C > 1 (the chunk step and the speculative verify step, C =
// spec_k + 1); the FP32-core kernel takes C = 1 (decode) and every
// float32 q (whose 1e-4 bar TF32 cannot meet).
//
// The tensor-core kernel (namespace tc).  What bounds it: a prefill chunk
// reuses every K/V byte for up to C*G rows, so its bound is the bytes
// it must move, and the FP32 cores, not the memory, were its limit
// (about 7 TFLOP/s); on mma.sync the operations take a few microseconds.
//   * tiles: a block of 4 warps owns 64 rows of one lane's rows for one
//     kv head, 16 per warp (a row is one (c, g) pair; with G = 8 a tile is
//     8 tokens x 8 heads, the G heads of a token contiguous in q since GQA
//     is kv-major, h = k*G + g); it walks the visible K/V in 64-token
//     tiles (four pages at page 16), each token's row found through the
//     block table, and stops at the last token any of its rows can see;
//   * staging: a two-stage shared-memory ring filled with cp.async 16-byte
//     copies whose addresses each thread takes from the block table, one
//     lookup per thread and tile (a gather: a page's 16 rows for head k
//     are Kv*hd apart in the pool, and the pages are scattered, which is
//     what cp.async is for; a 3-D TMA map would need one box per page,
//     four per tile, and its own completion barrier for no fewer bytes);
//     tokens past the end are zero-filled, so P.V never meets garbage.
//     The q tile sits beside the ring (87 KB a block at hd 128, two
//     blocks an SM): a third stage, q kept in registers instead, or three
//     blocks an SM all measured slower on the card;
//   * products: S = q.K^T and O += P.V as mma.sync m16n8k16 (bf16, f32
//     accumulators), fed by ldmatrix (.trans for V); each warp keeps its
//     q fragments, its 16 x 64 S and its 16 x hd O in registers and reuses
//     S as P.V's A operand with no shared-memory round trip (the
//     FlashAttention-2 arrangement).  mma.sync rather than wgmma: the
//     bound is bytes, and 5.1 GFLOP at 300 TFLOP/s is 0.017 ms;
//   * softmax: online (m, l) in float32 per row, exp2 of log2-scaled
//     scores, the reference's NEG_INF and its masks (t < len, t <= qpos,
//     and the block's last visible token); a row that sees nothing
//     outputs 0.  p is rounded to bf16 for P.V while l sums it unrounded
//     (the reference multiplies float32 p by float32 v: a deliberate
//     difference, bounded in the tests, as in the flash kernel);
//   * int8 pool without dequantising in shared memory: int8 values in
//     [-127, 127] are exact in bf16, so each raw tile is converted once
//     (by a byte permute into a float's mantissa and one subtraction, not
//     the quarter-rate integer conversion);
//     the K scale of each token's page multiplies its score column after
//     q.K^T, the V scale multiplies p before p is rounded, and l sums the
//     unscaled p: q.(k*s_k) and sum p.(v*s_v) up to float32 rounding.
// Where it can go wrong: a 64-row tile holds up to 8 query tokens with 8
// causal limits, lanes end anywhere (an empty lane, aliased prefix pages),
// and tiles end at kv_end and inside pages; the masks are per element.
// Dropped tiles hide behind flat scores, so chip_smoke.py phase 3 also
// runs q scaled to scores of std 4.  What still holds it back: a long
// lane's blocks walk their tiles one after another (15 at 1,024 tokens),
// each tile a chain of ldmatrix, mma.sync and the softmax in which each
// of the 4 warps re-reads the whole K and V tile from shared memory;
// splitting a long lane's walk across blocks, or wgmma, is the next step.
//
// The FP32-core kernel (simple and exact first):
//   * one thread block of 8 warps per (tile of up to 32 query rows, kv
//     head k, lane b); a "row" is one (c, g) pair, so a block's rows all
//     read kv head k;
//   * the block's rows are spread over its warps (1..4 rows per warp),
//     each keeping its rows' (m, l, acc) in registers; the q rows sit in
//     shared memory as float32;
//   * the block walks the tokens its rows can see, kTile = 32 at a time
//     (one token per lane): all 256 threads stage that tile's K and V for
//     head k in shared memory as float32, with 16-byte loads (K rows
//     padded by one word so the lanes' column reads hit 32 different
//     banks); an int8 pool is read 16 elements per load and each row is
//     multiplied by its page's scale as it is staged, so everything after
//     the staging is the same for every pool type (the scales add 8 bytes
//     per page and kv head; an int8 row is half a bf16 row's bytes);
//     each lane scores its token against a row, the warp reduces
//     max and sum with shuffles, and the probabilities are broadcast lane
//     by lane into the V accumulation;
//   * the walk stops at the last token any of the block's rows can see,
//     min(len, page_counts*page, q_start + last row + 1), so empty lanes
//     (len = 0) and rows before any visible token cost nothing.
// What bounds it on the card: decode streams every visible K/V byte once
// per step for a handful of query rows, so it is bound by memory
// bandwidth.  This design does not reach it: the staging loop is
// synchronous, and decode launches only B*Kv blocks (32 at B=8, Kv=4),
// leaving most of the 132 SMs idle while each block walks its whole
// sequence alone.  Left for later: split-KV (flash-decoding) for decode.
//
// Plain C interface (loaded with ctypes): paged_prefill_launch (FP32
// cores) and paged_prefill_tc_launch (tensor cores) return
// cudaGetLastError() after the launch; 0 means launched.  The pool must be
// 16-byte aligned (the wrapper checks): K/V rows are read 16 bytes at a
// time, which for int8 needs hd >= 16 (every supported hd is).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kMaxWarps = 8;
constexpr int kTile = 32;            // tokens staged per tile: one per lane
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared memory a block with `rows_per_block` rows needs, in bytes.
template <int HD>
constexpr size_t smem_bytes(int rows_per_block) {
  return sizeof(float) *
         (size_t(kTile) * (HD + 1) + size_t(kTile) * HD +
          size_t(rows_per_block) * HD);
}

// TQ: q/out element type (float or bf16); TKV: pool element type (TQ, or
// int8_t with kv_scales).
template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kv,
                     const float* __restrict__ kv_scales,
                     const int* __restrict__ block_table,
                     const int* __restrict__ page_counts,
                     const int* __restrict__ lengths,
                     const int* __restrict__ q_start, TQ* __restrict__ out,
                     int C, int H, int Kv, int page, int n_pages,
                     int pool_pages, int rows_per_block, float scale) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kDimsPerLane = (HD + 31) / 32;
  constexpr int kKStride = HD + 1;   // padded K row: conflict-free columns
  constexpr int kVec = 16 / sizeof(TKV);        // elements per 16-byte load
  constexpr int kVecPerRow = HD / kVec;
  const int G = H / Kv;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = C * G;
  const int row0 = blockIdx.x * rows_per_block;
  // this warp's rows: slots [warp * rpw, warp * rpw + rpw) of the block
  const int rpw = (rows_per_block + kMaxWarps - 1) / kMaxWarps;

  extern __shared__ float smem[];
  float* ks = smem;                     // [kTile][kKStride]
  float* vs = ks + kTile * kKStride;    // [kTile][HD]
  float* qs = vs + kTile * HD;          // [rows_per_block][HD]

  const int len = lengths[b];
  const int q0 = q_start[b];
  const int npages = page_counts[b];

  for (int i = threadIdx.x; i < rows_per_block * HD; i += blockDim.x) {
    const int slot = i / HD;
    const int d = i - slot * HD;
    const int row = row0 + slot;
    float val = 0.f;
    if (row < rows) {
      const int c = row / G;
      const int h = kh * G + (row - c * G);
      val = to_f32(q[((size_t(b) * C + c) * H + h) * HD + d]);
    }
    qs[i] = val;
  }

  // the last token any row of this block may see (block-uniform)
  const int last_row = min(row0 + rows_per_block, rows) - 1;
  const int kv_end = min(min(len, npages * page), q0 + last_row / G + 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) acc[r][j] = 0.f;
  }

  const size_t page_elems = size_t(page) * Kv * HD;   // one of K or V
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();   // q staged (first tile) / previous tile consumed
    for (int i = threadIdx.x; i < kTile * kVecPerRow; i += blockDim.x) {
      const int tt = i / kVecPerRow;
      const int d0 = (i - tt * kVecPerRow) * kVec;
      const int t = t0 + tt;
      float kf[kVec], vf[kVec];
      if (t < kv_end) {
        const int lp = min(t / page, n_pages - 1);
        int phys = block_table[size_t(b) * n_pages + lp];
        phys = min(max(phys, 0), pool_pages - 1);
        const TKV* src = kv + size_t(phys) * 2 * page_elems +
                         (size_t(t - (t / page) * page) * Kv + kh) * HD + d0;
        const uint4 kraw = *reinterpret_cast<const uint4*>(src);
        const uint4 vraw = *reinterpret_cast<const uint4*>(src + page_elems);
        const TKV* kp = reinterpret_cast<const TKV*>(&kraw);
        const TKV* vp = reinterpret_cast<const TKV*>(&vraw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kf[e] = to_f32(kp[e]);
          vf[e] = to_f32(vp[e]);
        }
        if constexpr (kInt8) {
          const float ksc = kv_scales[(size_t(phys) * 2) * Kv + kh];
          const float vsc = kv_scales[(size_t(phys) * 2 + 1) * Kv + kh];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kf[e] *= ksc;
            vf[e] *= vsc;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[tt * kKStride + d0 + e] = kf[e];
        vs[tt * HD + d0 + e] = vf[e];
      }
    }
    __syncthreads();

    const int t = t0 + lane;
    const int n_tok = min(kTile, kv_end - t0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int slot = warp * rpw + r;
      const int row = row0 + slot;
      if (r >= rpw || slot >= rows_per_block || row >= rows) break;  // uniform
      const int qpos = q0 + row / G;
      const bool valid = t < kv_end && t <= qpos;   // t < kv_end <= len
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + slot * HD;
        const float* kr = ks + lane * kKStride;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) acc[r][j] *= alpha;
      for (int tt = 0; tt < n_tok; ++tt) {
        const float pt = __shfl_sync(kFull, p, tt);
#pragma unroll
        for (int j = 0; j < kDimsPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d < HD) acc[r][j] = fmaf(pt, vs[tt * HD + d], acc[r][j]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int slot = warp * rpw + r;
    const int row = row0 + slot;
    if (r >= rpw || slot >= rows_per_block || row >= rows) break;
    const int c = row / G;
    const int h = kh * G + (row - c * G);
    const float denom = l[r] == 0.f ? 1.f : l[r];   // fully masked -> 0
    TQ* dst = out + ((size_t(b) * C + c) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < HD) dst[d] = from_f32<TQ>(acc[r][j] / denom);
    }
  }
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const void* q, const void* kv, const float* kv_scales,
                   const int* block_table, const int* page_counts,
                   const int* lengths, const int* q_start, void* out, int B,
                   int C, int H, int Kv, int page, int n_pages,
                   int pool_pages, float scale, cudaStream_t stream) {
  const int rows = C * (H / Kv);
  const int rows_per_block =
      rows < kMaxWarps * kRowsPerWarp ? rows : kMaxWarps * kRowsPerWarp;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, Kv, B);
  const size_t smem = smem_bytes<HD>(rows_per_block);
  auto kernel = paged_prefill_kernel<TQ, TKV, HD>;
  // above 48 KB a block needs the opt-in; set it once per instantiation
  // to the most any launch of it asks for
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_bytes<HD>(kMaxWarps * kRowsPerWarp)));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<grid, kMaxWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kv), kv_scales,
      block_table, page_counts, lengths, q_start, static_cast<TQ*>(out), C,
      H, Kv, page, n_pages, pool_pages, rows_per_block, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* kv,
                        const float* kv_scales, const int* block_table,
                        const int* page_counts, const int* lengths,
                        const int* q_start, void* out, int B, int C, int H,
                        int Kv, int page, int n_pages, int pool_pages,
                        float scale, cudaStream_t stream) {
#define PAGED_LAUNCH(HD_)                                                   \
  launch<TQ, TKV, HD_>(q, kv, kv_scales, block_table, page_counts, lengths, \
                       q_start, out, B, C, H, Kv, page, n_pages, pool_pages, \
                       scale, stream)
  switch (hd) {
    case 16: return PAGED_LAUNCH(16);
    case 32: return PAGED_LAUNCH(32);
    case 64: return PAGED_LAUNCH(64);
    case 128: return PAGED_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_LAUNCH
}

// ---------------------------------------------- tensor-core prefill --
// q bf16, C > 1 (the chunk step and the speculative verify step), on a
// bf16 or an int8 pool; see the design note at the top of the file.
namespace tc {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;   // query rows per block
constexpr int kTok = 64;             // tokens per K/V tile
constexpr int kPad = 8;              // bf16 row padding: 16 bytes, so the
                                     // ldmatrix rows hit distinct banks

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 values (one word, little-endian) -> four exact bf16 values in
// two words, without the quarter-rate integer-to-float conversion:
// flipping a byte's sign bit gives x + 128 as an unsigned byte; placed in
// the low mantissa of 2^23 it reads as the float 2^23 + 128 + x, and
// subtracting 2^23 + 128 leaves x exactly.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;             // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443));
  lo = pack_bf16(f0 - kMagic, f1 - kMagic);
  hi = pack_bf16(f2 - kMagic, f3 - kMagic);
}

// Shared memory of one block, in bytes: the q tile, two stages of K and V
// (bf16 pool: bf16 tiles; int8 pool: raw int8 tiles, plus one bf16 K and
// V pair they are converted into, plus each stage's per-token scales).
template <typename TKV, int HD>
struct Smem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kLd = HD + kPad;               // bf16 row (elements)
  static constexpr int kBf16Tile = kTok * kLd * 2;    // one K or V tile
  static constexpr int kQ = kRows * kLd * 2;
  static constexpr int kRawTile = kTok * HD;          // int8 K or V tile
  static constexpr int kStage = kInt8 ? 2 * kRawTile + 2 * kTok * 4
                                      : 2 * kBf16Tile;
  static constexpr int kBytes = kQ + 2 * kStage + (kInt8 ? 2 * kBf16Tile : 0);
};

template <typename TKV, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_prefill_tc_kernel(const bf16* __restrict__ q, const TKV* __restrict__ kv,
                        const float* __restrict__ kv_scales,
                        const int* __restrict__ block_table,
                        const int* __restrict__ page_counts,
                        const int* __restrict__ lengths,
                        const int* __restrict__ q_start,
                        bf16* __restrict__ out, int C, int H, int Kv,
                        int page, int n_pages, int pool_pages,
                        float scale_log2) {
  using S = Smem<TKV, HD>;
  constexpr bool kInt8 = S::kInt8;
  constexpr int kLd = S::kLd;
  constexpr int kChunks = HD * int(sizeof(TKV)) / 16;   // per K/V row
  constexpr int kQChunks = HD / 8;                      // per q row
  const int G = H / Kv;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int rows = C * G;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lengths[b], q0 = q_start[b], npages = page_counts[b];
  // the last token any row of this block may see (block-uniform)
  const int last_row = min(row0 + kRows, rows) - 1;
  const int kv_end = min(min(len, npages * page), q0 + last_row / G + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + kTok - 1) / kTok : 0;

  extern __shared__ __align__(128) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  uint8_t* stages = smem + S::kQ;
  // the bf16 K and V tiles compute reads: stage st's own (bf16 pool) or
  // the one pair each int8 stage is converted into
  auto k_tile = [&](int st) {
    return reinterpret_cast<bf16*>(kInt8 ? stages + 2 * S::kStage
                                         : stages + st * S::kStage);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<bf16*>(
        kInt8 ? stages + 2 * S::kStage + S::kBf16Tile
              : stages + st * S::kStage + S::kBf16Tile);
  };
  auto k_scale = [&](int st) {     // int8: [kTok] K scales, then V's
    return reinterpret_cast<float*>(stages + st * S::kStage +
                                    2 * S::kRawTile);
  };

  // q rows (row = c*G + g reads head kh*G + g of token c), zero past rows
  for (int i = threadIdx.x; i < kRows * kQChunks; i += blockDim.x) {
    const int r = i / kQChunks, ch = i - r * kQChunks;
    const int row = row0 + r;
    const bf16* src = q;
    int bytes = 0;
    if (row < rows) {
      const int c = row / G;
      src = q + ((size_t(b) * C + c) * H + kh * G + (row - c * G)) * HD +
            ch * 8;
      bytes = 16;
    }
    cp_async16(qs + r * kLd + ch * 8, src, bytes);
  }

  // tile `it` of the visible tokens into stage st.  Thread i stages token
  // i % kTok of the tile: one block-table lookup gives its page, and the
  // thread copies its share of the token's K and V rows of head kh (16
  // bytes a copy) and, on an int8 pool, one of its page's two scales;
  // zeros past kv_end
  constexpr int kParts = kWarps * 32 / kTok;             // threads a token
  constexpr int kPer = (kChunks + kParts - 1) / kParts;  // copies a row
  static_assert(kParts == 2, "a token's two threads copy its two scales");
  const size_t page_elems = size_t(page) * Kv * HD;      // one of K or V
  auto load_tile = [&](int it, int st) {
    const int tt = threadIdx.x % kTok, part = threadIdx.x / kTok;
    const int t = it * kTok + tt;
    const bool valid = t < kv_end;
    const int bytes = valid ? 16 : 0;
    const TKV* row = kv;                                 // token t's K row
    int phys = 0;
    if (valid) {
      const int lp = t / page;
      phys = block_table[size_t(b) * n_pages + min(lp, n_pages - 1)];
      phys = min(max(phys, 0), pool_pages - 1);
      row = kv + size_t(phys) * 2 * page_elems +
            (size_t(t - lp * page) * Kv + kh) * HD;
    }
    uint8_t* base = stages + st * S::kStage;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int ch = part * kPer + j;
      if (ch >= kChunks) break;
#pragma unroll
      for (int sel = 0; sel < 2; ++sel) {                // K, then V
        const TKV* src =
            valid ? row + sel * page_elems + ch * (16 / int(sizeof(TKV)))
                  : kv;
        void* dst =
            kInt8 ? static_cast<void*>(base + sel * S::kRawTile + tt * HD +
                                       ch * 16)
                  : static_cast<void*>(
                        reinterpret_cast<bf16*>(base + sel * S::kBf16Tile) +
                        tt * kLd + ch * 8);
        cp_async16(dst, src, bytes);
      }
    }
    if constexpr (kInt8) {   // part 0: the K scale of t's page; part 1: V's
      cp_async4(k_scale(st) + part * kTok + tt,
                valid ? kv_scales + (size_t(phys) * 2 + part) * Kv + kh
                      : kv_scales,
                valid ? 4 : 0);
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();              // group 0: q and tile 0

  // this thread's two rows of its warp's 16: lane/4 and lane/4 + 8
  const int ra = row0 + warp * 16 + lane / 4, rb = ra + 8;
  const int qpos_a = q0 + ra / G, qpos_b = q0 + rb / G;
  const bool warp_live = warp * 16 < rows - row0;   // any real row
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[HD / 16][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kInt8) {
      // int8 values in [-127, 127] are exact in bf16: convert once
      const uint8_t* raw = stages + st * S::kStage;
      for (int i = threadIdx.x; i < 2 * kTok * (HD / 16);
           i += blockDim.x) {
        const int sel = i / (kTok * (HD / 16));
        const int rem = i - sel * kTok * (HD / 16);
        const int tt = rem / (HD / 16), ch = rem - tt * (HD / 16);
        const uint4 v = *reinterpret_cast<const uint4*>(
            raw + sel * S::kRawTile + tt * HD + ch * 16);
        uint32_t w[8];
        int8x4_to_bf16(v.x, w[0], w[1]);
        int8x4_to_bf16(v.y, w[2], w[3]);
        int8x4_to_bf16(v.z, w[4], w[5]);
        int8x4_to_bf16(v.w, w[6], w[7]);
        bf16* dst = (sel ? v_tile(st) : k_tile(st)) + tt * kLd + ch * 16;
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
    }
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldmatrix_x4(qf[ks], qs + (warp * 16 + (lane % 8) +
                                  ((lane / 8) % 2) * 8) * kLd +
                                ks * 16 + (lane / 16) * 8);
    }
    if (warp_live) {
      const bf16* ks_t = k_tile(st);
      const bf16* vs_t = v_tile(st);
      // S = q . K^T for 64 tokens: 8 n-tiles of 8 tokens
      float s[kTok / 8][4];
#pragma unroll
      for (int j = 0; j < kTok / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int jp = 0; jp < kTok / 16; ++jp) {
          uint32_t kb[4];   // tokens 16jp..+7 and +8..+15, dims lo / hi
          ldmatrix_x4(kb, ks_t + (16 * jp + (lane / 16) * 8 + lane % 8) * kLd +
                              ks * 16 + ((lane / 8) % 2) * 8);
          mma_16816(s[2 * jp], qf[ks], kb[0], kb[1]);
          mma_16816(s[2 * jp + 1], qf[ks], kb[2], kb[3]);
        }
      }
      // scale (and the int8 K scale of each token's page), mask, max
      const int t0 = it * kTok;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kTok / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = 8 * j + 2 * (lane % 4) + (e & 1);
          const int t = t0 + tt;
          const bool valid = t < kv_end && t <= (e < 2 ? qpos_a : qpos_b);
          float x = s[j][e] * scale_log2;
          if constexpr (kInt8) x *= k_scale(st)[tt];
          s[j][e] = valid ? x : kNegInf;
          if (e < 2) mx_a = fmaxf(mx_a, s[j][e]);
          else mx_b = fmaxf(mx_b, s[j][e]);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][0] *= al_a;
        o[j][1] *= al_a;
        o[j][2] *= al_b;
        o[j][3] *= al_b;
      }
      // p = exp(s - m) on visible tokens, 0 elsewhere; l sums p as is, the
      // P.V operand is p (times the int8 V scale) rounded to bf16
      uint32_t pa[kTok / 16][4];
#pragma unroll
      for (int j = 0; j < kTok / 8; ++j) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = 8 * j + 2 * (lane % 4) + (e & 1);
          const float p = s[j][e] == kNegInf
                              ? 0.f
                              : exp2f(s[j][e] - (e < 2 ? m_a : m_b));
          if (e < 2) l_a += p;
          else l_b += p;
          pv[e] = p;
          if constexpr (kInt8) pv[e] *= k_scale(st)[kTok + tt];
        }
        // n-tile j is half of the A operand of k-step j/2
        pa[j / 2][(j % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
      // O += P . V: V tiles read transposed (k = token, n = dim)
#pragma unroll
      for (int kt = 0; kt < kTok / 16; ++kt) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];   // tokens lo / hi of dims 16dp..+7, then +8..+15
          ldmatrix_x4_trans(vb, vs_t + (16 * kt + lane % 8 +
                                        ((lane / 8) % 2) * 8) * kLd +
                                    16 * dp + (lane / 16) * 8);
          mma_16816(o[2 * dp], pa[kt], vb[0], vb[1]);
          mma_16816(o[2 * dp + 1], pa[kt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();  // an empty lane's q copies are still in flight
  __syncthreads();     // and every warp is done with the last tile

  if (!warp_live) return;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, o_);
    l_b += __shfl_xor_sync(kFull, l_b, o_);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);   // fully masked -> 0
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  // stage the warp's 16 output rows in its own rows of the q tile, then
  // write them with 16-byte stores
  bf16* os = qs + warp * 16 * kLd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(os + (lane / 4) * kLd + d) =
        pack_bf16(o[j][0] * inv_a, o[j][1] * inv_a);
    *reinterpret_cast<uint32_t*>(os + (lane / 4 + 8) * kLd + d) =
        pack_bf16(o[j][2] * inv_b, o[j][3] * inv_b);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kQChunks; i += 32) {
    const int r = i / kQChunks, ch = i - r * kQChunks;
    const int row = row0 + warp * 16 + r;
    if (row >= rows) continue;
    const int c = row / G;
    *reinterpret_cast<uint4*>(
        out + ((size_t(b) * C + c) * H + kh * G + (row - c * G)) * HD +
        ch * 8) = *reinterpret_cast<const uint4*>(os + r * kLd + ch * 8);
  }
}

template <typename TKV, int HD>
cudaError_t launch(const void* q, const void* kv, const float* kv_scales,
                   const int* block_table, const int* page_counts,
                   const int* lengths, const int* q_start, void* out, int B,
                   int C, int H, int Kv, int page, int n_pages,
                   int pool_pages, float scale, cudaStream_t stream) {
  const int rows = C * (H / Kv);
  const dim3 grid((rows + kRows - 1) / kRows, Kv, B);
  auto kernel = paged_prefill_tc_kernel<TKV, HD>;
  constexpr int smem = Smem<TKV, HD>::kBytes;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TKV*>(kv), kv_scales,
      block_table, page_counts, lengths, q_start, static_cast<bf16*>(out), C,
      H, Kv, page, n_pages, pool_pages, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* kv,
                        const float* kv_scales, const int* block_table,
                        const int* page_counts, const int* lengths,
                        const int* q_start, void* out, int B, int C, int H,
                        int Kv, int page, int n_pages, int pool_pages,
                        float scale, cudaStream_t stream) {
#define TC_LAUNCH(HD_)                                                      \
  launch<TKV, HD_>(q, kv, kv_scales, block_table, page_counts, lengths,     \
                   q_start, out, B, C, H, Kv, page, n_pages, pool_pages,    \
                   scale, stream)
  switch (hd) {
    case 16: return TC_LAUNCH(16);
    case 32: return TC_LAUNCH(32);
    case 64: return TC_LAUNCH(64);
    case 128: return TC_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef TC_LAUNCH
}

}  // namespace tc

}  // namespace

// Element-type codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only).
// q_dtype is 0 or 1; kv_dtype equals q_dtype, or is 2 with kv_scales a
// (pool_pages, 2, Kv) float32 device pointer (null otherwise).  Pointers
// are device pointers of contiguous tensors: q/out (B,C,H,hd), kv
// (pool_pages,2,page,Kv,hd), block_table (B,n_pages) int32 repeat-padded,
// page_counts/lengths/q_start (B,) int32.  Launches on `stream`; does not
// synchronise.
extern "C" int paged_prefill_launch(int q_dtype, int kv_dtype, const void* q,
                                    const void* kv, const void* kv_scales,
                                    const void* block_table,
                                    const void* page_counts,
                                    const void* lengths, const void* q_start,
                                    void* out, int B, int C, int H, int Kv,
                                    int hd, int page, int n_pages,
                                    int pool_pages, float scale,
                                    void* stream) {
  const float* sc = static_cast<const float*>(kv_scales);
  const int* bt = static_cast<const int*>(block_table);
  const int* cnt = static_cast<const int*>(page_counts);
  const int* len = static_cast<const int*>(lengths);
  const int* qs = static_cast<const int*>(q_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8_pool = kv_dtype == 2;
  if (int8_pool != (sc != nullptr)) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) {
    e = dispatch_hd<float, float>(hd, q, kv, sc, bt, cnt, len, qs, out, B, C,
                                  H, Kv, page, n_pages, pool_pages, scale, s);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    e = dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, q, kv, sc, bt, cnt, len, qs, out, B, C, H, Kv, page, n_pages,
        pool_pages, scale, s);
  } else if (q_dtype == 0 && int8_pool) {
    e = dispatch_hd<float, int8_t>(hd, q, kv, sc, bt, cnt, len, qs, out, B,
                                   C, H, Kv, page, n_pages, pool_pages,
                                   scale, s);
  } else if (q_dtype == 1 && int8_pool) {
    e = dispatch_hd<__nv_bfloat16, int8_t>(hd, q, kv, sc, bt, cnt, len, qs,
                                           out, B, C, H, Kv, page, n_pages,
                                           pool_pages, scale, s);
  }
  return static_cast<int>(e);
}

// The tensor-core kernel: q/out bfloat16 (B,C,H,hd), kv_dtype 1 (a
// bfloat16 pool) or 2 (an int8 pool with kv_scales); the other arguments
// as paged_prefill_launch's.  The wrapper's route sends bf16 q with C > 1
// here; it computes any C.
extern "C" int paged_prefill_tc_launch(int kv_dtype, const void* q,
                                       const void* kv, const void* kv_scales,
                                       const void* block_table,
                                       const void* page_counts,
                                       const void* lengths,
                                       const void* q_start, void* out, int B,
                                       int C, int H, int Kv, int hd, int page,
                                       int n_pages, int pool_pages,
                                       float scale, void* stream) {
  const float* sc = static_cast<const float*>(kv_scales);
  const bool int8_pool = kv_dtype == 2;
  if ((kv_dtype != 1 && !int8_pool) || int8_pool != (sc != nullptr))
    return int(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* cnt = static_cast<const int*>(page_counts);
  const int* len = static_cast<const int*>(lengths);
  const int* qs = static_cast<const int*>(q_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      int8_pool
          ? tc::dispatch_hd<int8_t>(hd, q, kv, sc, bt, cnt, len, qs, out, B,
                                    C, H, Kv, page, n_pages, pool_pages,
                                    scale, s)
          : tc::dispatch_hd<__nv_bfloat16>(hd, q, kv, sc, bt, cnt, len, qs,
                                           out, B, C, H, Kv, page, n_pages,
                                           pool_pages, scale, s);
  return static_cast<int>(e);
}
