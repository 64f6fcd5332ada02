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
// Design (simple and exact first):
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
//
// What bounds it on the card: decode streams every visible K/V byte once
// per step for a handful of query rows, so it is bound by memory
// bandwidth; long-prompt prefill reuses each
// K/V tile across up to 32 rows and moves toward the FLOP bound.  This
// design reaches neither: the staging loop is synchronous (no cp.async or
// TMA double-buffering), scores and the V product run on the FP32 cores
// rather than the tensor cores, and decode launches only B*Kv blocks (32
// at B=8, Kv=4), leaving most of the 132 SMs idle while each block walks
// its whole sequence alone.  Left for later: split-KV (flash-decoding)
// for decode, and wgmma + TMA tiles for prefill.
//
// Plain C interface (loaded with ctypes): paged_prefill_launch returns
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
