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
// Design (simple and exact first):
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
//
// What bounds it on the card: attention at S = 4096 reuses every K/V
// tile across 64 query rows, so it is bound by operations (4 hd per
// visible (query, key) pair); the tensor cores' bound is ~989 TFLOP/s in
// bf16.  This design runs on the FP32 cores (67 TFLOP/s peak) with
// synchronous staging and no overlap of loads with math, so it sits far
// above that bound.  Left for later: wgmma on TMA-fed K/V tiles with a
// cp.async/TMA ring and warp-specialised producers.
//
// Plain C interface (loaded with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch; 0 means launched.  q/k/v must be
// 16-byte aligned and contiguous (the wrapper checks): rows are read 16
// bytes at a time, which needs hd * element size to be a multiple of 16
// (every supported hd is).

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

}  // namespace

// Element-type codes: 0 = float32, 1 = bfloat16 (q, k, v and out share
// it).  q/out are (BH, S, hd), k/v (BH / groups, T, hd), contiguous device
// tensors; window = 0 and cap = 0 switch those masks off.  Launches on
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
  } else if (dtype == 1) {
    e = dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, BH, S, T_len, groups,
                                   causal, window, cap, scale, s);
  }
  return static_cast<int>(e);
}
