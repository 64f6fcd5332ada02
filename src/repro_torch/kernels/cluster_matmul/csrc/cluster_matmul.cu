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
// Design (simple and exact first).  One thread block of 256 threads owns
// a 128 x 128 tile of C and walks K in steps; each step stages the A and
// B tiles in shared memory (the scratchpad), zero-filled past the edges of
// the matrices, so every shape is right whatever it is (the wrapper's
// shape contract, tiles of min(128, dim) dividing each dim, is not needed
// here).  The Pallas grid's sequential K dimension, which carries the sum
// in VMEM scratch, becomes the loop inside the block; the sum stays in
// registers.
//   * float32: 16 K per step; each thread keeps an 8 x 8 block of C in
//     registers (rows ty*4+{0..3} and 64+ty*4+{0..3}, columns likewise
//     from tx, so its shared-memory reads are 16-byte and conflict-free)
//     and accumulates with true FP32 FMAs (no TF32: the reference is a
//     float32 jnp.dot).
//   * bfloat16: 32 K per step on the tensor cores through WMMA
//     (mma.sync, 16 x 16 x 16 bf16 fragments, float32 accumulators in
//     registers); 8 warps as 2 x 4, each owning 64 x 32 of C.  The
//     epilogue stages each 16 x 16 fragment through shared memory to
//     round and bounds-check it.
//
// What bounds it on the card: at the shapes the offload path and a model
// MLP meet (768^3 to 4096^3, 1024 x 4096 x 11008) the product does
// 2mnk operations on (mk + kn + mn) elements, far above the card's ridge
// point, so it is bound by operations: 67 TFLOP/s of FP32 cores for
// float32, 989 TFLOP/s of tensor cores for bfloat16.  This design reaches
// neither: staging is synchronous (no cp.async or TMA double-buffering,
// two barriers per K step) and global loads are scalar; bf16 uses
// mma.sync, not Hopper's wgmma.  Left for later: a TMA-fed, wgmma,
// warp-specialized pipeline.
//
// Plain C interface (loaded with ctypes): cluster_matmul_launch returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;             // rows of C per block
constexpr int kBN = 128;             // columns of C per block

// ---------------------------------------------------------------- f32 --
constexpr int kBK32 = 16;            // K per step
constexpr int kPadA = 4;             // As row padding: 2-way, not 16-way,
                                     // conflicts on the transposed store

__global__ void __launch_bounds__(kThreads)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K) {
  // A tile stored transposed, As[k][m], so a thread's 8 rows at one k are
  // two 16-byte reads
  __shared__ __align__(16) float As[kBK32][kBM + kPadA];
  __shared__ __align__(16) float Bs[kBK32][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK32) {
#pragma unroll
    for (int i = 0; i < kBM * kBK32 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK32, c = e % kBK32;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK32 * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

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

// dtype: 0 = float32, 1 = bfloat16 (A, B and C alike).
extern "C" int cluster_matmul_launch(int dtype, const void* a, const void* b,
                                     void* c, int m, int n, int k,
                                     void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return int(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    matmul_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), m, n, k);
  } else if (dtype == 1) {
    matmul_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(c), m, n, k);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
