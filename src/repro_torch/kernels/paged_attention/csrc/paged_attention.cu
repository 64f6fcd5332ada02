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
// Three kernels, chosen by the wrapper (kernel.py::route) from q's type
// and C alone, never on a failure: the split-KV kernel takes C = 1
// (decode) with either q type (its bf16-q branch on the tensor cores);
// the tensor-core kernel takes bf16 q with C > 1 (the chunk step and the
// speculative verify step, C = spec_k + 1); the FP32-core kernel takes
// float32 q with C > 1 (whose 1e-4 bar TF32 cannot meet), and only that
// is compiled of it.
//
// The split-KV decode kernel (namespace split; flash-decoding).  What
// bounds it: decode streams every visible K/V byte once per step for G
// query rows per kv head, so its bound is bytes (~1.5 us at phase 3's
// 5 MB); what held the FP32-core kernel at ~1% of it was latency, B*Kv
// = 32 blocks each walking a whole lane (up to 1,024 tokens) alone.
//   * grid (kv head x head chunk, lane, split): a split is a fixed span
//     of tokens of one lane, 128 for bf16 q and 32 for float32 q; the
//     host sizes the grid from block_table.shape[1] * page, known without
//     a sync, and a block past its lane's last visible token exits at
//     once, so a lane of 1,024 tokens spreads over 8 blocks (bf16 q);
//   * each thread reads its token's block-table entry through the lane's
//     own row (aliased prefix pages are found as mapped) while the lane's
//     lengths are still in flight, then stages the token's K and V rows of
//     its kv head with cp.async, zeros past the end;
//   * bf16 q: a block takes up to 16 query heads of its kv head as the 16
//     rows of mma.sync m16n8k16 (as the tc kernel), each of its 8 warps
//     scores and accumulates 16 of the span's tokens (S kept in
//     registers as P.V's A operand), and the warps' row maxima, sums and
//     partial outputs meet in shared memory; p (times the int8 V scale)
//     is rounded to bf16 for P.V while l sums it unrounded;
//   * float32 q (its 1e-4 bar): a block takes up to 8 heads, one per warp,
//     on the FP32 cores: lanes score tokens, warp max and sum by shuffles,
//     P.V with p read back from shared memory four tokens at a time;
//   * int8 pages multiply the score by their K scale and p by their V
//     scale; l sums p unscaled;
//   * one launch per call: a block writes its partial (m, l, acc) in
//     float32 to scratch, and the last live split of each (lane, kv head)
//     to finish, found by __threadfence() and an atomic ticket that it
//     puts back to 0, combines them by log-sum-exp; a lane with a single
//     live split writes its output directly.  Empty splits weigh 0 and a
//     lane with nothing visible writes 0, never NaN.
//   What still holds it back (A/B calls with parts of it switched off): a
//   chain of three dependent memory round trips (lengths and table, then
//   K/V, then the partials through the ticket) and the combiner's pass;
//   the FP32 branch's compute.  Next step: CUDA graphs over the decode
//   step (the iteration is launch-bound on the host).
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
// The FP32-core kernel (namespace f32; float32 q, C > 1: the float32
// engine's chunk and verify steps).  What bounds it: a chunk does 4 hd
// operations per visible (query, key) pair, and its 1e-4 bar keeps them
// on the FP32 cores (67 TFLOP/s, no TF32), so it is bound by operations
// (0.076 ms at phase 3's C = 128).  The first kernel reached 10% of that:
// each lane scored one token against one row, so every K value read from
// shared memory fed 4 FMAs, and its staging waited on synchronous loads
// at a barrier per 32-token tile.  This design register-tiles both
// products, as a float32 GEMM does:
//   * a block of 256 threads (a 16 x 16 grid) takes one lane b, one kv
//     head k and 64 rows of the chunk's (c, g) grid (a row is one (c, g)
//     pair, head k*G + g of token c); grid (rows / 64, Kv, B);
//   * q's 64 rows are staged once; K/V tiles of 64 tokens go through a
//     two-stage cp.async ring (tile t+1 is copied while tile t is
//     computed), each 16-byte copy finding its token's page through the
//     lane's block-table row (aliased prefix pages are found as mapped),
//     zero-filled past the block's last visible token.  K and q rows keep
//     d contiguous and carry a 16-byte pad, so a quarter-warp's 16-byte
//     reads of 8 rows hit 8 bank groups;
//   * S = q.K^T: each thread computes 4 rows x 4 tokens (rows ty + 16i,
//     tokens tx + 16j), reading q and K 16 bytes along d at a time: 8
//     float4 reads feed 64 FMAs, against 4 FMAs per read before;
//   * the online softmax runs per row across the row's 16 threads (one
//     half-warp) with shuffles: scores in log2 units, exp2, the
//     reference's NEG_INF; the causal and length masks are applied only on
//     tiles that cross the limit of some row of the block; p goes to
//     shared memory (rows of 80 floats) and l sums it;
//   * O += P.V: each thread accumulates 4 rows x hd/16 dims, p read 4
//     tokens at a time, V 16 bytes at a time (at hd 128, 12 reads feed 128
//     FMAs); (m, l, acc) stay in registers for the whole walk;
//   * an int8 pool's stage holds the raw int8 K and V and each token's
//     two page scales (cp.async too); a pass then dequantizes it into one
//     float32 K/V pair, int8 value times scale, before any product, as
//     the reference's fetch does (optim/compress.py's
//     dequantize-then-attend), so the products are the float32 pool's;
//   * the walk stops at the last token any of the block's rows can see,
//     min(len, page_counts*page, q_start + last row + 1), so empty lanes
//     and rows before any visible token cost nothing; a row that saw
//     nothing writes 0, never NaN.
// Shared memory at hd 128: q 33 KB, P 20 KB, two float32 K/V stages 130
// KB (an int8 pool: two raw stages 33 KB and one float32 pair 65 KB);
// one block an SM.  What still holds it back (PERF.md §6, variants of
// this source timed by scripts/ab_kernel_variants.py): a tile takes ~9 us
// at hd 128, about half the FMA rate of one SM; the two products take
// three quarters of the call, the copies a tenth.  A 4 x 4 tile a thread
// issues 8 16-byte shared reads per 64 FMAs (S) and 12 per 128 (P.V);
// 8 or 2 rows a thread (128 or 512 threads) measured slower, as did
// starting the lanes interleaved.  And the longest lane's blocks walk
// their 16 tiles one after another (0.14 ms at C = 5, where 28 blocks
// run).  Next step: split a long lane's walk over blocks, combined as
// split-KV decode does.
//
// Plain C interface (loaded with ctypes): paged_prefill_launch (FP32
// cores), paged_prefill_tc_launch (tensor cores) and
// paged_decode_split_launch (split-KV) return
// cudaGetLastError() after the launch; 0 means launched.  The pool must be
// 16-byte aligned (the wrapper checks): K/V rows are read 16 bytes at a
// time, which for int8 needs hd >= 16 (every supported hd is).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// ------------------------------------------------- split-KV decode --
// C = 1 (decode) with q float32 or bf16 on a pool in q's type or int8;
// see the design note at the top of the file.
namespace split {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 32;            // tokens per split (float32 q): a lane
                                     // each
constexpr int kHeads = kWarps;       // query heads per block, one per warp

// Shared memory of one block: a split's K and V rows in the pool's type,
// each row padded by 16 bytes (16-byte reads of 8 consecutive rows then
// hit distinct banks), the block's q rows as float32, and each warp's p.
template <typename TKV, int HD>
struct Smem {
  static constexpr int kRowBytes = HD * int(sizeof(TKV)) + 16;
  static constexpr int kTile = kSpan * kRowBytes;
  static constexpr int kBytes = 2 * kTile + kHeads * HD * 4 +
                                kWarps * kSpan * 4;
};

// N consecutive elements of a shared-memory row (N * sizeof(T) bytes,
// aligned to that) in one load, as float32
template <typename T, int N>
__device__ __forceinline__ void load_dims(const T* p, float (&f)[N]) {
  constexpr int kBytes = N * int(sizeof(T));
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using W = std::conditional_t<kBytes == 16, uint4,
                                 std::conditional_t<kBytes == 8, uint2,
                                                    uint32_t>>;
    const W raw = *reinterpret_cast<const W*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(p[i]);
  }
}

// N consecutive floats another block wrote, past L1 (__ldcg)
template <int N>
__device__ __forceinline__ void ldcg_dims(const float* p, float (&f)[N]) {
  if constexpr (N == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    f[0] = v.x; f[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __ldcg(p + i);
  }
}

// Whether this block is the last of its lane's n_live live splits (for
// its kv head) to finish: its ticket is taken after its partials are
// visible device-wide, and the last block puts the counter back to 0 for
// the next launch.  Every thread of the block calls it.
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

// One warp combines one query head's partials, slots slot0 .. slot0 +
// n_live - 1 ((m, l) pairs in part_ml, hd floats each in part_acc), into
// its output row dst_head.
template <typename TQ, int HD>
__device__ __forceinline__ void combine_head(const float* part_ml,
                                             const float* part_acc,
                                             size_t slot0, int n_live,
                                             TQ* dst_head, int lane) {
  constexpr int kDims = (HD + 31) / 32;
  const int d0 = lane * kDims;
  const bool dims_live = d0 < HD;
  // log-sum-exp combine: m = max m_i, l = sum l_i e^(m_i - m), acc = sum
  // acc_i e^(m_i - m).  A split that saw nothing (m_i = NEG_INF, l_i = 0,
  // acc_i = 0) weighs 0, or 1 times zeros if all did: the output is 0,
  // never NaN.  Each lane reads every split's (m, l) and its own dims of
  // every acc_i, all loads independent of each other.  Partials are read
  // past L1 (__ldcg): other SMs wrote them.
  float mx = kNegInf;
  for (int i = lane; i < n_live; i += 32)
    mx = fmaxf(mx, __ldcg(part_ml + 2 * (slot0 + i)));
  mx = warp_max(mx);
  float lsum = 0.f, o[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) o[e] = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_live; ++i) {
    const float2 mli = __ldcg(reinterpret_cast<const float2*>(
        part_ml + 2 * (slot0 + i)));
    float a[kDims];
    if (dims_live) ldcg_dims<kDims>(part_acc + (slot0 + i) * HD + d0, a);
    const float w = expf(mli.x - mx);
    lsum = fmaf(mli.y, w, lsum);
    if (dims_live) {
#pragma unroll
      for (int e = 0; e < kDims; ++e) o[e] = fmaf(a[e], w, o[e]);
    }
  }
  if (dims_live) {
    const float denom = lsum == 0.f ? 1.f : lsum;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      dst_head[d0 + e] = from_f32<TQ>(o[e] / denom);
  }
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const TQ* __restrict__ q,
                          const TKV* __restrict__ kv,
                          const float* __restrict__ kv_scales,
                          const int* __restrict__ block_table,
                          const int* __restrict__ page_counts,
                          const int* __restrict__ lengths,
                          const int* __restrict__ q_start,
                          TQ* __restrict__ out, float* __restrict__ part_ml,
                          float* __restrict__ part_acc,
                          int* __restrict__ tickets, int H, int Kv, int page,
                          int n_pages, int pool_pages, float scale) {
  using S = Smem<TKV, HD>;
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kVec = 16 / int(sizeof(TKV));     // elements a 16-byte copy
  constexpr int kChunks = HD / kVec;              // copies a row
  constexpr int kDims = (HD + 31) / 32;           // dims a lane accumulates:
  static_assert(HD % kDims == 0, "whole lanes");  // d0 .. d0 + kDims - 1
  constexpr int kQPer = (kHeads * HD + kThreads - 1) / kThreads;
  // grid (kv head x head chunk, lane, split): the split is the slowest
  // index, so the blocks of low splits, live in every non-empty lane,
  // spread over the SMs before the mostly dead high ones
  const int split = blockIdx.z, n_splits = gridDim.z;
  const int G = H / Kv;
  const int chunks = (G + kHeads - 1) / kHeads;
  const int kh = blockIdx.x / chunks;
  const int g0 = (blockIdx.x - kh * chunks) * kHeads;
  const int nh = min(kHeads, G - g0);             // heads of this block
  const int h0 = kh * G + g0;                     // its first query head
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * kDims;                    // the lane's first dim
  const bool dims_live = d0 < HD;                 // hd 16: half the lanes
  // warp w takes head h0 + w; a warp past nh only helps stage
  const bool head_live = warp < nh;
  const int t0 = split * kSpan;
  // every load that does not wait on another goes out first: the lane's
  // lengths, the block-table entries of this thread's tokens (the table
  // is repeat-padded, so any column below n_pages is a page of the pool)
  // and the block's q rows
  const int t = t0 + lane;                        // this lane's token
  const int phys = min(
      max(block_table[size_t(b) * n_pages + min(t / page, n_pages - 1)], 0),
      pool_pages - 1);
  float qv[kQPer];
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    qv[k] = i < nh * HD ? to_f32(q[(size_t(b) * H + h0) * HD + i]) : 0.f;
  }
  // the lane's visible tokens: t < len, t < page_counts * page, t <= qpos
  const int kv_end = min(min(lengths[b], page_counts[b] * page),
                         q_start[b] + 1);
  const int n_live = kv_end > 0 ? (kv_end + kSpan - 1) / kSpan : 0;
  TQ* dst = out + (size_t(b) * H + h0) * HD;      // (B, 1, H, hd)

  if (n_live == 0) {   // nothing visible (an empty lane): 0, from split 0
    if (split == 0)
      for (int i = threadIdx.x; i < nh * HD; i += kThreads)
        dst[i] = from_f32<TQ>(0.f);
    return;
  }
  if (split >= n_live) return;                    // past the lane's end

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ks = smem;
  uint8_t* vs = smem + S::kTile;
  float* qs = reinterpret_cast<float*>(smem + 2 * S::kTile);
  float* ps = qs + kHeads * HD + warp * kSpan;    // this warp's p
  __shared__ int last;

  // stage the split: lane l fetches token l (its block-table entry read
  // through this lane's own row, so aliased prefix pages are found as
  // mapped), warp w its 16-byte copies w, w + 8, ...; zeros past kv_end
  const size_t page_elems = size_t(page) * Kv * HD;   // one of K or V
  const bool valid = t < kv_end;
  const TKV* row = valid ? kv + size_t(phys) * 2 * page_elems +
                               (size_t(t % page) * Kv + kh) * HD
                         : kv;
  float k_sc = 1.f, v_sc = 1.f;
  if (kInt8 && valid) {
    k_sc = kv_scales[(size_t(phys) * 2) * Kv + kh];
    v_sc = kv_scales[(size_t(phys) * 2 + 1) * Kv + kh];
  }
  for (int ch = warp; ch < kChunks; ch += kWarps) {
    tc::cp_async16(ks + lane * S::kRowBytes + ch * 16,
                   valid ? row + ch * kVec : kv, valid ? 16 : 0);
    tc::cp_async16(vs + lane * S::kRowBytes + ch * 16,
                   valid ? row + page_elems + ch * kVec : kv,
                   valid ? 16 : 0);
  }
  tc::cp_async_commit();
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kHeads * HD) qs[i] = qv[k];
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // lanes score their tokens against the warp's head, then accumulate
  // dims d0 .. d0 + kDims - 1 of P.V
  float m = kNegInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
  if (head_live) {
    float dot = 0.f;
    const TKV* kr = reinterpret_cast<const TKV*>(ks + lane * S::kRowBytes);
    const float* qr = qs + warp * HD;
#pragma unroll 4
    for (int ch = 0; ch < kChunks; ++ch) {
      float kf[kVec];
      load_dims<TKV, kVec>(kr + ch * kVec, kf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(qr[ch * kVec + e], kf[e], dot);
    }
    // int8: the K scale of the token's page multiplies its score, the V
    // scale its p in P.V; l sums p unscaled
    const float s = valid ? dot * scale * k_sc : kNegInf;
    m = warp_max(s);
    const float p = valid ? expf(s - m) : 0.f;
    l = warp_sum(p);
    // p of the span's tokens through shared memory, four at a time;
    // tokens past kv_end have p = 0 and zero V rows
    ps[lane] = p * v_sc;
    __syncwarp();
    if (dims_live) {
#pragma unroll 2
      for (int tt = 0; tt < kSpan; tt += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + tt);
        const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[kDims];
          load_dims<TKV, kDims>(reinterpret_cast<const TKV*>(
                                    vs + (tt + u) * S::kRowBytes) + d0, vv);
#pragma unroll
          for (int e = 0; e < kDims; ++e) acc[e] = fmaf(pp[u], vv[e], acc[e]);
        }
      }
    }
  }

  if (n_live == 1) {   // the lane's only split: the output as it stands
    if (head_live && dims_live) {
      const float denom = l == 0.f ? 1.f : l;     // fully masked -> 0
#pragma unroll
      for (int e = 0; e < kDims; ++e)
        dst[warp * HD + d0 + e] = from_f32<TQ>(acc[e] / denom);
    }
    return;
  }

  // the partial (m, l, acc) of this split, in float32
  if (head_live) {
    const size_t slot = (size_t(b) * H + h0 + warp) * n_splits + split;
    if (lane == 0) {
      part_ml[2 * slot] = m;
      part_ml[2 * slot + 1] = l;
    }
    if (dims_live) {
#pragma unroll
      for (int e = 0; e < kDims; ++e) part_acc[slot * HD + d0 + e] = acc[e];
    }
  }
  if (!last_split(tickets + size_t(b) * gridDim.x + blockIdx.x, n_live,
                  &last) || !head_live)
    return;
  combine_head<TQ, HD>(part_ml, part_acc,
                       (size_t(b) * H + h0 + warp) * n_splits, n_live,
                       dst + warp * HD, lane);
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const void* q, const void* kv, const float* kv_scales,
                   const int* block_table, const int* page_counts,
                   const int* lengths, const int* q_start, void* out,
                   float* part_ml, float* part_acc, int* tickets, int B,
                   int H, int Kv, int page, int n_pages, int pool_pages,
                   int n_splits, float scale, cudaStream_t stream) {
  const int chunks = (H / Kv + kHeads - 1) / kHeads;
  if (B > 65535 || n_splits > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(Kv * chunks, B, n_splits);
  auto kernel = paged_decode_split_kernel<TQ, TKV, HD>;
  constexpr int smem = Smem<TKV, HD>::kBytes;
  static bool opted_in = false;   // above 48 KB a block needs the opt-in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kv), kv_scales,
      block_table, page_counts, lengths, q_start, static_cast<TQ*>(out),
      part_ml, part_acc, tickets, H, Kv, page, n_pages, pool_pages, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* kv,
                        const float* kv_scales, const int* block_table,
                        const int* page_counts, const int* lengths,
                        const int* q_start, void* out, float* part_ml,
                        float* part_acc, int* tickets, int B, int H, int Kv,
                        int page, int n_pages, int pool_pages, int n_splits,
                        float scale, cudaStream_t stream) {
#define SPLIT_LAUNCH(HD_)                                                   \
  launch<TQ, TKV, HD_>(q, kv, kv_scales, block_table, page_counts, lengths, \
                       q_start, out, part_ml, part_acc, tickets, B, H, Kv,  \
                       page, n_pages, pool_pages, n_splits, scale, stream)
  switch (hd) {
    case 16: return SPLIT_LAUNCH(16);
    case 32: return SPLIT_LAUNCH(32);
    case 64: return SPLIT_LAUNCH(64);
    case 128: return SPLIT_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef SPLIT_LAUNCH
}

// ------------------------------------- split-KV decode, bf16 q on mma --
// The bf16-q branch of the split-KV kernel: the same grid, partials and
// combine, with its products on the tensor cores (mma.sync m16n8k16, as
// the tc prefill kernel's): a block's up to 16 query heads are the 16
// rows of the A operand, each of its 8 warps scores and accumulates 16 of
// the split's 128 tokens, and the warps' row maxima, sums and partial
// outputs meet in shared memory.  p (times the int8 V scale) is rounded
// to bf16 for P.V while l sums it unrounded, as in the tc prefill kernel.
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcTok = 16;                       // tokens per warp
constexpr int kTcSpan = kTcWarps * kTcTok;       // tokens per split
constexpr int kTcRows = 16;                      // query heads per block
constexpr float kLn2 = 0.6931471805599453f;

template <typename TKV, int HD>
struct TcSmem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kLd = HD + tc::kPad;                // bf16 row
  static constexpr int kOLd = HD + 8;                      // float row
  static constexpr int kQ = kTcRows * kLd * 2;
  static constexpr int kTile = kTcSpan * kLd * 2;          // bf16 K or V
  static constexpr int kRaw = kTcSpan * HD;                // int8 K or V
  static constexpr int kTiles =
      2 * kTile + (kInt8 ? 2 * kRaw + 2 * kTcSpan * 4 : 0);
  // the warps' partial outputs reuse the tiles once P.V is done
  static constexpr int kO = kTcWarps * kTcRows * kOLd * 4;
  static constexpr int kBody = kTiles > kO ? kTiles : kO;
  static constexpr int kBytes = kQ + kBody + 2 * kTcWarps * kTcRows * 4;
};

template <typename TKV, int HD>
__global__ void __launch_bounds__(kTcThreads)
paged_decode_split_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const TKV* __restrict__ kv,
                             const float* __restrict__ kv_scales,
                             const int* __restrict__ block_table,
                             const int* __restrict__ page_counts,
                             const int* __restrict__ lengths,
                             const int* __restrict__ q_start,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ part_ml,
                             float* __restrict__ part_acc,
                             int* __restrict__ tickets, int H, int Kv,
                             int page, int n_pages, int pool_pages,
                             float scale_log2) {
  using bf16 = __nv_bfloat16;
  using S = TcSmem<TKV, HD>;
  constexpr bool kInt8 = S::kInt8;
  constexpr int kLd = S::kLd;
  constexpr int kChunks = HD * int(sizeof(TKV)) / 16;    // copies a row
  constexpr int kQChunks = HD / 8;                       // copies a q row
  constexpr int kParts = kTcThreads / kTcSpan;           // threads a token
  static_assert(kParts == 2, "a token's two threads copy its two scales");
  const int split = blockIdx.z, n_splits = gridDim.z;
  const int G = H / Kv;
  const int chunks = (G + kTcRows - 1) / kTcRows;
  const int kh = blockIdx.x / chunks;
  const int g0 = (blockIdx.x - kh * chunks) * kTcRows;
  const int nh = min(kTcRows, G - g0);            // heads of this block
  const int h0 = kh * G + g0;                     // its first query head
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = split * kTcSpan;
  // thread i stages token i % 128 of the split, part i / 128 of its rows;
  // its block-table entry goes out with the lane's lengths (the table is
  // repeat-padded, so any column below n_pages is a page of the pool)
  const int tt = threadIdx.x % kTcSpan, part = threadIdx.x / kTcSpan;
  const int phys = min(
      max(block_table[size_t(b) * n_pages +
                      min((t0 + tt) / page, n_pages - 1)], 0),
      pool_pages - 1);
  const int kv_end = min(min(lengths[b], page_counts[b] * page),
                         q_start[b] + 1);
  const int n_live = kv_end > 0 ? (kv_end + kTcSpan - 1) / kTcSpan : 0;
  bf16* dst = out + (size_t(b) * H + h0) * HD;    // (B, 1, H, hd)

  if (n_live == 0) {   // nothing visible (an empty lane): 0, from split 0
    if (split == 0)
      for (int i = threadIdx.x; i < nh * HD; i += kTcThreads)
        dst[i] = __float2bfloat16(0.f);
    return;
  }
  if (split >= n_live) return;                    // past the lane's end

  extern __shared__ __align__(128) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  uint8_t* body = smem + S::kQ;
  bf16* kt = reinterpret_cast<bf16*>(body);
  bf16* vt = reinterpret_cast<bf16*>(body + S::kTile);
  uint8_t* raw = body + 2 * S::kTile;             // int8: K, V, scales
  float* scales = reinterpret_cast<float*>(raw + 2 * S::kRaw);
  float* os = reinterpret_cast<float*>(body);     // after P.V
  float* red = reinterpret_cast<float*>(body + S::kBody);
  __shared__ int last;

  // q: head h0 + r in row r, zeros past nh
  for (int i = threadIdx.x; i < kTcRows * kQChunks; i += kTcThreads) {
    const int r = i / kQChunks, ch = i - r * kQChunks;
    const bool ok = r < nh;
    tc::cp_async16(qs + r * kLd + ch * 8,
                   ok ? q + (size_t(b) * H + h0 + r) * HD + ch * 8 : q,
                   ok ? 16 : 0);
  }
  // token tt's K and V rows of head kh (and, on an int8 pool, part 0 its
  // page's K scale, part 1 its V scale); zeros past kv_end
  const size_t page_elems = size_t(page) * Kv * HD;   // one of K or V
  {
    const int t = t0 + tt;
    const bool valid = t < kv_end;
    const TKV* row = valid ? kv + size_t(phys) * 2 * page_elems +
                                 (size_t(t % page) * Kv + kh) * HD
                           : kv;
    for (int ch = part; ch < kChunks; ch += kParts) {
#pragma unroll
      for (int sel = 0; sel < 2; ++sel) {          // K, then V
        const TKV* src =
            valid ? row + sel * page_elems + ch * (16 / int(sizeof(TKV)))
                  : kv;
        void* d = kInt8 ? static_cast<void*>(raw + sel * S::kRaw + tt * HD +
                                             ch * 16)
                        : static_cast<void*>((sel ? vt : kt) + tt * kLd +
                                             ch * 8);
        tc::cp_async16(d, src, valid ? 16 : 0);
      }
    }
    if constexpr (kInt8)
      tc::cp_async4(scales + part * kTcSpan + tt,
                    valid ? kv_scales + (size_t(phys) * 2 + part) * Kv + kh
                          : kv_scales,
                    valid ? 4 : 0);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kInt8) {
    // int8 values in [-127, 127] are exact in bf16: convert once
    for (int i = threadIdx.x; i < 2 * kTcSpan * (HD / 16);
         i += kTcThreads) {
      const int sel = i / (kTcSpan * (HD / 16));
      const int rem = i - sel * kTcSpan * (HD / 16);
      const int r = rem / (HD / 16), ch = rem - r * (HD / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(raw + sel * S::kRaw +
                                                      r * HD + ch * 16);
      uint32_t w[8];
      tc::int8x4_to_bf16(v.x, w[0], w[1]);
      tc::int8x4_to_bf16(v.y, w[2], w[3]);
      tc::int8x4_to_bf16(v.z, w[4], w[5]);
      tc::int8x4_to_bf16(v.w, w[6], w[7]);
      bf16* d = (sel ? vt : kt) + r * kLd + ch * 16;
      reinterpret_cast<uint4*>(d)[0] = make_uint4(w[0], w[1], w[2], w[3]);
      reinterpret_cast<uint4*>(d)[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();
  }

  // S = q . K^T for the warp's 16 tokens: 2 n-tiles of 8
  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t qf[4], kb[4];
    tc::ldmatrix_x4(qf, qs + ((lane % 8) + ((lane / 8) % 2) * 8) * kLd +
                            ks * 16 + (lane / 16) * 8);
    tc::ldmatrix_x4(kb, kt + (kTcTok * warp + (lane / 16) * 8 + lane % 8) *
                                 kLd + ks * 16 + ((lane / 8) % 2) * 8);
    tc::mma_16816(s[0], qf, kb[0], kb[1]);
    tc::mma_16816(s[1], qf, kb[2], kb[3]);
  }
  // element e of n-tile j: row (head) lane/4 (e < 2) or lane/4 + 8, token
  // 16 warp + 8 j + 2 (lane % 4) + e % 2 of the split
  const int ra = lane / 4, rb = ra + 8;
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tk = kTcTok * warp + 8 * j + 2 * (lane % 4) + (e & 1);
      float x = s[j][e] * scale_log2;
      if constexpr (kInt8) x *= scales[tk];
      s[j][e] = t0 + tk < kv_end ? x : kNegInf;
      if (e < 2) mx_a = fmaxf(mx_a, s[j][e]);
      else mx_b = fmaxf(mx_b, s[j][e]);
    }
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, o_));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, o_));
  }
  float* red_m = red;                             // [warp][row]
  float* red_l = red + kTcWarps * kTcRows;
  if (lane % 4 == 0) {
    red_m[warp * kTcRows + ra] = mx_a;
    red_m[warp * kTcRows + rb] = mx_b;
  }
  __syncthreads();
  float m_a = kNegInf, m_b = kNegInf;             // the split's row max
#pragma unroll
  for (int w = 0; w < kTcWarps; ++w) {
    m_a = fmaxf(m_a, red_m[w * kTcRows + ra]);
    m_b = fmaxf(m_b, red_m[w * kTcRows + rb]);
  }
  // p = exp(s - m) on visible tokens, 0 elsewhere; l sums p as is, the
  // P.V operand is p (times the int8 V scale) rounded to bf16
  float l_a = 0.f, l_b = 0.f, pv[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tk = kTcTok * warp + 8 * j + 2 * (lane % 4) + (e & 1);
      const float p = s[j][e] == kNegInf
                          ? 0.f
                          : exp2f(s[j][e] - (e < 2 ? m_a : m_b));
      if (e < 2) l_a += p;
      else l_b += p;
      pv[j][e] = p;
      if constexpr (kInt8) pv[j][e] *= scales[kTcSpan + tk];
    }
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, o_);
    l_b += __shfl_xor_sync(kFull, l_b, o_);
  }
  if (lane % 4 == 0) {
    red_l[warp * kTcRows + ra] = l_a;
    red_l[warp * kTcRows + rb] = l_b;
  }
  const uint32_t pa[4] = {tc::pack_bf16(pv[0][0], pv[0][1]),
                          tc::pack_bf16(pv[0][2], pv[0][3]),
                          tc::pack_bf16(pv[1][0], pv[1][1]),
                          tc::pack_bf16(pv[1][2], pv[1][3])};
  // O_w = P . V over the warp's 16 tokens: V read transposed
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    uint32_t vb[4];
    tc::ldmatrix_x4_trans(vb, vt + (kTcTok * warp + lane % 8 +
                                    ((lane / 8) % 2) * 8) * kLd +
                                  16 * dp + (lane / 16) * 8);
    tc::mma_16816(o[2 * dp], pa, vb[0], vb[1]);
    tc::mma_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
  }
  __syncthreads();   // every warp is done with the tiles: os reuses them
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(os + (warp * kTcRows + ra) * S::kOLd + d) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(os + (warp * kTcRows + rb) * S::kOLd + d) =
        make_float2(o[j][2], o[j][3]);
  }
  __syncthreads();

  // the block's rows: sum the warps' parts; m back from log2 units
  for (int i = threadIdx.x; i < nh * HD; i += kTcThreads) {
    const int r = i / HD, d = i - r * HD;
    float acc = 0.f, l = 0.f, m = kNegInf;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      acc += os[(w * kTcRows + r) * S::kOLd + d];
      l += red_l[w * kTcRows + r];
      m = fmaxf(m, red_m[w * kTcRows + r]);
    }
    if (n_live == 1) {   // the lane's only split: the output as it stands
      dst[i] = __float2bfloat16(acc / (l == 0.f ? 1.f : l));
    } else {
      const size_t slot = (size_t(b) * H + h0 + r) * n_splits + split;
      part_acc[slot * HD + d] = acc;
      if (d == 0) {
        part_ml[2 * slot] = m * kLn2;
        part_ml[2 * slot + 1] = l;
      }
    }
  }
  if (n_live == 1) return;
  if (!last_split(tickets + size_t(b) * gridDim.x + blockIdx.x, n_live,
                  &last))
    return;
  for (int hl = warp; hl < nh; hl += kTcWarps)
    combine_head<bf16, HD>(part_ml, part_acc,
                           (size_t(b) * H + h0 + hl) * n_splits, n_live,
                           dst + hl * HD, lane);
}

template <typename TKV, int HD>
cudaError_t launch_tc(const void* q, const void* kv, const float* kv_scales,
                      const int* block_table, const int* page_counts,
                      const int* lengths, const int* q_start, void* out,
                      float* part_ml, float* part_acc, int* tickets, int B,
                      int H, int Kv, int page, int n_pages, int pool_pages,
                      int n_splits, float scale, cudaStream_t stream) {
  const int chunks = (H / Kv + kTcRows - 1) / kTcRows;
  if (B > 65535 || n_splits > 65535) return cudaErrorInvalidValue;
  const dim3 grid(Kv * chunks, B, n_splits);
  auto kernel = paged_decode_split_tc_kernel<TKV, HD>;
  constexpr int smem = TcSmem<TKV, HD>::kBytes;
  static bool opted_in = false;   // above 48 KB a block needs the opt-in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(kv),
      kv_scales, block_table, page_counts, lengths, q_start,
      static_cast<__nv_bfloat16*>(out), part_ml, part_acc, tickets, H, Kv,
      page, n_pages, pool_pages, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t dispatch_tc_hd(int hd, const void* q, const void* kv,
                           const float* kv_scales, const int* block_table,
                           const int* page_counts, const int* lengths,
                           const int* q_start, void* out, float* part_ml,
                           float* part_acc, int* tickets, int B, int H,
                           int Kv, int page, int n_pages, int pool_pages,
                           int n_splits, float scale, cudaStream_t stream) {
#define SPLIT_TC_LAUNCH(HD_)                                                 \
  launch_tc<TKV, HD_>(q, kv, kv_scales, block_table, page_counts, lengths,   \
                      q_start, out, part_ml, part_acc, tickets, B, H, Kv,    \
                      page, n_pages, pool_pages, n_splits, scale, stream)
  switch (hd) {
    case 16: return SPLIT_TC_LAUNCH(16);
    case 32: return SPLIT_TC_LAUNCH(32);
    case 64: return SPLIT_TC_LAUNCH(64);
    case 128: return SPLIT_TC_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef SPLIT_TC_LAUNCH
}

}  // namespace split

// ------------------------------------------------ FP32-core prefill --
// q float32, C > 1 (the float32 engine's chunk and verify steps), on a
// float32 or an int8 pool; see the design note at the top of the file.
namespace f32 {

constexpr int kThreads = 256;        // a kTY x 16 thread grid
constexpr int kRows = 64;            // query rows per block
constexpr int kTok = 64;             // tokens per K/V tile
constexpr int kTY = kThreads / 16;   // thread rows of the grid
constexpr int kRT = kRows / kTY;     // query rows of a thread

// Shared memory of one block, in bytes: the q tile, P, two stages of the
// K/V ring (float32 pool: float32 K and V; int8 pool: raw int8 K and V and
// each token's two scales) and, on an int8 pool, the float32 K and V the
// stage is dequantized into.  q and K rows carry a 16-byte pad, so the 8
// rows a quarter-warp reads 16 bytes of start in 8 different bank groups;
// P rows are 80 floats, so a warp's two rows of p land in disjoint banks.
template <typename TKV, int HD>
struct Smem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kLd = HD + 4;                  // q and K rows
  static constexpr int kPLd = kTok + 16;              // P rows
  static constexpr int kQ = kRows * kLd * 4;
  static constexpr int kP = kRows * kPLd * 4;
  static constexpr int kK = kTok * kLd * 4;           // float32 K tile
  static constexpr int kV = kTok * HD * 4;            // float32 V tile
  static constexpr int kRaw = kTok * HD;              // int8 K or V tile
  static constexpr int kStage = kInt8 ? 2 * kRaw + 2 * kTok * 4 : kK + kV;
  static constexpr int kBytes = kQ + kP + 2 * kStage + (kInt8 ? kK + kV : 0);
};

// Four int8 values (one word, little-endian) -> four exact floats without
// the quarter-rate integer conversion, as tc::int8x4_to_bf16 does: the
// byte with its sign bit flipped, x + 128, in the low mantissa of 2^23,
// less 2^23 + 128
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;             // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kMagic;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kMagic;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kMagic;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kMagic;
}

// N consecutive floats from shared memory, 16, 8 or 4 bytes at once
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

template <typename TKV, int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_kernel(const float* __restrict__ q, const TKV* __restrict__ kv,
                     const float* __restrict__ kv_scales,
                     const int* __restrict__ block_table,
                     const int* __restrict__ page_counts,
                     const int* __restrict__ lengths,
                     const int* __restrict__ q_start, float* __restrict__ out,
                     int C, int H, int Kv, int page, int n_pages,
                     int pool_pages, float scale_log2) {
  using S = Smem<TKV, HD>;
  constexpr bool kInt8 = S::kInt8;
  constexpr int kLd = S::kLd, kPLd = S::kPLd;
  constexpr int kChunks = HD * int(sizeof(TKV)) / 16;   // per K/V row
  constexpr int kD = HD / 16;              // P.V dims of a thread
  constexpr int kVec = kD < 4 ? kD : 4;    // ... read kVec at a time
  constexpr int kGroups = kD / kVec;       // ... in groups 16*kVec apart
  const int G = H / Kv;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int rows = C * G;
  const int row0 = blockIdx.x * kRows;
  // thread (ty, tx): rows ty + kTY i of the block, tokens tx + 16j of a
  // tile; a row's 16 threads are one half-warp
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int len = lengths[b], q0 = q_start[b], npages = page_counts[b];
  const int kv_lim = min(len, npages * page);
  // the last token any row of this block may see, and the last every row
  // may see (block-uniform): tiles past the first are skipped, tiles
  // before the second need no mask
  const int last_row = min(row0 + kRows, rows) - 1;
  const int kv_end = min(kv_lim, q0 + last_row / G + 1);
  const int kv_full = min(kv_lim, q0 + row0 / G + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + kTok - 1) / kTok : 0;

  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + S::kQ);
  uint8_t* stages = smem + S::kQ + S::kP;
  // the float32 K and V tiles the products read: stage st's own (float32
  // pool) or the pair every int8 stage is dequantized into
  auto k_tile = [&](int st) {
    return reinterpret_cast<float*>(kInt8 ? stages + 2 * S::kStage
                                          : stages + st * S::kStage);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<float*>(
        kInt8 ? stages + 2 * S::kStage + S::kK
              : stages + st * S::kStage + S::kK);
  };
  auto scales = [&](int st) {     // int8: [kTok] K scales, then V's
    return reinterpret_cast<float*>(stages + st * S::kStage + 2 * S::kRaw);
  };

  // q rows (row = c*G + g reads head kh*G + g of token c), zero past rows
  constexpr int kQCopies = kRows * (HD / 4);
#pragma unroll
  for (int j = 0; j < (kQCopies + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (kQCopies % kThreads && i >= kQCopies) break;
    const int r = i / (HD / 4), ch = i - r * (HD / 4);
    const int row = row0 + r;
    const float* src = q;
    int bytes = 0;
    if (row < rows) {
      const int c = row / G;
      src = q + ((size_t(b) * C + c) * H + kh * G + (row - c * G)) * HD +
            ch * 4;
      bytes = 16;
    }
    tc::cp_async16(qs + r * kLd + ch * 4, src, bytes);
  }

  // tile `it` of the visible tokens into stage st.  Copy i of the tile is
  // chunk i % kChunks of token i / kChunks, so a warp copies whole rows
  // (512 contiguous bytes of a float32 row at hd 128) and a thread's
  // copies are kStep tokens apart: its first token's (page, slot) is
  // divided out once a tile, then stepped on.  Each copy reads its
  // token's page from the lane's own block-table row; zeros past kv_end
  static_assert(kThreads % kChunks == 0, "a thread keeps one chunk");
  constexpr int kStep = kThreads / kChunks;          // tokens per pass
  const size_t page_elems = size_t(page) * Kv * HD;  // one of K or V
  const int* bt_row = block_table + size_t(b) * n_pages;
  auto phys_of = [&](int lp) {
    return min(max(bt_row[min(lp, n_pages - 1)], 0), pool_pages - 1);
  };
  auto load_tile = [&](int it, int st) {
    uint8_t* base = stages + st * S::kStage;
    const int ch = threadIdx.x % kChunks;
    int tt = threadIdx.x / kChunks;
    int t = it * kTok + tt;
    int lp = t / page, slot = t - lp * page;
    // unrolled, so the block-table reads of all passes are in flight
    // together
#pragma unroll
    for (int j = 0; j < (kTok + kStep - 1) / kStep; ++j) {
      if (kTok % kStep && tt >= kTok) break;
      const bool valid = t < kv_end;
      const TKV* row =
          valid ? kv + size_t(phys_of(lp)) * 2 * page_elems +
                      (size_t(slot) * Kv + kh) * HD
                : kv;
      constexpr int kElems = 16 / int(sizeof(TKV));
#pragma unroll
      for (int sel = 0; sel < 2; ++sel) {                // K, then V
        const TKV* src = valid ? row + sel * page_elems + ch * kElems : kv;
        void* dst =
            kInt8 ? static_cast<void*>(base + sel * S::kRaw + tt * HD +
                                       ch * 16)
                  : static_cast<void*>(
                        reinterpret_cast<float*>(base + sel * S::kK) +
                        tt * (sel ? HD : kLd) + ch * 4);
        tc::cp_async16(dst, src, valid ? 16 : 0);
      }
      tt += kStep;
      t += kStep;
      for (slot += kStep; slot >= page; slot -= page) ++lp;
    }
    if constexpr (kInt8) {   // threads 0-63: K scales; 64-127: V scales
      if (threadIdx.x < 2 * kTok) {
        const int tk = threadIdx.x % kTok, sel = threadIdx.x / kTok;
        const int tok = it * kTok + tk;
        const bool valid = tok < kv_end;
        tc::cp_async4(scales(st) + sel * kTok + tk,
                      valid ? kv_scales +
                                  (size_t(phys_of(tok / page)) * 2 + sel) *
                                      Kv + kh
                            : kv_scales,
                      valid ? 4 : 0);
      }
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  tc::cp_async_commit();          // q and tile 0

  // this thread's rows: their causal limits (rows past the chunk see the
  // whole resident sequence, as in the reference), (m, l) and acc
  int lim[kRT];
  float m[kRT], l[kRT], acc[kRT][kD];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    lim[i] = min(kv_lim, q0 + (row0 + ty + kTY * i) / G + 1);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[i][d] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    tc::cp_async_wait<0>();   // tile it (and q) landed ...
    __syncthreads();          // ... for every thread; tile it-1 is consumed
    if (it + 1 < n_tiles) {   // so its stage takes tile it+1
      load_tile(it + 1, st ^ 1);
      tc::cp_async_commit();
    }
    if constexpr (kInt8) {
      // dequantize before any product, as the reference's fetch does:
      // K = k_int8 * s_k of the token's page, V likewise
      const int8_t* raw = reinterpret_cast<const int8_t*>(
          stages + st * S::kStage);
      const float* sc = scales(st);
      for (int i = threadIdx.x; i < 2 * kTok * (HD / 16); i += kThreads) {
        const int sel = i / (kTok * (HD / 16));
        const int rem = i - sel * kTok * (HD / 16);
        const int tt = rem / (HD / 16), ch = rem - tt * (HD / 16);
        const uint4 v = *reinterpret_cast<const uint4*>(
            raw + sel * S::kRaw + tt * HD + ch * 16);
        const float s = sc[sel * kTok + tt];
        float* dst = (sel ? v_tile(st) + tt * HD : k_tile(st) + tt * kLd) +
                     ch * 16;
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f[4];
          int8x4_to_f32(w[e], f);
          *reinterpret_cast<float4*>(dst + 4 * e) =
              make_float4(f[0] * s, f[1] * s, f[2] * s, f[3] * s);
        }
      }
      __syncthreads();
    }
    const float* ks = k_tile(st);
    const float* vs = v_tile(st);

    // S = q . K^T: kRT rows x 4 tokens a thread, 16 bytes of q and of K
    // at a time
    float s[kRT][4];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
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

    // scale to log2 units, mask (only a tile that crosses some row's
    // limit), online softmax across the row's 16 threads
    const int t0 = it * kTok;
    const bool masked = t0 + kTok > kv_full;
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale_log2;
        if (masked && t0 + tx + 16 * j >= lim[i]) x = kNegInf;
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
        const float p = s[i][j] == kNegInf ? 0.f : exp2f(s[i][j] - m_new);
        sum += p;
        ps[(ty + kTY * i) * kPLd + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();          // P complete

    // O += P . V: kRT rows x kD dims a thread, p 4 tokens at a time
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
          float v[kVec];
          load_vec(v, vs + (t4 + e) * HD + g * 16 * kVec + tx * kVec);
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[i][g * kVec + x] =
                  fmaf(pv[i][e], v[x], acc[i][g * kVec + x]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();    // an empty lane's q copies are still in flight

#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int row = row0 + ty + kTY * i;
    if (row >= rows) continue;
    const int c = row / G;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);   // nothing seen: 0
    float* dst = out + ((size_t(b) * C + c) * H + kh * G + (row - c * G)) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float* o = dst + g * 16 * kVec + tx * kVec;
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[i][4 * g] * inv, acc[i][4 * g + 1] * inv,
            acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x) o[x] = acc[i][g * kVec + x] * inv;
      }
    }
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
  auto kernel = paged_prefill_kernel<TKV, HD>;
  constexpr int smem = Smem<TKV, HD>::kBytes;
  static bool opted_in = false;   // above 48 KB a block needs the opt-in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(kv), kv_scales,
      block_table, page_counts, lengths, q_start, static_cast<float*>(out),
      C, H, Kv, page, n_pages, pool_pages, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* kv,
                        const float* kv_scales, const int* block_table,
                        const int* page_counts, const int* lengths,
                        const int* q_start, void* out, int B, int C, int H,
                        int Kv, int page, int n_pages, int pool_pages,
                        float scale, cudaStream_t stream) {
#define PAGED_LAUNCH(HD_)                                                   \
  launch<TKV, HD_>(q, kv, kv_scales, block_table, page_counts, lengths,     \
                   q_start, out, B, C, H, Kv, page, n_pages, pool_pages,    \
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

}  // namespace f32

}  // namespace

// Element-type codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only).
// The FP32-core kernel: q/out float32 (B,C,H,hd), kv_dtype 0 (a float32
// pool) or 2 (an int8 pool with kv_scales a (pool_pages, 2, Kv) float32
// device pointer, null otherwise).  Pointers are device pointers of
// contiguous tensors: kv (pool_pages,2,page,Kv,hd), block_table
// (B,n_pages) int32 repeat-padded, page_counts/lengths/q_start (B,)
// int32.  The wrapper's route sends float32 q with C > 1 here; it
// computes any C.  Launches on `stream`; does not synchronise.
extern "C" int paged_prefill_launch(int kv_dtype, const void* q,
                                    const void* kv, const void* kv_scales,
                                    const void* block_table,
                                    const void* page_counts,
                                    const void* lengths, const void* q_start,
                                    void* out, int B, int C, int H, int Kv,
                                    int hd, int page, int n_pages,
                                    int pool_pages, float scale,
                                    void* stream) {
  const float* sc = static_cast<const float*>(kv_scales);
  const bool int8_pool = kv_dtype == 2;
  if ((kv_dtype != 0 && !int8_pool) || int8_pool != (sc != nullptr))
    return int(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* cnt = static_cast<const int*>(page_counts);
  const int* len = static_cast<const int*>(lengths);
  const int* qs = static_cast<const int*>(q_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      int8_pool
          ? f32::dispatch_hd<int8_t>(hd, q, kv, sc, bt, cnt, len, qs, out, B,
                                     C, H, Kv, page, n_pages, pool_pages,
                                     scale, s)
          : f32::dispatch_hd<float>(hd, q, kv, sc, bt, cnt, len, qs, out, B,
                                    C, H, Kv, page, n_pages, pool_pages,
                                    scale, s);
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

// Tokens of one split of the split-KV kernel, and query heads of one of
// its blocks: the wrapper sizes the grid, the scratch and the tickets
// with them.
extern "C" int paged_decode_split_tokens(int q_dtype) {
  return q_dtype == 1 ? split::kTcSpan : split::kSpan;
}
extern "C" int paged_decode_split_heads(int q_dtype) {
  return q_dtype == 1 ? split::kTcRows : split::kHeads;
}

// The split-KV decode kernel: C = 1, q_dtype 0 or 1, kv_dtype equal to
// q_dtype or 2 (an int8 pool with kv_scales); q/out (B,1,H,hd); the other
// pointers as paged_prefill_launch's, plus float32 scratch the wrapper
// allocates, part_ml (B, H, n_splits, 2) and part_acc (B, H, n_splits,
// hd), and int32 tickets (B, Kv * ceil(G / heads)) that must be 0 before
// the first launch (each launch leaves them 0), with tokens and heads as
// paged_decode_split_tokens/_heads(q_dtype) give them; n_splits * tokens
// must cover n_pages * page.  Launches that share scratch and tickets must
// run one after another (one stream).  Launches on `stream`; does not
// synchronise.
extern "C" int paged_decode_split_launch(
    int q_dtype, int kv_dtype, const void* q, const void* kv,
    const void* kv_scales, const void* block_table, const void* page_counts,
    const void* lengths, const void* q_start, void* out, void* part_ml,
    void* part_acc, void* tickets, int B, int H, int Kv, int hd, int page,
    int n_pages, int pool_pages, int n_splits, float scale, void* stream) {
  const float* sc = static_cast<const float*>(kv_scales);
  const bool int8_pool = kv_dtype == 2;
  if (int8_pool != (sc != nullptr) || B < 1 || Kv < 1 || H % Kv ||
      n_splits < 1 ||
      (long long)n_splits * paged_decode_split_tokens(q_dtype) <
          (long long)n_pages * page)
    return int(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* cnt = static_cast<const int*>(page_counts);
  const int* len = static_cast<const int*>(lengths);
  const int* qs = static_cast<const int*>(q_start);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define SPLIT_DISPATCH(TQ_, TKV_)                                            \
  split::dispatch_hd<TQ_, TKV_>(hd, q, kv, sc, bt, cnt, len, qs, out, ml,   \
                                acc, tk, B, H, Kv, page, n_pages,           \
                                pool_pages, n_splits, scale, s)
  if (q_dtype == 0 && kv_dtype == 0) {
    e = SPLIT_DISPATCH(float, float);
  } else if (q_dtype == 0 && int8_pool) {
    e = SPLIT_DISPATCH(float, int8_t);
  } else if (q_dtype == 1 && (kv_dtype == 1 || int8_pool)) {
    // bf16 q: the products on the tensor cores
    e = int8_pool ? split::dispatch_tc_hd<int8_t>(
                        hd, q, kv, sc, bt, cnt, len, qs, out, ml, acc, tk, B,
                        H, Kv, page, n_pages, pool_pages, n_splits, scale, s)
                  : split::dispatch_tc_hd<__nv_bfloat16>(
                        hd, q, kv, sc, bt, cnt, len, qs, out, ml, acc, tk, B,
                        H, Kv, page, n_pages, pool_pages, n_splits, scale, s);
  }
#undef SPLIT_DISPATCH
  return static_cast<int>(e);
}
