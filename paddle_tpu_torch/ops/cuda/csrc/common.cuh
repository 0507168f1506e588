// Shared device helpers of the port's Hopper kernels: the block-skip
// predicate the attention and grouped-matmul kernels run, 8-wide vector
// loads that widen bf16/fp32 to fp32, and the flash kernels' tensor-core
// pieces: the bf16 mma.sync product, cp.async copies into shared memory,
// ldmatrix fragment loads, padded tiles and fragment helpers (flash_fwd.cu,
// flash_bwd.cu). The wgmma/TMA core of the grouped matmul and the CE
// statistics is sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace ptt {

constexpr float kNegInf = -1e30f;

// -inf, the lse of a row with no visible key
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// THE cross-block skip predicate (paddle_tpu/ops/pallas/flash_attention.py
// `_seg_blocks_can_touch`): a K block may contribute to a Q block only if
// their id ranges intersect. The flash kernel runs it over segment-id
// ranges, the paged kernel over position ranges (a page is read only if
// it overlaps the last query's key range [0, len + T - 2]).
__device__ __forceinline__ bool blocks_can_touch(int q_min, int q_max,
                                                 int k_min, int k_max) {
  return k_min <= q_max && k_max >= q_min;
}

// 8 consecutive elements -> fp32. bf16 needs 16-byte alignment, fp32 32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The least and the largest of the ids one load brought: an int, or the
// four ints of a 16-byte load (the visit counters' vector path).
__device__ __forceinline__ int lo_of(int v) { return v; }
__device__ __forceinline__ int hi_of(int v) { return v; }
__device__ __forceinline__ int lo_of(int4 v) {
  return min(min(v.x, v.y), min(v.z, v.w));
}
__device__ __forceinline__ int hi_of(int4 v) {
  return max(max(v.x, v.y), max(v.z, v.w));
}

// c += a . b on the tensor cores: one m16n8k16 tile, bf16 inputs (a row-
// major, b column-major fragments), fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to bf16 and packed as one mma operand register
// (`lo` in the low half: the element of the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Asynchronous 16-byte (4-byte) copy global -> shared; src_bytes 0
// zero-fills the destination without reading `gmem`.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i holds matrix i (transposed
// with _trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ---- the flash kernels' tensor-core pieces (flash_fwd.cu, flash_bwd.cu);
// kLog2e and exp2_ftz also serve fused_ce.cu ------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU, subnormal results flushed to 0: exp2f wraps the same
// instruction in a rescaling for subnormals, several more instructions a
// value, and a term below 2^-126 adds nothing to a softmax sum
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 row stride of a shared [rows][D] tile: 16 bytes of padding keep
// every ldmatrix of the tile free of bank conflicts
template <int D>
constexpr int kTileLd = D + 8;

// the segment-id range of rows [r0, r0 + 32 * n), reduced over the warp so
// every warp of the block reaches the same skip decision
__device__ __forceinline__ void seg_range(const int* segb, int r0, int n,
                                          int S, int& mn, int& mx) {
  const int lane = threadIdx.x & 31;
  int a = INT_MAX, b = INT_MIN;
  for (int i = 0; i < n; ++i) {
    const int r = r0 + 32 * i + lane;
    if (r < S) {
      a = min(a, segb[r]);
      b = max(b, segb[r]);
    }
  }
  mn = warp_min_i(a);
  mx = warp_max_i(b);
}

// rows [r0, r0 + ROWS) of a [S, D] bf16 slice with row stride `ss` into a
// padded shared tile by cp.async, spread over a block of THREADS threads;
// rows past S are zero-filled
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  static_assert(ROWS * kChunks % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * kTileLd<D> + c,
               src + (in ? (long long)(r0 + r) * ss : 0) + c, in ? 16 : 0);
  }
}

// A fragment of the 16 x 16 block at (r0, c0) of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int r0,
                                       int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles, columns n0.. and n0 + 8.., depth c0..c0 + 15,
// from a tile that holds B transposed ([n][k], as K for Q . K^T): b[0..1]
// the first tile, b[2..3] the second
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4],
                                        const __nv_bfloat16* t, int n0,
                                        int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
                     ((lane >> 3) & 1) * 8);
}

// the same two n8 tiles from a tile that holds B itself ([k][n], as V for
// P . V or K for dS . K), depth rows k0..k0 + 15, read transposed by
// ldmatrix.trans
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* t, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma_bf16_16816(c0, a, b0);
  mma_bf16_16816(c1, a, b1);
}

// the 16-column chunk j of a 16 x 8N accumulator block (c[nt][i]: row
// gid + 8 (i / 2), column 8 nt + 2 tig + i % 2) as a bf16 A fragment
// (the flash kernels' blocks are 16 x 64, the paged kernel's 16 x 16)
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

}  // namespace ptt
