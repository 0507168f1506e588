// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (launched by `_flash_bwd`). The flash-2
// recurrence from the forward's saved lse: nothing of size S^2 is stored.
// Both kernels recompute S = (Q . K^T) * scale, P = exp(S - lse),
// dP = dO . V^T and dS = P * (dP - delta) * scale, with delta =
// rowsum(dO * O) handed in by the caller.
//
// The JAX split, which needs no atomics:
//  * dq:  one block per (batch * q-head, 64-row q tile) walks the K/V tiles
//         up to the diagonal; dq += dS . K;
//  * dkv: one block per (batch * kv-head, 64-key K tile) walks, for every
//         query head of its GQA group, the q tiles from the diagonal on;
//         dv += P^T . dO and dk += dS^T . Q.
// Both take the forward's conventions: causal diagonal stop, the segment
// mask plus the whole-tile skip through ptt::blocks_can_touch (the same
// predicate as the forward), ragged S masked here, head_dim 64 or 128.
// A masked (query, key) pair gets P = 0 by selection, never through exp of
// a sentinel, so a row whose lse came from an all-masked row (-inf, the
// forward's) gives no NaN. As in the forward, the keys' segment ids may
// come from a pointer of their own (kv_seg, defaulting to seg): every read
// of a key's id and every K-tile range go through it, in a compile-time
// variant (kSplit) launched only when kv_seg differs from seg.
//
// What bounds it: five products of 2 D flops per visible (query, key) pair
// and head (the dq kernel runs three, the dkv kernel four), against
// O(S D) bytes: at training lengths thousands of flops a byte, so
// operations.
//
// bf16 inputs (flash_bwd_*_kernel_mma): FlashAttention-2's design on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). Every tile is 64 rows;
// 4 warps each own 16 rows of the tile the block keeps (q rows in dq, keys
// in dkv) and all 64 columns of the streamed one.
//  * The kept tiles (Q, dO in dq; K, V in dkv) are loaded once as bf16;
//    the streamed ones (K, V in dq; Q, dO with their lse and delta in dkv)
//    come through a two-stage cp.async ring, the next tile in flight while
//    the current one is computed; rows past S are zero-filled. Shared rows
//    are padded by 16 bytes so every ldmatrix is free of bank conflicts:
//    6 tiles, 102 KB at D 128, two blocks an SM.
//  * dq computes S and dP with the streamed tile as the B operand; dkv
//    computes S^T = K . Q^T and dP^T = V . dO^T, so P^T and dS^T are rows
//    of the kept tile. Either way P and dS leave the fp32 accumulators
//    straight as bf16 A fragments of the second products (the m16n8
//    accumulator layout is the m16n8k16 A layout): no shared memory, no
//    shuffles. The B operands of the second products (K in dq, dO and Q in
//    dkv) are read by ldmatrix.trans from the same tiles.
//  * Numerics: S and dP are exact bf16 products summed in fp32; P (for dv)
//    and P * (dP - delta) (for dq, dk) are rounded to bf16 for the second
//    products, as the library's backward does, and dq, dk are scaled by
//    `scale` in fp32 at the end.
//  * q tiles are launched longest causal row first.
//
// fp32 inputs (flash_bwd_*_kernel<float>): the CUDA-core kernels, 8 warps
// each owning 8 rows of the kept tile with fp32 accumulators in registers
// (lane l owns head-dim columns l + 32j) and lane l owning one row of the
// 32-row streamed tile; P and dS reach the products by shuffles. The tensor
// cores would round fp32 to tf32.
//
// Layout: q, dO [B, S, Hq, D]; k, v [B, S, Hkv, D] (all contiguous, bf16 or
// fp32, bf16 16-byte aligned); lse, delta [B, Hq, S] fp32; dq [B, S, Hq, D]
// and dk, dv [B, S, Hkv, D] written in fp32.
#include "common.cuh"

namespace {

// ---- fp32: CUDA cores ----------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// dq: 64 q rows per block, 32 keys per streamed tile
constexpr int kDqBQ = 64;
constexpr int kDqBK = 32;
constexpr int kDqRows = kDqBQ / kWarps;
// dkv: 64 keys per block, 32 q rows per streamed tile
constexpr int kKvBK = 64;
constexpr int kKvBQ = 32;
constexpr int kKvKeys = kKvBK / kWarps;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kDqBQ + 2 * kDqBK) * (D + 4);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKvBK + 2 * kKvBQ) * (D + 4);
}

// rows [r0, r0 + n) of a [S, D] slice with row stride `ss` into padded
// shared rows (stride D + 4), times `mul`, zero past S
template <typename T, int D, int N>
__device__ __forceinline__ void stage_rows(const T* base, long long ss, int r0,
                                           int S, float mul, float* dst) {
  constexpr int DP = D + 4;
  for (int e = threadIdx.x * 8; e < N * D; e += kThreads * 8) {
    const int r = e / D, c = e % D;
    float t[8];
    if (r0 + r < S) {
      ptt::load8(base + (r0 + r) * ss + c, t);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = 0.f;
    }
    float4* p = reinterpret_cast<float4*>(dst + r * DP + c);
    p[0] = make_float4(t[0] * mul, t[1] * mul, t[2] * mul, t[3] * mul);
    p[1] = make_float4(t[4] * mul, t[5] * mul, t[6] * mul, t[7] * mul);
  }
}

template <typename T, int D, bool kSplit>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg,
                    const int* __restrict__ kv_seg, float* __restrict__ dq,
                    int S, int Hq, int Hkv, int causal, float scale) {
  constexpr int DP = D + 4;
  constexpr int CPL = D / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][DP], q * scale
  float* dos = qs + kDqBQ * DP;                 // [BQ][DP]
  float* ks = dos + kDqBQ * DP;                 // [BK][DP]
  float* vs = ks + kDqBK * DP;                  // [BK][DP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kDqBQ;
  const long long q_ss = (long long)Hq * D, k_ss = (long long)Hkv * D;
  const T* qb = q + (long long)b * S * q_ss + (long long)h * D;
  const T* dob = dout + (long long)b * S * q_ss + (long long)h * D;
  const T* kb = k + (long long)b * S * k_ss + (long long)hk * D;
  const T* vb = v + (long long)b * S * k_ss + (long long)hk * D;
  const float* lseb = lse + ((long long)b * Hq + h) * S;
  const float* deltab = delta + ((long long)b * Hq + h) * S;
  const int* segb = seg ? seg + (long long)b * S : nullptr;
  const int* kvb = kSplit ? kv_seg + (long long)b * S : segb;

  stage_rows<T, D, kDqBQ>(qb, q_ss, q0, S, scale, qs);
  stage_rows<T, D, kDqBQ>(dob, q_ss, q0, S, 1.f, dos);

  const int row0 = q0 + warp * kDqRows;
  float lse_r[kDqRows], delta_r[kDqRows];
  int qseg[kDqRows];
#pragma unroll
  for (int i = 0; i < kDqRows; ++i) {
    const int r = row0 + i;
    lse_r[i] = r < S ? lseb[r] : 0.f;
    delta_r[i] = r < S ? deltab[r] : 0.f;
    qseg[i] = (segb && r < S) ? segb[r] : -1;
  }
  int q_min = 0, q_max = 0;
  if (segb) ptt::seg_range(segb, q0, kDqBQ / 32, S, q_min, q_max);

  float acc[kDqRows][CPL];
#pragma unroll
  for (int i = 0; i < kDqRows; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;

  int n_kt = (S + kDqBK - 1) / kDqBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kDqBQ, S) + kDqBK - 1) / kDqBK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kDqBK;
    const int kpos = k0 + lane;
    const int kseg = (kvb && kpos < S) ? kvb[kpos] : 0;
    if (segb) {
      int mn, mx;
      ptt::seg_range(kvb, k0, 1, S, mn, mx);
      if (!ptt::blocks_can_touch(q_min, q_max, mn, mx)) continue;
    }
    __syncthreads();  // the previous tile's readers (and the staging) are done
    stage_rows<T, D, kDqBK>(kb, k_ss, k0, S, 1.f, ks);
    stage_rows<T, D, kDqBK>(vb, k_ss, k0, S, 1.f, vs);
    __syncthreads();

    float s[kDqRows], dp[kDqRows];
#pragma unroll
    for (int i = 0; i < kDqRows; ++i) s[i] = dp[i] = 0.f;
    const float* krow = ks + lane * DP;
    const float* vrow = vs + lane * DP;
    const float* qrow = qs + warp * kDqRows * DP;
    const float* drow = dos + warp * kDqRows * DP;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int i = 0; i < kDqRows; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + i * DP + d);
        const float4 dd = *reinterpret_cast<const float4*>(drow + i * DP + d);
        s[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        dp[i] += dd.x * vv.x + dd.y * vv.y + dd.z * vv.z + dd.w * vv.w;
      }
    }

#pragma unroll
    for (int i = 0; i < kDqRows; ++i) {
      const int qpos = row0 + i;
      const bool valid = qpos < S && kpos < S && (!causal || qpos >= kpos) &&
                         (!segb || qseg[i] == kseg);
      const float p = valid ? expf(s[i] - lse_r[i]) : 0.f;
      s[i] = p * (dp[i] - delta_r[i]) * scale;  // dS
    }

#pragma unroll 4
    for (int kk = 0; kk < kDqBK; ++kk) {
      float kv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) kv[j] = ks[kk * DP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kDqRows; ++i) {
        const float ds = __shfl_sync(0xffffffffu, s[i], kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i][j] += ds * kv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kDqRows; ++i) {
    const int r = row0 + i;
    if (r >= S) continue;
    float* out = dq + ((long long)b * S + r) * q_ss + (long long)h * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) out[lane + 32 * j] = acc[i][j];
  }
}

template <typename T, int D, bool kSplit>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg,
                     const int* __restrict__ kv_seg, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int Hq, int Hkv,
                     int causal, float scale) {
  constexpr int DP = D + 4;
  constexpr int CPL = D / 32;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][DP]
  float* vs = ks + kKvBK * DP;                  // [BK][DP]
  float* qs = vs + kKvBK * DP;                  // [BQ][DP], q * scale
  float* dos = qs + kKvBQ * DP;                 // [BQ][DP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = Hq / Hkv;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int k0 = blockIdx.x * kKvBK;
  const long long q_ss = (long long)Hq * D, k_ss = (long long)Hkv * D;
  const T* kb = k + (long long)b * S * k_ss + (long long)hk * D;
  const T* vb = v + (long long)b * S * k_ss + (long long)hk * D;
  const int* segb = seg ? seg + (long long)b * S : nullptr;
  const int* kvb = kSplit ? kv_seg + (long long)b * S : segb;

  stage_rows<T, D, kKvBK>(kb, k_ss, k0, S, 1.f, ks);
  stage_rows<T, D, kKvBK>(vb, k_ss, k0, S, 1.f, vs);

  const int key0 = k0 + warp * kKvKeys;  // this warp's first key
  int kseg[kKvKeys];
#pragma unroll
  for (int i = 0; i < kKvKeys; ++i)
    kseg[i] = (kvb && key0 + i < S) ? kvb[key0 + i] : 0;
  int k_min = 0, k_max = 0;
  if (segb) ptt::seg_range(kvb, k0, kKvBK / 32, S, k_min, k_max);

  float dka[kKvKeys][CPL], dva[kKvKeys][CPL];
#pragma unroll
  for (int i = 0; i < kKvKeys; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_qt = (S + kKvBQ - 1) / kKvBQ;
  // causal: a q tile whose last row is above this K tile's first key
  // contributes nothing
  const int first_qt = causal ? k0 / kKvBQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + (long long)b * S * q_ss + (long long)h * D;
    const T* dob = dout + (long long)b * S * q_ss + (long long)h * D;
    const float* lseb = lse + ((long long)b * Hq + h) * S;
    const float* deltab = delta + ((long long)b * Hq + h) * S;
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * kKvBQ;
      const int qpos = q0 + lane;
      const int qseg = (segb && qpos < S) ? segb[qpos] : -1;
      if (segb) {
        int mn, mx;
        ptt::seg_range(segb, q0, 1, S, mn, mx);
        if (!ptt::blocks_can_touch(mn, mx, k_min, k_max)) continue;
      }
      const float lse_l = qpos < S ? lseb[qpos] : 0.f;
      const float delta_l = qpos < S ? deltab[qpos] : 0.f;
      __syncthreads();  // the previous q tile's readers are done
      stage_rows<T, D, kKvBQ>(qb, q_ss, q0, S, scale, qs);
      stage_rows<T, D, kKvBQ>(dob, q_ss, q0, S, 1.f, dos);
      __syncthreads();

      float p[kKvKeys], ds[kKvKeys];
#pragma unroll
      for (int i = 0; i < kKvKeys; ++i) p[i] = ds[i] = 0.f;
      const float* qrow = qs + lane * DP;
      const float* drow = dos + lane * DP;
      const float* krow = ks + warp * kKvKeys * DP;
      const float* vrow = vs + warp * kKvKeys * DP;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + d);
        const float4 dd = *reinterpret_cast<const float4*>(drow + d);
#pragma unroll
        for (int i = 0; i < kKvKeys; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(krow + i * DP + d);
          const float4 vv = *reinterpret_cast<const float4*>(vrow + i * DP + d);
          p[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
          ds[i] += dd.x * vv.x + dd.y * vv.y + dd.z * vv.z + dd.w * vv.w;
        }
      }

#pragma unroll
      for (int i = 0; i < kKvKeys; ++i) {
        const int kpos = key0 + i;
        const bool valid = qpos < S && kpos < S &&
                           (!causal || qpos >= kpos) &&
                           (!segb || qseg == kseg[i]);
        p[i] = valid ? expf(p[i] - lse_l) : 0.f;
        // dS / scale: qs already carries the scale, so dk += this . qs
        ds[i] = p[i] * (ds[i] - delta_l);
      }

#pragma unroll 4
      for (int r = 0; r < kKvBQ; ++r) {
        float dov[CPL], qv[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          dov[j] = dos[r * DP + lane + 32 * j];
          qv[j] = qs[r * DP + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < kKvKeys; ++i) {
          const float pr = __shfl_sync(0xffffffffu, p[i], r);
          const float dr = __shfl_sync(0xffffffffu, ds[i], r);
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            dva[i][j] += pr * dov[j];
            dka[i][j] += dr * qv[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kKvKeys; ++i) {
    const int r = key0 + i;
    if (r >= S) continue;
    const long long off = ((long long)b * S + r) * k_ss + (long long)hk * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      dk[off + lane + 32 * j] = dka[i][j];
      dv[off + lane + 32 * j] = dva[i][j];
    }
  }
}

// ---- bf16: tensor cores ---------------------------------------------------
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of the kept tile each
constexpr int kMmaB = 64;         // rows of every tile: q rows and keys

template <int D>
struct MmaTile {
  static constexpr int kLd = ptt::kTileLd<D>;
  static constexpr int kElems = kMmaB * kLd;
};

// Q, dO and two stages of K, V (dq); K, V and two stages of Q, dO, lse and
// delta (dkv)
template <int D>
constexpr size_t mma_smem_bytes(bool dkv) {
  return sizeof(__nv_bfloat16) * 6 * MmaTile<D>::kElems +
         (dkv ? sizeof(float) * 2 * 2 * kMmaB : 0);
}

template <int D, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dq_kernel_mma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg,
                        const int* __restrict__ kv_seg,
                        float* __restrict__ dq, int S, int Hq, int Hkv,
                        int causal, float scale) {
  constexpr int LD = MmaTile<D>::kLd, TE = MmaTile<D>::kElems;
  constexpr int NT = D / 8;  // n8 tiles over the head dim
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* dos = qs + TE;
  __nv_bfloat16* ks = dos + TE;  // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * TE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  // the last q tile (the longest causal rows) is launched first
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kMmaB;
  const long long q_ss = (long long)Hq * D, k_ss = (long long)Hkv * D;
  const __nv_bfloat16* qb = q + (long long)b * S * q_ss + (long long)h * D;
  const __nv_bfloat16* dob = dout + (long long)b * S * q_ss + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * S * k_ss + (long long)hk * D;
  const __nv_bfloat16* vb = v + (long long)b * S * k_ss + (long long)hk * D;
  const float* lseb = lse + ((long long)b * Hq + h) * S;
  const float* deltab = delta + ((long long)b * Hq + h) * S;
  const int* segb = seg ? seg + (long long)b * S : nullptr;
  const int* kvb = kSplit ? kv_seg + (long long)b * S : segb;

  ptt::copy_tile<kMmaB, D, kMmaThreads>(qs, qb, q_ss, q0, S);
  ptt::copy_tile<kMmaB, D, kMmaThreads>(dos, dob, q_ss, q0, S);

  // this thread's accumulator rows: ra (i = 0, 1) and rb = ra + 8 (i = 2, 3)
  const int ra = q0 + 16 * warp + gid, rb = ra + 8;
  const float lse_a = ra < S ? lseb[ra] * ptt::kLog2e : 0.f;
  const float lse_b = rb < S ? lseb[rb] * ptt::kLog2e : 0.f;
  const float delta_a = ra < S ? deltab[ra] : 0.f;
  const float delta_b = rb < S ? deltab[rb] : 0.f;
  const int qseg_a = (segb && ra < S) ? segb[ra] : -1;
  const int qseg_b = (segb && rb < S) ? segb[rb] : -1;
  const float sl2 = scale * ptt::kLog2e;
  int q_min = 0, q_max = 0;
  if (segb) ptt::seg_range(segb, q0, 2, S, q_min, q_max);

  int n_kt = (S + kMmaB - 1) / kMmaB;
  if (causal) n_kt = min(n_kt, qt + 1);
  // the first K tile at or after t that the segment skip lets through
  auto next_tile = [&](int t) {
    for (; t < n_kt && segb; ++t) {
      int mn, mx;
      ptt::seg_range(kvb, t * kMmaB, 2, S, mn, mx);
      if (ptt::blocks_can_touch(q_min, q_max, mn, mx)) break;
    }
    return t;
  };
  auto issue = [&](int stage, int t) {
    ptt::copy_tile<kMmaB, D, kMmaThreads>(ks + stage * TE, kb, k_ss,
                                          t * kMmaB, S);
    ptt::copy_tile<kMmaB, D, kMmaThreads>(vs + stage * TE, vb, k_ss,
                                          t * kMmaB, S);
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  int cur = next_tile(0), stage = 0;
  if (cur < n_kt) issue(0, cur);
  ptt::cp_async_commit();  // with Q and dO
  while (cur < n_kt) {
    const int nxt = next_tile(cur + 1);
    ptt::cp_async_wait_all();
    __syncthreads();  // tile `cur` landed; the other stage's readers are done
    if (nxt < n_kt) issue(stage ^ 1, nxt);  // overlaps this tile's products
    ptt::cp_async_commit();
    const __nv_bfloat16* kst = ks + stage * TE;
    const __nv_bfloat16* vst = vs + stage * TE;
    const int k0 = cur * kMmaB;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ad[4];
      ptt::frag_a<LD>(aq, qs, 16 * warp, kk);
      ptt::frag_a<LD>(ad, dos, 16 * warp, kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ptt::frag_bt<LD>(bk, kst, 16 * np, kk);
        ptt::frag_bt<LD>(bv, vst, 16 * np, kk);
        ptt::mma_pair(s[2 * np], s[2 * np + 1], aq, bk);
        ptt::mma_pair(dp[2 * np], dp[2 * np + 1], ad, bv);
      }
    }

    // s <- P * (dP - delta); pairs are masked only on the diagonal and
    // ragged tiles and under segments
    const bool mask = (causal && k0 + kMmaB > q0) || k0 + kMmaB > S ||
                      q0 + kMmaB > S || segb != nullptr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hi = i >= 2;
        float p = exp2f(fmaf(s[nt][i], sl2, -(hi ? lse_b : lse_a)));
        if (mask) {
          const int qpos = hi ? rb : ra;
          const int kpos = k0 + 8 * nt + 2 * tig + (i & 1);
          const bool valid = qpos < S && kpos < S &&
                             (!causal || qpos >= kpos) &&
                             (!segb || (hi ? qseg_b : qseg_a) == kvb[kpos]);
          p = valid ? p : 0.f;
        }
        s[nt][i] = p * (dp[nt][i] - (hi ? delta_b : delta_a));
      }

    // dq += dS . K, 16 keys a step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      ptt::acc_to_a(a, s, j);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ptt::frag_b<LD>(bk, kst, 16 * j, 16 * np);
        ptt::mma_pair(acc[2 * np], acc[2 * np + 1], a, bk);
      }
    }
    cur = nxt;
    stage ^= 1;
  }
  ptt::cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const long long c = (long long)h * D + 8 * nt + 2 * tig;
    if (ra < S)
      *reinterpret_cast<float2*>(dq + ((long long)b * S + ra) * q_ss + c) =
          make_float2(acc[nt][0] * scale, acc[nt][1] * scale);
    if (rb < S)
      *reinterpret_cast<float2*>(dq + ((long long)b * S + rb) * q_ss + c) =
          make_float2(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

template <int D, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dkv_kernel_mma(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg,
                         const int* __restrict__ kv_seg,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int S, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = MmaTile<D>::kLd, TE = MmaTile<D>::kElems;
  constexpr int NT = D / 8;
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* vs = ks + TE;
  __nv_bfloat16* qs = vs + TE;       // [2][64][LD]
  __nv_bfloat16* dos = qs + 2 * TE;  // [2][64][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * TE);  // [2][64]
  float* deltas = lses + 2 * kMmaB;                      // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int group = Hq / Hkv;
  const int bh = blockIdx.x, b = bh / Hkv, hk = bh % Hkv;
  const int kt = blockIdx.y, k0 = kt * kMmaB;
  const long long q_ss = (long long)Hq * D, k_ss = (long long)Hkv * D;
  const int* segb = seg ? seg + (long long)b * S : nullptr;
  const int* kvb = kSplit ? kv_seg + (long long)b * S : segb;

  const long long kv_off = (long long)b * S * k_ss + (long long)hk * D;
  ptt::copy_tile<kMmaB, D, kMmaThreads>(ks, k + kv_off, k_ss, k0, S);
  ptt::copy_tile<kMmaB, D, kMmaThreads>(vs, v + kv_off, k_ss, k0, S);

  // this thread's accumulator rows (keys): ka (i = 0, 1), kb = ka + 8
  const int ka = k0 + 16 * warp + gid, kb = ka + 8;
  const int kseg_a = (kvb && ka < S) ? kvb[ka] : -1;
  const int kseg_b = (kvb && kb < S) ? kvb[kb] : -1;
  const float sl2 = scale * ptt::kLog2e;
  int k_min = 0, k_max = 0;
  if (segb) ptt::seg_range(kvb, k0, 2, S, k_min, k_max);

  // the walk: item j is q tile first_qt + j % per_head of the group's query
  // head j / per_head; causal q tiles above this K tile contribute nothing
  const int n_qt = (S + kMmaB - 1) / kMmaB;
  const int first_qt = causal ? kt : 0;
  const int per_head = n_qt - first_qt, n_items = group * per_head;
  auto next_item = [&](int j) {
    for (; j < n_items && segb; ++j) {
      int mn, mx;
      ptt::seg_range(segb, (first_qt + j % per_head) * kMmaB, 2, S, mn, mx);
      if (ptt::blocks_can_touch(mn, mx, k_min, k_max)) break;
    }
    return j;
  };
  auto issue = [&](int stage, int j) {
    const int h = hk * group + j / per_head;
    const int q0 = (first_qt + j % per_head) * kMmaB;
    const long long off = (long long)b * S * q_ss + (long long)h * D;
    ptt::copy_tile<kMmaB, D, kMmaThreads>(qs + stage * TE, q + off, q_ss,
                                          q0, S);
    ptt::copy_tile<kMmaB, D, kMmaThreads>(dos + stage * TE, dout + off,
                                          q_ss, q0, S);
    // one lse (threads 0-63) or delta (64-127) value a thread
    const int r = tid & (kMmaB - 1);
    const float* src = (tid < kMmaB ? lse : delta) +
                       ((long long)b * Hq + h) * S;
    float* dst = (tid < kMmaB ? lses : deltas) + stage * kMmaB + r;
    const bool in = q0 + r < S;
    ptt::cp_async4(dst, src + (in ? q0 + r : 0), in ? 4 : 0);
  };

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  int cur = next_item(0), stage = 0;
  if (cur < n_items) issue(0, cur);
  ptt::cp_async_commit();  // with K and V
  while (cur < n_items) {
    const int nxt = next_item(cur + 1);
    ptt::cp_async_wait_all();
    __syncthreads();  // item `cur` landed; the other stage's readers are done
    if (nxt < n_items) issue(stage ^ 1, nxt);  // overlaps this item's products
    ptt::cp_async_commit();
    const __nv_bfloat16* qst = qs + stage * TE;
    const __nv_bfloat16* dost = dos + stage * TE;
    const float* lst = lses + stage * kMmaB;
    const float* dlt = deltas + stage * kMmaB;
    const int q0 = (first_qt + cur % per_head) * kMmaB;

    // S^T = K . Q^T and dP^T = V . dO^T: rows are this warp's 16 keys
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ak[4], av[4];
      ptt::frag_a<LD>(ak, ks, 16 * warp, kk);
      ptt::frag_a<LD>(av, vs, 16 * warp, kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4], bd[4];
        ptt::frag_bt<LD>(bq, qst, 16 * np, kk);
        ptt::frag_bt<LD>(bd, dost, 16 * np, kk);
        ptt::mma_pair(st[2 * np], st[2 * np + 1], ak, bq);
        ptt::mma_pair(dpt[2 * np], dpt[2 * np + 1], av, bd);
      }
    }

    // st <- P^T, dpt <- (P * (dP - delta))^T; lse and delta are per query,
    // so per column
    const bool mask = (causal && q0 < k0 + kMmaB) || k0 + kMmaB > S ||
                      q0 + kMmaB > S || segb != nullptr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(lst + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool odd = i & 1;
        float p = exp2f(
            fmaf(st[nt][i], sl2, -(odd ? l2.y : l2.x) * ptt::kLog2e));
        if (mask) {
          const int qpos = q0 + c + odd;
          const int kpos = i >= 2 ? kb : ka;
          const int kseg = i >= 2 ? kseg_b : kseg_a;
          const bool valid = qpos < S && kpos < S &&
                             (!causal || qpos >= kpos) &&
                             (!segb || segb[qpos] == kseg);
          p = valid ? p : 0.f;
        }
        dpt[nt][i] = p * (dpt[nt][i] - (odd ? d2.y : d2.x));
        st[nt][i] = p;
      }
    }

    // dv += P^T . dO and dk += dS^T . Q, 16 queries a step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ap[4], ads[4];
      ptt::acc_to_a(ap, st, j);
      ptt::acc_to_a(ads, dpt, j);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bd[4], bq[4];
        ptt::frag_b<LD>(bd, dost, 16 * j, 16 * np);
        ptt::mma_pair(dva[2 * np], dva[2 * np + 1], ap, bd);
        ptt::frag_b<LD>(bq, qst, 16 * j, 16 * np);
        ptt::mma_pair(dka[2 * np], dka[2 * np + 1], ads, bq);
      }
    }
    cur = nxt;
    stage ^= 1;
  }
  ptt::cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const long long c = (long long)hk * D + 8 * nt + 2 * tig;
    if (ka < S) {
      const long long off = ((long long)b * S + ka) * k_ss + c;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[nt][0] * scale, dka[nt][1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[nt][0], dva[nt][1]);
    }
    if (kb < S) {
      const long long off = ((long long)b * S + kb) * k_ss + c;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[nt][2] * scale, dka[nt][3] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[nt][2], dva[nt][3]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* seg,
               const int* kv_seg, float* dq, float* dk, float* dv, int B,
               int S, int Hq, int Hkv, int causal, float scale,
               cudaStream_t stream) {
  // the keys' own ids only where they differ from the queries'
  const bool split = seg && kv_seg != seg;
  auto dq_kern = split ? flash_bwd_dq_kernel_mma<D, true>
                       : flash_bwd_dq_kernel_mma<D, false>;
  auto dkv_kern = split ? flash_bwd_dkv_kernel_mma<D, true>
                        : flash_bwd_dkv_kernel_mma<D, false>;
  const size_t dq_smem = mma_smem_bytes<D>(false);
  const size_t dkv_smem = mma_smem_bytes<D>(true);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dt = static_cast<const bf*>(dout);
  const int n_t = (S + kMmaB - 1) / kMmaB;
  // heads on x: the blocks of every head's longest tile start first
  dq_kern<<<dim3(B * Hq, n_t), kMmaThreads, dq_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, seg, kv_seg, dq, S, Hq, Hkv, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kern<<<dim3(B * Hkv, n_t), kMmaThreads, dkv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, seg, kv_seg, dk, dv, S, Hq, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* seg,
           const int* kv_seg, float* dq, float* dk, float* dv, int B, int S,
           int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const bool split = seg && kv_seg != seg;
  auto dq_kern = split ? flash_bwd_dq_kernel<T, D, true>
                       : flash_bwd_dq_kernel<T, D, false>;
  auto dkv_kern = split ? flash_bwd_dkv_kernel<T, D, true>
                        : flash_bwd_dkv_kernel<T, D, false>;
  const size_t dq_smem = dq_smem_bytes<D>(), dkv_smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  dim3 dq_grid((S + kDqBQ - 1) / kDqBQ, B * Hq);
  dq_kern<<<dq_grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, seg, kv_seg, dq, S, Hq, Hkv, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 dkv_grid((S + kKvBK - 1) / kKvBK, B * Hkv);
  dkv_kern<<<dkv_grid, kThreads, dkv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, seg, kv_seg, dk, dv, S, Hq, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): launches the dq kernel, then the
// dkv kernel, on `stream`. is_bf16: 1 bf16 inputs (the tensor-core
// kernels), 0 fp32 (the CUDA-core ones); outputs fp32. kv_seg: the keys'
// segment ids (null: seg's); ignored without seg.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* seg,
                             const int* kv_seg, float* dq, float* dk,
                             float* dv, int B, int S, int Hq,
                             int Hkv, int D, int causal, float scale,
                             int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_seg == nullptr) kv_seg = seg;
  if (is_bf16) {
    if (D == 64) return launch_mma<64>(q, k, v, dout, lse, delta, seg, kv_seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
    if (D == 128) return launch_mma<128>(q, k, v, dout, lse, delta, seg, kv_seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k, v, dout, lse, delta, seg, kv_seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
    if (D == 128) return launch<float, 128>(q, k, v, dout, lse, delta, seg, kv_seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
