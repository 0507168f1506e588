// Flash-attention backward for Hopper (sm_90a), CUDA cores, fp32 math.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (launched by `_flash_bwd`). The flash-2
// recurrence from the forward's saved lse: nothing of size S^2 is stored.
// In both kernels S = (q * scale) . k is recomputed exactly as the forward
// computed it, P = exp(S - lse), dP = dO . V^T, dS = P * (dP - delta) * scale
// with delta = rowsum(dO * O) handed in by the caller.
//
// The JAX split, which needs no atomics:
//  * dq:  one block per (batch * q-head, 64-row q tile) walks the 32-key
//         K/V tiles up to the diagonal; dq += dS . K;
//  * dkv: one block per (batch * kv-head, 64-key K tile) walks, for every
//         query head of its GQA group, the 32-row q tiles from the diagonal
//         on; dv += P^T . dO and dk += dS^T . Q.
// Both take the forward's conventions: causal diagonal stop, the segment
// mask plus the whole-tile skip through ptt::blocks_can_touch (the same
// predicate as the forward), ragged S masked here, head_dim 64 or 128.
// A masked (query, key) pair gets P = 0 by selection, never through exp of
// a sentinel, so a row whose lse came from an all-masked row gives no NaN.
//
// Layout: q, dO [B, S, Hq, D]; k, v [B, S, Hkv, D] (all contiguous, bf16 or
// fp32); lse, delta [B, Hq, S] fp32; dq [B, S, Hq, D] and dk, dv
// [B, S, Hkv, D] written in fp32.
//
// Thread maps follow the forward: 8 warps, each owning 8 rows of the tile
// the block keeps (q rows in dq, keys in dkv) with the fp32 accumulators in
// registers (lane l owns head-dim columns l + 32j), and lane l owning one
// row of the streamed tile for the scores. P and dS never go through shared
// memory: the products broadcast them from the owning lane by shuffles.
#include "common.cuh"

namespace {

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

// the segment-id range of rows [r0, r0 + 32 * n) (n = 1 or 2), reduced over
// the warp so every warp of the block reaches the same skip decision
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
  mn = ptt::warp_min_i(a);
  mx = ptt::warp_max_i(b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, float* __restrict__ dq, int S,
                    int Hq, int Hkv, int causal, float scale) {
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
  if (segb) seg_range(segb, q0, kDqBQ / 32, S, q_min, q_max);

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
    const int kseg = (segb && kpos < S) ? segb[kpos] : 0;
    if (segb) {
      int mn, mx;
      seg_range(segb, k0, 1, S, mn, mx);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, float* __restrict__ dk,
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

  stage_rows<T, D, kKvBK>(kb, k_ss, k0, S, 1.f, ks);
  stage_rows<T, D, kKvBK>(vb, k_ss, k0, S, 1.f, vs);

  const int key0 = k0 + warp * kKvKeys;  // this warp's first key
  int kseg[kKvKeys];
#pragma unroll
  for (int i = 0; i < kKvKeys; ++i)
    kseg[i] = (segb && key0 + i < S) ? segb[key0 + i] : 0;
  int k_min = 0, k_max = 0;
  if (segb) seg_range(segb, k0, kKvBK / 32, S, k_min, k_max);

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
        seg_range(segb, q0, 1, S, mn, mx);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* seg, float* dq,
           float* dk, float* dv, int B, int S, int Hq, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  auto dq_kern = flash_bwd_dq_kernel<T, D>;
  auto dkv_kern = flash_bwd_dkv_kernel<T, D>;
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
      qt, kt, vt, dt, lse, delta, seg, dq, S, Hq, Hkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 dkv_grid((S + kKvBK - 1) / kKvBK, B * Hkv);
  dkv_kern<<<dkv_grid, kThreads, dkv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, seg, dk, dv, S, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): launches the dq kernel, then the
// dkv kernel, on `stream`. is_bf16: 1 bf16, 0 fp32 inputs; outputs fp32.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* seg, float* dq,
                             float* dk, float* dv, int B, int S, int Hq,
                             int Hkv, int D, int causal, float scale,
                             int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
    if (D == 128) return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k, v, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
    if (D == 128) return launch<float, 128>(q, k, v, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
