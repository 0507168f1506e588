// Flash-attention forward for Hopper (sm_90a), CUDA cores, fp32 math, and
// the block-visit counter.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd`) and `_visit_kernel` (launched by
// `segment_block_visit_counts`). One block per (batch * q-head,
// 64-row q tile); 32-key K/V tiles stream through shared memory with an
// online softmax (fp32 running max and denominator). Writes o and lse.
//
//  * causal: K tiles past the q tile's diagonal are never loaded;
//  * GQA: q head h reads kv head h / group, K/V are never repeated;
//  * segment_ids: q_seg != k_seg is masked inside a tile, and a whole K
//    tile whose segment range cannot touch the q tile's is skipped through
//    ptt::blocks_can_touch (the predicate the paged kernel shares);
//  * ragged S: rows and keys past S are masked here, S need not divide
//    the tile sizes.
//  * flash_visit_kernel counts, per (row, block_q rows), the K blocks that
//    ptt::blocks_can_touch and the causal bound admit, the forward's own
//    skip rules; at block_q 64, block_k 32 it counts the tiles this kernel
//    visits.
//
// Layout: q [B, S, Hq, D], k/v [B, S, Hkv, D] given by element strides
// (head_dim contiguous), o [B, S, Hq, D] contiguous, lse [B, Hq, S] fp32.
//
// Thread map: 8 warps; warp w owns q rows 8w..8w+7 of the tile, lane l owns
// key l of the K tile for the scores and head-dim columns l + 32j of the
// output. P never goes through shared memory: the PV product broadcasts
// each probability from the lane that owns its key with a shuffle.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kRows = kBQ / (kThreads / 32);  // q rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 4) + kBK * (D + 4) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ lse, int S, int Hq,
                 int group, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, int causal,
                 float scale) {
  constexpr int DP = D + 4;  // padded row: float4 reads stay conflict-free
  constexpr int CPL = D / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * DP;
  float* vs = ks + kBK * DP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int* segb = seg ? seg + (long long)b * S : nullptr;

  for (int e = tid * 8; e < kBQ * D; e += kThreads * 8) {
    const int r = e / D, c = e % D;
    float t[8];
    if (q0 + r < S) {
      ptt::load8(qb + (q0 + r) * q_ss + c, t);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(qs + r * DP + c);
    dst[0] = make_float4(t[0] * scale, t[1] * scale, t[2] * scale, t[3] * scale);
    dst[1] = make_float4(t[4] * scale, t[5] * scale, t[6] * scale, t[7] * scale);
  }

  const int row0 = q0 + warp * kRows;
  int qseg[kRows];
  int q_min = 0, q_max = 0;
  if (segb) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) qseg[i] = row0 + i < S ? segb[row0 + i] : -1;
    // the q tile's segment range, computed by every warp alike so the skip
    // decision below is uniform across the block
    const int a = q0 + lane, c = q0 + 32 + lane;
    int mn = INT_MAX, mx = INT_MIN;
    if (a < S) { mn = min(mn, segb[a]); mx = max(mx, segb[a]); }
    if (c < S && 32 + lane < kBQ) { mn = min(mn, segb[c]); mx = max(mx, segb[c]); }
    q_min = ptt::warp_min_i(mn);
    q_max = ptt::warp_max_i(mx);
  }

  float m[kRows], l[kRows], acc[kRows][CPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = ptt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, S) + kBK - 1) / kBK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int kpos = k0 + lane;
    const int kseg = (segb && kpos < S) ? segb[kpos] : 0;
    if (segb) {
      const int mn = ptt::warp_min_i(kpos < S ? kseg : INT_MAX);
      const int mx = ptt::warp_max_i(kpos < S ? kseg : INT_MIN);
      if (!ptt::blocks_can_touch(q_min, q_max, mn, mx)) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid * 8; e < kBK * D; e += kThreads * 8) {
      const int r = e / D, c = e % D;
      float tk[8], tv[8];
      if (k0 + r < S) {
        ptt::load8(kb + (k0 + r) * k_ss + c, tk);
        ptt::load8(vb + (k0 + r) * v_ss + c, tv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) tk[i] = tv[i] = 0.f;
      }
      float4* dk = reinterpret_cast<float4*>(ks + r * DP + c);
      float4* dv = reinterpret_cast<float4*>(vs + r * D + c);
      dk[0] = make_float4(tk[0], tk[1], tk[2], tk[3]);
      dk[1] = make_float4(tk[4], tk[5], tk[6], tk[7]);
      dv[0] = make_float4(tv[0], tv[1], tv[2], tv[3]);
      dv[1] = make_float4(tv[4], tv[5], tv[6], tv[7]);
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float* krow = ks + lane * DP;
    const float* qrow = qs + warp * kRows * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + i * DP + d);
        s[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = row0 + i;
      const bool valid = kpos < S && (!causal || qpos >= kpos) &&
                         (!segb || qseg[i] == kseg);
      const float m_new = fmaxf(m[i], ptt::warp_max(valid ? s[i] : ptt::kNegInf));
      const float p = valid ? expf(s[i] - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + ptt::warp_sum(p);
      m[i] = m_new;
      s[i] = p;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] *= alpha;
    }

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) vv[j] = vs[kk * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i], kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + i;
    if (r >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* orow = o + (((long long)b * S + r) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) ptt::store(acc[i][j] * inv, orow + lane + 32 * j);
    if (lane == 0) lse[((long long)b * Hq + h) * S + r] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* o, float* lse, int B, int S, int Hq, int Hkv,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(o), lse, S, Hq,
      Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale);
  return (int)cudaGetLastError();
}

// One warp a (q block, row): the block's segment-id range, then the count
// of K blocks kb < last whose range can touch it, last = ceil((qi + 1) bq /
// bk) when causal (the JAX kernel's bound), S / bk otherwise.
__global__ void flash_visit_kernel(const int* __restrict__ seg,
                                   int* __restrict__ counts, int S, int bq,
                                   int bk, int causal) {
  const int qi = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int* row = seg + (long long)b * S;
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < bq; r += 32) {
    const int s = row[qi * bq + r];
    qmin = min(qmin, s);
    qmax = max(qmax, s);
  }
  qmin = ptt::warp_min_i(qmin);
  qmax = ptt::warp_max_i(qmax);
  const int last = causal ? ((qi + 1) * bq + bk - 1) / bk : S / bk;
  int n = 0;
  for (int kb = 0; kb < last; ++kb) {
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int r = lane; r < bk; r += 32) {
      const int s = row[kb * bk + r];
      kmin = min(kmin, s);
      kmax = max(kmax, s);
    }
    kmin = ptt::warp_min_i(kmin);
    kmax = ptt::warp_max_i(kmax);
    n += ptt::blocks_can_touch(qmin, qmax, kmin, kmax) ? 1 : 0;
  }
  if (lane == 0) counts[(long long)b * gridDim.x + qi] = n;
}

}  // namespace

// Block-visit counter: counts [B, S / bq] int32 from segment ids [B, S]
// int32; S must be a multiple of bq and bk (the wrapper checks).
extern "C" int ptt_flash_visit(const int* seg, int* counts, int B, int S,
                               int bq, int bk, int causal, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (bq <= 0 || bk <= 0 || S % bq || S % bk) return (int)cudaErrorInvalidValue;
  flash_visit_kernel<<<dim3(S / bq, B), 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(seg, counts, S, bq,
                                                            bk, causal);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes). strides: 9 element strides,
// (batch, seq, head) for q, k, v in that order. is_bf16: 1 bf16, 0 fp32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const int* seg, void* o, float* lse, int B,
                             int S, int Hq, int Hkv, int D,
                             const long long* strides, int causal,
                             float scale, int is_bf16, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch<__nv_bfloat16, 64>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
    if (D == 128) return launch<__nv_bfloat16, 128>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
    if (D == 128) return launch<float, 128>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
