// Paged decode attention for Hopper (sm_90a), CUDA cores, fp32 math.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `paged_decode_attention`). One block per
// (row, kv head) covers all T * group query rows of that kv head (GQA: K/V
// are never repeated). The block walks the row's context in 64-key chunks,
// reading each key's page id from the page table itself (what scalar
// prefetch did on the TPU), and keeps an online softmax in fp32.
//
// Split-K over the context: a row's keys are cut into kSplitKeys-long
// splits, one block each (grid Hkv x B x splits), so a 4095-token row is
// read by 8 blocks in parallel instead of one; each block leaves its
// unnormalized (acc, max, sum) in a workspace and `paged_combine_kernel`
// merges the splits. Splits past a row's context exit at once.
//
//  * query row r of the frame is t = r / group and sees keys
//    k_pos < len + t (T == 1 is plain decode: k_pos < len);
//  * a page is read only if ptt::blocks_can_touch(0, len + T - 2, first,
//    last) holds, the predicate the flash kernel shares, so the block
//    reads ceil((len + T - 1) / page_size) pages, not pages_per_seq;
//  * rows with len 0 write zeros.
//
// Layout: q/o [B, T, Hq, D] contiguous; pools [Hkv, P, page_size, D]
// contiguous; page_table [B, pages_per_seq] int32; lens [B] int32.
#include "common.cuh"

namespace {

constexpr int kCH = 64;  // keys per chunk
constexpr int kThreads = 256;
constexpr int kMaxRows = 64;  // T * group bound (shared memory)
constexpr int kSplitKeys = 512;  // keys per split-K block

int paged_splits(int pages_per_seq, int ps, int Tq) {
  const int keys = pages_per_seq * ps + Tq - 1;
  return keys > kSplitKeys ? (keys + kSplitKeys - 1) / kSplitKeys : 1;
}

template <int D>
size_t smem_bytes(int tg) {
  return sizeof(float) * (kCH * (D + 4) + kCH * D +
                          (size_t)tg * ((D + 4) + kCH + D + 3)) +
         sizeof(int) * kCH;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ lens, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int Tq, int Hq, int Hkv, int P,
                    int ps, int pages_per_seq, float scale) {
  constexpr int DP = D + 4;
  const int group = Hq / Hkv;
  const int TG = Tq * group;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kCH * DP;
  float* qs = vs + kCH * D;
  float* sc = qs + TG * DP;  // scores, then probabilities [TG, kCH]
  float* os = sc + TG * kCH;  // accumulators [TG, D]
  float* ms = os + TG * D;
  float* ls = ms + TG;
  float* al = ls + TG;
  int* pg = reinterpret_cast<int*>(al + TG);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int len = lens[b];
  const int n_keys = len > 0 ? len + Tq - 1 : 0;  // the last row's keys
  const int k_begin = split * kSplitKeys;
  const int k_end = min(n_keys, k_begin + kSplitKeys);
  // this split's slot of the workspace: acc [TG, D], (max, sum) [TG, 2]
  const long long slot = ((long long)b * Hkv + hk) * gridDim.z + split;
  float* wacc = ws_acc + slot * TG * D;
  float* wml = ws_ml + slot * TG * 2;

  if (k_begin >= k_end) {  // len-0 row, or a split past the context
    for (int r = tid; r < TG; r += kThreads) {
      wml[2 * r] = ptt::kNegInf;
      wml[2 * r + 1] = 0.f;
    }
    return;
  }

  for (int e = tid * 8; e < TG * D; e += kThreads * 8) {
    const int r = e / D, c = e % D;
    const int t = r / group, g = r % group;
    float t8[8];
    ptt::load8(q + (((long long)b * Tq + t) * Hq + hk * group + g) * D + c,
               t8);
#pragma unroll
    for (int i = 0; i < 8; ++i) qs[r * DP + c + i] = t8[i] * scale;
  }
  for (int e = tid; e < TG * D; e += kThreads) os[e] = 0.f;
  for (int r = tid; r < TG; r += kThreads) {
    ms[r] = ptt::kNegInf;
    ls[r] = 0.f;
  }

  const int* ptb = pt + (long long)b * pages_per_seq;
  for (int c0 = k_begin; c0 < k_end; c0 += kCH) {
    __syncthreads();  // previous chunk fully consumed
    if (tid < kCH) {
      const int pos = c0 + tid, page = pos / ps, first = page * ps;
      pg[tid] = (pos < k_end && page < pages_per_seq &&
                 ptt::blocks_can_touch(0, n_keys - 1, first, first + ps - 1))
                    ? ptb[page]
                    : -1;
    }
    __syncthreads();
    for (int e = tid * 8; e < kCH * D; e += kThreads * 8) {
      const int r = e / D, c = e % D, pos = c0 + r;
      float tk[8], tv[8];
      if (pg[r] >= 0) {
        const long long off = (((long long)hk * P + pg[r]) * ps + pos % ps) * D + c;
        ptt::load8(kp + off, tk);
        ptt::load8(vp + off, tv);
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

    for (int p = tid; p < TG * kCH; p += kThreads) {
      const int r = p / kCH, j = p % kCH;
      const float* qr = qs + r * DP;
      const float* kr = ks + j * DP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
      sc[p] = s;
    }
    __syncthreads();

    for (int r = warp; r < TG; r += kThreads / 32) {
      const int limit = len + r / group;  // keys < len + frame index
      float s0 = sc[r * kCH + lane], s1 = sc[r * kCH + 32 + lane];
      const bool v0 = c0 + lane < limit, v1 = c0 + 32 + lane < limit;
      const float m_old = ms[r];
      const float m_new = fmaxf(
          m_old, ptt::warp_max(fmaxf(v0 ? s0 : ptt::kNegInf, v1 ? s1 : ptt::kNegInf)));
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      sc[r * kCH + lane] = p0;
      sc[r * kCH + 32 + lane] = p1;
      const float sum = ptt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
        al[r] = alpha;
      }
    }
    __syncthreads();

    for (int e = tid; e < TG * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const float* pr = sc + r * kCH;
      float a = os[e] * al[r];
#pragma unroll 8
      for (int j = 0; j < kCH; ++j) a += pr[j] * vs[j * D + c];
      os[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < TG * D; e += kThreads) wacc[e] = os[e];
  for (int r = tid; r < TG; r += kThreads) {
    wml[2 * r] = ms[r];
    wml[2 * r + 1] = ls[r];
  }
}

// Merges the splits of one (row, kv head): out = sum_s acc_s e^(m_s - M) /
// sum_s l_s e^(m_s - M) with M the largest split max. Rows with len 0
// write zeros; empty splits (sum 0) are skipped.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_ml,
                     const int* __restrict__ lens, T* __restrict__ o, int Tq,
                     int Hq, int Hkv, int n_splits) {
  const int group = Hq / Hkv;
  const int TG = Tq * group;
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long slot0 = ((long long)b * Hkv + hk) * n_splits;
  const bool live = lens[b] > 0;
  for (int e = threadIdx.x; e < TG * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int t = r / group, g = r % group;
    float res = 0.f;
    if (live) {
      float mx = ptt::kNegInf;
      for (int s = 0; s < n_splits; ++s) {
        const float* ml = ws_ml + (slot0 + s) * TG * 2 + 2 * r;
        if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
      }
      float num = 0.f, den = 0.f;
      for (int s = 0; s < n_splits; ++s) {
        const float* ml = ws_ml + (slot0 + s) * TG * 2 + 2 * r;
        if (ml[1] > 0.f) {
          const float w = expf(ml[0] - mx);
          den += ml[1] * w;
          num += ws_acc[(slot0 + s) * TG * D + e] * w;
        }
      }
      res = num / fmaxf(den, 1e-30f);
    }
    ptt::store(res, o + (((long long)b * Tq + t) * Hq + hk * group + g) * D + c);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* lens, void* o, float* ws_acc, float* ws_ml, int B,
           int Tq, int Hq, int Hkv, int P, int ps, int pages_per_seq,
           float scale, cudaStream_t stream) {
  const int tg = Tq * (Hq / Hkv);
  if (tg > kMaxRows) return (int)cudaErrorInvalidValue;
  auto kern = paged_decode_kernel<T, D>;
  const size_t smem = smem_bytes<D>(tg);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_splits = paged_splits(pages_per_seq, ps, Tq);
  kern<<<dim3(Hkv, B, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, ws_acc, ws_ml, Tq, Hq, Hkv, P, ps,
      pages_per_seq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T, D><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      ws_acc, ws_ml, lens, static_cast<T*>(o), Tq, Hq, Hkv, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Split-K blocks per (row, kv head) for a page table of `pages_per_seq`
// pages and a T-query frame; the wrapper sizes the workspace with it.
extern "C" int ptt_paged_splits(int pages_per_seq, int ps, int Tq) {
  return paged_splits(pages_per_seq, ps, Tq);
}

// Plain C entry point (bound with ctypes). is_bf16: 1 bf16, 0 fp32.
// ws_acc: [B, Hkv, splits, T*group, D] fp32 and ws_ml: [B, Hkv, splits,
// T*group, 2] fp32 scratch. Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int ptt_paged_decode(const void* q, const void* k, const void* v,
                                const int* page_table, const int* lens,
                                void* o, float* ws_acc, float* ws_ml, int B,
                                int Tq, int Hq, int Hkv, int P, int ps,
                                int pages_per_seq, int D, float scale,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch<__nv_bfloat16, 64>(q, k, v, page_table, lens, o, ws_acc, ws_ml, B, Tq, Hq, Hkv, P, ps, pages_per_seq, scale, st);
    if (D == 128) return launch<__nv_bfloat16, 128>(q, k, v, page_table, lens, o, ws_acc, ws_ml, B, Tq, Hq, Hkv, P, ps, pages_per_seq, scale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k, v, page_table, lens, o, ws_acc, ws_ml, B, Tq, Hq, Hkv, P, ps, pages_per_seq, scale, st);
    if (D == 128) return launch<float, 128>(q, k, v, page_table, lens, o, ws_acc, ws_ml, B, Tq, Hq, Hkv, P, ps, pages_per_seq, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
