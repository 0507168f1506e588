// Paged decode attention for Hopper (sm_90a) and the page-visit counter:
// bf16 q on the tensor cores, fed by bulk copies on an mbarrier ring; fp32
// q, and bf16 q at page sizes that are not multiples of 8, on the CUDA
// cores.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `paged_decode_attention`), its quantized
// branch included, and `_visit_kernel` (launched by `page_visit_counts`).
// What the decode computes, for both kernels below:
//
//  * query row r = (t, g) of the T * group frame rows of a kv head sees
//    keys k_pos < len + t (T == 1 is plain decode: k_pos < len); GQA: the
//    group's rows share the kv head's pages, K/V are never repeated;
//  * only pages that ptt::blocks_can_touch(0, len + T - 2, first, last)
//    admits are read, the predicate the flash kernels share, so a row
//    reads ceil((len + T - 1) / page_size) pages, not pages_per_seq;
//  * rows with len 0 write zeros;
//  * quantized pools (int8 or fp8-e4m3 codes with fp32 per-slot-per-head
//    scales [Hkv, P, page_size]) are dequantized on chip: nothing
//    dequantized is ever written to device memory;
//  * split-K: a row's keys are cut into splits, one block each; a block
//    leaves its unnormalized (acc, max, sum) in a workspace and
//    `paged_combine_kernel` merges the splits in split order.
//
// What bounds it: bytes. A decode step reads every live K/V row once and
// does about one flop per byte, far below the ~295 flops a byte where the
// tensor cores would become the limit.
//
// bf16 q (paged_decode_kernel_mma): a work item is one 8-row tile of the
// frame rows of one (row, kv head) over one split of kMmaSplitKeys keys,
// cut into 16-key stages. Only items that hold keys are numbered: by row,
// then split, kv head and row tile (fastest), so the 1-8 tiles of a GQA
// head read the same pages close in time and L2 serves the repeats. The
// kernel is persistent: as many blocks as fit on an SM (two for bf16 at D
// 128, three for codes), each one producer warp and four consumer warps,
// take items w, w + grid, ..., so no block pays a launch, a ring fill or a
// shared-memory reservation for an empty split, one item's merge overlaps
// the next item's copies, and a row's splits spread over consecutive
// blocks, so a long row among short ones leaves every block near the mean
// work (numbering the empty splits too, a block's share would follow where
// its stride falls on them).
//  * The ring: 8 stages (64 KB of bf16 at D 128), each with a "full" and
//    an "empty" mbarrier (sm90.cuh), kept across items. The
//    producer warp reads the page ids from the page table itself (what
//    scalar prefetch did on the TPU), the next item's while this item's
//    stages go out, and fills a stage with 1-D bulk copies (cp.async.bulk,
//    no tensor map) of the K and V rows as they lie in the pool, in its
//    own dtype: one copy a tensor when the stage lies in one page, else
//    one for each 8-key half (page sizes 8, 24, ...; a multiple of 8 keeps
//    a half in one page). Few large copies: the copy engine's cost is by
//    request, so key rows copied one by one (256 bytes a request) make it,
//    not the bytes, the limit. A quantized stage's 16 + 16 fp32 scales
//    ride the same barrier, in 8-key pieces of 32 bytes (two copies a
//    stage in one page). Keys past the last query's key range are never
//    copied, and a stage holding none is never issued.
//  * A consumer lays its stage out into its own padded bf16 tile ([16][D +
//    8] for K and for V, rows 16 bytes apart, so ldmatrix reads it free of
//    bank conflicts: rows of 128 or 256 bytes as copied would put a
//    fragment's 8 rows on the same banks), and releases the ring stage at
//    once. bf16 rows are copied as they are; int8 and e4m3 codes are exact
//    in bf16 and are widened there (int8 by the fp32 magic-number trick,
//    e4m3 through the hardware's e4m3x2 -> f16x2 conversion).
//  * Consumer warp w takes stages w, w + 4, ... of each item and keeps its
//    own online softmax (m, l, acc) for the item's 8 query rows, on
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the keys as the 16
//    rows: S^T = K . q^T (K by ldmatrix, q^T as B fragments held for the
//    item), then o^T += V^T . P^T (V^T by ldmatrix.trans; P^T's 8 x 8
//    blocks, packed to bf16 from the S^T accumulators, become its B
//    fragments by movmatrix.trans). Decode's 1-8 frame rows then fill the
//    n8 side instead of padding 15 of 16 rows: half the products and half
//    the accumulators (32 a thread at D 128) of a query-row-major tile,
//    which leaves codes room for three blocks an SM; a query row's 16 keys
//    lie in the 8 lanes of one quad position, so its max takes three
//    shuffles.
//  * Scales enter in fp32 on the products' results: s_j = (q . c_j) ks_j,
//    exp2 with scale * log2(e) folded in; P . V takes p_j vs_j against the
//    codes as two bf16 pieces, hi = bf16(p_j vs_j) and lo = bf16(p_j vs_j
//    - hi), two products (one piece would add up to 2^-9 of a value to the
//    output's own bf16 rounding, past the quantized pools' rule); l sums
//    the unscaled fp32 p_j. bf16 pools round P to bf16 once, as flash does.
//  * Slots past a row's keys (the tail of the last page, never-written
//    bytes) may hold NaN patterns: their scores get p = 0 by selection,
//    and the tile rows of keys the ring never copied are written as zeros,
//    since 0 * NaN is NaN; a dead slot's scale only ever meets a selection.
//  * At the end of an item the four warps merge through shared memory in
//    warp order and write the split's partial; the schedule is static and
//    no atomics are used, so a call is deterministic. Shared memory does
//    not depend on T * group, so one opt-in a process serves every call.
//
// fp32 q, and bf16 q at a page size that is not a multiple of 8
// (paged_decode_kernel, the CUDA cores, fp32 math): one block per (row, kv
// head, 512-key split) covers all T * group rows, walking 64-key chunks
// staged as fp32 tiles (bf16 rows and codes widened, codes scaled there),
// at any page size. The wrapper picks the kernel (its route) and passes it
// to ptt_paged_splits and ptt_paged_decode alike.
//
// Layout: q/o [B, T, Hq, D] contiguous; pools [Hkv, P, page_size, D]
// contiguous; page_table [B, pages_per_seq] int32; lens [B] int32.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

// ---- fp32 q, and bf16 q at any page size: CUDA cores -----------------------
constexpr int kCH = 64;  // keys per chunk
constexpr int kThreads = 256;
constexpr int kMaxRows = 64;  // T * group bound (shared memory)
constexpr int kSplitKeys = 512;  // keys per split-K block

// fp8-e4m3 code storage (the bits of torch.float8_e4m3fn)
struct e4m3 {
  uint8_t bits;
};

// How a pool's values reach fp32: kVec values a load, and whether they are
// codes to multiply by their key's scale.
template <typename KV>
struct KVLoad;

template <>
struct KVLoad<float> {
  static constexpr int kVec = 8;
  static constexpr bool kQuant = false;
  __device__ static void load(const float* p, float* o) { ptt::load8(p, o); }
};

template <>
struct KVLoad<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr bool kQuant = false;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    ptt::load8(p, o);
  }
};

template <>
struct KVLoad<int8_t> {
  static constexpr int kVec = 16;
  static constexpr bool kQuant = true;
  __device__ static void load(const int8_t* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)c[i];
  }
};

template <>
struct KVLoad<e4m3> {
  static constexpr int kVec = 16;
  static constexpr bool kQuant = true;
  __device__ static void load(const e4m3* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8x2_storage_t* c =
        reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // e4m3 values are exact in fp16: low byte -> .x, high byte -> .y
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(c[i], __NV_E4M3);
      const float2 f = __half22float2(__half2(r));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

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

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ pt,
                    const int* __restrict__ lens, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int Tq, int Hq, int Hkv, int P,
                    int ps, int pages_per_seq, float scale) {
  constexpr int DP = D + 4;
  constexpr int V = KVLoad<KV>::kVec;
  constexpr bool kQuant = KVLoad<KV>::kQuant;
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
    for (int e = tid * V; e < kCH * D; e += kThreads * V) {
      const int r = e / D, c = e % D, pos = c0 + r;
      float tk[V], tv[V];
      if (pg[r] >= 0) {
        const long long key = ((long long)hk * P + pg[r]) * ps + pos % ps;
        KVLoad<KV>::load(kp + key * D + c, tk);
        KVLoad<KV>::load(vp + key * D + c, tv);
        if constexpr (kQuant) {
          // the key's scales load beside its codes (the D / V threads of
          // a key read the same word), not before them
          const float a = k_scales[key], b = v_scales[key];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            tk[i] *= a;
            tv[i] *= b;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) tk[i] = tv[i] = 0.f;
      }
      float4* dk = reinterpret_cast<float4*>(ks + r * DP + c);
      float4* dv = reinterpret_cast<float4*>(vs + r * D + c);
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        dk[i] = make_float4(tk[4 * i], tk[4 * i + 1], tk[4 * i + 2], tk[4 * i + 3]);
        dv[i] = make_float4(tv[4 * i], tv[4 * i + 1], tv[4 * i + 2], tv[4 * i + 3]);
      }
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

template <typename T, typename KV, int D>
int launch(const void* q, const void* k, const void* v, const float* ksc,
           const float* vsc, const int* pt, const int* lens, void* o,
           float* ws_acc, float* ws_ml, int B, int Tq, int Hq, int Hkv, int P,
           int ps, int pages_per_seq, float scale, int device,
           cudaStream_t stream) {
  const int tg = Tq * (Hq / Hkv);
  if (tg > kMaxRows) return (int)cudaErrorInvalidValue;
  if (KVLoad<KV>::kQuant && (ksc == nullptr || vsc == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kern = paged_decode_kernel<T, KV, D>;
  // the opt-in covers the largest frame, so it runs once a process
  cudaError_t err = ptt::sm90_host::opt_in_smem(
      kern, device, (int)smem_bytes<D>(kMaxRows));
  if (err != cudaSuccess) return (int)err;
  const int n_splits = paged_splits(pages_per_seq, ps, Tq);
  kern<<<dim3(Hkv, B, n_splits), kThreads, smem_bytes<D>(tg), stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ksc, vsc, pt, lens, ws_acc, ws_ml, Tq, Hq,
      Hkv, P, ps, pages_per_seq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T, D><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      ws_acc, ws_ml, lens, static_cast<T*>(o), Tq, Hq, Hkv, n_splits);
  return (int)cudaGetLastError();
}

// ---- bf16 q: tensor cores, bulk copies on an mbarrier ring ----------------
namespace sm90 = ptt::sm90;

constexpr int kStageKeys = 16;      // keys of a ring stage
constexpr int kMmaSplitKeys = 256;  // keys of a split: 16 stages
constexpr int kConsumers = 4;       // consumer warps
constexpr int kMmaThreads = 32 * (kConsumers + 1);
constexpr int kRowTile = 8;         // frame rows of a work item
constexpr int kSplitPages = kMmaSplitKeys / 8 + 1;  // pages a split touches

int mma_splits(int pages_per_seq, int ps) {
  const int keys = pages_per_seq * ps;
  return keys > kMmaSplitKeys ? (keys + kMmaSplitKeys - 1) / kMmaSplitKeys
                              : 1;
}

// 16 int8 codes -> 16 bf16 values (exact): code + 128 as the low byte of
// the fp32 2^23 + (code + 128), minus 2^23 + 128
__device__ __forceinline__ void widen16(const uint4& u, const int8_t*,
                                        uint32_t (&o)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | j)) -
             8388736.f;
    o[2 * i] = ptt::pack_bf16(f[0], f[1]);
    o[2 * i + 1] = ptt::pack_bf16(f[2], f[3]);
  }
}

// 16 e4m3 codes -> 16 bf16 values (exact): e4m3x2 -> f16x2 in hardware
__device__ __forceinline__ void widen16(const uint4& u, const e4m3*,
                                        uint32_t (&o)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)(w[i] >> (16 * h)), __NV_E4M3);
      const float2 f = __half22float2(__half2(r));
      o[2 * i + h] = ptt::pack_bf16(f.x, f.y);
    }
}

// Shared memory of one block (bytes): the ring (a stage is 16 K rows and
// 16 V rows as they lie in the pool, and for codes 16 + 16 fp32 scales),
// its mbarriers (full, then empty), and each consumer warp's padded bf16
// tile of a stage's K and V, which the merge reuses for each warp's scaled
// accumulators once an item's products are done; then each warp's (m, l)
// a row.
template <typename KV, int D>
struct MmaSmem {
  // codes (widened to bf16, scaled) or bf16 values
  static constexpr bool kQuant = !std::is_same<KV, __nv_bfloat16>::value;
  static constexpr int kLd = ptt::kTileLd<D>;  // bf16 row stride of a tile
  static constexpr int kCopy = D * (int)sizeof(KV);  // bytes a key row
  static constexpr int kTensor = kStageKeys * kCopy;
  static constexpr int kStage = 2 * kTensor + (kQuant ? 2 * 4 * kStageKeys : 0);
  static constexpr int kStages = 8;
  static constexpr int kTile = 2 * kStageKeys * kLd * 2;  // K and V, bf16
  static constexpr int kMergeLd = D + 8;  // fp32 row stride of the merge
  static constexpr int kBars = kStages * kStage;
  static constexpr int kWide = kBars + 2 * 8 * kStages;
  static constexpr int kMl = kWide + kConsumers * kTile;
  static constexpr int kBytes = kMl + kConsumers * kRowTile * 2 * 4;
  static_assert(kStage % 16 == 0 && kWide % 16 == 0, "16-byte alignment");
  static_assert(kRowTile * kMergeLd * 4 <= kTile, "a warp's merge rows fit "
                "in its tile");
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// the 8 x 8 bf16 matrix whose fragment a lane holds (row gid, columns
// 2 tig, 2 tig + 1, as mma's C and A fragments lie) transposed, in the same
// fragment layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A fragment of the 16 x 16 block (rows m0.., depth k0..) of A = T^T, from
// a tile T that holds [k][m] (V as it lies, for V^T . P^T), read
// transposed by ldmatrix.trans
template <int LD>
__device__ __forceinline__ void frag_at(uint32_t (&a)[4],
                                        const __nv_bfloat16* t, int k0,
                                        int m0) {
  const int lane = threadIdx.x & 31;
  ptt::ldmatrix_x4_trans(a, t + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                    LD + m0 + ((lane >> 3) & 1) * 8);
}

// The keys of row b that some query of the frame sees: [0, len + T - 2],
// within the page table; 0 for a len-0 row.
__device__ __forceinline__ int keys_of(int len, int Tq, int ps,
                                       int pages_per_seq) {
  return len > 0 ? min(len + Tq - 1, pages_per_seq * ps) : 0;
}

// One work item of the persistent kernel: an 8-row tile of the frame rows
// of one (row b, kv head), over the keys [k_begin, k_end) of one split.
struct Item {
  int rt, hk, b, split, len, n_keys, k_begin, k_end;
  __device__ int stages() const {
    return (k_end - k_begin + kStageKeys - 1) / kStageKeys;
  }
};

// The items that hold keys, in order: row, then split, then kv head, then
// row tile (fastest). A walker finds item w from its cursor (row b, whose
// first item is `base`); w only grows, so a block reads each row's length
// a few times over the whole call. Returns false past the last row.
struct Walk {
  const int* lens;
  int B, Tq, ps, pages_per_seq, per_split;  // per_split: Hkv * row tiles
  int n_tiles, b = 0, base = 0;

  __device__ int splits(int row) const {
    const int n = keys_of(lens[row], Tq, ps, pages_per_seq);
    return (n + kMmaSplitKeys - 1) / kMmaSplitKeys;
  }
  __device__ bool seek(int w, Item& it) {
    for (; b < B; ++b) {
      const int cnt = splits(b) * per_split;
      if (w < base + cnt) break;
      base += cnt;
    }
    if (b >= B) return false;
    const int local = w - base;
    it.b = b;
    it.split = local / per_split;
    it.hk = local % per_split / n_tiles;
    it.rt = local % n_tiles;
    it.len = lens[b];
    it.n_keys = keys_of(it.len, Tq, ps, pages_per_seq);
    it.k_begin = it.split * kMmaSplitKeys;
    it.k_end = min(it.n_keys, it.k_begin + kMmaSplitKeys);
    return true;
  }
};

template <typename KV, int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
paged_decode_kernel_mma(const __nv_bfloat16* __restrict__ q,
                        const KV* __restrict__ kp, const KV* __restrict__ vp,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ pt,
                        const int* __restrict__ lens,
                        float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                        int B, int Tq, int Hq, int Hkv, int P, int ps,
                        int pages_per_seq, int n_tiles, int n_splits,
                        float scale) {
  using L = MmaSmem<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int LD = L::kLd, KS = D / 16;
  extern __shared__ uint4 smem_pg[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_pg);
  const uint32_t ring = sm90::smem_addr(smem);
  const uint32_t bars = ring + L::kBars;  // full s at 8 s, empty s after

  constexpr int kStages = L::kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = Hq / Hkv, TG = Tq * group;
  Walk walk{lens, B, Tq, ps, pages_per_seq, Hkv * n_tiles, n_tiles};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(bars + 8 * s, 1);              // the producer
      sm90::bar_init(bars + 8 * (kStages + s), 1);  // the consuming warp
    }
    sm90::fence_bar_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer ---------------------------------------------------------
    // An item's page ids (at most kSplitPages) sit in two registers a
    // lane, page p0 + j in lane j % 32 of register j / 32; the next item's
    // are loaded while this item's stages go out.
    static_assert(kSplitPages <= 64, "two page-id registers a lane");
    auto fetch = [&](const Item& it, int& pa, int& pb) {
      const int p0 = it.k_begin / ps, p1 = (it.k_end - 1) / ps;
      const int* ptb = pt + (long long)it.b * pages_per_seq;
      if (p0 + lane <= p1) pa = ptb[p0 + lane];
      if (p0 + 32 + lane <= p1) pb = ptb[p0 + 32 + lane];
    };
    auto page_id = [](int j, int lo, int hi) {  // j: page index - p0
      const int a = __shfl_sync(0xffffffffu, lo, j & 31);
      const int c = __shfl_sync(0xffffffffu, hi, j & 31);
      return j < 32 ? a : c;
    };
    int g = 0;  // stages issued by this block
    Item it, nx;
    int pa = 0, pb = 0;
    bool more = walk.seek(blockIdx.x, it);
    if (more) fetch(it, pa, pb);
    for (int w = blockIdx.x; more; w += gridDim.x) {
      const bool next = walk.seek(w + gridDim.x, nx);
      int na = 0, nb = 0;
      if (next) fetch(nx, na, nb);
      const int p0 = it.k_begin / ps, n = it.stages();
      const long long head = (long long)it.hk * P;
      for (int i = 0; i < n; ++i, ++g) {
        const int s = g % kStages;
        const uint32_t full = bars + 8 * s, st = ring + s * L::kStage;
        const int k0 = it.k_begin + i * kStageKeys;
        const int live = min(kStageKeys, it.k_end - k0);  // rows copied
        // lanes 0-3 copy K (0, 1) and V (2, 3) rows, lanes 4-7 their
        // scales, in 8-key halves, each inside one page (ps % 8 == 0);
        // when the stage lies in one page, one copy takes both halves
        const int h = lane & 1, v = (lane >> 1) & 1;
        const bool one_page = k0 % ps + kStageKeys <= ps;
        const int pos = k0 + 8 * h, page = pos / ps;
        const int pid = page_id(page - p0, pa, pb);
        const int pieces = (live + 7) / 8;  // 8-key halves with a key
        const int rows = one_page ? (h ? 0 : live) : min(8, live - 8 * h);
        const int sc_rows = one_page ? (h ? 0 : 8 * pieces) : 8;
        const long long key = (head + pid) * ps + pos - page * ps;
        sm90::bar_wait(bars + 8 * (kStages + s), ((g / kStages) & 1) ^ 1);
        if (lane == 0)
          sm90::bar_arrive_expect_tx(
              full, 2 * live * L::kCopy + (kQuant ? 2 * 32 * pieces : 0));
        __syncwarp();
        if (lane < 4 && rows > 0)
          sm90::bulk_load(st + v * L::kTensor + 8 * h * L::kCopy,
                          (v ? vp : kp) + key * D, rows * L::kCopy, full);
        if (kQuant && lane >= 4 && lane < 8 && 8 * h < live && sc_rows > 0)
          sm90::bulk_load(st + 2 * L::kTensor + 64 * v + 32 * h,
                          (v ? v_scales : k_scales) + key, 4 * sc_rows,
                          full);
      }
      more = next;
      it = nx;
      pa = na;
      pb = nb;
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int gid = lane >> 2, tig = lane & 3;
  const float sl2 = scale * ptt::kLog2e;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem + L::kWide) +
                        warp * 2 * kStageKeys * LD;
  float* mrg = reinterpret_cast<float*>(smem + L::kWide);  // the tiles
  float* mls = reinterpret_cast<float*>(smem + L::kMl);  // [warp][row][2]
  // the splits of rows b = blockIdx.x, + grid, ... that hold no keys (all
  // of a len-0 row's) get (max -inf, sum 0): the combine skips them
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int first = walk.splits(b);
    const int n = (n_splits - first) * Hkv * TG;
    for (int e = threadIdx.x; e < n; e += 32 * kConsumers) {
      const int r = e % TG, hk = e / TG % Hkv, split = first + e / TG / Hkv;
      float* ml = ws_ml + ((((long long)b * Hkv + hk) * n_splits + split) *
                               TG + r) * 2;
      ml[0] = ptt::kNegInf;
      ml[1] = 0.f;
    }
  }
  int g = 0;  // stages consumed by this block's warps
  Item it;
  for (int w = blockIdx.x; walk.seek(w, it); w += gridDim.x) {
    const int rows = min(kRowTile, TG - it.rt * kRowTile);  // real rows
    const long long slot =
        ((long long)it.b * Hkv + it.hk) * n_splits + it.split;
    float* wacc = ws_acc + (slot * TG + it.rt * kRowTile) * D;
    float* wml = ws_ml + (slot * TG + it.rt * kRowTile) * 2;
    const int n_stages = it.stages();

    // q^T as B fragments: this lane's query row gid of the tile (a padding
    // row is zero); the key limit len + t of its query rows 2 tig, +1
    uint32_t qb[KS][2];
    {
      const int r = it.rt * kRowTile + gid;
      const __nv_bfloat16* qr =
          q + (((long long)it.b * Tq + r / group) * Hq + it.hk * group +
               r % group) * D + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          qb[kk][c] = r < TG ? *reinterpret_cast<const uint32_t*>(
                                   qr + 16 * kk + 8 * c)
                             : 0u;
    }
    int limit[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      limit[j] = min(it.len + (it.rt * kRowTile + 2 * tig + j) / group,
                     it.n_keys);

    // o^T (depth x query row): acc[mt][i] is depth 16 mt + gid + 8 (i / 2),
    // query row 2 tig + i % 2
    float acc[D / 16][4], m[2], l[2];
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[j] = ptt::kNegInf;  // running max of the raw (unscaled) scores
      l[j] = 0.f;           // this lane's share of the running sum
    }

    // this warp's stages of the item: i = warp, warp + 4, ... (block stage
    // g + i, in ring slot (g + i) % kStages); how an item's stages fall to
    // the warps, and so the rounding, does not depend on the schedule
    for (int i = warp; i < n_stages; i += kConsumers) {
      const int gs = g + i, s = gs % kStages;
      const unsigned char* st = smem + s * L::kStage;
      const uint32_t empty = bars + 8 * (kStages + s);
      const int k0 = it.k_begin + i * kStageKeys;
      const int live = min(kStageKeys, it.k_end - k0);
      sm90::bar_wait(bars + 8 * s, (gs / kStages) & 1);

      // the stage into this warp's padded bf16 tile (K rows, then V rows;
      // codes widened, bf16 copied), rows the ring never filled zeroed; then
      // the ring stage is free
      float2 ksc, vsc;  // scales of keys gid and gid + 8
      if constexpr (kQuant) {
        const float* sk = reinterpret_cast<const float*>(st + 2 * L::kTensor);
        ksc = make_float2(sk[gid], sk[gid + 8]);
        vsc = make_float2(sk[kStageKeys + gid], sk[kStageKeys + gid + 8]);
      }
      __syncwarp();  // the previous stage's ldmatrix reads are done
      constexpr int kPiece = 16 / (int)sizeof(KV);   // values a 16-byte piece
      constexpr int kPieces = 2 * kStageKeys * D / kPiece;  // K and V
#pragma unroll
      for (int j = 0; j < kPieces / 32; ++j) {
        const int c = lane + 32 * j;
        const int v = c / (kPieces / 2);                  // 0 K, 1 V
        const int e = (c % (kPieces / 2)) * kPiece;        // value in tensor
        const int r = e / D, col = e % D;
        const uint4 u = *reinterpret_cast<const uint4*>(st + v * L::kTensor +
                                                        e * sizeof(KV));
        uint4* dst =
            reinterpret_cast<uint4*>(wide + (v * kStageKeys + r) * LD + col);
        if constexpr (kQuant) {
          uint32_t o[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
          if (r < live) widen16(u, static_cast<const KV*>(nullptr), o);
          dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        } else {
          *dst = r < live ? u : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(empty);
      const __nv_bfloat16* kt = wide;
      const __nv_bfloat16* vt = wide + kStageKeys * LD;

      // S^T = K . q^T: the stage's 16 keys (m) by the tile's 8 query rows
      // (n); sc[i] is key gid + 8 (i / 2), query row 2 tig + i % 2
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ptt::frag_a<LD>(a, kt, 0, 16 * kk);
        ptt::mma_bf16_16816(sc, a, qb[kk]);
      }

      // the online softmax, query row by query row: a row's 16 keys lie in
      // the 8 lanes of one tig
      float p[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool v0 = k0 + gid < limit[j], v1 = k0 + gid + 8 < limit[j];
        float x0 = sc[j], x1 = sc[2 + j];
        if constexpr (kQuant) {
          x0 *= ksc.x;
          x1 *= ksc.y;
        }
        float mx = fmaxf(m[j], fmaxf(v0 ? x0 : ptt::kNegInf,
                                     v1 ? x1 : ptt::kNegInf));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float alpha = ptt::exp2_ftz((m[j] - mx) * sl2);
        const float mb = mx * sl2;
        m[j] = mx;
        const float p0 = v0 ? ptt::exp2_ftz(fmaf(x0, sl2, -mb)) : 0.f;
        const float p1 = v1 ? ptt::exp2_ftz(fmaf(x1, sl2, -mb)) : 0.f;
        l[j] = l[j] * alpha + p0 + p1;
        if constexpr (kQuant) {  // P . V against the codes: p_j vs_j
          p[j] = v0 ? p0 * vsc.x : 0.f;
          p[2 + j] = v1 ? p1 * vsc.y : 0.f;
        } else {
          p[j] = p0;
          p[2 + j] = p1;
        }
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          acc[mt][j] *= alpha;
          acc[mt][2 + j] *= alpha;
        }
      }

      // o^T += V^T . P^T: P^T in bf16 is the B operand, its 8 x 8 blocks
      // (keys 0-7, 8-15) transposed in registers by movmatrix. Against
      // codes, p_j vs_j goes in as two bf16 pieces, hi and lo = the rest:
      // one piece would add up to 2^-9 of a value to the output's rounding
      uint32_t pb[2], plo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pb[h] = movmatrix_trans(ptt::pack_bf16(p[2 * h], p[2 * h + 1]));
        if constexpr (kQuant) {
          const float r0 = p[2 * h] - bf16_round(p[2 * h]);
          const float r1 = p[2 * h + 1] - bf16_round(p[2 * h + 1]);
          plo[h] = movmatrix_trans(ptt::pack_bf16(r0, r1));
        }
      }
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        uint32_t a[4];
        frag_at<LD>(a, vt, 0, 16 * mt);
        ptt::mma_bf16_16816(acc[mt], a, pb);
        if constexpr (kQuant) ptt::mma_bf16_16816(acc[mt], a, plo);
      }
    }
    g += n_stages;

    // ---- merge the four warps in warp order, write the item's partial --
    consumers_sync();  // every warp's products (tile reads) are done
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 4);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 8);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 16);
      if (gid == 0) {
        mls[(warp * kRowTile + 2 * tig + j) * 2] = m[j];
        mls[(warp * kRowTile + 2 * tig + j) * 2 + 1] = l[j];
      }
    }
    consumers_sync();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 2 * tig + j;
      float mx = ptt::kNegInf;
#pragma unroll
      for (int w2 = 0; w2 < kConsumers; ++w2)
        mx = fmaxf(mx, mls[(w2 * kRowTile + r) * 2]);
      const float f = ptt::exp2_ftz((m[j] - mx) * sl2);
      float* row = mrg + (warp * kRowTile + r) * L::kMergeLd + gid;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        row[16 * mt] = acc[mt][j] * f;
        row[16 * mt + 8] = acc[mt][2 + j] * f;
      }
    }
    consumers_sync();
    for (int e = threadIdx.x; e < rows * D; e += 32 * kConsumers) {
      const int r = e / D, c = e % D;
      float a = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kConsumers; ++w2)
        a += mrg[(w2 * kRowTile + r) * L::kMergeLd + c];
      wacc[e] = a;
    }
    if (threadIdx.x < rows) {
      const int r = threadIdx.x;
      float mx = ptt::kNegInf, sum = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kConsumers; ++w2)
        mx = fmaxf(mx, mls[(w2 * kRowTile + r) * 2]);
#pragma unroll
      for (int w2 = 0; w2 < kConsumers; ++w2)
        sum += mls[(w2 * kRowTile + r) * 2 + 1] *
               ptt::exp2_ftz((mls[(w2 * kRowTile + r) * 2] - mx) * sl2);
      wml[2 * r] = mx * scale;  // the combine's max is of scaled scores
      wml[2 * r + 1] = sum;
    }
    consumers_sync();  // the merge reads are done before the next tiles
  }
}

template <typename KV, int D>
int launch_mma(const void* q, const void* k, const void* v, const float* ksc,
               const float* vsc, const int* pt, const int* lens, void* o,
               float* ws_acc, float* ws_ml, int B, int Tq, int Hq, int Hkv,
               int P, int ps, int pages_per_seq, float scale, int device,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int tg = Tq * (Hq / Hkv);
  if (tg > kMaxRows || ps <= 0 || ps % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (MmaSmem<KV, D>::kQuant && (ksc == nullptr || vsc == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kern = paged_decode_kernel_mma<KV, D>;
  constexpr int smem = MmaSmem<KV, D>::kBytes;
  cudaError_t err = ptt::sm90_host::opt_in_smem(kern, device, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (tg + kRowTile - 1) / kRowTile;
  const int n_splits = mma_splits(pages_per_seq, ps);
  const long long total = (long long)n_tiles * Hkv * B * n_splits;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  // persistent: as many blocks as fit on an SM (2 for bf16 at D 128, by
  // shared memory; 3 for codes), found once a process
  static const int per_sm = [&] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, kern, kMmaThreads, smem) == cudaSuccess && n > 0
               ? n
               : 1;
  }();
  const int grid = (int)std::min<long long>(
      total, (long long)per_sm *
                 ptt::sm90_host::persistent_blocks(device, INT_MAX));
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ksc, vsc, pt, lens, ws_acc, ws_ml, B, Tq, Hq,
      Hkv, P, ps, pages_per_seq, n_tiles, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<bf, D><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      ws_acc, ws_ml, lens, static_cast<bf*>(o), Tq, Hq, Hkv, n_splits);
  return (int)cudaGetLastError();
}

// The kernel a call runs, chosen by the wrapper (kernel_route) and passed
// to both ptt_paged_splits and ptt_paged_decode, so the workspace is sized
// for the kernel that fills it: the tensor-core kernel takes bf16 q at a
// page size that is a multiple of 8 (a ring stage's 8-key halves lie in
// one page); the CUDA-core kernel takes bf16 or fp32 q at any page size.
constexpr int kRouteCudaCore = 0;
constexpr int kRouteMma = 1;

int route_splits(int route, int pages_per_seq, int ps, int Tq) {
  return route == kRouteMma ? mma_splits(pages_per_seq, ps)
                            : paged_splits(pages_per_seq, ps, Tq);
}

// kv_kind: 0 the pool holds q's type, 1 int8 codes, 2 fp8-e4m3 codes.
int launch_kv(int is_bf16, int route, int kv_kind, int D, const void* q,
              const void* k, const void* v, const float* ksc,
              const float* vsc, const int* pt, const int* lens, void* o,
              float* ws_acc, float* ws_ml, int B, int Tq, int Hq, int Hkv,
              int P, int ps, int pages_per_seq, float scale, int dev,
              cudaStream_t st) {
  using bf = __nv_bfloat16;
#define PTT_PAGED(...)                                                       \
  return __VA_ARGS__(q, k, v, ksc, vsc, pt, lens, o, ws_acc, ws_ml, B, Tq, Hq, \
                     Hkv, P, ps, pages_per_seq, scale, dev, st)
#define PTT_PAGED_D(DD)                                             \
  if (route == kRouteMma) {                                         \
    if (kv_kind == 0) PTT_PAGED(launch_mma<bf, DD>);                \
    if (kv_kind == 1) PTT_PAGED(launch_mma<int8_t, DD>);            \
    if (kv_kind == 2) PTT_PAGED(launch_mma<e4m3, DD>);              \
  } else if (is_bf16) {                                             \
    if (kv_kind == 0) PTT_PAGED(launch<bf, bf, DD>);                \
    if (kv_kind == 1) PTT_PAGED(launch<bf, int8_t, DD>);            \
    if (kv_kind == 2) PTT_PAGED(launch<bf, e4m3, DD>);              \
  } else {                                                          \
    if (kv_kind == 0) PTT_PAGED(launch<float, float, DD>);          \
    if (kv_kind == 1) PTT_PAGED(launch<float, int8_t, DD>);         \
    if (kv_kind == 2) PTT_PAGED(launch<float, e4m3, DD>);           \
  }
  if (route != kRouteCudaCore && (route != kRouteMma || !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (D == 64) {
    PTT_PAGED_D(64)
  } else if (D == 128) {
    PTT_PAGED_D(128)
  }
#undef PTT_PAGED_D
#undef PTT_PAGED
  return (int)cudaErrorInvalidValue;
}

// The page-visit counter: replaces `_visit_kernel` (paddle_tpu/ops/pallas/
// paged_attention.py:372, launched at :400), a grid step a row that tests
// the pages one after another. Here a row is a warp's (kPageVisitWarps
// rows a block): its lanes take 32 pages a step and test each by the
// decode kernel's own predicate, ptt::blocks_can_touch over the page's
// positions [p ps, p ps + ps - 1] and [0, len - 1] (len <= 0 visits none;
// p ps in int32, as the decode kernel and JAX compute it), and one
// __ballot_sync + __popc counts the step (every lane votes, lanes past
// pages_per_seq vote false): 8 ballots for 256 pages, not 256 serial
// tests. Counting by the predicate, not by ceil(len / ps), is the point:
// the counter shows what the decode kernel reads. Lane 0 writes the
// row's count; no atomics.
constexpr int kPageVisitWarps = 8;

__global__ void __launch_bounds__(kPageVisitWarps * 32)
page_visit_kernel(const int* __restrict__ lens, int* __restrict__ counts,
                  int B, int ps, int pages_per_seq) {
  const int b = blockIdx.x * kPageVisitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;                  // the whole warp
  const int len = lens[b];
  int n = 0;
  for (int p0 = 0; p0 < pages_per_seq; p0 += 32) {
    const int p = p0 + lane;
    const bool touch = p < pages_per_seq &&
        ptt::blocks_can_touch(0, len - 1, p * ps, p * ps + ps - 1);
    n += __popc(__ballot_sync(0xffffffffu, touch));
  }
  if (lane == 0) counts[b] = n;
}

}  // namespace

// Split-K blocks per (row, kv head) for a page table of `pages_per_seq`
// pages and a T-query frame on kernel `route` (1: the tensor-core
// kernel's 256-key splits; 0: the CUDA-core kernel's 512 keys, counting
// the frame's T - 1 extra keys); the wrapper sizes the workspace with it
// and passes the same route to ptt_paged_decode.
extern "C" int ptt_paged_splits(int pages_per_seq, int ps, int Tq,
                                int route) {
  return route_splits(route, pages_per_seq, ps, Tq);
}

// Plain C entry point (bound with ctypes). is_bf16: q and o are bf16 (1)
// or fp32 (0); route: 1 the tensor-core kernel (bf16 q, page_size a
// multiple of 8), 0 the CUDA-core kernel (any q, any page size), as given
// to ptt_paged_splits; kv_kind: 0 the pools hold q's type, 1 int8 codes,
// 2 fp8-e4m3 codes, with k_scales/v_scales [Hkv, P, ps] fp32 (null when
// kv_kind is 0; 16-byte aligned). ws_acc: [B, Hkv, splits, T*group, D]
// fp32 and ws_ml: [B, Hkv, splits, T*group, 2] fp32 scratch. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ptt_paged_decode(const void* q, const void* k, const void* v,
                                const float* k_scales, const float* v_scales,
                                const int* page_table, const int* lens,
                                void* o, float* ws_acc, float* ws_ml, int B,
                                int Tq, int Hq, int Hkv, int P, int ps,
                                int pages_per_seq, int D, float scale,
                                int is_bf16, int route, int kv_kind,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0) return (int)cudaErrorInvalidValue;
  return launch_kv(is_bf16, route, kv_kind, D, q, k, v, k_scales, v_scales,
                   page_table, lens, o, ws_acc, ws_ml, B, Tq, Hq, Hkv, P, ps,
                   pages_per_seq, scale, device,
                   static_cast<cudaStream_t>(stream));
}

// Page-visit counter: counts [B] int32 from lens [B] int32.
extern "C" int ptt_page_visit(const int* lens, int* counts, int B, int ps,
                              int pages_per_seq, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  if (ps <= 0 || pages_per_seq < 0) return (int)cudaErrorInvalidValue;
  page_visit_kernel<<<(B + kPageVisitWarps - 1) / kPageVisitWarps,
                      kPageVisitWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(lens, counts, B, ps,
                                                           pages_per_seq);
  return (int)cudaGetLastError();
}
