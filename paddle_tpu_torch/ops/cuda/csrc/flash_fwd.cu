// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores; and the block-visit counter.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd`) and `_visit_kernel` (launched by
// `segment_block_visit_counts`). Each block owns one q tile of one (batch,
// q-head) and streams K/V tiles past it with an online softmax (fp32
// running max and denominator). Writes o and lse = m + log(l).
//
//  * causal: K tiles past the q tile's diagonal are never loaded;
//  * GQA: q head h reads kv head h / group, K/V are never repeated;
//  * segment_ids: q_seg != k_seg is masked inside a tile, and a whole K
//    tile whose segment range cannot touch the q tile's is skipped through
//    ptt::blocks_can_touch (the predicate the backward and the paged
//    kernel share). The keys' ids may come from a pointer of their own
//    (kv_seg, the segment ids of another stretch of the sequence: a ring
//    attention block); every read of a key's id and every K-tile range go
//    through it. That is a compile-time variant (kSplit), launched only
//    when kv_seg differs from seg, so every other caller runs the code it
//    ran before the pointer existed;
//  * a row with no visible key (possible only across stretches: a row
//    always sees itself otherwise, also when the segment skip leaves a
//    q tile no K tile) writes o = 0 and lse = -inf, which the caller's
//    log-sum-exp merge lets through;
//  * ragged S: rows and keys past S are masked here, S need not divide
//    the tile sizes. A masked pair gets P = 0 by selection.
//  * flash_visit_kernel counts, per (row, block_q rows), the K blocks that
//    ptt::blocks_can_touch and the causal bound admit, the forward's own
//    skip rules; at the tiles of FwdTile below (64 x 64 at head_dim 128,
//    the serving path's) it counts the tiles the bf16 kernel visits, at
//    64 x 32 the fp32 kernel's. Its design (each block's id range reduced
//    once a CTA into shared memory, every block pair tested in parallel,
//    counts by warp ballot) is noted above the kernel.
//
// What bounds it: two products of 2 D flops per visible (query, key) pair
// and head against O(S D) bytes, so operations at prefill and training
// lengths.
//
// bf16 inputs (flash_fwd_kernel_mma): FlashAttention-2's forward on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). 4 warps own the rows of
// the block's q tile and all 64 keys of each streamed K/V tile. At head_dim
// 64 a warp owns 32 rows (two m16 tiles, a 128-row q tile), so each K or V
// fragment it loads by ldmatrix serves 4 mma; at head_dim 128 the output
// and score accumulators of 32 rows overflow the registers (ptxas: 255 and
// a spill), so a warp owns 16 rows (a 64-row q tile), as in the backward.
//  * Q is copied once as bf16 by cp.async and its A fragments are read from
//    shared memory each step; K and V stream through a two-stage cp.async
//    ring, the next admitted tile in flight while the current one is
//    computed; rows past S are zero-filled. Rows are padded by 16 bytes, so
//    ldmatrix is free of bank conflicts (87 KB at head_dim 128, two blocks
//    an SM).
//  * Q . K^T takes K by ldmatrix; P . V takes V by ldmatrix.trans, so
//    nothing is transposed in shared memory.
//  * The online softmax runs in the accumulators: a row of an m16n8 tile
//    lives in one quad of 4 lanes, so its max takes two shuffles and its
//    sum none until the end (each lane keeps its share of l). exp2 with
//    scale * log2(e) folded into one multiply-add a score, on the SFU with
//    subnormals flushed. Only the diagonal, ragged and segmented tiles run
//    the masking code; the others take a copy without it. P leaves the
//    fp32 accumulators straight as bf16 A fragments of P . V.
//  * Numerics: S is exact bf16 products summed in fp32, scaled in fp32;
//    l sums the unrounded fp32 P; P is rounded to bf16 for P . V, as the
//    library's forward does; o is normalised by 1 / l in fp32 and rounded
//    to bf16 once.
//  * q tiles are launched longest causal row first.
//
// fp32 inputs (flash_fwd_kernel<float>): the CUDA cores (the tensor cores
// would round to tf32). One block per (batch * q-head, 64-row q tile);
// 32-key K/V tiles go through shared memory widened to fp32. 8 warps; warp
// w owns q rows 8w..8w+7 of the tile, lane l owns key l of the K tile for
// the scores and head-dim columns l + 32j of the output; the PV product
// broadcasts each probability from the lane that owns its key.
//
// Layout: q [B, S, Hq, D], k/v [B, S, Hkv, D] given by element strides
// (head_dim contiguous, 16-byte aligned rows), o [B, S, Hq, D] contiguous,
// lse [B, Hq, S] fp32.
#include <type_traits>

#include "common.cuh"

namespace {

// ---- fp32: CUDA cores ----------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kRows = kBQ / (kThreads / 32);  // q rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 4) + kBK * (D + 4) + kBK * D);
}

template <typename T, int D, bool kSplit>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 const int* __restrict__ kv_seg,
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
  const int* kvb = kSplit ? kv_seg + (long long)b * S : segb;

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
    const int kseg = (kvb && kpos < S) ? kvb[kpos] : 0;
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
    if (lane == 0)
      lse[((long long)b * Hq + h) * S + r] =
          (!kSplit || l[i] > 0.f) ? m[i] + logf(lc) : ptt::neg_inf();
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* seg,
           const int* kv_seg, void* o, float* lse, int B, int S, int Hq,
           int Hkv,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
  // the keys' own ids only where they differ from the queries'
  auto kern = seg && kv_seg != seg ? flash_fwd_kernel<T, D, true>
                                   : flash_fwd_kernel<T, D, false>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, kv_seg, static_cast<T*>(o), lse, S, Hq,
      Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ---------------------------------------------------
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaBK = 64;        // keys of a streamed K/V tile

// the q tile of a block: each warp owns kMT m16 row tiles (one compiled
// tile a head_dim; why, in the note at the top)
template <int D>
struct FwdTile {
  static constexpr int kMT = D == 128 ? 1 : 2;
  static constexpr int kBQ = 16 * kMT * kMmaThreads / 32;
};

// the Q tile and two stages of K and V
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (FwdTile<D>::kBQ + 4 * kMmaBK) *
         ptt::kTileLd<D>;
}

template <int D, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg,
                     const int* __restrict__ kv_seg,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, int Hq, int group, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, int causal, float scale) {
  constexpr int MT = FwdTile<D>::kMT, BQ = FwdTile<D>::kBQ;
  constexpr int LD = ptt::kTileLd<D>;
  constexpr int TK = kMmaBK * LD;
  constexpr int NT = D / 8;          // n8 tiles over the head dim
  constexpr int KS = D / 16;         // k16 steps over the head dim
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ks = qs + BQ * LD;  // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * TK;   // [2][64][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / group;
  // the last q tile (the longest causal rows) is launched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const int* segb = seg ? seg + (long long)b * S : nullptr;
  const int* kvb = kSplit ? kv_seg + (long long)b * S : segb;

  ptt::copy_tile<BQ, D, kMmaThreads>(qs, qb, q_ss, q0, S);

  // this thread's rows: rw + 16 mt + 8 hi holds the accumulators c[mt][.][i]
  // with i = 2 hi, 2 hi + 1
  const int wr = 16 * MT * warp, rw = q0 + wr + gid;
  int qseg[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = rw + 16 * mt + 8 * hi;
      qseg[mt][hi] = (segb && r < S) ? segb[r] : -1;
    }
  int q_min = 0, q_max = 0;
  if (segb) ptt::seg_range(segb, q0, BQ / 32, S, q_min, q_max);
  const float sl2 = scale * ptt::kLog2e;

  int n_kt = (S + kMmaBK - 1) / kMmaBK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, S) + kMmaBK - 1) / kMmaBK);
  // the first K tile at or after t that the segment skip lets through
  auto next_tile = [&](int t) {
    for (; t < n_kt && segb; ++t) {
      int mn, mx;
      ptt::seg_range(kvb, t * kMmaBK, kMmaBK / 32, S, mn, mx);
      if (ptt::blocks_can_touch(q_min, q_max, mn, mx)) break;
    }
    return t;
  };
  auto issue = [&](int stage, int t) {
    ptt::copy_tile<kMmaBK, D, kMmaThreads>(ks + stage * TK, kb, k_ss,
                                           t * kMmaBK, S);
    ptt::copy_tile<kMmaBK, D, kMmaThreads>(vs + stage * TK, vb, v_ss,
                                           t * kMmaBK, S);
  };

  // m: the running max of the raw scores; l: this lane's share of the
  // running sum (the quad's four shares are added at the end)
  float acc[MT][NT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      m[mt][hi] = ptt::kNegInf;
      l[mt][hi] = 0.f;
    }
  }
  int cur = next_tile(0), stage = 0;
  if (cur < n_kt) issue(0, cur);
  ptt::cp_async_commit();  // with Q
  while (cur < n_kt) {
    const int nxt = next_tile(cur + 1);
    ptt::cp_async_wait_all();
    __syncthreads();  // tile `cur` landed; the other stage's readers are done
    if (nxt < n_kt) issue(stage ^ 1, nxt);  // overlaps this tile's products
    ptt::cp_async_commit();
    const __nv_bfloat16* kst = ks + stage * TK;
    const __nv_bfloat16* vst = vs + stage * TK;
    const int k0 = cur * kMmaBK;

    // S = Q . K^T over this warp's rows and the tile's 64 keys
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ptt::frag_a<LD>(a[mt], qs, wr + 16 * mt, 16 * kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ptt::frag_bt<LD>(bk, kst, 16 * np, 16 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ptt::mma_pair(s[mt][2 * np], s[mt][2 * np + 1], a[mt], bk);
      }
    }

    // the online softmax, row by row. Pairs are masked only on the
    // diagonal and ragged tiles and under segments, and the other tiles
    // take a copy of this code without the mask (rows past S are never
    // written, so they need none).
    auto softmax = [&](auto mask_tag) {
      constexpr bool kMasked = decltype(mask_tag)::value;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int qpos = rw + 16 * mt + 8 * hi;
          uint32_t vis = 0xffffu;  // bit 2 nt + e: key 8 nt + 2 tig + e
          float mx = m[mt][hi];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int bit = 2 * nt + e;
              if constexpr (kMasked) {
                const int kpos = k0 + 8 * nt + 2 * tig + e;
                const bool valid = kpos < S && (!causal || qpos >= kpos) &&
                                   (!segb || qseg[mt][hi] == kvb[kpos]);
                if (!valid) vis &= ~(1u << bit);
              }
              if (vis >> bit & 1u) mx = fmaxf(mx, s[mt][nt][2 * hi + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float alpha = ptt::exp2_ftz((m[mt][hi] - mx) * sl2);
          const float mb = mx * sl2;
          m[mt][hi] = mx;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int bit = 2 * nt + e;
              float& x = s[mt][nt][2 * hi + e];
              x = (vis >> bit & 1u) ? ptt::exp2_ftz(fmaf(x, sl2, -mb))
                                    : 0.f;
              sum += x;
            }
          l[mt][hi] = l[mt][hi] * alpha + sum;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[mt][nt][2 * hi] *= alpha;
            acc[mt][nt][2 * hi + 1] *= alpha;
          }
        }
    };
    if ((causal && k0 + kMmaBK > q0) || k0 + kMmaBK > S || segb != nullptr)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // o += P . V, 16 keys a step; P leaves the accumulators as bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ptt::acc_to_a(pa[mt], s[mt], j);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ptt::frag_b<LD>(bv, vst, 16 * j, 16 * np);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ptt::mma_pair(acc[mt][2 * np], acc[mt][2 * np + 1], pa[mt], bv);
      }
    }
    cur = nxt;
    stage ^= 1;
  }
  ptt::cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float lt = l[mt][hi];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f), inv = 1.f / lc;
      const int r = rw + 16 * mt + 8 * hi;
      if (r >= S) continue;
      __nv_bfloat16* orow = o + (((long long)b * S + r) * Hq + h) * D;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nt + 2 * tig) =
            __floats2bfloat162_rn(acc[mt][nt][2 * hi] * inv,
                                  acc[mt][nt][2 * hi + 1] * inv);
      if (tig == 0)
        lse[((long long)b * Hq + h) * S + r] =
            (!kSplit || lt > 0.f) ? m[mt][hi] * scale + logf(lc)
                                  : ptt::neg_inf();
    }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int* seg,
               const int* kv_seg, void* o, float* lse, int B, int S, int Hq,
               int Hkv,
               const long long* st, int causal, float scale,
               cudaStream_t stream) {
  auto kern = seg && kv_seg != seg ? flash_fwd_kernel_mma<D, true>
                                   : flash_fwd_kernel_mma<D, false>;
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  // heads on x: the blocks of every head's longest tile start first
  dim3 grid(B * Hq, (S + FwdTile<D>::kBQ - 1) / FwdTile<D>::kBQ);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), seg, kv_seg, static_cast<bf*>(o), lse, S,
      Hq,
      Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale);
  return (int)cudaGetLastError();
}

// ---- the block-visit counter ----------------------------------------------
// Replaces `_visit_kernel` (paddle_tpu/ops/pallas/flash_attention.py:507,
// launched at :550), which walks the K blocks kb < last of one (row, q
// block) a grid step, reducing each K block's ids again in every q block
// that reaches it. What bounds it here: the bytes are one read of the ids
// (16-128 KB at S 4096-32768) and the operations one range test a pair of
// blocks, both far under a microsecond, so the launch and the chain of
// dependent instructions inside a CTA set the time (on an H100 a
// 1-element fill takes 0.0010 ms of device time, this kernel 0.0014-0.0017
// at the forward's tiles up to S 4096). The design keeps that chain short
// and independent of S:
//  * A CTA owns one row's chunk of `qchunk` q blocks (the plan in
//    flash_attention.visit_plan spreads a row over about as many CTAs as
//    the card has SMs, longest chunks first). It reduces each K block it
//    needs (kb below its last q block's causal bound, all of them when not
//    causal) and each of its q blocks to (min, max) ONCE, into tables in
//    shared memory; when bq == bk and the K blocks fit one table, the q
//    blocks' ranges are read from the K table.
//  * The row's ids are read once a CTA, by plain loads from L2: 16-byte
//    loads (int4) where the row is 16-byte aligned (the pointer is tested:
//    a view with a storage offset can break it), S % 4 == 0 and the block
//    a multiple of 4 ids, scalar loads otherwise. Bulk copies on an
//    mbarrier would land the same bytes in shared memory only to be read
//    once again from there; each id is used once, so registers are enough.
//    A block goes to a group of L lanes, L the least power of two whose
//    lanes read it in kVisitUnroll loads each, issued together, so a CTA
//    reads its ids in one round of loads and 2-5 shuffle steps; the plan
//    sizes the CTA (threads) for one pass up to S 16384.
//  * After one barrier each warp takes q blocks; its lanes stride over the
//    K blocks kb < last (the JAX kernel's bound: ceil((qi + 1) bq / bk)
//    when causal, S / bk otherwise) and test ptt::blocks_can_touch, the
//    forward kernel's own skip predicate, on the tables; __ballot_sync +
//    __popc count 32 blocks a step (every lane votes, lanes past `last`
//    vote false). Each count has one owner warp; no atomics.
//  * The forward's 64 x 64 tiles with 16-byte loads take an instantiation
//    whose block arithmetic is fixed at compile time (kFast): the runtime
//    divisions, loops and branches of the general body cost as much as
//    the loads (on an H100, 0.0024 against 0.0016 ms at B 4 x S 2048).
//  * Tables past kVisitKTile K blocks (bq = bk = 1 at long S) are taken in
//    tiles of kVisitKTile, the counts summed in shared memory by their
//    owners. Shared memory stays under 48 KB: no opt-in.
constexpr int kVisitKTile = 2048;      // K-table entries a pass (16 KB)
constexpr int kVisitMaxQChunk = 1024;  // q blocks a CTA
constexpr int kVisitMinThreads = 128;
constexpr int kVisitMaxThreads = 1024;
constexpr int kVisitLoads = 4;         // 16-byte loads a thread, for sizing
constexpr int kVisitUnroll = 4;        // loads a lane issues at once
constexpr int kVisitFastBlock = 64;    // bq == bk of the forward's tiles
static_assert(kVisitKTile * 8 + kVisitMaxQChunk * 12 <= 48 * 1024,
              "the visit tables fit without the shared-memory opt-in");

// tab[i] = (min, max) of the ids of block first + i of `bs` ids, i < n;
// T = int4 (bs % 4 == 0, the row 16-byte aligned) or int. A block goes to
// a group of L lanes, L the least power of two (at most 32) whose lanes
// read it in kVisitUnroll loads each, issued together; neighbouring groups
// take neighbouring blocks, and a group's xor shuffles stay in its lanes.
// kPer > 0 fixes the loads a block (bs / 4 or bs) at compile time.
template <typename T, int kPer = 0>
__device__ __forceinline__ void visit_ranges(const int* __restrict__ row,
                                             int first, int n, int bs,
                                             int2* tab) {
  constexpr int kIds = sizeof(T) / sizeof(int);
  const int per = kPer > 0 ? kPer : bs / kIds;       // loads a block, >= 1
  const int x = (per + kVisitUnroll - 1) / kVisitUnroll;
  const int lg = x <= 1 ? 0 : min(5, 32 - __clz(x - 1));   // L = 2^lg
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> lg, sub = lane & ((1 << lg) - 1), groups = 32 >> lg;
  const int step = (blockDim.x >> 5) * groups;  // blocks a pass of the CTA
  const T* base = reinterpret_cast<const T*>(row + (long long)first * bs);
  for (int w0 = warp * groups; w0 < n; w0 += step) {   // warp-uniform
    const int i = w0 + g;
    const T* blk = base + i * per;
    int lo = INT_MAX, hi = INT_MIN;
    for (int j0 = sub; j0 < per; j0 += kVisitUnroll << lg) {
      T v[kVisitUnroll];
#pragma unroll
      for (int u = 0; u < kVisitUnroll; ++u) {
        v[u] = T{};
        if (i < n && j0 + (u << lg) < per) v[u] = __ldg(blk + j0 + (u << lg));
      }
#pragma unroll
      for (int u = 0; u < kVisitUnroll; ++u)
        if (i < n && j0 + (u << lg) < per) {
          lo = min(lo, ptt::lo_of(v[u]));
          hi = max(hi, ptt::hi_of(v[u]));
        }
    }
    for (int o = 1 << lg >> 1; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (i < n && sub == 0) tab[i] = make_int2(lo, hi);
  }
}

// The K blocks a causal q range [0, q_end) of bq-row blocks reaches:
// ceil(q_end bq / bk), q_end itself when bq == bk (no division).
__device__ __forceinline__ int k_reach(int q_end, int bq, int bk) {
  return bq == bk ? q_end : (q_end * bq + bk - 1) / bk;
}

// The K blocks kb in [k0, end) of the table (entry kb - k0) whose range
// can touch qr: lane l tests kb0 + l, one ballot a 32 (every lane votes).
__device__ __forceinline__ int visit_count(int2 qr, const int2* ktab, int k0,
                                           int end) {
  const int lane = threadIdx.x & 31;
  int n = 0;
#pragma unroll 4
  for (int kb0 = k0; kb0 < end; kb0 += 32) {   // warp-uniform bound
    const int kb = kb0 + lane;
    bool touch = false;
    if (kb < end) {
      const int2 kr = ktab[kb - k0];
      touch = ptt::blocks_can_touch(qr.x, qr.y, kr.x, kr.y);
    }
    n += __popc(__ballot_sync(0xffffffffu, touch));
  }
  return n;
}

// grid (chunks, B): x the row's q-block chunk, longest first; y the row.
// kFast: the forward's tiles (bq == bk == kVisitFastBlock, 16-byte loads,
// one K tile, the q ranges read from the K table) with the loads a block
// fixed at compile time; the general body otherwise. Nearly all of this
// kernel's time is its one chain of dependent instructions, so the
// forward's tiles get that chain with no runtime block arithmetic.
template <bool kFast>
__global__ void __launch_bounds__(kVisitMaxThreads)
flash_visit_kernel(const int* __restrict__ seg, int* __restrict__ counts,
                   int S, int nq, int nk, int bq, int bk, int causal,
                   int qchunk, int vec) {
  extern __shared__ int2 visit_smem[];
  const int b = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * qchunk;
  const int nqc = min(qchunk, nq - q0);
  const int* row = seg + (long long)b * S;
  int* out = counts + (long long)b * nq + q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int2* ktab = visit_smem;
  if constexpr (kFast) {
    const int kend = causal ? q0 + nqc : nk;
    visit_ranges<int4, kVisitFastBlock / 4>(row, 0, kend, kVisitFastBlock,
                                            ktab);
    __syncthreads();
    for (int j = warp; j < nqc; j += warps) {
      const int qb = q0 + j;
      const int n = visit_count(ktab[qb], ktab, 0, causal ? qb + 1 : nk);
      if (lane == 0) out[j] = n;
    }
    return;
  }
  const int kend = causal ? k_reach(q0 + nqc, bq, bk) : nk;
  const int ktile = min(kVisitKTile, nk);
  const bool sep = bq != bk || nk > kVisitKTile;
  int2* qtab = sep ? ktab + ktile : ktab;
  int* cnt = reinterpret_cast<int*>(ktab + ktile + (sep ? qchunk : 0));
  const bool one_tile = kend <= ktile;
  for (int k0 = 0; k0 < kend; k0 += ktile) {
    const int k1 = min(kend, k0 + ktile);
    if (k0 > 0) __syncthreads();   // every warp is done with the last tile
    if (vec && bk % 4 == 0) visit_ranges<int4>(row, k0, k1 - k0, bk, ktab);
    else visit_ranges<int>(row, k0, k1 - k0, bk, ktab);
    if (k0 == 0 && sep) {
      if (vec && bq % 4 == 0) visit_ranges<int4>(row, q0, nqc, bq, qtab);
      else visit_ranges<int>(row, q0, nqc, bq, qtab);
    }
    __syncthreads();
    for (int j = warp; j < nqc; j += warps) {
      const int qb = q0 + j;
      const int n = visit_count(qtab[sep ? j : qb], ktab, k0,
                                min(causal ? k_reach(qb + 1, bq, bk) : nk,
                                    k1));
      if (lane == 0) {
        if (one_tile) out[j] = n;
        else cnt[j] = (k0 == 0 ? 0 : cnt[j]) + n;
      }
    }
  }
  if (!one_tile && lane == 0)
    for (int j = warp; j < nqc; j += warps) out[j] = cnt[j];
}

}  // namespace

// Block-visit counter: counts [B, S / bq] int32 from segment ids [B, S]
// int32; S must be a multiple of bq and bk (the wrapper checks). qchunk
// (q blocks a CTA) and threads come from flash_attention.visit_plan.
extern "C" int ptt_flash_visit(const int* seg, int* counts, int B, int S,
                               int bq, int bk, int causal, int qchunk,
                               int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (bq <= 0 || bk <= 0 || S % bq || S % bk || qchunk <= 0 ||
      qchunk > kVisitMaxQChunk || threads < 32 ||
      threads > kVisitMaxThreads || threads % 32 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nq = S / bq, nk = S / bk, chunks = (nq + qchunk - 1) / qchunk;
  const int ktile = nk < kVisitKTile ? nk : kVisitKTile;
  const bool sep = bq != bk || nk > kVisitKTile;
  const size_t smem = sizeof(int2) * (ktile + (sep ? qchunk : 0)) +
                      sizeof(int) * qchunk;
  const int vec = reinterpret_cast<uintptr_t>(seg) % 16 == 0 && S % 4 == 0;
  const dim3 grid(chunks, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec && !sep && bk == kVisitFastBlock)
    flash_visit_kernel<true><<<grid, threads, smem, st>>>(
        seg, counts, S, nq, nk, bq, bk, causal, qchunk, vec);
  else
    flash_visit_kernel<false><<<grid, threads, smem, st>>>(
        seg, counts, S, nq, nk, bq, bk, causal, qchunk, vec);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes). strides: 9 element strides,
// (batch, seq, head) for q, k, v in that order. is_bf16: 1 bf16 (the
// tensor-core kernel), 0 fp32 (the CUDA-core one). kv_seg: the keys'
// segment ids [B, S] (null: seg's, so every existing caller computes what
// it computed before); ignored without seg.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const int* seg, const int* kv_seg, void* o,
                             float* lse, int B,
                             int S, int Hq, int Hkv, int D,
                             const long long* strides, int causal,
                             float scale, int is_bf16, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_seg == nullptr) kv_seg = seg;
  if (is_bf16) {
    if (D == 64) return launch_mma<64>(q, k, v, seg, kv_seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
    if (D == 128) return launch_mma<128>(q, k, v, seg, kv_seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k, v, seg, kv_seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
    if (D == 128) return launch<float, 128>(q, k, v, seg, kv_seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
