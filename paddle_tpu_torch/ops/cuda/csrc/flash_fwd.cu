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
//    kernel share);
//  * ragged S: rows and keys past S are masked here, S need not divide
//    the tile sizes. A masked pair gets P = 0 by selection.
//  * flash_visit_kernel counts, per (row, block_q rows), the K blocks that
//    ptt::blocks_can_touch and the causal bound admit, the forward's own
//    skip rules; at the tiles of FwdTile below (64 x 64 at head_dim 128,
//    the serving path's) it counts the tiles the bf16 kernel visits, at
//    64 x 32 the fp32 kernel's.
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg,
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
      ptt::seg_range(segb, t * kMmaBK, kMmaBK / 32, S, mn, mx);
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
                                   (!segb || qseg[mt][hi] == segb[kpos]);
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
        lse[((long long)b * Hq + h) * S + r] = m[mt][hi] * scale + logf(lc);
    }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int* seg,
               void* o, float* lse, int B, int S, int Hq, int Hkv,
               const long long* st, int causal, float scale,
               cudaStream_t stream) {
  auto kern = flash_fwd_kernel_mma<D>;
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  // heads on x: the blocks of every head's longest tile start first
  dim3 grid(B * Hq, (S + FwdTile<D>::kBQ - 1) / FwdTile<D>::kBQ);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), seg, static_cast<bf*>(o), lse, S, Hq,
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
// (batch, seq, head) for q, k, v in that order. is_bf16: 1 bf16 (the
// tensor-core kernel), 0 fp32 (the CUDA-core one).
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
    if (D == 64) return launch_mma<64>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
    if (D == 128) return launch_mma<128>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
    if (D == 128) return launch<float, 128>(q, k, v, seg, o, lse, B, S, Hq, Hkv, strides, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
