// Grouped (ragged) matmul for Hopper (sm_90a): the dropless-MoE expert
// products. Replaces the TPU kernels of paddle_tpu/ops/pallas/
// grouped_matmul.py:
//   gmm_fwd   <- `_gmm_fwd_kernel`: y[i] = x[i] @ w[gids[i]], fp32 out;
//                also dx = dy @ w[g]^T (the JAX VJP's dx is this forward
//                over swapaxes(w) in fp32);
//   gmm_dw    <- `_gmm_dw_kernel`:  dw[g] = sum_{gids[i] = g} x[i]^T dy[i];
//   gmm_visit <- `_visit_kernel`:   groups visited per block_rows block.
// Rows with gids == G are trash: they match no group and come out zero.
//
// What bounds it: each expert product is 2 * rows * d * h flops against
// (rows * (d + h) + d * h) elements moved, hundreds of flops a byte at the
// MoE widths, so operations; at h 4096 the fp32 y (285 MB at 17408 rows)
// comes close, so the epilogue's stores must not stall the products long.
// All three products run on the shared Hopper GEMM core (sm90.cuh): a
// persistent grid of one block an SM walks 128 x 256 output tiles, a
// producer warp brings K slices by TMA into an mbarrier ring and two
// consumer warpgroups run wgmma on it.
//  * gmm_fwd, bf16 x and w: 64-deep slices of x (TMA, 2-D) and of w[g]
//    (TMA, 3-D, four 64-column boxes, MN-major) in a 4-stage ring; the
//    consumers store fp32 float2 pairs straight from their accumulators,
//    while the producer already loads the next tile. The column tiles of
//    one row tile lie next to each other, so the blocks running together
//    read one expert's w[g] (8 MB at h1) while it sits in L2.
//  * The row-group skip of the TPU kernel: every warp reads the tile's gid
//    min and max and the tile runs one full product for each group g < G
//    that `ptt::blocks_can_touch(gmin, gmax, g, g)` admits, storing only
//    the rows with gids == g (one pass a tile on the dispatcher's
//    128-aligned buckets). A row's value is its own group's product, as
//    the masked sum of the JAX kernel gives, so any grouped layout is
//    exact; rows that no pass matched (trash) are stored as zeros. TMA's
//    zero fill covers rows past M, columns past N and a depth that is not
//    a multiple of the stage's.
//  * gmm_fwd, fp32 x (dy for dx): the same walk as split TF32 (sm90.cuh),
//    32-deep slices; w comes K-major as [G, N, D] (for dx that is w as it
//    lies, [G, d, h]; for a plain fp32 forward the wrapper's copy of w^T),
//    in hi (and lo) parts the wrapper makes; 2 passes when w came from
//    bf16, 3 otherwise, as the wrapper says.
//  * gmm_dw: dw[g]^T = dy_g^T . x_g, split TF32. TF32 wgmma reads only
//    K-major operands from shared memory and K is the token rows here, so
//    A = dy_g^T comes through registers (dy's [32 rows, 32 h] boxes as
//    they lie, read transposed, rows of other groups zeroed there) and B
//    = x_g^T from an fp32 copy x^T [D, M] that a transpose kernel makes
//    first (hi and lo when x is fp32; 2 passes for bf16 x, whose values
//    are exact in TF32, 3 for fp32). A tile of dw[g]^T (128 h x 256 d)
//    walks only the 32-row chunks whose gid range admits g, inside g's
//    window of chunks (a small pre-pass computes both), and is stored
//    transposed into dw[g]; a group with no rows stores zeros. One block
//    owns each tile: no atomics, a fixed summation order.
//
// Layouts, all contiguous: x [M, D], w [G, D, N] (bf16) or [G, N, D]
// (fp32, K-major), gids [M] int32, y [M, N] fp32, dy [M, N] fp32, dw
// [G, D, N] fp32; the x^T scratch is [D, M] fp32 with a row stride that
// is a multiple of 4. TMA row strides are multiples of 16 bytes: bf16
// gmm_fwd needs D % 8 == 0 and N % 8 == 0, the fp32 kernels D % 4 == 0
// and N % 4 == 0.
#include "common.cuh"
#include "sm90.cuh"

namespace sm90 = ptt::sm90;

namespace {

// ---- the forward: the sm90 GEMM core --------------------------------------

// The gid min and max of tile rows [m0, m0 + kBM) (rows past M count as
// trash, G), reduced over one warp, so every warp of the block reaches the
// same list of passes without a block barrier.
__device__ __forceinline__ void warp_gid_range(const int* __restrict__ gids,
                                               int m0, int M, int G,
                                               int& gmin, int& gmax) {
  int mn = INT_MAX, mx = INT_MIN;
  for (int i = threadIdx.x & 31; i < sm90::kBM; i += 32) {
    const int g = m0 + i < M ? gids[m0 + i] : G;
    mn = min(mn, g);
    mx = max(mx, g);
  }
  gmin = ptt::warp_min_i(mn);
  gmax = ptt::warp_max_i(mx);
}

// the thread's two accumulator rows (s0: row, s1: row + 8) of the 256
// columns from n0, as fp32 pairs; zero stores 0 instead
template <bool ZERO>
__device__ __forceinline__ void store_rows(float* __restrict__ y,
                                           const float (&acc)[128], int row,
                                           int col0, int N, bool s0,
                                           bool s1) {
  float* y0 = y + (long long)row * N;
  float* y1 = y0 + 8LL * N;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = col0 + 8 * j;
    if (col >= N) continue;
    if (s0)
      *reinterpret_cast<float2*>(y0 + col) =
          ZERO ? make_float2(0.f, 0.f)
               : make_float2(acc[4 * j], acc[4 * j + 1]);
    if (s1)
      *reinterpret_cast<float2*>(y1 + col) =
          ZERO ? make_float2(0.f, 0.f)
               : make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
gmm_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w,
                     const int* __restrict__ gids, float* __restrict__ y,
                     int M, int D, int N, int G) {
  extern __shared__ unsigned char smem[];
  sm90::Ring ring(sm90::ring_setup(smem));
  const int n_tiles = (N + sm90::kBN - 1) / sm90::kBN;
  const int tiles = (M + sm90::kBM - 1) / sm90::kBM * n_tiles;
  const int nk = (D + sm90::kBK - 1) / sm90::kBK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: warp 0 walks the passes, lane 0 issues the copies
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x < 32) {
      const bool issuer = threadIdx.x == 0;
      if (issuer) {
        sm90::prefetch_map(&tmap_x);
        sm90::prefetch_map(&tmap_w);
      }
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * sm90::kBM, n0 = t % n_tiles * sm90::kBN;
        int gmin, gmax;
        warp_gid_range(gids, m0, M, G, gmin, gmax);
        for (int g = 0; g < G; ++g) {
          if (!issuer || !ptt::blocks_can_touch(gmin, gmax, g, g)) continue;
          sm90::produce(ring, nk, [&](uint32_t sa, uint32_t sb, uint32_t bar,
                                      int k) {
            sm90::tma_load_2d(sa, &tmap_x, bar, k * sm90::kBK, m0);
#pragma unroll
            for (int j = 0; j < sm90::kBN / 64; ++j)
              sm90::tma_load_3d(sb + j * sm90::kBK * 128, &tmap_w, bar,
                                n0 + 64 * j, k * sm90::kBK, g);
          });
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 rows of each tile a warpgroup
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int c = wg - 1;
    const int r_in = 64 * c + sm90::acc_row0();
    float acc[128];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles * sm90::kBM, n0 = t % n_tiles * sm90::kBN;
      int gmin, gmax;
      warp_gid_range(gids, m0, M, G, gmin, gmax);
      const int row = m0 + r_in, col0 = n0 + sm90::acc_col0();
      const bool in0 = row < M, in1 = row + 8 < M;
      const int g0 = in0 ? gids[row] : G, g1 = in1 ? gids[row + 8] : G;
      for (int g = 0; g < G; ++g) {
        if (!ptt::blocks_can_touch(gmin, gmax, g, g)) continue;
        sm90::consume<1>(ring, nk, c, acc);
        store_rows<false>(y, acc, row, col0, N, in0 && g0 == g,
                          in1 && g1 == g);
      }
      // rows no pass matched: trash (gid G) or any id outside [0, G)
      store_rows<true>(y, acc, row, col0, N, in0 && (g0 < 0 || g0 >= G),
                       in1 && (g1 < 0 || g1 >= G));
    }
  }
}

template <int PASSES>
__global__ void __launch_bounds__(sm90::kThreads, 1)
gmm_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w,
                    const __grid_constant__ CUtensorMap tmap_wlo,
                    const int* __restrict__ gids, float* __restrict__ y,
                    int M, int D, int N, int G) {
  using Ring = sm90::RingTF32<PASSES>;
  extern __shared__ unsigned char smem[];
  Ring ring(sm90::ring_setup<Ring>(smem));
  const int n_tiles = (N + sm90::kBN - 1) / sm90::kBN;
  const int tiles = (M + sm90::kBM - 1) / sm90::kBM * n_tiles;
  const int nk = (D + sm90::kBK32 - 1) / sm90::kBK32;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: warp 0 walks the passes, lane 0 issues the copies
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x < 32) {
      const bool issuer = threadIdx.x == 0;
      if (issuer) {
        sm90::prefetch_map(&tmap_x);
        sm90::prefetch_map(&tmap_w);
        if (PASSES == 3) sm90::prefetch_map(&tmap_wlo);
      }
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * sm90::kBM, n0 = t % n_tiles * sm90::kBN;
        int gmin, gmax;
        warp_gid_range(gids, m0, M, G, gmin, gmax);
        for (int g = 0; g < G; ++g) {
          if (!issuer || !ptt::blocks_can_touch(gmin, gmax, g, g)) continue;
          sm90::produce(ring, nk, [&](uint32_t sa, uint32_t sb, uint32_t bar,
                                      int k) {
            sm90::tma_load_2d(sa, &tmap_x, bar, k * sm90::kBK32, m0);
            sm90::tma_load_3d(sb, &tmap_w, bar, k * sm90::kBK32, n0, g);
            if (PASSES == 3)
              sm90::tma_load_3d(sb + sm90::kB32Bytes, &tmap_wlo, bar,
                                k * sm90::kBK32, n0, g);
          });
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 rows of each tile a warpgroup
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int c = wg - 1;
    const int r_in = 64 * c + sm90::acc_row0();
    float acc[128];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles * sm90::kBM, n0 = t % n_tiles * sm90::kBN;
      int gmin, gmax;
      warp_gid_range(gids, m0, M, G, gmin, gmax);
      const int row = m0 + r_in, col0 = n0 + sm90::acc_col0();
      const bool in0 = row < M, in1 = row + 8 < M;
      const int g0 = in0 ? gids[row] : G, g1 = in1 ? gids[row + 8] : G;
      for (int g = 0; g < G; ++g) {
        if (!ptt::blocks_can_touch(gmin, gmax, g, g)) continue;
        for (int k = 0; k < nk; ++k)
          sm90::consume_tf32<PASSES, false>(ring, c, acc, k == 0, ~0u);
        store_rows<false>(y, acc, row, col0, N, in0 && g0 == g,
                          in1 && g1 == g);
      }
      store_rows<true>(y, acc, row, col0, N, in0 && (g0 < 0 || g0 >= G),
                       in1 && (g1 < 0 || g1 >= G));
    }
  }
}

// ---- dw: dw[g]^T = dy_g^T . x_g, split TF32 --------------------------------
constexpr int kChunk = sm90::kBK32;  // token rows a dw stage
constexpr int kWalkThreads = 256;
constexpr int kTile = 32;             // the x^T copy's square tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dw's B operand: xt [D, ld] = x [M, D]^T in fp32 (SPLIT: its TF32 hi, and
// the lo part in xt_lo), 32 x 32 tiles through shared memory so both the
// rows of x and the rows of x^T are read and written whole.
template <typename TX, bool SPLIT>
__global__ void __launch_bounds__(256)
gmm_xt_kernel(const TX* __restrict__ x, float* __restrict__ xt,
              float* __restrict__ xt_lo, int M, int D, int ld) {
  __shared__ float tile[kTile][kTile + 1];
  const int m0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int r = row; r < kTile; r += 8) {
    const int m = m0 + r, d = d0 + lane;
    tile[r][lane] = m < M && d < D ? to_f32(x[(long long)m * D + d]) : 0.f;
  }
  __syncthreads();
  for (int r = row; r < kTile; r += 8) {
    const int d = d0 + r, m = m0 + lane;
    if (d >= D || m >= M) continue;
    const float v = tile[lane][r];
    const long long o = (long long)d * ld + m;
    if (SPLIT) {
      const float hi = __uint_as_float(sm90::tf32_rna(v));
      xt[o] = hi;
      xt_lo[o] = __uint_as_float(sm90::tf32_rna(v - hi));
    } else {
      xt[o] = v;
    }
  }
}

// The dw walk, block g of G: every kChunk-row chunk's (gid min, gid max)
// over its rows below M (block 0 stores them in range), and window[g] =
// (first, last) chunk whose range admits g, or (INT_MAX, -1) for none.
__global__ void __launch_bounds__(kWalkThreads)
gmm_dw_walk_kernel(const int* __restrict__ gids, int2* __restrict__ range,
                   int2* __restrict__ window, int M, int nchunks) {
  __shared__ int red[2 * kWalkThreads / 32];
  const int g = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int first = INT_MAX, last = -1;
  for (int ci = threadIdx.x; ci < nchunks; ci += kWalkThreads) {
    int mn = INT_MAX, mx = INT_MIN;
    const int r0 = ci * kChunk;
    if (r0 + kChunk <= M) {  // a whole chunk: its loads issued together
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        mn = min(mn, gids[r0 + i]);
        mx = max(mx, gids[r0 + i]);
      }
    } else {
      for (int r = r0; r < M; ++r) {
        mn = min(mn, gids[r]);
        mx = max(mx, gids[r]);
      }
    }
    if (g == 0) range[ci] = make_int2(mn, mx);
    if (ptt::blocks_can_touch(mn, mx, g, g)) {
      first = min(first, ci);
      last = max(last, ci);
    }
  }
  first = ptt::warp_min_i(first);
  last = ptt::warp_max_i(last);
  if (lane == 0) {
    red[warp] = first;
    red[kWalkThreads / 32 + warp] = last;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWalkThreads / 32; ++i) {
      first = min(first, red[i]);
      last = max(last, red[kWalkThreads / 32 + i]);
    }
    window[g] = make_int2(first, last);
  }
}

// Bit j: chunk base + j (below `end`) has a gid range that admits g; the
// lane's own chunk's range in rg. Every lane of the warp calls it.
__device__ __forceinline__ uint32_t chunk_mask(const int2* __restrict__ range,
                                               int base, int end, int g,
                                               int2& rg) {
  const int ci = base + (threadIdx.x & 31);
  rg = ci < end ? range[ci] : make_int2(INT_MAX, INT_MIN);
  return __ballot_sync(0xffffffffu, ptt::blocks_can_touch(rg.x, rg.y, g, g));
}

// the thread's accumulators of a dw[g]^T tile (row: h, column: d) into
// dw[g] [D, N]: rows h and h + 8, columns d0c + 8 j + {0, 1}
__device__ __forceinline__ void store_dw(float* __restrict__ dwg,
                                         const float (&acc)[128], int h,
                                         int d0c, int D, int N) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = d0c + 8 * j + e;
      if (d >= D) continue;
      if (h < N) dwg[(long long)d * N + h] = acc[4 * j + e];
      if (h + 8 < N) dwg[(long long)d * N + h + 8] = acc[4 * j + 2 + e];
    }
  }
}

template <int PASSES>
__global__ void __launch_bounds__(sm90::kThreads, 1)
gmm_dw_tf32_kernel(const __grid_constant__ CUtensorMap tmap_dy,
                   const __grid_constant__ CUtensorMap tmap_xt,
                   const __grid_constant__ CUtensorMap tmap_xtlo,
                   const int* __restrict__ gids,
                   const int2* __restrict__ range,
                   const int2* __restrict__ window, float* __restrict__ dw,
                   int M, int D, int N, int G) {
  using Ring = sm90::RingTF32<PASSES>;
  extern __shared__ unsigned char smem[];
  Ring ring(sm90::ring_setup<Ring>(smem));
  const int d_tiles = (D + sm90::kBN - 1) / sm90::kBN;
  const int per_g = (N + sm90::kBM - 1) / sm90::kBM * d_tiles;
  const int tiles = G * per_g;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;

  if (wg == 0) {
    // ---- producer: warp 0 walks the chunks, lane 0 issues the copies
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x < 32) {
      const bool issuer = lane == 0;
      if (issuer) {
        sm90::prefetch_map(&tmap_dy);
        sm90::prefetch_map(&tmap_xt);
        if (PASSES == 3) sm90::prefetch_map(&tmap_xtlo);
      }
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int g = t / per_g, u = t % per_g;
        const int h0 = u / d_tiles * sm90::kBM, d0 = u % d_tiles * sm90::kBN;
        const int2 win = window[g];
        for (int base = win.x; base <= win.y; base += 32) {
          int2 rg;
          uint32_t mask = chunk_mask(range, base, win.y + 1, g, rg);
          while (mask) {
            const int r0 = (base + __ffs(mask) - 1) * kChunk;
            mask &= mask - 1;
            if (!issuer) continue;
            sm90::produce(ring, 1, [&](uint32_t sa, uint32_t sb,
                                       uint32_t bar, int) {
#pragma unroll
              for (int j = 0; j < sm90::kBM / 32; ++j)
                sm90::tma_load_2d(sa + j * sm90::kBK32 * 128, &tmap_dy, bar,
                                  h0 + 32 * j, r0);
              sm90::tma_load_2d(sb, &tmap_xt, bar, r0, d0);
              if (PASSES == 3)
                sm90::tma_load_2d(sb + sm90::kB32Bytes, &tmap_xtlo, bar, r0,
                                  d0);
            });
          }
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 h rows of each tile a warpgroup
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int c = wg - 1;
    const int h_in = 64 * c + sm90::acc_row0();
    float acc[128];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int g = t / per_g, u = t % per_g;
      const int h0 = u / d_tiles * sm90::kBM, d0 = u % d_tiles * sm90::kBN;
      const int2 win = window[g];
      bool first = true;
      for (int base = win.x; base <= win.y; base += 32) {
        int2 rg;
        uint32_t mask = chunk_mask(range, base, win.y + 1, g, rg);
        while (mask) {
          const int j = __ffs(mask) - 1;
          mask &= mask - 1;
          // the chunk's rows of g: all of them when its range is g alone
          // (rows past M are TMA's zeros), else by their ids
          const bool pure = __shfl_sync(0xffffffffu, rg.x, j) == g &&
                            __shfl_sync(0xffffffffu, rg.y, j) == g;
          const int row = (base + j) * kChunk + lane;
          const uint32_t keep =
              pure ? ~0u
                   : __ballot_sync(0xffffffffu, row < M && gids[row] == g);
          sm90::consume_tf32<PASSES, true>(ring, c, acc, first, keep);
          first = false;
        }
      }
      if (first) {  // g has no rows: zeros
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      }
      store_dw(dw + (long long)g * D * N, acc, h0 + h_in,
               d0 + sm90::acc_col0(), D, N);
    }
  }
}

// The visit counter: replaces `_visit_kernel` (paddle_tpu/ops/pallas/
// grouped_matmul.py:291, launched at :314), a grid step a block_rows block
// that tests the groups one after another. What bounds it on the H100: not
// bytes (4 bytes an id, read once) nor tests (one range test a block and
// group), both far under a microsecond at the dispatcher's layouts, but
// the launch and each warp's chain of dependent instructions (an H100
// launches a 1-element fill in about 0.0010 ms of device time). The design
// keeps that chain short:
//  * A block goes to a group of L lanes, L the least power of two (at most
//    32) that reads it in one load a lane: 16-byte loads (int4) where
//    bm % 4 == 0 and the ids are 16-byte aligned (the wrapper tests the
//    pointer), scalar loads otherwise; blocks past 128 ids (32 past 32
//    scalar ids) take more than one load a lane. So a warp reads 32 / L
//    blocks in one round of loads and reduces each to (min, max) in
//    log2(L) xor shuffles that stay inside its lane group, or, when a
//    block is the whole warp, in one redux.sync each (on an H100,
//    0.00127-0.00128 against 0.00134 ms with five shuffle steps at bm
//    128).
//  * Lane `sub` of a group tests g = sub + L j with ptt::blocks_can_touch,
//    the grouped forward kernel's own predicate, and one __ballot_sync
//    counts L groups of every block of the warp at once: each group
//    __popc's its own L bits. Every lane votes; lanes with g >= G vote
//    false, so padding rows (gid G) never match. At bm 128 a block is a
//    warp and a ballot counts 32 groups; at bm 8, 16 blocks share a warp
//    and a ballot counts 2 groups of each.
//  * The host plan (grouped_matmul.gmm_visit_plan) sizes the CTA at
//    kGmmVisitMinThreads or more and the grid at most one wave of the
//    card's SMs; a warp strides over the blocks past the first pass.
//  * The dispatcher's blocks with 16-byte loads (bm 128 at the main path's
//    widths, 32 and 8 for small problems: pick_block_rows) take
//    instantiations with the lanes, loads and shuffles fixed at compile
//    time (kBm): at times this close to the launch, the runtime block
//    arithmetic and the longer code it needs cost as much as the work (on
//    an H100, 0.00146 against 0.00133 ms at bm 128; 0.00142 for bm 8 on
//    the general body, where the parent's one-warp CTAs took 0.00132).
// Each count has one owner lane; no atomics, no shared memory.
constexpr int kGmmVisitMinThreads = 128;
constexpr int kGmmVisitMaxThreads = 1024;
constexpr int kGmmVisitFastBlock = 128;

template <typename T, int kBm>
__global__ void __launch_bounds__(kGmmVisitMaxThreads)
gmm_visit_kernel(const int* __restrict__ gids, int* __restrict__ counts,
                 int nb, int G, int bm) {
  constexpr int kIds = sizeof(T) / sizeof(int);
  const int per = (kBm > 0 ? kBm : bm) / kIds;      // loads a block, >= 1
  const int lg = per >= 32 ? 5 : 32 - __clz(per - 1);   // L = 2^lg lanes
  const int lanes = 1 << lg;
  const int lane = threadIdx.x & 31, sub = lane & (lanes - 1);
  const int grp = lane >> lg, bpw = 32 >> lg;       // blocks a warp
  // this group's bits of a ballot
  const unsigned seg = lg == 5 ? 0xffffffffu
                               : ((1u << lanes) - 1u) << (grp << lg);
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  for (int b0 = w * bpw; b0 < nb; b0 += warps * bpw) {   // warp-uniform
    const int blk = b0 + grp;
    const bool live = blk < nb;
    const T* p = reinterpret_cast<const T*>(gids + (long long)blk * bm);
    int lo = INT_MAX, hi = INT_MIN;
    if (live) {
      for (int j = sub; j < per; j += lanes) {
        const T v = __ldg(p + j);
        lo = min(lo, ptt::lo_of(v));
        hi = max(hi, ptt::hi_of(v));
      }
    }
    if (lg == 5) {          // a warp a block: one redux instruction each
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
    } else {                // xor shuffles that stay in the lane group
      for (int o = lanes >> 1; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
    }
    int n = 0;
    for (int g0 = 0; g0 < G; g0 += lanes) {             // warp-uniform
      const int g = g0 + sub;
      const bool touch = live && g < G && ptt::blocks_can_touch(lo, hi, g, g);
      n += __popc(__ballot_sync(0xffffffffu, touch) & seg);
    }
    if (live && sub == 0) counts[blk] = n;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns
// cudaGetLastError() after its launches (0 = launched). A tensor map that
// cannot be encoded returns ptt::sm90_host::kNoEncoder or kEncodeFailed +
// its CUresult.

namespace {

namespace host = ptt::sm90_host;
using host::launch_persistent;

template <int PASSES>
int gmm_fwd_tf32(const CUtensorMap& tx, const CUtensorMap& tw,
                 const CUtensorMap& twlo, const int* gids, float* y, int M,
                 int D, int N, int G, int device, cudaStream_t st) {
  const int tiles = (M + sm90::kBM - 1) / sm90::kBM *
                    ((N + sm90::kBN - 1) / sm90::kBN);
  return launch_persistent(gmm_fwd_tf32_kernel<PASSES>,
                           sm90::RingTF32<PASSES>::kSmemBytes, tiles, device,
                           st, tx, tw, twlo, gids, y, M, D, N, G);
}

template <int PASSES>
int gmm_dw_tf32(const CUtensorMap& tdy, const CUtensorMap& txt,
                const CUtensorMap& txtlo, const int* gids, const int2* range,
                const int2* window, float* dw, int M, int D, int N, int G,
                int device, cudaStream_t st) {
  const int tiles = G * ((N + sm90::kBM - 1) / sm90::kBM) *
                    ((D + sm90::kBN - 1) / sm90::kBN);
  return launch_persistent(gmm_dw_tf32_kernel<PASSES>,
                           sm90::RingTF32<PASSES>::kSmemBytes, tiles, device,
                           st, tdy, txt, txtlo, gids, range, window, dw, M, D,
                           N, G);
}

}  // namespace

// y [M, N] fp32 = x [M, D] @ w[gids]. passes 1: bf16 x and w, w [G, D, N]
// (one bf16 product); 2 or 3: fp32 x and w K-major [G, N, D], split TF32,
// w_lo w's lo part when 3 (2: w exact in TF32, w_lo unused).
extern "C" int ptt_gmm_fwd(const void* x, const void* w, const void* w_lo,
                           const int* gids, float* y, int M, int D, int N,
                           int G, int passes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  const bool bf16 = passes == 1;
  if (D <= 0 || G <= 0 || passes < 1 || passes > 3 ||
      N % (bf16 ? 8 : 4) != 0 || D % (bf16 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (M + sm90::kBM - 1) / sm90::kBM *
                    ((N + sm90::kBN - 1) / sm90::kBN);
  CUtensorMap tmap_x, tmap_w, tmap_wlo;
  if (bf16) {
    const cuuint64_t xdim[2] = {(cuuint64_t)D, (cuuint64_t)M};
    const cuuint64_t xstride[1] = {(cuuint64_t)D * 2};
    const cuuint32_t xbox[2] = {sm90::kBK, sm90::kBM};
    const cuuint64_t wdim[3] = {(cuuint64_t)N, (cuuint64_t)D, (cuuint64_t)G};
    const cuuint64_t wstride[2] = {(cuuint64_t)N * 2, (cuuint64_t)D * N * 2};
    const cuuint32_t wbox[3] = {64, sm90::kBK, 1};
    int e = host::encode_bf16(&tmap_x, x, 2, xdim, xstride, xbox);
    if (e == 0) e = host::encode_bf16(&tmap_w, w, 3, wdim, wstride, wbox);
    if (e != 0) return e;
    return launch_persistent(gmm_fwd_wgmma_kernel, sm90::kSmemBytes, tiles,
                             device, st, tmap_x, tmap_w, gids, y, M, D, N, G);
  }
  const cuuint64_t xdim[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstride[1] = {(cuuint64_t)D * 4};
  const cuuint32_t xbox[2] = {sm90::kBK32, sm90::kBM};
  const cuuint64_t wdim[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)G};
  const cuuint64_t wstride[2] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4};
  const cuuint32_t wbox[3] = {sm90::kBK32, sm90::kBN, 1};
  int e = host::encode_f32(&tmap_x, x, 2, xdim, xstride, xbox);
  if (e == 0) e = host::encode_f32(&tmap_w, w, 3, wdim, wstride, wbox);
  if (e == 0)
    e = host::encode_f32(&tmap_wlo, passes == 3 ? w_lo : w, 3, wdim, wstride,
                         wbox);
  if (e != 0) return e;
  return passes == 3
             ? gmm_fwd_tf32<3>(tmap_x, tmap_w, tmap_wlo, gids, y, M, D, N, G,
                               device, st)
             : gmm_fwd_tf32<2>(tmap_x, tmap_w, tmap_wlo, gids, y, M, D, N, G,
                               device, st);
}

// dw [G, D, N] fp32 = per-group x^T dy over the rows of each group, split
// TF32: x [M, D] bf16 (x_is_bf16 1: x^T exact in TF32, 2 passes) or fp32
// (3 passes), dy [M, N] fp32; xt and xt_lo are fp32 scratch [D, xt_ld]
// (xt_ld a multiple of 4, at least M; xt_lo unused for bf16 x) for x^T and
// its lo part, walk int2 scratch of ceil(M / 32) + G.
extern "C" int ptt_gmm_dw(const void* x, const float* dy, const int* gids,
                          float* xt, float* xt_lo, void* walk, float* dw,
                          int M, int D, int N, int G, int xt_ld,
                          int x_is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || D <= 0 || N <= 0) return 0;
  if (M <= 0 || N % 4 != 0 || D % 4 != 0 || xt_ld % 4 != 0 || xt_ld < M ||
      (D + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = x_is_bf16 ? 2 : 3;
  const int nchunks = (M + kChunk - 1) / kChunk;
  int2* range = static_cast<int2*>(walk);
  int2* window = range + nchunks;
  CUtensorMap tmap_dy, tmap_xt, tmap_xtlo;
  const cuuint64_t ydim[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t ystride[1] = {(cuuint64_t)N * 4};
  const cuuint32_t ybox[2] = {32, kChunk};
  const cuuint64_t tdim[2] = {(cuuint64_t)M, (cuuint64_t)D};
  const cuuint64_t tstride[1] = {(cuuint64_t)xt_ld * 4};
  const cuuint32_t tbox[2] = {kChunk, sm90::kBN};
  int e = host::encode_f32(&tmap_dy, dy, 2, ydim, ystride, ybox);
  if (e == 0) e = host::encode_f32(&tmap_xt, xt, 2, tdim, tstride, tbox);
  if (e == 0)
    e = host::encode_f32(&tmap_xtlo, passes == 3 ? xt_lo : xt, 2, tdim,
                         tstride, tbox);
  if (e != 0) return e;
  const dim3 tgrid((M + kTile - 1) / kTile, (D + kTile - 1) / kTile);
  if (x_is_bf16)
    gmm_xt_kernel<__nv_bfloat16, false><<<tgrid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xt, nullptr, M, D, xt_ld);
  else
    gmm_xt_kernel<float, true><<<tgrid, 256, 0, st>>>(
        static_cast<const float*>(x), xt, xt_lo, M, D, xt_ld);
  gmm_dw_walk_kernel<<<G, kWalkThreads, 0, st>>>(gids, range, window, M,
                                                  nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return passes == 3
             ? gmm_dw_tf32<3>(tmap_dy, tmap_xt, tmap_xtlo, gids, range,
                              window, dw, M, D, N, G, device, st)
             : gmm_dw_tf32<2>(tmap_dy, tmap_xt, tmap_xtlo, gids, range,
                              window, dw, M, D, N, G, device, st);
}

// counts [M / bm] int32: groups visited per bm-row block (M % bm == 0).
// vec: read the ids by 16-byte loads (bm % 4 == 0, gids 16-byte aligned);
// grid and threads: the host plan (grouped_matmul.gmm_visit_plan).
extern "C" int ptt_gmm_visit(const int* gids, int* counts, int M, int G,
                             int bm, int vec, int grid, int threads,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bm <= 0 || M % bm != 0 || G < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (grid <= 0 || threads < 32 || threads > kGmmVisitMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (bm % 4 != 0 || reinterpret_cast<uintptr_t>(gids) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = M / bm;
  if (vec && bm == kGmmVisitFastBlock)
    gmm_visit_kernel<int4, kGmmVisitFastBlock>
        <<<grid, threads, 0, st>>>(gids, counts, nb, G, bm);
  else if (vec && bm == 32)
    gmm_visit_kernel<int4, 32><<<grid, threads, 0, st>>>(gids, counts, nb, G,
                                                         bm);
  else if (vec && bm == 8)
    gmm_visit_kernel<int4, 8><<<grid, threads, 0, st>>>(gids, counts, nb, G,
                                                        bm);
  else if (vec)
    gmm_visit_kernel<int4, 0><<<grid, threads, 0, st>>>(gids, counts, nb, G,
                                                         bm);
  else
    gmm_visit_kernel<int, 0><<<grid, threads, 0, st>>>(gids, counts, nb, G,
                                                       bm);
  return (int)cudaGetLastError();
}
