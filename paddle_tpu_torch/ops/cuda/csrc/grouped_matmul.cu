// Grouped (ragged) matmul for Hopper (sm_90a): the dropless-MoE expert
// products. Replaces the TPU kernels of paddle_tpu/ops/pallas/
// grouped_matmul.py:
//   gmm_fwd   <- `_gmm_fwd_kernel`: y[i] = x[i] @ w[gids[i]], fp32 out;
//                also dx = dy @ w[g]^T (the wrapper hands a transposed
//                fp32 copy of w, as the JAX VJP does);
//   gmm_dw    <- `_gmm_dw_kernel`:  dw[g] = sum_{gids[i] = g} x[i]^T dy[i];
//   gmm_visit <- `_visit_kernel`:   groups visited per block_rows block.
// Rows with gids == G are trash: they match no group and come out zero.
//
// What bounds it: each expert product is 2 * rows * d * h flops against
// (rows * (d + h) + d * h) elements moved, hundreds of flops a byte at the
// MoE widths, so operations; at h 4096 the fp32 y (285 MB at 17408 rows)
// comes close, so the epilogue's stores must not stall the products long.
// The design:
//  * gmm_fwd, bf16 x and w: the shared Hopper GEMM core (sm90.cuh). A
//    persistent grid of one block an SM walks 128-row x 256-column output
//    tiles, the column tiles of one row tile next to each other, so the
//    blocks running together read one expert's w[g] (8 MB at h1) while it
//    sits in L2. A producer warp brings 64-deep slices of x (TMA, 2-D) and
//    of w[g] (TMA, 3-D, four 64-column boxes, MN-major) into a 4-stage
//    ring; two consumer warpgroups run wgmma m64n256k16 on it and store
//    fp32 float2 pairs straight from their accumulators, while the
//    producer already loads the next tile.
//  * The row-group skip of the TPU kernel: every warp reads the tile's gid
//    min and max and the tile runs one full product for each group g < G
//    that `ptt::blocks_can_touch(gmin, gmax, g, g)` admits, storing only
//    the rows with gids == g (one pass a tile on the dispatcher's
//    128-aligned buckets). A row's value is its own group's product, as
//    the masked sum of the JAX kernel gives, so any grouped layout is
//    exact; rows that no pass matched (trash) are stored as zeros. TMA's
//    zero fill covers rows past M, columns past h and a d that is not a
//    multiple of 64.
//  * gmm_fwd, fp32: a 64 x 128 tile, 4 x 8 outputs a thread, on the CUDA
//    cores (the tensor cores would round fp32 to tf32), with the same
//    group skip (the rows of other groups loaded as zeros);
//  * gmm_dw: one [64 (d), 128 (h)] tile of one group's dw[g] a block,
//    walking the 16-row chunks of x and dy whose gid range touches g (the
//    ranges come from a small pre-pass) with rows of other groups zeroed;
//    fp32 math on the CUDA cores (dy is fp32, as in the JAX backward).
//
// Layouts, all contiguous: x [M, D], w [G, D, N], gids [M] int32, y [M, N]
// fp32, dy [M, N] fp32, dw [G, D, N] fp32. bf16 gmm_fwd needs D % 8 == 0
// (TMA row strides are multiples of 16 bytes), fp32 gmm_fwd D % 16 == 0,
// gmm_dw D % 8 == 0; all need N % 8 == 0.
#include "common.cuh"
#include "sm90.cuh"

namespace sm90 = ptt::sm90;

namespace {

constexpr int kThreads = 256;  // the CUDA-core kernels

// Group ids of a block's `rows` rows into sg (rows past M count as trash,
// G), and their min and max over the block. Every thread calls it.
__device__ __forceinline__ void tile_gid_range(const int* __restrict__ gids,
                                               int m0, int rows, int M, int G,
                                               int* sg, int* red, int& gmin,
                                               int& gmax) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int mn = INT_MAX, mx = INT_MIN;
  if (tid < rows) {
    const int r = m0 + tid;
    const int g = r < M ? gids[r] : G;
    sg[tid] = g;
    mn = mx = g;
  }
  mn = ptt::warp_min_i(mn);
  mx = ptt::warp_max_i(mx);
  if (lane == 0) {
    red[warp] = mn;
    red[kThreads / 32 + warp] = mx;
  }
  __syncthreads();
  gmin = INT_MAX;
  gmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    gmin = min(gmin, red[i]);
    gmax = max(gmax, red[kThreads / 32 + i]);
  }
}

// ---- bf16 forward: the sm90 GEMM core -------------------------------------

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

// ---- fp32 paths: CUDA cores -----------------------------------------------
constexpr int kBR = 64;    // output rows per block (gmm_dw: rows of dw[g])
constexpr int kBN = 128;   // output columns per block
constexpr int kBK = 16;    // depth of a staged slice (gmm_dw: token rows)

// acc[r][c] += sum_kk as[kk][4 ty + r] * bs[kk][col c] over one staged
// slice; thread (ty, tx) owns rows 4 ty + r and columns 4 tx + c and
// 64 + 4 tx + c.
__device__ __forceinline__ void simt_slice(const float (*as)[kBR],
                                           const float (*bs)[kBN + 4],
                                           float (&acc)[4][8], int tx,
                                           int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] += av[r] * bv[c];
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[4][8], int r0,
                                           int c0, int rows, int cols,
                                           int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h * 64 + tx * 4;
      if (col < cols)
        *reinterpret_cast<float4*>(out + (long long)row * cols + col) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
    }
  }
}

__device__ __forceinline__ void zero8(float* v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
gmm_fwd_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ gids, float* __restrict__ y,
                    int M, int D, int N, int G) {
  __shared__ __align__(16) float as[kBK][kBR];       // x slice, transposed
  __shared__ __align__(16) float bs[kBK][kBN + 4];   // w slice
  __shared__ int sg[kBR];
  __shared__ int red[2 * kThreads / 32];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBR, n0 = blockIdx.x * kBN;
  int gmin, gmax;
  tile_gid_range(gids, m0, kBR, M, G, sg, red, gmin, gmax);

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    if (!ptt::blocks_can_touch(gmin, gmax, g, g)) continue;
    const float* wg = w + (long long)g * D * N;
    for (int k0 = 0; k0 < D; k0 += kBK) {
      __syncthreads();  // the previous slice's readers are done
      float v[8];
      if (tid < 2 * kBR) {
        const int r = tid >> 1, c = (tid & 1) * 8;
        if (sg[r] == g)
          ptt::load8(x + (long long)(m0 + r) * D + k0 + c, v);
        else
          zero8(v);
#pragma unroll
        for (int i = 0; i < 8; ++i) as[c + i][r] = v[i];
      }
      {
        const int r = tid >> 4, c = (tid & 15) * 8;
        if (n0 + c < N)
          ptt::load8(wg + (long long)(k0 + r) * N + n0 + c, v);
        else
          zero8(v);
        *reinterpret_cast<float4*>(&bs[r][c]) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(&bs[r][c + 4]) = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      simt_slice(as, bs, acc, tx, ty);
    }
  }
  store_tile(y, acc, m0, n0, M, N, tx, ty);
}

// (min, max) gid of every kBK-row chunk of x / dy (rows past M ignored).
__global__ void gmm_chunk_range_kernel(const int* __restrict__ gids,
                                       int2* __restrict__ range, int M,
                                       int nchunks) {
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= nchunks) return;
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = ci * kBK; r < min(M, (ci + 1) * kBK); ++r) {
    mn = min(mn, gids[r]);
    mx = max(mx, gids[r]);
  }
  range[ci] = make_int2(mn, mx);
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
gmm_dw_kernel(const TX* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ gids, const int2* __restrict__ range,
              float* __restrict__ dw, int M, int D, int N) {
  __shared__ __align__(16) float as[kBK][kBR];       // x^T slice: [row][d]
  __shared__ __align__(16) float bs[kBK][kBN + 4];   // dy slice: [row][h]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int g = blockIdx.z, d0 = blockIdx.y * kBR, n0 = blockIdx.x * kBN;
  const int nchunks = (M + kBK - 1) / kBK;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    const int2 rg = range[ci];
    if (!ptt::blocks_can_touch(rg.x, rg.y, g, g)) continue;  // block-uniform
    const int r0 = ci * kBK;
    __syncthreads();  // the previous slice's readers are done
    float v[8];
    if (tid < 2 * kBR) {
      const int r = tid >> 3, c = (tid & 7) * 8, row = r0 + r;
      if (row < M && d0 + c < D && gids[row] == g)
        ptt::load8(x + (long long)row * D + d0 + c, v);
      else
        zero8(v);
      *reinterpret_cast<float4*>(&as[r][c]) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&as[r][c + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    }
    {
      const int r = tid >> 4, c = (tid & 15) * 8, row = r0 + r;
      if (row < M && n0 + c < N)
        ptt::load8(dy + (long long)row * N + n0 + c, v);
      else
        zero8(v);
      *reinterpret_cast<float4*>(&bs[r][c]) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&bs[r][c + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    simt_slice(as, bs, acc, tx, ty);
  }
  // a group with no rows writes zeros
  store_tile(dw + (long long)g * D * N, acc, d0, n0, D, N, tx, ty);
}

// One warp a block_rows block: its gid min and max, then the count of the
// groups g < G the forward kernel's predicate admits.
__global__ void gmm_visit_kernel(const int* __restrict__ gids,
                                 int* __restrict__ counts, int G, int bm) {
  const int blk = blockIdx.x, lane = threadIdx.x;
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = lane; r < bm; r += 32) {
    const int v = gids[(long long)blk * bm + r];
    mn = min(mn, v);
    mx = max(mx, v);
  }
  mn = ptt::warp_min_i(mn);
  mx = ptt::warp_max_i(mx);
  if (lane == 0) {
    int c = 0;
    for (int g = 0; g < G; ++g) c += ptt::blocks_can_touch(mn, mx, g, g);
    counts[blk] = c;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns
// cudaGetLastError() after its launches (0 = launched).

// y [M, N] fp32 = x [M, D] @ w[gids] ([G, D, N]); is_bf16: 1 bf16 x and w
// (tensor cores, TMA and wgmma), 0 fp32 x and w (CUDA cores). A tensor map
// that cannot be encoded returns ptt::sm90_host::kNoEncoder or
// kEncodeFailed + its CUresult.
extern "C" int ptt_gmm_fwd(const void* x, const void* w, const int* gids,
                           float* y, int M, int D, int N, int G, int is_bf16,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  if (D <= 0 || G <= 0 || N % 8 != 0 || D % (is_bf16 ? 8 : kBK) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace host = ptt::sm90_host;
    CUtensorMap tmap_x, tmap_w;
    const cuuint64_t xdim[2] = {(cuuint64_t)D, (cuuint64_t)M};
    const cuuint64_t xstride[1] = {(cuuint64_t)D * 2};
    const cuuint32_t xbox[2] = {sm90::kBK, sm90::kBM};
    const cuuint64_t wdim[3] = {(cuuint64_t)N, (cuuint64_t)D, (cuuint64_t)G};
    const cuuint64_t wstride[2] = {(cuuint64_t)N * 2, (cuuint64_t)D * N * 2};
    const cuuint32_t wbox[3] = {64, sm90::kBK, 1};
    int e = host::encode_bf16(&tmap_x, x, 2, xdim, xstride, xbox);
    if (e == 0) e = host::encode_bf16(&tmap_w, w, 3, wdim, wstride, wbox);
    if (e != 0) return e;
    err = host::opt_in_smem(gmm_fwd_wgmma_kernel, device);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (M + sm90::kBM - 1) / sm90::kBM *
                      ((N + sm90::kBN - 1) / sm90::kBN);
    gmm_fwd_wgmma_kernel<<<host::persistent_blocks(device, tiles),
                           sm90::kThreads, sm90::kSmemBytes, st>>>(
        tmap_x, tmap_w, gids, y, M, D, N, G);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBR - 1) / kBR);
    gmm_fwd_simt_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), gids, y,
        M, D, N, G);
  }
  return (int)cudaGetLastError();
}

// dw [G, D, N] fp32 = per-group x^T dy over the rows of each group; x [M, D]
// bf16 (x_is_bf16 1) or fp32, dy [M, N] fp32; range is int2 scratch of
// ceil(M / 16) chunks.
extern "C" int ptt_gmm_dw(const void* x, const float* dy, const int* gids,
                          void* range, float* dw, int M, int D, int N, int G,
                          int x_is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || D <= 0 || N <= 0) return 0;
  if (M < 0 || N % 8 != 0 || D % 8 != 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (M + kBK - 1) / kBK;
  int2* rg = static_cast<int2*>(range);
  if (nchunks > 0) {
    gmm_chunk_range_kernel<<<(nchunks + 255) / 256, 256, 0, st>>>(gids, rg, M,
                                                                  nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + kBN - 1) / kBN, (D + kBR - 1) / kBR, G);
  if (x_is_bf16)
    gmm_dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), dy, gids, rg, dw, M, D, N);
  else
    gmm_dw_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), dy, gids, rg, dw, M, D, N);
  return (int)cudaGetLastError();
}

// counts [M / bm] int32: groups visited per bm-row block (M % bm == 0).
extern "C" int ptt_gmm_visit(const int* gids, int* counts, int M, int G,
                             int bm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bm <= 0 || M % bm != 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  gmm_visit_kernel<<<M / bm, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      gids, counts, G, bm);
  return (int)cudaGetLastError();
}
