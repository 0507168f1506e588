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
// MoE widths, so operations. The design:
//  * gmm_fwd, bf16 x and w: one 128-row x 128-column output tile a block,
//    8 warps as 4 x 2 of 32 x 64 sub-tiles on mma.sync m16n8k16 with fp32
//    accumulation, 32-deep slices of x and w double-buffered in shared
//    memory with cp.async (rows padded so ldmatrix is conflict-free; w's
//    [d, h] slice is read transposed by ldmatrix.trans);
//  * gmm_fwd, fp32: a 64 x 128 tile, 4 x 8 outputs a thread, on the CUDA
//    cores (the tensor cores would round fp32 to tf32);
//  * the row-group skip of the TPU kernel: a block reads its rows' gid
//    min and max once and runs the d loop only for the groups g < G that
//    `ptt::blocks_can_touch(gmin, gmax, g, g)` admits (one group per tile
//    on the dispatcher's 128-aligned buckets), loading the rows of other
//    groups as zeros (cp.async zero-fill), so any grouped layout is exact;
//  * gmm_dw: one [64 (d), 128 (h)] tile of one group's dw[g] a block,
//    walking the 16-row chunks of x and dy whose gid range touches g (the
//    ranges come from a small pre-pass) with rows of other groups zeroed;
//    fp32 math on the CUDA cores (dy is fp32, as in the JAX backward).
//
// Layouts, all contiguous: x [M, D], w [G, D, N], gids [M] int32, y [M, N]
// fp32, dy [M, N] fp32, dw [G, D, N] fp32. bf16 gmm_fwd needs D % 32 == 0,
// fp32 gmm_fwd D % 16 == 0, gmm_dw D % 8 == 0; all need N % 8 == 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---- bf16 forward: mma.sync ------------------------------------------------
constexpr int kMBM = 128;           // rows per block
constexpr int kMBN = 128;           // columns per block
constexpr int kMBK = 32;            // depth of a staged slice
constexpr int kMALd = kMBK + 8;     // padded shared rows, in bf16
constexpr int kMBLd = kMBN + 8;

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

__global__ void __launch_bounds__(kThreads)
gmm_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ gids, float* __restrict__ y, int M,
                   int D, int N, int G) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kMBM][kMALd];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kMBK][kMBLd];
  __shared__ int sg[kMBM];
  __shared__ int red[2 * kThreads / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;   // 32 rows x 64 columns a warp
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kMBM, n0 = blockIdx.x * kMBN;
  int gmin, gmax;
  tile_gid_range(gids, m0, kMBM, M, G, sg, red, gmin, gmax);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int nk = D / kMBK;
  for (int g = 0; g < G; ++g) {
    if (!ptt::blocks_can_touch(gmin, gmax, g, g)) continue;
    const __nv_bfloat16* wg = w + (long long)g * D * N;
    // one slice: x 128 x 32 and w 32 x 128, two 16-byte copies each a
    // thread; rows of other groups (and trash rows) are zero-filled
    auto issue = [&](int stage, int k0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * kThreads, r = e >> 2, c = (e & 3) * 8;
        const bool hit = sg[r] == g;
        ptt::cp_async16(&as[stage][r][c],
                        x + (long long)(hit ? m0 + r : 0) * D + k0 + c,
                        hit ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * kThreads, r = e >> 4, c = (e & 15) * 8;
        const bool in = n0 + c < N;
        ptt::cp_async16(&bs[stage][r][c],
                        wg + (long long)(k0 + r) * N + (in ? n0 + c : 0),
                        in ? 16 : 0);
      }
      ptt::cp_async_commit();
    };
    __syncthreads();  // the previous group's readers of both stages are done
    issue(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      ptt::cp_async_wait_all();
      __syncthreads();  // slice kt landed; slice kt - 1's readers are done
      if (kt + 1 < nk) issue((kt + 1) & 1, (kt + 1) * kMBK);  // overlaps
      const int st = kt & 1;
#pragma unroll
      for (int kk = 0; kk < kMBK; kk += 16) {
        uint32_t a[2][4], b[8][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ptt::ldmatrix_x4(a[mt], &as[st][wm * 32 + mt * 16 + (lane & 15)]
                                     [kk + (lane >> 4) * 8]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ptt::ldmatrix_x4_trans(
              r, &bs[st][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                        [wn * 64 + np * 16 + (lane >> 4) * 8]);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            ptt::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
      }
    }
  }

  // every block writes its whole tile: rows no visited group matched
  // (trash rows included) are zero
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = m0 + wm * 32 + mt * 16 + gid;
      const int col = n0 + wn * 64 + nt * 8 + tig * 2;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<float2*>(y + (long long)row * N + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(y + (long long)(row + 8) * N + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
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
// (tensor cores), 0 fp32 x and w (CUDA cores).
extern "C" int ptt_gmm_fwd(const void* x, const void* w, const int* gids,
                           float* y, int M, int D, int N, int G, int is_bf16,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  if (D <= 0 || G <= 0 || N % 8 != 0 || D % (is_bf16 ? kMBK : kBK) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((N + kMBN - 1) / kMBN, (M + kMBM - 1) / kMBM);
    gmm_fwd_mma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), gids, y, M, D, N, G);
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
