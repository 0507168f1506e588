// Fused linear + cross-entropy statistics for Hopper (sm_90a): bf16 inputs
// on the tensor cores (the shared GEMM core of sm90.cuh: TMA, an mbarrier
// ring, wgmma), fp32 inputs on the CUDA cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ce.py
// `_ce_stats_kernel` (launched by `_stats_pallas`). For every token n it
// computes, over the logits row x[n] . W^T that is never stored:
//   m  = max_v logit,  s = sum_v exp(logit - m),
//   t  = logit[label[n]] (0 when the label is outside [0, V)),
//   sl = sum_v logit.
//
// What bounds it: the tile product, 2 N V H flops (1.07 TFLOP at N 4096,
// H 4096, V 32000) against 2 (N + V) H bytes, so operations; the next
// limit is how often W (262 MB, more than L2) and x are read again.
//  * bf16 (ce_stats_wgmma_kernel): a persistent grid of one block an SM.
//    A work unit is one 128-token block and one split's contiguous range
//    of 256-column vocab tiles; a producer warp streams 64-deep slices of
//    x and W (both K-major) by TMA into a 4-stage ring, two consumer
//    warpgroups run wgmma m64n256k16 on them (W read from shared memory,
//    twice the tile of the mma.sync kernel it replaces, so half the L2
//    reads of W and x) and fold each finished 128 x 256 tile into the
//    running (m, s, t, sl) in their accumulators: a row lives in one quad
//    of 4 lanes, so its max takes two shuffles, and each lane keeps its
//    share of s, t and sl until the unit ends. exp2 with log2(e) folded
//    into one multiply-add a logit, on the SFU. Only the last vocab tile
//    masks columns >= V (TMA reads them as zeros). Units run split-major,
//    so the blocks running at one time share a vocab range and W streams
//    from device memory about once a wave.
//  * fp32 (ce_stats_partial_kernel): a 64-token x 128-vocab tile, 4 x 8
//    outputs a thread from 16-wide H slices, on the CUDA cores (the tensor
//    cores would round fp32 to tf32), with the same online fold.
//
// Both write partial statistics per vocab split (split j covers tiles_per_
// split 256-column tiles), and a second small kernel merges the splits
// (m = max m_j, s = sum s_j exp(m_j - m), t and sl summed), as the paged
// kernel's split-K does; the wrapper picks the split so that token blocks
// x splits fill the grid.
//
// Layout: x [N, H] and W [V, H] contiguous (H a multiple of 8 for bf16:
// TMA row strides are multiples of 16 bytes; 16 for fp32), labels [N]
// int32; partial statistics [4, nsplit, N] fp32; m, s, t, sl [N] fp32.
#include "common.cuh"
#include "sm90.cuh"

namespace sm90 = ptt::sm90;

namespace {

constexpr int kSplitCols = sm90::kBN;  // vocab columns a split counts in
constexpr int kBR = 64;    // tokens per block (fp32 path)
constexpr int kBV = 128;   // vocab columns per tile (fp32 path)
constexpr int kBH = 16;    // H slice staged per step (fp32 path)
constexpr int kThreads = 256;

// Fold 8 logits of one token row (column col[c], counted when < V) into
// the running statistics, after reducing the tile's row over the WIDTH
// lanes that share the row (xor shuffles stay inside aligned lane groups).
template <int WIDTH>
__device__ __forceinline__ void fold_row(const float (&val)[8],
                                         const int (&col)[8], int V, int lab,
                                         float& m, float& s, float& t,
                                         float& sl) {
  float bm = ptt::kNegInf;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (col[c] < V) bm = fmaxf(bm, val[c]);
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
  const float nm = fmaxf(m, bm);
  float se = 0.f, tt = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (col[c] < V) {
      se += expf(val[c] - nm);
      ss += val[c];
      if (col[c] == lab) tt += val[c];
    }
  }
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    se += __shfl_xor_sync(0xffffffffu, se, o);
    tt += __shfl_xor_sync(0xffffffffu, tt, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  s = s * expf(m - nm) + se;
  m = nm;
  t += tt;
  sl += ss;
}

__global__ void __launch_bounds__(kThreads)
ce_stats_partial_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const int* __restrict__ labels,
                        float* __restrict__ part, int N, int V, int H,
                        int tiles_per_split) {
  // transposed slices: xs[h][token], ws[h][vocab]; float4 reads along the
  // token / vocab axis
  __shared__ __align__(16) float xs[kBH][kBR];
  __shared__ __align__(16) float ws[kBH][kBV + 4];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBR;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int v_begin = split * tiles_per_split * kSplitCols;
  const int v_end = min(V, v_begin + tiles_per_split * kSplitCols);

  // thread (ty, tx) owns tokens n0 + 4 ty + r and vocab columns
  // tx * 4 + c and 64 + tx * 4 + c of each tile; the 16 threads of a
  // half-warp share their tokens
  int lab[4];
  float m[4], s[4], t[4], sl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty * 4 + r;
    lab[r] = n < N ? labels[n] : -1;
    m[r] = ptt::kNegInf;
    s[r] = t[r] = sl[r] = 0.f;
  }

  for (int v0 = v_begin; v0 < v_end; v0 += kBV) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int h0 = 0; h0 < H; h0 += kBH) {
      __syncthreads();  // the previous slice's readers are done
      {
        const int r = tid >> 1, c = (tid & 1) * 8;
        float tv[8];
        if (r < kBR) {
          if (n0 + r < N) {
            ptt::load8(x + (long long)(n0 + r) * H + h0 + c, tv);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) tv[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) xs[c + i][r] = tv[i];
        }
        if (v0 + r < V) {
          ptt::load8(w + (long long)(v0 + r) * H + h0 + c, tv);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) tv[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) ws[c + i][r] = tv[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBH; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += av[r] * bv[c];
      }
    }

    // fold the finished [64, 128] tile into the running statistics
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int col[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        col[c] = v0 + (c < 4 ? tx * 4 + c : 60 + tx * 4 + c);
      fold_row<16>(acc[r], col, V, lab[r], m[r], s[r], t[r], sl[r]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + ty * 4 + r;
      if (n >= N) continue;
      part[(0LL * nsplit + split) * N + n] = m[r];
      part[(1LL * nsplit + split) * N + n] = s[r];
      part[(2LL * nsplit + split) * N + n] = t[r];
      part[(3LL * nsplit + split) * N + n] = sl[r];
    }
  }
}

// Fold the thread's two rows of a finished 64 x 256 accumulator tile
// (columns col0 + 8 j + e, e < 2) into its running statistics: the row max
// over the quad, then this lane's share of sum exp, the target logit and
// the sum. MASK: columns >= V (zeros read past the vocab) are left out.
template <bool MASK>
__device__ __forceinline__ void fold_tile(const float (&acc)[128], int col0,
                                          int V, const int (&lab)[2],
                                          float (&m)[2], float (&s)[2],
                                          float (&t)[2], float (&sl)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float bm = ptt::kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!MASK || col0 + 8 * j + e < V)
          bm = fmaxf(bm, acc[4 * j + 2 * h + e]);
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
    const float nm = fmaxf(m[h], bm), nml = nm * ptt::kLog2e;
    const int rel = lab[h] - col0;  // the label's place in these columns
    float se = 0.f, ss = 0.f, tt = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc[4 * j + 2 * h + e];
        if (!MASK || col0 + 8 * j + e < V) {
          se += ptt::exp2_ftz(fmaf(v, ptt::kLog2e, -nml));
          ss += v;
          if (8 * j + e == rel) tt = v;
        }
      }
    s[h] = s[h] * ptt::exp2_ftz((m[h] - nm) * ptt::kLog2e) + se;
    m[h] = nm;
    t[h] += tt;
    sl[h] += ss;
  }
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
ce_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_w,
                      const int* __restrict__ labels,
                      float* __restrict__ part, int N, int V, int H,
                      int nsplit, int tiles_per_split) {
  extern __shared__ unsigned char smem[];
  sm90::Ring ring(sm90::ring_setup(smem));
  const int nblk = (N + sm90::kBM - 1) / sm90::kBM;
  const int units = nblk * nsplit;
  const int nk = (H + sm90::kBK - 1) / sm90::kBK;
  const int span = tiles_per_split * kSplitCols;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: one thread issues the copies
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tmap_x);
      sm90::prefetch_map(&tmap_w);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int split = u / nblk, n0 = u % nblk * sm90::kBM;
        const int v_end = min(V, (split + 1) * span);
        for (int v0 = split * span; v0 < v_end; v0 += sm90::kBN)
          sm90::produce(ring, nk, [&](uint32_t sa, uint32_t sb, uint32_t bar,
                                      int k) {
            sm90::tma_load_2d(sa, &tmap_x, bar, k * sm90::kBK, n0);
            sm90::tma_load_2d(sb, &tmap_w, bar, k * sm90::kBK, v0);
          });
      }
    }
  } else {
    // ---- consumers: 64 tokens of each unit a warpgroup
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int r_in = 64 * (wg - 1) + sm90::acc_row0();
    float acc[128];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int split = u / nblk, n0 = u % nblk * sm90::kBM;
      const int v_end = min(V, (split + 1) * span);
      const int row = n0 + r_in;
      const int lab[2] = {row < N ? labels[row] : -1,
                          row + 8 < N ? labels[row + 8] : -1};
      float m[2] = {ptt::kNegInf, ptt::kNegInf}, s[2] = {0.f, 0.f},
            t[2] = {0.f, 0.f}, sl[2] = {0.f, 0.f};
      for (int v0 = split * span; v0 < v_end; v0 += sm90::kBN) {
        sm90::consume<0>(ring, nk, wg - 1, acc);
        const int col0 = v0 + sm90::acc_col0();
        if (v0 + sm90::kBN <= V)
          fold_tile<false>(acc, col0, V, lab, m, s, t, sl);
        else
          fold_tile<true>(acc, col0, V, lab, m, s, t, sl);
      }
      // the quad's shares of each row, then the split's partial
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
          t[h] += __shfl_xor_sync(0xffffffffu, t[h], o);
          sl[h] += __shfl_xor_sync(0xffffffffu, sl[h], o);
        }
      if ((threadIdx.x & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = row + 8 * h;
          if (n >= N) continue;
          part[(0LL * nsplit + split) * N + n] = m[h];
          part[(1LL * nsplit + split) * N + n] = s[h];
          part[(2LL * nsplit + split) * N + n] = t[h];
          part[(3LL * nsplit + split) * N + n] = sl[h];
        }
      }
    }
  }
}

__global__ void ce_stats_merge_kernel(const float* __restrict__ part,
                                      float* __restrict__ m,
                                      float* __restrict__ s,
                                      float* __restrict__ t,
                                      float* __restrict__ sl, int N,
                                      int nsplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float mx = ptt::kNegInf;
  for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, part[(long long)j * N + n]);
  float se = 0.f, tt = 0.f, ss = 0.f;
  for (int j = 0; j < nsplit; ++j) {
    const float mj = part[(long long)j * N + n];
    se += part[(1LL * nsplit + j) * N + n] * expf(mj - mx);
    tt += part[(2LL * nsplit + j) * N + n];
    ss += part[(3LL * nsplit + j) * N + n];
  }
  m[n] = mx;
  s[n] = se;
  t[n] = tt;
  sl[n] = ss;
}

}  // namespace

// Plain C entry point (bound with ctypes). nsplit vocab splits of
// tiles_per_split 256-column tiles each (nsplit * tiles_per_split * 256 >=
// V); part is [4, nsplit, N] fp32 scratch. is_bf16: 1 bf16, 0 fp32.
// Returns cudaGetLastError() after the launches (0 = launched), or, for a
// tensor map that cannot be encoded, ptt::sm90_host::kNoEncoder or
// kEncodeFailed + its CUresult.
extern "C" int ptt_ce_stats(const void* x, const void* w, const int* labels,
                            float* part, float* m, float* s, float* t,
                            float* sl, int N, int V, int H, int nsplit,
                            int tiles_per_split, int is_bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0) return 0;
  if (V <= 0 || H <= 0 || H % (is_bf16 ? 8 : kBH) != 0 || nsplit <= 0 ||
      tiles_per_split <= 0 ||
      (long long)nsplit * tiles_per_split * kSplitCols < V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    namespace host = ptt::sm90_host;
    CUtensorMap tmap_x, tmap_w;
    const cuuint64_t stride[1] = {(cuuint64_t)H * 2};
    const cuuint64_t xdim[2] = {(cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t wdim[2] = {(cuuint64_t)H, (cuuint64_t)V};
    const cuuint32_t xbox[2] = {sm90::kBK, sm90::kBM};
    const cuuint32_t wbox[2] = {sm90::kBK, sm90::kBN};
    int e = host::encode_bf16(&tmap_x, x, 2, xdim, stride, xbox);
    if (e == 0) e = host::encode_bf16(&tmap_w, w, 2, wdim, stride, wbox);
    if (e != 0) return e;
    err = host::opt_in_smem(ce_stats_wgmma_kernel, device);
    if (err != cudaSuccess) return (int)err;
    const int units = (N + sm90::kBM - 1) / sm90::kBM * nsplit;
    ce_stats_wgmma_kernel<<<host::persistent_blocks(device, units),
                            sm90::kThreads, sm90::kSmemBytes, st>>>(
        tmap_x, tmap_w, labels, part, N, V, H, nsplit, tiles_per_split);
  } else {
    dim3 grid((N + kBR - 1) / kBR, nsplit);
    ce_stats_partial_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), labels,
        part, N, V, H, tiles_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_stats_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, m, s, t, sl, N,
                                                         nsplit);
  return (int)cudaGetLastError();
}
