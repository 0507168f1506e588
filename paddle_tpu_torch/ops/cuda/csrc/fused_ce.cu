// Fused linear + cross-entropy statistics for Hopper (sm_90a): bf16 inputs
// on the tensor cores (mma.sync, fp32 accumulation), fp32 inputs on the
// CUDA cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ce.py
// `_ce_stats_kernel` (launched by `_stats_pallas`). For every token n it
// computes, over the logits row x[n] . W^T that is never stored:
//   m  = max_v logit,  s = sum_v exp(logit - m),
//   t  = logit[label[n]] (0 when the label is outside [0, V)),
//   sl = sum_v logit.
// The x . W^T tile product runs in the kernel's own body, a 64-token by
// 128-vocab tile at a time, accumulated in fp32 registers:
//  * bf16: 8 warps as 2 x 4, each a 32 x 32 sub-tile of m16n8k16
//    mma.sync products over 64-wide H slices of x and W staged in shared
//    memory (rows padded to 72 so the fragment loads hit 32 distinct
//    banks), the next slice loaded into registers while this one computes;
//  * fp32: 4 x 8 outputs a thread from 16-wide H slices, on the CUDA cores
//    (the tensor cores would round fp32 to tf32).
// Each finished tile is folded into the running (m, s, t, sl) with the
// online-rescaling recurrence of the TPU kernel; the mma path keeps one
// running set per warp column and merges the four through shared memory
// at the end.
//
// At N = 4096 there are only 64 token blocks for 132 SMs, so the vocabulary
// is also split across blocks: block (i, j) walks the vocab tiles of split
// j and writes partial statistics, and a second small kernel merges the
// splits (m = max m_j, s = sum s_j exp(m_j - m), t and sl summed), as the
// paged kernel's split-K does.
//
// Layout: x [N, H] and W [V, H] contiguous (H a multiple of 64 for bf16, 16
// for fp32), labels [N] int32; partial statistics [4, nsplit, N] fp32;
// m, s, t, sl [N] fp32.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kBR = 64;    // tokens per block
constexpr int kBV = 128;   // vocab columns per tile
constexpr int kBH = 16;    // H slice staged per step (fp32 path)
constexpr int kMmaBK = 64;            // H slice staged per step (bf16 path)
constexpr int kMmaLd = kMmaBK + 8;    // padded shared row, in bf16
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
  const int v_begin = split * tiles_per_split * kBV;
  const int v_end = min(V, v_begin + tiles_per_split * kBV);

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

__global__ void __launch_bounds__(kThreads)
ce_stats_partial_mma_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const int* __restrict__ labels,
                            float* __restrict__ part, int N, int V, int H,
                            int tiles_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBR][kMmaLd];
  __shared__ __align__(16) __nv_bfloat16 ws[kBV][kMmaLd];
  __shared__ float red[4][4][kBR];  // [statistic][warp column][token]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;  // 32 tokens x 32 columns each
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBR;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int v_begin = split * tiles_per_split * kBV;
  const int v_end = min(V, v_begin + tiles_per_split * kBV);

  // this thread's accumulator rows: 32 wr + 16 mt + gid + 8 hf
  int lab[2][2];
  float m[2][2], s[2][2], t[2][2], sl[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = n0 + 32 * wr + 16 * mt + gid + 8 * hf;
      lab[mt][hf] = n < N ? labels[n] : -1;
      m[mt][hf] = ptt::kNegInf;
      s[mt][hf] = t[mt][hf] = sl[mt][hf] = 0.f;
    }

  // one H slice: x 64 x 64 and W 128 x 64 bf16, 16 bytes a load
  uint4 xr[2], wreg[4];
  auto load = [&](int v0, int h0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreads, r = e >> 3, c = (e & 7) * 8;
      xr[i] = n0 + r < N ? *reinterpret_cast<const uint4*>(
                               x + (long long)(n0 + r) * H + h0 + c)
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads, r = e >> 3, c = (e & 7) * 8;
      wreg[i] = v0 + r < V ? *reinterpret_cast<const uint4*>(
                                 w + (long long)(v0 + r) * H + h0 + c)
                           : make_uint4(0, 0, 0, 0);
    }
  };

  for (int v0 = v_begin; v0 < v_end; v0 += kBV) {
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    const int nk = H / kMmaBK;
    load(v0, 0);
    for (int kc = 0; kc < nk; ++kc) {
      __syncthreads();  // the previous slice's readers are done
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * kThreads;
        *reinterpret_cast<uint4*>(&xs[e >> 3][(e & 7) * 8]) = xr[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * kThreads;
        *reinterpret_cast<uint4*>(&ws[e >> 3][(e & 7) * 8]) = wreg[i];
      }
      __syncthreads();
      if (kc + 1 < nk) load(v0, (kc + 1) * kMmaBK);  // overlaps the products
#pragma unroll
      for (int kk = 0; kk < kMmaBK; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = 32 * wr + 16 * mt + gid, c = kk + tig * 2;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(&xs[r][c]);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c]);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(&xs[r][c + 8]);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = 32 * wc + 8 * nt + gid, c = kk + tig * 2;
          b[nt][0] = *reinterpret_cast<const uint32_t*>(&ws[r][c]);
          b[nt][1] = *reinterpret_cast<const uint32_t*>(&ws[r][c + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            ptt::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
      }
    }

    // fold this warp's 32 columns of the tile: a row's 8 values in a
    // thread, its 32 across the 4 lanes of a quad
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float val[8];
        int col[8];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            val[nt * 2 + c] = acc[mt][nt][hf * 2 + c];
            col[nt * 2 + c] = v0 + 32 * wc + 8 * nt + tig * 2 + c;
          }
        fold_row<4>(val, col, V, lab[mt][hf], m[mt][hf], s[mt][hf],
                    t[mt][hf], sl[mt][hf]);
      }
  }

  // merge the 4 warp columns of each token, then write the split's partial
  if (tig == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 32 * wr + 16 * mt + gid + 8 * hf;
        red[0][wc][r] = m[mt][hf];
        red[1][wc][r] = s[mt][hf];
        red[2][wc][r] = t[mt][hf];
        red[3][wc][r] = sl[mt][hf];
      }
  }
  __syncthreads();
  if (tid < kBR && n0 + tid < N) {
    float mx = ptt::kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, red[0][j][tid]);
    float se = 0.f, tt = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      se += red[1][j][tid] * expf(red[0][j][tid] - mx);
      tt += red[2][j][tid];
      ss += red[3][j][tid];
    }
    const int n = n0 + tid;
    part[(0LL * nsplit + split) * N + n] = mx;
    part[(1LL * nsplit + split) * N + n] = se;
    part[(2LL * nsplit + split) * N + n] = tt;
    part[(3LL * nsplit + split) * N + n] = ss;
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

template <typename T>
int launch(const void* x, const void* w, const int* labels, float* part,
           float* m, float* s, float* t, float* sl, int N, int V, int H,
           int nsplit, int tiles_per_split, cudaStream_t stream) {
  dim3 grid((N + kBR - 1) / kBR, nsplit);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    ce_stats_partial_mma_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), labels, part, N, V, H,
        tiles_per_split);
  } else {
    ce_stats_partial_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), labels,
        part, N, V, H, tiles_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_stats_merge_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, m, s, t, sl,
                                                           N, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). nsplit vocab splits of
// tiles_per_split 128-column tiles each (nsplit * tiles_per_split * 128 >=
// V); part is [4, nsplit, N] fp32 scratch. is_bf16: 1 bf16, 0 fp32.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ptt_ce_stats(const void* x, const void* w, const int* labels,
                            float* part, float* m, float* s, float* t,
                            float* sl, int N, int V, int H, int nsplit,
                            int tiles_per_split, int is_bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0) return 0;
  if (V <= 0 || H <= 0 || H % (is_bf16 ? kMmaBK : kBH) != 0 || nsplit <= 0 ||
      (long long)nsplit * tiles_per_split * kBV < V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, labels, part, m, s, t, sl, N, V, H,
                                 nsplit, tiles_per_split, st);
  return launch<float>(x, w, labels, part, m, s, t, sl, N, V, H, nsplit,
                       tiles_per_split, st);
}
