// RMSNorm forward and backward over x [rows, d] with a weight w [d].
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/rmsnorm_kernel.py
// `_rmsnorm_fwd_kernel` (:47, launched by `_fwd`, the pallas_call at :105)
// and `_rmsnorm_bwd_kernel` (:54, launched by `_bwd`, the pallas_call at
// :124). Same math, all in fp32 with one rounding at the end:
//   y  = x * rstd * w,  rstd = 1 / sqrt(mean(x^2) + eps)
//   dx = rstd * (dy*w - x * rstd^2 * sum(dy*w*x) / d)   (rstd recomputed)
//   dw = sum over rows of dy * x * rstd                  (summed in fp32)
//
// What bounds them on the H100: bytes. A row is a reduction plus an
// elementwise pass, a few flops a byte. Forward [4096, 4096] bf16 moves
// 67.1 MB (x read, y written), 0.0200 ms at 3.35 TB/s; the backward reads
// x and dy and writes dx, 100.7 MB, about 0.030 ms, plus the dw partials.
// What the design does about it: 16-byte vector loads where the width
// allows (d % 8 == 0 for bf16, d % 4 == 0 for fp32; a scalar path
// otherwise); both kernels take two passes over a block's rows: one warp a
// row for the statistics (fp32 shuffle sums, the column loop unrolled 4
// times so 4 loads a lane are in flight: a row pass is otherwise
// latency-bound), then threads that own columns walk the rows in order,
// re-reading them while they are still in L1/L2 and reading w once a
// block.
//
// dw across blocks: the TPU grid runs in order and carries dw in one fp32
// buffer from step to step. Here blocks run in parallel and in no order, so
// each block of `br` rows writes its fp32 partial [d] (the threads own
// columns and walk the block's rows in order), and `rmsnorm_dw_kernel` sums
// the [n_blocks, d] partials in a fixed order: no atomics, the same bits
// every run. The ragged last block walks only its real rows, so rows past
// `rows` add nothing and are never written. `br` trades the grid's width
// (132 SMs to fill) against the partials' traffic; the autotuner picks it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockRows = 1024;  // rmsnorm_kernel.MAX_BLOCK_ROWS:
                                     // the statistics' shared rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N consecutive elements moved as one aligned access of N * sizeof(T)
// bytes (16 or 32 on the vector path: LDG/STG.128; one element on the
// scalar path).
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) ptt::store(in[i], &pk.v[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

// Two passes over the block's rows [r0, r0 + n). 1: one warp a row (warp w
// takes rows w, w + 8, ...; lane l reads columns l*V + 32*V*j), rstd into
// shared memory. 2: thread t owns columns t*V + 256*V*j and walks the rows
// in order, writing y; w is read once a block.
template <typename Tx, typename Tw, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                   Tx* __restrict__ y, int rows, int d, int br, float eps) {
  __shared__ float s_rstd[kMaxBlockRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * br;
  const int n = (int)min((long long)br, rows - r0);
  for (int i = warp; i < n; i += kWarps) {
    const Tx* xr = x + (r0 + i) * d;
    float ss = 0.f;
#pragma unroll 4
    for (int c = lane * V; c < d; c += 32 * V) {
      float t[V];
      load<Tx, V>(xr + c, t);
#pragma unroll
      for (int j = 0; j < V; ++j) ss += t[j] * t[j];
    }
    ss = ptt::warp_sum(ss);
    if (lane == 0) s_rstd[i] = 1.f / sqrtf(ss / d + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
    float wv[V];
    load<Tw, V>(w + c, wv);
    for (int i = 0; i < n; ++i) {
      const float rstd = s_rstd[i];
      float t[V];
      load<Tx, V>(x + (r0 + i) * d + c, t);
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = t[j] * rstd * wv[j];
      store<Tx, V>(y + (r0 + i) * d + c, t);
    }
  }
}

// Two passes over the block's rows. 1: one warp a row, rstd and
// proj = sum(dy*w*x) / d into shared memory. 2: thread t owns columns
// t*V + 256*V*j; for each it walks the rows in order, writes dx and sums
// dy*x*rstd into the block's fp32 partial.
template <typename Tx, typename Tw, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                   const Tx* __restrict__ dy, Tx* __restrict__ dx,
                   float* __restrict__ part, int rows, int d, int br,
                   float eps) {
  __shared__ float s_rstd[kMaxBlockRows];
  __shared__ float s_proj[kMaxBlockRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * br;
  const int n = (int)min((long long)br, rows - r0);
  for (int i = warp; i < n; i += kWarps) {
    const Tx* xr = x + (r0 + i) * d;
    const Tx* gr = dy + (r0 + i) * d;
    float ss = 0.f, sp = 0.f;
#pragma unroll 4
    for (int c = lane * V; c < d; c += 32 * V) {
      float t[V], g[V], wv[V];
      load<Tx, V>(xr + c, t);
      load<Tx, V>(gr + c, g);
      load<Tw, V>(w + c, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss += t[j] * t[j];
        sp += g[j] * wv[j] * t[j];
      }
    }
    ss = ptt::warp_sum(ss);
    sp = ptt::warp_sum(sp);
    if (lane == 0) {
      s_rstd[i] = 1.f / sqrtf(ss / d + eps);
      s_proj[i] = sp / d;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
    float wv[V], acc[V];
    load<Tw, V>(w + c, wv);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int i = 0; i < n; ++i) {
      const float rstd = s_rstd[i], proj = s_proj[i];
      float t[V], g[V], o[V];
      load<Tx, V>(x + (r0 + i) * d + c, t);
      load<Tx, V>(dy + (r0 + i) * d + c, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dyw = g[j] * wv[j];
        o[j] = rstd * (dyw - t[j] * (rstd * rstd) * proj);
        acc[j] += g[j] * t[j] * rstd;
      }
      store<Tx, V>(dx + (r0 + i) * d + c, o);
    }
    store<float, V>(part + (long long)blockIdx.x * d + c, acc);
  }
}

// dw [d] = sum over the nb partials [nb, d], in a fixed order: warp g sums
// partial rows g, g + 8, ... of 32 columns, then lane c of warp 0 adds the
// 8 warp sums in order.
template <typename Tw>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ part, Tw* __restrict__ dw,
                  int nb, int d) {
  __shared__ float s[kWarps][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < d)
    for (int b = warp; b < nb; b += kWarps) acc += part[(long long)b * d + c];
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += s[k][lane];
    ptt::store(t, dw + c);
  }
}

bool bad_args(int rows, int d, int br, int vec, int V) {
  return rows < 0 || d <= 0 || br <= 0 || br > kMaxBlockRows ||
         (vec && d % V != 0);
}

template <typename Tx, typename Tw>
int fwd(const void* x, const void* w, void* y, int rows, int d, int br,
        float eps, int vec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(Tx);
  if (bad_args(rows, d, br, vec, V)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int grid = (rows + br - 1) / br;
  auto kern =
      vec ? &rmsnorm_fwd_kernel<Tx, Tw, V> : &rmsnorm_fwd_kernel<Tx, Tw, 1>;
  kern<<<grid, kThreads, 0, st>>>(static_cast<const Tx*>(x),
                                  static_cast<const Tw*>(w),
                                  static_cast<Tx*>(y), rows, d, br, eps);
  return (int)cudaGetLastError();
}

template <typename Tx, typename Tw>
int bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
        int rows, int d, int br, float eps, int vec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(Tx);
  if (bad_args(rows, d, br, vec, V)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int grid = (rows + br - 1) / br;
  auto kern =
      vec ? &rmsnorm_bwd_kernel<Tx, Tw, V> : &rmsnorm_bwd_kernel<Tx, Tw, 1>;
  kern<<<grid, kThreads, 0, st>>>(
      static_cast<const Tx*>(x), static_cast<const Tw*>(w),
      static_cast<const Tx*>(dy), static_cast<Tx*>(dx), part, rows, d, br,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns
// cudaGetLastError() after its launch (0 = launched). x_bf16 / w_bf16: 1
// for bf16, 0 for fp32; vec: 1 for the 16-byte path (d a multiple of
// 16 / sizeof(x) and every base pointer aligned to its vector), 0 scalar.

// y [rows, d] in x's type.
extern "C" int ptt_rmsnorm_fwd(const void* x, const void* w, void* y,
                               int rows, int d, int br, float eps,
                               int x_bf16, int w_bf16, int vec, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return w_bf16 ? fwd<bf, bf>(x, w, y, rows, d, br, eps, vec, st)
                  : fwd<bf, float>(x, w, y, rows, d, br, eps, vec, st);
  return w_bf16 ? fwd<float, bf>(x, w, y, rows, d, br, eps, vec, st)
                : fwd<float, float>(x, w, y, rows, d, br, eps, vec, st);
}

// dx [rows, d] in x's type; part [ceil(rows / br), d] fp32 partials of dw.
extern "C" int ptt_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                               void* dx, float* part, int rows, int d,
                               int br, float eps, int x_bf16, int w_bf16,
                               int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return w_bf16
               ? bwd<bf, bf>(x, w, dy, dx, part, rows, d, br, eps, vec, st)
               : bwd<bf, float>(x, w, dy, dx, part, rows, d, br, eps, vec, st);
  return w_bf16
             ? bwd<float, bf>(x, w, dy, dx, part, rows, d, br, eps, vec, st)
             : bwd<float, float>(x, w, dy, dx, part, rows, d, br, eps, vec,
                                 st);
}

// dw [d] in w's type = the sum of part [nb, d] over its rows.
extern "C" int ptt_rmsnorm_dw(const float* part, void* dw, int nb, int d,
                              int w_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (d + 31) / 32;
  if (w_bf16)
    rmsnorm_dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(dw), nb, d);
  else
    rmsnorm_dw_kernel<float><<<grid, kThreads, 0, st>>>(
        part, static_cast<float*>(dw), nb, d);
  return (int)cudaGetLastError();
}
