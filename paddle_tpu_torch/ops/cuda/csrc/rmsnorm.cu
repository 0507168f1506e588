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
//
// Two routes, chosen by rmsnorm_kernel.rmsnorm_plan (its constants mirror
// the kRing* ones below):
//
//  * The ring (rmsnorm_fwd_ring_kernel, rmsnorm_bwd_ring_kernel), where a
//    row is a whole number of 16-byte vectors, every base is aligned to
//    its vector and two stages fit shared memory. A block walks its rows
//    one at a time, and each row of x (and of dy) is read from HBM once:
//    one elected thread copies it by a 1-D bulk copy (sm90::bulk_load) into
//    a ring of 2-4 shared-memory stages, each stage's mbarrier counting its
//    bytes, and keeps the next rows' copies in flight while the block works
//    on the current one (kRingStageBudget bytes of stages a block, so a
//    few blocks on an SM keep several tens of KB in flight). Thread t owns
//    the row's 16-byte vectors t, t + T, ... (P of them; T and P from d),
//    reads them once from the stage into registers, and the block forms
//    sum(x^2) (and sum(dy*w*x)) by warp shuffles, then the warp sums in a
//    fixed order: no atomics, the same bits every run. y (dx) is written
//    from the same registers with 16-byte stores, and the stage is free
//    once the block has passed the barrier of that row's sums. w is read
//    once a block into registers, and the backward sums dy*x*rstd for its
//    columns over the block's rows in registers, in row order, writing
//    the block's fp32 partial of dw once at the end.
//  * Two passes over a block's rows (rmsnorm_fwd_kernel,
//    rmsnorm_bwd_kernel) everywhere else: a width that is not a whole
//    number of vectors (a scalar path), or one whose stages do not fit.
//    One warp a row forms the statistics (the column loop unrolled 4
//    times so 4 loads a lane are in flight), then threads that own
//    columns walk the rows in order, re-reading them from L1/L2.
//
// dw across blocks: the TPU grid runs in order and carries dw in one fp32
// buffer from step to step. Here blocks run in parallel and in no order, so
// each block of `br` rows writes its fp32 partial [d] (summed over the
// block's rows in order), and `rmsnorm_dw_kernel` sums the [n_blocks, d]
// partials in a fixed order: no atomics, the same bits every run. The
// ragged last block walks only its real rows, so rows past `rows` add
// nothing and are never written. `br` trades the grid's width (132 SMs to
// fill) against the partials' traffic; the autotuner picks it.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = ptt::sm90;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockRows = 1024;  // rmsnorm_kernel.MAX_BLOCK_ROWS:
                                     // the statistics' shared rows
// The routes (rmsnorm_kernel.ROUTES) and the ring's plan, mirrored by
// rmsnorm_kernel.rmsnorm_plan. Rows of at most 32 * kRingWarpMaxElems
// elements go a warp a row (kRouteRingWarp: kRingWarpThreads threads, a
// stage of one row a warp, P the smallest power of 2 that covers the row;
// two blocks an SM, so 128 registers a thread). Wider rows go a block a
// row (kRouteRing:
// P the smallest power of 2 that needs no more than kRingTargetThreads
// threads, T the vectors over P in whole warps, at most kRingMaxThreads,
// so 128 registers a thread), where a thread holds at most
// kRing{Fwd,Bwd}MaxElems elements of a row (P 16-byte vectors of V): with
// x (and dy) in their own type, w widened to fp32 and, backward, the fp32
// dw sums, more spill. stages = kRingStageBudget over a stage's bytes,
// clamped to kRingMinStages..kRingMaxStages and then to the stages a block
// of rows fills. The ring applies where kRingMinStages stages fit in
// kRingSmemLimit bytes (227 KB less 1 KB for the static barriers and warp
// sums).
constexpr int kRouteScalar = 0;    // two passes, one element at a time
constexpr int kRouteVector = 1;    // two passes, 16-byte vectors
constexpr int kRouteRing = 2;      // bulk copies on a ring, a block a row
constexpr int kRouteRingWarp = 3;  // bulk copies on a ring, a warp a row
constexpr int kRingTargetThreads = 256;
constexpr int kRingMaxThreads = 512;
constexpr int kRingMaxWarps = kRingMaxThreads / 32;
constexpr int kRingWarpThreads = 256;
constexpr int kRingWarpMaxElems = 32;
constexpr int kRingFwdMaxElems = 32;
constexpr int kRingBwdMaxElems = 16;
constexpr int kRingMinStages = 2;
constexpr int kRingMaxStages = 4;
constexpr int kRingStageBudget = 49152;
constexpr int kRingSmemLimit = 231424;
static_assert(1 <= kRingMinStages && kRingMinStages <= kRingMaxStages,
              "the ring's stage counts");
static_assert(kRingTargetThreads <= kRingMaxThreads &&
                  kRingWarpThreads <= kRingMaxThreads,
              "the ring's thread counts");

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

// ---- the ring route --------------------------------------------------------

// A block's ring: `stages` shared-memory stages, each of `per` consecutive
// rows of x (and then of dy), one "full" mbarrier a stage. Use k of the
// ring holds the block's rows [k * per, k * per + per) that exist, copied
// by one 1-D bulk copy a tensor (the rows are contiguous).
struct Ring {
  const unsigned char* mem;  // stage 0
  uint32_t base, bars;       // shared addresses of stage 0 and its barrier
  uint32_t row_bytes;
  int stages, per, tensors;  // tensors a stage: 1 (x) or 2 (x, dy)
  int n;                     // the block's rows
  const char* x;             // the block's first row of x, and of dy
  const char* dy;

  __device__ __forceinline__ int uses() const { return (n + per - 1) / per; }
  __device__ __forceinline__ uint32_t stage(int k) const {
    return base + (uint32_t)(k % stages) * per * row_bytes * tensors;
  }
  __device__ __forceinline__ uint32_t full(int k) const {
    return bars + 8 * (k % stages);
  }
  __device__ __forceinline__ void issue(int k) const {
    const uint32_t bytes = (uint32_t)min(per, n - k * per) * row_bytes;
    const long long off = (long long)k * per * row_bytes;
    sm90::bar_arrive_expect_tx(full(k), bytes * tensors);
    sm90::bulk_load(stage(k), x + off, bytes, full(k));
    if (tensors == 2)
      sm90::bulk_load(stage(k) + per * row_bytes, dy + off, bytes, full(k));
  }
  // thread 0: the barriers, then the copies of the first `stages` uses
  __device__ __forceinline__ void start() const {
    for (int s = 0; s < stages; ++s) sm90::bar_init(bars + 8 * s, 1);
    sm90::fence_bar_init();
    for (int k = 0; k < min(stages, uses()); ++k) issue(k);
  }
  // until use k has landed (the j-th use of a stage has parity j & 1)
  __device__ __forceinline__ void wait(int k) const {
    sm90::bar_wait(full(k), (k / stages) & 1);
  }
  // row r of the stage of use k, of tensor t (0 x, 1 dy)
  template <typename T>
  __device__ __forceinline__ const T* row(int k, int t, int r) const {
    return reinterpret_cast<const T*>(
        mem + (stage(k) - base) + (size_t)(t * per + r) * row_bytes);
  }
};

// Which thread holds which vectors of which row of a stage. A block a row
// (kWarp false): thread t holds vectors t + T*j (j < P) of the stage's one
// row, and the row's sums go through the warp sums. A warp a row: lane l
// of warp r holds vectors l + 32*j of the stage's row r, and a row's sums
// are its warp's.
template <bool kWarp>
struct Share {
  int me, step, row;
  __device__ __forceinline__ Share()
      : me(kWarp ? (int)(threadIdx.x & 31) : (int)threadIdx.x),
        step(kWarp ? 32 : (int)blockDim.x),
        row(kWarp ? (int)(threadIdx.x >> 5) : 0) {}
  __device__ __forceinline__ int vec(int j) const { return me + step * j; }
};

// The ring's forward over the block's rows [r0, r0 + n). Per use of the
// ring: wait for its stage, read this thread's vectors of its row into
// registers, sum x^2 (the thread's elements in order, then the warp's
// shuffle tree; a block a row then adds the warp sums in order), one
// barrier (after which thread 0 refills the stage with use k + stages),
// write y from the registers.
template <typename Tx, typename Tw, int P, bool kWarp>
__global__ void __launch_bounds__(kWarp ? kRingWarpThreads : kRingMaxThreads,
                                  kWarp ? 2 : 1)
rmsnorm_fwd_ring_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                        Tx* __restrict__ y, int rows, int d, int br,
                        int stages, float eps) {
  constexpr int V = 16 / sizeof(Tx);
  extern __shared__ uint4 ring_smem[];
  __shared__ __align__(8) unsigned long long s_full[kRingMaxStages];
  __shared__ float s_red[2][kRingMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, nv = d / V;
  const long long r0 = (long long)blockIdx.x * br;
  const Share<kWarp> sh;
  const Ring ring{reinterpret_cast<const unsigned char*>(ring_smem),
                  sm90::smem_addr(ring_smem), sm90::smem_addr(s_full),
                  (uint32_t)(d * sizeof(Tx)), stages,
                  kWarp ? nwarps : 1, 1,
                  (int)min((long long)br, rows - r0),
                  reinterpret_cast<const char*>(x + r0 * d), nullptr};
  if (threadIdx.x == 0) ring.start();
  Pack<Tw, V> wv[P];
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (sh.vec(j) < nv)
      wv[j] = *reinterpret_cast<const Pack<Tw, V>*>(w + sh.vec(j) * V);
  __syncthreads();  // the barriers are initialised

  for (int k = 0; k < ring.uses(); ++k) {
    const int i = k * ring.per + sh.row;  // this thread's row of the block
    const bool live = i < ring.n;         // uniform across a warp
    ring.wait(k);
    const Pack<Tx, V>* st = ring.row<Pack<Tx, V>>(k, 0, sh.row);
    Pack<Tx, V> xv[P];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (live && sh.vec(j) < nv) {
        xv[j] = st[sh.vec(j)];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float t = to_f(xv[j].v[e]);
          ss += t * t;
        }
      }
    ss = ptt::warp_sum(ss);
    if (!kWarp && lane == 0) s_red[k & 1][warp] = ss;
    __syncthreads();  // every thread has read the stage (and its warp sum)
    if (threadIdx.x == 0 && k + ring.stages < ring.uses())
      ring.issue(k + ring.stages);
    if (!kWarp) {
      ss = 0.f;
      for (int q = 0; q < nwarps; ++q) ss += s_red[k & 1][q];
    }
    if (!live) continue;
    const float rstd = 1.f / sqrtf(ss / d + eps);
    Tx* yr = y + (r0 + i) * d;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (sh.vec(j) < nv) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          o[e] = to_f(xv[j].v[e]) * rstd * to_f(wv[j].v[e]);
        store<Tx, V>(yr + sh.vec(j) * V, o);
      }
  }
}

// The ring's backward: a stage holds rows of x, then the same rows of dy.
// Per use as the forward, with sum(x^2) and sum(dy*w*x) reduced together;
// dx is written and dy*x*rstd is added, row by row in order, into the
// thread's fp32 sums of its columns. A block a row keeps its vectors in
// registers across the barrier that frees the stage. A warp a row needs no
// barrier for its sums, so it reads its vectors from the stage again for
// dx and frees the stage after: with w and the dw sums in registers, x and
// dy there too took 168 registers a thread at 32 elements (one block an
// SM). A block a row writes its dw sums as the block's partial; a
// warp a row first adds its warps' sums in warp order through shared
// memory (the ring's, all its copies landed).
template <typename Tx, typename Tw, int P, bool kWarp>
__global__ void __launch_bounds__(kWarp ? kRingWarpThreads : kRingMaxThreads,
                                  kWarp ? 2 : 1)
rmsnorm_bwd_ring_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                        const Tx* __restrict__ dy, Tx* __restrict__ dx,
                        float* __restrict__ part, int rows, int d, int br,
                        int stages, float eps) {
  constexpr int V = 16 / sizeof(Tx);
  extern __shared__ uint4 ring_smem[];
  __shared__ __align__(8) unsigned long long s_full[kRingMaxStages];
  __shared__ float2 s_red[2][kRingMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, nv = d / V;
  const long long r0 = (long long)blockIdx.x * br;
  const Share<kWarp> sh;
  const Ring ring{reinterpret_cast<const unsigned char*>(ring_smem),
                  sm90::smem_addr(ring_smem), sm90::smem_addr(s_full),
                  (uint32_t)(d * sizeof(Tx)), stages,
                  kWarp ? nwarps : 1, 2,
                  (int)min((long long)br, rows - r0),
                  reinterpret_cast<const char*>(x + r0 * d),
                  reinterpret_cast<const char*>(dy + r0 * d)};
  if (threadIdx.x == 0) ring.start();
  Pack<Tw, V> wv[P];
  float acc[P][V];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (sh.vec(j) < nv)
      wv[j] = *reinterpret_cast<const Pack<Tw, V>*>(w + sh.vec(j) * V);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
  }
  __syncthreads();  // the barriers are initialised

  for (int k = 0; k < ring.uses(); ++k) {
    const int i = k * ring.per + sh.row;
    const bool live = i < ring.n;
    ring.wait(k);
    const Pack<Tx, V>* sx = ring.row<Pack<Tx, V>>(k, 0, sh.row);
    const Pack<Tx, V>* sg = ring.row<Pack<Tx, V>>(k, 1, sh.row);
    Pack<Tx, V> xv[P], gv[P];
    float ss = 0.f, sp = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (live && sh.vec(j) < nv) {
        xv[j] = sx[sh.vec(j)];
        gv[j] = sg[sh.vec(j)];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float t = to_f(xv[j].v[e]), g = to_f(gv[j].v[e]);
          ss += t * t;
          sp += g * to_f(wv[j].v[e]) * t;
        }
      }
    ss = ptt::warp_sum(ss);
    sp = ptt::warp_sum(sp);
    if (!kWarp) {
      if (lane == 0) s_red[k & 1][warp] = make_float2(ss, sp);
      __syncthreads();  // every thread has read the stage and its warp sums
      if (threadIdx.x == 0 && k + ring.stages < ring.uses())
        ring.issue(k + ring.stages);
      ss = sp = 0.f;
      for (int q = 0; q < nwarps; ++q) {
        ss += s_red[k & 1][q].x;
        sp += s_red[k & 1][q].y;
      }
    }
    if (live) {
      const float rstd = 1.f / sqrtf(ss / d + eps), proj = sp / d;
      Tx* dxr = dx + (r0 + i) * d;
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (sh.vec(j) < nv) {
          if (kWarp) {  // again from the stage, which is freed below
            xv[j] = sx[sh.vec(j)];
            gv[j] = sg[sh.vec(j)];
          }
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float t = to_f(xv[j].v[e]), g = to_f(gv[j].v[e]);
            const float dyw = g * to_f(wv[j].v[e]);
            o[e] = rstd * (dyw - t * (rstd * rstd) * proj);
            acc[j][e] += g * t * rstd;
          }
          store<Tx, V>(dxr + sh.vec(j) * V, o);
        }
    }
    if (kWarp) {
      __syncthreads();  // every warp is done with the stage
      if (threadIdx.x == 0 && k + ring.stages < ring.uses())
        ring.issue(k + ring.stages);
    }
  }
  float* out = part + (long long)blockIdx.x * d;
  if (!kWarp) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (sh.vec(j) < nv) store<float, V>(out + sh.vec(j) * V, acc[j]);
    return;
  }
  // a warp a row: warp r's sums into row r of a [warps, d] fp32 table over
  // the ring (warps * d * 4 bytes, at most a stage's warps * d * 2 * 2),
  // then column c summed over the warps in order
  float* red = reinterpret_cast<float*>(ring_smem);
  __syncthreads();  // every thread is done with the stages
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (sh.vec(j) < nv)
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[(long long)warp * d + sh.vec(j) * V + e] = acc[j][e];
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < nwarps; ++q) s += red[(long long)q * d + c];
    out[c] = s;
  }
}

bool bad_args(int rows, int d, int br, int route, int V) {
  return rows < 0 || d <= 0 || br <= 0 || br > kMaxBlockRows ||
         route < kRouteScalar || route > kRouteRingWarp ||
         (route != kRouteScalar && d % V != 0);
}

// The ring kernel of P vectors a thread, a warp a row or a block a row;
// nullptr where P vectors exceed the elements a thread holds (those
// instances spill and are never compiled).
template <typename Tx, typename Tw, int P, bool kWarp>
auto fwd_ring() {
  constexpr int most = kWarp ? kRingWarpMaxElems : kRingFwdMaxElems;
  if constexpr (P * (16 / (int)sizeof(Tx)) <= most)
    return &rmsnorm_fwd_ring_kernel<Tx, Tw, P, kWarp>;
  else
    return (decltype(&rmsnorm_fwd_ring_kernel<Tx, Tw, 1, kWarp>))nullptr;
}

template <typename Tx, typename Tw, int P, bool kWarp>
auto bwd_ring() {
  constexpr int most = kWarp ? kRingWarpMaxElems : kRingBwdMaxElems;
  if constexpr (P * (16 / (int)sizeof(Tx)) <= most)
    return &rmsnorm_bwd_ring_kernel<Tx, Tw, P, kWarp>;
  else
    return (decltype(&rmsnorm_bwd_ring_kernel<Tx, Tw, 1, kWarp>))nullptr;
}

// the instance for `vecs` (1, 2, 4 or 8) vectors a thread, or nullptr
template <class Pick>
auto by_vecs(int vecs, Pick pick) {
  using K = decltype(pick(std::integral_constant<int, 1>()));
  switch (vecs) {
    case 1: return pick(std::integral_constant<int, 1>());
    case 2: return pick(std::integral_constant<int, 2>());
    case 4: return pick(std::integral_constant<int, 4>());
    case 8: return pick(std::integral_constant<int, 8>());
    default: return (K) nullptr;
  }
}

// The ring's launch, checked against its plan's limits: P vectors a
// thread and T threads cover the row (a block a row: T in whole warps up to
// kRingMaxThreads; a warp a row: a lane's P vectors cover it, T =
// kRingWarpThreads); stages within kRingMaxStages and their bytes within
// kRingSmemLimit. Opts the kernel in to kRingSmemLimit bytes once a
// process (sm90_host::opt_in_smem).
template <class Kernel, class... Args>
int launch_ring(Kernel* kern, bool warp_a_row, int grid, int threads,
                int vecs, int stages, long long row_bytes, int tensors,
                int nv, int device, cudaStream_t st, Args... args) {
  const long long per = warp_a_row ? threads / 32 : 1;
  const long long stage_bytes = per * row_bytes * tensors;
  const bool covered = warp_a_row ? threads == kRingWarpThreads &&
                                        32LL * vecs >= nv
                                  : threads <= kRingMaxThreads &&
                                        (long long)threads * vecs >= nv;
  if (kern == nullptr || !covered || threads < 32 || threads % 32 != 0 ||
      stages < 1 || stages > kRingMaxStages ||
      stages * stage_bytes > kRingSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      ptt::sm90_host::opt_in_smem(kern, device, kRingSmemLimit);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, (size_t)(stages * stage_bytes), st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename Tx, typename Tw>
int fwd(const void* x, const void* w, void* y, int rows, int d, int br,
        float eps, int route, int threads, int vecs, int stages, int device,
        cudaStream_t st) {
  constexpr int V = 16 / sizeof(Tx);
  if (bad_args(rows, d, br, route, V)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int grid = (rows + br - 1) / br;
  const Tx* xp = static_cast<const Tx*>(x);
  const Tw* wp = static_cast<const Tw*>(w);
  Tx* yp = static_cast<Tx*>(y);
  if (route >= kRouteRing) {
    const bool wr = route == kRouteRingWarp;
    auto kern = wr ? by_vecs(vecs, [](auto p) {
                       return fwd_ring<Tx, Tw, decltype(p)::value, true>();
                     })
                   : by_vecs(vecs, [](auto p) {
                       return fwd_ring<Tx, Tw, decltype(p)::value, false>();
                     });
    return launch_ring(kern, wr, grid, threads, vecs, stages,
                       (long long)d * sizeof(Tx), 1, d / V, device, st, xp,
                       wp, yp, rows, d, br, stages, eps);
  }
  auto kern = route == kRouteVector ? &rmsnorm_fwd_kernel<Tx, Tw, V>
                                    : &rmsnorm_fwd_kernel<Tx, Tw, 1>;
  kern<<<grid, kThreads, 0, st>>>(xp, wp, yp, rows, d, br, eps);
  return (int)cudaGetLastError();
}

template <typename Tx, typename Tw>
int bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
        int rows, int d, int br, float eps, int route, int threads, int vecs,
        int stages, int device, cudaStream_t st) {
  constexpr int V = 16 / sizeof(Tx);
  if (bad_args(rows, d, br, route, V)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int grid = (rows + br - 1) / br;
  const Tx* xp = static_cast<const Tx*>(x);
  const Tw* wp = static_cast<const Tw*>(w);
  const Tx* gp = static_cast<const Tx*>(dy);
  Tx* dxp = static_cast<Tx*>(dx);
  if (route >= kRouteRing) {
    const bool wr = route == kRouteRingWarp;
    auto kern = wr ? by_vecs(vecs, [](auto p) {
                       return bwd_ring<Tx, Tw, decltype(p)::value, true>();
                     })
                   : by_vecs(vecs, [](auto p) {
                       return bwd_ring<Tx, Tw, decltype(p)::value, false>();
                     });
    return launch_ring(kern, wr, grid, threads, vecs, stages,
                       (long long)d * sizeof(Tx), 2, d / V, device, st, xp,
                       wp, gp, dxp, part, rows, d, br, stages, eps);
  }
  auto kern = route == kRouteVector ? &rmsnorm_bwd_kernel<Tx, Tw, V>
                                    : &rmsnorm_bwd_kernel<Tx, Tw, 1>;
  kern<<<grid, kThreads, 0, st>>>(xp, wp, gp, dxp, part, rows, d, br, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns
// cudaGetLastError() after its launch (0 = launched). x_bf16 / w_bf16: 1
// for bf16, 0 for fp32. route: kRouteScalar, kRouteVector (d a multiple of
// 16 / sizeof(x) and every base pointer aligned to its vector), kRouteRing
// or kRouteRingWarp (as kRouteVector, with the plan's threads, vectors a
// thread and stages; the two-pass routes ignore those three).

// y [rows, d] in x's type.
extern "C" int ptt_rmsnorm_fwd(const void* x, const void* w, void* y,
                               int rows, int d, int br, float eps,
                               int x_bf16, int w_bf16, int route,
                               int threads, int vecs, int stages, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return w_bf16 ? fwd<bf, bf>(x, w, y, rows, d, br, eps, route, threads,
                                vecs, stages, device, st)
                  : fwd<bf, float>(x, w, y, rows, d, br, eps, route, threads,
                                   vecs, stages, device, st);
  return w_bf16 ? fwd<float, bf>(x, w, y, rows, d, br, eps, route, threads,
                                 vecs, stages, device, st)
                : fwd<float, float>(x, w, y, rows, d, br, eps, route,
                                    threads, vecs, stages, device, st);
}

// dx [rows, d] in x's type; part [ceil(rows / br), d] fp32 partials of dw.
extern "C" int ptt_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                               void* dx, float* part, int rows, int d,
                               int br, float eps, int x_bf16, int w_bf16,
                               int route, int threads, int vecs, int stages,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return w_bf16 ? bwd<bf, bf>(x, w, dy, dx, part, rows, d, br, eps, route,
                                threads, vecs, stages, device, st)
                  : bwd<bf, float>(x, w, dy, dx, part, rows, d, br, eps,
                                   route, threads, vecs, stages, device, st);
  return w_bf16 ? bwd<float, bf>(x, w, dy, dx, part, rows, d, br, eps, route,
                                 threads, vecs, stages, device, st)
                : bwd<float, float>(x, w, dy, dx, part, rows, d, br, eps,
                                    route, threads, vecs, stages, device, st);
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
