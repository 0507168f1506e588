// The fused linear + cross-entropy backward for Hopper (sm_90a): bf16 x
// and W on the shared GEMM core of sm90.cuh (TMA, an mbarrier ring, wgmma).
//
// Replaces paddle_tpu/ops/pallas/fused_ce.py `_bwd_tokens` (with
// `_chunk_dlogits`), which the JAX package leaves to XLA inside a
// lax.scan: no pallas_call. Token chunk by token chunk of C tokens it
// computes, for x [N, H], W [V, H], labels [N], the forward's lse [N] and
// the cotangent ct [N]:
//   logits = x_c . W^T                                         (fp32)
//   d      = exp(logits - lse) coef - (1 - eps) ct_v onehot(label)
//            - (eps / V) ct_v,   ct_v = ct (0 for ignore_index),
//            coef = ct_v (1 + 2 z lse) (ct_v without z-loss)
//   dx_c   = d . W,   dW += d^T . x_c                          (fp32)
// Labels outside [0, V) match no column.
//
// What bounds it: operations. At N 4096, H 4096, V 32000 one product is
// 2 N V H = 1.07 TFLOP; an fp32-accurate route needs 7 bf16 products (the
// logits one, as x and W are bf16; dx and dW three each, fp32 d as three
// bf16 pieces against bf16 W or x), 7.6 ms at 989 TFLOP/s. Next, at small
// chunks, dW's read-modify-write: 2 x 4 V H bytes a chunk (1.05 GB).
//
// Design, three kernels a chunk (plus a small merge), all on the core's
// persistent 1-producer + 2-consumer block, with 128 x 128 output tiles
// (wgmma m64n128k16) whose accumulation is promoted every 256 deep (4
// stages, sm90::consume_promoted): the tensor cores' own fp32
// accumulation loses bits with the depth (4e-5 of a row at H 4096,
// 1.6e-4 at V 32000 on an H100), too much for the fp32 rule, while runs
// of 256 added to the tile in fp32 hold it; a 64-register tile and its
// 64-register sum are what a consumer thread can hold, hence 128
// columns, not the core's 256.
//  * dlogits: the ce_stats tile product (x and W K-major, 128 tokens x 128
//    vocab columns, six 64-deep TMA stages) with an epilogue that forms d
//    in the accumulators, zeroes columns >= V (TMA reads W rows past V as
//    zeros, whose logit 0 would give exp(-lse) coef, not 0; rows past N
//    load lse, coef and ct_v as 0, so their d is 0), and splits it in
//    registers into bf16 pieces d = hi + mid + lo (cvt.rn each: hi =
//    bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid); exact for |d|
//    >= 2^-110, which covers every d a step makes), stored as three bf16
//    planes [3, C, Vp] of a chunk scratch (Vp: V rounded up to 8, so TMA's
//    16-byte row stride holds; columns V..Vp are stored as 0). Three
//    planes, not one fp32 tile split on load: the dx and dW products then
//    read every operand from shared memory through descriptors, one TMA
//    copy a piece, and the transposed A of dW needs no register fragments.
//  * dx: M = tokens, N = H, K = V. A = the pieces, K-major; B = W [V, H]
//    as it lies, MN-major. A stage holds the three pieces' 64-deep slices
//    and one W slice (64 KB, 3 stages), and each k16 step runs hi, mid and
//    lo against the same W slice into one tile. At C 256 there are only
//    2 x 32 output tiles for 132 SMs, so the V loop is split (as
//    ce_stats splits the vocabulary) into partials that a merge kernel
//    sums in split order; dx rows are complete within a chunk.
//  * dW: M = V, N = H, K = the chunk's tokens. A = d^T, which is the
//    pieces as they lie: MN-major (bf16 wgmma's transpose bit for A); B =
//    x's chunk rows, MN-major. The first chunk stores its tile, later
//    chunks load, add and store it: fp32 accumulation in a fixed order,
//    chunk by chunk, no atomics. A tile's dW rows are prefetched into L2
//    when its products start, and the epilogue loads a row's 16 old
//    pairs before it stores any; with either alone the load-add-store
//    waits on device memory a pair at a time (on an H100, dW at a
//    256-token chunk: 24.5 ms with either alone, 8.1 with both, against
//    4.2 ms of products and the 15 read-modify-writes' 15.7 GB).
//
// Layout: x [N, H] and W [V, H] bf16 contiguous (H a multiple of 8), labels
// [N] int32, lse and ct [N] fp32; scratch dl [3, C, Vp] bf16, dx_part
// [splits, C, H] fp32 (splits > 1); out dx [N, H] and dw [V, H] fp32.
#include "common.cuh"
#include "sm90.cuh"

namespace sm90 = ptt::sm90;

namespace {

constexpr int kPieces = 3;
constexpr int kBN = 128;                       // output tile columns
constexpr int kBBytes = kBN * sm90::kBK * 2;   // a stage's B: 16 KB
constexpr int kPromote = 4;                    // stages a promoted run
// the logits' stages (A: 128 tokens, B: 128 vocab rows, 64 deep), and the
// dx and dW products' stages: the three pieces' A slices, one B
using LogitRing = sm90::RingOf<6, sm90::kABytes, kBBytes>;
using PieceRing = sm90::RingOf<3, kPieces * sm90::kABytes, kBBytes>;

// A token row's backward coefficients (all 0 past N: d = 0 there)
struct RowCoef {
  int lab;       // the label (-1: none)
  float lse;
  float coef;    // ct_v (1 + 2 z lse)
  float onehot;  // -(1 - eps) ct_v, at the label's column
  float smooth;  // (eps / V) ct_v, off every column
};

__device__ __forceinline__ RowCoef row_coef(int n, int N,
                                            const int* __restrict__ labels,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ ct,
                                            int ignore_index, float eps,
                                            float eps_v, float z_loss) {
  RowCoef r{-1, 0.f, 0.f, 0.f, 0.f};
  if (n >= N) return r;
  r.lab = labels[n];
  r.lse = lse[n];
  const float ctv = r.lab != ignore_index ? ct[n] : 0.f;
  r.coef = z_loss != 0.f ? ctv * (1.f + 2.f * z_loss * r.lse) : ctv;
  r.onehot = -(1.f - eps) * ctv;
  r.smooth = eps_v * ctv;
  return r;
}

// d of one logit at column col
__device__ __forceinline__ float dlogit(float logit, int col, int V,
                                        const RowCoef& r) {
  float d = ptt::exp2_ftz((logit - r.lse) * ptt::kLog2e) * r.coef;
  if (col == r.lab) d += r.onehot;
  d -= r.smooth;
  return col < V ? d : 0.f;
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
ce_bwd_dlogits_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                            const __grid_constant__ CUtensorMap tmap_w,
                            const int* __restrict__ labels,
                            const float* __restrict__ lse,
                            const float* __restrict__ ct,
                            __nv_bfloat16* __restrict__ dl, int c0, int N,
                            int V, int H, int cr, int vp, int ignore_index,
                            float eps, float eps_v, float z_loss) {
  extern __shared__ unsigned char smem[];
  LogitRing ring(sm90::ring_setup<LogitRing>(smem));
  const int ntt = cr / sm90::kBM;
  const int units = ntt * ((V + kBN - 1) / kBN);
  const int nk = (H + sm90::kBK - 1) / sm90::kBK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: one thread issues the copies; the token tiles of a
    // vocab tile run next to each other and share its W slices in L2
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tmap_x);
      sm90::prefetch_map(&tmap_w);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int t0 = c0 + u % ntt * sm90::kBM, v0 = u / ntt * kBN;
        sm90::produce(ring, nk, [&](uint32_t sa, uint32_t sb, uint32_t bar,
                                    int k) {
          sm90::tma_load_2d(sa, &tmap_x, bar, k * sm90::kBK, t0);
          sm90::tma_load_2d(sb, &tmap_w, bar, k * sm90::kBK, v0);
        });
      }
    }
  } else {
    // ---- consumers: 64 tokens of each tile a warpgroup
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int c = wg - 1;
    const int r_in = 64 * c + sm90::acc_row0();
    const long long plane = (long long)cr * vp;
    float acc[64];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tr = u % ntt * sm90::kBM + r_in;  // row in the chunk
      const int v0 = u / ntt * kBN;
      const RowCoef rc[2] = {
          row_coef(c0 + tr, N, labels, lse, ct, ignore_index, eps, eps_v,
                   z_loss),
          row_coef(c0 + tr + 8, N, labels, lse, ct, ignore_index, eps,
                   eps_v, z_loss)};
      sm90::consume_promoted<0, 0, 1, kPromote>(ring, nk, c, acc);
      const int col0 = v0 + sm90::acc_col0();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* row = dl + (long long)(tr + 8 * h) * vp;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = col0 + 8 * j;
          if (col >= vp) continue;  // vp and col even: col + 1 < vp too
          const float d0 = dlogit(acc[4 * j + 2 * h], col, V, rc[h]);
          const float d1 = dlogit(acc[4 * j + 2 * h + 1], col + 1, V, rc[h]);
          // d = hi + mid + lo, each rounded to nearest
          const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
          const float2 fh = __bfloat1622float2(hi);
          const float r0 = d0 - fh.x, r1 = d1 - fh.y;
          const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
          const float2 fm = __bfloat1622float2(mid);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(r0 - fm.x,
                                                          r1 - fm.y);
          *reinterpret_cast<__nv_bfloat162*>(row + col) = hi;
          *reinterpret_cast<__nv_bfloat162*>(row + plane + col) = mid;
          *reinterpret_cast<__nv_bfloat162*>(row + 2 * plane + col) = lo;
        }
      }
    }
  }
}

// the thread's two accumulator rows of 128 fp32 columns from col0 into
// y (row stride ld), rows below `rows` and columns below `cols`; ADD adds
// what y holds, a row's 16 old pairs loaded together before any store
// (loads and stores interleaved would wait on device memory one pair at
// a time)
template <bool ADD>
__device__ __forceinline__ void store_tile(float* __restrict__ y,
                                           const float (&acc)[64], int row,
                                           int col0, int rows, int cols,
                                           int ld) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= rows) continue;
    float* yr = y + (long long)(row + 8 * h) * ld;
    float2 old[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      old[j] = ADD && col < cols ? *reinterpret_cast<const float2*>(yr + col)
                                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= cols) continue;
      *reinterpret_cast<float2*>(yr + col) =
          make_float2(old[j].x + acc[4 * j + 2 * h],
                      old[j].y + acc[4 * j + 2 * h + 1]);
    }
  }
}

// dx (or its V-split partials): out [rows, H] of the chunk's tokens,
// split s covering 64-column K steps [s per, (s + 1) per) of V
__global__ void __launch_bounds__(sm90::kThreads, 1)
ce_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_d,
                       const __grid_constant__ CUtensorMap tmap_w,
                       float* __restrict__ out, int rows, int H, int cr,
                       int ksteps, int splits, int per) {
  extern __shared__ unsigned char smem[];
  PieceRing ring(sm90::ring_setup<PieceRing>(smem));
  const int ntt = cr / sm90::kBM;
  const int nht = (H + kBN - 1) / kBN;
  const int units = splits * ntt * nht;
  const int wg = threadIdx.x >> 7;
  // unit u: split, then token tile, then H tile (fastest), so the blocks
  // running together share a token tile's pieces and a split's W rows
  auto place = [&](int u, int& s, int& t0, int& h0) {
    h0 = u % nht * kBN;
    t0 = u / nht % ntt * sm90::kBM;
    s = u / (nht * ntt);
  };

  if (wg == 0) {
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tmap_d);
      sm90::prefetch_map(&tmap_w);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int s, t0, h0;
        place(u, s, t0, h0);
        const int kb = s * per, nk = min(ksteps, kb + per) - kb;
        sm90::produce(ring, nk, [&](uint32_t sa, uint32_t sb, uint32_t bar,
                                    int k) {
          const int v = (kb + k) * sm90::kBK;
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
            sm90::tma_load_3d(sa + p * sm90::kABytes, &tmap_d, bar, v, t0,
                              p);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            sm90::tma_load_2d(sb + j * sm90::kBK * 128, &tmap_w, bar,
                              h0 + 64 * j, v);
        });
      }
    }
  } else {
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int c = wg - 1;
    const int r_in = 64 * c + sm90::acc_row0();
    float acc[64];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int s, t0, h0;
      place(u, s, t0, h0);
      const int kb = s * per, nk = min(ksteps, kb + per) - kb;
      sm90::consume_promoted<1, 0, kPieces, kPromote>(ring, nk, c,
                                                        acc);
      store_tile<false>(out + (long long)s * cr * H, acc, t0 + r_in,
                        h0 + sm90::acc_col0(), rows, H, H);
    }
  }
}

// dx rows [0, rows) = the sum of the splits' partials, in split order
__global__ void ce_bwd_dx_merge_kernel(const float4* __restrict__ part,
                                       float4* __restrict__ dx, long long n4,
                                       long long split4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = part[s * split4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  dx[i] = a;
}

// dW [V, H] (+)= d^T . x over the chunk's cr tokens from c0 (first: =)
__global__ void __launch_bounds__(sm90::kThreads, 1)
ce_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_d,
                       const __grid_constant__ CUtensorMap tmap_x,
                       float* __restrict__ dw, int c0, int V, int H, int cr,
                       int first) {
  extern __shared__ unsigned char smem[];
  PieceRing ring(sm90::ring_setup<PieceRing>(smem));
  const int nht = (H + kBN - 1) / kBN;
  const int units = (V + sm90::kBM - 1) / sm90::kBM * nht;
  const int nk = cr / sm90::kBK;
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    // ---- producer: a vocab tile's H tiles run next to each other and
    // share its pieces; the chunk's x rows stay in L2
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tmap_d);
      sm90::prefetch_map(&tmap_x);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int v0 = u / nht * sm90::kBM, h0 = u % nht * kBN;
        sm90::produce(ring, nk, [&](uint32_t sa, uint32_t sb, uint32_t bar,
                                    int k) {
          const int t = k * sm90::kBK;
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
#pragma unroll
            for (int b = 0; b < 2; ++b)  // each consumer's 64 vocab rows
              sm90::tma_load_3d(sa + p * sm90::kABytes + b * sm90::kBK * 128,
                                &tmap_d, bar, v0 + 64 * b, t, p);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            sm90::tma_load_2d(sb + j * sm90::kBK * 128, &tmap_x, bar,
                              h0 + 64 * j, c0 + t);
        });
      }
    }
  } else {
    sm90::regs_inc<sm90::kConsumerRegs>();
    const int c = wg - 1;
    const int r_in = 64 * c + sm90::acc_row0();
    float acc[64];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int v0 = u / nht * sm90::kBM, h0 = u % nht * kBN;
      if (!first) {
        // the tile's dW rows into L2 while the products run, so the
        // epilogue's loads hit L2: 64 rows x 4 128-byte lines a
        // warpgroup, two lines a thread
        for (int i = threadIdx.x & 127; i < 256; i += 128) {
          const int v = v0 + 64 * c + (i >> 2), h = h0 + 32 * (i & 3);
          if (v < V && h < H)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                dw + (long long)v * H + h));
        }
      }
      sm90::consume_promoted<1, 1, kPieces, kPromote>(ring, nk, c,
                                                        acc);
      if (first)
        store_tile<false>(dw, acc, v0 + r_in, h0 + sm90::acc_col0(), V, H,
                          H);
      else
        store_tile<true>(dw, acc, v0 + r_in, h0 + sm90::acc_col0(), V, H,
                         H);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): dx [N, H] and dw [V, H] fp32 of
// the fused CE loss for bf16 x [N, H] and W [V, H], labels [N] int32, lse
// and ct [N] fp32, in token chunks of cr (a multiple of 128) tokens. dl is
// the [3, cr, vp] bf16 chunk scratch (vp >= V, a multiple of 8); dx's V
// loop runs in `splits` splits of `per` 64-column steps (into dx_part
// [splits, cr, H] fp32, merged in order; unused when splits is 1). Four
// launches a chunk at most. Returns cudaGetLastError() after the launches
// (0 = launched), or, for a tensor map that cannot be encoded,
// ptt::sm90_host::kNoEncoder or kEncodeFailed + its CUresult.
// v_total is the vocabulary the smoothing term spreads over: V, or, for a
// vocab shard of a tensor-parallel head, the whole vocabulary (labels
// then come shifted into the shard, and a label outside [0, V) matches
// no column).
extern "C" int ptt_ce_bwd_vt(const void* x, const void* w, const int* labels,
                             const float* lse, const float* ct, void* dl,
                             float* dx_part, float* dx, float* dw, int N,
                             int V, int H, int cr, int vp, int splits,
                             int per, int ignore_index, float eps,
                             float z_loss, int v_total, int device,
                             void* stream) {
  namespace host = ptt::sm90_host;
  using host::launch_persistent;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0) return 0;
  const int ksteps = (V + sm90::kBK - 1) / sm90::kBK;
  if (V <= 0 || H <= 0 || H % 8 != 0 || cr <= 0 || cr % sm90::kBM != 0 ||
      vp < V || vp % 8 != 0 || splits <= 0 || per <= 0 ||
      (long long)splits * per < ksteps || (splits - 1) * per >= ksteps ||
      (splits > 1 && dx_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tx_k, tw_k, tw_mn, tx_mn, td_k, td_mn;
  const cuuint64_t stride[1] = {(cuuint64_t)H * 2};
  const cuuint64_t xdim[2] = {(cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t wdim[2] = {(cuuint64_t)H, (cuuint64_t)V};
  const cuuint64_t ddim[3] = {(cuuint64_t)vp, (cuuint64_t)cr, kPieces};
  const cuuint64_t dstride[2] = {(cuuint64_t)vp * 2,
                                 (cuuint64_t)cr * vp * 2};
  const cuuint32_t box_a[2] = {sm90::kBK, sm90::kBM};  // K-major A
  const cuuint32_t box_b[2] = {sm90::kBK, kBN};        // K-major B
  const cuuint32_t box_mn[2] = {64, sm90::kBK};        // an MN-major box
  const cuuint32_t dbox_k[3] = {sm90::kBK, sm90::kBM, 1};
  const cuuint32_t dbox_mn[3] = {64, sm90::kBK, 1};
  int e = host::encode_bf16(&tx_k, x, 2, xdim, stride, box_a);
  if (e == 0) e = host::encode_bf16(&tw_k, w, 2, wdim, stride, box_b);
  if (e == 0) e = host::encode_bf16(&tw_mn, w, 2, wdim, stride, box_mn);
  if (e == 0) e = host::encode_bf16(&tx_mn, x, 2, xdim, stride, box_mn);
  if (e == 0) e = host::encode_bf16(&td_k, dl, 3, ddim, dstride, dbox_k);
  if (e == 0) e = host::encode_bf16(&td_mn, dl, 3, ddim, dstride, dbox_mn);
  if (e != 0) return e;
  if (v_total < V) return (int)cudaErrorInvalidValue;
  const float eps_v = (float)((double)eps / v_total);
  const int ntt = cr / sm90::kBM;
  const int nht = (H + kBN - 1) / kBN;
  const int dl_units = ntt * ((V + kBN - 1) / kBN);
  const int dw_units = (V + sm90::kBM - 1) / sm90::kBM * nht;
  for (int c0 = 0; c0 < N; c0 += cr) {
    const int rows = N - c0 < cr ? N - c0 : cr;
    int r = launch_persistent(ce_bwd_dlogits_wgmma_kernel,
                              LogitRing::kSmemBytes, dl_units, device, st,
                              tx_k, tw_k, labels, lse, ct,
                              static_cast<__nv_bfloat16*>(dl), c0, N, V, H,
                              cr, vp, ignore_index, eps, eps_v, z_loss);
    if (r != 0) return r;
    float* dx_c = dx + (long long)c0 * H;
    r = launch_persistent(ce_bwd_dx_wgmma_kernel, PieceRing::kSmemBytes,
                          splits * ntt * nht, device, st, td_k, tw_mn,
                          splits > 1 ? dx_part : dx_c,
                          splits > 1 ? cr : rows, H, cr, ksteps, splits, per);
    if (r != 0) return r;
    if (splits > 1) {
      const long long n4 = (long long)rows * H / 4;
      ce_bwd_dx_merge_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
          reinterpret_cast<const float4*>(dx_part),
          reinterpret_cast<float4*>(dx_c), n4, (long long)cr * H / 4, splits);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    r = launch_persistent(ce_bwd_dw_wgmma_kernel, PieceRing::kSmemBytes,
                          dw_units, device, st, td_mn, tx_mn, dw, c0, V, H,
                          cr, (int)(c0 == 0));
    if (r != 0) return r;
  }
  return 0;
}

// The entry for a whole vocabulary (v_total = V).
extern "C" int ptt_ce_bwd(const void* x, const void* w, const int* labels,
                          const float* lse, const float* ct, void* dl,
                          float* dx_part, float* dx, float* dw, int N, int V,
                          int H, int cr, int vp, int splits, int per,
                          int ignore_index, float eps, float z_loss,
                          int device, void* stream) {
  return ptt_ce_bwd_vt(x, w, labels, lse, ct, dl, dx_part, dx, dw, N, V, H,
                       cr, vp, splits, per, ignore_index, eps, z_loss, V,
                       device, stream);
}
