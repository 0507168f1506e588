// One Hopper (sm_90a) GEMM core, shared by the grouped matmul
// (grouped_matmul.cu: the bf16 forward, the fp32 forward that is the
// backward's dx, dw) and the CE statistics (fused_ce.cu): a persistent,
// warp-specialised block that forms 128 x 256 fp32 tiles of A . B from
// bf16 operands, or fp32 ones as split TF32 (below), and hands each
// finished tile to its kernel's epilogue. Its mbarrier helpers and the
// 1-D bulk copy (bulk_load) also feed the paged decode kernel's ring
// (paged_attention.cu).
//
//  * A block is 3 warpgroups. Warpgroup 0 is the producer: one thread
//    issues TMA copies (cp.async.bulk.tensor) of 64-deep K slices of A
//    (128 rows) and B (256 columns) into a ring of kStages shared-memory
//    stages, 128B-swizzled, and a "full" mbarrier per stage counts their
//    bytes. Warpgroups 1 and 2 are consumers: each owns 64 rows of the
//    tile and runs wgmma.mma_async m64n256k16 on the stages that have
//    landed, keeping one stage's products in flight, and releases a stage
//    through its "empty" mbarrier once its products are done. setmaxnreg
//    moves registers from the producer to the consumers (128 fp32
//    accumulators a thread).
//  * Producer and consumers walk the same sequence of jobs (a job: one
//    tile's K loop), so the producer runs ahead across job and tile
//    boundaries: one tile's epilogue overlaps the next tile's loads.
//  * TMA zero-fills whatever lies outside the tensor: rows past M or N, a
//    ragged last vocab tile, a depth that is not a multiple of 64. The
//    products of zeros are exact zeros, so no shared tile is ever masked.
//  * A and B are each K-major ([rows, K], K contiguous, as x and the CE
//    head W [V, H] in the logits x . W^T) or MN-major ([K, rows], rows
//    contiguous, as a grouped weight w[g] [d, h] for B, or the CE
//    backward's d-logits [C, V] as the A of dW = d^T . x): bf16 wgmma has
//    a transpose bit for each operand, and the descriptor's strides
//    follow (MN-major A: wgmma_m64n128k16 and consume_promoted). A
//    stage's A may hold several equal parts (the CE backward's bf16
//    pieces of one fp32 operand), each multiplied by the stage's one B
//    into the same accumulators.
//  * Every mbarrier wait gives up after kHangNs with __trap(), so a phase
//    error becomes a launch error instead of a hung card.
//  * fp32 operands (the grouped matmul's backward) run as split TF32 on
//    the same ring: a = hi + lo, hi = tf32(a) rounded to nearest
//    (cvt.rna), lo = tf32(a - hi), and a . b = hi . b + lo . b (+ hi . b_lo
//    when b is not exact in TF32; a bf16 value is), three or two
//    wgmma m64n256k8 .tf32 a K step. TF32 wgmma has no transpose bit, so
//    both operands are K-major in their products; A (the fp32 side) comes
//    from registers: each consumer thread reads its fragment from the
//    landed stage with ld.shared, undoing the swizzle, zeroes the K rows
//    its kernel masks and splits it there. B (hi, and lo as a second
//    stream) stays in shared memory. A stage is 32 fp32 deep (one 128-byte
//    swizzle row), so A and B take bf16's bytes: 4 stages, or 2 with the
//    lo stream.
//
// Host side: the tensor maps are encoded per call by cuTensorMapEncodeTiled,
// looked up through the CUDA runtime's entry-point query (no libcuda link),
// and passed to the kernel as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace ptt {
namespace sm90 {

constexpr int kBM = 128;                  // tile rows: two consumers of 64
constexpr int kBN = 256;                  // tile columns: one m64n256k16
constexpr int kBK = 64;                   // stage depth: one 128-byte row
constexpr int kStages = 4;
constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kABytes = kBM * kBK * 2;    // 16 KB
constexpr int kBBytes = kBN * kBK * 2;    // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
// the stages, 2 mbarriers a stage, and slack to align the ring to the
// 1024-byte period of the 128B swizzle
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kBK32 = 32;                 // fp32 stage depth: 128 bytes
constexpr int kA32Bytes = kBM * kBK32 * 4;  // 16 KB
constexpr int kB32Bytes = kBN * kBK32 * 4;  // 32 KB, each of hi and lo
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr unsigned long long kHangNs = 4000000000ull;  // 4 s

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival, and `bytes` more transaction bytes for this phase to await
__device__ __forceinline__ void bar_arrive_expect_tx(uint32_t bar,
                                                     uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!bar_try_wait(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// box at coordinates (c0 innermost, c1) of `map` into shared `dst`;
// completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes at global `src` into shared `dst` by the bulk-
// copy engine, no tensor map (both 16-byte aligned, bytes a multiple of
// 16); completion counts the bytes on `bar`. The paged decode kernel
// copies its K/V rows and scales with it.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled tile at `addr` (1024-
// byte aligned, plus the k16 step's offset): start address, leading and
// stride byte offsets in 16-byte units, swizzle mode 1 (128B) in bits
// 62-63.
//  K-major (rows of 64 K values, 128 bytes): 8-row groups 1024 bytes apart
//    (stride); the leading offset is unused (1). A k16 step advances the
//    start by 32 bytes inside the swizzle row.
//  MN-major (K rows of 64 columns, 128 bytes; a 256-column tile is 4 such
//    64-column boxes of kBK rows): 8-K-row groups 1024 bytes apart
//    (stride), the next 64 columns a box (kBK * 128 bytes) apart (leading).
//    A k16 step advances the start by 16 rows, 2048 bytes. The same
//    descriptor serves an MN-major A: a consumer's 64 rows are one box, so
//    the leading offset is never stepped over.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((kBK * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators as the compiler sees them: written here, so no use of
// them moves across a wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32) = A (64 x 16, bf16, K-major) . B (16 x 256, bf16),
// plus d when `accumulate`. TRANS_B 0: B K-major, 1: B MN-major.
// Accumulator i of a thread holds row 16 (warp % 4) + lane / 4 + 8 ((i / 2)
// % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 rows.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 128, fp32) = A (64 x 16, bf16) . B (16 x 128, bf16), plus d
// when `accumulate`. TRANS_A / TRANS_B 0: the operand is K-major, 1:
// MN-major (the wgmma transpose bit; an MN-major A's 64 rows are one
// 64-column box). Accumulator i of a thread holds row 16 (warp % 4) +
// lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- the ring --------------------------------------------------------------

// The stages and their barriers in dynamic shared memory, and a walker's
// place in them: stage index and the parity of the stage's current phase.
// Producer and consumers each keep their own ring and advance it once a
// stage, so they agree on every stage's phase. A stage is A_BYTES of A,
// then B_BYTES of B.
template <int STAGES, int A_BYTES, int B_BYTES>
struct RingOf {
  static constexpr int kStages = STAGES;
  static constexpr int kStageBytes = A_BYTES + B_BYTES;
  static constexpr int kSmemBytes = STAGES * kStageBytes + 2 * STAGES * 8 +
                                    1024;
  uint32_t base;  // shared address of stage 0, 1024-byte aligned
  int stage = 0;
  uint32_t phase = 0;

  __device__ explicit RingOf(uint32_t b) : base(b) {}
  __device__ uint32_t a(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t full(int s) const {
    return base + STAGES * kStageBytes + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(s) + 8 * STAGES; }
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

using Ring = RingOf<kStages, kABytes, kBBytes>;  // bf16
// split TF32: B hi, and B lo behind it when PASSES is 3
template <int PASSES>
using RingTF32 = RingOf<PASSES == 3 ? 2 : kStages, kA32Bytes,
                        (PASSES == 3 ? 2 : 1) * kB32Bytes>;

// The ring's base in the kernel's dynamic shared memory; thread 0 sets up
// the barriers (full: the producer's one arrival plus the stage's bytes;
// empty: one arrival from each consumer warpgroup). Every thread calls it.
template <class R = Ring>
__device__ __forceinline__ uint32_t ring_setup(unsigned char* smem) {
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    R r(base);
    for (int s = 0; s < R::kStages; ++s) {
      bar_init(r.full(s), 1);
      bar_init(r.empty(s), 2);
    }
    fence_bar_init();
  }
  __syncthreads();
  return base;
}

// Producer (one thread): the nk stages of one job. load(a, b, bar, k)
// issues the TMA copies of K slice k into stage addresses a and b,
// completing on bar; they must bring the stage's bytes.
template <class R, class Load>
__device__ __forceinline__ void produce(R& r, int nk, Load&& load) {
  for (int k = 0; k < nk; ++k) {
    bar_wait(r.empty(r.stage), r.phase ^ 1);
    bar_arrive_expect_tx(r.full(r.stage), R::kStageBytes);
    load(r.a(r.stage), r.b(r.stage), r.full(r.stage), k);
    r.advance();
  }
}

// Consumer warpgroup c (0 or 1): acc = its 64 rows of the job's tile, over
// nk stages. One stage's wgmma stay in flight while the next is issued; a
// stage is released once its products are done.
template <int TRANS_B>
__device__ __forceinline__ void consume(Ring& r, int nk, int c,
                                        float (&acc)[128]) {
  const bool leader = (threadIdx.x & 127) == 0;
  int prev = 0;
  for (int k = 0; k < nk; ++k) {
    bar_wait(r.full(r.stage), r.phase);
    const uint32_t sa = r.a(r.stage) + c * (kABytes / 2);
    const uint32_t sb = r.b(r.stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc_k_major(sa + kk * 32);
      const uint64_t db = TRANS_B ? desc_mn_major(sb + kk * 16 * 128)
                                  : desc_k_major(sb + kk * 32);
      wgmma_m64n256k16<TRANS_B>(acc, da, db, (k | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (k > 0 && leader) bar_arrive(r.empty(prev));
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader) bar_arrive(r.empty(prev));
}

// Consumer warpgroup c (0 or 1) of a 128 x 128 tile (wgmma m64n128k16, B
// 128 columns a stage; A as for consume): acc = its 64 rows over nk
// stages, promoted: the products of each run of PROMOTE stages are summed
// on the tensor cores into a fresh tile, which is then added to acc in
// fp32 on the CUDA cores, rounding to nearest. The tensor cores' fp32
// accumulation does not round to nearest from one step to the next, and
// over thousands of k16 steps its error grows with the depth (on an H100,
// 4e-5 of a row's max at depth 4096 and 1.6e-4 at 32000, against 1e-6 at
// 256); a run of 256 deep bounds it. Within a run one stage's products
// stay in flight while the next is issued, as in consume; at its end the
// tile is waited for, added and started afresh. The registers hold the
// tile and acc (128).
template <int TRANS_B, int TRANS_A, int PARTS, int PROMOTE, class R>
__device__ __forceinline__ void consume_promoted(R& r, int nk, int c,
                                                 float (&acc)[64]) {
  const bool leader = (threadIdx.x & 127) == 0;
  float tile[64];
  int prev = -1;
  for (int k = 0; k < nk; ++k) {
    bar_wait(r.full(r.stage), r.phase);
    const uint32_t sa = r.a(r.stage) + c * (kABytes / 2);
    const uint32_t sb = r.b(r.stage);
    const bool fresh = k % PROMOTE == 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = TRANS_B ? desc_mn_major(sb + kk * 16 * 128)
                                  : desc_k_major(sb + kk * 32);
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        const uint32_t pa = sa + p * kABytes;
        const uint64_t da = TRANS_A ? desc_mn_major(pa + kk * 16 * 128)
                                    : desc_k_major(pa + kk * 32);
        wgmma_m64n128k16<TRANS_B, TRANS_A>(tile, da, db,
                                           !fresh || (kk | p) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (prev >= 0 && leader) bar_arrive(r.empty(prev));
    prev = r.stage;
    r.advance();
    if ((k + 1) % PROMOTE == 0 || k + 1 == nk) {
      wgmma_wait<0>();
      fence_acc(tile);
      if (leader) bar_arrive(r.empty(prev));
      prev = -1;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = k < PROMOTE ? tile[i] : acc[i] + tile[i];
    }
  }
}

// The consumer thread's place in its warpgroup's 64 x 256 accumulator:
// rows row0 and row0 + 8 of the tile (counting from the warpgroup's first
// row), columns 8 j + col0 + {0, 1} for j < 32.
__device__ __forceinline__ int acc_row0() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

// ---- split TF32 ------------------------------------------------------------

// v rounded to TF32, to nearest with ties away from zero (its low 13 bits
// zero), as an fp32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// the registers as the compiler sees them: written here, so their values
// are made before and stay live until this point (an A fragment must not
// move or be reused while a wgmma that reads it is in flight)
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 256, fp32) = A (64 x 8, tf32, registers) . B (8 x 256, tf32,
// K-major in shared memory), plus d when `accumulate`. A fragment of a
// thread (lane l of warp w of the warpgroup): a[0] row 16 w + l / 4,
// column l % 4; a[1] row + 8; a[2] column + 4; a[3] both.
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128],
                                                     const uint32_t* a,
                                                     uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Byte offset of A element (tile row i, depth k) in a 128B-swizzled fp32
// stage: the 16-byte chunk k / 4 of the row's 128 bytes sits at chunk
// (k / 4) ^ (row % 8). K-major (A [rows, K] as it lies): one 128-byte row
// a tile row. MN-major (A^T [K, rows] as it lies): four boxes of 32 tile
// rows, each 32 K rows of 128 bytes.
template <bool MN_A>
__device__ __forceinline__ uint32_t a32_offset(int i, int k) {
  if (MN_A)
    return (i >> 5) * (kBK32 * 128) + k * 128 +
           ((((i & 31) >> 2) ^ (k & 7)) << 4) + (i & 3) * 4;
  return i * 128 + (((k >> 2) ^ (i & 7)) << 4) + (k & 3) * 4;
}

// Consumer warpgroup c (0 or 1): acc (+)= its 64 rows of one stage's
// product in split TF32 (acc = the product when `first`). The thread's 16
// A values of the stage come by ld.shared; depth k is zeroed unless bit k
// of `keep` is set; each splits into hi and lo. Then 4 K steps of
// hi . B + lo . B (+ hi . B_lo, PASSES 3), in that order, and the stage is
// released once they are done. No stage stays in flight, so a fragment's
// registers are free after its stage; meanwhile the other consumer
// warpgroup's products keep the tensor cores busy.
template <int PASSES, bool MN_A, class R>
__device__ __forceinline__ void consume_tf32(R& r, int c, float (&acc)[128],
                                             bool first, uint32_t keep) {
  const int lane = threadIdx.x & 31;
  const int i0 = 64 * c + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int t = lane & 3;
  bar_wait(r.full(r.stage), r.phase);
  const uint32_t sa = r.a(r.stage), sb = r.b(r.stage);
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {  // K step j / 4, register j % 4
    const int i = i0 + 8 * (j & 1), k = 8 * (j >> 2) + 4 * ((j >> 1) & 1) + t;
    float v = lds_f32(sa + a32_offset<MN_A>(i, k));
    v = (keep >> k) & 1u ? v : 0.f;
    hi[j] = tf32_rna(v);
    lo[j] = tf32_rna(v - __uint_as_float(hi[j]));
  }
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK32 / 8; ++kk) {
    const uint64_t db = desc_k_major(sb + kk * 32);
    wgmma_m64n256k8_tf32(acc, hi + 4 * kk, db, !first || kk > 0);
    wgmma_m64n256k8_tf32(acc, lo + 4 * kk, db, 1);
    if (PASSES == 3)
      wgmma_m64n256k8_tf32(acc, hi + 4 * kk,
                           desc_k_major(sb + kB32Bytes + kk * 32), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(hi);
  fence_regs(lo);
  if ((threadIdx.x & 127) == 0) bar_arrive(r.empty(r.stage));
  r.advance();
}

}  // namespace sm90

// ---- host: tensor maps -----------------------------------------------------

namespace sm90_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Codes the C entry points return for a tensor map that cannot be made
// (beside cudaError_t values, which stay below 1000).
constexpr int kNoEncoder = 100000;       // no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 100001;    // + the CUresult

// A tensor map of `type` and `rank` dims (innermost first, in elements),
// byte strides of dims 1.. (multiples of 16), a box of `box` elements (128
// bytes innermost at most), 128B swizzle, out-of-bounds elements read as
// zero. Returns 0 or an error code.
inline int encode(CUtensorMap* map, CUtensorMapDataType type,
                  const void* ptr, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr),
                        dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

inline int encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims,
                strides, box);
}

inline int encode_f32(CUtensorMap* map, const void* ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, rank, dims,
                strides, box);
}

// Lets `kernel` take `bytes` of dynamic shared memory on `device`, once a
// process for each kernel and device: later calls (a CUDA-graph capture
// among them) skip the call. Keyed by the kernel itself, as instances of
// one template share a type but not their shared-memory size.
template <class Kernel>
inline cudaError_t opt_in_smem(Kernel* kernel, int device,
                               int bytes = sm90::kSmemBytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel),
                                        device);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& k : done)
    if (k == key) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.push_back(key);
  return e;
}

// the persistent grid: at most one block an SM
inline int persistent_blocks(int device, int work) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      sms <= 0)
    sms = 1;
  return work < sms ? work : sms;
}

// Launches a persistent kernel of the core (kThreads threads, `smem` bytes
// of dynamic shared memory, one block an SM for `work` items) on `st`;
// returns cudaGetLastError() (0 = launched).
template <class Kernel, class... Args>
int launch_persistent(Kernel* kernel, int smem, int work, int device,
                      cudaStream_t st, Args... args) {
  const cudaError_t err = opt_in_smem(kernel, device, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<persistent_blocks(device, work), sm90::kThreads, smem, st>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace sm90_host
}  // namespace ptt
