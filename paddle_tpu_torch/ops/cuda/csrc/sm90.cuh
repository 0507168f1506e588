// One Hopper (sm_90a) GEMM core, shared by the bf16 grouped-matmul forward
// (grouped_matmul.cu) and the CE statistics (fused_ce.cu): a persistent,
// warp-specialised block that forms 128 x 256 fp32 tiles of A . B from
// bf16 operands and hands each finished tile to its kernel's epilogue.
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
//  * A is K-major ([rows, K], K contiguous). B is K-major ([cols, K], as
//    the CE head W [V, H]) or MN-major ([K, cols], cols contiguous, as a
//    grouped weight w[g] [d, h]): the wgmma transpose bit and the
//    descriptor's strides follow.
//  * Every mbarrier wait gives up after kHangNs with __trap(), so a phase
//    error becomes a launch error instead of a hung card.
//
// Host side: the tensor maps are encoded per call by cuTensorMapEncodeTiled,
// looked up through the CUDA runtime's entry-point query (no libcuda link),
// and passed to the kernel as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
//    A k16 step advances the start by 16 rows, 2048 bytes.
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
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
// Producer and consumers each keep their own Ring and advance it once a
// stage, so they agree on every stage's phase.
struct Ring {
  uint32_t base;  // shared address of stage 0, 1024-byte aligned
  int stage = 0;
  uint32_t phase = 0;

  __device__ explicit Ring(uint32_t b) : base(b) {}
  __device__ uint32_t a(int s) const { return base + s * kStageBytes; }
  __device__ uint32_t b(int s) const { return a(s) + kABytes; }
  __device__ uint32_t full(int s) const {
    return base + kStages * kStageBytes + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(s) + 8 * kStages; }
  __device__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The ring's base in the kernel's dynamic shared memory; thread 0 sets up
// the barriers (full: the producer's one arrival plus the stage's bytes;
// empty: one arrival from each consumer warpgroup). Every thread calls it.
__device__ __forceinline__ uint32_t ring_setup(unsigned char* smem) {
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    Ring r(base);
    for (int s = 0; s < kStages; ++s) {
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
// completing on bar; they must bring kStageBytes.
template <class Load>
__device__ __forceinline__ void produce(Ring& r, int nk, Load&& load) {
  for (int k = 0; k < nk; ++k) {
    bar_wait(r.empty(r.stage), r.phase ^ 1);
    bar_arrive_expect_tx(r.full(r.stage), kStageBytes);
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

// The consumer thread's place in its warpgroup's 64 x 256 accumulator:
// rows row0 and row0 + 8 of the tile (counting from the warpgroup's first
// row), columns 8 j + col0 + {0, 1} for j < 32.
__device__ __forceinline__ int acc_row0() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

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

// A bf16 tensor map of `rank` dims (innermost first, in elements), byte
// strides of dims 1.. (multiples of 16), a box of `box` elements, 128B
// swizzle, out-of-bounds elements read as zero. Returns 0 or an error code.
inline int encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        (cuuint32_t)rank, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// Lets `kernel` take kSmemBytes of dynamic shared memory on `device`, once
// a process: later calls (a CUDA-graph capture among them) skip the call.
template <class Kernel>
inline cudaError_t opt_in_smem(Kernel* kernel, int device) {
  static bool done[64] = {};
  const bool known = device >= 0 && device < 64;
  if (known && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemBytes);
  if (e == cudaSuccess && known) done[device] = true;
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

}  // namespace sm90_host
}  // namespace ptt
