// Hopper (sm_90a) building blocks shared by the tensor-core kernels under
// csrc/: mbarriers, TMA loads, wgmma descriptors and instructions, and the
// tensor maps they read, encoded through the driver's cuTensorMapEncodeTiled
// reached at run time (no -lcuda).  Everything is in an anonymous namespace:
// each source that includes this file gets its own copy.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A wait that
// lasts about 10 s (a protocol fault) traps, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before later async-proxy ones (wgmma operands, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 4-d tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2-d tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, the byte stride
// between 8-row groups (as both leading and stride offset: the one the
// layout does not use is ignored), and the swizzle (1: 128 B, 2: 64 B,
// 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t group,
                                              uint64_t swizzle) {
  const uint64_t off = group >> 4;
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (off << 16) | (off << 32) |
         (swizzle << 62);
}

// smem_desc(p, ...) made opaque to the compiler, and the descriptor `bytes`
// (a multiple of 16) past such a base: descriptors formed with desc_at()
// from a base taken inside a loop are formed where they are used, not
// hoisted out of the loop into dozens of live registers.
__device__ __forceinline__ uint64_t desc_base(const void* p, uint32_t group,
                                              uint64_t swizzle) {
  uint64_t d = smem_desc(p, group, swizzle);
  asm volatile("" : "+l"(d));
  return d;
}
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t bytes) {
  return base + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's reads and writes of an accumulator register against
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D = A.B (+ D) for a 64-row tile: ss takes A and B from shared memory, rs
// takes A from registers and B from shared memory.  In ss, TA = 0 reads A
// K-major (rows of A contiguous along the reduction) and TA = 1 M-major; TB
// likewise for B (0: K-major, 1: N-major); rs always reads B N-major.
// Accumulator layout (PTX ISA, wgmma D fragments): in warp w of the
// warpgroup, lane l holds rows 16w + l/4 (+8) and, per 8 columns j, columns
// 8j + 2(l%4) + {0, 1}: d[4j + 2i + e] is row 16w + l/4 + 8i, column
// 8j + 2(l%4) + e.  The A fragment of 16 reduction steps is the same layout
// in bf16 pairs: a[2c + i] holds row l/4 + 8i, steps 8c + 2(l%4) + {0, 1}.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else wgmma_rs_n16(d, a, b);
}

// Waits until at most N committed wgmma groups of this thread are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// G groups of wgmma products, each into a fresh accumulator of N fp32
// registers a thread and added on the fp32 pipe (rounded to nearest) to
// where it belongs while the next group runs: `issue(g, t)` issues group
// g into t (its first product with scale-d 0), `add(g, t)` adds it; both
// must agree on whether group g has any product.  The tensor cores' own
// fp32 accumulation does not round to nearest: on the H100, a split fp32
// mLSTM scan with every product of a 512-long reduction chained into one
// accumulator missed its plain version's tolerance on six D = 512 hazards
// (PERF.md, ROADMAP C21).  With
// kOverlap false one accumulator serves every group in turn (N fewer
// registers; each group waits for its own).
template <int N, int G, bool kOverlap = true, typename Issue, typename Add>
__device__ __forceinline__ void wgmma_chain(Issue&& issue, Add&& add) {
  if constexpr (!kOverlap) {
    float t[N];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wgmma_fence();
      issue(g, t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
      add(g, t);
    }
  } else {
    float t0[N], t1[N];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float (&t)[N] = g % 2 ? t1 : t0;
      wgmma_fence();
      issue(g, t);
      wgmma_commit();
      if (g > 0) {
        wgmma_wait<1>();
        float (&p)[N] = g % 2 ? t0 : t1;
        fence_regs(p);
        add(g - 1, p);
      }
    }
    wgmma_wait<0>();
    float (&p)[N] = (G - 1) % 2 ? t1 : t0;
    fence_regs(p);
    add(G - 1, p);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The top 8 significant bits of (x0, x1) as a bf16 pair (their top 16
// bits, truncated); leaves in x0, x1 what they did not hold, exactly.
// Three such terms of an fp32 value sum to it exactly (3 x 8 bits cover
// fp32's 24).
__device__ __forceinline__ uint32_t split_bf16(float& x0, float& x1) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  x0 -= __uint_as_float(u0 & 0xffff0000u);
  x1 -= __uint_as_float(u1 & 0xffff0000u);
  return __byte_perm(u0, u1, 0x7632);
}

// Term pair pr of a product of two operands split into three bf16 terms,
// (pair_a, pair_b): the six with i + j <= 2, smallest first: (1,1), (0,2),
// (2,0), (0,1), (1,0), (0,0).  The three left out are below 2^-20 of it.
__host__ __device__ constexpr int pair_a(int pr) {
  return pr == 0 ? 1 : pr == 2 ? 2 : pr == 4 ? 1 : 0;
}
__host__ __device__ constexpr int pair_b(int pr) {
  return pr == 0 ? 1 : pr == 1 ? 2 : pr == 3 ? 1 : 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (dims innermost first, the byte
// strides of dimensions 1.. in `strides`) read in boxes of `box`; the
// swizzle matches the box's row width (128, 64 or 32 bytes).  Elements
// past the tensor read as zeros.
bool tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box[0] * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An fp32 tensor map of `rank` dimensions (as tensor_map_bf16) read in
// unswizzled boxes: for tiles that threads, not wgmma, read.  Elements past
// the tensor read as zeros.
bool tensor_map_f32(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over a contiguous (B, len, heads, D) bf16 tensor whose box is
// `col` columns x `box_heads` heads x `box_rows` rows of one batch; rows,
// heads and columns past the tensor read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int batch, int len,
                int heads, int d, int col, int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(len), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2, cuuint64_t(heads) * d * 2,
                                 cuuint64_t(len) * heads * d * 2};
  const cuuint32_t box[4] = {cuuint32_t(col), cuuint32_t(box_heads),
                             cuuint32_t(box_rows), 1};
  return tensor_map_bf16(map, base, 4, dims, strides, box);
}

// Allows `kernel` `bytes` of dynamic shared memory, a driver call made once
// a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

}  // namespace
