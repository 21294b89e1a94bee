// Hopper (sm_90a) building blocks for the flash-attention kernels: TMA
// loads through tensor maps, mbarriers, warpgroup matrix products
// (wgmma) and their shared-memory descriptors, register reallocation.
//
// Tiles in shared memory.  A tile of ROWS x D 16-bit values is stored as
// D / W boxes of ROWS x W, W = min(D, 64), each box written by one TMA load
// with the swizzle that matches its row length (W * 2 = 128, 64 or 32
// bytes -> SWIZZLE_128B, _64B, _32B).  Box b holds columns [bW, (b+1)W).
// Every tile starts on a 1024-byte boundary, so the swizzle pattern (a
// function of the shared address) is the same for the TMA unit that
// writes it and the tensor cores that read it.  The wgmma descriptors
// below describe exactly this layout:
//   K-major operand (the product's depth runs along D, as Q and K in
//   Q.K^T): 8-row groups SBO = 8 * W * 2 bytes apart, a depth step of 16
//   columns moves the start address by 32 bytes inside the swizzle row,
//   and into the next box every W / 16 steps.
//   MN-major operand (the depth runs along the rows, as V in P.V): a depth
//   step of 16 rows moves the start by 16 rows, 8-row groups are SBO
//   apart, and the N direction crosses from box to box (LBO = box bytes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ---------------------------------------------------------------------------
// Shared-memory tiles and wgmma descriptors
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a wgmma operand in shared memory (PTX ISA, "Matrix
// Descriptor Format"): start address, leading and stride byte offsets in
// 16-byte units, swizzle layout in bits 62-63 (1 = 128B, 2 = 64B, 3 = 32B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

template <int ROWS, int D>
struct SmemTile {
  static constexpr int kW = D < 64 ? D : 64;  // columns of one box
  static constexpr int kRowBytes = kW * 2;
  static constexpr int kBoxes = D / kW;
  static constexpr int kBoxBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "rows of 16, 32 or 64 16-bit values per box");
  static_assert(kBytes % 1024 == 0, "tiles stay 1024-byte aligned");

  // K-major operand: rows [row0, row0 + 64) (or the B operand's N rows
  // from row0), depth columns [16 kk, 16 kk + 16).
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int row0,
                                                     int kk) {
    const int col = kk * 16;
    return smem_desc(base + (col / kW) * kBoxBytes + row0 * kRowBytes +
                         (col % kW) * 2,
                     16, 8 * kRowBytes, kLayout);
  }
  // MN-major operand: depth rows [16 kk, 16 kk + 16), N = all D columns.
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
    return smem_desc(base + kk * 16 * kRowBytes, kBoxBytes, 8 * kRowBytes,
                     kLayout);
  }
};

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and expect `bytes` more from TMA loads in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Expect `bytes` more from TMA loads in this phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// One box of a 3-D map [BH][T][D] (coordinates innermost first) into shared
// memory, counted against `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Rows [row0, row0 + ROWS) of head `bh`, all D columns, box by box.
template <int ROWS, int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0, int bh) {
  using Tile = SmemTile<ROWS, D>;
#pragma unroll
  for (int b = 0; b < Tile::kBoxes; ++b)
    tma_load_3d(dst + b * Tile::kBoxBytes, map, bar, b * Tile::kW, row0, bh);
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups
// ---------------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
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

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence (its accumulators, or its A
// fragments, which it reads until the wait).
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define HVD_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HVD_REGS16                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "     \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define HVD_REGS32                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define HVD_REGS64                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define HVD_ACC8(b)                                                   \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define HVD_ACC16 HVD_ACC8(0), HVD_ACC8(8)
#define HVD_ACC32 HVD_ACC16, HVD_ACC8(16), HVD_ACC8(24)
#define HVD_ACC64 \
  HVD_ACC32, HVD_ACC8(32), HVD_ACC8(40), HVD_ACC8(48), HVD_ACC8(56)

// d (m64 x nN, fp32) (+)= A (smem, K-major) . B (smem, K-major).
#define HVD_WGMMA_SS(TY, N, REGS, ACC, IA, IB, IS)                     \
  asm volatile(                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " \
      REGS ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"                  \
      : ACC                                                           \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

// d (m64 x nN, fp32) (+)= A (registers) . B (smem, MN-major: transposed).
#define HVD_WGMMA_RS(TY, N, REGS, ACC, I0, I1, I2, I3, IB, IS)          \
  asm volatile(                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                 \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "  \
      REGS ", {%" I0 ", %" I1 ", %" I2 ", %" I3 "}, %" IB              \
      ", p, 1, 1, 1;\n}\n"                                             \
      : ACC                                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),       \
        "r"(accumulate))

// One m64nNk16 product of two shared-memory operands, both K-major;
// `accumulate` = 0 overwrites d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 32 || N == 64 || N == 128, "N of a score tile");
  if constexpr (N == 32) {
    if constexpr (kBf16)
      HVD_WGMMA_SS("bf16", 32, HVD_REGS16, HVD_ACC16, "16", "17", "18");
    else
      HVD_WGMMA_SS("f16", 32, HVD_REGS16, HVD_ACC16, "16", "17", "18");
  } else if constexpr (N == 64) {
    if constexpr (kBf16)
      HVD_WGMMA_SS("bf16", 64, HVD_REGS32, HVD_ACC32, "32", "33", "34");
    else
      HVD_WGMMA_SS("f16", 64, HVD_REGS32, HVD_ACC32, "32", "33", "34");
  } else {
    if constexpr (kBf16)
      HVD_WGMMA_SS("bf16", 128, HVD_REGS64, HVD_ACC64, "64", "65", "66");
    else
      HVD_WGMMA_SS("f16", 128, HVD_REGS64, HVD_ACC64, "64", "65", "66");
  }
}

// One m64nNk16 product with A in registers (the mma.m16n8k16 A fragment of
// each warp's 16 rows) and B in shared memory, MN-major.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N = head dim");
  if constexpr (N == 16) {
    if constexpr (kBf16)
      HVD_WGMMA_RS("bf16", 16, HVD_REGS8, HVD_ACC8(0), "8", "9", "10", "11",
                   "12", "13");
    else
      HVD_WGMMA_RS("f16", 16, HVD_REGS8, HVD_ACC8(0), "8", "9", "10", "11",
                   "12", "13");
  } else if constexpr (N == 32) {
    if constexpr (kBf16)
      HVD_WGMMA_RS("bf16", 32, HVD_REGS16, HVD_ACC16, "16", "17", "18", "19",
                   "20", "21");
    else
      HVD_WGMMA_RS("f16", 32, HVD_REGS16, HVD_ACC16, "16", "17", "18", "19",
                   "20", "21");
  } else if constexpr (N == 64) {
    if constexpr (kBf16)
      HVD_WGMMA_RS("bf16", 64, HVD_REGS32, HVD_ACC32, "32", "33", "34", "35",
                   "36", "37");
    else
      HVD_WGMMA_RS("f16", 64, HVD_REGS32, HVD_ACC32, "32", "33", "34", "35",
                   "36", "37");
  } else {
    if constexpr (kBf16)
      HVD_WGMMA_RS("bf16", 128, HVD_REGS64, HVD_ACC64, "64", "65", "66", "67",
                   "68", "69");
    else
      HVD_WGMMA_RS("f16", 128, HVD_REGS64, HVD_ACC64, "64", "65", "66", "67",
                   "68", "69");
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime; it is
// looked up in the libcuda.so.1 the runtime has already loaded, so the
// kernel library links against nothing new.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Map of a contiguous [bh][t][d] 16-bit tensor whose box is `box_rows` rows
// of one head by min(d, 64) columns, swizzled as SmemTile expects.  Rows
// past t read as zeros (the map is 3-D, so a box never runs into the next
// head).
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const void* base, int bh, int t,
                       int d, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const int w = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T),
                                 (cuuint64_t)t * d * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      w * sizeof(T) == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : w * sizeof(T) == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims,
                            strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
