// Hopper (sm_90a) building blocks of the flash-attention forward
// (flash_attn.cu) and dkv (flash_attn_bwd.cu) kernels: mbarriers, TMA tile
// loads from a CUtensorMap, wgmma shared-memory descriptors for the
// 128-byte swizzle, warpgroup MMA (wgmma.mma_async), setmaxnreg; and, on
// the host, the tensor maps, encoded at each launch through the runtime's
// driver entry point (so nothing links -lcuda).
//
// Tiles in shared memory. A tile of R rows x 128 bf16 dims is two panels of
// R x 64 dims, each filled by one TMA box {64 dims, 1 head, R rows, 1 batch}
// with the 128-byte swizzle: row r of a panel lies at r * 128 bytes, its
// 16-byte chunk c at chunk c ^ (r % 8). Panels start on 1024-byte
// boundaries, so the swizzle the TMA writes is the one wgmma reads. Rows
// past the tensor's end are zero-filled by the TMA.
//   * K-major operand (rows are M or N, dims are K): the k-step kk (16 dims)
//     starts in panel kk / 4 at (kk % 4) * 32 bytes; 8-row groups lie 1024
//     bytes apart (the descriptor's stride offset).
//   * MN-major operand (rows are K, dims are N; tnspB = 1): the k-step kk
//     (16 rows) starts kk * 2048 bytes into the first panel; 8-row groups
//     lie 1024 bytes apart (the stride offset) and the 64-dim panels one
//     panel apart (the leading offset), so a wgmma of N = 128 reads both.
//
// Register layouts (per warpgroup of 128 threads; warp w, lane l, g = l / 4,
// tig = l % 4). The accumulator of a 64 x N product holds, for each 8-column
// chunk j, d[4j], d[4j+1] at (row 16w + g, columns 8j + 2 tig, +1) and
// d[4j+2], d[4j+3] at row 16w + g + 8. A register A operand of a k16 step
// is four bf16 pairs, laid out as mma.sync m16n8k16's A fragment for the
// warp's 16 rows; packing the accumulator chunks 2kk and 2kk + 1 of one
// product gives exactly the A operand of k-step kk of the next
// (a_operand below), so P and dS never leave registers.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace hopper {

constexpr int kPanelCols = 64;           // bf16 dims per 128-byte row
constexpr int kMapError = 1000;          // + CUresult: tensor map refused

// ---- device: barriers, TMA, wgmma --------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that lasts
// ~10 s of SM clock (a lost arrival) traps, so a fault ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: one box of a 4-D map (coordinates innermost first) into shared
// memory, completing `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand starting at `p`: leading
// offset `lbo` bytes (K-major: unused, kLboK; MN-major: the panel stride),
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  uint64_t d = (saddr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}
constexpr uint32_t kLboK = 16;

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

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barriers (ids 1-15; 0 is __syncthreads) between warpgroups:
// `threads` counts every thread that syncs or arrives on one use.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the A operand of k-step kk (16 columns) from a 64 x N f32 accumulator,
// rounded to bf16
template <int NF>
__device__ __forceinline__ void a_operand(uint32_t (&a)[4],
                                          const float (&d)[NF], int kk) {
  a[0] = flash::pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = flash::pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = flash::pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = flash::pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d[64 x 128] (+)= A B with A and B in shared memory (descriptors), both
// K-major. scale_d = 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] (+)= A B with A and B in shared memory (descriptors), both
// K-major. scale_d = 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] (+)= A B with A in registers (see the note above) and B in
// shared memory, MN-major (tnspB = 1), across two 64-dim panels.
__device__ __forceinline__ void wgmma_m64n128k16_rs_tn(float* d,
                                                       const uint32_t* a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, looked up once
// (thread-safe static initialisation); null if the driver has none
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Map of a bf16 [batch, seq, heads, 128] tensor with element strides
// (sb, st, sh) and unit last stride, as {128, heads, seq, batch}; a box is
// {64, 1, box_rows, 1} with the 128-byte swizzle. Returns 0 or
// kMapError + the driver's code.
inline int bthd_map(CUtensorMap* map, const void* base, int batch, int seq,
                    int heads, long long sb, long long st, long long sh,
                    int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  // a dimension of extent 1 is only ever read at 0: any legal stride does
  auto bytes = [](long long s, int n) -> cuuint64_t {
    return n > 1 ? static_cast<cuuint64_t>(s) * 2 : 256;
  };
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(st, seq),
                                 bytes(sb, batch)};
  const cuuint32_t box[4] = {kPanelCols, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(rc);
}

// Map of `n` contiguous f32 values, boxes of `box` values, no swizzle; a
// box that runs past n is zero-filled there.
inline int f32_map(CUtensorMap* map, const void* base, long long n, int box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};     // rank 1: none is read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(rc);
}

// The message for a launcher's return code: a CUDA runtime error, or a
// tensor map the driver refused.
inline const char* error_string(int code) {
  if (code >= kMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (driver code = "
           "return code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
