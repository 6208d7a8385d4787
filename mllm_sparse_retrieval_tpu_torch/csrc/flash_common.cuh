// Building blocks shared by the flash-attention kernels: constants and
// helpers of all three (flash_attn.cu, the forward; flash_attn_bwd.cu, the
// dkv and dq backward kernels), and the mma.sync path that only the dq
// kernel still runs (the forward and dkv kernels run on wgmma and TMA:
// hopper_common.cuh).
//
// mma.sync path: tiles are 64 rows of one head, 128 bf16 dims each, in
// shared memory with an XOR swizzle; products are mma.sync m16n8k16 bf16 ->
// f32 with operands fetched by ldmatrix. A block has 4 warps; warp w owns
// rows 16w .. 16w+15 of its 64-row tile, so each thread holds two rows (g
// and g + 8 of its warp's 16, g = lane / 4) of every 16 x 8 accumulator
// fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileElems = kTile * kHeadDim;   // 8,192 bf16 = 16 KB
constexpr int kChunks = kHeadDim / 8;          // 16-byte chunks per row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

// Element offset of 16-byte chunk `chunk` of row `row` in a [64][128] tile.
// The XOR spreads the 8 rows of one ldmatrix 8x8 matrix over 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head into a swizzled smem tile; rows
// at or past `seq` are zero-filled (never NaN, so 0 * V stays 0).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long st, int row0, int seq,
                                          int tid) {
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + tid;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int row = row0 + r;
    const bool in = row < seq;
    const __nv_bfloat16* src = base + (in ? row : seq - 1) * st + c * 8;
    cp_async16(dst + swz(r, c), src, in);
  }
}

// c = A B^T for one warp: A is rows a_row0 .. a_row0 + 15 of the swizzled
// tile sA, B the whole 64-row swizzled tile sB, both [rows][128 dims];
// c[n] holds columns 8n .. 8n + 7 (rows of sB) of the 16 x 64 result.
__device__ __forceinline__ void mma_rows_bt(float (&c)[8][4],
                                            const __nv_bfloat16* sA,
                                            int a_row0,
                                            const __nv_bfloat16* sB,
                                            int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, sA + swz(a_row0 + (lane & 15), 4 * k2 + (lane >> 4)));
    ldsm_x4(a1, sA + swz(a_row0 + (lane & 15), 4 * k2 + 2 + (lane >> 4)));
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bk[4];
      ldsm_x4(bk, sB + swz(n * 8 + (lane & 7), k2 * 4 + (lane >> 3)));
      mma_bf16(c[n], a0, bk[0], bk[1]);
      mma_bf16(c[n], a1, bk[2], bk[3]);
    }
  }
}

// o += P B for one warp: P is a 16 x 64 f32 accumulator (as mma_rows_bt
// leaves it), rounded to bf16 here; it is exactly the A operand layout once
// packed. B is the whole 64-row swizzled tile sB ([64 rows][128 dims], read
// transposed); o[d] holds dims 8d .. 8d + 7 of the 16 x 128 result.
__device__ __forceinline__ void mma_acc_b(float (&o)[16][4],
                                          const float (&s)[8][4],
                                          const __nv_bfloat16* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, sB + swz(kk * 16 + (lane & 15),
                                 dn * 2 + (lane >> 4)));
      mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device. The attribute is per device and only ever grows; setting it again
// is harmless, so two threads racing here need no lock.
template <typename Kernel>
inline cudaError_t ensure_smem(Kernel kernel, int bytes, int* set_per_device) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > set_per_device[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set_per_device[device] = bytes;
  }
  return cudaSuccess;
}

}  // namespace flash
