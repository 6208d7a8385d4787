// Constants and small helpers shared by the flash-attention kernels
// (flash_attn.cu, the forward; flash_attn_bwd.cu, the dq and dkv backward
// kernels). Their Hopper building blocks (TMA, mbarriers, wgmma, the work
// items) are in hopper_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
