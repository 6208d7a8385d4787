// InternVL's dynamic tiling on Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package tiles on the host (Pillow's
// resize in data/tiling.py::dynamic_tile), and so did the port, in numpy
// (models/anyres.py::resize_bicubic) on the encode pipeline's prefetch
// thread and in the trainer's collator, where it set the pace of InternVL's
// indexing (245 ms an image on the card's host against ~205 ms of card
// work). This kernel makes the same tiles on the card from the raw uint8
// images: the padded, ImageNet-normalised [B, T, S, S, 3] f32 tile tensor
// that data/tiling.py's dynamic_tile + pad_tiles give, byte for byte.
//
// Arithmetic: Pillow's 8-bit bicubic resample (Resample.c), two separable
// passes, horizontal first, each skipped by Pillow when its size does not
// change: here the horizontal pass then has no job, and the vertical one
// reads a table of exact identity weights (Pillow's bicubic is 0 at every
// nonzero integer offset), which gives the skipped pass's bytes.
// Per output pixel an int32 sum that starts at 1 << 21, adds the 22-bit
// fixed-point weights times the input bytes, shifts right by 22
// (arithmetic, a floor) and clips to [0, 255]. The weights and each output
// index's first input are Pillow's (models/anyres.py::_coefficients),
// computed on the host and passed in the tables. The integer sums do not
// depend on their order. The normalisation is (u / 255 - mean) / std in
// IEEE f32, each operation rounded to nearest (no contraction), as numpy
// computes it.
//
// What bounds it on an H100: bytes. A pass does a few integer multiply-adds
// per byte it reads, and the vertical pass writes 12 bytes of f32 for every
// output pixel: 250 MB for the index batch's 8 x 13 tiles of 448 x 448,
// padding tiles included, against ~1 MB of input an image. So the least
// time is the output's bytes over the card's bandwidth, ~75 us a batch.
//
// What the design does about it:
//   * two launches a batch, no host sync. The horizontal pass writes the
//     intermediate uint8 rows (H x cols*S, and H x S for the thumbnail) to
//     scratch; its blocks walk a flat list, each (image, pass) job a run of
//     blocks, so images of different sizes share one launch with no idle
//     blocks. An image whose width does not change has no job: the vertical
//     pass reads its raw bytes.
//   * the vertical pass fuses the resample, the normalisation and the
//     scatter into tile slots: one thread a tile pixel, its three channels,
//     grid (pixels / 256, T, B); a warp reads 32 neighbouring pixels of each
//     input row (96 contiguous bytes) and writes 384 contiguous bytes.
//     Padding slots are written as zeros by the same launch, so the output
//     needs no memset.
//   * the intermediate stays in uint8 (3 bytes a pixel), and both passes
//     read through L1/L2: each input row is reused by the ~5-11 output
//     rows whose windows cover it.
// Measured (chip_smoke.phase_tile, PERF.md; NVIDIA H100 80GB HBM3, 700 W):
// 0.30 ms a batch of the index mix's 8 images in a graph replay, 4x its
// 0.077 ms bound (scalar 4-byte stores at a 12-byte stride, the integer
// loops), against ~1.6 s of card work a batch: left as it is.
//
// Contract (built and checked by the Python wrapper, ops/tile_kernel.py):
// one uint8 buffer `data` holds the int32 tables at offset 0, then the raw
// [H, W, 3] images, then the scratch. Tables, in int32 units:
//   [0, 8)     mean[3], std[3] as f32 bits, 2 unused;
//   8 + 8 j    horizontal job j: {src, in_w, out_w, rows, coef, ksize, dst,
//              first_block} (src, dst: byte offsets in data);
//   then       B * T vertical jobs {src, src_w, x0, y0, coef, ksize, in_h,
//              live}: slot b * T + t reads rows of in_h x src_w pixels at
//              src, columns x0 .. x0 + S, output rows y0 .. y0 + S of its
//              table; live 0 marks a padding slot;
//   coef       a table: per output index {first input, ksize weights}.
// Weights past an image's edge are 0 and their bytes are not read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJob = 8;     // int32 fields of a job
constexpr int kNorm = 8;    // int32 fields before the first job

__device__ __forceinline__ uint8_t clip8(int acc) {
  const int v = acc >> 22;  // arithmetic shift: a floor, as Pillow's
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void __launch_bounds__(kThreads)
tile_horizontal_kernel(uint8_t* __restrict__ data,
                       const int* __restrict__ tab, int n_jobs) {
  const int* jobs = tab + kNorm;
  const int block = blockIdx.x;
  int j = 0;
  while (j + 1 < n_jobs && jobs[(j + 1) * kJob + 7] <= block) ++j;
  const int* job = jobs + j * kJob;
  const int in_w = job[1], out_w = job[2], rows = job[3], ksize = job[5];
  const long long p =
      static_cast<long long>(block - job[7]) * kThreads + threadIdx.x;
  if (p >= static_cast<long long>(rows) * out_w) return;
  const int y = static_cast<int>(p / out_w);
  const int x = static_cast<int>(p - static_cast<long long>(y) * out_w);
  const int* c = tab + job[4] + x * (ksize + 1);
  const int x0 = c[0];
  const int n = min(ksize, in_w - x0);
  const uint8_t* in =
      data + job[0] + (static_cast<long long>(y) * in_w + x0) * 3;
  int a0 = 1 << 21, a1 = 1 << 21, a2 = 1 << 21;
  for (int i = 0; i < n; ++i) {
    const int k = c[1 + i];
    a0 += k * in[3 * i];
    a1 += k * in[3 * i + 1];
    a2 += k * in[3 * i + 2];
  }
  uint8_t* out = data + job[6] + p * 3;
  out[0] = clip8(a0);
  out[1] = clip8(a1);
  out[2] = clip8(a2);
}

__global__ void __launch_bounds__(kThreads)
tile_vertical_kernel(const uint8_t* __restrict__ data,
                     const int* __restrict__ tab, int n_h, int tile,
                     float* __restrict__ out) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= tile * tile) return;
  const int slot = blockIdx.z * gridDim.y + blockIdx.y;
  float* o = out + (static_cast<long long>(slot) * tile * tile + pix) * 3;
  const int* job = tab + kNorm + (n_h + slot) * kJob;
  if (!job[7]) {
    o[0] = 0.f;
    o[1] = 0.f;
    o[2] = 0.f;
    return;
  }
  const int src_w = job[1], ksize = job[5], in_h = job[6];
  const int y = pix / tile, x = pix - (pix / tile) * tile;
  const int* c = tab + job[4] + (job[3] + y) * (ksize + 1);
  const int r0 = c[0];
  const int n = min(ksize, in_h - r0);
  const long long stride = static_cast<long long>(src_w) * 3;
  const uint8_t* in =
      data + job[0] + r0 * stride + static_cast<long long>(job[2] + x) * 3;
  int a0 = 1 << 21, a1 = 1 << 21, a2 = 1 << 21;
  for (int i = 0; i < n; ++i) {
    const int k = c[1 + i];
    const uint8_t* row = in + i * stride;
    a0 += k * row[0];
    a1 += k * row[1];
    a2 += k * row[2];
  }
  const float* norm = reinterpret_cast<const float*>(tab);
  const uint8_t u[3] = {clip8(a0), clip8(a1), clip8(a2)};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = __fdiv_rn(static_cast<float>(u[ch]), 255.0f);
    o[ch] = __fdiv_rn(__fsub_rn(v, norm[ch]), norm[3 + ch]);
  }
}

}  // namespace

extern "C" {

// data: the staged buffer (device); tab: its tables (data viewed as int32);
// n_h horizontal jobs over h_blocks blocks; batch x slots vertical jobs of
// tile x tile pixels; out: [batch, slots, tile, tile, 3] f32.
int tile_images(void* data, int n_h, int h_blocks, int batch, int slots,
                int tile, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* d = static_cast<uint8_t*>(data);
  const int* tab = static_cast<const int*>(data);
  if (n_h > 0) {
    tile_horizontal_kernel<<<h_blocks, kThreads, 0, s>>>(d, tab, n_h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((tile * tile + kThreads - 1) / kThreads, slots, batch);
  tile_vertical_kernel<<<grid, kThreads, 0, s>>>(d, tab, n_h, tile,
                                                 static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
