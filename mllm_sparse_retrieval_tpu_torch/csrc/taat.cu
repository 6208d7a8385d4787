// Term-at-a-time impact scoring for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel mllm_sparse_retrieval_tpu/ops/impact_kernel.py
// ::_taat_kernel (entry impact_scores_taat). It computes
//
//     out[b, n] = sum_j q_w[b, j] * matrix[q_idx[b, j], n]      (f32 accumulate)
//
// over a [T+1, N] impact matrix (int16 or f32) whose row 0 is a dead zero row.
// q_idx arrives already shifted by +1; slots that point at row 0 are padding
// and are skipped (no load, no FMA). With integer weights and sums below 2^24
// every partial sum is an exact f32 integer, so the result does not depend on
// the order of the additions and equals the plain PyTorch version and the
// full-f32 matmul backend exactly.
//
// What bounds it on an H100: memory. Each (query, term) step is one FMA per
// element read, far below the ~20 operations per byte where f32 compute
// would bind. The least traffic is the bytes of the DISTINCT rows the batch
// touches (each read once) plus the B x N x 4 bytes of output. Rows shared by
// many queries (Zipf-hot terms) are re-read from L2 (50 MB) rather than HBM.
//
// What the design does about it:
//   * one block of 256 threads per (query, column tile); query-major block
//     order (blockIdx.x = query), so blocks in flight at one time read the
//     same column slice of the hot rows and hit L2;
//   * the block stages its query's live (row, weight) pairs in shared memory,
//     compacted in slot order with a warp ballot, so the inner loop has no
//     branch and can keep several 16-byte loads in flight per thread;
//   * each thread owns 8 consecutive columns: one 16-byte load per term for
//     int16 rows (8 values), two for f32 rows; accumulation stays in f32
//     registers and the output is written once with 16-byte stores;
//   * the split (1, 2, 4 or 8; chosen by the wrapper from B and N) fills
//     the card at a small batch. With split s the block's threads form s
//     parts over a tile of 2048 / s columns; part p takes the live terms
//     p, p + s, ..., so each thread waits on ~1/s of the query's loads, and
//     part 0 adds the parts' sums in a fixed order through shared memory.
//     A large batch (the bench shape, B=256: 3,328 blocks of 2,048 columns)
//     runs at split 1, where no sum crosses a thread; the served batch
//     (B=8, N=26,624: 104 such blocks on 132 SMs) at split 4 (416 blocks of
//     512 columns).
// Measured by chip_flash_ab.py (PERF.md; NVIDIA H100 80GB HBM3, 700 W): the
// served-shape call 0.0027-0.0029 ms (split 1, the design before the
// split: 0.0032-0.0033 ms) against a 0.0009 ms bytes bound and a 0.0011 ms
// replay floor of the smallest launch; the bench call 0.125-0.128 ms
// int16, 1.5x its bound. The served call is latency-bound: two dependent
// global reads (the query's slots, then the matrix rows) and the store.
// Split 8 is slower there (0.0041 ms: 832 blocks, two waves at 40
// registers a thread); loading several rows a thread before their
// multiply-adds made the int16 bench call ~5% slower.
// The TPU kernel's sublane view, VMEM column blocking, 16-slot DMA ring and
// hot-row VMEM cache are TPU data movement; the L2 and the load pipeline take
// their place here.
//
// Contract (checked by the Python wrapper, ops/impact_kernel.py):
//   matrix [n_rows, n_cols] int16 or f32, contiguous, 16-byte aligned,
//   n_cols % 8 == 0; q_idx [batch, q] int32; q_w [batch, q] f32;
//   out [batch, n_cols] f32; split 1, 2, 4 or 8. Rows outside [1, n_rows)
//   are skipped, so a bad index can never read outside the matrix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 8;
constexpr int kColsPerBlock = kThreads * kColsPerThread;  // 2048 at split 1
constexpr int kWarps = kThreads / 32;
constexpr int kTermChunk = kThreads;  // query slots staged per pass

__device__ __forceinline__ void load8(const int16_t* p, float* v) {
  int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const short2* s = reinterpret_cast<const short2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<float>(s[i].x);
    v[2 * i + 1] = static_cast<float>(s[i].y);
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T, int kSplit>
__global__ void __launch_bounds__(kThreads)
taat_kernel(const T* __restrict__ matrix, const int32_t* __restrict__ q_idx,
            const float* __restrict__ q_w, float* __restrict__ out,
            int64_t n_rows, int64_t n_cols, int q) {
  __shared__ int32_t s_row[kTermChunk];
  __shared__ float s_w[kTermChunk];
  __shared__ int s_warp_live[kWarps];
  __shared__ float4 s_part[kColsPerBlock / 4];   // the parts' sums

  constexpr int col_threads = kThreads / kSplit;
  const int part = threadIdx.x / col_threads;
  const int ct = threadIdx.x % col_threads;
  const int64_t b = blockIdx.x;
  const int64_t col =
      static_cast<int64_t>(blockIdx.y) * col_threads * kColsPerThread +
      static_cast<int64_t>(ct) * kColsPerThread;
  const bool active = col < n_cols;  // n_cols % 8 == 0: all 8 or none
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) acc[k] = 0.0f;

  for (int base = 0; base < q; base += kTermChunk) {
    // stage this chunk's live slots, compacted in slot order
    const int j = base + threadIdx.x;
    int32_t row = 0;
    float w = 0.0f;
    if (j < q) {
      row = q_idx[b * q + j];
      w = q_w[b * q + j];
    }
    const bool live = row > 0 && row < n_rows;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp_live[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int n_live = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = s_warp_live[i];
      offset += (i < warp) ? c : 0;
      n_live += c;
    }
    if (live) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      s_row[pos] = row;
      s_w[pos] = w;
    }
    __syncthreads();

    if (active) {
#pragma unroll 4
      for (int t = part; t < n_live; t += kSplit) {   // this part's terms
        float v[kColsPerThread];
        load8(matrix + static_cast<int64_t>(s_row[t]) * n_cols + col, v);
        const float wt = s_w[t];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) acc[k] = fmaf(wt, v[k], acc[k]);
      }
    }
    __syncthreads();  // s_row / s_w are rewritten by the next chunk
  }

  if (kSplit > 1) {
    // part 0 adds the other parts' sums, in part order
    const int slot = 2 * (part * col_threads + ct);
    if (part > 0) {
      s_part[slot] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      s_part[slot + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
    if (part > 0) return;
#pragma unroll
    for (int p = 1; p < kSplit; ++p) {
      const float4 x = s_part[2 * (p * col_threads + ct)];
      const float4 y = s_part[2 * (p * col_threads + ct) + 1];
      acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
      acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
    }
  }
  if (active) {
    float4* dst = reinterpret_cast<float4*>(out + b * n_cols + col);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

template <typename T, int kSplit>
void launch_split(const void* matrix, const void* q_idx, const void* q_w,
                  void* out, long long n_rows, long long n_cols, int batch,
                  int q, cudaStream_t stream) {
  constexpr long long cols = kColsPerBlock / kSplit;
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>((n_cols + cols - 1) / cols));
  taat_kernel<T, kSplit><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(matrix), static_cast<const int32_t*>(q_idx),
      static_cast<const float*>(q_w), static_cast<float*>(out), n_rows,
      n_cols, q);
}

template <typename T>
int launch(const void* matrix, const void* q_idx, const void* q_w, void* out,
           long long n_rows, long long n_cols, int batch, int q, int split,
           void* stream) {
  if (batch <= 0 || n_cols <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (split) {
    case 1: launch_split<T, 1>(matrix, q_idx, q_w, out, n_rows, n_cols, batch,
                               q, st); break;
    case 2: launch_split<T, 2>(matrix, q_idx, q_w, out, n_rows, n_cols, batch,
                               q, st); break;
    case 4: launch_split<T, 4>(matrix, q_idx, q_w, out, n_rows, n_cols, batch,
                               q, st); break;
    case 8: launch_split<T, 8>(matrix, q_idx, q_w, out, n_rows, n_cols, batch,
                               q, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int taat_i16(const void* matrix, const void* q_idx, const void* q_w, void* out,
             long long n_rows, long long n_cols, int batch, int q, int split,
             void* stream) {
  return launch<int16_t>(matrix, q_idx, q_w, out, n_rows, n_cols, batch, q,
                         split, stream);
}

int taat_f32(const void* matrix, const void* q_idx, const void* q_w, void* out,
             long long n_rows, long long n_cols, int batch, int q, int split,
             void* stream) {
  return launch<float>(matrix, q_idx, q_w, out, n_rows, n_cols, batch, q,
                       split, stream);
}

const char* taat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
