// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the stock Pallas TPU kernel that
// mllm_sparse_retrieval_tpu/models/layers.py::flash_causal_attention calls
// (jax.experimental.pallas.ops.tpu.flash_attention with causal=True and
// SegmentIds(q=mask, kv=mask)), forward only. It computes
//
//   out[b, t, h] = sum_s softmax_s(scale * q[b,t,h] . k[b,s,h/G]) v[b,s,h/G]
//
// over the admissible keys s <= t with seg[b, s] == seg[b, t] (G = Hq / Hkv,
// native GQA: no K/V head is repeated). Inputs and output are bf16 in the
// [B, T, H, 128] layout, read and written through their strides; products
// accumulate in f32 and the softmax is f32. One segment-id vector serves
// queries and keys, so every query admits its own key and a pad row attends
// among its pads; the normaliser is guarded all the same (0, never NaN).
//
// What bounds it on an H100: operations. A served call (B=8, T=3,072, 32
// q-heads, ~2,943 real tokens a row) does ~5.7e11 FLOP of tensor-core work on
// ~0.5 GB of q/k/v/out: ~0.57 ms at 989 TFLOP/s against ~0.15 ms of bytes.
//
// What the design does about it:
//   * one block of 4 warps per (64-query tile, q-head, batch row); each warp
//     owns 16 query rows, so a row's max and sum stay inside one quad of
//     threads and no block-wide reduction is needed;
//   * the query tile index is the slowest grid dimension, reversed, so the
//     heaviest causal tiles (late queries, many keys) are scheduled first;
//   * Q stays in registers as mma A-fragments for the whole key loop; K and V
//     tiles of 64 keys are double-buffered in shared memory with cp.async,
//     the next tile loading while the current one is computed;
//   * mma.sync m16n8k16 bf16 -> f32 for S = Q K^T and O += P V, operands
//     fetched with ldmatrix (V with .trans) from an XOR-swizzled layout that
//     makes the 16-byte rows of one 8x8 matrix fall on distinct banks;
//   * P never leaves registers: the S accumulator fragments are exactly the
//     A fragments of the P V product once packed to bf16;
//   * online softmax in the exp2 form, with scale * log2(e) folded into S;
//   * key tiles above the diagonal are never visited, key tiles holding no
//     key of the query tile's segments are skipped, and the per-element
//     mask runs only on the diagonal tile and on tiles with mixed segments.
// wgmma, TMA and warp specialisation are later work.
//
// Contract (checked by the Python wrapper, ops/flash_attention.py): head_dim
// 128; q/k/v/out bf16 with unit last stride, every other stride a multiple
// of 8 elements and 16-byte aligned storage; seg int32 [batch, seq]
// contiguous; hq % hkv == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;     // query rows per block
constexpr int kBlockN = 64;     // keys per tile
constexpr int kHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileElems = kBlockM * kHeadDim;   // 8,192 bf16 = 16 KB
constexpr int kChunks = kHeadDim / 8;            // 16-byte chunks per row
constexpr int kFixedSmem = 5 * kTileElems * 2;   // Q + 2 K + 2 V = 80 KB
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int32_t* seg;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int seq, group;
  float scale_log2;
};

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
  for (int it = 0; it < kBlockM * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + tid;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int row = row0 + r;
    const bool in = row < seq;
    const __nv_bfloat16* src = base + (in ? row : seq - 1) * st + c * 8;
    cp_async16(dst + swz(r, c), src, in);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTileElems;        // two buffers
  __nv_bfloat16* sV = sK + 2 * kTileElems;    // two buffers
  unsigned char* sLive = smem_raw + kFixedSmem;   // per key tile flags
  const int n_tiles_max = (p.seq + kBlockN - 1) / kBlockN;
  unsigned char* sMixed = sLive + n_tiles_max;
  __shared__ int sQmin, sQmax;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;    // heavy causal tiles first
  const int q0 = qt * kBlockM;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq = p.seq;
  const int32_t* seg = p.seg + static_cast<long long>(b) * seq;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // Q tile first, so its copy overlaps the segment scan below
  load_tile(sQ, qb, p.q_st, q0, seq, tid);
  cp_async_commit();

  // segment range of this query tile, and which key tiles it needs
  const int q_last = min(q0 + kBlockM, seq) - 1;
  const int n_kt = q_last / kBlockN + 1;     // causal: tiles 0 .. n_kt - 1
  if (tid == 0) {
    sQmin = 0x7fffffff;
    sQmax = -0x7fffffff - 1;
  }
  for (int j = tid; j < n_kt; j += kThreads) {
    sLive[j] = 0;
    sMixed[j] = 0;
  }
  __syncthreads();
  if (tid < kBlockM && q0 + tid < seq) {
    const int s = seg[q0 + tid];
    atomicMin(&sQmin, s);
    atomicMax(&sQmax, s);
  }
  __syncthreads();
  const int qmin = sQmin;
  const int qmax = sQmax;
  for (int s = tid; s <= q_last; s += kThreads) {
    const int sg = seg[s];
    // every writer stores the same value, so the races are benign
    if (sg >= qmin && sg <= qmax) sLive[s / kBlockN] = 1;
    if (sg != qmin || qmin != qmax) sMixed[s / kBlockN] = 1;
  }
  __syncthreads();

  int j = 0;
  while (j < n_kt && !sLive[j]) ++j;
  if (j < n_kt) {
    load_tile(sK, kb, p.k_st, j * kBlockN, seq, tid);
    load_tile(sV, vb, p.v_st, j * kBlockN, seq, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();      // Q has landed
  __syncthreads();

  // Q fragments of this warp's 16 rows: 8 k-steps of 16 dims
  uint32_t qf[8][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    ldsm_x4(qf[kk], sQ + swz(wr + (lane & 15), kk * 2 + (lane >> 4)));

  const int g = lane >> 2;      // row within the 8-row half
  const int tig = lane & 3;     // thread in quad
  const int row_a = q0 + wr + g;
  const int row_b = row_a + 8;
  const int seg_a = row_a < seq ? seg[row_a] : 0;
  const int seg_b = row_b < seq ? seg[row_b] : 0;

  float o[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};

  int buf = 0;
  while (j < n_kt) {
    int jn = j + 1;
    while (jn < n_kt && !sLive[jn]) ++jn;
    if (jn < n_kt) {
      load_tile(sK + (buf ^ 1) * kTileElems, kb, p.k_st, jn * kBlockN, seq,
                tid);
      load_tile(sV + (buf ^ 1) * kTileElems, vb, p.v_st, jn * kBlockN, seq,
                tid);
    }
    cp_async_commit();
    cp_async_wait<1>();    // tile j has landed
    __syncthreads();

    const __nv_bfloat16* cK = sK + buf * kTileElems;
    const __nv_bfloat16* cV = sV + buf * kTileElems;

    // S = Q K^T for 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bk[4];
        ldsm_x4(bk, cK + swz(n * 8 + (lane & 7), k2 * 4 + (lane >> 3)));
        mma_bf16(s[n], qf[2 * k2], bk[0], bk[1]);
        mma_bf16(s[n], qf[2 * k2 + 1], bk[2], bk[3]);
      }
    }

    // scale into the exp2 domain and mask
    const bool need_mask = (j == qt) || sMixed[j];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        if (need_mask) {
          const int key = j * kBlockN + n * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const int sr = e < 2 ? seg_a : seg_b;
          const bool ok = key <= row && key < seq && __ldg(seg + key) == sr;
          x = ok ? x : -INFINITY;
        }
        s[n][e] = x;
      }
    }

    // online softmax; a row's 64 values live in one quad of threads
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // no key yet
      const float alpha = fast_exp2(m_r[r] - m_use);
      m_r[r] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = fast_exp2(s[n][2 * r] - m_use);
        const float p1 = fast_exp2(s[n][2 * r + 1] - m_use);
        s[n][2 * r] = p0;
        s[n][2 * r + 1] = p1;
        rs += p0 + p1;
      }
      l_r[r] = l_r[r] * alpha + rs;   // this thread's share; summed at the end
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the S fragments are P's A fragments
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
        ldsm_x4_trans(bv, cV + swz(kk * 16 + (lane & 15),
                                   dn * 2 + (lane >> 4)));
        mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with buffer `buf` before reuse
    j = jn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // normalise and write; l > 0 under self-attention, guarded all the same
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    const int row = r == 0 ? row_a : row_b;
    if (row < seq) {
      __nv_bfloat16* dst = p.o + b * p.o_sb + row * p.o_st + h * p.o_sh +
                           tig * 2;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        *reinterpret_cast<uint32_t*>(dst + d * 8) =
            pack_bf16(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
      }
    }
  }
}

}  // namespace

extern "C" {

int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        const void* seg, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, long long o_sb, long long o_st,
                        long long o_sh, int batch, int seq, int hq, int hkv,
                        float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.seg = static_cast<const int32_t*>(seg);
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.seq = seq;
  p.group = hq / hkv;
  p.scale_log2 = scale * kLog2e;
  const int n_tiles = (seq + kBlockN - 1) / kBlockN;
  const int smem = kFixedSmem + 2 * n_tiles;
  // the attribute is per device and only ever grows; setting it again is
  // harmless, so two threads racing here need no lock
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = smem;
  }
  const dim3 grid(static_cast<unsigned>(hq), static_cast<unsigned>(batch),
                  static_cast<unsigned>((seq + kBlockM - 1) / kBlockM));
  flash_fwd_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
