// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the forward of the stock Pallas TPU kernel that
// mllm_sparse_retrieval_tpu/models/layers.py::flash_causal_attention calls
// (jax.experimental.pallas.ops.tpu.flash_attention, _flash_attention_kernel).
// It computes
//
//   out[b, t, h] = sum_s softmax_s(scale * q[b,t,h] . k[b,s,h/G]) v[b,s,h/G]
//
// over the admissible keys: s <= t with mask[b, s] != 0 (G = Hq / Hkv,
// native GQA: no K/V head is repeated). This is the JAX package's
// `attention` + `causal_padding_mask` (SegmentIds(q=ones, kv=mask)): a pad
// query attends to every real key at or before it. A query with no
// admissible key (an all-pad row, or a position before the first real
// token) gets an output of 0 and a log-sum-exp of +inf, so that the
// backward kernels (flash_attn_bwd.cu) recompute P = 0 there. Inputs and
// output are bf16 in the [B, T, H, 128] layout, read and written through
// their strides; products accumulate in f32 and the softmax is f32.
//
// Optional output: lse[b, h, t] = log sum_s exp(scale * q . k_s) in f32,
// natural base, over the admissible keys (+inf where there is none); a null
// pointer writes none (serving).
//
// What bounds it on an H100: operations. A served call (B=8, T=3,072, 32
// q-heads; seven rows of 1,795-2,971 real tokens and one all-pad row) does
// ~5.0e11 FLOP of tensor-core work on ~0.5 GB of q/k/v/out: ~0.51 ms at
// 989 TFLOP/s against ~0.15 ms of bytes.
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
//     real key are skipped, and the per-element mask runs only on the
//     diagonal tile and on tiles that mix real and pad keys.
// wgmma, TMA and warp specialisation are later work.
//
// Contract (checked by the Python wrapper, ops/flash_attention.py): head_dim
// 128; q/k/v/out bf16 with unit last stride, every other stride a multiple
// of 8 elements and 16-byte aligned storage; mask int32 [batch, seq]
// contiguous; lse f32 [batch, hq, seq] contiguous or null; hq % hkv == 0.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kFixedSmem = 5 * kTileElems * 2;   // Q + 2 K + 2 V = 80 KB

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int32_t* mask;
  float* lse;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int seq, hq, group;
  float scale_log2;
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTileElems;        // two buffers
  __nv_bfloat16* sV = sK + 2 * kTileElems;    // two buffers
  unsigned char* sLive = smem_raw + kFixedSmem;   // per key tile flags
  const int n_tiles_max = (p.seq + kTile - 1) / kTile;
  unsigned char* sMixed = sLive + n_tiles_max;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;    // heavy causal tiles first
  const int q0 = qt * kTile;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq = p.seq;
  const int32_t* mask = p.mask + static_cast<long long>(b) * seq;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // Q tile first, so its copy overlaps the mask scan below
  load_tile(sQ, qb, p.q_st, q0, seq, tid);
  cp_async_commit();

  // which causal key tiles hold a real key (live), and which also hold a
  // pad key (mixed: the element mask must run there)
  const int q_last = min(q0 + kTile, seq) - 1;
  const int n_kt = q_last / kTile + 1;     // causal: tiles 0 .. n_kt - 1
  for (int j = tid; j < n_kt; j += kThreads) {
    sLive[j] = 0;
    sMixed[j] = 0;
  }
  __syncthreads();
  for (int s = tid; s <= q_last; s += kThreads) {
    // every writer stores the same value, so the races are benign
    if (mask[s] != 0) sLive[s / kTile] = 1;
    else sMixed[s / kTile] = 1;
  }
  __syncthreads();

  int j = 0;
  while (j < n_kt && !sLive[j]) ++j;
  if (j < n_kt) {
    load_tile(sK, kb, p.k_st, j * kTile, seq, tid);
    load_tile(sV, vb, p.v_st, j * kTile, seq, tid);
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
      load_tile(sK + (buf ^ 1) * kTileElems, kb, p.k_st, jn * kTile, seq,
                tid);
      load_tile(sV + (buf ^ 1) * kTileElems, vb, p.v_st, jn * kTile, seq,
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
          const int key = j * kTile + n * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool ok = key <= row && key < seq && __ldg(mask + key) != 0;
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
    mma_acc_b(o, s, cV, lane);
    __syncthreads();   // every warp is done with buffer `buf` before reuse
    j = jn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // normalise and write; a row with no admissible key has l = 0: it gets 0
  // and a log-sum-exp of +inf
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
      if (p.lse != nullptr && tig == 0) {
        p.lse[(static_cast<long long>(b) * p.hq + h) * seq + row] =
            l > 0.0f ? (m_r[r] + log2f(l)) * kLn2 : INFINITY;
      }
    }
  }
}

int smem_set[kMaxDevices] = {};

}  // namespace

extern "C" {

int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        const void* mask, void* lse, long long q_sb,
                        long long q_st, long long q_sh, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb,
                        long long v_st, long long v_sh, long long o_sb,
                        long long o_st, long long o_sh, int batch, int seq,
                        int hq, int hkv, float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.mask = static_cast<const int32_t*>(mask);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.seq = seq;
  p.hq = hq;
  p.group = hq / hkv;
  p.scale_log2 = scale * kLog2e;
  const int n_tiles = (seq + kTile - 1) / kTile;
  const int smem = kFixedSmem + 2 * n_tiles;
  cudaError_t err = ensure_smem(flash_fwd_kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(hq), static_cast<unsigned>(batch),
                  static_cast<unsigned>(n_tiles));
  flash_fwd_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
