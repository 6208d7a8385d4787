// Causal flash-attention backward for Hopper (sm_90a), plain C interface:
// a dq kernel and a dkv kernel.
//
// Replaces the backward of the stock Pallas TPU kernel behind the custom VJP
// of mllm_sparse_retrieval_tpu/models/layers.py::flash_causal_attention
// (jax.experimental.pallas.ops.tpu.flash_attention, _flash_attention_bwd_dq
// and _flash_attention_bwd_dkv). With the forward's log-sum-exp lse
// (flash_attn.cu, natural base, +inf for a query with no admissible key),
// di[b, h, t] = sum_d out . dout (computed by the caller) and the forward's
// key-mask rule (key s is admissible for query t iff s <= t and
// mask[b, s] != 0), both kernels recompute
//
//   P  = exp(scale * q . k - lse)          (0 where not admissible)
//   dS = P * (dout . v - di)
//
// and the dkv kernel forms dV = P^T dout and dK = scale * dS^T q, the dq
// kernel dQ = scale * dS k. GQA is native: query head h reads kv head
// h / G (G = Hq / Hkv), and the dkv block of one kv head sums over its G
// query heads itself, so K/V are never repeated and no atomics are used:
// the sum order is fixed and the result deterministic.
//
// Layout and types: q/k/v/dout and the outputs dq/dk/dv are bf16 [B, T, H,
// 128], read and written through their strides; lse and di are f32
// [B, Hq, T] contiguous; mask int32 [B, T] contiguous. Products are
// mma.sync m16n8k16 bf16 -> f32; P and dS are rounded to bf16 before each
// product, as the forward rounds P.
//
// What bounds it on an H100: operations. Per admissible (query, key) pair
// and head the backward does five 128-deep products (S and dP in both
// kernels, dV, dK, dQ), 2.5x the forward's two. At the training shape (B=4,
// T=3,072, 32/8 heads; three image rows and an all-pad row) that is
// ~0.57 ms at 989 TFLOP/s against ~0.1 ms of bytes.
//
// What the design does about it:
//   * dkv: one block of 4 warps per (64-key tile, kv head, batch row); each
//     warp owns 16 keys and keeps their dK and dV rows in f32 registers for
//     the whole loop over the G query heads and the query tiles at or after
//     the key tile, and writes them once. K and V stay in shared memory; Q
//     and dout tiles (with their lse and di) are double-buffered with
//     cp.async. The key-tile index is the grid's slowest dimension, in
//     order, so the heaviest tiles (early keys, most queries) start first.
//     A key tile with no real key writes zeros and stops;
//   * dq: one block per (64-query tile, q head, batch row), the forward's
//     grid and tile skip: key tiles above the diagonal are never visited,
//     key tiles with no real key are skipped, and the per-element mask runs
//     on the diagonal tile and on tiles that mix real and pad keys;
//   * S^T = K Q^T and dP^T = V dout^T leave P^T and dS^T in accumulator
//     fragments that are exactly the A operands of dV += P^T dout and
//     dK += dS^T Q, so they never leave registers (the same holds for P, dS
//     and dQ += dS K in the dq kernel).
// wgmma, TMA and one fused kernel are later work.
//
// Contract (checked by the Python wrapper, ops/flash_attention.py): head_dim
// 128; every bf16 tensor has unit last stride, its other strides multiples
// of 8 elements and 16-byte aligned storage; hq % hkv == 0.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kDqSmem = 6 * kTileElems * 2;    // Q, dO, 2 K, 2 V = 96 KB
constexpr int kDkvSmem = 6 * kTileElems * 2;   // K, V, 2 Q, 2 dO = 96 KB

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int32_t* mask;
  const float* lse;
  const float* di;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int seq, hq, group;
  float scale, scale_log2;
};

// Write one warp's 16 x 128 f32 accumulator rows (g and g + 8 of rows
// row0 .. row0 + 15) times `mul` as bf16; rows at or past `seq` are dropped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long st,
                                           int row0, int seq, int lane,
                                           const float (&acc)[16][4],
                                           float mul) {
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < seq) {
      __nv_bfloat16* dst = base + row * st + tig * 2;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        *reinterpret_cast<uint32_t*>(dst + d * 8) =
            pack_bf16(acc[d][2 * r] * mul, acc[d][2 * r + 1] * mul);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kTileElems;
  __nv_bfloat16* sK = sDO + kTileElems;       // two buffers
  __nv_bfloat16* sV = sK + 2 * kTileElems;    // two buffers
  unsigned char* sLive = smem_raw + kDqSmem;  // per key tile flags
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

  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  load_tile(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, seq, tid);
  load_tile(sDO, p.dout + b * p.do_sb + h * p.do_sh, p.do_st, q0, seq, tid);
  cp_async_commit();

  // the forward's tile skip: live key tiles hold a real key, mixed ones
  // also a pad key
  const int q_last = min(q0 + kTile, seq) - 1;
  const int n_kt = q_last / kTile + 1;
  for (int j = tid; j < n_kt; j += kThreads) {
    sLive[j] = 0;
    sMixed[j] = 0;
  }
  __syncthreads();
  for (int s = tid; s <= q_last; s += kThreads) {
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

  const int wr = warp * 16;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row_a = q0 + wr + g;
  const int row_b = row_a + 8;
  const long long stat = (static_cast<long long>(b) * p.hq + h) * seq;
  // lse in the exp2 domain of the scaled logits; +inf gives P = 0
  const float lse_a = row_a < seq ? p.lse[stat + row_a] * kLog2e : INFINITY;
  const float lse_b = row_b < seq ? p.lse[stat + row_b] * kLog2e : INFINITY;
  const float di_a = row_a < seq ? p.di[stat + row_a] : 0.0f;
  const float di_b = row_b < seq ? p.di[stat + row_b] : 0.0f;

  float dq[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d)
    dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.0f;

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
    cp_async_wait<1>();    // Q, dO and tile j have landed
    __syncthreads();

    const __nv_bfloat16* cK = sK + buf * kTileElems;
    const __nv_bfloat16* cV = sV + buf * kTileElems;

    // P = exp2(S * scale * log2(e) - lse * log2(e)) under the key mask
    float s[8][4];
    mma_rows_bt(s, sQ, wr, cK, lane);
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
        s[n][e] = fast_exp2(x - (e < 2 ? lse_a : lse_b));
      }
    }

    // dS = P * (dO V^T - di)
    float ds[8][4];
    mma_rows_bt(ds, sDO, wr, cV, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = s[n][e] * (ds[n][e] - (e < 2 ? di_a : di_b));
    }

    // dQ += dS K
    mma_acc_b(dq, ds, cK, lane);
    __syncthreads();   // every warp is done with buffer `buf` before reuse
    j = jn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_st, q0 + wr, seq, lane,
             dq, p.scale);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTileElems;
  __nv_bfloat16* sQ = sV + kTileElems;        // two buffers
  __nv_bfloat16* sDO = sQ + 2 * kTileElems;   // two buffers
  __shared__ float sL[2][kTile];              // lse * log2(e) of a q tile
  __shared__ float sD[2][kTile];              // di of a q tile
  __shared__ int sAny;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;                  // early keys are the heaviest
  const int k0 = kt * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq = p.seq;
  const int group = p.group;
  const int32_t* mask = p.mask + static_cast<long long>(b) * seq;
  const int wr = warp * 16;

  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;

  load_tile(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_st, k0, seq, tid);
  load_tile(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_st, k0, seq, tid);
  cp_async_commit();

  if (tid == 0) sAny = 0;
  __syncthreads();
  for (int s = k0 + tid; s < min(k0 + kTile, seq); s += kThreads)
    if (mask[s] != 0) sAny = 1;    // benign race: every writer stores 1
  __syncthreads();

  float dk[16][4], dv[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.0f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.0f;
  }
  if (!sAny) {           // no real key here: no query attends to this tile
    cp_async_wait<0>();
    store_rows(dkb, p.dk_st, k0 + wr, seq, lane, dk, 0.0f);
    store_rows(dvb, p.dv_st, k0 + wr, seq, lane, dv, 0.0f);
    return;
  }

  const int g = lane >> 2;
  const int tig = lane & 3;
  const int key_a = k0 + wr + g;
  const int key_b = key_a + 8;
  const bool ok_a = key_a < seq && mask[key_a] != 0;
  const bool ok_b = key_b < seq && mask[key_b] != 0;

  // iterations: every query tile at or after this key tile, for each of
  // the G query heads of this kv head
  const int n_qt = (seq + kTile - 1) / kTile;
  const int nq = n_qt - kt;
  const int total = group * nq;

  auto issue = [&](int it, int buf) {
    const int h = hk * group + it / nq;
    const int q0 = (kt + it % nq) * kTile;
    load_tile(sQ + buf * kTileElems, p.q + b * p.q_sb + h * p.q_sh, p.q_st,
              q0, seq, tid);
    load_tile(sDO + buf * kTileElems, p.dout + b * p.do_sb + h * p.do_sh,
              p.do_st, q0, seq, tid);
    if (tid < kTile) {
      const int t = q0 + tid;
      const long long at = (static_cast<long long>(b) * p.hq + h) * seq + t;
      sL[buf][tid] = t < seq ? p.lse[at] * kLog2e : INFINITY;
      sD[buf][tid] = t < seq ? p.di[at] : 0.0f;
    }
  };

  issue(0, 0);
  cp_async_commit();

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();    // K, V and this iteration's tiles have landed
    __syncthreads();

    const int q0 = (kt + it % nq) * kTile;
    const bool diag = q0 == k0;
    const __nv_bfloat16* cQ = sQ + buf * kTileElems;
    const __nv_bfloat16* cDO = sDO + buf * kTileElems;
    const float* cL = sL[buf];
    const float* cD = sD[buf];

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), rows are keys
    float s[8][4];
    mma_rows_bt(s, sK, wr, cQ, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1);
        const int key = e < 2 ? key_a : key_b;
        const bool ok = (e < 2 ? ok_a : ok_b) && (!diag || key <= q0 + col);
        const float x = ok ? s[n][e] * p.scale_log2 : -INFINITY;
        s[n][e] = fast_exp2(x - cL[col]);
      }
    }

    // dV += P^T dO
    mma_acc_b(dv, s, cDO, lane);

    // dS^T = P^T * (V dO^T - di)
    float ds[8][4];
    mma_rows_bt(ds, sV, wr, cDO, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = s[n][e] * (ds[n][e] - cD[n * 8 + tig * 2 + (e & 1)]);
    }

    // dK += dS^T Q
    mma_acc_b(dk, ds, cQ, lane);
    __syncthreads();   // every warp is done with buffer `buf` before reuse
  }
  cp_async_wait<0>();

  store_rows(dkb, p.dk_st, k0 + wr, seq, lane, dk, p.scale);
  store_rows(dvb, p.dv_st, k0 + wr, seq, lane, dv, 1.0f);
}

int dq_smem_set[kMaxDevices] = {};
int dkv_smem_set[kMaxDevices] = {};

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   const void* mask, const void* lse, const void* di,
                   const long long* st, int seq, int hq, int hkv,
                   float scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.mask = static_cast<const int32_t*>(mask);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  long long* dst[21] = {&p.q_sb,  &p.q_st,  &p.q_sh,  &p.k_sb,  &p.k_st,
                        &p.k_sh,  &p.v_sb,  &p.v_st,  &p.v_sh,  &p.do_sb,
                        &p.do_st, &p.do_sh, &p.dq_sb, &p.dq_st, &p.dq_sh,
                        &p.dk_sb, &p.dk_st, &p.dk_sh, &p.dv_sb, &p.dv_st,
                        &p.dv_sh};
  for (int i = 0; i < 21; ++i) *dst[i] = st[i];
  p.seq = seq;
  p.hq = hq;
  p.group = hq / hkv;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

extern "C" {

// strides: 21 values, [batch, seq, head] strides (elements) of q, k, v,
// dout, dq, dk, dv in that order. dq, or dk and dv, may be null: only the
// kernels whose outputs are given run.
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        const void* mask, const void* lse, const void* di,
                        const long long* strides, int batch, int seq, int hq,
                        int hkv, float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, dout, dq, dk, dv, mask, lse, di,
                               strides, seq, hq, hkv, scale);
  const int n_tiles = (seq + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk != nullptr && dv != nullptr) {
    cudaError_t err = ensure_smem(flash_bwd_dkv_kernel, kDkvSmem,
                                  dkv_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(hkv), static_cast<unsigned>(batch),
                    static_cast<unsigned>(n_tiles));
    flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    const int smem = kDqSmem + 2 * n_tiles;
    cudaError_t err = ensure_smem(flash_bwd_dq_kernel, smem, dq_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(hq), static_cast<unsigned>(batch),
                    static_cast<unsigned>(n_tiles));
    flash_bwd_dq_kernel<<<grid, kThreads, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
