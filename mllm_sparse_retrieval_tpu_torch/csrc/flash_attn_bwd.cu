// Causal flash-attention backward for Hopper (sm_90a), plain C interface:
// a dkv kernel and a dq kernel.
//
// Replaces the backward of the stock Pallas TPU kernel behind the custom VJP
// of mllm_sparse_retrieval_tpu/models/layers.py:199 (flash_causal_attention):
// jax/experimental/pallas/ops/tpu/flash_attention.py:941
// (_flash_attention_bwd_dkv, pallas_call :1121) and :1287
// (_flash_attention_bwd_dq, pallas_call :1456; jax 0.9.0). With the
// forward's log-sum-exp lse (flash_attn.cu, natural base, +inf for a query
// with no admissible key), di[b, h, t] = sum_d out . dout (computed by the
// caller) and the forward's key-mask rule (key s is admissible for query t
// iff s <= t and mask[b, s] != 0), both kernels recompute
//
//   P  = exp(scale * q . k - lse)          (0 where not admissible)
//   dS = P * (dout . v - di)
//
// and the dkv kernel forms dV = P^T dout and dK = scale * dS^T q, the dq
// kernel dQ = scale * dS k. GQA is native: query head h reads kv head
// h / G (G = Hq / Hkv), and the dkv block of one kv head sums over its G
// query heads itself, so K/V are never repeated and no atomics are used:
// the sum order is fixed and the result deterministic, bit for bit.
//
// Layout and types: q/k/v/dout and the outputs dq/dk/dv are bf16 [B, T, H,
// 128], read and written through their strides; lse and di are f32
// [B, Hq, T] contiguous; mask int32 [B, T] contiguous. Products are bf16 ->
// f32; P and dS are rounded to bf16 before each product, as the forward
// rounds P.
//
// What bounds it on an H100: operations. Per admissible (query, key) pair
// and head the backward does five 128-deep products (S and dP in both
// kernels, dV, dK, dQ), 2.5x the forward's two. At the training shape (B=4,
// T=3,072, 32/8 heads; three image rows and an all-pad row) the dkv
// kernel's four are 0.4535 ms at 989 TFLOP/s and the dq kernel's three
// 0.3401 ms, against ~0.1 ms of bytes. Only wgmma reaches that rate.
//
// dkv, for Hopper (hopper_common.cuh holds the building blocks):
//   * one block of three warpgroups (384 threads) per (128-key tile, kv
//     head, batch row); the key-tile index is the grid's slowest dimension,
//     in order, so the heaviest tiles (early keys, most queries) start
//     first. A key tile with no real key writes zeros and stops;
//   * warpgroup 0 is the producer (setmaxnreg 24): one thread loads K and V
//     once by TMA (32 KB each) and streams, for each of the G query heads
//     and each 64-query tile at or after the key tile, Q and dout (16 KB
//     each) and their 64 lse and di values through a ring of 2 stages on
//     full/empty mbarriers; TMA zero-fills rows past T;
//   * warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 keys each:
//     S^T = K Q^T and dP^T = V dout^T are 16 wgmma m64n64k16 with both
//     operands in shared memory, committed as two groups so P^T is formed
//     while dP^T is still on the tensor cores; P^T and dS^T, rounded to
//     bf16 in registers, are the register A operands of dV += P^T dout and
//     dK += dS^T Q (8 wgmma m64n128k16, dout and Q as MN-major B operands).
//     dK and dV stay in registers (64 f32 a thread each) for the whole
//     loop and are written once; a consumer skips the query tile that lies
//     wholly before its keys;
//   * shared memory per block: K, V 64 KB + 2 x (Q, dout 32 KB + 512 bytes
//     of lse and di) = 129 KB.
// Registers as `nvcc -Xptxas -v` reports them on the card (CUDA 12.8):
// 168 a thread at launch (384 threads), the consumers at up to 240 after
// setmaxnreg and the producer at 24; 32 bytes of spill stores and 44 of
// loads (a 32-byte frame): a few loop-invariant integers of the consumers
// kept in local memory across each iteration's products (dK, dV, S^T and
// dP^T take 192 of the 240 registers), and the producer's. The mma.sync
// design this replaces ran at 255 with 12-64 bytes of spills.
// Measured by chip_smoke.py (see PERF.md): 0.92 ms at the synthetic
// training shape,
// 2.02x the bound; what holds it back: S^T and dP^T are m64n64 products
// with both operands in shared memory, which need about the whole
// shared-memory bandwidth at the tensor-core rate, and each iteration's
// four products depend on one another with only two warpgroups to overlap.
//
// dq (the first, mma.sync design; wgmma is later work): one block of 4 warps
// per (64-query tile, q head, batch row), the forward's grid and tile skip;
// mma.sync m16n8k16 with ldmatrix operands (flash_common.cuh), cp.async
// double buffering, dS and dQ += dS K in registers.
//
// Contract (checked by the Python wrapper, ops/flash_attention.py): head_dim
// 128; every bf16 tensor has unit last stride, its other strides multiples
// of 8 elements and 16-byte aligned storage; hq % hkv == 0.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kDqSmem = 6 * kTileElems * 2;    // Q, dO, 2 K, 2 V = 96 KB

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

// ---- dkv: wgmma, TMA and warp specialisation -------------------------------

constexpr int kDkvKeys = 128;                  // keys per block, 64 a consumer
constexpr int kDkvRows = 64;                   // queries per streamed tile
constexpr int kDkvStages = 2;                  // Q/dO/lse/di ring
constexpr int kDkvThreads = 384;               // producer + 2 consumers
constexpr int kKvPanel = kDkvKeys * 128;       // 128 rows x 64 dims: 16 KB
constexpr int kKvTile = 2 * kKvPanel;
constexpr int kQPanel = kDkvRows * 128;        // 64 rows x 64 dims: 8 KB
constexpr int kQTile = 2 * kQPanel;
constexpr int kStatBytes = kDkvRows * 4;
constexpr int kSmemV = kKvTile;                // K at 0
constexpr int kSmemQ = 2 * kKvTile;
constexpr int kSmemDO = kSmemQ + kDkvStages * kQTile;
constexpr int kSmemL = kSmemDO + kDkvStages * kQTile;
constexpr int kSmemD = kSmemL + kDkvStages * kStatBytes;
constexpr int kSmemBar = kSmemD + kDkvStages * kStatBytes;
constexpr int kDkvSmem = 1024 + kSmemBar + 64;   // + alignment slack

struct DkvParams {
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int32_t* mask;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int seq, hq, group;
  float scale, scale_log2;
};

// Write a consumer warpgroup's 64 x 128 f32 accumulator rows (row0 + 16w +
// g and + 8) times `mul` as bf16; rows at or past `seq` are dropped.
__device__ __forceinline__ void store_wg_rows(__nv_bfloat16* base,
                                              long long st, int row0,
                                              int seq, const float (&acc)[64],
                                              float mul) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x / 32) & 3;
  const int tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * w + (lane >> 2) + 8 * r;
    if (row < seq) {
      __nv_bfloat16* dst = base + row * st + tig * 2;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        *reinterpret_cast<uint32_t*>(dst + d * 8) =
            pack_bf16(acc[4 * d + 2 * r] * mul, acc[4 * d + 2 * r + 1] * mul);
      }
    }
  }
}

__device__ __forceinline__ void dkv_consume(const DkvParams& p,
                                            unsigned char* smem,
                                            uint64_t* bar, int k0, int nq,
                                            int total, int b, int hk) {
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kDkvStages;
  const int tid = threadIdx.x;
  const int wg = tid / 128 - 1;          // keys 64 wg .. 64 wg + 63
  const int w = (tid / 32) & 3;
  const int lane = tid & 31;
  const int tig = lane & 3;
  const int seq = p.seq;
  const int kwg = k0 + 64 * wg;
  const int key_a = kwg + 16 * w + (lane >> 2);
  const int key_b = key_a + 8;
  const int32_t* mask = p.mask + static_cast<long long>(b) * seq;
  const bool ok_a = key_a < seq && mask[key_a] != 0;
  const bool ok_b = key_b < seq && mask[key_b] != 0;
  const int t0 = k0 / kDkvRows;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;

  mbar_wait(kv_full, 0);
  const unsigned char* sK = smem + wg * 64 * 128;
  const unsigned char* sV = smem + kSmemV + wg * 64 * 128;
  for (int it = 0; it < total; ++it) {
    const int s = it % kDkvStages;
    const int q0 = (t0 + it % nq) * kDkvRows;
    mbar_wait(full + s, (it / kDkvStages) & 1);
    if (q0 + kDkvRows <= kwg) {        // every query precedes every key here
      if (lane == 0) mbar_arrive(empty + s);
      continue;
    }
    const unsigned char* sQ = smem + kSmemQ + s * kQTile;
    const unsigned char* sDO = smem + kSmemDO + s * kQTile;
    const float* sL = reinterpret_cast<const float*>(smem + kSmemL +
                                                     s * kStatBytes);
    const float* sD = reinterpret_cast<const float*>(smem + kSmemD +
                                                     s * kStatBytes);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, committed
    // apart, so that P^T is formed while dP^T is still on the tensor cores
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off_a = (kk >> 2) * kKvPanel + (kk & 3) * 32;
      const int off_b = (kk >> 2) * kQPanel + (kk & 3) * 32;
      wgmma_m64n64k16_ss(st, sw128_desc(sK + off_a, kLboK),
                         sw128_desc(sQ + off_b, kLboK), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off_a = (kk >> 2) * kKvPanel + (kk & 3) * 32;
      const int off_b = (kk >> 2) * kQPanel + (kk & 3) * 32;
      wgmma_m64n64k16_ss(dpt, sw128_desc(sV + off_a, kLboK),
                         sw128_desc(sDO + off_b, kLboK), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) under the key mask
    // (the causal part only on the diagonal, queries past T only at the
    // end)
    const bool edge = q0 < kwg + 64 || q0 + kDkvRows > seq;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * tig;
      const float2 lse2 = *reinterpret_cast<const float2*>(sL + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + col + (e & 1);
        const int key = e < 2 ? key_a : key_b;
        bool ok = e < 2 ? ok_a : ok_b;
        if (edge) ok = ok && key <= q && q < seq;
        const float x = ok ? st[4 * n + e] * p.scale_log2 : -INFINITY;
        st[4 * n + e] =
            fast_exp2(x - ((e & 1) ? lse2.y : lse2.x) * kLog2e);
      }
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_operand(pa[kk], st, kk);

    // dS^T = P^T * (dP^T - di)
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 di2 =
          *reinterpret_cast<const float2*>(sD + 8 * n + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * n + e] = st[4 * n + e] *
                         (dpt[4 * n + e] - ((e & 1) ? di2.y : di2.x));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_operand(da[kk], dpt, kk);

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T in registers (bf16),
    // dO and Q MN-major B operands across both 64-dim panels
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n128k16_rs_tn(dv, pa[kk], sw128_desc(sDO + kk * 2048, kQPanel),
                             1);
      wgmma_m64n128k16_rs_tn(dk, da[kk], sw128_desc(sQ + kk * 2048, kQPanel),
                             1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done with stage s
  }

  store_wg_rows(p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_st, kwg, seq, dk,
                p.scale);
  store_wg_rows(p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_st, kwg, seq, dv,
                1.0f);
}

__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p,
                     const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_di) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte tiles
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kSmemBar);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kDkvStages;
  __shared__ int s_any;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kDkvKeys;    // early keys are the heaviest
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int seq = p.seq;
  const int group = p.group;
  const int32_t* mask = p.mask + static_cast<long long>(b) * seq;

  if (tid == 0) {
    s_any = 0;
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);           // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  for (int s = k0 + tid; s < min(k0 + kDkvKeys, seq); s += kDkvThreads)
    if (mask[s] != 0) s_any = 1;       // benign race: every writer stores 1
  __syncthreads();
  if (!s_any) {     // no real key here: no query attends to this tile
    for (int i = tid; i < kDkvKeys * 16; i += kDkvThreads) {
      const int row = k0 + i / 16;
      if (row < seq) {
        const int c = (i % 16) * 8;
        *reinterpret_cast<uint4*>(p.dk + b * p.dk_sb + row * p.dk_st +
                                  hk * p.dk_sh + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(p.dv + b * p.dv_sb + row * p.dv_st +
                                  hk * p.dv_sh + c) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  // iterations: every 64-query tile at or after this key tile, for each of
  // the G query heads of this kv head, in a fixed order
  const int nq = (seq + kDkvRows - 1) / kDkvRows - k0 / kDkvRows;
  const int total = group * nq;
  if (warp < 4) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * kKvTile);
      tma_load_4d(smem, &tm_k, kv_full, 0, hk, k0, b);
      tma_load_4d(smem + kKvPanel, &tm_k, kv_full, kPanelCols, hk, k0, b);
      tma_load_4d(smem + kSmemV, &tm_v, kv_full, 0, hk, k0, b);
      tma_load_4d(smem + kSmemV + kKvPanel, &tm_v, kv_full, kPanelCols, hk,
                  k0, b);
      for (int it = 0; it < total; ++it) {
        const int s = it % kDkvStages;
        if (it >= kDkvStages) mbar_wait(empty + s, (it / kDkvStages - 1) & 1);
        const int h = hk * group + it / nq;
        const int q0 = (k0 / kDkvRows + it % nq) * kDkvRows;
        mbar_expect_tx(full + s, 2 * kQTile + 2 * kStatBytes);
        unsigned char* dst_q = smem + kSmemQ + s * kQTile;
        unsigned char* ddo = smem + kSmemDO + s * kQTile;
        tma_load_4d(dst_q, &tm_q, full + s, 0, h, q0, b);
        tma_load_4d(dst_q + kQPanel, &tm_q, full + s, kPanelCols, h, q0, b);
        tma_load_4d(ddo, &tm_do, full + s, 0, h, q0, b);
        tma_load_4d(ddo + kQPanel, &tm_do, full + s, kPanelCols, h, q0, b);
        // lse and di rows of (b, h): a box running past T reads the next
        // row's values (or zeros at the end), which the mask never uses
        const int at = (b * p.hq + h) * seq + q0;
        tma_load_1d(smem + kSmemL + s * kStatBytes, &tm_lse, full + s, at);
        tma_load_1d(smem + kSmemD + s * kStatBytes, &tm_di, full + s, at);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    dkv_consume(p, smem, bar, k0, nq, total, b, hk);
  }
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

// The dkv kernel: tensor maps of q, k, v and dout (128-byte swizzled boxes of
// 64 or 128 rows) and of lse and di (boxes of 64 f32), then one block per
// (128-key tile, kv head, batch row).
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               void* dk, void* dv, const void* mask, const void* lse,
               const void* di, const long long* st, int batch, int seq,
               int hq, int hkv, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_di;
  const long long n_stat = static_cast<long long>(batch) * hq * seq;
  int rc = bthd_map(&tm_q, q, batch, seq, hq, st[0], st[1], st[2], kDkvRows);
  if (rc == 0)
    rc = bthd_map(&tm_k, k, batch, seq, hkv, st[3], st[4], st[5], kDkvKeys);
  if (rc == 0)
    rc = bthd_map(&tm_v, v, batch, seq, hkv, st[6], st[7], st[8], kDkvKeys);
  if (rc == 0)
    rc = bthd_map(&tm_do, dout, batch, seq, hq, st[9], st[10], st[11],
                  kDkvRows);
  if (rc == 0) rc = f32_map(&tm_lse, lse, n_stat, kDkvRows);
  if (rc == 0) rc = f32_map(&tm_di, di, n_stat, kDkvRows);
  if (rc != 0) return rc;
  DkvParams p;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.mask = static_cast<const int32_t*>(mask);
  p.dk_sb = st[15]; p.dk_st = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_st = st[19]; p.dv_sh = st[20];
  p.seq = seq;
  p.hq = hq;
  p.group = hq / hkv;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaError_t err = ensure_smem(flash_bwd_dkv_kernel, kDkvSmem, dkv_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(hkv), static_cast<unsigned>(batch),
                  static_cast<unsigned>((seq + kDkvKeys - 1) / kDkvKeys));
  flash_bwd_dkv_kernel<<<grid, kDkvThreads, kDkvSmem, stream>>>(
      p, tm_q, tm_k, tm_v, tm_do, tm_lse, tm_di);
  return static_cast<int>(cudaGetLastError());
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
    const int err = launch_dkv(q, k, v, dout, dk, dv, mask, lse, di, strides,
                               batch, seq, hq, hkv, scale, s);
    if (err != 0) return err;
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
  return error_string(code);
}

}  // extern "C"
