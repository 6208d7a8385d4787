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
// both kernels sum in a fixed order and are deterministic, bit for bit.
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
// 0.3401 ms, against ~0.1 ms of bytes. Only wgmma reaches that rate. Both
// kernels are built from hopper_common.cuh: a producer warpgroup (setmaxnreg
// 24) whose thread 0 issues every TMA load on full/empty mbarriers, and two
// consumer warpgroups (setmaxnreg 240) that run wgmma on what has landed.
//
// dq, the forward's shape with the dq algebra:
//   * persistent: one block of three warpgroups (384 threads) per SM walks
//     the work items, each a (128-query tile, q head, batch row), heaviest
//     causal tiles first (hopper_common.cuh's item walk, shared with the
//     forward);
//   * producer: for each item, Q and dout (32 KB each) and the item's 128
//     lse and di values into one buffer, then the 128-key K and V tiles
//     (32 KB each) of every live key tile at or before the diagonal into a
//     ring of 2 stages. K and V have their own full and empty barriers: V is
//     freed once dP has landed, K only after dQ += dS K, which reads it a
//     second time. Q and dout are freed once the item's last S and dP have
//     landed, so the next item's load overlaps the last dQ product. Warps
//     1-3 of the producer warpgroup scan the next item's key mask
//     meanwhile, once per item;
//   * consumers, 64 query rows each: S = Q K^T and dP = dout V^T are 8
//     wgmma m64n128k16 each, both operands K-major in shared memory,
//     committed as two groups, so P = exp2(S * scale * log2(e) - lse *
//     log2(e)) (one FFMA and one ex2 a value; lse is per row) is formed
//     while dP is still on the tensor cores. The element mask runs only on
//     the diagonal tile and on tiles that mix real and pad keys. dS = P *
//     (dP - di), packed to bf16 in registers, is the A operand of dQ += dS
//     K, 8 wgmma m64n128k16 with K an MN-major B operand (the forward's
//     O += P V, K in V's place). dQ (64 f32 a thread) stays in registers
//     for the item and is written once, times scale;
//   * shared memory per block: Q, dout 64 KB + 2 x (K 32 KB + V 32 KB) +
//     lse and di 1 KB = 193 KB, plus 2 x 18 bytes per 128 keys of T for the
//     flag sets.
//
// dkv:
//   * one block of three warpgroups (384 threads) per (128-key tile, kv
//     head, batch row); the key-tile index is the grid's slowest dimension,
//     in order, so the heaviest tiles (early keys, most queries) start
//     first. A key tile with no real key writes zeros and stops;
//   * producer: K and V loaded once by TMA (32 KB each), then, for each of
//     the G query heads and each 64-query tile at or after the key tile, Q
//     and dout (16 KB each) and their 64 lse and di values through a ring of
//     2 stages; TMA zero-fills rows past T;
//   * consumers, 64 keys each: S^T = K Q^T and dP^T = V dout^T are 16 wgmma
//     m64n64k16 with both operands in shared memory, committed as two
//     groups so P^T is formed while dP^T is still on the tensor cores; P^T
//     and dS^T, rounded to bf16 in registers, are the register A operands
//     of dV += P^T dout and dK += dS^T Q (8 wgmma m64n128k16, dout and Q as
//     MN-major B operands). dK and dV stay in registers (64 f32 a thread
//     each) for the whole loop and are written once; a consumer skips the
//     query tile that lies wholly before its keys;
//   * shared memory per block: K, V 64 KB + 2 x (Q, dout 32 KB + 512 bytes
//     of lse and di) = 129 KB.
//
// Registers as `nvcc -Xptxas -v` reports them on the card (CUDA 12.8): both
// kernels 168 a thread at launch (384 threads), the consumers at up to 240
// after setmaxnreg and the producer warpgroup at 24. dq: 52 bytes of spill
// stores, all in the producer and scanner warps (none between its wgmmas in
// the SASS); dkv: 32 bytes, a few loop-invariant integers of the consumers
// (dK, dV, S^T and dP^T take 192 of the 240 registers) and the producer's.
//
// Measured by chip_flash_ab.py (PERF.md; NVIDIA H100 80GB HBM3, 700 W), at
// the synthetic training shape: dq 0.66-0.67 ms, 1.95-1.97x its bound (the
// mma.sync design it replaces: 1.25-1.27 ms), 0.68-0.70 ms on the training
// step's rows; dkv 0.91-0.93 ms, 2.0x its bound. What holds dq back is not
// measured apart: each tile's chain (S and dP, then P and dS, then dQ += dS
// K, which waits on dS) runs in order inside a warpgroup, with only the
// other warpgroup to fill the tensor cores; ping-pong of the two on named
// barriers gained nothing (0.667-0.669 against 0.663-0.668 ms), and forming
// P without the scale folded into one FFMA was 1.7% slower. dkv: S^T and
// dP^T are m64n64 products with both operands in shared memory, which need
// about the whole shared-memory bandwidth at the tensor-core rate.
//
// Contract (checked by the Python wrapper, ops/flash_attention.py): head_dim
// 128; every bf16 tensor has unit last stride, its other strides multiples
// of 8 elements and 16-byte aligned storage; hq % hkv == 0.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

// ---- dq: wgmma, TMA and warp specialisation, persistent --------------------

constexpr int kDqThreads = 384;                // producer + 2 consumers
constexpr int kDqStages = 2;                   // K/V ring
constexpr int kDqTile = 2 * kItemPanel;        // 128 rows x 128 dims: 32 KB
constexpr int kDqStat = kItemRows * 4;         // 128 f32 of lse or di
constexpr int kDqSmemDO = kDqTile;             // Q at 0
constexpr int kDqSmemK = 2 * kDqTile;
constexpr int kDqSmemV = kDqSmemK + kDqStages * kDqTile;
constexpr int kDqSmemL = kDqSmemV + kDqStages * kDqTile;   // lse, then di
constexpr int kDqSmemBar = kDqSmemL + 2 * kDqStat;
constexpr int kDqSmemFlags = kDqSmemBar + 128;   // 14 barriers, 2 flag sets

struct DqParams {
  __nv_bfloat16* dq;
  const int32_t* mask;
  long long dq_sb, dq_st, dq_sh;
  int seq, hq, batch, group, n_items;
  float scale, scale_log2;
};

// The dq block's barriers: the Q/dout buffer, the K and V rings, the flag
// sets.
struct DqBars {
  uint64_t *q_full, *q_empty, *k_full, *v_full, *k_empty, *v_empty;
  uint64_t *f_full, *f_empty;
};

__device__ __forceinline__ DqBars dq_bars_at(unsigned char* smem) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + kDqSmemBar);
  constexpr int S = kDqStages;
  return {b, b + 1, b + 2, b + 2 + S, b + 2 + 2 * S, b + 2 + 3 * S,
          b + 2 + 4 * S, b + 4 + 4 * S};
}

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

// A consumer warpgroup: 64 query rows of each of the block's items against
// every live key tile. `gt` counts the K/V tiles of the ring consumed so
// far, over all items.
__device__ __forceinline__ void dq_consume(const DqParams& p,
                                           unsigned char* smem,
                                           const DqBars& bar) {
  const int tid = threadIdx.x;
  const int wg = tid / 128 - 1;          // rows 64 wg .. 64 wg + 63
  const int w = (tid / 32) & 3;
  const int lane = tid & 31;
  const int tig = lane & 3;
  const int r_a = 64 * wg + 16 * w + (lane >> 2);   // row in the item
  const unsigned char* sQ = smem + wg * 64 * 128;
  const unsigned char* sDO = smem + kDqSmemDO + wg * 64 * 128;
  const float* sL = reinterpret_cast<const float*>(smem + kDqSmemL);
  const float* sD = sL + kItemRows;
  int gt = 0;
  for (int c = 0, i = blockIdx.x; i < p.n_items; ++c, i += gridDim.x) {
    const int set = c & 1;
    const Item item = item_at(i, p.seq, p.hq, p.batch);
    const int n_kt = item.n_kt;
    const int row_a = item.q0 + r_a;
    const int row_b = row_a + 8;
    mbar_wait(bar.f_full + set, (c >> 1) & 1);
    const Flags f = flags_at(smem + kDqSmemFlags, set, p.seq);
    int n_live = 0;
    for (int j = 0; j < n_kt; ++j) n_live += f.live[j];

    mbar_wait(bar.q_full, c & 1);      // also where no tile is live
    // -lse in the exp2 domain (-inf where no key is admissible: P = 0)
    const float nl_a = -sL[r_a] * kLog2e;
    const float nl_b = -sL[r_a + 8] * kLog2e;
    const float di_a = sD[r_a];
    const float di_b = sD[r_a + 8];
    float dq[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) dq[k] = 0.0f;
    if (n_live == 0 && lane == 0) mbar_arrive(bar.q_empty);

    int j = -1;
    for (int it = 0; it < n_live; ++it, ++gt) {
      j = next_live(f.live, j + 1, n_kt);
      const int s = gt % kDqStages;
      const unsigned ph = (gt / kDqStages) & 1;
      const unsigned char* sK = smem + kDqSmemK + s * kDqTile;
      const unsigned char* sV = smem + kDqSmemV + s * kDqTile;

      // S = Q K^T and dP = dO V^T, committed apart, so that P is formed
      // while dP is still on the tensor cores (both waits come before the
      // fence: a wait between the two would make ptxas fence again)
      float sc[64], dp[64];
      mbar_wait(bar.k_full + s, ph);
      mbar_wait(bar.v_full + s, ph);
      wgmma_fence();
      issue_qk(sc, sQ, sK);
      wgmma_commit();
      issue_qk(dp, sDO, sV);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P = exp2(S * scale * log2(e) - lse * log2(e)) under the key mask
      // (the diagonal tile, and tiles that mix real and pad keys)
      if (f.mixed[j] || j == n_kt - 1) {
        uint32_t wd[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) wd[u] = f.bits[4 * j + u];
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * tig + (e & 1);
            const int key = j * kItemRows + col;
            const bool ok = key <= (e < 2 ? row_a : row_b) &&
                            ((wd[n >> 2] >> (col & 31)) & 1u);
            const float x = fmaf(sc[4 * n + e], p.scale_log2,
                                 e < 2 ? nl_a : nl_b);
            sc[4 * n + e] = fast_exp2(ok ? x : -INFINITY);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * n + e] = fast_exp2(fmaf(sc[4 * n + e], p.scale_log2,
                                           e < 2 ? nl_a : nl_b));
        }
      }

      // dS = P * (dP - di); V, and after the item's last tile Q and dO,
      // are no longer read
      wgmma_wait<0>();
      fence_regs(dp);
      if (lane == 0) {
        mbar_arrive(bar.v_empty + s);
        if (it == n_live - 1) mbar_arrive(bar.q_empty);
      }
      uint32_t da[8][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n + e] = sc[4 * n + e] *
                          (dp[4 * n + e] - (e < 2 ? di_a : di_b));
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) a_operand(da[kk], dp, kk);
      fence_regs(da);    // packed before the fence, not between the wgmmas

      // dQ += dS K: K an MN-major B operand, as V in the forward's O += P V
      wgmma_fence();
      issue_pv(dq, da, sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      if (lane == 0) mbar_arrive(bar.k_empty + s);
    }
    if (lane == 0) mbar_arrive(bar.f_empty + set);
    store_wg_rows(p.dq + item.b * p.dq_sb + item.h * p.dq_sh, p.dq_st,
                  item.q0 + 64 * wg, p.seq, dq, p.scale);
  }
}

// Thread 0: for each of the block's items, Q, dO, lse and di into their
// buffer once the consumers are done with the item before, then K and V of
// each live key tile into the ring. K and V of one tile share a stage but
// not its barriers: V is freed once dP has landed, K once dQ += dS K has.
__device__ __forceinline__ void dq_produce(
    const DqParams& p, unsigned char* smem, const DqBars& bar,
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const CUtensorMap* tm_lse,
    const CUtensorMap* tm_di) {
  int gt = 0;
  for (int c = 0, i = blockIdx.x; i < p.n_items; ++c, i += gridDim.x) {
    const int set = c & 1;
    const Item item = item_at(i, p.seq, p.hq, p.batch);
    const int hk = item.h / p.group;
    if (c >= 1) mbar_wait(bar.q_empty, (c - 1) & 1);
    mbar_expect_tx(bar.q_full, 2 * kDqTile + 2 * kDqStat);
    tma_load_4d(smem, tm_q, bar.q_full, 0, item.h, item.q0, item.b);
    tma_load_4d(smem + kItemPanel, tm_q, bar.q_full, kPanelCols, item.h,
                item.q0, item.b);
    tma_load_4d(smem + kDqSmemDO, tm_do, bar.q_full, 0, item.h, item.q0,
                item.b);
    tma_load_4d(smem + kDqSmemDO + kItemPanel, tm_do, bar.q_full, kPanelCols,
                item.h, item.q0, item.b);
    // lse and di rows of (b, h): a box running past T reads the next row's
    // values (or zeros at the end), which only rows past T use, and those
    // are never written
    const int at = (item.b * p.hq + item.h) * p.seq + item.q0;
    tma_load_1d(smem + kDqSmemL, tm_lse, bar.q_full, at);
    tma_load_1d(smem + kDqSmemL + kDqStat, tm_di, bar.q_full, at);
    mbar_wait(bar.f_full + set, (c >> 1) & 1);
    const Flags f = flags_at(smem + kDqSmemFlags, set, p.seq);
    for (int j = 0; j < item.n_kt; ++j) {
      if (!f.live[j]) continue;
      const int s = gt % kDqStages;
      const unsigned parity = (gt / kDqStages - 1) & 1;
      unsigned char* dk = smem + kDqSmemK + s * kDqTile;
      unsigned char* dv = smem + kDqSmemV + s * kDqTile;
      if (gt >= kDqStages) mbar_wait(bar.k_empty + s, parity);
      mbar_expect_tx(bar.k_full + s, kDqTile);
      tma_load_4d(dk, tm_k, bar.k_full + s, 0, hk, j * kItemRows, item.b);
      tma_load_4d(dk + kItemPanel, tm_k, bar.k_full + s, kPanelCols, hk,
                  j * kItemRows, item.b);
      if (gt >= kDqStages) mbar_wait(bar.v_empty + s, parity);
      mbar_expect_tx(bar.v_full + s, kDqTile);
      tma_load_4d(dv, tm_v, bar.v_full + s, 0, hk, j * kItemRows, item.b);
      tma_load_4d(dv + kItemPanel, tm_v, bar.v_full + s, kPanelCols, hk,
                  j * kItemRows, item.b);
      ++gt;
    }
    mbar_arrive(bar.f_empty + set);      // done reading this flag set
  }
}

// Persistent: one block per SM walks the work items i = blockIdx.x,
// blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ DqParams p,
                    const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_di) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte tiles
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const DqBars bar = dq_bars_at(smem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar.q_full, 1);
    mbar_init(bar.q_empty, 8);           // one arrival per consumer warp
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar.k_full + s, 1);
      mbar_init(bar.v_full + s, 1);
      mbar_init(bar.k_empty + s, 8);
      mbar_init(bar.v_empty + s, 8);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(bar.f_full + k, kScanThreads);
      mbar_init(bar.f_empty + k, 8 + 1); // consumer warps and the producer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    setmaxnreg_dec<24>();
    if (tid == 0)
      dq_produce(p, smem, bar, &tm_q, &tm_k, &tm_v, &tm_do, &tm_lse, &tm_di);
    else if (tid >= 32)
      scan_masks(p.mask, p.seq, p.hq, p.batch, p.n_items,
                 smem + kDqSmemFlags, bar.f_full, bar.f_empty);
  } else {
    setmaxnreg_inc<240>();
    dq_consume(p, smem, bar);
  }
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

// The dq kernel: tensor maps of q and dout (128-row boxes), k and v
// (128-row boxes) and of lse and di (boxes of 128 f32), then one persistent
// block per SM, or one per item where there are fewer items.
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              void* dq, const void* mask, const void* lse, const void* di,
              const long long* st, int batch, int seq, int hq, int hkv,
              float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_di;
  const long long n_stat = static_cast<long long>(batch) * hq * seq;
  int rc = bthd_map(&tm_q, q, batch, seq, hq, st[0], st[1], st[2], kItemRows);
  if (rc == 0)
    rc = bthd_map(&tm_k, k, batch, seq, hkv, st[3], st[4], st[5], kItemRows);
  if (rc == 0)
    rc = bthd_map(&tm_v, v, batch, seq, hkv, st[6], st[7], st[8], kItemRows);
  if (rc == 0)
    rc = bthd_map(&tm_do, dout, batch, seq, hq, st[9], st[10], st[11],
                  kItemRows);
  if (rc == 0) rc = f32_map(&tm_lse, lse, n_stat, kItemRows);
  if (rc == 0) rc = f32_map(&tm_di, di, n_stat, kItemRows);
  if (rc != 0) return rc;
  DqParams p;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.mask = static_cast<const int32_t*>(mask);
  p.dq_sb = st[12]; p.dq_st = st[13]; p.dq_sh = st[14];
  p.seq = seq;
  p.hq = hq;
  p.batch = batch;
  p.group = hq / hkv;
  p.n_items = hq * batch * ((seq + kItemRows - 1) / kItemRows);
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 1024 + kDqSmemFlags +
                   2 * flag_set_bytes((seq + kItemRows - 1) / kItemRows);
  err = ensure_smem(flash_bwd_dq_kernel, smem, dq_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.n_items < sms ? p.n_items : sms;
  flash_bwd_dq_kernel<<<grid, kDqThreads, smem, stream>>>(
      p, tm_q, tm_k, tm_v, tm_do, tm_lse, tm_di);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk != nullptr && dv != nullptr) {
    const int err = launch_dkv(q, k, v, dout, dk, dv, mask, lse, di, strides,
                               batch, seq, hq, hkv, scale, s);
    if (err != 0) return err;
  }
  if (dq != nullptr) {
    const int err = launch_dq(q, k, v, dout, dq, mask, lse, di, strides,
                              batch, seq, hq, hkv, scale, s);
    if (err != 0) return err;
  }
  return 0;
}

const char* flash_attn_bwd_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
