// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the forward of the stock Pallas TPU kernel that
// mllm_sparse_retrieval_tpu/models/layers.py:199 (flash_causal_attention)
// calls: jax/experimental/pallas/ops/tpu/flash_attention.py:331
// (_flash_attention_kernel, pallas_call :758; jax 0.9.0). It computes
//
//   out[b, t, h] = sum_s softmax_s(scale * q[b,t,h] . k[b,s,h/G]) v[b,s,h/G]
//
// over the admissible keys: s <= t with mask[b, s] != 0 (G = Hq / Hkv,
// native GQA: no K/V head is repeated). This is the JAX package's
// `attention` + `causal_padding_mask`: a pad query attends to every real
// key at or before it. A query with no admissible key (an all-pad row, or a
// position before the first real token) gets an output of 0 and a
// log-sum-exp of +inf, so that the backward kernels (flash_attn_bwd.cu)
// recompute P = 0 there. Inputs and output are bf16 in the [B, T, H, 128]
// layout, read and written through their strides; products accumulate in
// f32 and the softmax is f32.
//
// Optional output: lse[b, h, t] = log sum_s exp(scale * q . k_s) in f32,
// natural base, over the admissible keys (+inf where there is none); a null
// pointer writes none (serving).
//
// What bounds it on an H100: operations. A served call (B=8, T=3,072, 32
// q-heads; seven rows of 1,795-2,971 real tokens and one all-pad row) does
// ~5.0e11 FLOP of tensor-core work on ~0.5 GB of q/k/v/out: 0.505 ms at
// 989 TFLOP/s against ~0.15 ms of bytes. Only wgmma reaches that rate.
//
// The design (hopper_common.cuh holds the building blocks):
//   * persistent: one block of three warpgroups (384 threads) per SM walks
//     the work items, each a (128-query tile, q-head, batch row), heaviest
//     causal tiles first; item i goes to block i % gridDim.x;
//   * warpgroup 0 gives its registers away (setmaxnreg 24). Its thread 0
//     is the producer: for each item it loads Q (32 KB) by TMA into one of
//     two Q buffers, then the 128-key K and V tiles (32 KB each) of every
//     live key tile into a ring of 2 stages. K and V have their own full
//     and empty mbarriers: K is freed as soon as S has landed, V once
//     O += P V has. TMA zero-fills rows past T. Its warps 1-3 scan the
//     next item's mask meanwhile (two flag sets on mbarriers);
//   * warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows
//     each: S = Q K^T is 8 wgmma m64n128k16 with both operands in shared
//     memory (K-major, 128-byte swizzle); P, packed to bf16 in registers,
//     is the register A operand of O += P V, 8 wgmma m64n128k16 with V an
//     MN-major (transposed) B operand. O (64 f32 a thread) stays in
//     registers for the item;
//   * the consumer loop is software-pipelined: S of tile j is issued with
//     O += P V of tile j - 1, and the online softmax of tile j (exp2 form;
//     for a positive scale, scale * log2(e) folded into one FFMA a value)
//     runs while that product is on the tensor cores. The two
//     consumers take turns to issue (ping-pong on named barriers 1 and 2),
//     so one's softmax overlaps the other's products;
//   * tile skip: key tiles above the diagonal are never loaded, key tiles
//     holding no real key are skipped by producer and consumers alike, and
//     the element mask runs only on the diagonal tile and on tiles that mix
//     real and pad keys, from a bitmask of the row's mask in shared memory;
//   * shared memory per block: 2 Q buffers 64 KB + 2 x (K 32 KB + V 32 KB)
//     = 192 KB, plus 2 x 18 bytes per 128 keys of T for the flag sets.
// Registers as `nvcc -Xptxas -v` reports them on the card (CUDA 12.8):
// 168 a thread at launch (384 threads); after setmaxnreg the consumers run
// at up to 240 with no spill, and the 52 bytes of spill stores (68 of
// loads, a 40-byte frame) fall in the producer and scanner warps at 24.
// Measured by chip_smoke.py (see PERF.md): 1.00 ms at the served shape,
// 1.98x the bound. What holds the rest back is not measured apart: the
// suspects are the ex2 work beside the products and each tile's chain of
// products and softmax, with only two consumer warpgroups to overlap it.
//
// Contract (checked by the Python wrapper, ops/flash_attention.py): head_dim
// 128; q/k/v/out bf16 with unit last stride, every other stride a multiple
// of 8 elements and 16-byte aligned storage (what a TMA map needs); mask
// int32 [batch, seq] contiguous; lse f32 [batch, hq, seq] contiguous or
// null; hq % hkv == 0.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kBM = 128;                      // queries per block
constexpr int kBN = 128;                      // keys per tile
constexpr int kStages = 2;                    // K/V ring
constexpr int kThreadsFwd = 384;              // producer + 2 consumers
constexpr int kPanelBytes = kBN * 128;        // 128 rows x 64 dims: 16 KB
constexpr int kTileBytes = 2 * kPanelBytes;   // 128 rows x 128 dims: 32 KB
constexpr int kQBufs = 2;                     // Q of this item and the next
constexpr int kSmemK = kQBufs * kTileBytes;   // Q buffers at 0
constexpr int kSmemV = kSmemK + kStages * kTileBytes;
constexpr int kSmemBar = kSmemV + kStages * kTileBytes;
constexpr int kSmemFlags = kSmemBar + 256;    // 16 barriers, then 2 flag sets
static_assert(kBM == kBN && kBM == kItemRows,
              "Q and K/V tiles share one panel layout and the item walk");

struct Params {
  __nv_bfloat16* o;
  const int32_t* mask;
  float* lse;
  long long o_sb, o_st, o_sh;
  int seq, hq, batch, group, n_items;
  float scale_log2;
};

// The block's barriers: Q buffers, the K and V rings, the flag sets.
struct Bars {
  uint64_t *q_full, *q_empty, *k_full, *v_full, *k_empty, *v_empty;
  uint64_t *f_full, *f_empty;
};

__device__ __forceinline__ Bars bars_at(unsigned char* smem) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + kSmemBar);
  return {b, b + kQBufs, b + 2 * kQBufs, b + 2 * kQBufs + kStages,
          b + 2 * kQBufs + 2 * kStages, b + 2 * kQBufs + 3 * kStages,
          b + 2 * kQBufs + 4 * kStages, b + 2 * kQBufs + 4 * kStages + 2};
}

// One step of the online softmax on key tile j, under the key mask where
// the tile needs it (the diagonal tile, and tiles that mix real and pad
// keys): then sc holds P (f32, unnormalised, in the exp2 domain), m_r (the
// running max of scale * log2(e) * S) and l_r have moved on, and alpha_r is
// the factor O must be rescaled by. A row's 128 values live in one quad of
// threads. kPos (scale > 0): the max is taken on the raw S and each P is
// one FFMA and one ex2 (2-3% faster on an H100); otherwise S is scaled
// first.
template <bool kPos>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[64], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
    const uint32_t* bits, bool need_mask, int j, int row_a, int row_b,
    int tig, float scale_log2) {
  if (need_mask) {
    uint32_t wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wd[i] = bits[4 * j + i];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tig + (e & 1);
        const int key = j * kBN + col;
        const bool ok = key <= (e < 2 ? row_a : row_b) &&
                        ((wd[n >> 2] >> (col & 31)) & 1u);
        const float x = kPos ? sc[4 * n + e] : sc[4 * n + e] * scale_log2;
        sc[4 * n + e] = ok ? x : -INFINITY;
      }
    }
  } else if (!kPos) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[r], kPos ? mx * scale_log2 : mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;   // no key yet
    alpha[r] = fast_exp2(m_r[r] - m_use);
    m_r[r] = m_new;
    float rs = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * n + 2 * r + c];
        x = fast_exp2(kPos ? fmaf(x, scale_log2, -m_use) : x - m_use);
        rs += x;
      }
    }
    l_r[r] = l_r[r] * alpha[r] + rs;   // this thread's share; summed at the end
  }
}

// A consumer warpgroup: 64 query rows of each of the block's items against
// every live key tile. The loop is software-pipelined: S of tile j is
// issued together with O += P V of the tile before, and the softmax of
// tile j runs while that product is on the tensor cores. With ping-pong
// scheduling the two consumer warpgroups take turns to issue their
// products (named barriers 1 and 2), so one warpgroup's softmax overlaps
// the other's products. `gt` counts the K/V tiles of the ring consumed so
// far, over all items.
template <bool kPos>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem,
                                        const Bars& bar) {
  const int tid = threadIdx.x;
  const int wg = tid / 128 - 1;          // rows 64 wg .. 64 wg + 63
  const int w = (tid / 32) & 3;
  const int lane = tid & 31;
  const int tig = lane & 3;
  const int seq = p.seq;
  int gt = 0;
  for (int c = 0, i = blockIdx.x; i < p.n_items; ++c, i += gridDim.x) {
    const int set = c & 1;               // flag set and Q buffer
    const unsigned use = (c >> 1) & 1;
    const Item item = item_at(i, p.seq, p.hq, p.batch);
    const int n_kt = item.n_kt;
    const int row_a = item.q0 + 64 * wg + 16 * w + (lane >> 2);
    const int row_b = row_a + 8;
    mbar_wait(bar.f_full + set, use);
    const Flags f = flags_at(smem + kSmemFlags, set, seq);
    int n_live = 0;
    for (int j = 0; j < n_kt; ++j) n_live += f.live[j];

    float o[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) o[k] = 0.0f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.0f, 0.0f};
    mbar_wait(bar.q_full + set, use);   // also where no tile is live
    const unsigned char* sQ = smem + set * kTileBytes + wg * 64 * 128;

    int j = next_live(f.live, 0, n_kt);
    if (j < n_kt) {
      float sc[64], alpha[2];
      uint32_t pa[8][4];
      int s = gt % kStages;
      mbar_wait(bar.k_full + s, (gt / kStages) & 1);
      wgmma_fence();
      issue_qk(sc, sQ, smem + kSmemK + s * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(bar.k_empty + s);
      softmax_tile<kPos>(sc, m_r, l_r, alpha, f.bits,
                         f.mixed[j] || j == n_kt - 1, j, row_a, row_b, tig,
                         p.scale_log2);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) a_operand(pa[kk], sc, kk);
      if (wg == 1 && n_live > 1) named_arrive(1, 256);   // wg 0 first
      int prev = s;                      // the stage whose P is in pa
      for (int it = 1; it < n_live; ++it) {
        j = next_live(f.live, j + 1, n_kt);
        const int g = gt + it;
        s = g % kStages;
        mbar_wait(bar.k_full + s, (g / kStages) & 1);
        mbar_wait(bar.v_full + prev, ((g - 1) / kStages) & 1);
        named_sync(1 + wg, 256);         // this warpgroup's turn
        wgmma_fence();
        issue_qk(sc, sQ, smem + kSmemK + s * kTileBytes);
        wgmma_commit();
        issue_pv(o, pa, smem + kSmemV + prev * kTileBytes);
        wgmma_commit();
        if (wg == 0 || it + 1 < n_live)  // every sync has its arrival
          named_arrive(2 - wg, 256);     // the other warpgroup's turn
        wgmma_wait<1>();                 // S of tile j has landed
        fence_regs(sc);
        if (lane == 0) mbar_arrive(bar.k_empty + s);
        softmax_tile<kPos>(sc, m_r, l_r, alpha, f.bits,
                           f.mixed[j] || j == n_kt - 1, j, row_a, row_b,
                           tig, p.scale_log2);
        wgmma_wait<0>();                 // O += P V of the tile before
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(bar.v_empty + prev);
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          o[4 * d] *= alpha[0];
          o[4 * d + 1] *= alpha[0];
          o[4 * d + 2] *= alpha[1];
          o[4 * d + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) a_operand(pa[kk], sc, kk);
        prev = s;
      }
      mbar_wait(bar.v_full + prev, ((gt + n_live - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv(o, pa, smem + kSmemV + prev * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar.v_empty + prev);
      gt += n_live;
    }
    if (lane == 0) {                     // done with this Q and flag set
      mbar_arrive(bar.q_empty + set);
      mbar_arrive(bar.f_empty + set);
    }

    // normalise and write; a row with no admissible key has l = 0: it gets
    // 0 and a log-sum-exp of +inf
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      const int row = r == 0 ? row_a : row_b;
      if (row < seq) {
        __nv_bfloat16* dst = p.o + item.b * p.o_sb + row * p.o_st +
                             item.h * p.o_sh + tig * 2;
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          *reinterpret_cast<uint32_t*>(dst + d * 8) =
              pack_bf16(o[4 * d + 2 * r] * inv, o[4 * d + 2 * r + 1] * inv);
        }
        if (p.lse != nullptr && tig == 0) {
          p.lse[(static_cast<long long>(item.b) * p.hq + item.h) * seq +
                row] = l > 0.0f ? (m_r[r] + log2f(l)) * kLn2 : INFINITY;
        }
      }
    }
  }
}

// Thread 0: for each of the block's items, Q into its buffer, then K and V
// of each live key tile into the ring. K and V of one tile share a stage
// but not its barriers: K is freed once S has landed, V once O += P V has.
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem,
                                        const Bars& bar,
                                        const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v) {
  int gt = 0;
  for (int c = 0, i = blockIdx.x; i < p.n_items; ++c, i += gridDim.x) {
    const int set = c & 1;
    const Item item = item_at(i, p.seq, p.hq, p.batch);
    const int hk = item.h / p.group;
    mbar_wait(bar.f_full + set, (c >> 1) & 1);
    const Flags f = flags_at(smem + kSmemFlags, set, p.seq);
    if (c >= 2) mbar_wait(bar.q_empty + set, ((c >> 1) - 1) & 1);
    unsigned char* dq = smem + set * kTileBytes;
    mbar_expect_tx(bar.q_full + set, kTileBytes);
    tma_load_4d(dq, tm_q, bar.q_full + set, 0, item.h, item.q0, item.b);
    tma_load_4d(dq + kPanelBytes, tm_q, bar.q_full + set, kPanelCols, item.h,
                item.q0, item.b);
    for (int j = 0; j < item.n_kt; ++j) {
      if (!f.live[j]) continue;
      const int s = gt % kStages;
      const unsigned parity = (gt / kStages - 1) & 1;
      unsigned char* dk = smem + kSmemK + s * kTileBytes;
      unsigned char* dv = smem + kSmemV + s * kTileBytes;
      if (gt >= kStages) mbar_wait(bar.k_empty + s, parity);
      mbar_expect_tx(bar.k_full + s, kTileBytes);
      tma_load_4d(dk, tm_k, bar.k_full + s, 0, hk, j * kBN, item.b);
      tma_load_4d(dk + kPanelBytes, tm_k, bar.k_full + s, kPanelCols, hk,
                  j * kBN, item.b);
      if (gt >= kStages) mbar_wait(bar.v_empty + s, parity);
      mbar_expect_tx(bar.v_full + s, kTileBytes);
      tma_load_4d(dv, tm_v, bar.v_full + s, 0, hk, j * kBN, item.b);
      tma_load_4d(dv + kPanelBytes, tm_v, bar.v_full + s, kPanelCols, hk,
                  j * kBN, item.b);
      ++gt;
    }
    mbar_arrive(bar.f_empty + set);      // done reading this flag set
  }
}

// Persistent: one block per SM walks the work items i = blockIdx.x,
// blockIdx.x + gridDim.x, ... kPos: the softmax scale is positive.
template <bool kPos>
__global__ void __launch_bounds__(kThreadsFwd, 1)
flash_fwd_kernel(const __grid_constant__ Params p,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte tiles
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const Bars bar = bars_at(smem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int k = 0; k < kQBufs; ++k) {
      mbar_init(bar.q_full + k, 1);
      mbar_init(bar.q_empty + k, 8);     // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
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
    if (tid == 0) produce(p, smem, bar, &tm_q, &tm_k, &tm_v);
    else if (tid >= 32)
      scan_masks(p.mask, p.seq, p.hq, p.batch, p.n_items, smem + kSmemFlags,
                 bar.f_full, bar.f_empty);
  } else {
    setmaxnreg_inc<240>();
    consume<kPos>(p, smem, bar);
  }
}

int smem_set[2][kMaxDevices] = {};   // [kPos]

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
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = bthd_map(&tm_q, q, batch, seq, hq, q_sb, q_st, q_sh, kBM);
  if (rc == 0) rc = bthd_map(&tm_k, k, batch, seq, hkv, k_sb, k_st, k_sh, kBN);
  if (rc == 0) rc = bthd_map(&tm_v, v, batch, seq, hkv, v_sb, v_st, v_sh, kBN);
  if (rc != 0) return rc;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.mask = static_cast<const int32_t*>(mask);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.seq = seq;
  p.hq = hq;
  p.batch = batch;
  p.group = hq / hkv;
  p.n_items = hq * batch * ((seq + kBM - 1) / kBM);
  p.scale_log2 = scale * kLog2e;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 1024 + kSmemFlags +
                   2 * flag_set_bytes((seq + kBN - 1) / kBN);
  const int grid = p.n_items < sms ? p.n_items : sms;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale > 0.0f) {
    err = ensure_smem(flash_fwd_kernel<true>, smem, smem_set[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<true><<<grid, kThreadsFwd, smem, st>>>(p, tm_q, tm_k,
                                                             tm_v);
  } else {
    err = ensure_smem(flash_fwd_kernel<false>, smem, smem_set[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<false><<<grid, kThreadsFwd, smem, st>>>(p, tm_q, tm_k,
                                                              tm_v);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attn_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
