// Hopper (sm_90a) building blocks of the flash-attention kernels (the
// forward in flash_attn.cu, dq and dkv in flash_attn_bwd.cu): mbarriers, TMA
// tile loads from a CUtensorMap, wgmma shared-memory descriptors for the
// 128-byte swizzle, warpgroup MMA (wgmma.mma_async), setmaxnreg, the work
// items and key-mask flags of the two query-tile kernels (forward, dq); and,
// on the host, the tensor maps, encoded at each launch through the
// runtime's driver entry point (so nothing links -lcuda).
//
// Tiles in shared memory. A tile of R rows x 128 bf16 dims is two panels of
// R x 64 dims, each filled by one TMA box {64 dims, 1 head, R rows, 1 batch}
// with the 128-byte swizzle: row r of a panel lies at r * 128 bytes, its
// 16-byte chunk c at chunk c ^ (r % 8). Panels start on 1024-byte
// boundaries, so the swizzle the TMA writes is the one wgmma reads. Rows
// past the tensor's end are zero-filled by the TMA.
//   * K-major operand (rows are M or N, dims are K): the k-step kk (16 dims)
//     starts in panel kk / 4 at (kk % 4) * 32 bytes; 8-row groups lie 1024
//     bytes apart (the descriptor's stride offset).
//   * MN-major operand (rows are K, dims are N; tnspB = 1): the k-step kk
//     (16 rows) starts kk * 2048 bytes into the first panel; 8-row groups
//     lie 1024 bytes apart (the stride offset) and the 64-dim panels one
//     panel apart (the leading offset), so a wgmma of N = 128 reads both.
//
// Register layouts (per warpgroup of 128 threads; warp w, lane l, g = l / 4,
// tig = l % 4). The accumulator of a 64 x N product holds, for each 8-column
// chunk j, d[4j], d[4j+1] at (row 16w + g, columns 8j + 2 tig, +1) and
// d[4j+2], d[4j+3] at row 16w + g + 8. A register A operand of a k16 step
// is four bf16 pairs, laid out as mma.sync m16n8k16's A fragment for the
// warp's 16 rows; packing the accumulator chunks 2kk and 2kk + 1 of one
// product gives exactly the A operand of k-step kk of the next
// (a_operand below), so P and dS never leave registers.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace hopper {

constexpr int kPanelCols = 64;           // bf16 dims per 128-byte row
constexpr int kMapError = 1000;          // + CUresult: tensor map refused

// ---- device: barriers, TMA, wgmma --------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that lasts
// ~10 s of SM clock (a lost arrival) traps, so a fault ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: one box of a 4-D map (coordinates innermost first) into shared
// memory, completing `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand starting at `p`: leading
// offset `lbo` bytes (K-major: unused, kLboK; MN-major: the panel stride),
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  uint64_t d = (saddr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}
constexpr uint32_t kLboK = 16;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barriers (ids 1-15; 0 is __syncthreads) between warpgroups:
// `threads` counts every thread that syncs or arrives on one use.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the A operand of k-step kk (16 columns) from a 64 x N f32 accumulator,
// rounded to bf16
template <int NF>
__device__ __forceinline__ void a_operand(uint32_t (&a)[4],
                                          const float (&d)[NF], int kk) {
  a[0] = flash::pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = flash::pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = flash::pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = flash::pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d[64 x 128] (+)= A B with A and B in shared memory (descriptors), both
// K-major. scale_d = 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] (+)= A B with A and B in shared memory (descriptors), both
// K-major. scale_d = 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] (+)= A B with A in registers (see the note above) and B in
// shared memory, MN-major (tnspB = 1), across two 64-dim panels.
__device__ __forceinline__ void wgmma_m64n128k16_rs_tn(float* d,
                                                       const uint32_t* a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- device: work items and key-mask flags of the query-tile kernels ----
//
// The forward and dq kernels are persistent: one block per SM walks the
// work items i = blockIdx.x, blockIdx.x + gridDim.x, ..., each a (128-query
// tile, q-head, batch row), heaviest causal tiles first, against 128-key
// tiles at or before the diagonal. Warps 1-3 of the producer warpgroup scan
// each item's key mask into one of two flag sets, while the consumers still
// work on the item before.

constexpr int kItemRows = 128;           // queries per item, keys per tile
constexpr int kItemPanel = kItemRows * 128;   // 128 rows x 64 dims: 16 KB
constexpr int kScanThreads = 96;         // warps 1-3 of warpgroup 0

struct Item {
  int h, b, q0, n_kt;                    // n_kt: causal key tiles
};

__device__ __forceinline__ Item item_at(int i, int seq, int hq, int batch) {
  const int per = hq * batch;
  const int n_qt = (seq + kItemRows - 1) / kItemRows;
  Item it;
  it.q0 = (n_qt - 1 - i / per) * kItemRows;
  it.b = (i % per) / hq;
  it.h = i % hq;
  it.n_kt = (min(it.q0 + kItemRows, seq) - 1) / kItemRows + 1;
  return it;
}

// one flag set: 4 mask words per key tile, then a live and a mixed byte
__host__ __device__ constexpr int flag_set_bytes(int n_tiles) {
  return (18 * n_tiles + 15) & ~15;
}

struct Flags {
  uint32_t* bits;          // real-key bits, 4 words per key tile
  unsigned char* live;     // the key tile holds a real key
  unsigned char* mixed;    // ... and a pad key
};

// flag set `set` (0 or 1) of the two that start at `sets`
__device__ __forceinline__ Flags flags_at(unsigned char* sets, int set,
                                          int seq) {
  const int n_tiles = (seq + kItemRows - 1) / kItemRows;
  unsigned char* base = sets + set * flag_set_bytes(n_tiles);
  Flags f;
  f.bits = reinterpret_cast<uint32_t*>(base);
  f.live = base + 16 * n_tiles;
  f.mixed = f.live + n_tiles;
  return f;
}

// The first live key tile at or after j (n_kt if none).
__device__ __forceinline__ int next_live(const unsigned char* live, int j,
                                         int n_kt) {
  while (j < n_kt && !live[j]) ++j;
  return j;
}

// Warps 1-3 of warpgroup 0: for each of the block's items, a word of
// real-key bits per 32 keys of the causal key range (4 words a pass a warp,
// their loads in flight together), and which key tiles are live (hold a
// real key) and mixed (hold a pad key too), into flag set c % 2 (the
// block's c-th item). f_full[set] takes one arrival per scanner thread,
// f_empty[set] is the consumers' and the producer's release. Every writer
// of a flag stores 1, so the races are benign.
__device__ __forceinline__ void scan_masks(const int32_t* mask, int seq,
                                           int hq, int batch, int n_items,
                                           unsigned char* sets,
                                           uint64_t* f_full,
                                           uint64_t* f_empty) {
  const int st = threadIdx.x - 32;
  const int sw = st / 32;
  const int lane = threadIdx.x & 31;
  constexpr int kScanWarps = kScanThreads / 32;
  for (int c = 0, i = blockIdx.x; i < n_items; ++c, i += gridDim.x) {
    const int set = c & 1;
    if (c >= 2) mbar_wait(f_empty + set, ((c >> 1) - 1) & 1);
    const Item item = item_at(i, seq, hq, batch);
    const Flags f = flags_at(sets, set, seq);
    const int q_last = min(item.q0 + kItemRows, seq) - 1;
    const int32_t* row = mask + static_cast<long long>(item.b) * seq;
    for (int j = st; j < item.n_kt; j += kScanThreads) {
      f.live[j] = 0;
      f.mixed[j] = 0;
    }
    named_sync(3, kScanThreads);
    const int n_words = 4 * item.n_kt;
    for (int base = sw; base < n_words; base += 4 * kScanWarps) {
      int32_t m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = (base + u * kScanWarps) * 32 + lane;
        m[u] = key <= q_last ? __ldg(row + key) : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int wd = base + u * kScanWarps;
        const bool in = wd * 32 + lane <= q_last;
        const unsigned rb = __ballot_sync(0xffffffffu, in && m[u] != 0);
        const unsigned pb = __ballot_sync(0xffffffffu, in && m[u] == 0);
        if (lane == 0 && wd < n_words) {
          f.bits[wd] = rb;
          if (rb) f.live[wd / 4] = 1;
          if (pb) f.mixed[wd / 4] = 1;
        }
      }
    }
    mbar_arrive(f_full + set);           // every scanner thread
  }
}

// S = Q K^T (or dP = dO V^T) for a warpgroup's 64 rows of a 128-row tile
// and one 128-key tile: 8 k-steps of 16 dims, both operands K-major in
// shared memory.
__device__ __forceinline__ void issue_qk(float (&sc)[64],
                                         const unsigned char* sQ,
                                         const unsigned char* sK) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int off = (kk >> 2) * kItemPanel + (kk & 3) * 32;
    wgmma_m64n128k16_ss(sc, sw128_desc(sQ + off, kLboK),
                        sw128_desc(sK + off, kLboK), kk > 0);
  }
}

// O += P V (or dQ += dS K): P in registers (bf16, 8 k-steps of 16 keys),
// the 128-key tile an MN-major B operand across both 64-dim panels.
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[8][4],
                                         const unsigned char* sV) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n128k16_rs_tn(o, pa[kk], sw128_desc(sV + kk * 2048, kItemPanel),
                           1);
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, looked up once
// (thread-safe static initialisation); null if the driver has none
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Map of a bf16 [batch, seq, heads, 128] tensor with element strides
// (sb, st, sh) and unit last stride, as {128, heads, seq, batch}; a box is
// {64, 1, box_rows, 1} with the 128-byte swizzle. Returns 0 or
// kMapError + the driver's code.
inline int bthd_map(CUtensorMap* map, const void* base, int batch, int seq,
                    int heads, long long sb, long long st, long long sh,
                    int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  // a dimension of extent 1 is only ever read at 0: any legal stride does
  auto bytes = [](long long s, int n) -> cuuint64_t {
    return n > 1 ? static_cast<cuuint64_t>(s) * 2 : 256;
  };
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(st, seq),
                                 bytes(sb, batch)};
  const cuuint32_t box[4] = {kPanelCols, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(rc);
}

// Map of `n` contiguous f32 values, boxes of `box` values, no swizzle; a
// box that runs past n is zero-filled there.
inline int f32_map(CUtensorMap* map, const void* base, long long n, int box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};     // rank 1: none is read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(rc);
}

// The current device's number of SMs (the grid of a persistent kernel),
// looked up once per device; threads racing here store the same value.
inline cudaError_t device_sms(int* sms) {
  static int count[flash::kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= flash::kMaxDevices)
    return cudaErrorInvalidDevice;
  if (count[device] == 0) {
    err = cudaDeviceGetAttribute(&count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = count[device];
  return cudaSuccess;
}

// The message for a launcher's return code: a CUDA runtime error, or a
// tensor map the driver refused.
inline const char* error_string(int code) {
  if (code >= kMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (driver code = "
           "return code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
