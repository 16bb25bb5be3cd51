// Flash attention kernels for Hopper (sm_90a), with a plain C interface.
//
// flash_fwd replaces paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel,
// flash_bwd_dq replaces :_bwd_dq_kernel and flash_bwd_dkv replaces
// :_bwd_dkv_kernel (all three driven by the custom VJP of _flash_bhsd).
//
// What bounds them on an H100: at the training path's shapes (b 4, s 1024,
// h 16, d 128, causal, bf16) the forward moves q, k, v and o once (67 MB,
// 20 us at 3.35 TB/s) and does 17 GFLOP of products (17 us at 989
// TFLOP/s), so bytes and tensor-core operations are about level; dq
// (3 products) and dk/dv (4 products) lean to operations.
//
// The Pallas grid runs its innermost axis in order and carries (acc, m,
// l) in VMEM scratch from one grid step to the next. On Hopper blocks run
// in no order, so a block owns its whole output tile and loops over the
// other axis itself; under `causal` the loop stops at the diagonal (the
// TPU kernel's `run` predicate). No output is summed across blocks: there
// are no atomics, and a result is the same on every run. q, k, v, o, do,
// dq, dk, dv are read and written in place through their strides ([b, s,
// h, d] with a contiguous last axis), so the q/k/v views that
// GPTAttention splits off its fused projection need no transpose or copy.
//
// bf16 forward (flash_fwd_wgmma_kernel). Its first version (mma.sync from
// operands built by scalar shared-memory reads, one K and one V buffer
// filled by the compute threads between two barriers, p through shared
// memory, 64 x 64 tiles) ran at 11 % of the bound. This one is built from
// the Hopper blocks of hopper.cuh:
//   - one block of two warpgroups per (b*h, 128 query rows), each
//     warpgroup 64 rows (wgmma's M); 256 threads, so a thread may hold up
//     to 255 registers (a third, producer warp would put three warps on one
//     SM sub-partition and cap every thread at 168, where the accumulators
//     spill);
//   - q, k and v come by TMA as 4-D tensor maps (head_dim, heads, seq,
//     batch) over their strides, 128-byte swizzled boxes of 64 x 128;
//     K and V of 128 keys go through a 2-stage ring with full/empty
//     mbarriers, refilled by one thread as soon as both warpgroups are
//     done with a stage, so the next tiles load while this one computes;
//   - S = q k^T and o += p v are wgmma.m64n128k16 (f32 accumulation); the
//     online softmax runs in S's accumulator registers and p stays in
//     registers as the A operand of p v (no shared-memory round trip);
//     the mask is applied on the last key tile only;
//   - blocks take the query tiles with the most key tiles first, so under
//     `causal` the heaviest blocks run in the first wave.
// Measured on the card, a 3-stage ring, a dedicated producer warp(group)
// and issuing the next tile's q k^T before this tile's softmax (an
// intra-warpgroup overlap) did not make it faster; see PERF.md.
//
// bf16 dq and dk/dv (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel).
// Their first version (the mma.sync tiles below) ran at 9-10 % of the
// bound. At the training path's shape dq does 3 products of the causal
// pairs (26 us at 989 TFLOP/s) and dk/dv 4 (35 us), against ~11 us of
// bytes each, so both are bound by tensor-core operations. They are built
// from the same Hopper blocks as the forward:
//   - a block of two warpgroups owns 128 rows (dq: query rows, taken
//     heaviest first; dk/dv: keys, the first key tiles first, which under
//     causal see the most query rows), loaded once by TMA, and walks the
//     other sequence in 64-row steps through a 2-stage ring of TMA loads,
//     refilled by thread 0 (128 KB of shared memory, one block an SM);
//   - dq: S = q k^T and dP = do v^T by SS wgmma (m64n64k16), ds formed in
//     S's accumulator registers, rounded to bf16 and paired into the A
//     fragment of dq += ds k (RS wgmma, k read MN-major);
//   - dk/dv: S^T = k q^T and dP^T = v do^T directly, so p^T and ds^T come
//     out in the accumulator layout and pair into A fragments with no
//     shared-memory round trip; dv += p^T do and dk += ds^T q by RS wgmma.
//     lse and delta are per column there: each warpgroup stages a step's
//     64 values of each in shared memory. The two 64 x 128 accumulators,
//     S^T, dP^T and the fragments fit 255 registers without spills;
//   - the mask runs only on the steps that hold the causal diagonal or the
//     ragged edge (TMA fills rows past the end with zeros: keys past seq_k
//     in dq and queries past seq_q in dk/dv are set to -1e30 there).
//
// f32 forward, dq and dk/dv (attention_tiles.cuh): a block of four warps
// owns 64 output rows (16 a warp); flash_fwd and flash_bwd_dq loop over
// 64-key tiles, flash_bwd_dkv owns 64 keys and loops over 32-row query
// tiles from the diagonal on. Tiles are staged in shared memory (16-byte
// loads, rows padded by 8 elements); the products are f32 FMAs in the
// mma.sync register layout (wgmma's tf32 would change f32 results, and
// f32 is the checking path). bsa_fwd's f32 kernel shares these tiles
// (block_sparse_attention.cu).
//
// head_dim: every kernel is a template on D, instantiated at 64 (BERT-base,
// ERNIE-3.0-base, ViT-B/16) and 128 (GPT-1.3B), as bsa_fwd is. At D 64 a
// 64-row tile is one 128-byte TMA box, the wgmma products whose N is the
// head (o += p v, dq += ds k, dv += p^T do, dk += ds^T q) are m64n64k16,
// each thread holds 32 accumulators a product instead of 64, and the
// shared memory a block needs halves (81 KB forward, 67 KB backward). The
// products over keys keep their widths, so a step does half the work of
// D 128 on the same tiles. At BERT's shape ([16, 512, 12, 64], not causal)
// the forward moves 50 MB (15 us at 3.35 TB/s) and does 12.9 GFLOP (13 us):
// level again; at ViT-B's ([128, 197, 12, 64], ragged: 197 = 128 + 69
// rows) bytes lead, and TMA fills the rows past 197 with zeros, which the
// masks of the last tile and the stores' row bounds keep out.
//
// Numerics follow the Pallas kernels: base-2 softmax with scale*log2(e)
// folded into the scores, masked scores set to -1e30 (not -inf), the
// causal mask top-left aligned (col <= row), l == 0 rows divided by 1,
// lse stored in natural log as m*ln2 + log(l) in f32 [b*h, s_q]; p is
// rounded to the value dtype before p@v and before p^T@do, ds to the
// input dtype before ds@k and ds^T@q. delta = rowsum(do*o) is an input
// of both backward kernels (ring attention passes delta - dlse).
//
// Every entry point launches on the stream it is given, does not
// synchronise, and returns cudaGetLastError().

#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockQi = 32;  // dk/dv: query rows a step

// Key tiles a query tile starting at q0 visits (the causal diagonal bound).
__device__ __forceinline__ int key_tiles(int q0, int seq_k, int causal) {
  int n = (seq_k + kBlockK - 1) / kBlockK;
  if (causal) n = min(n, (q0 + kBlockQ - 1) / kBlockK + 1);
  return n;
}

// ------------------------------------------------ bf16 forward on wgmma
constexpr int kWgRows = 128;                 // query rows a block owns
constexpr int kWgKeys = 128;                 // keys a step
constexpr int kWgStages = 2;                 // depth of the K/V ring
constexpr int kBox = 64;                     // head_dim values a TMA box row holds (128 B)
constexpr int kBoxBytes = kWgRows * kBox * 2;              // 16 KB
constexpr int kWgThreads = 256;              // two warpgroups of 64 query rows
// A 128-row tile of head_dim D: D / 64 boxes side by side (32 KB at D 128,
// one 16 KB box at D 64).
template <int D>
constexpr int kTileBytes = kWgRows * D * 2;
template <int D>
constexpr int kWgSmem = (1 + 2 * kWgStages) * kTileBytes<D> + 128 + 1024;  // + barriers, alignment

struct WgBarriers {
  uint64_t q;
  uint64_t full_k[kWgStages], full_v[kWgStages], empty_k[kWgStages], empty_v[kWgStages];
};

// Block (b*h, 128 query rows), heaviest causal tiles first
// (flash_attention.py:fwd_tile_order). Two warpgroups each own 64 query
// rows. Thread 0 loads the q tile once by TMA and keeps 128-key K and V
// tiles coming through a kWgStages-deep ring: K and V of a stage each
// have a "full" barrier (the TMA bytes landed) and an "empty" one (all 8
// warps are done with it); thread 0 refills a stage with the tile
// kWgStages ahead as soon as both warpgroups have released it, K right
// after S is formed, V after p v. Per key tile a warpgroup forms
// S = q k^T by wgmma from shared memory (q and k K-major), runs the online
// softmax in the accumulator registers (a thread holds rows row_a and
// row_a + 8, columns 8j + 2t + {0, 1}), rounds p to bf16 in registers and
// adds p v by wgmma with p as the register A operand (v MN-major, read
// through the transpose bit). At D 64 a tile is one box and o += p v is
// wgmma.m64n64k16 (32 accumulators a thread, not 64).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, Strides os,
                           int heads, int bh_count, int q_tiles, int seq_q, int seq_k, float sl2,
                           int causal) {
  constexpr int TB = kTileBytes<D>;
  constexpr int NA = D / 2;  // accumulator registers a thread: 64 x D over 128 threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = hopper::align_1024(smem_raw);
  unsigned char* sk = sq + TB;
  unsigned char* sv = sk + kWgStages * TB;
  WgBarriers& bar = *reinterpret_cast<WgBarriers*>(sv + kWgStages * TB);

  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * kWgRows;
  int nk = (seq_k + kWgKeys - 1) / kWgKeys;  // flash_attention.py:fwd_key_tiles
  if (causal) nk = min(nk, (q0 + kWgRows - 1) / kWgKeys + 1);

  // key tile kt's K (or V) into stage kt % kWgStages
  auto load_kv = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full, int kt) {
    const int s = kt % kWgStages;
    hopper::mbar_expect_tx(&full[s], TB);
    for (int x = 0; x < D / kBox; ++x)
      hopper::tma_load_4d(ring + s * TB + x * kBoxBytes, map, &full[s], x * kBox, h,
                          kt * kWgKeys, b);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar.q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&bar.full_k[s], 1);
      hopper::mbar_init(&bar.full_v[s], 1);
      hopper::mbar_init(&bar.empty_k[s], 8);
      hopper::mbar_init(&bar.empty_v[s], 8);
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bar.q, TB);
    for (int x = 0; x < D / kBox; ++x)
      hopper::tma_load_4d(sq + x * kBoxBytes, &qmap, &bar.q, x * kBox, h, q0, b);
    for (int kt = 0; kt < min(nk, kWgStages); ++kt) {
      load_kv(&kmap, sk, bar.full_k, kt);
      load_kv(&vmap, sv, bar.full_v, kt);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + warp * 16 + g;  // and row_a + 8
  const unsigned char* qw = sq + wg * 64 * 128;     // this warpgroup's 64 rows
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // this warp is done with key tile kt's K (or V): release it; thread 0
  // waits for the other warps' release and loads tile kt + kWgStages
  auto release = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full,
                     uint64_t* empty, int kt) {
    if (lane == 0) hopper::mbar_arrive(&empty[kt % kWgStages]);
    if (threadIdx.x == 0 && kt + kWgStages < nk) {
      hopper::mbar_wait(&empty[kt % kWgStages], (kt / kWgStages) & 1);
      load_kv(map, ring, full, kt + kWgStages);
    }
    __syncwarp();  // warp 0 reconverges before its next wgmma
  };
  // scores into log2 units, the running maximum m, p = exp2(s - m) in sc
  // and its row sums rs; `masked` (the last tile only) sets keys past
  // seq_k and, under causal, above the diagonal (col > row) to -1e30.
  // Returns in corr the factors that move acc and l to the new maximum.
  auto softmax = [&](float (&sc)[64], int k0, auto masked, float (&corr)[2], float (&rs)[2]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * sl2;
        if constexpr (decltype(masked)::value) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          if (col >= seq_k || (causal && col > row)) x = kNegInf;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      rs[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m[e >> 1]);
        rs[e >> 1] += sc[4 * j + e];
      }
    }
  };

  hopper::mbar_wait(&bar.q, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kWgStages;
    const uint32_t parity = (kt / kWgStages) & 1;
    float sc[64];
    hopper::mbar_wait(&bar.full_k[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hopper::wgmma_m64n128k16_ss(sc, hopper::smem_desc(qw + off, 16, 1024),
                                  hopper::smem_desc(sk + s * TB + off, 16, 1024),
                                  kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    release(&kmap, sk, bar.full_k, bar.empty_k, kt);

    float corr[2], rs[2];
    if (kt == nk - 1 && (causal || (kt + 1) * kWgKeys > seq_k))
      softmax(sc, kt * kWgKeys, std::true_type{}, corr, rs);
    else
      softmax(sc, kt * kWgKeys, std::false_type{}, corr, rs);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    uint32_t p[32];  // p as the A operand: 2j and 2j + 1 are rows row_a and row_a + 8
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      p[2 * j] = hopper::pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
      p[2 * j + 1] = hopper::pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
    }

    hopper::mbar_wait(&bar.full_v[s], parity);
    hopper::fence_regs(acc);
    hopper::fence_regs(p);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      const uint64_t desc = hopper::smem_desc(sv + s * TB + kk * 16 * 128, kBoxBytes, 1024);
      if constexpr (D == 128)
        hopper::wgmma_m64n128k16_rs_mn(acc, a, desc);
      else
        hopper::wgmma_m64n64k16_rs_mn(acc, a, desc);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(p);
    release(&vmap, sv, bar.full_v, bar.empty_v, kt);
  }

  // o = acc / l (l == 0: divided by 1), lse = m*ln2 + log(l)
  const float la = l[0] == 0.f ? 1.f : l[0];
  const float lb = l[1] == 0.f ? 1.f : l[1];
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_a < seq_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_a) * os.s + col) =
          hopper::pack_bf16x2(acc[4 * j] / la, acc[4 * j + 1] / la);
    if (row_a + 8 < seq_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_a + 8) * os.s + col) =
          hopper::pack_bf16x2(acc[4 * j + 2] / lb, acc[4 * j + 3] / lb);
  }
  if (t == 0) {
    float* lrow = lse + static_cast<long long>(bh) * seq_q;
    if (row_a < seq_q) lrow[row_a] = m[0] * kLn2 + logf(la);
    if (row_a + 8 < seq_q) lrow[row_a + 8] = m[1] * kLn2 + logf(lb);
  }
}

// ------------------------------------------- bf16 backward on wgmma
// Both kernels: a block of two warpgroups owns a 128-row tile (dq: query
// rows; dk/dv: keys), 64 rows a warpgroup, loaded once by TMA, and walks
// the other sequence in 64-row steps that come through a kBwStages-deep
// ring (one full and one empty barrier a stage, refilled by thread 0 once
// all 8 warps released it). Every TMA box is 64 head values (128 bytes,
// the swizzle width) by 64 rows (flash_attention.py:tma_geometry, rows
// 64); a 64-row tile is D / 64 boxes side by side (two at D 128, one at
// D 64), a 128-row one two such tiles, warpgroup 0's rows first.
constexpr int kBwOwn = 128;                               // rows a block owns
constexpr int kBwStep = 64;                               // rows a step
constexpr int kBwStages = 2;
constexpr int kBwBoxBytes = kBwStep * kBox * 2;           // 8 KB
template <int D>
constexpr int kBwStepBytes = kBwStep * D * 2;             // a 64-row tile: 16 KB at D 128
template <int D>
constexpr int kBwOwnBytes = kBwOwn * D * 2;               // 32 KB at D 128
template <int D>
constexpr int kBwSmem = 4 * kBwOwnBytes<D> + 2 * 2 * 2 * kBwStep * 4 + 128 + 1024;

struct BwBarriers {
  uint64_t own;                                   // the block's own two tiles
  uint64_t full[kBwStages], empty[kBwStages];     // the ring
};

// Rows [row0, row0 + 64) of head h, batch b: D / 64 boxes into dst.
template <int D>
__device__ __forceinline__ void tma_rows64(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int h, int row0, int b) {
  for (int x = 0; x < D / kBox; ++x)
    hopper::tma_load_4d(dst + x * kBwBoxBytes, map, bar, x * kBox, h, row0, b);
}

// acc (+)= A B^T over head_dim for two 64-row tiles, both K-major (rows of
// head values): A this warpgroup's rows, B a step's 64 rows.
template <int D>
__device__ __forceinline__ void wgmma_rows_dot(float (&acc)[32], const unsigned char* a,
                                               const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBwBoxBytes + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, hopper::smem_desc(a + off, 16, 1024),
                               hopper::smem_desc(b + off, 16, 1024), kk > 0);
  }
}

// acc += A B with A 64 x 64 in registers (pairs of the accumulator layout)
// and B a step's 64 rows of D head values, read MN-major.
template <int D>
__device__ __forceinline__ void wgmma_frag_rows(float (&acc)[D / 2], const uint32_t (&a)[16],
                                                const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kBwStep / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    const uint64_t desc = hopper::smem_desc(b + kk * 16 * 128, kBwBoxBytes, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs_mn(acc, ak, desc);
    else
      hopper::wgmma_m64n64k16_rs_mn(acc, ak, desc);
  }
}

// A 64 x D accumulator (rows row_a and row_a + 8 of this thread) to
// global rows below seq through the row stride.
template <int D>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* base, long long stride, int row_a,
                                               int seq, const float (&acc)[D / 2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_a < seq)
      *reinterpret_cast<uint32_t*>(base + static_cast<long long>(row_a) * stride + col) =
          hopper::pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    if (row_a + 8 < seq)
      *reinterpret_cast<uint32_t*>(base + static_cast<long long>(row_a + 8) * stride + col) =
          hopper::pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dq. Block (b*h, 128 query rows), heaviest causal tiles first
// (flash_attention.py:fwd_tile_order); its q and do tiles come once, K and
// V of 64 keys a step through the ring (flash_attention.py:dq_key_tiles).
// Per step a warpgroup forms S = q k^T and dP = do v^T by wgmma from
// shared memory, then in S's accumulator layout p = exp2(S*scale*log2e -
// lse*log2e) (keys past seq_k and, under causal, col > row set to -1e30 on
// the tiles that hold any) and ds = p (dP - delta) scale, rounds ds to
// bf16 in registers and adds ds k by wgmma (k read MN-major). lse and
// delta of the thread's two rows stay in registers.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, Strides dqs, int heads,
                              int bh_count, int q_tiles, int seq_q, int seq_k, float scale,
                              int causal) {
  constexpr int SB = kBwStepBytes<D>, OB = kBwOwnBytes<D>;
  constexpr int NA = D / 2;  // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = hopper::align_1024(smem_raw);
  unsigned char* sdo = sq + OB;
  unsigned char* sk = sdo + OB;
  unsigned char* sv = sk + kBwStages * SB;
  BwBarriers& bar = *reinterpret_cast<BwBarriers*>(sv + kBwStages * SB);

  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * kBwOwn;
  int nk = (seq_k + kBwStep - 1) / kBwStep;  // flash_attention.py:dq_key_tiles
  if (causal) nk = min(nk, (q0 + kBwOwn - 1) / kBwStep + 1);

  auto load_kv = [&](int kt) {
    const int s = kt % kBwStages;
    hopper::mbar_expect_tx(&bar.full[s], 2 * SB);
    tma_rows64<D>(sk + s * SB, &kmap, &bar.full[s], h, kt * kBwStep, b);
    tma_rows64<D>(sv + s * SB, &vmap, &bar.full[s], h, kt * kBwStep, b);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar.own, 1);
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(&bar.full[s], 1);
      hopper::mbar_init(&bar.empty[s], 8);
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bar.own, 2 * OB);
    for (int half = 0; half < 2; ++half) {
      tma_rows64<D>(sq + half * SB, &qmap, &bar.own, h, q0 + half * kBwStep, b);
      tma_rows64<D>(sdo + half * SB, &domap, &bar.own, h, q0 + half * kBwStep, b);
    }
    for (int kt = 0; kt < min(nk, kBwStages); ++kt) load_kv(kt);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + wg * kBwStep;                // this warpgroup's first row
  const int row_a = q0w + warp * 16 + g;            // and row_a + 8
  const unsigned char* qw = sq + wg * SB;
  const unsigned char* dow = sdo + wg * SB;
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const long long at = static_cast<long long>(bh) * seq_q + row;
    lse2[i] = row < seq_q ? lse[at] * kLog2e : 0.f;
    dl[i] = row < seq_q ? delta[at] : 0.f;
  }
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  // ds of one key step in S's layout, rounded to bf16 pairs (the A
  // fragment of ds k); `masked` sets keys past seq_k and, under causal,
  // above the diagonal to -1e30
  auto form_ds = [&](float (&sc)[32], const float (&dp)[32], int k0, auto masked,
                     uint32_t (&da)[16]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * sl2;
        if constexpr (decltype(masked)::value) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          if (col >= seq_k || (causal && col > row)) x = kNegInf;
        }
        const float p = exp2f(x - lse2[e >> 1]);
        sc[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]) * scale;
      }
      da[2 * j] = hopper::pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
      da[2 * j + 1] = hopper::pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };

  hopper::mbar_wait(&bar.own, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kBwStages;
    const unsigned char* kst = sk + s * SB;
    float sc[32], dp[32];
    hopper::mbar_wait(&bar.full[s], (kt / kBwStages) & 1);
    hopper::wgmma_fence();
    wgmma_rows_dot<D>(sc, qw, kst);
    wgmma_rows_dot<D>(dp, dow, sv + s * SB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const int k0 = kt * kBwStep;
    uint32_t da[16];
    if (k0 + kBwStep > seq_k || (causal && k0 + kBwStep - 1 > q0w))
      form_ds(sc, dp, k0, std::true_type{}, da);
    else
      form_ds(sc, dp, k0, std::false_type{}, da);

    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    hopper::wgmma_fence();
    wgmma_frag_rows<D>(acc, da, kst);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);

    // this warp is done with step kt: release it; thread 0 waits for the
    // other warps' release and loads step kt + kBwStages
    if (lane == 0) hopper::mbar_arrive(&bar.empty[s]);
    if (threadIdx.x == 0 && kt + kBwStages < nk) {
      hopper::mbar_wait(&bar.empty[s], (kt / kBwStages) & 1);
      load_kv(kt + kBwStages);
    }
    __syncwarp();
  }
  store_acc_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, row_a, seq_q, acc);
}

// dk and dv. Block (b*h, 128 keys), the first key tiles first (under
// causal they see the most query tiles: flash_attention.py:dkv_tile_order);
// its K and V come once, q and do of 64 query rows a step through the
// ring, from the step that holds query row k0 under causal (rows before
// it see none of these keys: flash_attention.py:dkv_query_start). Per step
// a warpgroup forms S^T = k q^T and dP^T = v do^T by wgmma (keys are the
// rows, queries the columns), so p^T and ds^T come out in the accumulator
// layout and pair into A fragments with no shared-memory round trip:
// dv += p^T do and dk += ds^T q by wgmma (do and q read MN-major). lse and
// delta are per column here: each warpgroup stages the step's 64 of each
// in shared memory (double-buffered, one named barrier a step), and a
// thread reads those of its columns 8j + 2t + {0, 1}. Queries past seq_q
// and, under causal, key > query are set to -1e30 on the steps that hold
// any.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               Strides dks, Strides dvs, int heads, int bh_count, int seq_q,
                               int seq_k, float scale, int causal) {
  constexpr int SB = kBwStepBytes<D>, OB = kBwOwnBytes<D>;
  constexpr int NA = D / 2;  // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = hopper::align_1024(smem_raw);
  unsigned char* sv = sk + OB;
  unsigned char* sq = sv + OB;
  unsigned char* sdo = sq + kBwStages * SB;
  float* stats_all = reinterpret_cast<float*>(sdo + kBwStages * SB);
  BwBarriers& bar = *reinterpret_cast<BwBarriers*>(stats_all + 2 * 2 * 2 * kBwStep);

  const int kt = static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / heads, h = bh % heads;
  const int k0 = kt * kBwOwn;
  const int first = causal ? k0 / kBwStep : 0;      // flash_attention.py:dkv_query_start
  const int steps = max((seq_q + kBwStep - 1) / kBwStep - first, 0);

  auto load_qdo = [&](int i) {
    const int s = i % kBwStages;
    hopper::mbar_expect_tx(&bar.full[s], 2 * SB);
    tma_rows64<D>(sq + s * SB, &qmap, &bar.full[s], h, (first + i) * kBwStep, b);
    tma_rows64<D>(sdo + s * SB, &domap, &bar.full[s], h, (first + i) * kBwStep, b);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar.own, 1);
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(&bar.full[s], 1);
      hopper::mbar_init(&bar.empty[s], 8);
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bar.own, 2 * OB);
    for (int half = 0; half < 2; ++half) {
      tma_rows64<D>(sk + half * SB, &kmap, &bar.own, h, k0 + half * kBwStep, b);
      tma_rows64<D>(sv + half * SB, &vmap, &bar.own, h, k0 + half * kBwStep, b);
    }
    for (int i = 0; i < min(steps, kBwStages); ++i) load_qdo(i);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0w = k0 + wg * kBwStep;                // this warpgroup's first key
  const int key_a = k0w + warp * 16 + g;            // and key_a + 8
  const unsigned char* kw = sk + wg * SB;
  const unsigned char* vw = sv + wg * SB;
  float* stats = stats_all + wg * 2 * 2 * kBwStep;  // [buffer][lse | delta][64]
  const float* lrow = lse + static_cast<long long>(bh) * seq_q;
  const float* drow = delta + static_cast<long long>(bh) * seq_q;
  const float sl2 = scale * kLog2e;
  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;

  // p^T and ds^T of one query step in S^T's layout, rounded to bf16 pairs
  // (the A fragments of p^T do and ds^T q); st holds the stats of the
  // step's 64 columns (lse * log2e, then delta)
  auto form_pds = [&](const float (&sc)[32], const float (&dp)[32], const float* st, int q0,
                      auto masked, uint32_t (&pa)[16], uint32_t (&da)[16]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = sc[4 * j + e] * sl2;
        if constexpr (decltype(masked)::value) {
          const int key = key_a + 8 * (e >> 1);
          if (q0 + c >= seq_q || (causal && key > q0 + c)) x = kNegInf;
        }
        p[e] = exp2f(x - st[c]);
        ds[e] = p[e] * (dp[4 * j + e] - st[kBwStep + c]) * scale;
      }
      pa[2 * j] = hopper::pack_bf16x2(p[0], p[1]);
      pa[2 * j + 1] = hopper::pack_bf16x2(p[2], p[3]);
      da[2 * j] = hopper::pack_bf16x2(ds[0], ds[1]);
      da[2 * j + 1] = hopper::pack_bf16x2(ds[2], ds[3]);
    }
  };

  hopper::mbar_wait(&bar.own, 0);
  for (int i = 0; i < steps; ++i) {
    const int s = i % kBwStages;
    const int q0 = (first + i) * kBwStep;
    const unsigned char* qst = sq + s * SB;
    const unsigned char* dost = sdo + s * SB;
    // this step's lse (threads 0-63 of the warpgroup) or delta (64-127),
    // loaded before the wait so the read overlaps it
    const int row = q0 + (tid & 63);
    float stat = 0.f;
    if (row < seq_q) stat = tid < kBwStep ? lrow[row] * kLog2e : drow[row];

    float sc[32], dp[32];
    hopper::mbar_wait(&bar.full[s], (i / kBwStages) & 1);
    hopper::wgmma_fence();
    wgmma_rows_dot<D>(sc, kw, qst);
    wgmma_rows_dot<D>(dp, vw, dost);
    hopper::wgmma_commit();
    float* st = stats + (i & 1) * 2 * kBwStep;
    st[tid] = stat;
    hopper::named_barrier_sync(1 + wg, 128);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    uint32_t pa[16], da[16];
    if (q0 + kBwStep > seq_q || (causal && q0 < k0w + kBwStep - 1))
      form_pds(sc, dp, st, q0, std::true_type{}, pa, da);
    else
      form_pds(sc, dp, st, q0, std::false_type{}, pa, da);

    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    hopper::wgmma_fence();
    wgmma_frag_rows<D>(dva, pa, dost);
    wgmma_frag_rows<D>(dka, da, qst);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);

    if (lane == 0) hopper::mbar_arrive(&bar.empty[s]);
    if (threadIdx.x == 0 && i + kBwStages < steps) {
      hopper::mbar_wait(&bar.empty[s], (i / kBwStages) & 1);
      load_qdo(i + kBwStages);
    }
    __syncwarp();
  }
  store_acc_rows<D>(dk + b * dks.b + h * dks.h, dks.s, key_a, seq_k, dka);
  store_acc_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.s, key_a, seq_k, dva);
}

// The f32 forward: FMAs in the mma.sync register layout (attention_tiles.cuh).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, int heads, int seq_q, int seq_k, float scale,
                     int causal) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kBlockQ * LD;
  T* sv = sk + kBlockK * LD;
  T* sp = sv + kBlockK * LD;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, kBlockQ, D>(sq, q + b * qs.b + h * qs.h, qs.s, q0, seq_q);

  const float sl2 = scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // this lane's rows: row_a, row_a + 8
  FwdState<D> st;
  fwd_init(st);
  T* pw = sp + warp * 16 * (kBlockK + kPad);

  const int nk = key_tiles(q0, seq_k, causal);
  for (int kt = 0; kt < nk; ++kt)
    fwd_step<T, D>(st, sq, sk, sv, pw, kb, ks.s, vb, vs.s, kt * kBlockK, seq_k, causal, row_a,
                   sl2);
  fwd_store<T, D>(st, o + b * os.b + h * os.h, os.s, lse + static_cast<long long>(bh) * seq_q,
                  row_a, seq_q);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides ds_,
                        Strides dqs, int heads, int seq_q, int seq_k, float scale, int causal) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kBlockK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + kBlockQ * LD;
  T* sk = sdo + kBlockQ * LD;
  T* sv = sk + kBlockK * LD;
  T* sds = sv + kBlockK * LD;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, kBlockQ, D>(sq, q + b * qs.b + h * qs.h, qs.s, q0, seq_q);
  load_tile<T, kBlockQ, D>(sdo, dout + b * ds_.b + h * ds_.h, ds_.s, q0, seq_q);

  const float sl2 = scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const long long at = static_cast<long long>(bh) * seq_q + row;
    lse2[i] = row < seq_q ? lse[at] * kLog2e : 0.f;
    dl[i] = row < seq_q ? delta[at] : 0.f;
  }
  float acc[D / 8][4] = {};
  T* dsw = sds + warp * 16 * LDP;

  const int nk = key_tiles(q0, seq_k, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile<T, kBlockK, D>(sk, kb, ks.s, k0, seq_k);
    load_tile<T, kBlockK, D>(sv, vb, vs.s, k0, seq_k);
    __syncthreads();

    float s[kBlockK / 8][4] = {};
    warp_mma<kBlockK / 8, D, LD, 1, 1, LD>(s, sq + warp * 16 * LD, sk);
    float dp[kBlockK / 8][4] = {};
    warp_mma<kBlockK / 8, D, LD, 1, 1, LD>(dp, sdo + warp * 16 * LD, sv);
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row_a + 8 * i;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool keep = col < seq_k && (!causal || col <= row);
        const float x = keep ? s[j][e] * sl2 : kNegInf;
        const float p = exp2f(x - lse2[i]);
        const float ds = p * (dp[j][e] - dl[i]) * scale;
        dsw[(g + 8 * i) * LDP + j * 8 + 2 * t + (e & 1)] = from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<D / 8, kBlockK, LDP, 1, LD, 1>(acc, dsw, sk);
  }
  store_rows<T, D>(dq + b * dqs.b + h * dqs.h, dqs.s, row_a, seq_q, acc, 1.f, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks,
                         Strides vs, Strides ds_, Strides dks, Strides dvs, int heads,
                         int seq_q, int seq_k, float scale, int causal) {
  constexpr int LD = D + kPad;
  constexpr int LDQ = kBlockQi + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kBlockK * LD;
  T* sq = sv + kBlockK * LD;
  T* sdo = sq + kBlockQi * LD;
  T* spt = sdo + kBlockQi * LD;      // p^T: [keys, queries]
  T* sdst = spt + kBlockK * LDQ;     // ds^T
  float* slse = reinterpret_cast<float*>(sdst + kBlockK * LDQ);
  float* sdl = slse + kBlockQi;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kBlockK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * ds_.b + h * ds_.h;
  const float* lrow = lse + static_cast<long long>(bh) * seq_q;
  const float* drow = delta + static_cast<long long>(bh) * seq_q;
  load_tile<T, kBlockK, D>(sk, k + b * ks.b + h * ks.h, ks.s, k0, seq_k);
  load_tile<T, kBlockK, D>(sv, v + b * vs.b + h * vs.h, vs.s, k0, seq_k);

  const float sl2 = scale * kLog2e;
  const int key_a = k0 + warp * 16 + g;  // this lane's keys: key_a, key_a + 8
  float dka[D / 8][4] = {};
  float dva[D / 8][4] = {};
  T* ptw = spt + warp * 16 * LDQ;
  T* dstw = sdst + warp * 16 * LDQ;

  const int nq = (seq_q + kBlockQi - 1) / kBlockQi;
  // causal: query rows before k0 see none of these keys
  for (int qt = causal ? k0 / kBlockQi : 0; qt < nq; ++qt) {
    const int q0 = qt * kBlockQi;
    __syncthreads();
    load_tile<T, kBlockQi, D>(sq, qb, qs.s, q0, seq_q);
    load_tile<T, kBlockQi, D>(sdo, dob, ds_.s, q0, seq_q);
    if (threadIdx.x < kBlockQi) {
      const int row = q0 + threadIdx.x;
      slse[threadIdx.x] = row < seq_q ? lrow[row] * kLog2e : 0.f;
      sdl[threadIdx.x] = row < seq_q ? drow[row] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: rows are this warp's keys, columns the tile's queries
    float st[kBlockQi / 8][4] = {};
    warp_mma<kBlockQi / 8, D, LD, 1, 1, LD>(st, sk + warp * 16 * LD, sq);
    float dpt[kBlockQi / 8][4] = {};
    warp_mma<kBlockQi / 8, D, LD, 1, 1, LD>(dpt, sv + warp * 16 * LD, sdo);
#pragma unroll
    for (int j = 0; j < kBlockQi / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + 8 * (e >> 1);
        const int c = j * 8 + 2 * t + (e & 1);
        const int row = q0 + c;
        const bool keep = key < seq_k && row < seq_q && (!causal || key <= row);
        const float x = keep ? st[j][e] * sl2 : kNegInf;
        const float p = exp2f(x - slse[c]);
        const float ds = p * (dpt[j][e] - sdl[c]) * scale;
        const int at = (g + 8 * (e >> 1)) * LDQ + c;
        ptw[at] = from_f<T>(p);
        dstw[at] = from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<D / 8, kBlockQi, LDQ, 1, LD, 1>(dva, ptw, sdo);
    warp_mma<D / 8, kBlockQi, LDQ, 1, LD, 1>(dka, dstw, sq);
  }
  store_rows<T, D>(dk + b * dks.b + h * dks.h, dks.s, key_a, seq_k, dka, 1.f, 1.f);
  store_rows<T, D>(dv + b * dvs.b + h * dvs.h, dvs.s, key_a, seq_k, dva, 1.f, 1.f);
}

template <typename T, int D>
constexpr int dq_smem() {
  return (2 * kBlockQ + 2 * kBlockK) * (D + kPad) * sizeof(T) +
         kBlockQ * (kBlockK + kPad) * sizeof(T);
}
template <typename T, int D>
constexpr int dkv_smem() {
  return (2 * kBlockK + 2 * kBlockQi) * (D + kPad) * sizeof(T) +
         2 * kBlockK * (kBlockQi + kPad) * sizeof(T) + 2 * kBlockQi * sizeof(float);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       const long long* st, int batch, int heads, int seq_q, int seq_k,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int smem = fwd_smem<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), heads, seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

// A [batch, seq, heads, d] bf16 operand as a 4-D tensor map (head_dim,
// heads, seq, batch) through its strides, boxes of 64 x 1 x rows x 1
// (flash_attention.py:tma_geometry).
bool encode_operand(CUtensorMap* map, const void* base, Strides s, int batch, int heads, int seq,
                    int d, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(s.h) * 2, static_cast<cuuint64_t>(s.s) * 2,
                               static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper::encode_bf16_4d(map, base, dims, bytes, box);
}

// q, k, v in boxes of 128 rows, encoded on every call; one block per
// (b*h, 128 query rows).
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                             const long long* st, int batch, int heads, int seq_q, int seq_k,
                             float scale, int causal, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  const int seq[3] = {seq_q, seq_k, seq_k};
  for (int i = 0; i < 3; ++i)
    if (!encode_operand(&maps[i], base[i], strides_at(st, i), batch, heads, seq[i], D, kWgRows))
      return cudaErrorInvalidValue;
  constexpr int smem = kWgSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (seq_q + kWgRows - 1) / kWgRows;
  flash_fwd_wgmma_kernel<D><<<q_tiles * batch * heads, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      strides_at(st, 3), heads, batch * heads, q_tiles, seq_q, seq_k, scale * kLog2e, causal);
  return cudaGetLastError();
}

// q, k, v, do (strides 0..3) in boxes of 64 rows, for both backward kernels.
bool encode_bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                     const void* dout, const long long* st, int batch, int heads, int seq_q,
                     int seq_k, int d) {
  const void* base[4] = {q, k, v, dout};
  const int seq[4] = {seq_q, seq_k, seq_k, seq_q};
  for (int i = 0; i < 4; ++i)
    if (!encode_operand(&maps[i], base[i], strides_at(st, i), batch, heads, seq[i], d, kBwStep))
      return false;
  return true;
}

// one block per (b*h, 128 query rows); dq's strides are st[4]
template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, const long long* st,
                            int batch, int heads, int seq_q, int seq_k, float scale, int causal,
                            cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_bwd_maps(maps, q, k, v, dout, st, batch, heads, seq_q, seq_k, D))
    return cudaErrorInvalidValue;
  constexpr int smem = kBwSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (seq_q + kBwOwn - 1) / kBwOwn;
  flash_bwd_dq_wgmma_kernel<D><<<q_tiles * batch * heads, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), strides_at(st, 4), heads,
      batch * heads, q_tiles, seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

// one block per (b*h, 128 keys); dk's and dv's strides are st[4], st[5]
template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const long long* st, int batch, int heads, int seq_q, int seq_k,
                             float scale, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_bwd_maps(maps, q, k, v, dout, st, batch, heads, seq_q, seq_k, D))
    return cudaErrorInvalidValue;
  constexpr int smem = kBwSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (seq_k + kBwOwn - 1) / kBwOwn;
  flash_bwd_dkv_wgmma_kernel<D><<<k_tiles * batch * heads, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), strides_at(st, 4), strides_at(st, 5), heads, batch * heads,
      seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const long long* st,
                      int batch, int heads, int seq_q, int seq_k, float scale, int causal,
                      cudaStream_t stream) {
  constexpr int smem = dq_smem<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), heads,
      seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const long long* st, int batch, int heads, int seq_q, int seq_k,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dkv_smem<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_k + kBlockK - 1) / kBlockK, batch * heads);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), heads, seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

bool valid_shape(int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype) {
  return batch > 0 && heads > 0 && seq_q > 0 && seq_k > 0 && batch * heads <= 65535 &&
         (head_dim == 64 || head_dim == 128) && (dtype == kF32 || dtype == kBF16);
}

}  // namespace

// Each entry point picks the instance of its head_dim (64: BERT's, ViT's;
// 128: GPT-1.3B's) and its dtype: bf16 the wgmma kernels (q, k and v
// 16-byte aligned with strides of whole 16-byte units), f32 the mma.sync
// tiles. The two instances of a kernel compute alike.
#define FLASH_DISPATCH(BF16_CALL, F32_CALL)                                   \
  (dtype == kBF16 ? (head_dim == 128 ? BF16_CALL(128) : BF16_CALL(64))        \
                  : (head_dim == 128 ? F32_CALL(128) : F32_CALL(64)))

// o = softmax(scale * q k^T (+ causal mask)) v and its f32 row log-sum-exp.
// q, o: [batch, seq_q, heads, head_dim]; k, v: [batch, seq_k, heads,
// head_dim]; strides: 12 values, (batch, seq, head) strides in elements of
// q, k, v, o. lse: contiguous [batch*heads, seq_q] f32. head_dim 64 or 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         const long long* strides, int batch, int heads, int seq_q,
                         int seq_k, int head_dim, int dtype, float scale, int causal,
                         int device, void* stream) {
  if (!valid_shape(batch, heads, seq_q, seq_k, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_BF16(D) \
  launch_fwd_wgmma<D>(q, k, v, o, lse, strides, batch, heads, seq_q, seq_k, scale, causal, s)
#define FWD_F32(D) \
  launch_fwd<float, D>(q, k, v, o, lse, strides, batch, heads, seq_q, seq_k, scale, causal, s)
  err = FLASH_DISPATCH(FWD_BF16, FWD_F32);
#undef FWD_BF16
#undef FWD_F32
  return static_cast<int>(err);
}

// dq given lse and delta = rowsum(do * o) (both [batch*heads, seq_q] f32).
// strides: 15 values, for q, k, v, do, dq.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            const long long* strides, int batch, int heads, int seq_q,
                            int seq_k, int head_dim, int dtype, float scale, int causal,
                            int device, void* stream) {
  if (!valid_shape(batch, heads, seq_q, seq_k, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ_BF16(D)                                                                         \
  launch_dq_wgmma<D>(q, k, v, dout, lse, delta, dq, strides, batch, heads, seq_q, seq_k, scale, \
                     causal, s)
#define DQ_F32(D)                                                                          \
  launch_dq<float, D>(q, k, v, dout, lse, delta, dq, strides, batch, heads, seq_q, seq_k,  \
                      scale, causal, s)
  err = FLASH_DISPATCH(DQ_BF16, DQ_F32);
#undef DQ_BF16
#undef DQ_F32
  return static_cast<int>(err);
}

// dk and dv given lse and delta. strides: 18 values, for q, k, v, do, dk, dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const long long* strides, int batch, int heads, int seq_q,
                             int seq_k, int head_dim, int dtype, float scale, int causal,
                             int device, void* stream) {
  if (!valid_shape(batch, heads, seq_q, seq_k, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV_BF16(D)                                                                          \
  launch_dkv_wgmma<D>(q, k, v, dout, lse, delta, dk, dv, strides, batch, heads, seq_q, seq_k, \
                      scale, causal, s)
#define DKV_F32(D)                                                                           \
  launch_dkv<float, D>(q, k, v, dout, lse, delta, dk, dv, strides, batch, heads, seq_q,      \
                       seq_k, scale, causal, s)
  err = FLASH_DISPATCH(DKV_BF16, DKV_F32);
#undef DKV_BF16
#undef DKV_F32
  return static_cast<int>(err);
}

#undef FLASH_DISPATCH
