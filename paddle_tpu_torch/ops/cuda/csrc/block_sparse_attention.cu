// Block-sparse flash attention forward for Hopper (sm_90a), with a plain
// C interface.
//
// bsa_fwd replaces paddle_tpu/ops/pallas/block_sparse_attention.py:
// _fwd_kernel (driven by _bsa_fwd, behind block_sparse_flash_attention and
// the block-aligned path of nn.functional.sparse_attention). The backward
// is a PyTorch composition over the same tables, as the reference's
// (_bsa_bwd_rule) is jnp.
//
// What bounds it on an H100: work is proportional to the active blocks of
// the mask. With A active (q-block, k-block) pairs of bq x bk tokens a
// (batch, head), the products take 4 * A * bq * bk * d operations; q, k,
// v and o are each moved once (4 * b*h*s*d elements), the lse and the
// tables are small. At the sparse block path's shape ([2, 16, 4096, 128],
// a window of 3 plus 2 global blocks of 64) bytes bound it (134 MB, 40 us
// at 3.35 TB/s, against 21 us of tensor-core work); at blocks of 512 over
// 16384 tokens the products do (200 GFLOP, 202 us at 989 TFLOP/s).
//
// The Pallas grid walks (b*h, q-block, step) with the step axis in order,
// the tables kt[qi, j] (the j-th active k-block of mask row qi) and
// cnt[qi] in scalar prefetch, and carries (acc, m, l) across steps in
// VMEM. Here a block owns its output tile and walks the keys itself.
//
// bf16 (bsa_fwd_wgmma_kernel, head_dim 64 and 128). The first version
// (mma.sync on four warps and 64 query rows, K and V staged by the compute
// threads between two barriers) ran at 15-20 % of the bound. This
// one is the bf16 flash forward's design (flash_attention.cu:
// flash_fwd_wgmma_kernel) driven by a table instead of a key range:
//   - one block of two warpgroups (256 threads) per (b*h, 128 query rows),
//     64 rows a warpgroup, one block an SM (160 KB of shared memory at
//     head_dim 128); q comes once by TMA;
//   - K and V come through a 2-stage ring of 128-key stages, each stage two
//     64-key TMA boxes addressed from the tile's box list (block_k / 64
//     boxes an active k-block, in kt's order). At blocks of 64 a stage
//     pairs two k-blocks, so wgmma keeps n = 128; blocks of 128-512 are
//     whole stages;
//   - at block_q = 64 a tile holds two mask rows (one a warpgroup): the
//     box list is the sorted union of their k-blocks, and a two-bit flag a
//     box says which warpgroups compute on it. A warpgroup skips the
//     products and the softmax of a stage that holds none of its boxes (it
//     still waits on the stage and releases it) and sets the scores of a
//     box it does not hold, or of the missing second box of an odd count
//     (loaded as a copy of the first), to -1e30: a zero-filled box alone
//     would give exp2(0 - m), not 0. Keys past seq_k are masked on the
//     stages whose boxes reach past it;
//   - S = q k^T and o += p v are wgmma (f32 accumulation); the online
//     softmax runs in S's accumulator registers and p stays there as the
//     register A operand of p v;
//   - blocks take the tiles with the most stages first (the tables'
//     order), the sparse counterpart of flash's heaviest-first order.
// Every stage a warpgroup runs holds at least one key below seq_k of a box
// it holds, so its running maximum is finite from its first stage on. The
// tables are built on the host (block_sparse_attention.py:
// tile_walk_tables).
//
// On the card (PERF.md §6) it takes 0.11 ms at the path's shape, 36 %
// of the byte bound: a tile there walks only 3 stages (5 active blocks a
// mask row, the union's sixth box masked), so each block's fixed cost
// (the first stage's wait, the epilogue, one block an SM) is not hidden;
// at blocks of 512 (12 stages a tile) it reaches 33 % of the operations
// bound, flash's rate. Measured and not kept: a 3-stage ring
// (no change); a persistent block an SM walking its tiles with the ring
// and a second q buffer running across tiles (5-32 % slower: a static
// share of the tiles, and thread 0's walk on the critical path); one
// warpgroup a block at block_q 64, two blocks an SM (3 % slower at
// head_dim 128, whose 1-stage ring then stalls; 11 % faster at 64).
//
// f32 (bsa_fwd_kernel) stays on the f32 tiles of attention_tiles.cuh (the
// checking path; wgmma's tf32 would change the results): four warps own
// 64 query rows of one mask row and walk kt[qi, 0:cnt[qi]] in 64-key
// steps of the flash forward's online softmax (fwd_step).
//
// Numerics are the reference kernel's: base-2 online softmax with
// scale*log2(e) folded into the scores, no token-level mask inside an
// active block (causal masks act at block level), keys at or past seq_k
// at -1e30, p rounded to v's type before p @ v with f32 accumulation,
// o = acc / (l == 0 ? 1 : l) and lse = m*ln2 + log(l) in f32; a row with
// no active block writes o = 0 and lse = -1e30 * ln2; rows past seq_q are
// not written. Nothing is summed across blocks: no atomics, the same bits
// on every run.
//
// The entry point launches on the stream it is given, does not
// synchronise, and returns cudaGetLastError().

#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------------ bf16 forward on wgmma
constexpr int kTileRows = 128;   // query rows a block owns, 64 a warpgroup
constexpr int kBoxRows = 64;     // rows (keys or queries) of a TMA box
constexpr int kBoxCols = 64;     // head values of a box row (128 bytes, the swizzle width)
constexpr int kBoxBytes = kBoxRows * kBoxCols * 2;    // 8 KB
constexpr int kStageKeys = 2 * kBoxRows;              // keys a stage: two boxes
constexpr int kStages = 2;                            // depth of the K/V ring
constexpr int kWgThreads = 256;

// A 128-row tile (q, or a stage's K or V): for each 64-value column chunk
// x, 128 rows of 128 bytes at x * 16 KB, so rows [0, 64) and [64, 128) are
// the two boxes of the chunk.
template <int D>
constexpr int kTileBytes = kTileRows * D * 2;
template <int D>
constexpr int kWgmmaSmem = (1 + 2 * kStages) * kTileBytes<D> + 128 + 1024;  // + barriers, alignment

struct RingBarriers {
  uint64_t q;
  uint64_t full_k[kStages], full_v[kStages], empty_k[kStages], empty_v[kStages];
};

// Rows [row0, row0 + 64) of head h, batch b, all D values, into half `hf`
// of a 128-row tile: D / 64 boxes, completion counted on `bar`.
template <int D>
__device__ __forceinline__ void tma_half(unsigned char* tile, int hf, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int h, int b) {
#pragma unroll
  for (int x = 0; x < D / kBoxCols; ++x)
    hopper::tma_load_4d(tile + x * 2 * kBoxBytes + hf * kBoxBytes, map, bar, x * kBoxCols, row0,
                        h, b);
}

// Block (b*h, tile): tile = order[blockIdx.x / bh_count], so every (b, h)
// takes the heaviest tiles first. The tile's boxes are
// boxes[tile, 0:count[tile]], each (64-key chunk << 2) | (warpgroups that
// compute on it, a bit each); stage j holds boxes 2j and 2j + 1. Thread 0
// loads q once and keeps the ring full: K and V of a stage each have a
// "full" barrier (the TMA bytes landed) and an "empty" one (all 8 warps
// are done with it), and thread 0 refills a stage with the stage
// kStages ahead as soon as all warps have released it, K right after S is
// formed, V after p v. A thread holds rows row_a and row_a + 8 of its
// warpgroup, columns 8j + 2t + {0, 1} of S and of o.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    bsa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse, Strides os,
                         const int* __restrict__ boxes, const int* __restrict__ count,
                         const int* __restrict__ order, int max_boxes, int heads, int bh_count,
                         int seq_q, int seq_k, float sl2) {
  constexpr int TB = kTileBytes<D>;
  constexpr int NA = D / 2;  // accumulator registers a thread: 64 x D over 128 threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = hopper::align_1024(smem_raw);
  unsigned char* sk = sq + TB;
  unsigned char* sv = sk + kStages * TB;
  RingBarriers& bar = *reinterpret_cast<RingBarriers*>(sv + kStages * TB);

  const int tile = order[blockIdx.x / bh_count];
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / heads, h = bh % heads;
  const int q0 = tile * kTileRows;
  if (q0 >= seq_q) return;  // a tile of the mask's last row past seq_q
  const int* bx = boxes + static_cast<long long>(tile) * max_boxes;
  const int n = count[tile];
  const int stages = (n + 1) / 2;

  // stage j's K (or V) into ring slot j % kStages. The missing second box
  // of an odd count is a copy of the first: its scores are masked, and its
  // V rows must be finite (p = 0 times stale shared memory could be NaN).
  auto load_stage = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full, int j) {
    const int s = j % kStages;
    const int c0 = bx[2 * j] >> 2;
    const int c1 = 2 * j + 1 < n ? bx[2 * j + 1] >> 2 : c0;
    hopper::mbar_expect_tx(&full[s], TB);
    tma_half<D>(ring + s * TB, 0, map, &full[s], c0 * kBoxRows, h, b);
    tma_half<D>(ring + s * TB, 1, map, &full[s], c1 * kBoxRows, h, b);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar.q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&bar.full_k[s], 1);
      hopper::mbar_init(&bar.full_v[s], 1);
      hopper::mbar_init(&bar.empty_k[s], 8);
      hopper::mbar_init(&bar.empty_v[s], 8);
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bar.q, TB);
    tma_half<D>(sq, 0, &qmap, &bar.q, q0, h, b);
    tma_half<D>(sq, 1, &qmap, &bar.q, q0 + kBoxRows, h, b);
    for (int j = 0; j < min(stages, kStages); ++j) {
      load_stage(&kmap, sk, bar.full_k, j);
      load_stage(&vmap, sv, bar.full_v, j);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + warp * 16 + g;  // and row_a + 8
  const unsigned char* qw = sq + wg * kBoxBytes;   // this warpgroup's 64 rows
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // this warp is done with stage j's K (or V): release it; thread 0 waits
  // for the other warps' release and loads stage j + kStages
  auto release = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* full,
                     uint64_t* empty, int j) {
    if (lane == 0) hopper::mbar_arrive(&empty[j % kStages]);
    if (threadIdx.x == 0 && j + kStages < stages) {
      hopper::mbar_wait(&empty[j % kStages], (j / kStages) & 1);
      load_stage(map, ring, full, j + kStages);
    }
    __syncwarp();  // warp 0 reconverges before its next wgmma
  };
  // scores into log2 units, the running maximum m, p = exp2(s - m) in sc
  // and its row sums rs; `masked` sets the columns of box hf at or past
  // lim[hf] (keys past seq_k, a box this warpgroup does not hold, the
  // missing box of an odd count) to -1e30. Returns in corr the factors
  // that move acc and l to the new maximum.
  auto softmax = [&](float (&sc)[64], const int (&lim)[2], auto masked, float (&corr)[2],
                     float (&rs)[2]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * sl2;
        if constexpr (decltype(masked)::value) {
          if (8 * (j & 7) + 2 * t + (e & 1) >= lim[j >> 3]) x = kNegInf;
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
  for (int j = 0; j < stages; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int e0 = bx[2 * j];
    const int e1 = 2 * j + 1 < n ? bx[2 * j + 1] : 0;  // flags 0: no second box
    int lim[2] = {0, 0};  // columns of each box this warpgroup keeps
    if ((e0 >> wg) & 1) lim[0] = min(kBoxRows, max(0, seq_k - (e0 >> 2) * kBoxRows));
    if ((e1 >> wg) & 1) lim[1] = min(kBoxRows, max(0, seq_k - (e1 >> 2) * kBoxRows));
    const bool run = ((e0 | e1) >> wg) & 1;  // warpgroup-uniform
    float sc[64];
    hopper::mbar_wait(&bar.full_k[s], parity);
    if (run) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * 2 * kBoxBytes + (kk % 4) * 32;
        hopper::wgmma_m64n128k16_ss(sc, hopper::smem_desc(qw + off, 16, 1024),
                                    hopper::smem_desc(sk + s * TB + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
    }
    release(&kmap, sk, bar.full_k, bar.empty_k, j);

    uint32_t p[32];  // p as the A operand: 2i and 2i + 1 are rows row_a and row_a + 8
    if (run) {
      float corr[2], rs[2];
      if (lim[0] < kBoxRows || lim[1] < kBoxRows)
        softmax(sc, lim, std::true_type{}, corr, rs);
      else
        softmax(sc, lim, std::false_type{}, corr, rs);
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
      for (int i = 0; i < NA / 4; ++i) {
        acc[4 * i] *= corr[0];
        acc[4 * i + 1] *= corr[0];
        acc[4 * i + 2] *= corr[1];
        acc[4 * i + 3] *= corr[1];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        p[2 * i] = hopper::pack_bf16x2(sc[4 * i], sc[4 * i + 1]);
        p[2 * i + 1] = hopper::pack_bf16x2(sc[4 * i + 2], sc[4 * i + 3]);
      }
    }

    hopper::mbar_wait(&bar.full_v[s], parity);
    if (run) {
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageKeys / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        const uint64_t desc = hopper::smem_desc(sv + s * TB + kk * 16 * 128, 2 * kBoxBytes, 1024);
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs_mn(acc, a, desc);
        else
          hopper::wgmma_m64n64k16_rs_mn(acc, a, desc);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
    }
    release(&vmap, sv, bar.full_v, bar.empty_v, j);
  }

  // o = acc / l (l == 0: divided by 1, so a row that saw no key is 0),
  // lse = m*ln2 + log(l)
  const float la = l[0] == 0.f ? 1.f : l[0];
  const float lb = l[1] == 0.f ? 1.f : l[1];
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < NA / 4; ++i) {
    const int col = 8 * i + 2 * t;
    if (row_a < seq_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_a) * os.s + col) =
          hopper::pack_bf16x2(acc[4 * i] / la, acc[4 * i + 1] / la);
    if (row_a + 8 < seq_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_a + 8) * os.s + col) =
          hopper::pack_bf16x2(acc[4 * i + 2] / lb, acc[4 * i + 3] / lb);
  }
  if (t == 0) {
    float* lrow = lse + static_cast<long long>(bh) * seq_q;
    if (row_a < seq_q) lrow[row_a] = m[0] * kLn2 + logf(la);
    if (row_a + 8 < seq_q) lrow[row_a + 8] = m[1] * kLn2 + logf(lb);
  }
}

// A [batch, heads, seq, D] bf16 operand as a 4-D tensor map (head_dim,
// seq, heads, batch) through its strides, boxes of 64 values x 64 rows.
bool encode_rows(CUtensorMap* map, const void* base, Strides s, int batch, int heads, int seq,
                 int d) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(s.s) * 2, static_cast<cuuint64_t>(s.h) * 2,
                               static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {kBoxCols, kBoxRows, 1, 1};
  return hopper::encode_bf16_4d(map, base, dims, bytes, box);
}

template <int D>
cudaError_t launch_bsa_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* boxes, const void* count, const void* order,
                             const long long* st, int batch, int heads, int seq_q, int seq_k,
                             int tiles, int max_boxes, float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  const int seq[3] = {seq_q, seq_k, seq_k};
  for (int i = 0; i < 3; ++i)
    if (!encode_rows(&maps[i], base[i], strides_at(st, i), batch, heads, seq[i], D))
      return cudaErrorInvalidValue;
  constexpr int smem = kWgmmaSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(bsa_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bsa_fwd_wgmma_kernel<D><<<tiles * batch * heads, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      strides_at(st, 3), static_cast<const int*>(boxes), static_cast<const int*>(count),
      static_cast<const int*>(order), max_boxes, heads, batch * heads, seq_q, seq_k,
      scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------------ f32 forward on mma.sync
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kt,
                   const int* __restrict__ cnt, Strides qs, Strides ks, Strides vs, Strides os,
                   int heads, int seq_q, int seq_k, int block_q, int block_k, int max_active,
                   float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kBlockQ * LD;
  T* sv = sk + kBlockK * LD;
  T* sp = sv + kBlockK * LD;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int qi = q0 / block_q;  // this tile's mask row
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, kBlockQ, D>(sq, q + b * qs.b + h * qs.h, qs.s, q0, seq_q);

  const float sl2 = scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // this lane's rows: row_a, row_a + 8
  FwdState<D> st;
  fwd_init(st);
  T* pw = sp + warp * 16 * (kBlockK + kPad);

  const int n = cnt[qi];
  for (int j = 0; j < n; ++j) {
    const int k_begin = kt[qi * max_active + j] * block_k;
    const int k_end = min(k_begin + block_k, seq_k);
    for (int k0 = k_begin; k0 < k_end; k0 += kBlockK)
      fwd_step<T, D>(st, sq, sk, sv, pw, kb, ks.s, vb, vs.s, k0, seq_k, 0, row_a, sl2);
  }
  fwd_store<T, D>(st, o + b * os.b + h * os.h, os.s, lse + static_cast<long long>(bh) * seq_q,
                  row_a, seq_q);
}

template <typename T, int D>
cudaError_t launch_bsa(const void* q, const void* k, const void* v, void* o, void* lse,
                       const void* kt, const void* cnt, const long long* st, int batch,
                       int heads, int seq_q, int seq_k, int block_q, int block_k,
                       int max_active, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem<T, D>();
  cudaError_t err = cudaFuncSetAttribute(bsa_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  bsa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kt),
      static_cast<const int*>(cnt), strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), heads, seq_q, seq_k, block_q, block_k, max_active, scale);
  return cudaGetLastError();
}

bool valid_block(int block) { return block >= kBlockQ && block <= 512 && block % kBlockQ == 0; }

}  // namespace

// o = the block-sparse attention of q over k, v (f32 row log-sum-exp in
// lse). q, o: [batch, heads, seq_q, head_dim]; k, v: [batch, heads, seq_k,
// head_dim], read and written through strides: 12 values, the (batch, seq,
// head) strides in elements of q, k, v, o (bf16: q, k and v 16-byte aligned
// with strides of whole 16-byte units). lse: contiguous [batch*heads,
// seq_q] f32. On the device: the f32 kernel's tables kt (contiguous int32
// [ceil(seq_q / block_q), max_active]) and cnt; the bf16 kernel's walk
// (block_sparse_attention.py:tile_walk_tables) boxes (contiguous int32
// [tiles, max_boxes]), count and order (int32 [tiles]), tiles >= ceil(seq_q
// / 128). block_q and block_k are multiples of 64 up to 512; head_dim is
// 64 or 128.
extern "C" int bsa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       const void* kt, const void* cnt, const void* boxes, const void* count,
                       const void* order, const long long* strides, int batch, int heads,
                       int seq_q, int seq_k, int head_dim, int dtype, int block_q, int block_k,
                       int max_active, int tiles, int max_boxes, float scale, int device,
                       void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 || batch * heads > 65535 ||
      max_active <= 0 || !valid_block(block_q) || !valid_block(block_k) ||
      (head_dim != 64 && head_dim != 128) || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16 && (max_boxes <= 0 || tiles < (seq_q + kTileRows - 1) / kTileRows ||
                         static_cast<long long>(tiles) * batch * heads > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
#define BSA_WGMMA(D)                                                                         \
  launch_bsa_wgmma<D>(q, k, v, o, lse, boxes, count, order, strides, batch, heads, seq_q,  \
                      seq_k, tiles, max_boxes, scale, s)
    err = head_dim == 128 ? BSA_WGMMA(128) : BSA_WGMMA(64);
#undef BSA_WGMMA
  } else {
#define BSA_LAUNCH(D)                                                                          \
  launch_bsa<float, D>(q, k, v, o, lse, kt, cnt, strides, batch, heads, seq_q, seq_k, block_q, \
                       block_k, max_active, scale, s)
    err = head_dim == 128 ? BSA_LAUNCH(128) : BSA_LAUNCH(64);
#undef BSA_LAUNCH
  }
  return static_cast<int>(err);
}
