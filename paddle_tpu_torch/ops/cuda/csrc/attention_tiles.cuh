// Tile code shared by the f32 attention kernels for Hopper (sm_90a):
// flash_attention.cu's flash_fwd, flash_bwd_dq and flash_bwd_dkv, and
// block_sparse_attention.cu's bsa_fwd. The bf16 kernels run on wgmma and
// TMA instead (hopper.cuh).
//
// A block of four warps owns 64 query rows (16 a warp). Tiles are staged
// in shared memory with 16-byte loads, rows padded by 8 elements; the
// products are f32 FMAs in the register layout of mma.sync's m16n8k16
// tiles (wgmma's tf32 would change f32 results; f32 is the checking path).
// Tensors are read and written through their (batch, seq, head) strides
// with a contiguous last axis.
//
// Numerics follow the Pallas kernels: base-2 softmax with scale*log2(e)
// folded into the scores, masked scores set to -1e30 (not -inf), l == 0
// rows divided by 1, lse stored in natural log as m*ln2 + log(l) in f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 64;   // query rows a forward block owns
constexpr int kBlockK = 64;   // keys a forward step
constexpr int kPad = 8;       // shared-memory row padding, in elements

enum Dtype { kF32 = 0, kBF16 = 1 };

struct Strides {  // in elements; the head_dim axis is contiguous
  long long b, s, h;
};

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// Rows [row0, row0 + ROWS) of a [seq, D] slab (row stride `stride`) into
// shared memory (row stride D + kPad); rows at or past `seq` are zeroed,
// so masked keys never multiply garbage.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long stride, int row0, int seq) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      v = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * stride + col);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = v;
  }
}

// One warp: acc[j] += A (16 x K) @ B (K x 8*NT), A(r, k) = a[r*A_RS + k*A_KS]
// and B(k, n) = b[k*B_KS + n*B_NS] in shared memory, by FMAs in mma.sync's
// register layout: lane (g = lane/4, t = lane%4) holds rows g and g + 8,
// columns 2t and 2t + 1 of each 8-wide tile j: acc[j] = {(g, 2t), (g,
// 2t+1), (g+8, 2t), (g+8, 2t+1)}.
template <int NT, int K, int A_RS, int A_KS, int B_KS, int B_NS>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * A_RS + k * A_KS];
    const float a1 = a[(g + 8) * A_RS + k * A_KS];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b[k * B_KS + (j * 8 + 2 * t) * B_NS];
      const float b1 = b[k * B_KS + (j * 8 + 2 * t + 1) * B_NS];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// Max and sum across the four lanes that share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stores a warp's 16 x D accumulator rows (scaled by 1/div) to global rows
// q0 + warp*16 + {g, g + 8} below `seq`.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride, int row_a, int seq,
                                           const float (&acc)[D / 8][4], float div_a,
                                           float div_b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_a < seq) {
      T* p = base + static_cast<long long>(row_a) * stride + col;
      p[0] = from_f<T>(acc[j][0] / div_a);
      p[1] = from_f<T>(acc[j][1] / div_a);
    }
    if (row_a + 8 < seq) {
      T* p = base + static_cast<long long>(row_a + 8) * stride + col;
      p[0] = from_f<T>(acc[j][2] / div_b);
      p[1] = from_f<T>(acc[j][3] / div_b);
    }
  }
}

// Shared memory of a forward block: the q tile, one K and one V step, and
// each warp's 16 rows of p.
template <typename T, int D>
constexpr int fwd_smem() {
  return (kBlockQ + 2 * kBlockK) * (D + kPad) * sizeof(T) +
         kBlockQ * (kBlockK + kPad) * sizeof(T);
}

// The forward's running state for this lane's two rows (row_a, row_a + 8):
// the output accumulator, the running maximum m (base 2) and the sum l.
template <int D>
struct FwdState {
  float acc[D / 8][4];
  float m[2];
  float l[2];
};

template <int D>
__device__ __forceinline__ void fwd_init(FwdState<D>& st) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[j][e] = 0.f;
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;
}

// One forward step over keys [k0, k0 + kBlockK), called by every thread of
// the block: stage that K and V tile (rows at or past seq_k zeroed), form
// this warp's scores against its q rows (sq: the block's q tile), mask keys
// past seq_k and, under `causal`, keys above the diagonal (col > row) to
// -1e30, rescale acc and l to the new running maximum and add p @ v with p
// rounded to T (pw: this warp's 16 rows of p).
template <typename T, int D>
__device__ __forceinline__ void fwd_step(FwdState<D>& st, const T* sq, T* sk, T* sv, T* pw,
                                         const T* kb, long long k_stride, const T* vb,
                                         long long v_stride, int k0, int seq_k, int causal,
                                         int row_a, float sl2) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kBlockK + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncthreads();  // the previous step's K/V reads are done
  load_tile<T, kBlockK, D>(sk, kb, k_stride, k0, seq_k);
  load_tile<T, kBlockK, D>(sv, vb, v_stride, k0, seq_k);
  __syncthreads();

  float s[kBlockK / 8][4] = {};
  warp_mma<kBlockK / 8, D, LD, 1, 1, LD>(s, sq + warp * 16 * LD, sk);
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_a + 8 * (e >> 1);
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      const bool keep = col < seq_k && (!causal || col <= row);
      const float x = keep ? s[j][e] * sl2 : kNegInf;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    corr[i] = exp2f(st.m[i] - mx[i]);
    st.m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - st.m[e >> 1]);
      rs[e >> 1] += p;
      pw[(g + 8 * (e >> 1)) * LDP + j * 8 + 2 * t + (e & 1)] = from_f<T>(p);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.acc[j][0] *= corr[0];
    st.acc[j][1] *= corr[0];
    st.acc[j][2] *= corr[1];
    st.acc[j][3] *= corr[1];
  }
  __syncwarp();  // this warp's p rows are written
  warp_mma<D / 8, kBlockK, LDP, 1, LD, 1>(st.acc, pw, sv);
}

// o = acc / l (l == 0: divided by 1, so a row that saw no key is 0) and
// lse = m*ln2 + log(l) for this lane's rows below seq_q; lrow is the
// (b*h) row of lse.
template <typename T, int D>
__device__ __forceinline__ void fwd_store(const FwdState<D>& st, T* ob, long long o_stride,
                                          float* lrow, int row_a, int seq_q) {
  const int t = threadIdx.x & 3;
  const float la = st.l[0] == 0.f ? 1.f : st.l[0];
  const float lb = st.l[1] == 0.f ? 1.f : st.l[1];
  store_rows<T, D>(ob, o_stride, row_a, seq_q, st.acc, la, lb);
  if (t == 0) {
    if (row_a < seq_q) lrow[row_a] = st.m[0] * kLn2 + logf(la);
    if (row_a + 8 < seq_q) lrow[row_a + 8] = st.m[1] * kLn2 + logf(lb);
  }
}

}  // namespace
