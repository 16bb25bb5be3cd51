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
// (3 products) and dk/dv (4 products) lean to operations. These kernels
// do not reach either bound: they are the simple, right first version.
//
// Design. The Pallas grid runs its innermost axis in order and carries
// (acc, m, l) in VMEM scratch from one grid step to the next. On Hopper
// blocks run in no order, so a block owns its whole output tile and
// loops over the other axis itself:
//   - flash_fwd and flash_bwd_dq: one block per (b*h, 64 query rows),
//     looping over 64-key tiles; under `causal` the loop stops at the
//     diagonal (the TPU kernel's `run` predicate);
//   - flash_bwd_dkv: one block per (b*h, 64 keys), looping over 32-row
//     query tiles from the diagonal on.
// dq and dk/dv stay in separate kernels, as in the reference, so no
// output is summed across blocks: there are no atomics, and a result is
// the same on every run. Four warps split a block's 64 output rows, 16
// each. Tiles are staged in shared memory (16-byte loads, rows padded by
// 8 elements); the products are mma.sync m16n8k16 bf16 tiles with f32
// accumulation for bf16 inputs, and f32 FMAs in the same register layout
// for f32 inputs. q, k, v, o, do, dq, dk, dv are read and written in
// place through their strides ([b, s, h, d] with a contiguous last axis),
// so the q/k/v views that GPTAttention splits off its fused projection
// need no transpose and no copy. The tile code and the forward's
// online-softmax step live in attention_tiles.cuh, shared with
// block_sparse_attention.cu.
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

#include "attention_tiles.cuh"

namespace {

constexpr int kBlockQi = 32;  // dk/dv: query rows a step
constexpr int kHeadDim = 128; // the one head_dim instantiated (GPT-1.3B's)

// Key tiles a query tile starting at q0 visits (the causal diagonal bound).
__device__ __forceinline__ int key_tiles(int q0, int seq_k, int causal) {
  int n = (seq_k + kBlockK - 1) / kBlockK;
  if (causal) n = min(n, (q0 + kBlockQ - 1) / kBlockK + 1);
  return n;
}

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
         head_dim == kHeadDim && (dtype == kF32 || dtype == kBF16);
}

}  // namespace

// o = softmax(scale * q k^T (+ causal mask)) v and its f32 row log-sum-exp.
// q, o: [batch, seq_q, heads, head_dim]; k, v: [batch, seq_k, heads,
// head_dim]; strides: 12 values, (batch, seq, head) strides in elements of
// q, k, v, o. lse: contiguous [batch*heads, seq_q] f32. head_dim 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         const long long* strides, int batch, int heads, int seq_q,
                         int seq_k, int head_dim, int dtype, float scale, int causal,
                         int device, void* stream) {
  if (!valid_shape(batch, heads, seq_q, seq_k, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == kBF16)
    err = launch_fwd<bf16, kHeadDim>(q, k, v, o, lse, strides, batch, heads, seq_q, seq_k, scale, causal, s);
  else
    err = launch_fwd<float, kHeadDim>(q, k, v, o, lse, strides, batch, heads, seq_q, seq_k, scale, causal, s);
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
  using bf16 = __nv_bfloat16;
  if (dtype == kBF16)
    err = launch_dq<bf16, kHeadDim>(q, k, v, dout, lse, delta, dq, strides, batch, heads, seq_q, seq_k, scale, causal, s);
  else
    err = launch_dq<float, kHeadDim>(q, k, v, dout, lse, delta, dq, strides, batch, heads, seq_q, seq_k, scale, causal, s);
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
  using bf16 = __nv_bfloat16;
  if (dtype == kBF16)
    err = launch_dkv<bf16, kHeadDim>(q, k, v, dout, lse, delta, dk, dv, strides, batch, heads, seq_q, seq_k, scale, causal, s);
  else
    err = launch_dkv<float, kHeadDim>(q, k, v, dout, lse, delta, dk, dv, strides, batch, heads, seq_q, seq_k, scale, causal, s);
  return static_cast<int>(err);
}
