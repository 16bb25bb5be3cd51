// Fused AdamW update for Hopper (sm_90a), with a plain C interface.
//
// adam_update replaces paddle_tpu/ops/pallas/optim.py:_adam_kernel (the
// Pallas kernel behind fused_adam_update): one AdamW step of one rank-2
// parameter, in place. p is f32; g is f32 or bf16; the moments m and v
// are f32 or bf16 storage, the math f32 in registers. The scalars arrive
// as a 4-float device array sc = [lr, 1 - beta1^t, 1 - beta2^t,
// decay_on], so a schedule or the bias corrections never need a host
// value.
//
// The arithmetic is the reference kernel's, op for op: decoupled decay
// first (p * (1 - decay_on * lr * wd), only when wd != 0), then
// m' = beta1 * m + (1 - beta1) * g, v' = beta2 * v + (1 - beta2) * g * g,
// mhat = m' / c1, vhat = v' / c2 (division, not a reciprocal),
// p' = p - lr * mhat / (sqrt(vhat) + eps). Every step is an
// IEEE-rounded intrinsic (__fmul_rn, __fdiv_rn, __fsqrt_rn, ...), which
// nvcc never contracts into an FMA, so the kernel rounds exactly where the
// plain PyTorch version (ops/cuda/optim.py:_adam_ref) does.
//
// What bounds it on an H100: bytes. It reads p, g, m, v once and writes
// p, m, v once: 28 bytes an element with f32 g and moments (16 with bf16
// g and moments), against some 15 f32 operations an element.
//
// The guard (guard=True in the reference): a parameter's rows are cut
// into the reference's row blocks (_pick_block_rows: the regions), and a
// region whose f32 sum of g*g is not finite keeps its p, m and v
// unchanged. A region is up to 2 MB of g, far more than one block can
// hold, and blocks run in no order, so the verdict cannot be known where
// the update runs. Two kernels therefore:
//   1. adam_sumsq: block (c, r) sums g*g over chunk c of region r in a
//      fixed order (per thread, then by warp shuffles, then the warps in
//      index order) and writes one f32 partial: no atomics, so the sums
//      repeat bit for bit from run to run;
//   2. adam_update with guard: block (c, r) first sums region r's chunk
//      partials in a fixed order (the same in every block of the region),
//      block (0, r) writes the region's total, and a block of a
//      non-finite region returns before writing anything.
// That reads g twice (32 bytes an element); a later kernel may fuse it.
//
// Layout: the parameter is a contiguous [rows, cols] array of n
// elements; region r is elements [r * region_elems, (r + 1) *
// region_elems). A block handles one chunk of kChunk elements of one
// region, 8 elements a thread per step with 16-byte loads (32 bytes for
// f32). Regions other than the last start at a multiple of 8 elements
// (a row block is a multiple of 8 rows unless it is the whole array), so
// only the array's end can be ragged; a block finishes its chunk's ragged
// tail element by element.
//
// Every entry point launches on the stream it is given, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                             // elements a thread moves per step
constexpr int kSteps = 8;                           // steps a thread takes per chunk
constexpr int kChunk = kThreads * kVec * kSteps;    // 16384 elements a block
constexpr int kMaxRegions = 65535;                  // gridDim.y

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    v[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The host-side constants of one update (betas, eps and the decay
// coefficient are compile-time constants of the reference kernel).
struct Coef {
  float beta1, beta2, one_minus_beta1, one_minus_beta2, eps, wd;
};

// The step's scalars, read from sc once per thread.
struct Scalars {
  float lr, c1, c2, decay;   // decay = 1 - decay_on * lr * wd
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, const Coef& k,
                                          const Scalars& s) {
  if (k.wd != 0.f) p = __fmul_rn(p, s.decay);
  m = __fadd_rn(__fmul_rn(k.beta1, m), __fmul_rn(k.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(k.beta2, v), __fmul_rn(__fmul_rn(k.one_minus_beta2, g), g));
  const float mhat = __fdiv_rn(m, s.c1);
  const float vhat = __fdiv_rn(v, s.c2);
  const float upd = __fdiv_rn(__fmul_rn(s.lr, mhat), __fadd_rn(__fsqrt_rn(vhat), k.eps));
  p = __fsub_rn(p, upd);
}

// Sum of x over the block in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// Finite: the exponent is not all ones (not an inf or a NaN).
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// [start, end) of chunk blockIdx.x of region blockIdx.y.
__device__ __forceinline__ void chunk_bounds(int64_t n, int64_t region_elems, int64_t& start,
                                             int64_t& end) {
  const int64_t region_start = static_cast<int64_t>(blockIdx.y) * region_elems;
  const int64_t region_end = min64(region_start + region_elems, n);
  start = region_start + static_cast<int64_t>(blockIdx.x) * kChunk;
  end = min64(start + kChunk, region_end);
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
adam_sumsq_kernel(const TG* __restrict__ g, int64_t n, int64_t region_elems, int chunks,
                  float* __restrict__ chunk_parts) {
  int64_t start, end;
  chunk_bounds(n, region_elems, start, end);
  const int64_t vend = start + ((end > start ? end - start : 0) & ~int64_t(kVec - 1));
  float acc = 0.f;
  for (int64_t i = start + threadIdx.x * kVec; i < vend; i += kThreads * kVec) {
    float x[kVec];
    load8(g + i, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc += x[j] * x[j];
  }
  for (int64_t i = vend + threadIdx.x; i < end; i += kThreads) {
    const float x = load1(g + i);
    acc += x * x;
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) chunk_parts[static_cast<int64_t>(blockIdx.y) * chunks + blockIdx.x] = total;
}

template <typename TG, typename TM, bool kGuard>
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(float* __restrict__ p, const TG* __restrict__ g, TM* __restrict__ m,
                   TM* __restrict__ v, const float* __restrict__ sc, Coef k, int64_t n,
                   int64_t region_elems, int chunks, const float* __restrict__ chunk_parts,
                   float* __restrict__ region_parts) {
  if (kGuard) {
    // the region's verdict: its chunk partials summed in one fixed
    // order (lanes stride the partials, then a shuffle tree), the same
    // in every block of the region
    __shared__ float region_total;
    if (threadIdx.x < 32) {
      const float* parts = chunk_parts + static_cast<int64_t>(blockIdx.y) * chunks;
      float x = 0.f;
      for (int c = threadIdx.x; c < chunks; c += 32) x += parts[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
      if (threadIdx.x == 0) {
        region_total = x;
        if (blockIdx.x == 0) region_parts[blockIdx.y] = x;
      }
    }
    __syncthreads();
    if (!finite(region_total)) return;   // the region keeps its p, m and v
  }
  Scalars s;
  s.lr = sc[0];
  s.c1 = sc[1];
  s.c2 = sc[2];
  s.decay = __fsub_rn(1.f, __fmul_rn(__fmul_rn(sc[3], s.lr), k.wd));
  int64_t start, end;
  chunk_bounds(n, region_elems, start, end);
  const int64_t vend = start + ((end > start ? end - start : 0) & ~int64_t(kVec - 1));
  for (int64_t i = start + threadIdx.x * kVec; i < vend; i += kThreads * kVec) {
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    load8(p + i, pv);
    load8(g + i, gv);
    load8(m + i, mv);
    load8(v + i, vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) adam_elem(pv[j], gv[j], mv[j], vv[j], k, s);
    store8(p + i, pv);
    store8(m + i, mv);
    store8(v + i, vv);
  }
  for (int64_t i = vend + threadIdx.x; i < end; i += kThreads) {
    float pe = p[i], me = load1(m + i), ve = load1(v + i);
    adam_elem(pe, load1(g + i), me, ve, k, s);
    p[i] = pe;
    store1(m + i, me);
    store1(v + i, ve);
  }
}

template <typename TG, typename TM>
void launch_update(dim3 grid, cudaStream_t s, void* p, const void* g, void* m, void* v,
                   const float* sc, const Coef& k, int64_t n, int64_t region_elems, int chunks,
                   const float* chunk_parts, float* region_parts) {
  if (chunk_parts != nullptr)
    adam_update_kernel<TG, TM, true><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const TG*>(g), static_cast<TM*>(m),
        static_cast<TM*>(v), sc, k, n, region_elems, chunks, chunk_parts, region_parts);
  else
    adam_update_kernel<TG, TM, false><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const TG*>(g), static_cast<TM*>(m),
        static_cast<TM*>(v), sc, k, n, region_elems, chunks, nullptr, nullptr);
}

bool valid_dtype(int d) { return d == kF32 || d == kBF16; }

bool valid_layout(long long n, long long region_elems, int regions, int chunks) {
  return n > 0 && region_elems > 0 && regions > 0 && regions <= kMaxRegions && chunks > 0 &&
         static_cast<long long>(regions - 1) * region_elems < n &&
         static_cast<long long>(regions) * region_elems >= n &&
         static_cast<long long>(chunks) * kChunk >= region_elems &&
         (regions == 1 || region_elems % kVec == 0);
}

}  // namespace

// Elements one block handles: the caller sizes chunks = ceil(region_elems
// / adam_chunk_elems()) and the [regions, chunks] f32 partials from it.
extern "C" int adam_chunk_elems() { return kChunk; }

// chunk_parts[r * chunks + c] = f32 sum of g*g over chunk c of region r;
// g is a contiguous array of n elements cut into regions of region_elems.
extern "C" int adam_sumsq(const void* g, int g_dtype, long long n, long long region_elems,
                          int regions, int chunks, void* chunk_parts, int device, void* stream) {
  if (!valid_dtype(g_dtype) || !valid_layout(n, region_elems, regions, chunks) ||
      chunk_parts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, regions);
  float* parts = static_cast<float*>(chunk_parts);
  if (g_dtype == kBF16)
    adam_sumsq_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), n, region_elems, chunks, parts);
  else
    adam_sumsq_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(g), n,
                                                         region_elems, chunks, parts);
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step of the contiguous f32 p (n elements) in place, with g
// (g_dtype) and the moments m, v (m_dtype, both alike) of the same
// layout, sc the 4-float device scalars. With chunk_parts (from
// adam_sumsq on the same layout) the update is guarded: region r's total
// goes to region_parts[r], and a region whose total is not finite is
// left as it was. chunk_parts null: every region is updated.
extern "C" int adam_update(void* p, const void* g, void* m, void* v, const void* sc, int g_dtype,
                           int m_dtype, long long n, long long region_elems, int regions,
                           int chunks, float beta1, float beta2, float one_minus_beta1,
                           float one_minus_beta2, float eps, float weight_decay,
                           const void* chunk_parts, void* region_parts, int device,
                           void* stream) {
  if (!valid_dtype(g_dtype) || !valid_dtype(m_dtype) ||
      !valid_layout(n, region_elems, regions, chunks) || sc == nullptr ||
      (chunk_parts != nullptr && region_parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, regions);
  const Coef k{beta1, beta2, one_minus_beta1, one_minus_beta2, eps, weight_decay};
  const float* scf = static_cast<const float*>(sc);
  const float* cp = static_cast<const float*>(chunk_parts);
  float* rp = static_cast<float*>(region_parts);
  using bf16 = __nv_bfloat16;
  if (g_dtype == kBF16) {
    if (m_dtype == kBF16)
      launch_update<bf16, bf16>(grid, s, p, g, m, v, scf, k, n, region_elems, chunks, cp, rp);
    else
      launch_update<bf16, float>(grid, s, p, g, m, v, scf, k, n, region_elems, chunks, cp, rp);
  } else {
    if (m_dtype == kBF16)
      launch_update<float, bf16>(grid, s, p, g, m, v, scf, k, n, region_elems, chunks, cp, rp);
    else
      launch_update<float, float>(grid, s, p, g, m, v, scf, k, n, region_elems, chunks, cp, rp);
  }
  return static_cast<int>(cudaGetLastError());
}
