// LayerNorm kernels for Hopper (sm_90a), with a plain C interface.
//
// ln_fwd replaces paddle_tpu/ops/pallas/norm.py:_ln_kernel (the Pallas
// kernel behind fused_layer_norm). ln_res_fwd replaces
// paddle_tpu/ops/pallas/norm.py:_ln_res_kernel (behind fused_ln_residual
// and fused_add_layer_norm). ln_bwd replaces both backward kernels,
// :_ln_bwd_kernel_plain and :_ln_bwd_kernel_res, which share one body
// (_ln_bwd_core, driven by _ln_bwd_pallas); a null gh selects the plain
// variant. rms_fwd replaces :_rms_kernel (behind fused_rms_norm; the
// reference's RMSNorm backward is jnp, so the port's is a PyTorch
// composition).
//
// What bounds them on an H100: bytes. With e the element size, ln_fwd
// reads R*H*e and writes R*H*e; ln_res_fwd reads 2*R*H*e (x and r) and
// writes 2*R*H*e (h and y); both also read 2*H weights. ln_bwd reads h and
// gy (and gh) and writes dx: 3*R*H*e (4 with gh), plus its f32 partials.
// The arithmetic is a few operations per element, far below the card's
// rate per byte.
//
// Forward design (ln_fwd_kernel, both forwards). At the main path's
// shapes (hidden 2048: decode 8 rows, prefill 64-900, the train step
// 4096) a launch is short, and below ~1000 rows what bounds it is
// latency: the chain of memory round trips and reductions a row waits
// on, not the bytes. The first design (a warp a row, four rows a block,
// w and b loaded after the statistics) put 8 decode rows on 2 SMs
// behind two round trips. This one:
//   - gives a row a team of hidden/8 threads, one 16-byte chunk a lane
//     (256 at 2048): 8 decode rows run on 8 SMs;
//   - issues every load before the first reduction: w and b once a
//     thread, held in registers, and each next row's x (and r) while this
//     one is reduced, so after the statistics only stores touch memory;
//   - launches one wave of resident blocks (two 512-thread blocks an SM
//     at <= 64 registers) that walk the rows in a grid stride, so 4096
//     rows leave no ragged last wave and each thread loads w and b once;
//   - takes gelu as a template parameter.
// Two passes over the registers give the mean and then the mean of
// squared deviations, never E[x^2] - mean^2. The sums run in an order
// fixed by hidden alone, so every run and every row count gives the
// same bits. Each element crosses device memory once each way.
//
// Backward design (ln_bwd_kernel + ln_bwd_sum_kernel). What bounds it on
// an H100 at the training path's shape (4096 x 2048 bf16, 25 + 24 calls
// a GPT-1.3B step) is bytes in flight: each row is a chain of dependent
// loads and block reductions, so the kernel runs at the rate its
// outstanding loads allow, not at the memory's. The first design (one row
// at a time per block, three reductions of two barriers each, 2 blocks an
// SM, per-block partials summed by torch) ran at 27 % of the byte bound.
// This one:
//   - a block of `slots` rows x hidden/8 threads (512 at most), each
//     thread 8 columns; two blocks an SM at 64 registers;
//   - each thread copies its chunks of the next row into a ring in shared
//     memory with cp.async while the block reduces this one (no register
//     holds a prefetched row; a thread reads back only what it copied);
//   - two reductions a row without gelu (sum(x), then sum((x-mean)^2),
//     sum(gw) and sum(gw*(x-mean)) in one pass), each one barrier with
//     double-buffered partials; three with gelu, whose gy needs xhat;
//   - dw/db summed per thread in shared memory, the slots added in order,
//     one f32 partial row per block; ln_bwd_sum_kernel adds the partial
//     rows in a fixed order and casts to the weights' type: no atomics, so
//     the result is the same on every run.
// norm.py:ln_bwd_split picks the slots and the run of rows a block takes.
//
// RMSNorm forward design: y = x * rsqrt(mean(x^2) + eps) * w reads R*H*e
// and writes R*H*e (bytes bound it, as LayerNorm's). Its users run rows
// wider than a warp's registers hold (LLaMA's 4096, 5120, 8192), so a
// block of H/32 threads (rounded up to a warp; H <= 16384) owns a row,
// each thread up to four 8-element chunks in registers, one row-sum
// reduction through the warps' shuffles and one fixed-order shared-memory
// pass. Each element crosses device memory once each way.
//
// Every entry point launches on the stream it is given, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;         // elements a lane moves per step
constexpr int kMaxHidden = 4096;  // ln_bwd: hidden/8 threads a row, <= 512
constexpr int kRmsChunks = 4;       // rms_fwd: chunks a thread holds
constexpr int kRmsMaxThreads = 512; // rms_fwd: hidden <= 512 * 4 * 8 = 16384

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void load_chunk(const float* p, float v[kChunk]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float v[kChunk]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    v[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}

__device__ __forceinline__ void store_chunk(float* p, const float v[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float v[kChunk]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// tanh-form gelu, constants as in paddle_tpu/ops/pallas/norm.py:_gelu_grad
__device__ __forceinline__ float gelu_tanh(float u) {
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  const float c = 0.044715f;
  const float t = tanhf(k * (u + c * u * u * u));
  return 0.5f * u * (1.0f + t);
}

// ------------------------------------------------------ LayerNorm forwards
constexpr int kFwdMaxThreads = 512;  // a block: a row of hidden/8 threads, <= 16 warps
constexpr int kFwdBlocksPerSm = 2;   // of 512 threads: <= 64 registers a thread

// A chunk's 8 elements as loaded: one 16-byte word (bf16) or two (f32).
template <typename T>
struct Raw {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void fetch(const T* p, Raw<T>& c) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i) c.u[i] = q[i];
}

__device__ __forceinline__ void unpack(const Raw<float>& c, float v[kChunk]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(c.u[i].x);
    v[4 * i + 1] = __uint_as_float(c.u[i].y);
    v[4 * i + 2] = __uint_as_float(c.u[i].z);
    v[4 * i + 3] = __uint_as_float(c.u[i].w);
  }
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& c, float v[kChunk]) {
  const uint32_t w[4] = {c.u[0].x, c.u[0].y, c.u[0].z, c.u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);  // a bf16 is the high half of an f32
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The sum over a row of its lanes' values: each warp's by a butterfly,
// then the warps' in order through red (one float a warp; callers
// alternate two, so one barrier a call suffices).
__device__ __forceinline__ float row_sum(float part, float* red, int warp, int warps) {
  const float s = warp_sum(part);
  if (warps == 1) return s;
  if ((threadIdx.x & 31) == 0) red[warp] = s;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < warps; ++i) total += red[i];
  return total;
}

// Both forwards, _ln_kernel (RES false) and _ln_res_kernel (RES true):
// h = x + r in f32 (RES), y = act((v - mean) * rstd * w + b) with
// v = x or h, the mean and then the mean of squared deviations of the f32
// v (never E[v^2] - mean^2), act = tanh-gelu when GELU. w == nullptr: no
// affine (b ignored); b == nullptr: zero bias.
//
// A row belongs to a team of hidden/8 threads (rounded up to a warp),
// lane l of warp k holding chunk 32k + l. A team of several warps is a
// block, and its reductions cross the warps through shared memory under
// a block barrier; one-warp teams go blockDim.x / 32 to a block. Team s of
// block i takes row i * slots + s, then every gridDim.x * slots-th row
// after it (norm.py:ln_fwd_split sizes the grid to the resident blocks).
// The team, and so the order of every sum, depends on hidden alone: a
// row's bits do not depend on the row count.
//
// Every load a row needs is issued before its first reduction: w and b
// once a thread, before its first row, into registers kept across rows;
// the first row with them; each later row's x (and r) while the row
// before it is reduced. After the statistics only stores touch memory.
template <typename TX, typename TR, typename TO, typename TW, bool RES, bool GELU>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdBlocksPerSm)
    ln_fwd_kernel(const TX* __restrict__ x, const TR* __restrict__ r,
                  const TW* __restrict__ w, const TW* __restrict__ b, TO* __restrict__ h_out,
                  TO* __restrict__ y, int rows, int hidden, float eps) {
  __shared__ float red[2][kFwdMaxThreads / 32];
  const int nchunks = hidden / kChunk;
  const int warps = (nchunks + 31) / 32;  // a row's team
  const int warp = (threadIdx.x >> 5) % warps;
  const int slots = blockDim.x / (32 * warps);
  const int stride = gridDim.x * slots;
  const int chunk = warp * 32 + (threadIdx.x & 31);
  const bool has = chunk < nchunks;
  const int col = chunk * kChunk;
  const float n = static_cast<float>(hidden);
  int row = blockIdx.x * slots + (threadIdx.x >> 5) / warps;

  Raw<TX> xr;
  Raw<TR> rr;
  auto fetch_row = [&](int at) {
    if (!has) return;
    const size_t i = static_cast<size_t>(at) * hidden + col;
    fetch(x + i, xr);
    if (RES) fetch(r + i, rr);
  };
  if (row < rows) fetch_row(row);
  Raw<TW> wr, br;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(TW) / 2); ++i)
    wr.u[i] = br.u[i] = make_uint4(0u, 0u, 0u, 0u);
  if (has && w != nullptr) {
    fetch(w + col, wr);
    if (b != nullptr) fetch(b + col, br);
  }

  for (; row < rows; row += stride) {
    const size_t at = static_cast<size_t>(row) * hidden + col;
    float v[kChunk];
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = 0.0f;
    if (has) {
      unpack(xr, v);
      if (RES) {
        float rv[kChunk];
        unpack(rr, rv);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) v[e] += rv[e];
        store_chunk(h_out + at, v);
      }
#pragma unroll
      for (int e = 0; e < kChunk; ++e) part += v[e];
    }
    if (row + stride < rows) fetch_row(row + stride);
    const float mean = row_sum(part, red[0], warp, warps) / n;
    part = 0.0f;
    if (has) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const float d = v[e] - mean;
        v[e] = d;
        part += d * d;
      }
    }
    const float rstd = rsqrtf(row_sum(part, red[1], warp, warps) / n + eps);
    if (has) {
      float o[kChunk];
      if (w == nullptr) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) o[e] = v[e] * rstd;
      } else {
        float wv[kChunk], bv[kChunk];
        unpack(wr, wv);
        unpack(br, bv);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) o[e] = v[e] * rstd * wv[e] + bv[e];
      }
      if (GELU) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) o[e] = gelu_tanh(o[e]);
      }
      store_chunk(y + at, o);
    }
  }
}

// d gelu(u) / du for the tanh form (paddle_tpu/ops/pallas/norm.py:_gelu_grad)
__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float k = 0.7978845608028654f;
  const float c = 0.044715f;
  const float t = tanhf(k * (u + c * u * u * u));
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * k * (1.0f + 3.0f * c * u * u);
}

// Sums of a and b over the block, the same on every thread, summed in a
// fixed order. red holds 2 * 32 floats (at most 32 warps).
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
  for (int i = 0; i < nwarps; ++i) {
    s.x += red[i];
    s.y += red[32 + i];
  }
  __syncthreads();  // red may be written again
  return s;
}

// ------------------------------------------------------ LayerNorm backward
constexpr int kBwdMaxThreads = 512;   // a block: `slots` rows of hidden/8 threads
constexpr int kBwdMaxWarps = kBwdMaxThreads / 32;
constexpr int kBwdStages = 2;         // the cp.async ring: this step and the next
constexpr int kBwdBlocksPerSm = 2;    // bf16: 2 x 512 threads at <= 64 registers

// An async 16-byte copy global -> shared, with its group commit and wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NV sums over the threads of this thread's row slot (warps_per_slot
// consecutive warps), the same on every thread of the slot, summed in a
// fixed order. red: [4][kBwdMaxWarps] floats; callers alternate two
// buffers, so one barrier a call suffices (a buffer is written again only
// after the next call's barrier, when every read of it is done).
template <int NV>
__device__ __forceinline__ void slot_sum(float (&v)[NV], float* red, int warps_per_slot) {
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i * kBwdMaxWarps + warp] = v[i];
  }
  __syncthreads();
  const int w0 = warp - warp % warps_per_slot;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.0f;
    for (int k = 0; k < warps_per_slot; ++k) s += red[i * kBwdMaxWarps + w0 + k];
    v[i] = s;
  }
}

// Dynamic shared memory of ln_bwd_kernel: the ring, [kBwdStages][tensors]
// [threads] chunks of 8 elements (tensors: h, gy and, with gh, gh).
template <typename TH>
constexpr int bwd_smem(int threads, int tensors) {
  return kBwdStages * tensors * threads * kChunk * static_cast<int>(sizeof(TH));
}

// LayerNorm backward from the saved pre-norm rows h (_ln_bwd_core):
// recompute mean, rstd and xhat; with gelu, gy *= gelu'(xhat*w + b);
// dx = rstd * (gy*w - mean(gy*w) - xhat * mean(gy*w*xhat)) (+ gh);
// dw = sum(gy * xhat), db = sum(gy) as one f32 partial row per block.
//
// A block holds `slots` rows at once, hidden/8 threads (rounded up to a
// warp) a row, each thread 8 columns; it walks the rows
// [blockIdx.x * rows_per_block, + rows_per_block), slot s taking every
// slots-th row from s. Each thread copies its chunks of h, gy (and gh)
// kBwdStages - 1 steps ahead into a ring in shared memory with cp.async,
// so rows stay in flight through the block's reductions without holding
// registers. A thread reads only the chunks it copied itself: the ring
// needs no barrier. Without gelu a row needs two reductions: sum(x) for
// the mean, then sum((x-mean)^2), sum(gw) and sum(gw*(x-mean)) together,
// since sum(gw*xhat) = rstd * sum(gw*(x-mean)). With gelu, gy depends on
// xhat, so sum((x-mean)^2) comes first and the two gw sums after it.
template <typename TH, typename TW>
__global__ void __launch_bounds__(kBwdMaxThreads, sizeof(TH) == 2 ? kBwdBlocksPerSm : 1)
    ln_bwd_kernel(const TH* __restrict__ h, const TH* __restrict__ gy,
                  const TH* __restrict__ gh, const TW* __restrict__ w,
                  const TW* __restrict__ b, TH* __restrict__ dx, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int rows, int hidden, int rows_per_block,
                  int slots, float eps, int gelu) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float red[2][4 * kBwdMaxWarps];
  // this thread's running dw and db sums, [2 * kChunk][blockDim.x]: kept in
  // shared memory, not registers, so two blocks of 512 threads fit an SM
  __shared__ float acc[2 * kChunk * kBwdMaxThreads];
  constexpr int kCopies = kChunk * sizeof(TH) / 16;  // 16-byte copies a chunk
  const int tensors = gh != nullptr ? 3 : 2;
  const int per_slot = blockDim.x / slots;  // threads a row
  const int slot = threadIdx.x / per_slot;
  const int col = (threadIdx.x % per_slot) * kChunk;
  const bool active = col < hidden;
  const int warps_per_slot = per_slot >> 5;
  const float n = static_cast<float>(hidden);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const int steps = (r1 - r0 + slots - 1) / slots;
  float* mine = acc + threadIdx.x;  // element e at mine[e * blockDim.x]
#pragma unroll
  for (int e = 0; e < 2 * kChunk; ++e) mine[e * blockDim.x] = 0.0f;
  // this thread's chunk of tensor i in stage st
  auto chunk = [&](int st, int i) {
    return reinterpret_cast<TH*>(ring) + ((st * tensors + i) * blockDim.x + threadIdx.x) * kChunk;
  };
  // copy the chunks of step `step` (if its row exists) and close a group
  auto fetch = [&](int step) {
    const int row = r0 + step * slots + slot;
    if (active && step < steps && row < r1) {
      const size_t at = static_cast<size_t>(row) * hidden + col;
      const int st = step % kBwdStages;
#pragma unroll
      for (int c = 0; c < kCopies; ++c) {
        cp_async16(chunk(st, 0) + c * 16 / sizeof(TH), h + at + c * 16 / sizeof(TH));
        cp_async16(chunk(st, 1) + c * 16 / sizeof(TH), gy + at + c * 16 / sizeof(TH));
        if (gh != nullptr)
          cp_async16(chunk(st, 2) + c * 16 / sizeof(TH), gh + at + c * 16 / sizeof(TH));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kBwdStages - 1; ++st) fetch(st);
  int buf = 0;
  for (int step = 0; step < steps; ++step) {
    fetch(step + kBwdStages - 1);
    cp_async_wait<kBwdStages - 1>();  // this step's group has landed
    const int row = r0 + step * slots + slot;
    const bool live = active && row < r1;
    const int st = step % kBwdStages;
    float xv[kChunk], gv[kChunk];
    if (live) {
      load_chunk(chunk(st, 0), xv);
      load_chunk(chunk(st, 1), gv);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) xv[e] = gv[e] = 0.0f;
    }

    float s1[1] = {0.0f};
#pragma unroll
    for (int e = 0; e < kChunk; ++e) s1[0] += xv[e];
    slot_sum(s1, red[buf], warps_per_slot);
    buf ^= 1;
    const float mean = s1[0] / n;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) xv[e] = live ? xv[e] - mean : 0.0f;  // x - mean
    float wv[kChunk];
    if (active) {
      load_chunk(w + col, wv);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) wv[e] = 0.0f;
    }
    float rstd, m1, m2;
    if (!gelu) {
      float s3[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const float gw = gv[e] * wv[e];
        s3[0] += xv[e] * xv[e];
        s3[1] += gw;
        s3[2] += gw * xv[e];
      }
      slot_sum(s3, red[buf], warps_per_slot);
      buf ^= 1;
      rstd = rsqrtf(s3[0] / n + eps);
      m1 = s3[1] / n;
      m2 = rstd * s3[2] / n;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) xv[e] *= rstd;  // xhat
    } else {
      float sq[1] = {0.0f};
#pragma unroll
      for (int e = 0; e < kChunk; ++e) sq[0] += xv[e] * xv[e];
      slot_sum(sq, red[buf], warps_per_slot);
      buf ^= 1;
      rstd = rsqrtf(sq[0] / n + eps);
      float bv[kChunk];
      if (active && b != nullptr) {
        load_chunk(b + col, bv);
      } else {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) bv[e] = 0.0f;
      }
      float s2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        xv[e] *= rstd;  // xhat
        gv[e] *= gelu_tanh_grad(xv[e] * wv[e] + bv[e]);
        const float gw = gv[e] * wv[e];
        s2[0] += gw;
        s2[1] += gw * xv[e];
      }
      slot_sum(s2, red[buf], warps_per_slot);
      buf ^= 1;
      m1 = s2[0] / n;
      m2 = s2[1] / n;
    }
    if (live) {
      float d[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        d[e] = rstd * (gv[e] * wv[e] - m1 - xv[e] * m2);
        mine[e * blockDim.x] += gv[e] * xv[e];
        mine[(kChunk + e) * blockDim.x] += gv[e];
      }
      if (gh != nullptr) {
        float ghv[kChunk];
        load_chunk(chunk(st, 2), ghv);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) d[e] += ghv[e];
      }
      store_chunk(dx + static_cast<size_t>(row) * hidden + col, d);
    }
  }
  cp_async_wait<0>();
  // the slots' sums, added in slot order: one partial row per block
  if (r0 >= r1) return;
  __syncthreads();
  if (slot == 0 && active) {
    float dwa[kChunk], dba[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      dwa[e] = mine[e * blockDim.x];
      dba[e] = mine[(kChunk + e) * blockDim.x];
    }
    for (int k = 1; k < slots; ++k) {
      const float* other = mine + k * per_slot;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        dwa[e] += other[e * blockDim.x];
        dba[e] += other[(kChunk + e) * blockDim.x];
      }
    }
    const size_t at = static_cast<size_t>(blockIdx.x) * hidden + col;
    store_chunk(dw_part + at, dwa);
    store_chunk(db_part + at, dba);
  }
}

// dw = sum of the n_parts partial rows (and db, when db != nullptr), in
// the weights' type. A block of 32 columns x 32 row slices: slice y sums
// parts y, y + 32, ... and slice 0 adds the 32 slices in order, so the
// result is the same on every run.
constexpr int kSumCols = 32, kSumSlices = 32;

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TW>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
    ln_bwd_sum_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                      TW* __restrict__ dw, TW* __restrict__ db, int n_parts, int hidden) {
  __shared__ float part[2][kSumSlices][kSumCols + 1];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  float sw = 0.0f, sb = 0.0f;
  if (c < hidden) {
#pragma unroll 4
    for (int i = threadIdx.y; i < n_parts; i += kSumSlices) {
      sw += dw_part[static_cast<size_t>(i) * hidden + c];
      if (db != nullptr) sb += db_part[static_cast<size_t>(i) * hidden + c];
    }
  }
  part[0][threadIdx.y][threadIdx.x] = sw;
  part[1][threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y == 0 && c < hidden) {
    float tw = 0.0f, tb = 0.0f;
    for (int y = 0; y < kSumSlices; ++y) {
      tw += part[0][y][threadIdx.x];
      tb += part[1][y][threadIdx.x];
    }
    store_one(dw + c, tw);
    if (db != nullptr) store_one(db + c, tb);
  }
}

// RMSNorm forward (_rms_kernel): ms = mean(x^2) in f32 over the row,
// y = (x * rsqrt(ms + eps)) * w (w == nullptr: no weight), in x's type.
// Thread i holds chunks i, i + blockDim, ... (at most kRmsChunks).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kRmsMaxThreads)
    rms_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
                   int hidden, float eps) {
  __shared__ float red[64];
  const int nchunks = hidden / kChunk;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  float v[kRmsChunks][kChunk];
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kRmsChunks; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c < nchunks) {
      load_chunk(x + base + c * kChunk, v[j]);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) sq += v[j][e] * v[j][e];
    }
  }
  const float rstd = rsqrtf(block_sum2(sq, 0.0f, red).x / static_cast<float>(hidden) + eps);
#pragma unroll
  for (int j = 0; j < kRmsChunks; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c < nchunks) {
      float o[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e) o[e] = v[j][e] * rstd;
      if (w != nullptr) {
        float wv[kChunk];
        load_chunk(w + c * kChunk, wv);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) o[e] *= wv[e];
      }
      store_chunk(y + base + c * kChunk, o);
    }
  }
}

// A launch of ln_fwd_kernel: `slots` rows a block at once (1 unless a
// row's team is one warp), `blocks` blocks (norm.py:ln_fwd_split).
struct FwdSplit {
  int slots, blocks;
};

bool valid_split(const FwdSplit& s, int hidden) {
  const int warps = (hidden / kChunk + 31) / 32;
  return s.slots >= 1 && s.blocks >= 1 && (warps == 1 || s.slots == 1) &&
         32 * warps * s.slots <= kFwdMaxThreads;
}

template <typename TX, typename TR, typename TO, typename TW, bool RES, bool GELU>
void launch_fwd(const FwdSplit& s, const void* x, const void* r, const void* w, const void* b,
                void* h, void* y, int rows, int hidden, float eps, cudaStream_t stream) {
  const int threads = 32 * ((hidden / kChunk + 31) / 32) * s.slots;
  ln_fwd_kernel<TX, TR, TO, TW, RES, GELU><<<s.blocks, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(r), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<TO*>(h), static_cast<TO*>(y), rows, hidden, eps);
}

template <typename TX, typename TR, typename TO, typename TW>
void dispatch_res(const FwdSplit& s, const void* x, const void* r, const void* w, const void* b,
                  void* h, void* y, int rows, int hidden, float eps, int gelu,
                  cudaStream_t stream) {
  if (gelu)
    launch_fwd<TX, TR, TO, TW, true, true>(s, x, r, w, b, h, y, rows, hidden, eps, stream);
  else
    launch_fwd<TX, TR, TO, TW, true, false>(s, x, r, w, b, h, y, rows, hidden, eps, stream);
}

// The output type of ln_res_fwd is promote_types(x, r): bf16 only when
// both inputs are bf16.
template <typename TW>
void dispatch_res_inputs(const FwdSplit& s, int x_dtype, int r_dtype, const void* x,
                         const void* r, const void* w, const void* b, void* h, void* y, int rows,
                         int hidden, float eps, int gelu, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == kBF16 && r_dtype == kBF16)
    dispatch_res<bf16, bf16, bf16, TW>(s, x, r, w, b, h, y, rows, hidden, eps, gelu, stream);
  else if (x_dtype == kBF16)
    dispatch_res<bf16, float, float, TW>(s, x, r, w, b, h, y, rows, hidden, eps, gelu, stream);
  else if (r_dtype == kBF16)
    dispatch_res<float, bf16, float, TW>(s, x, r, w, b, h, y, rows, hidden, eps, gelu, stream);
  else
    dispatch_res<float, float, float, TW>(s, x, r, w, b, h, y, rows, hidden, eps, gelu, stream);
}

bool valid_dtype(int d) { return d == kF32 || d == kBF16; }

}  // namespace

// y = LN(x) * w + b over the last axis of a contiguous [rows, hidden]
// x. w and b may be null (no affine; b alone null: zero bias). y has
// x's type. slots and blocks split the rows (norm.py:ln_fwd_split;
// FwdSplit above); hidden is a multiple of 8 up to 4096.
extern "C" int ln_fwd(const void* x, const void* w, const void* b, void* y, int rows,
                      int hidden, int slots, int blocks, int x_dtype, int w_dtype, float eps,
                      int device, void* stream) {
  const FwdSplit split{slots, blocks};
  if (rows <= 0 || hidden <= 0 || hidden % kChunk || !valid_split(split, hidden) ||
      !valid_dtype(x_dtype) || !valid_dtype(w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define LN_FWD_LAUNCH(TX, TW) \
  launch_fwd<TX, TX, TX, TW, false, false>(split, x, nullptr, w, b, nullptr, y, rows, hidden, \
                                           eps, s)
  if (x_dtype == kBF16) {
    if (w_dtype == kBF16) LN_FWD_LAUNCH(bf16, bf16); else LN_FWD_LAUNCH(bf16, float);
  } else {
    if (w_dtype == kBF16) LN_FWD_LAUNCH(float, bf16); else LN_FWD_LAUNCH(float, float);
  }
#undef LN_FWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// h = x + r; y = act(LN(h) * w + b), act = tanh-gelu when gelu != 0.
// x and r are contiguous [rows, hidden]; w is required, b may be null.
// h and y have type promote_types(x, r). The split as for ln_fwd.
extern "C" int ln_res_fwd(const void* x, const void* r, const void* w, const void* b, void* h,
                          void* y, int rows, int hidden, int slots, int blocks, int x_dtype,
                          int r_dtype, int w_dtype, int gelu, float eps, int device,
                          void* stream) {
  const FwdSplit split{slots, blocks};
  if (rows <= 0 || hidden <= 0 || hidden % kChunk || !valid_split(split, hidden) ||
      w == nullptr || !valid_dtype(x_dtype) || !valid_dtype(r_dtype) || !valid_dtype(w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == kBF16)
    dispatch_res_inputs<__nv_bfloat16>(split, x_dtype, r_dtype, x, r, w, b, h, y, rows, hidden,
                                       eps, gelu, s);
  else
    dispatch_res_inputs<float>(split, x_dtype, r_dtype, x, r, w, b, h, y, rows, hidden, eps,
                               gelu, s);
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm backward (both Pallas variants): h, gy, gh and dx are
// contiguous [rows, hidden] of one type; gh may be null (the plain
// variant, h then being the LayerNorm's input x). w is required, b may be
// null (zero; db is then not written). Block i handles rows
// [i*rows_per_block, (i+1)*rows_per_block), `slots` of them at once, and
// writes row i of the f32 scratch dw_part and db_part, each
// [ceil(rows / rows_per_block), hidden]; a second kernel sums them into
// dw and db in w's type (norm.py:ln_bwd_split picks the split).
extern "C" int ln_bwd(const void* h, const void* gy, const void* gh, const void* w,
                      const void* b, void* dx, void* dw_part, void* db_part, void* dw, void* db,
                      int rows, int hidden, int rows_per_block, int slots, int h_dtype,
                      int w_dtype, int gelu, float eps, int device, void* stream) {
  const int per_slot = ((hidden / kChunk + 31) / 32) * 32;
  if (rows <= 0 || hidden <= 0 || hidden % kChunk || hidden > kMaxHidden ||
      rows_per_block <= 0 || slots <= 0 || slots * per_slot > kBwdMaxThreads || w == nullptr ||
      dw == nullptr || (b != nullptr) != (db != nullptr) || !valid_dtype(h_dtype) ||
      !valid_dtype(w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_parts = (rows + rows_per_block - 1) / rows_per_block;
  const dim3 sum_grid((hidden + kSumCols - 1) / kSumCols), sum_block(kSumCols, kSumSlices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int smem = 0;
  using bf16 = __nv_bfloat16;
#define LN_BWD_LAUNCH(TH, TW)                                                              \
  smem = bwd_smem<TH>(slots * per_slot, gh != nullptr ? 3 : 2);                           \
  err = cudaFuncSetAttribute(ln_bwd_kernel<TH, TW>,                                       \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);           \
  if (err != cudaSuccess) return static_cast<int>(err);                                    \
  ln_bwd_kernel<TH, TW><<<n_parts, slots * per_slot, smem, s>>>(                           \
      static_cast<const TH*>(h), static_cast<const TH*>(gy), static_cast<const TH*>(gh),   \
      static_cast<const TW*>(w), static_cast<const TW*>(b), static_cast<TH*>(dx),          \
      static_cast<float*>(dw_part), static_cast<float*>(db_part), rows, hidden,            \
      rows_per_block, slots, eps, gelu);                                                   \
  err = cudaGetLastError();                                                                \
  if (err != cudaSuccess) return static_cast<int>(err);                                    \
  ln_bwd_sum_kernel<TW><<<sum_grid, sum_block, 0, s>>>(                                    \
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),              \
      static_cast<TW*>(dw), static_cast<TW*>(db), n_parts, hidden)
  if (h_dtype == kBF16) {
    if (w_dtype == kBF16) { LN_BWD_LAUNCH(bf16, bf16); } else { LN_BWD_LAUNCH(bf16, float); }
  } else {
    if (w_dtype == kBF16) { LN_BWD_LAUNCH(float, bf16); } else { LN_BWD_LAUNCH(float, float); }
  }
#undef LN_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// y = x * rsqrt(mean(x^2) + eps) * w over the last axis of a contiguous
// [rows, hidden] x; w may be null (no weight). y has x's type. hidden is a
// multiple of 8 up to 16384.
extern "C" int rms_fwd(const void* x, const void* w, void* y, int rows, int hidden,
                       int x_dtype, int w_dtype, float eps, int device, void* stream) {
  const int nchunks = hidden / kChunk;
  const int threads = ((nchunks + kRmsChunks - 1) / kRmsChunks + 31) / 32 * 32;
  if (rows <= 0 || hidden <= 0 || hidden % kChunk || threads > kRmsMaxThreads ||
      !valid_dtype(x_dtype) || !valid_dtype(w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define RMS_LAUNCH(TX, TW)                                                                  \
  rms_fwd_kernel<TX, TW><<<rows, threads, 0, s>>>(static_cast<const TX*>(x),               \
                                                  static_cast<const TW*>(w),               \
                                                  static_cast<TX*>(y), hidden, eps)
  if (x_dtype == kBF16) {
    if (w_dtype == kBF16) RMS_LAUNCH(bf16, bf16); else RMS_LAUNCH(bf16, float);
  } else {
    if (w_dtype == kBF16) RMS_LAUNCH(float, bf16); else RMS_LAUNCH(float, float);
  }
#undef RMS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
