// Dropout's keep mask for Hopper (sm_90a), with a plain C interface.
//
// rng_keep_mask replaces no Pallas kernel: it is the XLA fusion that the
// reference's dropout compiles to, jax.random.bernoulli(next_key(),
// 1 - p, shape) (paddle_tpu/nn/functional/common.py:141, the attention
// probabilities' mask at paddle_tpu/nn/functional/transformer.py:39-42),
// with next_key()'s split of the global key folded in. Without it the
// mask is the plain torch threefry of framework/random.py: twenty rounds
// of some five int64 elementwise ops over every counter pair, over a
// hundred passes over the [4, 16, 1024, 1024] attention mask of each
// layer of GPT-1.3B.
//
// What it computes, bit for bit with the installed jax (threefry-2x32,
// jax_threefry_partitionable True):
//   new_key, sub = split(key)      key i of the split is threefry(key, (0, i))
//   bits[i]      = w1 ^ w2         (w1, w2) = threefry(sub, (i >> 32, i & 0xFFFFFFFF))
//   keep[i]      = float((bits[i] >> 9) | 0x3F800000) - 1 < keep_prob
// where i is an element's row-major index and keep_prob the f32 that
// jax rounds 1 - p to. The key is two words held as int64 in device
// memory (the global key tensor): every block reads it and derives sub
// itself, block 0 writes the new key and sub to their own buffers (the
// caller copies the new key over the old one after the launch, so no
// block can read a half-advanced key), and nothing is read back to the
// host, so a CUDA graph can capture the launch and each replay draws
// from the key the last replay left.
//
// What bounds it on an H100: integer operations. An element costs one
// threefry-2x32 (20 rounds of an add, a funnel-shift rotate and a xor,
// 5 key injections of two adds) and some eight more for the counter,
// the bits, the compare and the store: about 80 int32 operations,
// against 1 to 4 bytes written. The card's 64 int32 lanes an SM make
// that some 0.3 ms for the 67 M elements of an attention mask, eight
// times the bytes' time. So the design keeps each counter pair in
// registers, reads nothing but the two key words, and writes each
// thread's 16 bytes of mask (16 bool, 8 bf16/f16 or 4 f32 values) with
// one vector store.
//
// The entry point launches on the stream it is given, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;      // a grid-stride walk past this
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kOneF32 = 0x3F800000u;

enum OutType { kBool = 0, kF32 = 1, kBF16 = 2, kF16 = 3 };

struct Words {
  uint32_t a, b;
};

// jax's two rotation sets, alternating between key injections; every
// call site is unrolled, so i and j are constants here
__device__ __forceinline__ int rotation(int i, int j) {
  return (i & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// threefry-2x32 of the counter (x0, x1) under the key (k0, k1):
// jax._src.prng._threefry2x32_lowering
__device__ __forceinline__ Words threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

// one keep value's bits in the output type (T an unsigned word of its
// width): `one` where the element is kept, 0 where it is dropped
template <typename T>
__global__ void __launch_bounds__(kThreads)
    keep_mask_kernel(const long long* __restrict__ key, long long* __restrict__ new_key,
                     long long* __restrict__ sub_out, T* __restrict__ out, long long n,
                     float keep_prob, T one) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ uint32_t sub[2];
  if (threadIdx.x == 0) {
    const uint32_t k0 = static_cast<uint32_t>(key[0]);
    const uint32_t k1 = static_cast<uint32_t>(key[1]);
    const Words s = threefry(k0, k1, 0u, 1u);
    sub[0] = s.a;
    sub[1] = s.b;
    if (blockIdx.x == 0) {
      const Words k = threefry(k0, k1, 0u, 0u);
      new_key[0] = k.a;
      new_key[1] = k.b;
      sub_out[0] = s.a;
      sub_out[1] = s.b;
    }
  }
  __syncthreads();
  const uint32_t s0 = sub[0], s1 = sub[1];
  const long long vecs = (n + kVec - 1) / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < vecs;
       v += stride) {
    const long long base = v * kVec;
    union {
      T e[kVec];
      uint4 all;
    } vals;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const unsigned long long i = static_cast<unsigned long long>(base + e);
      const Words w = threefry(s0, s1, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
      const uint32_t bits = w.a ^ w.b;
      const float u = __fsub_rn(__uint_as_float((bits >> 9) | kOneF32), 1.0f);
      vals.e[e] = u < keep_prob ? one : T(0);
    }
    if (base + kVec <= n) {
      *reinterpret_cast<uint4*>(out + base) = vals.all;
    } else {
      for (int e = 0; e < kVec && base + e < n; ++e) out[base + e] = vals.e[e];
    }
  }
}

template <typename T>
void launch(cudaStream_t s, const void* key, void* new_key, void* sub, void* out, long long n,
            float keep_prob, T one) {
  constexpr int kVec = 16 / sizeof(T);
  const long long vecs = (n + kVec - 1) / kVec;
  long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // n == 0: the split alone
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  keep_mask_kernel<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const long long*>(key), static_cast<long long*>(new_key),
      static_cast<long long*>(sub), static_cast<T*>(out), n, keep_prob, one);
}

}  // namespace

// key: the 2 int64 words of the global key; new_key, sub: 2 int64 words
// each, written with split(key); out: n values of out_type (kBool: 1/0
// bytes; kF32, kBF16, kF16: 1.0/0.0), 16-byte aligned, null when n is 0.
extern "C" int rng_keep_mask(const void* key, void* new_key, void* sub, void* out, int out_type,
                             long long n, float keep_prob, int device, void* stream) {
  if (key == nullptr || new_key == nullptr || sub == nullptr || n < 0 ||
      (n > 0 && (out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_type) {
    case kBool:
      launch<uint8_t>(s, key, new_key, sub, out, n, keep_prob, 1);
      break;
    case kF32:
      launch<uint32_t>(s, key, new_key, sub, out, n, keep_prob, kOneF32);
      break;
    case kBF16:
      launch<uint16_t>(s, key, new_key, sub, out, n, keep_prob, 0x3F80);
      break;
    case kF16:
      launch<uint16_t>(s, key, new_key, sub, out, n, keep_prob, 0x3C00);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
