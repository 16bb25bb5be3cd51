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
// tables are small. At a window of 3 plus 2 global blocks of 64 over 4096
// tokens (d 128, bf16) bytes bound it (134 MB, 40 us at 3.35 TB/s, against
// 21 us of tensor-core work); at blocks of 512 over 16384 tokens the
// products do (200 GFLOP, 202 us at 989 TFLOP/s). This kernel reaches
// neither: it is the simple, right first version.
//
// Design. The Pallas grid walks (b*h, q-block, step) with the step axis in
// order, the tables kt[qi, j] (the j-th active k-block of mask row qi,
// padded with the row's last one so the TPU elides the DMA) and cnt[qi]
// in scalar prefetch, and carries (acc, m, l) across steps in VMEM. Here
// a block of four warps owns 64 query rows of one (b, h), as the flash
// forward does: the mask's block_q is a multiple of 64, so those rows lie
// in one mask row qi. The block reads cnt[qi] and walks kt[qi, 0:cnt[qi]]
// only (the padded entries are skipped, not re-read), each active k-block
// in 64-key steps of the flash forward's online softmax (fwd_step in
// attention_tiles.cuh), so mask blocks of 64 to 512 tokens take one
// kernel. Nothing is summed across blocks: no atomics, the same result
// every run.
//
// Numerics are the reference kernel's: no token-level mask inside an
// active block (causal masks act at block level), keys at or past seq_k
// masked, p rounded to v's type before p @ v with f32 accumulation, a row
// with no active block writes o = 0 and lse = -1e30 * ln2; rows past
// seq_q are not written.
//
// The entry point launches on the stream it is given, does not
// synchronise, and returns cudaGetLastError().

#include "attention_tiles.cuh"

namespace {

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
// head) strides in elements of q, k, v, o. lse: contiguous [batch*heads,
// seq_q] f32. kt: contiguous int32 [ceil(seq_q / block_q), max_active],
// cnt: int32 [ceil(seq_q / block_q)], both on the device. block_q and
// block_k are multiples of 64 up to 512; head_dim is 64 or 128.
extern "C" int bsa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       const void* kt, const void* cnt, const long long* strides, int batch,
                       int heads, int seq_q, int seq_k, int head_dim, int dtype, int block_q,
                       int block_k, int max_active, float scale, int device, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 || batch * heads > 65535 ||
      max_active <= 0 || !valid_block(block_q) || !valid_block(block_k) ||
      (head_dim != 64 && head_dim != 128) || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define BSA_LAUNCH(T, D)                                                                     \
  launch_bsa<T, D>(q, k, v, o, lse, kt, cnt, strides, batch, heads, seq_q, seq_k, block_q, \
                   block_k, max_active, scale, s)
  if (dtype == kBF16)
    err = head_dim == 128 ? BSA_LAUNCH(bf16, 128) : BSA_LAUNCH(bf16, 64);
  else
    err = head_dim == 128 ? BSA_LAUNCH(float, 128) : BSA_LAUNCH(float, 64);
#undef BSA_LAUNCH
  return static_cast<int>(err);
}
