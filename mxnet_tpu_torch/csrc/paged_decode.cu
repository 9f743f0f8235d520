// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/attention.py::_paged_pallas
// (grid (B, table slots), block table and context lengths as scalar
// prefetch steering each step's K/V DMA, online softmax in VMEM). Same
// contract: one query per sequence, q (B,H,D), pages (N,bs,H,D) float32 or
// bfloat16, block_tables (B,nb) int32, context_lens (B,) int32; out (B,H,D)
// in q's dtype. Positions >= context_len contribute exactly nothing and a
// context_len == 0 row returns exactly 0 (acc 0 over l clamped at 1e-30).
//
// What bounds it here: bytes. It reads the K and V rows of the live
// context once, sum_b ctx_b * H * D * itemsize * 2 bytes, against about
// 4 FLOP per element. The simple design reads nothing else: one thread
// block per (sequence, head) loads its own table row and context length
// (the TPU's scalar prefetch), walks the table slots in position order and
// stops at ceil(ctx/bs), so blocks past the context are never read. For
// each pool block, warp w scores tokens w, w+4, ... with a warp-shuffle dot
// product over D (neighbouring lanes read neighbouring words of a K row);
// then thread d accumulates sum_t p_t * V[t, d] (neighbouring threads read
// neighbouring words of each V row). Every (sequence, head) reduces in one
// fixed order with no atomics and no split across blocks, so a row's
// result does not depend on the batch it was launched in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;  // one thread per head dimension, D <= 128
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BS = 256;   // tokens per pool block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lens, TQ* __restrict__ out, int h,
                    int d, int num_blocks, int bs, int nb, float scale) {
  __shared__ float qs[THREADS];
  __shared__ float ss[MAX_BS];

  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qoff = ((size_t)b * h + hh) * d;

  if (tid < d) qs[tid] = to_float(q[qoff + tid]);
  const int ctx = lens[b];
  const int* row = tables + (size_t)b * nb;
  const int nblk = ctx <= 0 ? 0 : min(nb, (ctx + bs - 1) / bs);
  const size_t tok_stride = (size_t)h * d;  // one token of a pool block
  __syncthreads();

  float m = NEG_INF;
  float l = 0.f;
  float acc = 0.f;  // output dimension tid
  bool bad = false;
  for (int j = 0; j < nblk; ++j) {
    const int blk = row[j];
    if (blk < 0 || blk >= num_blocks) {  // uniform across the block
      bad = true;
      break;
    }
    const int n = min(bs, ctx - j * bs);  // live tokens of this pool block
    const size_t base = (size_t)blk * bs * tok_stride + (size_t)hh * d;
    for (int t = warp; t < n; t += WARPS) {
      const TP* kr = kp + base + t * tok_stride;
      float part = 0.f;
      for (int dd = lane; dd < d; dd += 32) part += qs[dd] * to_float(kr[dd]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) ss[t] = part * scale;
    }
    __syncthreads();
    float m_blk = NEG_INF;
    for (int t = 0; t < n; ++t) m_blk = fmaxf(m_blk, ss[t]);
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    float a = 0.f;
    for (int t = 0; t < n; ++t) {
      const float p = expf(ss[t] - m_new);
      psum += p;
      if (tid < d) a += p * to_float(vp[base + t * tok_stride + tid]);
    }
    l = l * corr + psum;
    acc = acc * corr + a;
    m = m_new;
    __syncthreads();  // ss is rewritten by the next pool block
  }
  if (tid < d) {
    // an out-of-range block id poisons the row, as jnp.take fills NaN
    const float o = bad ? NAN : acc / fmaxf(l, 1e-30f);
    out[qoff + tid] = from_float<TQ>(o);
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int b,
                   int h, int d, int num_blocks, int bs, int nb, float scale,
                   cudaStream_t stream) {
  if (d > THREADS || bs > MAX_BS) return cudaErrorInvalidValue;
  const dim3 grid(b, h);
  paged_decode_kernel<TQ, TP><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<TQ*>(out), h, d, num_blocks,
      bs, nb, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_pages(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* lens, void* out,
                           int b, int h, int d, int num_blocks, int bs, int nb,
                           float scale, int page_dtype, cudaStream_t stream) {
  if (page_dtype == 0)
    return launch<TQ, float>(q, kp, vp, tables, lens, out, b, h, d,
                             num_blocks, bs, nb, scale, stream);
  if (page_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, kp, vp, tables, lens, out, b, h, d,
                                     num_blocks, bs, nb, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaGetLastError().
extern "C" int mxt_paged_decode(const void* q, const void* kp, const void* vp,
                                const void* tables, const void* lens,
                                void* out, int b, int h, int d, int num_blocks,
                                int bs, int nb, float scale, int q_dtype,
                                int page_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_pages<float>(q, kp, vp, tables, lens, out, b, h, d,
                                 num_blocks, bs, nb, scale, page_dtype, s);
  if (q_dtype == 1)
    return dispatch_pages<__nv_bfloat16>(q, kp, vp, tables, lens, out, b, h,
                                         d, num_blocks, bs, nb, scale,
                                         page_dtype, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
