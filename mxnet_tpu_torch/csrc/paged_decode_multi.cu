// Multi-query ragged paged attention for Hopper (sm_90a): the speculative
// decoding verify pass.
//
// Replaces the Pallas TPU kernel
// mxnet_tpu/ops/attention.py::_paged_pallas_multi (grid (B, table slots),
// block table and per-lane context lengths as scalar prefetch, online
// softmax state with a T axis in VMEM, blocks past the longest lane
// skipped). Same contract: T query lanes per sequence share its block
// table, each with its own context length; q (B,T,H,D), pages (N,bs,H,D)
// float32 or bfloat16, block_tables (B,nb) int32, context_lens (B,T) int32;
// out (B,T,H,D) in q's dtype. Lane t attends over pool positions
// < context_lens[b, t]; a lane with context 0 returns exactly 0.
//
// What bounds it here: bytes, as for paged_decode.cu. The K and V rows of
// the longest lane's context are needed once, about
// 2 * sum_b max_t ctx[b,t] * H * D * itemsize bytes, against ~4 T FLOP per
// element. The design reads each of them from device memory once per
// window, not once per lane: one thread block per (sequence, head) walks
// the table up to ceil(max_t ctx / bs) (the TPU's pl.when early-out).
// For each pool block, warp w loads K rows w, w+4, ... into registers and
// scores each against all T query lanes, which sit in shared memory; then
// thread d reads V[t, d] once and adds it into each lane's accumulator
// (thread d holds T of them). Lane t updates only over its own live tokens
// of the block, min(bs, ctx_t - j*bs), and skips blocks past its context.
//
// Each lane uses paged_common.cuh's score and online-softmax step, in the
// same order as paged_decode.cu: lane t of this kernel equals paged_decode
// launched with context_lens[:, t], bit for bit, which is what makes the
// verify pass reproduce target-only decoding. No atomics and no split
// across blocks: a row's result does not depend on its batch. An
// out-of-range block id inside a lane's context poisons that lane with
// NaN, as paged_decode.cu does.

#include <climits>

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int MAX_T = 16;  // query lanes per sequence (spec_k + 1)

template <typename TQ, typename TP, int LANES>
__global__ void __launch_bounds__(THREADS)
paged_decode_multi_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                          const TP* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens, TQ* __restrict__ out,
                          int T, int h, int d, int num_blocks, int bs, int nb,
                          float scale) {
  __shared__ float qs[LANES][THREADS];
  __shared__ float ss[LANES][MAX_BS];

  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int ctx[LANES];
  int ctx_max = 0;
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    ctx[i] = i < T ? lens[(size_t)b * T + i] : 0;
    ctx_max = max(ctx_max, ctx[i]);
    if (i < T && tid < d)
      qs[i][tid] = to_float(q[(((size_t)b * T + i) * h + hh) * d + tid]);
  }
  const int* row = tables + (size_t)b * nb;
  const int nblk = ctx_max <= 0 ? 0 : min(nb, (ctx_max + bs - 1) / bs);
  const size_t tok_stride = (size_t)h * d;  // one token of a pool block
  __syncthreads();

  Softmax st[LANES];
  int bad_pos = INT_MAX;  // first position of an out-of-range block
  for (int j = 0; j < nblk; ++j) {
    const int blk = row[j];
    if (blk < 0 || blk >= num_blocks) {  // uniform across the block
      bad_pos = j * bs;
      break;
    }
    const int n_max = min(bs, ctx_max - j * bs);
    const size_t base = (size_t)blk * bs * tok_stride + (size_t)hh * d;
    for (int t = warp; t < n_max; t += WARPS) {
      float k[KREG];
      load_row(kp + base + t * tok_stride, d, lane, k);
#pragma unroll
      for (int i = 0; i < LANES; ++i) {
        if (i < T) {
          const float s = score(qs[i], k, d, lane, scale);
          if (lane == 0) ss[i][t] = s;
        }
      }
    }
    __syncthreads();
    int n[LANES];  // lane i's live tokens of this pool block (<= 0: none)
    BlockStep step[LANES];
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      n[i] = min(bs, ctx[i] - j * bs);
      if (n[i] > 0) step[i].begin(st[i], ss[i], n[i]);
    }
    for (int t = 0; t < n_max; ++t) {
      const float v =
          tid < d ? to_float(vp[base + t * tok_stride + tid]) : 0.f;
#pragma unroll
      for (int i = 0; i < LANES; ++i)
        if (t < n[i]) step[i].add(ss[i][t], v);
    }
#pragma unroll
    for (int i = 0; i < LANES; ++i)
      if (n[i] > 0) step[i].end(st[i]);
    __syncthreads();  // ss is rewritten by the next pool block
  }
  if (tid < d) {
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      if (i < T) {
        const float o = ctx[i] > bad_pos ? NAN : finish(st[i]);
        out[(((size_t)b * T + i) * h + hh) * d + tid] = from_float<TQ>(o);
      }
    }
  }
}

template <typename TQ, typename TP, int LANES>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int b,
                   int t, int h, int d, int num_blocks, int bs, int nb,
                   float scale, cudaStream_t stream) {
  const dim3 grid(b, h);
  paged_decode_multi_kernel<TQ, TP, LANES><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<TQ*>(out), t, h, d,
      num_blocks, bs, nb, scale);
  return cudaGetLastError();
}

// The lane count rounded up to 1, 2, 4, 8 or 16: the per-lane state lives
// in registers, sized at compile time.
template <typename TQ, typename TP>
cudaError_t dispatch_lanes(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* lens, void* out,
                           int b, int t, int h, int d, int num_blocks, int bs,
                           int nb, float scale, cudaStream_t stream) {
  if (t <= 1)
    return launch<TQ, TP, 1>(q, kp, vp, tables, lens, out, b, t, h, d,
                             num_blocks, bs, nb, scale, stream);
  if (t <= 2)
    return launch<TQ, TP, 2>(q, kp, vp, tables, lens, out, b, t, h, d,
                             num_blocks, bs, nb, scale, stream);
  if (t <= 4)
    return launch<TQ, TP, 4>(q, kp, vp, tables, lens, out, b, t, h, d,
                             num_blocks, bs, nb, scale, stream);
  if (t <= 8)
    return launch<TQ, TP, 8>(q, kp, vp, tables, lens, out, b, t, h, d,
                             num_blocks, bs, nb, scale, stream);
  return launch<TQ, TP, 16>(q, kp, vp, tables, lens, out, b, t, h, d,
                            num_blocks, bs, nb, scale, stream);
}

template <typename TQ>
cudaError_t dispatch_pages(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* lens, void* out,
                           int b, int t, int h, int d, int num_blocks, int bs,
                           int nb, float scale, int page_dtype,
                           cudaStream_t stream) {
  if (page_dtype == 0)
    return dispatch_lanes<TQ, float>(q, kp, vp, tables, lens, out, b, t, h, d,
                                     num_blocks, bs, nb, scale, stream);
  if (page_dtype == 1)
    return dispatch_lanes<TQ, __nv_bfloat16>(q, kp, vp, tables, lens, out, b,
                                             t, h, d, num_blocks, bs, nb,
                                             scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaGetLastError().
extern "C" int mxt_paged_decode_multi(const void* q, const void* kp,
                                      const void* vp, const void* tables,
                                      const void* lens, void* out, int b,
                                      int t, int h, int d, int num_blocks,
                                      int bs, int nb, float scale,
                                      int q_dtype, int page_dtype,
                                      void* stream) {
  if (t < 1 || t > MAX_T || d > THREADS || bs > MAX_BS)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_pages<float>(q, kp, vp, tables, lens, out, b, t, h, d,
                                 num_blocks, bs, nb, scale, page_dtype, s);
  if (q_dtype == 1)
    return dispatch_pages<__nv_bfloat16>(q, kp, vp, tables, lens, out, b, t,
                                         h, d, num_blocks, bs, nb, scale,
                                         page_dtype, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_paged_decode_multi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
