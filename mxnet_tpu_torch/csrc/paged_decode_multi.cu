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
// element. One thread block per (sequence, head) walks the table up to
// ceil(max_t ctx / bs) (the TPU's pl.when early-out) and reads each K and
// V row from device memory once per window, not once per lane. What held
// the first design back was latency, not bytes: V rows fetched one token
// at a time inside a serial loop, T exponentials per token in every
// thread, half the threads idle in the V pass, and a chain of dependent
// steps for every pool block. So here:
//   - the positions are walked in windows of whole pool blocks (up to 256
//     positions); a window's K rows, then its V rows, are staged in shared
//     memory with cp.async in chunks of CH positions (across pool-block
//     boundaries), through a ring of STAGES slots, so STAGES - 1 chunk
//     loads are in flight behind the one being computed; the table row
//     is read once into shared memory;
//   - warp w scores positions w, w+W, ... against every lane
//     (paged_common's score(), unchanged) into ss[lane][position];
//   - the online-softmax steps of all the window's pool blocks then run
//     in parallel where their order allows: each (lane, block) max
//     (fmaxf is exact in any order), one thread per lane carrying the
//     running max through the blocks, each (lane, position) weight
//     p = exp(s - m_new) once, each (lane, block) sum in position order,
//     one thread per lane carrying the running sum;
//   - the V pass spreads the (lane, dim) pairs over the 512 threads,
//     each running its own position-order fma chain over p and V and
//     folding it into its output at the end of each pool block.
//
// Lane t of this kernel equals paged_decode launched with
// context_lens[:, t], bit for bit, which is what makes the verify pass
// reproduce target-only decoding: the score, the block max, m_new and the
// correction per pool block, psum's token-order add chain, each (lane,
// dim)'s token-order fma chain and the fold and finish are the same
// operations in the same order (paged_common.cuh); only which thread runs
// them differs. No atomics and no split across blocks: a row's result
// does not depend on its batch. An out-of-range block id inside a lane's
// context poisons that lane with NaN, as paged_decode.cu does.

#include <climits>
#include <stdint.h>

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int MAX_T = 16;        // query lanes per sequence (spec_k + 1)
constexpr int BLOCK_THREADS = 512;  // 16 warps
constexpr int CH = 64;           // positions per staged chunk
constexpr int STAGES = 4;        // ring slots: STAGES - 1 chunks in flight
constexpr int SB_POS = MAX_BS;   // positions scored at once (a window)
constexpr int SB_BLOCKS = 64;    // pool blocks per window at most
constexpr int MAX_D = 128;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_TABLE = 8192;  // table slots per sequence (shared memory)
constexpr int TAB_FIRST = 256;   // table slots read before the lengths

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 1) : "memory");
}

// LANES: the lane count rounded up (1, 2, 4, 8, 16); PP: (lane, dim) pairs
// per thread at most. The staged chunks form one stream of jobs (window,
// K or V, chunk); job q + STAGES - 1 is staged while job q is computed.
template <typename TQ, typename TP, int LANES, int PP>
__global__ void __launch_bounds__(BLOCK_THREADS)
paged_decode_multi_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                          const TP* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens, TQ* __restrict__ out,
                          int T, int h, int d, int num_blocks, int bs, int nb,
                          float scale) {
  __shared__ float qs[LANES][MAX_D];
  __shared__ float ss[LANES][SB_POS];      // scores, then weights p
  __shared__ float corr[LANES][SB_BLOCKS]; // each pool block's correction
  __shared__ float bx[LANES][SB_BLOCKS];   // block max, new max, block sum
  __shared__ float m_run[LANES];           // running max
  __shared__ float l_run[LANES];           // running sum
  __shared__ int ctx[LANES];               // per-lane context length
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TP* buf = reinterpret_cast<TP*>(smem_raw);  // [STAGES][CH][d]
  int* tab = reinterpret_cast<int*>(buf + (size_t)STAGES * CH * d);  // [nb]

  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nth / 32;

  // the table row's head, read in parallel with the lengths (most rows
  // need no more); the rest once the walk's length is known
  for (int e = tid; e < min(nb, TAB_FIRST); e += nth)
    tab[e] = tables[(size_t)b * nb + e];
  int ctx_max = 0;
  for (int i = 0; i < T; ++i) ctx_max = max(ctx_max, lens[(size_t)b * T + i]);
  for (int e = tid; e < LANES * d; e += nth)  // lanes past T score zeros
    qs[e / d][e % d] =
        e / d < T ? to_float(q[(((size_t)b * T + e / d) * h + hh) * d + e % d])
                  : 0.f;
  if (tid < LANES) {
    ctx[tid] = tid < T ? lens[(size_t)b * T + tid] : 0;
    m_run[tid] = NEG_INF;
    l_run[tid] = 0.f;
  }
  const int nblk = ctx_max <= 0 ? 0 : min(nb, (ctx_max + bs - 1) / bs);
  for (int e = TAB_FIRST + tid; e < nblk; e += nth)
    tab[e] = tables[(size_t)b * nb + e];
  __syncthreads();  // qs, ctx, m_run, l_run, tab

  // an out-of-range block id ends the walk; lanes reaching it get NaN
  int jbad = nblk;
  for (int j = 0; j < nblk; ++j)
    if (tab[j] < 0 || tab[j] >= num_blocks) {
      jbad = j;
      break;
    }
  const int bad_pos = jbad < nblk ? jbad * bs : INT_MAX;
  const int npos = min(ctx_max, jbad * bs);  // positions walked
  const size_t tok_stride = (size_t)h * d;   // one token of a pool block
  const int epc = 16 / (int)sizeof(TP);      // elements per 16-byte copy
  const int cpr = d / epc;                   // copies per row
  const int wpos = min(SB_POS / bs, SB_BLOCKS) * bs;  // positions per window
  const int nwin = (npos + wpos - 1) / wpos;
  const int ncw = (wpos + CH - 1) / CH;  // chunks of a full window
  const int ncl = nwin > 0 ? (npos - (nwin - 1) * wpos + CH - 1) / CH : 0;
  const int njobs = nwin > 0 ? (nwin - 1) * 2 * ncw + 2 * ncl : 0;

  struct Job {
    int w0, w1;  // the window's positions
    int c, nc;   // chunk and chunk count
    bool v;      // V (else K)
    int c0, c1;  // the chunk's positions
  };
  auto job = [&](int jq) {
    Job x;
    const int w = min(jq / (2 * ncw), nwin - 1);
    const int r = jq - w * 2 * ncw;
    x.nc = w == nwin - 1 ? ncl : ncw;
    x.v = r >= x.nc;
    x.c = r % x.nc;
    x.w0 = w * wpos;
    x.w1 = min(npos, x.w0 + wpos);
    x.c0 = x.w0 + x.c * CH;
    x.c1 = min(x.w1, x.c0 + CH);
    return x;
  };
  // stage job jq's rows into its ring slot
  auto issue = [&](int jq) {
    if (jq >= njobs) return;
    const Job x = job(jq);
    const TP* pages = (x.v ? vp : kp) + (size_t)hh * d;
    TP* dst = buf + (size_t)(jq % STAGES) * CH * d;
    for (int e = tid; e < (x.c1 - x.c0) * cpr; e += nth) {
      const int rr = e / cpr;
      const int c = (e % cpr) * epc;
      const int pos = x.c0 + rr;
      const size_t slot = (size_t)tab[pos / bs] * bs + pos % bs;
      cp_async16(dst + rr * d + c, pages + slot * tok_stride + c);
    }
  };

  // each thread's (lane, dim) pairs: pair tid + k * nth
  float acc[PP];
  float part[PP];
#pragma unroll
  for (int k = 0; k < PP; ++k) acc[k] = part[k] = 0.f;

  for (int jq = 0; jq < STAGES - 1; ++jq) {
    issue(jq);
    cp_async_commit();
  }
  for (int jq = 0; jq < njobs; ++jq) {
    const Job x = job(jq);
    issue(jq + STAGES - 1);
    cp_async_commit();
    cp_async_wait_ring();
    __syncthreads();
    const TP* tile = buf + (size_t)(jq % STAGES) * CH * d;
    const int j0 = x.w0 / bs;  // the window's first pool block
    if (!x.v) {
      // scores of the chunk's positions against every lane, two
      // positions per warp at a time; all LANES lanes, so that no branch
      // separates the independent shuffle trees and they overlap
      for (int t = x.c0 + warp; t < x.c1; t += 2 * nwarps) {
        const int t2 = min(t + nwarps, x.c1 - 1);  // a repeat when past the end
        float k1[KREG], k2[KREG];
        load_row(tile + (t - x.c0) * d, d, lane, k1);
        load_row(tile + (t2 - x.c0) * d, d, lane, k2);
#pragma unroll
        for (int i = 0; i < LANES; ++i) {
          const float s1 = score(qs[i], k1, d, lane, scale);
          const float s2 = score(qs[i], k2, d, lane, scale);
          if (lane == 0) {
            ss[i][t - x.w0] = s1;
            ss[i][t2 - x.w0] = s2;
          }
        }
      }
      if (x.c == x.nc - 1) {
        // the window's softmax steps; pool block j of lane i covers its
        // n = min(bs, ctx_i - j bs) live positions, as in paged_decode
        const int nbw = (x.w1 - x.w0 + bs - 1) / bs;
        const int len = x.w1 - x.w0;
        __syncthreads();
        // block maxes, in parallel (fmaxf is exact in any order)
        for (int e = tid; e < T * nbw; e += nth) {
          const int i = e / nbw, jj = e % nbw;
          const int n = min(bs, ctx[i] - (j0 + jj) * bs);
          float mb = NEG_INF;
          for (int t = 0; t < n; ++t) mb = fmaxf(mb, ss[i][jj * bs + t]);
          bx[i][jj] = mb;
        }
        __syncthreads();
        // per lane, the new max and the correction of each block in turn
        if (tid < T) {
          float m = m_run[tid];
          for (int jj = 0; jj < nbw && ctx[tid] > (j0 + jj) * bs; ++jj) {
            const float mn = fmaxf(m, bx[tid][jj]);
            corr[tid][jj] = rescale(m, mn);
            bx[tid][jj] = mn;
            m = mn;
          }
          m_run[tid] = m;
        }
        __syncthreads();
        // each (lane, position) weight once, in place
        for (int e = tid; e < T * len; e += nth) {
          const int i = e / len, tt = e % len;
          if (x.w0 + tt < ctx[i]) ss[i][tt] = prob(ss[i][tt], bx[i][tt / bs]);
        }
        __syncthreads();
        // each block's sum in position order, in parallel
        for (int e = tid; e < T * nbw; e += nth) {
          const int i = e / nbw, jj = e % nbw;
          const int n = min(bs, ctx[i] - (j0 + jj) * bs);
          float psum = 0.f;
          for (int t = 0; t < n; ++t) psum = __fadd_rn(psum, ss[i][jj * bs + t]);
          bx[i][jj] = psum;
        }
        __syncthreads();
        // per lane, the running sum through the blocks in turn
        if (tid < T) {
          float l = l_run[tid];
          for (int jj = 0; jj < nbw && ctx[tid] > (j0 + jj) * bs; ++jj)
            l = fold(l, corr[tid][jj], bx[tid][jj]);
          l_run[tid] = l;
        }
      }
    } else {
      // V: each (lane, dim) pair's position-order chain, folded into the
      // running output at the end of each pool block
#pragma unroll
      for (int k = 0; k < PP; ++k) {
        const int pair = tid + k * nth;
        if (pair < T * d) {
          const int i = pair / d;
          const int dim = pair % d;
          const int ci = ctx[i];
          float a = part[k];
          for (int j = x.c0 / bs; j * bs < x.c1; ++j) {
            const int hi = min(min(x.c1, (j + 1) * bs), ci);
            for (int t = max(x.c0, j * bs); t < hi; ++t)
              a = __fmaf_rn(ss[i][t - x.w0], to_float(tile[(t - x.c0) * d + dim]),
                            a);
            if (x.c1 >= min((j + 1) * bs, x.w1)) {  // block j complete
              if (ci > j * bs) acc[k] = fold(acc[k], corr[i][j - j0], a);
              a = 0.f;
            }
          }
          part[k] = a;
        }
      }
    }
    __syncthreads();  // the slot is restaged, the window rewritten, after this
  }
#pragma unroll
  for (int k = 0; k < PP; ++k) {
    const int pair = tid + k * nth;
    if (pair < T * d) {
      const int i = pair / d;
      const int dim = pair % d;
      const float o = ctx[i] > bad_pos ? NAN : finish(acc[k], l_run[i]);
      out[(((size_t)b * T + i) * h + hh) * d + dim] = from_float<TQ>(o);
    }
  }
}

template <typename TQ, typename TP, int LANES>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int b,
                   int t, int h, int d, int num_blocks, int bs, int nb,
                   float scale, cudaStream_t stream) {
  constexpr int PP = (LANES * MAX_D + BLOCK_THREADS - 1) / BLOCK_THREADS;
  // the ring and the table row; past 48 KB with the static arrays the
  // kernel must opt in, asked once per device and size rather than on
  // every launch
  const int smem = STAGES * CH * d * (int)sizeof(TP) + nb * 4;
  static int opted[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || smem > opted[dev]) {
    e = cudaFuncSetAttribute(paged_decode_multi_kernel<TQ, TP, LANES, PP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted[dev] = smem;
  }
  // 16 warps whatever the lane count: the scoring and softmax steps are
  // latency bound, and more warps hide more of it (profile_kernels_torch.py
  // times 8 warps beside)
  const dim3 grid(b, h);
  paged_decode_multi_kernel<TQ, TP, LANES, PP>
      <<<grid, BLOCK_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<TQ*>(out), t, h, d,
      num_blocks, bs, nb, scale);
  return cudaGetLastError();
}

// The lane count rounded up to 1, 2, 4, 8 or 16: the per-lane arrays are
// sized at compile time.
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

// dtypes: 0 = float32, 1 = bfloat16. The pages must be 16-byte aligned
// (cp.async). Returns the launch's cudaGetLastError().
extern "C" int mxt_paged_decode_multi(const void* q, const void* kp,
                                      const void* vp, const void* tables,
                                      const void* lens, void* out, int b,
                                      int t, int h, int d, int num_blocks,
                                      int bs, int nb, float scale,
                                      int q_dtype, int page_dtype,
                                      void* stream) {
  if (t < 1 || t > MAX_T || d > MAX_D || d % 8 != 0 || bs > MAX_BS ||
      nb > MAX_TABLE)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16)
    return cudaErrorMisalignedAddress;
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
