// Multi-query ragged paged attention for Hopper (sm_90a): the speculative
// decoding verify pass.
//
// Replaces the Pallas TPU kernel
// mxnet_tpu/ops/attention.py::_paged_pallas_multi (grid (B, table slots),
// block table and per-lane context lengths as scalar prefetch, online
// softmax state with a T axis in VMEM, blocks past the longest lane
// skipped). Same contract: T query lanes per sequence share its block
// table, each with its own context length; q (B,T,H,D) float32 (the
// wrapper casts), pages (N,bs,H,D) float32, bfloat16 or float16,
// block_tables (B,nb) int32, context_lens (B,T) int32; out (B,T,H,D)
// float32. Lane t attends over pool positions
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
//
// The envelope: any T, table width, pool block size up to MAX_BS and head
// dimension up to MAX_D (paged_common.cuh). The lanes go in groups of up
// to 16, one grid row (blockIdx.z) per group, each group walking the
// table up to its own longest lane (a group re-reads the K/V its lanes
// share with another group's); the group shrinks below 16 where its
// queries and scores would not fit in shared memory. A window holds whole
// pool blocks, or one pool block when bs is larger than SB_POS; a chunk
// holds fewer positions where a row is wider than 128 float32 words. The
// first TAB_SMEM table slots sit in shared memory, the rest are read from
// device memory as the chunks are staged. A head dimension over 128 or a
// pool block over SB_POS positions (WIDE) takes rows of its queries and
// scores sized at run time, scores in chunks of 128 dimensions, the
// partial sums carried from chunk to chunk in each lane's order, and
// keeps the (lane, dim) chains in shared memory instead of registers; the
// other instances keep compile-time rows (128 dims, SB_POS positions) and
// the chains in registers.

#include <climits>
#include <stdint.h>

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int MAX_T = 16;        // query lanes per thread block
constexpr int BLOCK_THREADS = 512;  // 16 warps
constexpr int CH = 64;           // positions per staged chunk at most
constexpr int CH_BYTES = 32768;  // bytes per staged chunk at most
constexpr int STAGES = 4;        // ring slots: STAGES - 1 chunks in flight
constexpr int SB_POS = 256;      // positions scored at once (a window)
constexpr int SB_BLOCKS = 64;    // pool blocks per window at most
constexpr int TAB_FIRST = 256;   // table slots read before the lengths
// dynamic shared memory a block may take: 227 KB less the static arrays
constexpr int SMEM_BUDGET = 232448 - 2 * MAX_T * SB_BLOCKS * 4 - 1024;

// Sizes chosen by the launch from T, d, bs and nb.
struct Plan {
  int ch;    // positions per staged chunk
  int wb;    // pool blocks per window
  int tabn;  // table slots held in shared memory
};

// LANES: lanes per group, a power of two up to 16; PP: (lane, dim) pairs
// per thread at most (not WIDE); WIDE: d > CHUNK_D or bs > SB_POS. The
// staged chunks form one stream of jobs (window, K or V, chunk); job
// q + STAGES - 1 is staged while job q is computed.
template <typename TP, int LANES, int PP, bool WIDE>
__global__ void __launch_bounds__(BLOCK_THREADS)
paged_decode_multi_kernel(const float* __restrict__ q,
                          const TP* __restrict__ kp,
                          const TP* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens, float* __restrict__ out,
                          int T, int h, int d, int num_blocks, int bs, int nb,
                          float scale, Plan pl) {
  __shared__ float corr[LANES][SB_BLOCKS]; // each pool block's correction
  __shared__ float bx[LANES][SB_BLOCKS];   // block max, new max, block sum
  __shared__ float m_run[LANES];           // running max
  __shared__ float l_run[LANES];           // running sum
  __shared__ int ctx[LANES];               // per-lane context length
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ch = pl.ch;
  const int wpos = pl.wb * bs;                // positions per window
  // rows of qs and ss: compile-time unless WIDE
  const int qrow = WIDE ? d : CHUNK_D;
  const int srow = WIDE ? wpos : SB_POS;
  TP* buf = reinterpret_cast<TP*>(smem_raw);  // [STAGES][ch][d]
  float* qs = reinterpret_cast<float*>(buf + (size_t)STAGES * ch * d);
                                              // [LANES][qrow]
  float* ss = qs + LANES * qrow;  // [LANES][srow] scores, then weights p
  float* accs = ss + LANES * srow;  // WIDE: [LANES][d] outputs
  float* parts = accs + (WIDE ? LANES * d : 0);  // WIDE: [LANES][d] chains
  int* tab = reinterpret_cast<int*>(parts + (WIDE ? LANES * d : 0));
                                              // [tabn]

  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int lane0 = blockIdx.z * LANES;  // this group's first lane
  const int tl = min(LANES, T - lane0);  // and its lane count
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nth / 32;
  const int* row = tables + (size_t)b * nb;
  const int* lrow = lens + (size_t)b * T + lane0;

  // the table row's head, read in parallel with the lengths (most rows
  // need no more); the rest once the walk's length is known
  for (int e = tid; e < min(pl.tabn, TAB_FIRST); e += nth) tab[e] = row[e];
  int ctx_max = 0;
  for (int i = 0; i < tl; ++i) ctx_max = max(ctx_max, lrow[i]);
  for (int e = tid; e < LANES * d; e += nth)  // lanes past tl score zeros
    qs[e / d * qrow + e % d] =
        e / d < tl
            ? q[(((size_t)b * T + lane0 + e / d) * h + hh) * d + e % d]
            : 0.f;
  if (WIDE)
    for (int e = tid; e < 2 * LANES * d; e += nth) accs[e] = 0.f;
  if (tid < LANES) {
    ctx[tid] = tid < tl ? lrow[tid] : 0;
    m_run[tid] = NEG_INF;
    l_run[tid] = 0.f;
  }
  const int nblk = ctx_max <= 0 ? 0 : min(nb, (ctx_max - 1) / bs + 1);
  for (int e = TAB_FIRST + tid; e < min(nblk, pl.tabn); e += nth)
    tab[e] = row[e];
  __syncthreads();  // qs, ctx, m_run, l_run, tab

  // an out-of-range block id ends the walk; lanes reaching it get NaN
  int jbad = nblk;
  for (int j = 0; j < nblk; ++j) {
    const int blk = table_slot(tab, row, j);
    if (blk < 0 || blk >= num_blocks) {
      jbad = j;
      break;
    }
  }
  const long long bad_pos = jbad < nblk ? (long long)jbad * bs : LLONG_MAX;
  const int npos = (int)min((long long)ctx_max, (long long)jbad * bs);
  const size_t tok_stride = (size_t)h * d;   // one token of a pool block
  const int epc = 16 / (int)sizeof(TP);      // elements per 16-byte copy
  const int cpr = d / epc;                   // copies per row
  const int nwin = (npos + wpos - 1) / wpos;
  const int ncw = (wpos + ch - 1) / ch;  // chunks of a full window
  const int ncl = nwin > 0 ? (npos - (nwin - 1) * wpos + ch - 1) / ch : 0;
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
    x.c0 = x.w0 + x.c * ch;
    x.c1 = min(x.w1, x.c0 + ch);
    return x;
  };
  // stage job jq's rows into its ring slot
  auto issue = [&](int jq) {
    if (jq >= njobs) return;
    const Job x = job(jq);
    const TP* pages = (x.v ? vp : kp) + (size_t)hh * d;
    TP* dst = buf + (size_t)(jq % STAGES) * ch * d;
    for (int e = tid; e < (x.c1 - x.c0) * cpr; e += nth) {
      const int rr = e / cpr;
      const int c = (e % cpr) * epc;
      const int pos = x.c0 + rr;
      const size_t slot =
          (size_t)table_slot(tab, row, pos / bs) * bs + pos % bs;
      cp_async16(dst + rr * d + c, pages + slot * tok_stride + c);
    }
  };

  // each thread's (lane, dim) pairs: pair tid + k * nth (not WIDE)
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
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const TP* tile = buf + (size_t)(jq % STAGES) * ch * d;
    const int j0 = x.w0 / bs;  // the window's first pool block
    if (!x.v) {
      // scores of the chunk's positions against every lane, two
      // positions per warp at a time; all LANES lanes, so that no branch
      // separates the independent shuffle trees and they overlap
      for (int t = x.c0 + warp; t < x.c1; t += 2 * nwarps) {
        const int t2 = min(t + nwarps, x.c1 - 1);  // a repeat when past the end
        if (!WIDE) {
          float k1[KREG], k2[KREG];
          load_row(tile + (t - x.c0) * d, 0, d, lane, k1);
          load_row(tile + (t2 - x.c0) * d, 0, d, lane, k2);
#pragma unroll
          for (int i = 0; i < LANES; ++i) {
            const float s1 = score(qs + i * qrow, k1, d, lane, scale);
            const float s2 = score(qs + i * qrow, k2, d, lane, scale);
            if (lane == 0) {
              ss[i * srow + t - x.w0] = s1;
              ss[i * srow + t2 - x.w0] = s2;
            }
          }
        } else {
          // chunks of CHUNK_D dimensions, each lane's partials carried
          float p1[LANES], p2[LANES];
#pragma unroll
          for (int i = 0; i < LANES; ++i) p1[i] = p2[i] = 0.f;
          for (int c0 = 0; c0 < d; c0 += CHUNK_D) {
            float k1[KREG], k2[KREG];
            load_row(tile + (t - x.c0) * d, c0, d, lane, k1);
            load_row(tile + (t2 - x.c0) * d, c0, d, lane, k2);
#pragma unroll
            for (int i = 0; i < LANES; ++i) {
              p1[i] = dot_part(qs + i * qrow, k1, c0, d, lane, p1[i]);
              p2[i] = dot_part(qs + i * qrow, k2, c0, d, lane, p2[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < LANES; ++i) {
            const float s1 = warp_tree(p1[i], scale);
            const float s2 = warp_tree(p2[i], scale);
            if (lane == 0) {
              ss[i * srow + t - x.w0] = s1;
              ss[i * srow + t2 - x.w0] = s2;
            }
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
        for (int e = tid; e < tl * nbw; e += nth) {
          const int i = e / nbw, jj = e % nbw;
          const int n = min(bs, ctx[i] - (j0 + jj) * bs);
          float mb = NEG_INF;
          for (int t = 0; t < n; ++t)
            mb = fmaxf(mb, ss[i * srow + jj * bs + t]);
          bx[i][jj] = mb;
        }
        __syncthreads();
        // per lane, the new max and the correction of each block in turn
        if (tid < tl) {
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
        for (int e = tid; e < tl * len; e += nth) {
          const int i = e / len, tt = e % len;
          if (x.w0 + tt < ctx[i])
            ss[i * srow + tt] = prob(ss[i * srow + tt], bx[i][tt / bs]);
        }
        __syncthreads();
        // each block's sum in position order, in parallel
        for (int e = tid; e < tl * nbw; e += nth) {
          const int i = e / nbw, jj = e % nbw;
          const int n = min(bs, ctx[i] - (j0 + jj) * bs);
          float psum = 0.f;
          for (int t = 0; t < n; ++t)
            psum = __fadd_rn(psum, ss[i * srow + jj * bs + t]);
          bx[i][jj] = psum;
        }
        __syncthreads();
        // per lane, the running sum through the blocks in turn
        if (tid < tl) {
          float l = l_run[tid];
          for (int jj = 0; jj < nbw && ctx[tid] > (j0 + jj) * bs; ++jj)
            l = fold(l, corr[tid][jj], bx[tid][jj]);
          l_run[tid] = l;
        }
      }
    } else {
      // V: each (lane, dim) pair's position-order chain, folded into the
      // running output at the end of each pool block
      auto vpass = [&](int pair, float& out_acc, float& out_part) {
        const int i = pair / d;
        const int dim = pair % d;
        const int ci = ctx[i];
        float a = out_part;
        for (int j = x.c0 / bs; (long long)j * bs < x.c1; ++j) {
          const int hi = min(min(x.c1, (j + 1) * bs), ci);
          for (int t = max(x.c0, j * bs); t < hi; ++t)
            a = __fmaf_rn(ss[i * srow + t - x.w0],
                          to_float(tile[(t - x.c0) * d + dim]), a);
          if (x.c1 >= min((j + 1) * bs, x.w1)) {  // block j complete
            if (ci > j * bs) out_acc = fold(out_acc, corr[i][j - j0], a);
            a = 0.f;
          }
        }
        out_part = a;
      };
      if (!WIDE) {
#pragma unroll
        for (int k = 0; k < PP; ++k) {
          const int pair = tid + k * nth;
          if (pair < tl * d) vpass(pair, acc[k], part[k]);
        }
      } else {
        for (int pair = tid; pair < tl * d; pair += nth)
          vpass(pair, accs[pair], parts[pair]);
      }
    }
    __syncthreads();  // the slot is restaged, the window rewritten, after this
  }
  auto write = [&](int pair, float a) {
    const int i = pair / d;
    const int dim = pair % d;
    const float o = ctx[i] > bad_pos ? NAN : finish(a, l_run[i]);
    out[(((size_t)b * T + lane0 + i) * h + hh) * d + dim] = o;
  };
  if (!WIDE) {
#pragma unroll
    for (int k = 0; k < PP; ++k) {
      const int pair = tid + k * nth;
      if (pair < tl * d) write(pair, acc[k]);
    }
  } else {
    for (int pair = tid; pair < tl * d; pair += nth) write(pair, accs[pair]);
  }
}

// dynamic shared memory of a group of `lanes` lanes
inline long long smem_bytes(int lanes, bool wide, int d, int itemsize,
                            const Plan& pl, int bs) {
  const long long rows = wide ? d + (long long)pl.wb * bs + 2 * d
                              : CHUNK_D + SB_POS;
  return (long long)STAGES * pl.ch * d * itemsize + 4LL * lanes * rows +
         4LL * pl.tabn;
}

template <typename TP, int LANES, bool WIDE>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int b,
                   int t, int h, int d, int num_blocks, int bs, int nb,
                   float scale, const Plan& pl, cudaStream_t stream) {
  constexpr int PP =
      WIDE ? 1 : (LANES * CHUNK_D + BLOCK_THREADS - 1) / BLOCK_THREADS;
  const int smem = (int)smem_bytes(LANES, WIDE, d, (int)sizeof(TP), pl, bs);
  static int opted[MAX_DEVICES];
  const cudaError_t e = smem_opt_in(
      paged_decode_multi_kernel<TP, LANES, PP, WIDE>, opted, smem);
  if (e != cudaSuccess) return e;
  // 16 warps whatever the lane count: the scoring and softmax steps are
  // latency bound, and more warps hide more of it (profile_kernels_torch.py
  // times 8 warps beside)
  const dim3 grid(b, h, (t + LANES - 1) / LANES);
  paged_decode_multi_kernel<TP, LANES, PP, WIDE>
      <<<grid, BLOCK_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(out), t, h, d,
      num_blocks, bs, nb, scale, pl);
  return cudaGetLastError();
}

template <typename TP, bool WIDE>
cudaError_t dispatch_lanes(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* lens, void* out,
                           int b, int t, int h, int d, int num_blocks, int bs,
                           int nb, float scale, const Plan& pl, int lanes,
                           cudaStream_t stream) {
#define MXT_LAUNCH(L)                                                     \
  return launch<TP, L, WIDE>(q, kp, vp, tables, lens, out, b, t, h, d,    \
                             num_blocks, bs, nb, scale, pl, stream)
  if (lanes <= 1) MXT_LAUNCH(1);
  if (lanes <= 2) MXT_LAUNCH(2);
  if (lanes <= 4) MXT_LAUNCH(4);
  if (lanes <= 8) MXT_LAUNCH(8);
  MXT_LAUNCH(16);
#undef MXT_LAUNCH
}

// The lanes per group: min(T, 16) rounded up to 1, 2, 4, 8 or 16 (the
// per-lane arrays are sized at compile time), halved while the group's
// shared memory would not fit.
template <typename TP>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* lens, void* out, int b,
                     int t, int h, int d, int num_blocks, int bs, int nb,
                     float scale, cudaStream_t stream) {
  Plan pl;
  pl.ch = max(1, min(CH, CH_BYTES / (d * (int)sizeof(TP))));
  pl.wb = max(1, min(SB_POS / bs, SB_BLOCKS));
  pl.tabn = min(nb, TAB_SMEM);
  const bool wide = d > CHUNK_D || bs > SB_POS;
  int lanes = 1;
  while (lanes < t && lanes < MAX_T) lanes *= 2;
  while (lanes > 1 &&
         smem_bytes(lanes, wide, d, (int)sizeof(TP), pl, bs) > SMEM_BUDGET)
    lanes /= 2;
  if (smem_bytes(lanes, wide, d, (int)sizeof(TP), pl, bs) > SMEM_BUDGET)
    return cudaErrorInvalidValue;
  if (wide)
    return dispatch_lanes<TP, true>(q, kp, vp, tables, lens, out, b, t, h, d,
                                    num_blocks, bs, nb, scale, pl, lanes,
                                    stream);
  return dispatch_lanes<TP, false>(q, kp, vp, tables, lens, out, b, t, h, d,
                                   num_blocks, bs, nb, scale, pl, lanes,
                                   stream);
}

}  // namespace

// page_dtype: 0 = float32, 1 = bfloat16, 2 = float16; q and out are
// float32. The pages must be 16-byte aligned (cp.async). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_paged_decode_multi(const void* q, const void* kp,
                                      const void* vp, const void* tables,
                                      const void* lens, void* out, int b,
                                      int t, int h, int d, int num_blocks,
                                      int bs, int nb, float scale,
                                      int page_dtype, void* stream) {
  if (b < 1 || t < 1 || (t + MAX_T - 1) / MAX_T > 65535 || h < 1 ||
      h > 65535 || d < 8 || d % 8 != 0 || d > MAX_D || bs < 1 ||
      bs > MAX_BS || nb < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_dtype == 0)
    return dispatch<float>(q, kp, vp, tables, lens, out, b, t, h, d,
                           num_blocks, bs, nb, scale, s);
  if (page_dtype == 1)
    return dispatch<__nv_bfloat16>(q, kp, vp, tables, lens, out, b, t, h, d,
                                   num_blocks, bs, nb, scale, s);
  if (page_dtype == 2)
    return dispatch<__half>(q, kp, vp, tables, lens, out, b, t, h, d,
                            num_blocks, bs, nb, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_paged_decode_multi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
