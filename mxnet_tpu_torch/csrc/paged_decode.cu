// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/attention.py::_paged_pallas
// (grid (B, table slots), block table and context lengths as scalar
// prefetch steering each step's K/V DMA, online softmax in VMEM). Same
// contract: one query per sequence, q (B,H,D) float32 (the wrapper casts),
// pages (N,bs,H,D) float32, bfloat16 or float16, block_tables (B,nb)
// int32, context_lens (B,) int32; out (B,H,D) float32. Positions >=
// context_len contribute exactly nothing and a context_len == 0 row
// returns exactly 0 (acc 0 over l clamped at 1e-30). An out-of-range block
// id among the table slots the context reaches poisons the row with NaN,
// as jnp.take fills it.
//
// What bounds it here: bytes. It reads the K and V rows of the live
// context once, sum_b ctx_b * H * D * itemsize * 2 bytes, against about
// 4 FLOP per element. The first design (one thread per head dimension)
// ran at 17x that bound: its V pass was a serial loop over positions with
// one load from device memory and one dependent fma per step, every
// thread repeated the softmax bookkeeping, and each pool block's loads
// waited on the one before. At the serving shapes a block's time is a
// chain of latencies (the loads' round trip, then each phase between two
// barriers), so the design cuts the chain's links. One block of THREADS
// threads per (sequence, head):
//   - reads its length, its query and its table row at once, and checks
//     every slot the context reaches (an out-of-range id is never staged);
//   - walks the positions in segments of whole pool blocks (up to SEG_POS
//     positions, or one pool block when bs is larger), and stages each
//     segment's K rows, then its V rows, in shared memory with 16-byte
//     cp.async in chunks of up to CH_MAX positions, through a ring of
//     STAGES slots (each row's source address computed once): at the
//     serving shapes (context <= 256, D 64, f32) K and V are one chunk
//     each, both in flight from the start; longer contexts stream with
//     STAGES - 1 chunks in flight;
//   - scores each position with TPP threads (thread r holds the partials
//     l = r mod TPP of paged_common.cuh's score and folds the tree's upper
//     levels in registers, the last log2(TPP) by shuffles): 128 positions
//     at once;
//   - takes each pool block's max with a warp (fmaxf is exact in any
//     order); every thread that needs the running max carries it through
//     the blocks' maxes itself, so each correction and each weight p is
//     computed once, with no serial pass between two barriers;
//   - runs the V pass over (pool block, dimension) pairs, each its own
//     position-order fma chain read from shared memory (at D 64 and 8
//     pool blocks, 512 independent chains of <= 16 fmas), carried across
//     chunks, with each block's psum as one more chain beside them; then
//     one thread per dimension folds the segment's pool blocks in order.
// Every operation of paged_common.cuh's pool-block step is performed once
// and in its order, so the result equals the first design's bit for bit,
// and paged_decode_multi.cu's lane t equals it at context_lens[:, t]. No
// atomics and no split across blocks: a row's result does not depend on
// the batch it was launched in (nor does it use more than 4 of the 132
// SMs at B 1, H 4: a split of positions across blocks is ROADMAP work).
// profile_kernels_torch.py times the choices against their alternatives.

#include <climits>

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int THREADS = 512;       // 16 warps per (sequence, head)
constexpr int TPP = 4;             // threads per scored position
constexpr int NP = 32 / TPP;       // score partials per thread
constexpr int STAGES = 3;          // ring slots: STAGES - 1 chunks in flight
constexpr int CH_MAX = 256;        // positions per staged chunk at most
constexpr int CHUNK_BYTES = 73728; // bytes per staged chunk at most
constexpr int SEG_POS = 256;       // positions per segment (whole blocks)
constexpr int SEG_BLOCKS = 64;     // pool blocks per segment at most
constexpr int ABUF_FLOATS = 8192;  // (pool block, dim) chains per segment
// dynamic shared memory a block may take: 227 KB less the static
// variables and a margin
constexpr int SMEM_BUDGET = 232448 - 1024;

// Sizes chosen by the launch from d, bs and nb.
struct Plan {
  int stride;  // elements per staged row: d and 16 bytes of padding
  int ch;      // positions per chunk
  int nbw;     // pool blocks per segment
  int tabn;    // table slots held in shared memory
};

template <typename TP>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lens, float* __restrict__ out,
                    int h, int d, int num_blocks, int bs, int nb, float scale,
                    Plan pl) {
  __shared__ float m_run;  // running max
  __shared__ float l_run;  // running sum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = pl.stride;
  const int ch = pl.ch;
  const int seg = pl.nbw * bs;  // positions per segment
  TP* ring = reinterpret_cast<TP*>(smem_raw);  // [STAGES][ch][stride]
  float* qs = reinterpret_cast<float*>(
      smem_raw + ((size_t)STAGES * ch * stride * sizeof(TP) + 15) / 16 * 16);
  const int dp = d + 1;           // a pool block's chains: d dims, psum
  float* accb = qs + d;           // [d] running output
  float* ss = accb + d;           // [seg] scores, then weights p
  float* abuf = ss + seg;         // [nbw][dp] the V and psum chains
  float* bmax = abuf + pl.nbw * dp;  // [nbw] block max
  float* mnew = bmax + pl.nbw;    // [nbw] running max after the block
  float* corr = mnew + pl.nbw;    // [nbw] the block's correction
  int* tab = reinterpret_cast<int*>(corr + pl.nbw);  // [tabn]

  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qoff = ((size_t)b * h + hh) * d;
  const int* row = tables + (size_t)b * nb;

  // the length, the table row's head and the query at once; every slot
  // the context reaches is checked before any is staged
  const int ctx = lens[b];
  const int nblk = ctx <= 0 ? 0 : min(nb, (ctx - 1) / bs + 1);
  const int npos = (int)min((long long)ctx, (long long)nblk * bs);
  bool bad = false;
  for (int e = tid; e < pl.tabn; e += THREADS) {
    const int blk = __ldg(row + e);
    tab[e] = blk;
    bad |= e < nblk && (blk < 0 || blk >= num_blocks);
  }
  for (int e = pl.tabn + tid; e < nblk; e += THREADS) {
    const int blk = __ldg(row + e);
    bad |= blk < 0 || blk >= num_blocks;
  }
  for (int e = tid; e < d; e += THREADS) {
    qs[e] = q[qoff + e];
    accb[e] = 0.f;
  }
  if (tid == 0) {
    m_run = NEG_INF;
    l_run = 0.f;
  }
  if (__syncthreads_or(bad)) {  // uniform: every thread returns
    for (int e = tid; e < d; e += THREADS) out[qoff + e] = NAN;
    return;
  }

  const size_t tok_stride = (size_t)h * d;  // one token of a pool block
  const int epc = 16 / (int)sizeof(TP);     // elements per 16-byte copy
  const int cpr = d / epc;                  // copies per row
  const int nseg = (npos + seg - 1) / seg;
  const int ncf = (seg + ch - 1) / ch;  // chunks of a full segment
  const int ncl = nseg > 0 ? (npos - (nseg - 1) * seg + ch - 1) / ch : 0;
  const int njobs = nseg > 0 ? (nseg - 1) * 2 * ncf + 2 * ncl : 0;

  struct Job {
    int w0, w1;  // the segment's positions
    int c, nc;   // chunk and chunk count
    bool v;      // V (else K)
    int c0, c1;  // the chunk's positions
  };
  auto job = [&](int jq) {
    Job x;
    const int w = min(jq / (2 * ncf), nseg - 1);
    const int r = jq - w * 2 * ncf;
    x.nc = w == nseg - 1 ? ncl : ncf;
    x.v = r >= x.nc;
    x.c = r % x.nc;
    x.w0 = w * seg;
    x.w1 = min(npos, x.w0 + seg);
    x.c0 = x.w0 + x.c * ch;
    x.c1 = min(x.w1, x.c0 + ch);
    return x;
  };
  // stage job jq's rows into its ring slot: thread tid copies column
  // tid % cpr of rows tid / cpr, + rstep, ... (each row's address once)
  const int rstep = THREADS / cpr;
  const int ccol = (tid % cpr) * epc;
  const int crow = rstep > 0 && tid < rstep * cpr ? tid / cpr : INT_MAX;
  auto issue = [&](int jq) {
    if (jq >= njobs) return;
    const Job x = job(jq);
    const TP* pages = (x.v ? vp : kp) + (size_t)hh * d;
    TP* dst = ring + (size_t)(jq % STAGES) * ch * stride;
    auto row_src = [&](int rr) {
      const int pos = x.c0 + rr;
      return pages + ((size_t)table_slot(tab, row, pos / bs) * bs + pos % bs) *
                         tok_stride;
    };
    if (rstep > 0) {
      for (int rr = crow; rr < x.c1 - x.c0; rr += rstep)
        cp_async16(dst + rr * stride + ccol, row_src(rr) + ccol);
    } else {  // rows wider than THREADS copies
      for (int rr = 0; rr < x.c1 - x.c0; ++rr) {
        const TP* src = row_src(rr);
        for (int c = tid * epc; c < d; c += THREADS * epc)
          cp_async16(dst + rr * stride + c, src + c);
      }
    }
  };

  const int grp = tid / TPP;  // the position this thread helps score
  const int r = tid % TPP;    // its partials: l = r + TPP i
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
    const TP* tile = ring + (size_t)(jq % STAGES) * ch * stride;
    const int len = x.w1 - x.w0;
    const int nbs = (len + bs - 1) / bs;  // the segment's pool blocks
    if (!x.v) {
      // the chunk's scores, THREADS / TPP positions at a time; every lane
      // runs every round (the shuffles want the whole warp)
      for (int base = x.c0; base < x.c1; base += THREADS / TPP) {
        const int pos = base + grp;
        const TP* krow = tile + (min(pos, x.c1 - 1) - x.c0) * stride;
        float part[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) part[i] = 0.f;
        for (int c0 = 0; c0 < d; c0 += 32) {
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int dd = c0 + r + TPP * i;
            if (dd < d)
              part[i] = __fmaf_rn(qs[dd], to_float(krow[dd]), part[i]);
          }
        }
        // the tree's levels 16 .. TPP in registers, then TPP/2 .. 1
#pragma unroll
        for (int s = NP / 2; s >= 1; s /= 2)
#pragma unroll
          for (int i = 0; i < s; ++i) part[i] = __fadd_rn(part[i], part[i + s]);
        float sc = part[0];
#pragma unroll
        for (int off = TPP / 2; off >= 1; off /= 2)
          sc = __fadd_rn(sc, __shfl_xor_sync(0xffffffffu, sc, off));
        if (r == 0 && pos < x.c1) ss[pos - x.w0] = __fmul_rn(sc, scale);
      }
      if (x.c == x.nc - 1) {
        // the segment's softmax steps: pool block jj covers its
        // min(bs, len - jj bs) live positions. Its max, a warp per block
        // (fmaxf is exact in any order)
        __syncthreads();
        for (int jj = warp; jj < nbs; jj += THREADS / 32) {
          const int n = min(bs, len - jj * bs);
          float mb = NEG_INF;
          for (int t = lane; t < n; t += 32) mb = fmaxf(mb, ss[jj * bs + t]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
          if (lane == 0) bmax[jj] = mb;
        }
        __syncthreads();
        // the running max through the blocks, m = fmaxf(m, max_j) in
        // turn from m_run, carried by every thread that needs it: block
        // jj's correction, and each position's weight, once
        for (int jj = tid; jj < nbs; jj += THREADS) {
          float m = m_run;
#pragma unroll 8
          for (int k = 0; k < jj; ++k) m = fmaxf(m, bmax[k]);
          const float mn = fmaxf(m, bmax[jj]);
          corr[jj] = rescale(m, mn);
          mnew[jj] = mn;
        }
        for (int t = tid; t < len; t += THREADS) {
          float m = m_run;
#pragma unroll 8
          for (int k = 0; k <= t / bs; ++k) m = fmaxf(m, bmax[k]);
          ss[t] = prob(ss[t], m);
        }
        for (int e = tid; e < nbs * dp; e += THREADS) abuf[e] = 0.f;
      }
    } else {
      // V: each (pool block, dim) chain over the chunk's positions, in
      // position order, carried in abuf from chunk to chunk; "dim" d is
      // the block's psum, the add chain of its weights
      const int jlo = (x.c0 - x.w0) / bs;
      const int jn = (x.c1 - 1 - x.w0) / bs - jlo + 1;
      for (int e = tid; e < jn * dp; e += THREADS) {
        const int jj = jlo + e / dp;
        const int dim = e % dp;
        const int t0 = max(x.c0, x.w0 + jj * bs) - x.w0;
        const int t1 = min(x.c1, x.w0 + (jj + 1) * bs) - x.w0;
        const int r0 = x.c0 - x.w0;  // the chunk's first row
        float a = abuf[jj * dp + dim];
        if (dim < d) {
#pragma unroll 4
          for (int t = t0; t < t1; ++t)
            a = __fmaf_rn(ss[t], to_float(tile[(t - r0) * stride + dim]), a);
        } else {
#pragma unroll 4
          for (int t = t0; t < t1; ++t) a = __fadd_rn(a, ss[t]);
        }
        abuf[jj * dp + dim] = a;
      }
      if (x.c == x.nc - 1) {
        // fold the segment's pool blocks into the output and the running
        // sum, in order
        __syncthreads();
        for (int dim = tid; dim < d; dim += THREADS) {
          float acc = accb[dim];
#pragma unroll 8
          for (int jj = 0; jj < nbs; ++jj)
            acc = fold(acc, corr[jj], abuf[jj * dp + dim]);
          accb[dim] = acc;
        }
        if (tid == 0) {
          float l = l_run;
          for (int jj = 0; jj < nbs; ++jj)
            l = fold(l, corr[jj], abuf[jj * dp + d]);
          l_run = l;
          m_run = mnew[nbs - 1];
        }
      }
    }
    __syncthreads();  // the slot is restaged, the segment rewritten, after this
  }
  for (int e = tid; e < d; e += THREADS)
    out[qoff + e] = finish(accb[e], l_run);
}

template <typename TP>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int b,
                   int h, int d, int num_blocks, int bs, int nb, float scale,
                   cudaStream_t stream) {
  Plan pl;
  pl.stride = d + 16 / (int)sizeof(TP);
  const int rowb = pl.stride * (int)sizeof(TP);
  pl.nbw = max(1, min(min(SEG_POS / bs, SEG_BLOCKS), ABUF_FLOATS / d));
  pl.tabn = min(nb, TAB_SMEM);
  // the query, the output, a segment's scores and chains, and the table
  // head; the ring takes what is left, up to CHUNK_BYTES a slot
  const int rest =
      4 * (2 * d + pl.nbw * bs + pl.nbw * (d + 1) + 3 * pl.nbw + pl.tabn);
  pl.ch = min(CH_MAX, min(CHUNK_BYTES, (SMEM_BUDGET - rest - 16) / STAGES) /
                          rowb);
  if (pl.ch < 1) return cudaErrorInvalidValue;
  const int smem = (STAGES * pl.ch * rowb + 15) / 16 * 16 + rest;
  static int opted[MAX_DEVICES];
  const cudaError_t e =
      smem_opt_in(paged_decode_kernel<TP>, opted, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(b, h);
  paged_decode_kernel<TP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(out), h, d,
      num_blocks, bs, nb, scale, pl);
  return cudaGetLastError();
}

}  // namespace

// page_dtype: 0 = float32, 1 = bfloat16, 2 = float16; q and out are
// float32. The pages must be 16-byte aligned (cp.async). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_paged_decode(const void* q, const void* kp, const void* vp,
                                const void* tables, const void* lens,
                                void* out, int b, int h, int d, int num_blocks,
                                int bs, int nb, float scale, int page_dtype,
                                void* stream) {
  if (b < 1 || h < 1 || h > 65535 || d < 8 || d % 8 != 0 || d > MAX_D ||
      bs < 1 || bs > MAX_BS || nb < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_dtype == 0)
    return launch<float>(q, kp, vp, tables, lens, out, b, h, d, num_blocks,
                         bs, nb, scale, s);
  if (page_dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tables, lens, out, b, h, d,
                                 num_blocks, bs, nb, scale, s);
  if (page_dtype == 2)
    return launch<__half>(q, kp, vp, tables, lens, out, b, h, d, num_blocks,
                          bs, nb, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
