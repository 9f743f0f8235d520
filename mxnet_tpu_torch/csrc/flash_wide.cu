// Flash attention for head dimensions past 256 (forward, dK/dV and dQ),
// for Hopper (sm_90a), on the CUDA cores in float32.
//
// Replaces the same Pallas TPU kernels as flash_fwd.cu, flash_bwd_dkv.cu
// and flash_bwd_dq.cu (mxnet_tpu/ops/attention.py::_pallas_forward and
// the two kernels of ::_pallas_backward) at the head dimensions those
// three do not take: their K/V ring alone would need 2*2*32*(D+4)*4 bytes
// of shared memory, 264 KB at D 512 against the 227 KB a block has, and
// a full output row of accumulators would not fit the registers. Same
// contract as theirs: q/k/v (and dout) (B,H,S,D) in float32, bfloat16 or
// float16, any D % 8 == 0, computed in float32; out, lse, dk, dv and dq in
// float32. Masked scores are pinned to -1e30, l is clamped at 1e-30.
//
// The forward and the backward agree on every score bit: each score is one
// fmaf chain over d = 0, 1, ..., D-1 in that order, from 0 (an fmaf's
// product is exact, so swapping its two factors, as dK/dV does with K's
// rows owned, changes nothing), then multiplied by the scale once. The
// backward's p = exp(s*scale - lse) therefore sees exactly the forward's
// s. No chain is split across threads and none runs on the tensor cores.
//
// Forward and dQ (wide_fwd_kernel, wide_dq_kernel). What bounds them, as
// measured on an H100 (profile_kernels_torch.py's variants and a per-block
// timeline): the fmaf chains of S (and dP), which stay one thread per
// score, and the copies of K and V into shared memory, whose issue stalls
// for most of a chunk's time; not the arithmetic's rate. The design forms
// each score tile once:
//   - a block of 256 threads owns RB = 16 rows (queries) and the whole
//     output D up to WMAX = 512 columns; past that the output is cut into
//     ceil(D / 512) equal slices (a multiple of 8 wide) on the grid's z
//     axis, each forming S over the full D again; the cut depends on D
//     alone;
//   - for one slice (D <= 512) the block's Q rows (and dO's in dQ) are
//     staged into shared memory once; past it they stream with K;
//   - keys come in tiles of KB = 64. A tile's work is a run of chunks
//     through a ring of 16-byte cp.async copies (dynamic shared memory,
//     opted in past 48 KB; 2 stages in the forward, 4 in dQ), issued by
//     the four warps that form neither S nor dP, so that the chains do not
//     wait on the issue; one barrier per chunk: first K (and V in dQ) in
//     chunks of 128 (dQ 64) dimensions for S (and dP), then V (dQ: K) in
//     chunks of VC = 16 keys over the slice's columns for the output
//     product;
//   - S: four warps form the 16x64 tile in the forward, each thread 4 rows
//     x 2 keys; in dQ two warps form S and two dP, each thread 4 rows x 4
//     keys; every thread reads 4 dimensions of a row per 16-byte load
//     (lanes: 4 row groups x 8 key groups) into 8 or 16 independent
//     chains;
//   - the online softmax (forward) or dS = p (dP - delta) scale (dQ) goes
//     to shared memory; the output product is fmaf with one accumulator
//     per output element, each thread 4 rows x 8 columns of its warp's 64.
//
// dK/dV (wide_dkv_kernel) mirrors them with the roles of rows and keys
// swapped, so that each key's sums stay in one block (no atomics, the
// result bitwise repeatable). What bounds it, as measured on an H100
// (profile_kernels_torch.py's variants): the S^T and dP^T chains, on four
// of the eight warps, take about two fifths of its time, the copies,
// barriers and P/dS step about as much, the output products the rest; not
// the arithmetic's rate. The design:
//   - a block of 256 threads owns KR = 16 keys and all of dK and dV up to
//     WMAX = 512 columns, in registers (each thread 4 keys x 8 columns of
//     each), in the same ceil(D / 512) slices on z past that; S^T and dP^T
//     are formed once per (key block, query tile) up to D 512;
//   - for D <= 512 the block's K and V rows stay in shared memory in the
//     input dtype; past it they stream with the queries;
//   - the queries come in tiles of QT = 16 rows through a two-stage ring of
//     cp.async copies issued by the four warps that form neither S^T nor
//     dP^T, each warp taking whole rows: up to D 512 one stage holds a
//     tile's Q and dO rows whole, with its lse and delta, so that the score
//     chains and both output products read Q and dO from one copy (past
//     it: S chunks of 128 dimensions, then output chunks of 8 query rows
//     over the slice's columns);
//   - two warps form S^T = K.Q^T and two dP^T = V.dO^T, each thread 4
//     keys x 1 query, one in-order fmaf chain over d per score as above,
//     32 dimensions per unrolled step; P^T and dS^T = P^T (dP^T - delta)
//     scale go to shared memory; then all eight warps add dV += P^T.dO and
//     dK += dS^T.Q, one fmaf per query in order;
//   - causal: query tiles before the block's first key are skipped, the
//     key blocks that see the most queries are dispatched first, and keys
//     that no query sees (keys >= Sq) write exact zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // cp.async and the shared-memory opt-in

namespace {

using tf32mma::cp_async16;
using tf32mma::cp_async4;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait;

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------ tiles
constexpr int FWD_RB = 16;   // rows (queries) a block owns: forward
constexpr int DQ_RB = 16;    // dQ
constexpr int KB = 64;       // keys per tile
constexpr int WMAX = 512;    // output columns a block holds at most
constexpr int FWD_DC = 128;  // dimensions per S chunk (forward)
constexpr int DQ_DC = 64;    // dimensions per S/dP chunk (dQ)
constexpr int VC = 16;       // keys per output-product chunk
constexpr int FWD_STAGES = 2;  // depth of the cp.async ring (forward)
constexpr int DQ_STAGES = 4;   // (dQ)
constexpr int NT = 256;      // threads per block
constexpr int WARPS = NT / 32;
// the copies are issued by the threads from ISSUERS on: the warps that do
// not form S or dP, so that those that do are not held up by the issue
constexpr int ISSUERS = 128;

// S: S_WARPS warps form the RB x KB tile (in dQ as many more form dP),
// each thread RB / 4 rows x KB / (8 S_WARPS) keys; output: a warp holds
// 64 columns of every row, each thread RB / 4 rows x 8 columns
constexpr int FWD_S_WARPS = 4;
constexpr int DQ_S_WARPS = 2;
static_assert(KB % (8 * FWD_S_WARPS) == 0 && KB % (8 * DQ_S_WARPS) == 0 &&
                  2 * DQ_S_WARPS <= WARPS && FWD_S_WARPS <= WARPS,
              "S warp tiles must cover RB x KB");
static_assert(WARPS * 64 == WMAX, "output warp tiles must cover WMAX");
static_assert(ISSUERS % 32 == 0 && ISSUERS < NT, "whole warps issue");
static_assert(KB % 32 == 0 && FWD_RB % 8 == 0 && DQ_RB % 8 == 0 &&
                  KB % VC == 0 && VC % 4 == 0,
              "tile shapes");

// dK/dV: a block owns KR keys and streams the queries in tiles of QT rows.
// With K/V resident (D <= WMAX) an S chunk covers DKV_DC dimensions; at
// WMAX a tile's Q and dO rows are staged whole, once, and the output
// products read that same stage. Otherwise (K/V streamed, or a narrower
// DKV_DC) S chunks of DKV_SDC (DKV_DC) dimensions are followed by output
// chunks of OC query rows over the slice's columns.
constexpr int KR = 16;
constexpr int QT = 16;
constexpr int DKV_DC = WMAX;
constexpr int DKV_SDC = 128;
constexpr int OC = 8;
constexpr int DKV_STAGES = 2;
// S^T on warps [0, DKV_S_WARPS), dP^T on as many more: each thread KR / 4
// keys x QT / (8 DKV_S_WARPS) queries, its chains' loop over d unrolled
// DKV_UNROLL times; the outputs as the forward's, each thread KR / 4 keys x
// 8 columns of dV and of dK
constexpr int DKV_S_WARPS = 2;
constexpr int DKV_UNROLL = 8;
static_assert(QT % (8 * DKV_S_WARPS) == 0 && 2 * DKV_S_WARPS <= WARPS &&
                  KR % 4 == 0 && QT % OC == 0 && OC % 4 == 0 &&
                  DKV_DC % 8 == 0 && DKV_SDC % 8 == 0 && DKV_STAGES >= 2,
              "dK/dV tile shapes");
// every grid's y extent stays within 65535 for sq, sk <= 16 * 65535
static_assert(FWD_RB >= 16 && DQ_RB >= 16 && KR >= 16, "grid y extent");

// a row of staged elements is padded by 16 bytes, so that rows 1..7
// apart fall on distinct banks
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// elements of T in one ring stage: an S chunk (Q's rows when they stream,
// then K's; in dQ also dO's and V's) or an output-product chunk (VC rows
// of WMAX columns)
template <typename T, bool QRES, bool DQ, int RB = DQ ? DQ_RB : FWD_RB>
__host__ __device__ constexpr int stage_elems() {
  return cmax(((QRES ? 0 : RB) + KB) * (DQ ? 2 : 1) *
                  ((DQ ? DQ_DC : FWD_DC) + pad<T>()),
              VC * (WMAX + pad<T>()));
}

// dynamic shared memory of a block: resident Q (and dO) rows, the ring,
// the probability or dS tile, and (forward) m, l and the correction
template <typename T, bool QRES, bool DQ, int RB = DQ ? DQ_RB : FWD_RB>
__host__ __device__ constexpr int smem_bytes() {
  return (QRES ? (DQ ? 2 : 1) * RB * (WMAX + pad<T>()) : 0) *
             static_cast<int>(sizeof(T)) +
         (DQ ? DQ_STAGES : FWD_STAGES) * stage_elems<T, QRES, DQ>() *
             static_cast<int>(sizeof(T)) +
         (DQ ? 2 : 1) * RB * (KB + 4) * 4 + (DQ ? 2 : 3) * RB * 4;
}

// dK/dV: dimensions per S chunk, and whether the output products read the
// S chunk's stage (KRES and one chunk holding Q's and dO's rows whole)
template <bool KRES>
__host__ __device__ constexpr int dkv_dc() {
  return KRES ? DKV_DC : DKV_SDC;
}
template <bool KRES>
__host__ __device__ constexpr bool dkv_fused() {
  return KRES && DKV_DC >= WMAX;
}

// elements of T in one dK/dV ring stage: an S chunk (the tile's Q and dO
// rows, then K's and V's when they stream) or an output-product chunk (OC
// rows of Q and of dO over WMAX columns)
template <typename T, bool KRES>
__host__ __device__ constexpr int dkv_stage_elems() {
  return cmax((2 * QT + (KRES ? 0 : 2 * KR)) * (dkv_dc<KRES>() + pad<T>()),
              dkv_fused<KRES>() ? 0 : 2 * OC * (WMAX + pad<T>()));
}

// resident K and V rows, the ring, S^T then P^T and dP^T then dS^T, and a
// ring of the tiles' lse and delta
template <typename T, bool KRES>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return ((KRES ? 2 * KR * (WMAX + pad<T>()) : 0) +
          DKV_STAGES * dkv_stage_elems<T, KRES>()) *
             static_cast<int>(sizeof(T)) +
         (2 * KR * (QT + 4) + DKV_STAGES * 2 * QT) * 4;
}

// four consecutive elements as float (16 bytes of float, 8 of the others)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows [r0, r0 + n) x columns [c0, c0 + w) of x (rows of ld elements,
// `rows` of them) into dst (row stride `stride` elements), 16 bytes per
// cp.async from threads [ISSUERS, NT); rows past `rows` are zero-filled.
// w is a multiple of 8. ROWS: each issuing warp takes whole rows, its
// lanes across the row, with no division per copy (for rows of 32 copies
// or more; shorter rows leave lanes idle)
template <typename T, bool ROWS = false>
__device__ __forceinline__ void stage_async(T* dst, int stride,
                                            const T* __restrict__ x, int ld,
                                            int r0, int n, int rows, int c0,
                                            int w) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int per = w / E;
  const int t = threadIdx.x - ISSUERS;
  if (ROWS) {
    for (int r = t >> 5; r < n; r += (NT - ISSUERS) >> 5) {
      const bool in = r0 + r < rows;
      const T* src = in ? x + (size_t)(r0 + r) * ld + c0 : x;
      for (int c = (t & 31) * E; c < per * E; c += 32 * E)
        cp_async16(dst + r * stride + c, in ? src + c : x, in ? 16 : 0);
    }
    return;
  }
  for (int e = t; e < n * per; e += NT - ISSUERS) {
    const int r = e / per, c = (e - r * per) * E;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * stride + c,
               in ? x + (size_t)(r0 + r) * ld + c0 + c : x, in ? 16 : 0);
  }
}

// acc[i][k] += A[r + 4i] . B[c + 8k] over the staged dimensions [0, n):
// MR x NC chains, each one fmaf per dimension in order of d; the loop over
// d unrolled UNROLL times (4 dimensions a step)
template <typename T, int MR, int NC, int UNROLL = 2>
__device__ __forceinline__ void chains(float (&acc)[MR][NC],
                                       const T* __restrict__ a, int sa,
                                       const T* __restrict__ b, int sb, int n,
                                       int r, int c) {
  float4 x[MR], y[NC];
#pragma unroll (UNROLL)
  for (int j = 0; j < n; j += 4) {
#pragma unroll
    for (int i = 0; i < MR; ++i) x[i] = load4(a + (r + 4 * i) * sa + j);
#pragma unroll
    for (int k = 0; k < NC; ++k) y[k] = load4(b + (c + 8 * k) * sb + j);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        acc[i][k] = __fmaf_rn(x[i].x, y[k].x, acc[i][k]);
        acc[i][k] = __fmaf_rn(x[i].y, y[k].y, acc[i][k]);
        acc[i][k] = __fmaf_rn(x[i].z, y[k].z, acc[i][k]);
        acc[i][k] = __fmaf_rn(x[i].w, y[k].w, acc[i][k]);
      }
  }
}

// o[a][b][e] += sum over the chunk's N terms kc + t (keys; in dK/dV
// queries) of w[(li + 4a) * WS + kc + t] * Y[t][oc + 32 b + e], Y's rows
// YS elements apart: the output product of one chunk, terms in order, one
// fmaf per term
template <typename T, int TR, int N = VC, int WS = KB + 4,
          int YS = WMAX + pad<T>()>
__device__ __forceinline__ void out_product(float (&o)[TR][2][4],
                                            const float* __restrict__ w,
                                            const T* __restrict__ y, int kc,
                                            int li, int oc) {
#pragma unroll
  for (int t4 = 0; t4 < N; t4 += 4) {
    float4 p[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a)
      p[a] = *reinterpret_cast<const float4*>(w + (li + 4 * a) * WS + kc +
                                              t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const T* row = y + (t4 + e) * YS + oc;
      const float4 y0 = load4(row);
      const float4 y1 = load4(row + 32);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float pe = e == 0 ? p[a].x : e == 1 ? p[a].y : e == 2 ? p[a].z
                                                                     : p[a].w;
        o[a][0][0] = __fmaf_rn(pe, y0.x, o[a][0][0]);
        o[a][0][1] = __fmaf_rn(pe, y0.y, o[a][0][1]);
        o[a][0][2] = __fmaf_rn(pe, y0.z, o[a][0][2]);
        o[a][0][3] = __fmaf_rn(pe, y0.w, o[a][0][3]);
        o[a][1][0] = __fmaf_rn(pe, y1.x, o[a][1][0]);
        o[a][1][1] = __fmaf_rn(pe, y1.y, o[a][1][1]);
        o[a][1][2] = __fmaf_rn(pe, y1.z, o[a][1][2]);
        o[a][1][3] = __fmaf_rn(pe, y1.w, o[a][1][3]);
      }
    }
  }
}

// rows [row0, row0 + TR*4) of dst (ld columns) get o, columns c0 + oc +
// 32 b + (0..3) where they lie below `width`, each row divided by div[a]
template <int TR>
__device__ __forceinline__ void store_out(float* __restrict__ dst,
                                          const float (&o)[TR][2][4],
                                          const float (&div)[TR], int q0,
                                          int sq, int ld, int c0, int width,
                                          int li, int oc) {
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = q0 + li + 4 * a;
    if (row >= sq) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int col = oc + 32 * b;
      if (col >= width) continue;
      *reinterpret_cast<float4*>(dst + (size_t)row * ld + c0 + col) =
          make_float4(o[a][b][0] / div[a], o[a][b][1] / div[a],
                      o[a][b][2] / div[a], o[a][b][3] / div[a]);
    }
  }
}

// Forward for RB queries and one slice of the output's columns (all of
// them up to WMAX). QRES: the block's Q rows stay in shared memory.
template <typename T, bool QRES>
__global__ void __launch_bounds__(NT, FWD_RB == 16 ? 2 : 1)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int sq, int sk, int d, int w_slice,
                float scale, int causal) {
  constexpr int RB = FWD_RB;
  constexpr int TR = RB / 4, MR = RB / 4, NC = KB / (8 * FWD_S_WARPS);
  constexpr int P = pad<T>();
  constexpr int SE = stage_elems<T, QRES, false>();
  constexpr int KS = FWD_DC + P;       // row stride of an S chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qres = reinterpret_cast<T*>(smem_raw);
  T* ring = qres + (QRES ? RB * (WMAX + P) : 0);
  float* ps = reinterpret_cast<float*>(ring + FWD_STAGES * SE);
  float* m_s = ps + RB * (KB + 4);
  float* l_s = m_s + RB;
  float* corr_s = l_s + RB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int li = lane >> 3, lj = lane & 7;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * RB;
  const int c0 = blockIdx.z * w_slice;
  const int width = min(w_slice, d - c0);
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  const int kv_end = causal ? min(sk, q0 + RB) : sk;
  const int nk = (d + FWD_DC - 1) / FWD_DC;   // S chunks per tile
  const int per = nk + KB / VC;               // chunks per tile
  const int ntiles = (kv_end + KB - 1) / KB;
  const int total = ntiles * per;
  const int qs_stride = QRES ? d + P : KS;
  // S (warps below FWD_S_WARPS): rows li + 4i, keys sc + 8k of the tile
  const int sc = warp * 8 * NC + lj;
  // output: rows li + 4a, columns oc + 32b .. + 3 of the slice
  const int oc = warp * 64 + 4 * lj;

  if (tid < RB) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float o[TR][2][4] = {};
  float acc[MR][NC] = {};

  auto issue = [&](int n) {
    T* st = ring + (n % FWD_STAGES) * SE;
    const int t0 = n / per * KB, j = n % per;
    if (j < nk) {
      const int dc = j * FWD_DC, dn = min(FWD_DC, d - dc);
      if (!QRES) {
        stage_async(st, KS, qb, d, q0, RB, sq, dc, dn);
        st += RB * KS;
      }
      stage_async(st, KS, kb, d, t0, KB, sk, dc, dn);
    } else {
      stage_async(st, WMAX + P, vb, d, t0 + (j - nk) * VC, VC, sk, c0, width);
    }
  };

  if (QRES && tid >= ISSUERS) stage_async(qres, d + P, qb, d, q0, RB, sq, 0, d);
  for (int n = 0; n < FWD_STAGES - 1; ++n) {
    if (n < total && tid >= ISSUERS) issue(n);
    cp_async_commit();
  }
  for (int n = 0; n < total; ++n) {
    cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();
    if (n + FWD_STAGES - 1 < total && tid >= ISSUERS) issue(n + FWD_STAGES - 1);
    cp_async_commit();
    const T* st = ring + (n % FWD_STAGES) * SE;
    const int t0 = n / per * KB, j = n % per;
    if (j < nk) {
      const int dc = j * FWD_DC;
      if (warp < FWD_S_WARPS)
        chains(acc, QRES ? qres + dc : st, qs_stride,
               QRES ? st : st + RB * KS, KS, min(FWD_DC, d - dc), li, sc);
      if (j == nk - 1) {
        // the tile's scores, scaled once, masked
        if (warp < FWD_S_WARPS) {
#pragma unroll
          for (int a = 0; a < MR; ++a)
#pragma unroll
            for (int b = 0; b < NC; ++b) {
              const int row = q0 + li + 4 * a, key = t0 + sc + 8 * b;
              const bool ok = key < sk && (!causal || row >= key);
              ps[(li + 4 * a) * (KB + 4) + sc + 8 * b] =
                  ok ? acc[a][b] * scale : NEG_INF;
              acc[a][b] = 0.f;
            }
        }
        __syncthreads();
        // the online softmax: a warp updates RB / 8 rows, KB / 32 keys a lane
#pragma unroll
        for (int rr = 0; rr < RB / 8; ++rr) {
          const int row = warp * (RB / 8) + rr;
          float* pr = ps + row * (KB + 4);
          float s[KB / 32];
          float mx = NEG_INF;
#pragma unroll
          for (int i = 0; i < KB / 32; ++i) {
            s[i] = pr[lane + 32 * i];
            mx = fmaxf(mx, s[i]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_old = m_s[row];
          const float m_new = fmaxf(m_old, mx);
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < KB / 32; ++i) {
            const float p = expf(s[i] - m_new);
            pr[lane + 32 * i] = p;
            sum += p;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (lane == 0) {
            const float corr = expf(m_old - m_new);
            corr_s[row] = corr;
            l_s[row] = l_s[row] * corr + sum;
            m_s[row] = m_new;
          }
        }
      }
    } else {
      if (j == nk) {
        // the first V chunk of the tile: rescale by the softmax's correction
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          const float corr = corr_s[li + 4 * a];
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[a][b][e] *= corr;
        }
      }
      out_product(o, ps, st, (j - nk) * VC, li, oc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float lc[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) lc[a] = fmaxf(l_s[li + 4 * a], 1e-30f);
  store_out(out + (size_t)bh * sq * d, o, lc, q0, sq, d, c0, width, li, oc);
  if (blockIdx.z == 0 && tid < RB && q0 + tid < sq)
    lse[(size_t)bh * sq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// dK and dV for KR keys and one slice of their columns (all of them up to
// WMAX). KRES: the block's K and V rows stay in shared memory.
template <typename T, bool KRES>
__global__ void __launch_bounds__(NT, 1)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int sq, int sk, int d, int w_slice,
                float scale, int causal) {
  constexpr int TR = KR / 4, MR = KR / 4, NC = QT / (8 * DKV_S_WARPS);
  constexpr int P = pad<T>();
  constexpr int DC = dkv_dc<KRES>();
  constexpr bool FUSED = dkv_fused<KRES>();
  constexpr int SE = dkv_stage_elems<T, KRES>();
  constexpr int QS = DC + P;          // row stride of an S chunk
  constexpr int RS = WMAX + P;        // of the resident rows, output chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kres = reinterpret_cast<T*>(smem_raw);
  T* vres = kres + (KRES ? KR * RS : 0);
  T* ring = vres + (KRES ? KR * RS : 0);
  // S^T, then P^T in place; dP^T, then dS^T in place: [key][query]
  float* pss = reinterpret_cast<float*>(ring + DKV_STAGES * SE);
  float* dss = pss + KR * (QT + 4);
  float* rows = dss + KR * (QT + 4);  // per stage: lse [QT], delta [QT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int li = lane >> 3, lj = lane & 7;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * KR;
  const int c0 = blockIdx.z * w_slice;
  const int width = min(w_slice, d - c0);
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  // causal: query tiles that end before the block's first key see none of
  // its keys; keys that no query sees get no tile and write zeros
  const int q_begin = causal ? k0 / QT * QT : 0;
  const int ntiles = q_begin < sq ? (sq - q_begin + QT - 1) / QT : 0;
  const int nk = (d + DC - 1) / DC;              // S chunks per tile
  const int per = nk + (FUSED ? 0 : QT / OC);    // chunks per tile
  const int total = ntiles * per;
  // S^T (warps below DKV_S_WARPS) and dP^T (the next DKV_S_WARPS): keys
  // li + 4i, queries sc + 8k of the tile
  const int sc = warp % DKV_S_WARPS * 8 * NC + lj;
  const bool s_warp = warp < DKV_S_WARPS;
  const bool dp_warp = !s_warp && warp < 2 * DKV_S_WARPS;
  // output: keys li + 4a, columns oc + 32b .. + 3 of the slice
  const int oc = warp * 64 + 4 * lj;
  float dka[TR][2][4] = {}, dva[TR][2][4] = {};
  float acc[MR][NC] = {};

  // an S chunk holds [Q's rows, dO's rows, K's and V's when they stream];
  // the tile's last S chunk brings its lse and delta
  auto issue = [&](int n) {
    T* st = ring + (n % DKV_STAGES) * SE;
    const int t0 = q_begin + n / per * QT, j = n % per;
    if (j < nk) {
      const int dc = j * DC, dn = min(DC, d - dc);
      stage_async<T, true>(st, QS, qb, d, t0, QT, sq, dc, dn);
      stage_async<T, true>(st + QT * QS, QS, gb, d, t0, QT, sq, dc, dn);
      if (!KRES) {
        stage_async<T, true>(st + 2 * QT * QS, QS, kb, d, k0, KR, sk, dc,
                             dn);
        stage_async<T, true>(st + (2 * QT + KR) * QS, QS, vb, d, k0, KR, sk,
                             dc, dn);
      }
      const int e = threadIdx.x - ISSUERS;
      if (j == nk - 1 && e < QT) {
        float* ls = rows + (n % DKV_STAGES) * 2 * QT;
        const bool in = t0 + e < sq;
        const int at = in ? t0 + e : 0;
        cp_async4(ls + e, lb + at, in ? 4 : 0);
        cp_async4(ls + QT + e, db + at, in ? 4 : 0);
      }
    } else {
      const int r0 = t0 + (j - nk) * OC;
      stage_async<T, true>(st, RS, qb, d, r0, OC, sq, c0, width);
      stage_async<T, true>(st + OC * RS, RS, gb, d, r0, OC, sq, c0, width);
    }
  };

  if (KRES && total > 0 && tid >= ISSUERS) {
    stage_async<T, true>(kres, RS, kb, d, k0, KR, sk, 0, d);
    stage_async<T, true>(vres, RS, vb, d, k0, KR, sk, 0, d);
  }
  for (int n = 0; n < DKV_STAGES - 1; ++n) {
    if (n < total && tid >= ISSUERS) issue(n);
    cp_async_commit();
  }
  for (int n = 0; n < total; ++n) {
    cp_async_wait<DKV_STAGES - 2>();
    __syncthreads();
    if (n + DKV_STAGES - 1 < total && tid >= ISSUERS)
      issue(n + DKV_STAGES - 1);
    cp_async_commit();
    const T* st = ring + (n % DKV_STAGES) * SE;
    const int t0 = q_begin + n / per * QT, j = n % per;
    if (j < nk) {
      const int dc = j * DC, dn = min(DC, d - dc);
      const T* ks = KRES ? kres + dc : st + 2 * QT * QS;
      const T* vs = KRES ? vres + dc : st + (2 * QT + KR) * QS;
      if (s_warp)
        chains<T, MR, NC, DKV_UNROLL>(acc, ks, KRES ? RS : QS, st, QS, dn,
                                      li, sc);
      else if (dp_warp)
        chains<T, MR, NC, DKV_UNROLL>(acc, vs, KRES ? RS : QS, st + QT * QS,
                                      QS, dn, li, sc);
      if (j == nk - 1) {
        // S^T and dP^T of the tile into shared memory, then P^T and dS^T
        // in their place
        if (s_warp || dp_warp) {
          float* dst = s_warp ? pss : dss;
#pragma unroll
          for (int a = 0; a < MR; ++a)
#pragma unroll
            for (int b = 0; b < NC; ++b) {
              dst[(li + 4 * a) * (QT + 4) + sc + 8 * b] = acc[a][b];
              acc[a][b] = 0.f;
            }
        }
        __syncthreads();
        const float* ls = rows + (n % DKV_STAGES) * 2 * QT;
        for (int e = tid; e < KR * QT; e += NT) {
          const int r = e / QT, c = e % QT;
          const int key = k0 + r, row = t0 + c;
          const bool ok = row < sq && key < sk && (!causal || row >= key);
          float& s = pss[r * (QT + 4) + c];
          float& x = dss[r * (QT + 4) + c];
          const float p = ok ? expf(s * scale - ls[c]) : 0.f;
          x = ok ? p * (x - ls[QT + c]) * scale : 0.f;
          s = p;
        }
        if (FUSED) {
          // the output products from the same stage: dO's and Q's rows
          __syncthreads();
          out_product<T, TR, QT, QT + 4, QS>(dva, pss, st + QT * QS, 0, li,
                                             oc);
          out_product<T, TR, QT, QT + 4, QS>(dka, dss, st, 0, li, oc);
        }
      }
    } else {
      const int kc = (j - nk) * OC;
      out_product<T, TR, OC, QT + 4, RS>(dva, pss, st + OC * RS, kc, li, oc);
      out_product<T, TR, OC, QT + 4, RS>(dka, dss, st, kc, li, oc);
    }
  }
  cp_async_wait<0>();
  float one[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) one[a] = 1.f;
  store_out(dk + (size_t)bh * sk * d, dka, one, k0, sk, d, c0, width, li, oc);
  store_out(dv + (size_t)bh * sk * d, dva, one, k0, sk, d, c0, width, li, oc);
}

// dQ for RB queries and one slice of their columns (all of them up to
// WMAX). QRES: the block's Q and dO rows stay in shared memory.
template <typename T, bool QRES>
__global__ void __launch_bounds__(NT, 1)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int sq, int sk, int d, int w_slice,
               float scale, int causal) {
  constexpr int RB = DQ_RB;
  constexpr int TR = RB / 4, MR = RB / 4, NC = KB / (8 * DQ_S_WARPS);
  constexpr int P = pad<T>();
  constexpr int SE = stage_elems<T, QRES, true>();
  constexpr int KS = DQ_DC + P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qres = reinterpret_cast<T*>(smem_raw);
  T* gres = qres + (QRES ? RB * (WMAX + P) : 0);
  T* ring = gres + (QRES ? RB * (WMAX + P) : 0);
  float* dss = reinterpret_cast<float*>(ring + DQ_STAGES * SE);
  float* sss = dss + RB * (KB + 4);   // the tile's S chains, then dS in dss
  float* lse_s = sss + RB * (KB + 4);
  float* delta_s = lse_s + RB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int li = lane >> 3, lj = lane & 7;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * RB;
  const int c0 = blockIdx.z * w_slice;
  const int width = min(w_slice, d - c0);
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const int kv_end = causal ? min(sk, q0 + RB) : sk;
  const int nk = (d + DQ_DC - 1) / DQ_DC;
  const int per = nk + KB / VC;
  const int ntiles = (kv_end + KB - 1) / KB;
  const int total = ntiles * per;
  const int qs_stride = QRES ? d + P : KS;
  // S (warps below DQ_S_WARPS) and dP (the next DQ_S_WARPS): rows li + 4i,
  // keys sc + 8k of the tile
  const int sc = warp % DQ_S_WARPS * 8 * NC + lj;
  const bool s_warp = warp < DQ_S_WARPS;
  const bool dp_warp = !s_warp && warp < 2 * DQ_S_WARPS;
  const int oc = warp * 64 + 4 * lj;
  if (tid < RB) {
    const int row = q0 + tid;
    lse_s[tid] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    delta_s[tid] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  float o[TR][2][4] = {};
  float acc[MR][NC] = {};

  // an S chunk holds [Q's rows, dO's rows when they stream,] K's, V's
  auto issue = [&](int n) {
    T* st = ring + (n % DQ_STAGES) * SE;
    const int t0 = n / per * KB, j = n % per;
    if (j < nk) {
      const int dc = j * DQ_DC, dn = min(DQ_DC, d - dc);
      if (!QRES) {
        stage_async(st, KS, qb, d, q0, RB, sq, dc, dn);
        stage_async(st + RB * KS, KS, gb, d, q0, RB, sq, dc, dn);
        st += 2 * RB * KS;
      }
      stage_async(st, KS, kb, d, t0, KB, sk, dc, dn);
      stage_async(st + KB * KS, KS, vb, d, t0, KB, sk, dc, dn);
    } else {
      stage_async(st, WMAX + P, kb, d, t0 + (j - nk) * VC, VC, sk, c0, width);
    }
  };

  if (QRES && tid >= ISSUERS) {
    stage_async(qres, d + P, qb, d, q0, RB, sq, 0, d);
    stage_async(gres, d + P, gb, d, q0, RB, sq, 0, d);
  }
  for (int n = 0; n < DQ_STAGES - 1; ++n) {
    if (n < total && tid >= ISSUERS) issue(n);
    cp_async_commit();
  }
  for (int n = 0; n < total; ++n) {
    cp_async_wait<DQ_STAGES - 2>();
    __syncthreads();
    if (n + DQ_STAGES - 1 < total && tid >= ISSUERS) issue(n + DQ_STAGES - 1);
    cp_async_commit();
    const T* st = ring + (n % DQ_STAGES) * SE;
    const int t0 = n / per * KB, j = n % per;
    if (j < nk) {
      const int dc = j * DQ_DC, dn = min(DQ_DC, d - dc);
      const T* ks = QRES ? st : st + 2 * RB * KS;
      if (s_warp)
        chains(acc, QRES ? qres + dc : st, qs_stride, ks, KS, dn, li, sc);
      else if (dp_warp)
        chains(acc, QRES ? gres + dc : st + RB * KS, qs_stride, ks + KB * KS,
               KS, dn, li, sc);
      if (j == nk - 1) {
        // S and dP of the tile into shared memory, then dS in place of dP,
        // read after the next chunk's barrier
        if (s_warp || dp_warp) {
          float* dst = s_warp ? sss : dss;
#pragma unroll
          for (int a = 0; a < MR; ++a)
#pragma unroll
            for (int b = 0; b < NC; ++b) {
              dst[(li + 4 * a) * (KB + 4) + sc + 8 * b] = acc[a][b];
              acc[a][b] = 0.f;
            }
        }
        __syncthreads();
        for (int e = tid; e < RB * KB; e += NT) {
          const int r = e / KB, c = e % KB;
          const int row = q0 + r, key = t0 + c;
          const bool ok = row < sq && key < sk && (!causal || row >= key);
          const float sv = sss[r * (KB + 4) + c];
          const float p = ok ? expf(sv * scale - lse_s[r]) : 0.f;
          float& x = dss[r * (KB + 4) + c];
          x = ok ? p * (x - delta_s[r]) * scale : 0.f;
        }
      }
    } else {
      out_product(o, dss, st, (j - nk) * VC, li, oc);
    }
  }
  cp_async_wait<0>();
  float one[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) one[a] = 1.f;
  store_out(dq + (size_t)bh * sq * d, o, one, q0, sq, d, c0, width, li, oc);
}

static_assert(smem_bytes<float, true, true>() <= 232448 &&
                  smem_bytes<float, false, true>() <= 232448 &&
                  smem_bytes<float, true, false>() <= 232448 &&
                  smem_bytes<float, false, false>() <= 232448 &&
                  dkv_smem_bytes<float, true>() <= 232448 &&
                  dkv_smem_bytes<float, false>() <= 232448,
              "shared memory past the 227 KB a block has");

// the three kernels' cut of the output columns: ceil(d / WMAX) slices of
// equal width, a multiple of 8, on the grid's z axis
int slices(int d) { return (d + WMAX - 1) / WMAX; }
int slice_width(int d) {
  const int n = slices(d);
  return ((d + n - 1) / n + 7) / 8 * 8;
}

// the wide route's envelope: sq and sk up to 16 * 65535 (the grids' y
// extent at 16 rows or keys a block), D a multiple of 8 up to 128 * 65535
bool shape_ok(int bh, int sq, int sk, int d) {
  return d >= 8 && d % 8 == 0 && bh >= 1 && sq >= 1 && sk >= 1 &&
         (sq + 15) / 16 <= 65535 && (sk + 15) / 16 <= 65535 &&
         (d + 127) / 128 <= 65535;
}

template <typename T, bool QRES>
cudaError_t fwd_launch(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int sq, int sk, int d,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, QRES, false>();
  static bool opted_in[tf32mma::MAX_DEVICES];
  const cudaError_t e =
      tf32mma::smem_opt_in(wide_fwd_kernel<T, QRES>, opted_in, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (sq + FWD_RB - 1) / FWD_RB, slices(d));
  wide_fwd_kernel<T, QRES><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d, slice_width(d), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int bh, int sq, int sk, int d, float scale,
                int causal, cudaStream_t stream) {
  return d <= WMAX ? fwd_launch<T, true>(q, k, v, out, lse, bh, sq, sk, d,
                                         scale, causal, stream)
                   : fwd_launch<T, false>(q, k, v, out, lse, bh, sq, sk, d,
                                          scale, causal, stream);
}

template <typename T, bool KRES>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<T, KRES>();
  static bool opted_in[tf32mma::MAX_DEVICES];
  const cudaError_t e =
      tf32mma::smem_opt_in(wide_dkv_kernel<T, KRES>, opted_in, smem);
  if (e != cudaSuccess) return e;
  // key blocks in order: causal, the first ones see the most queries and
  // are dispatched first
  const dim3 grid(bh, (sk + KR - 1) / KR, slices(d));
  wide_dkv_kernel<T, KRES><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d,
      slice_width(d), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv,
                int bh, int sq, int sk, int d, float scale, int causal,
                cudaStream_t stream) {
  return d <= WMAX ? dkv_launch<T, true>(q, k, v, g, lse, delta, dk, dv, bh,
                                         sq, sk, d, scale, causal, stream)
                   : dkv_launch<T, false>(q, k, v, g, lse, delta, dk, dv, bh,
                                          sq, sk, d, scale, causal, stream);
}

template <typename T, bool QRES>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq_, int bh, int sq, int sk, int d, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, QRES, true>();
  static bool opted_in[tf32mma::MAX_DEVICES];
  const cudaError_t e =
      tf32mma::smem_opt_in(wide_dq_kernel<T, QRES>, opted_in, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (sq + DQ_RB - 1) / DQ_RB, slices(d));
  wide_dq_kernel<T, QRES><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_), sq, sk, d, slice_width(d), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dq_, int bh, int sq,
               int sk, int d, float scale, int causal, cudaStream_t stream) {
  return d <= WMAX ? dq_launch<T, true>(q, k, v, g, lse, delta, dq_, bh, sq,
                                        sk, d, scale, causal, stream)
                   : dq_launch<T, false>(q, k, v, g, lse, delta, dq_, bh, sq,
                                         sk, d, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and dout share
// it). Each returns the launch's cudaGetLastError().
extern "C" int mxt_flash_wide_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int b, int h, int sq,
                                  int sk, int d, float scale, int causal,
                                  int dtype, void* stream) {
  if (!shape_ok(b * h, sq, sk, d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(q, k, v, out, lse, b * h, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(q, k, v, out, lse, b * h, sq, sk, d, scale,
                              causal, s);
  if (dtype == 2)
    return fwd<__half>(q, k, v, out, lse, b * h, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int mxt_flash_wide_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int b, int h,
                                      int sq, int sk, int d, float scale,
                                      int causal, int dtype, void* stream) {
  if (!shape_ok(b * h, sq, sk, d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv<float>(q, k, v, dout, lse, delta, dk, dv, b * h, sq, sk, d,
                      scale, causal, s);
  if (dtype == 1)
    return dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b * h, sq,
                              sk, d, scale, causal, s);
  if (dtype == 2)
    return dkv<__half>(q, k, v, dout, lse, delta, dk, dv, b * h, sq, sk, d,
                       scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int mxt_flash_wide_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq_, int b, int h, int sq, int sk,
                                     int d, float scale, int causal,
                                     int dtype, void* stream) {
  if (!shape_ok(b * h, sq, sk, d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dq<float>(q, k, v, dout, lse, delta, dq_, b * h, sq, sk, d, scale,
                     causal, s);
  if (dtype == 1)
    return dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq_, b * h, sq, sk,
                             d, scale, causal, s);
  if (dtype == 2)
    return dq<__half>(q, k, v, dout, lse, delta, dq_, b * h, sq, sk, d, scale,
                      causal, s);
  return cudaErrorInvalidValue;
}

static const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* mxt_flash_wide_fwd_error_string(int code) {
  return error_string(code);
}
extern "C" const char* mxt_flash_wide_bwd_dkv_error_string(int code) {
  return error_string(code);
}
extern "C" const char* mxt_flash_wide_bwd_dq_error_string(int code) {
  return error_string(code);
}
