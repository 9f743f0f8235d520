// Pieces shared by the paged-attention kernels paged_decode.cu (one query
// per sequence) and paged_decode_multi.cu (T query lanes per sequence).
//
// Both kernels score a K row against a query with the same warp dot
// product and update the online softmax with the same operations in the
// same order, written here once with explicitly rounded intrinsics
// (__fmaf_rn, __fmul_rn, __fsub_rn: no contraction left to the compiler).
// So lane t of the multi-query kernel computes, bit for bit, what the
// single-query kernel computes for a sequence whose context length is
// lane t's: the speculative verify pass reproduces target-only decoding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace paged {

constexpr int THREADS = 128;       // one thread per head dimension, D <= 128
constexpr int WARPS = THREADS / 32;
constexpr int KREG = THREADS / 32; // head dimensions per warp lane
constexpr int MAX_BS = 256;        // tokens per pool block
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

// This warp lane's share of one K row: dimensions lane, lane + 32, ...
// (neighbouring lanes read neighbouring words).
template <typename TP>
__device__ __forceinline__ void load_row(const TP* __restrict__ row, int d,
                                         int lane, float (&k)[KREG]) {
#pragma unroll
  for (int c = 0; c < KREG; ++c) {
    const int dd = lane + 32 * c;
    k[c] = dd < d ? to_float(row[dd]) : 0.f;
  }
}

// Scaled score of the K row held by load_row against the query qs (shared
// memory, float32): each lane sums its dimensions in order, then the
// xor-shuffle tree adds the 32 partials. Every lane returns the result.
__device__ __forceinline__ float score(const float* qs, const float (&k)[KREG],
                                       int d, int lane, float scale) {
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < KREG; ++c) {
    const int dd = lane + 32 * c;
    if (dd < d) part = __fmaf_rn(qs[dd], k[c], part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  return __fmul_rn(part, scale);
}

// Online-softmax state of one query row: running max m, running sum l and
// this thread's output dimension acc.
struct Softmax {
  float m = NEG_INF;
  float l = 0.f;
  float acc = 0.f;
};

// One pool block's step, split in three so the multi-query kernel can
// read each V row once for all its lanes:
//   begin(ss, n)       — max over the block's n live scores, the new max
//                        and the correction of the old sums;
//   add(s, v)          — one live token: p = exp(s - m_new), summed into
//                        psum and, weighted by V[t, dim], into a;
//   end()              — fold the block's sums into the running state.
struct BlockStep {
  float m_new;
  float corr;
  float psum = 0.f;
  float a = 0.f;

  __device__ __forceinline__ void begin(const Softmax& st, const float* ss,
                                        int n) {
    float m_blk = NEG_INF;
    for (int t = 0; t < n; ++t) m_blk = fmaxf(m_blk, ss[t]);
    m_new = fmaxf(st.m, m_blk);
    corr = expf(__fsub_rn(st.m, m_new));
    psum = 0.f;
    a = 0.f;
  }
  __device__ __forceinline__ void add(float s, float v) {
    const float p = expf(__fsub_rn(s, m_new));
    psum = __fadd_rn(psum, p);
    a = __fmaf_rn(p, v, a);
  }
  __device__ __forceinline__ void end(Softmax& st) const {
    st.l = __fmaf_rn(st.l, corr, psum);
    st.acc = __fmaf_rn(st.acc, corr, a);
    st.m = m_new;
  }
};

// The row's output: acc / l, with l clamped so an empty row gives exactly 0.
__device__ __forceinline__ float finish(const Softmax& st) {
  return __fdiv_rn(st.acc, fmaxf(st.l, 1e-30f));
}

}  // namespace paged
