// Pieces shared by the paged-attention kernels paged_decode.cu (one query
// per sequence) and paged_decode_multi.cu (T query lanes per sequence).
//
// Both kernels score a K row against a query with the same dot product and
// update the online softmax with the same operations in the same order,
// written here once with explicitly rounded intrinsics (__fmaf_rn,
// __fmul_rn, __fsub_rn: no contraction left to the compiler). So lane t of
// the multi-query kernel computes, bit for bit, what the single-query
// kernel computes for a sequence whose context length is lane t's: the
// speculative verify pass reproduces target-only decoding.
//
// The score's arithmetic, whatever thread runs it: 32 partial sums, partial
// l an fma chain over dimensions l, l + 32, l + 64, ... in order from 0;
// then the tree that a warp's xor shuffles build, (p_l + p_{l^16}), then
// + its xor-8 partner, xor 4, 2, 1 (fadd is commutative, so every lane of
// the butterfly holds the same bits); then one multiply by the scale.
// paged_decode_multi.cu runs it with one warp per K row (lane l holds
// partial l); paged_decode.cu with TPP threads per row (thread r holds the
// partials l = r mod TPP and folds the tree's upper levels in registers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int KREG = 4;             // head dimensions per warp lane and chunk
constexpr int CHUNK_D = 32 * KREG;  // head dimensions per register chunk
constexpr float NEG_INF = -1e30f;
// the largest head dimension and pool block the kernels' shared memory
// holds at one query lane (ops/attention.py gates on the same numbers)
constexpr int MAX_D = 4096;
constexpr int MAX_BS = 16384;
// table slots kept in shared memory; slots past it are read from device
// memory (L1-cached) when a chunk is staged
constexpr int TAB_SMEM = 2048;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// This warp lane's share of one K row's chunk at dimension c0: dimensions
// c0 + lane, c0 + lane + 32, ... (neighbouring lanes read neighbouring
// words).
template <typename TP>
__device__ __forceinline__ void load_row(const TP* __restrict__ row, int c0,
                                         int d, int lane, float (&k)[KREG]) {
#pragma unroll
  for (int c = 0; c < KREG; ++c) {
    const int dd = c0 + lane + 32 * c;
    k[c] = dd < d ? to_float(row[dd]) : 0.f;
  }
}

// Partial `lane` of the score carried through the chunk at c0 of a K row
// held by load_row against the query qs (shared memory, float32).
__device__ __forceinline__ float dot_part(const float* qs,
                                          const float (&k)[KREG], int c0,
                                          int d, int lane, float part) {
#pragma unroll
  for (int c = 0; c < KREG; ++c) {
    const int dd = c0 + lane + 32 * c;
    if (dd < d) part = __fmaf_rn(qs[dd], k[c], part);
  }
  return part;
}

// The xor-shuffle tree over a warp's 32 partials, times the scale. Every
// lane returns the result.
__device__ __forceinline__ float warp_tree(float part, float scale) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  return __fmul_rn(part, scale);
}

// Scaled score of a K row of at most CHUNK_D dimensions held by load_row.
__device__ __forceinline__ float score(const float* qs, const float (&k)[KREG],
                                       int d, int lane, float scale) {
  return warp_tree(dot_part(qs, k, 0, d, lane, 0.f), scale);
}

// The online softmax's three roundings, named once so that every kernel
// that must agree with another (paged_decode_multi.cu with
// paged_decode.cu) performs them with the same operations:
//   rescale(m_old, m_new)  — the correction exp(m_old - m_new);
//   prob(s, m_new)         — a live token's weight exp(s - m_new);
//   fold(x, corr, part)    — the running sum x * corr + part (one fma).
// One pool block's step, over its n live positions in order: m_blk the
// fmaxf of its scores from NEG_INF; m_new = fmaxf(m, m_blk); corr =
// rescale(m, m_new); psum the __fadd_rn chain of prob(s, m_new) from 0 and
// each output dimension's a the __fmaf_rn chain of prob(s, m_new) * v
// from 0; then l = fold(l, corr, psum), acc = fold(acc, corr, a), m = m_new.
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return expf(__fsub_rn(m_old, m_new));
}
__device__ __forceinline__ float prob(float s, float m_new) {
  return expf(__fsub_rn(s, m_new));
}
__device__ __forceinline__ float fold(float x, float corr, float part) {
  return __fmaf_rn(x, corr, part);
}

// The row's output: acc / l, with l clamped so an empty row gives exactly 0.
__device__ __forceinline__ float finish(float acc, float l) {
  return __fdiv_rn(acc, fmaxf(l, 1e-30f));
}

// A pool block id of the sequence's table: slots below TAB_SMEM from the
// copy in shared memory, the rest from device memory.
__device__ __forceinline__ int table_slot(const int* tab, const int* row,
                                          int j) {
  return j < TAB_SMEM ? tab[j] : __ldg(row + j);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Opts `kernel` in to `bytes` of dynamic shared memory on the current
// device when it asks for more than before: `opted` is the caller's
// per-kernel record, a function-local static of the launching template.
template <typename K>
inline cudaError_t smem_opt_in(K kernel, int (&opted)[MAX_DEVICES],
                               int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && bytes <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) opted[dev] = bytes;
  return cudaSuccess;
}

}  // namespace paged
