// Tensor-core arithmetic at float32 accuracy, and the staging and launch
// helpers, shared by the flash-attention kernels: flash_fwd.cu (forward),
// flash_bwd_dkv.cu and flash_bwd_dq.cu (backward).
//
// Products run on mma.sync.m16n8k8 in TF32 with split operands:
//   - 3xTF32: x = big + small with big = tf32(x), small = tf32(x - big),
//     a.b summed as a_small.b_big + a_big.b_small + a_big.b_big (the
//     dropped small.small term is ~2^-22 of the product);
//   - the exact three-way split x = x1 + x2 + x3 (11 + 11 + 3 bits), in
//     the six products above 2^-33 of a.b, smallest first.
// Each 8-wide k-step is accumulated from zero and added to the running sums
// on the CUDA cores, rounded to nearest: the tensor core truncates as it
// accumulates, and a long chain of truncations biases the sums. bfloat16
// and float16 operands are exact in TF32 (8 and 10 explicit mantissa bits
// against TF32's 10, exponents inside float32's range) and need no split.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16x8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8, col):  b0 (k t, n g), b1 (k t+4, n g)
//   C (16x8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// A C fragment feeds the next product as its A operand with no shuffle
// when that product's k-step takes its 8 columns in the order
// (0,2,4,6,1,3,5,7): a = {c0, c2, c1, c3}, and B's rows are read in that
// order (b0 from column 2t, b1 from column 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// x rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 computes for finite x), in two integer operations:
// the cvt instruction is slower here (profile_kernels_torch.py times both).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (exact as float32 bit patterns)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a.b over one m16n8k8 tile, float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = x1 + x2 + x3 exactly, each TF32: x1 takes x's top 11 bits, x2 the
// next 11 of the remainder, x3 what is left (at most 3 bits)
__device__ __forceinline__ void split3(float x, uint32_t& x1, uint32_t& x2,
                                       uint32_t& x3) {
  x1 = tf32(x);
  const float r = x - __uint_as_float(x1);
  x2 = tf32(r);
  x3 = __float_as_uint(r - __uint_as_float(x2));
}

// the two TF32 operands of a B fragment element: split, or exact as it is
template <bool EXACT>
__device__ __forceinline__ void operand(float x, uint32_t& big,
                                        uint32_t& small) {
  if (EXACT)
    big = __float_as_uint(x);
  else
    split(x, big, small);
}

// acc[u] += L.R_u over one k-step (8 dimensions), for the products of two
// row-major inputs (Q.K^T, dO.V^T): L is the row side (Q or dO), R the key
// side (K or V); a holds this thread's A fragment and b[u] its B fragment
// of n-tile u. L_IS_A: L is the A operand (rows = queries), else R is
// (rows = keys); an element of the product sees the same products in the
// same order either way, into a fresh accumulator. PRODUCTS 6: the exact
// three-way split in flash_fwd.cu's order for Q.K^T, (L3,R1), (L2,R2),
// (L1,R3), (L2,R1), (L1,R2), (L1,R1); 3: 3xTF32 in its P.V order,
// (L_small,R_big), (L_big,R_small), (L_big,R_big). EXACT (bfloat16 or float16
// operands, exact in TF32): the one product L.R.
template <int PRODUCTS, bool EXACT, bool L_IS_A, int N>
__device__ __forceinline__ void kstep_lr(float (&acc)[N][4],
                                         const float (&a)[4],
                                         const float (&b)[N][2]) {
  static_assert(PRODUCTS == 6 || PRODUCTS == 3, "6 or 3 products");
  float tq[N][4] = {};
  // (L_p, R_q) is mma(a_p, b_q) when L is A, mma(a_q, b_p) when R is
#define MXT_PASS(P, Q)                                          \
  _Pragma("unroll") for (int u = 0; u < N; ++u) {               \
    if (L_IS_A)                                                 \
      mma(tq[u], a##P, b##Q[u]);                                \
    else                                                        \
      mma(tq[u], a##Q, b##P[u]);                                \
  }
  if (EXACT) {
    uint32_t a1[4], b1[N][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a1[i] = __float_as_uint(a[i]);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      b1[u][0] = __float_as_uint(b[u][0]);
      b1[u][1] = __float_as_uint(b[u][1]);
    }
    MXT_PASS(1, 1)
  } else if (PRODUCTS == 6) {
    uint32_t a1[4], a2[4], a3[4], b1[N][2], b2[N][2], b3[N][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split3(a[i], a1[i], a2[i], a3[i]);
#pragma unroll
    for (int u = 0; u < N; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) split3(b[u][i], b1[u][i], b2[u][i], b3[u][i]);
    MXT_PASS(3, 1)
    MXT_PASS(2, 2)
    MXT_PASS(1, 3)
    MXT_PASS(2, 1)
    MXT_PASS(1, 2)
    MXT_PASS(1, 1)
  } else {
    // 1 = big, 2 = small
    uint32_t a1[4], a2[4], b1[N][2], b2[N][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], a1[i], a2[i]);
#pragma unroll
    for (int u = 0; u < N; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) split(b[u][i], b1[u][i], b2[u][i]);
    MXT_PASS(2, 1)
    MXT_PASS(1, 2)
    MXT_PASS(1, 1)
  }
#undef MXT_PASS
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] += tq[u][i];
}

// acc[s] += p.y_s over one k-step: p is an A fragment of float32 values
// (probabilities or dS, always split), b[s] the B fragment of n-tile s
// (split, or exact for bfloat16 and float16). 3xTF32 into a fresh accumulator, in
// flash_fwd.cu's P.V order: (p_small, y_big), (p_big, y_small),
// (p_big, y_big); EXACT: the first and last.
template <bool EXACT, int N>
__device__ __forceinline__ void kstep_split(float (&acc)[N][4],
                                            const float (&a)[4],
                                            const float (&b)[N][2]) {
  uint32_t ab[4], as[4], bb[N][2], bs[N][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i) operand<EXACT>(b[u][i], bb[u][i], bs[u][i]);
  float tv[N][4] = {};
#pragma unroll
  for (int u = 0; u < N; ++u) mma(tv[u], as, bb[u]);
  if (!EXACT) {
#pragma unroll
    for (int u = 0; u < N; ++u) mma(tv[u], ab, bs[u]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) mma(tv[u], ab, bb[u]);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] += tv[u][i];
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// zero-fills the destination (a row past the end)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
// the same for one 4-byte word (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

constexpr int MAX_DEVICES = 64;

// The card's SM count and the opt-in to more than 48 KB of shared memory
// are asked for once per device, not on every launch.
inline cudaError_t sm_count(int* sms) {
  static int cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

// Opts `kernel` in to `bytes` of dynamic shared memory on the current
// device, once: `done` is the caller's per-kernel record of the devices
// already opted in (a function-local static of the launching template).
template <typename K>
inline cudaError_t smem_opt_in(K kernel, bool (&done)[MAX_DEVICES],
                               int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) done[dev] = true;
  return cudaSuccess;
}

}  // namespace tf32mma
