// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the second Pallas TPU kernel of
// mxnet_tpu/ops/attention.py::_pallas_backward (kernel_dq: grid
// (B*H, q-blocks, k-blocks), k-blocks innermost, the (block_q, D) dQ
// accumulator carried in VMEM across the sequential k axis). Same contract
// as flash_bwd_dkv.cu: q/dout (B,H,Sq,D), k/v (B,H,Sk,D) in float32 or
// bfloat16, computed in float32; lse and delta float32 (B,H,Sq); dq float32
// (B,H,Sq,D). P is recomputed from lse exactly as there, and
// dQ += ds k with ds = p * (dp - delta) * scale.
//
// What bounds it here: at the training shape (B=32, H=4, S=128, D=64,
// causal) the work is 6 FLOP per (q, k) pair and dimension, ~0.41 GFLOP
// over ~21 MB: about 6 us of either float32 CUDA-core peak or HBM
// bandwidth. The simple design mirrors flash_fwd.cu: one thread block per
// (b*h, query tile); the TPU grid's k axis becomes a loop inside the block
// over 64-key K/V tiles staged in shared memory as float32, stopping at the
// tile's last row when causal; the ragged Sk tail is zero-filled and masked.
// L threads own one query row, each holding D/L dimensions of q, dout and
// the dQ accumulator in registers, plus the row's lse and delta; a pair's
// two dot products are reduced across the L lanes with shuffles. Each dQ
// element is written once, in a fixed order: no atomics, no split
// reduction, the same bits on every launch. CUDA cores in float32 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;    // keys per shared-memory tile
constexpr int DPER = 16;  // dimensions per thread (D <= L * DPER)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int L>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// L: threads per query row (4 for D <= 64, 8 for D <= 128)
template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int sq, int sk, int d, float scale, int causal) {
  constexpr int BQ = THREADS / L;  // query rows per block
  extern __shared__ float smem[];
  float* ks = smem;           // [BK][d]
  float* vs = smem + BK * d;  // [BK][d]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int qi = q0 + row;
  const bool live = qi < sq;

  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  float qr[DPER], gr[DPER], acc[DPER];
#pragma unroll
  for (int t = 0; t < DPER; ++t) {
    const int dd = t * L + lane;
    const bool in = live && dd < d;
    const size_t at = ((size_t)bh * sq + qi) * d + dd;
    qr[t] = in ? to_float(q[at]) : 0.f;
    gr[t] = in ? to_float(dout[at]) : 0.f;
    acc[t] = 0.f;
  }
  const float l_i = live ? lse[(size_t)bh * sq + qi] : 0.f;
  const float d_i = live ? delta[(size_t)bh * sq + qi] : 0.f;

  // causal: tiles starting past the q-tile's last row are all masked
  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  for (int t0 = 0; t0 < kv_end; t0 += BK) {
    const int n = min(BK, sk - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < BK * d; e += THREADS) {
      const bool in = e / d < n;
      ks[e] = in ? to_float(kb[(size_t)t0 * d + e]) : 0.f;
      vs[e] = in ? to_float(vb[(size_t)t0 * d + e]) : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* krow = ks + j * d;
      const float* vrow = vs + j * d;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int dd = t * L + lane;
        if (dd < d) {
          s += qr[t] * krow[dd];
          dp += gr[t] * vrow[dd];
        }
      }
      s = lane_sum<L>(s);
      dp = lane_sum<L>(dp);
      const bool ok = live && (!causal || qi >= t0 + j);
      const float p = ok ? expf(s * scale - l_i) : 0.f;
      const float ds = p * (dp - d_i) * scale;
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int dd = t * L + lane;
        if (dd < d) acc[t] += ds * krow[dd];
      }
    }
  }

  if (live) {
    float* out = dq + ((size_t)bh * sq + qi) * d;
#pragma unroll
    for (int t = 0; t < DPER; ++t) {
      const int dd = t * L + lane;
      if (dd < d) out[dd] = acc[t];
    }
  }
}

template <typename T, int L>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int BQ = THREADS / L;
  const int smem = 2 * BK * d * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<T, L><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 4 * DPER)
    return launch<T, 4>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                        causal, stream);
  if (d <= 8 * DPER)
    return launch<T, 8>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                        causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout share it). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int b, int h,
                                int sq, int sk, int d, float scale, int causal,
                                int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dq, b * h, sq, sk, d,
                           scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b * h, sq,
                                   sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
