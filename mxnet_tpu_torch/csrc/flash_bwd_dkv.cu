// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the first Pallas TPU kernel of
// mxnet_tpu/ops/attention.py::_pallas_backward (kernel_dkv: grid
// (B*H, k-blocks, q-blocks), q-blocks innermost, the (block_k, D) dK and dV
// accumulators carried in VMEM across the sequential q axis). Same contract:
// q/dout (B,H,Sq,D), k/v (B,H,Sk,D) in float32 or bfloat16, computed in
// float32; lse and delta = rowsum(dout*out) float32 (B,H,Sq); dk/dv float32
// (B,H,Sk,D). P is recomputed from lse: s = q.k * scale, pinned to -1e30
// where the key is past Sk or (causal) after the query, p = exp(s - lse)
// (exactly 0 where masked), dp = dout.v, ds = p * (dp - delta) * scale;
// dV += p^T dout and dK += ds^T q.
//
// What bounds it here: at the training shape (B=32, H=4, S=128, D=64,
// causal) the work is 8 FLOP per (q, k) pair and dimension, ~0.54 GFLOP
// over ~25 MB: about 8 us of float32 CUDA-core peak. The simple design
// keeps every sum on chip with no atomics and no split reduction: one
// thread block per (b*h, key tile); the TPU grid's q axis becomes a loop
// inside the block over 64-row q/dout tiles staged in shared memory as
// float32 (with their lse and delta), starting at the first tile that
// reaches the key tile when causal. L threads own one key row, each holding
// D/L dimensions of k, v and of the dK/dV accumulators in registers
// (dimension t*L + lane, so the L lanes read consecutive shared-memory words
// and every row of a warp reads the same ones); a pair's two dot products
// are reduced across the L lanes with shuffles. Each dK/dV element is
// written once, in a fixed order, so two launches give the same bits.
// CUDA cores in float32 only: tensor cores, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;    // query rows per shared-memory tile
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

// L: threads per key row (4 for D <= 64, 8 for D <= 128)
template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int d,
                     float scale, int causal) {
  constexpr int BK = THREADS / L;  // key rows per block
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][d]
  float* gs = qs + BQ * d;    // [BQ][d]  dout
  float* ls = gs + BQ * d;    // [BQ]     lse
  float* dl = ls + BQ;        // [BQ]     delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int row = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int kj = k0 + row;
  const bool live = kj < sk;

  const T* qb = q + (size_t)bh * sq * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;

  float kr[DPER], vr[DPER], dka[DPER], dva[DPER];
#pragma unroll
  for (int t = 0; t < DPER; ++t) {
    const int dd = t * L + lane;
    const bool in = live && dd < d;
    const size_t at = ((size_t)bh * sk + kj) * d + dd;
    kr[t] = in ? to_float(k[at]) : 0.f;
    vr[t] = in ? to_float(v[at]) : 0.f;
    dka[t] = 0.f;
    dva[t] = 0.f;
  }

  // causal: q-tiles that end before this key tile starts see none of it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    const int n = min(BQ, sq - q0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < BQ * d; e += THREADS) {
      const bool in = e / d < n;
      qs[e] = in ? to_float(qb[(size_t)q0 * d + e]) : 0.f;
      gs[e] = in ? to_float(gb[(size_t)q0 * d + e]) : 0.f;
    }
    for (int e = threadIdx.x; e < BQ; e += THREADS) {
      ls[e] = e < n ? lb[q0 + e] : 0.f;
      dl[e] = e < n ? db[q0 + e] : 0.f;
    }
    __syncthreads();

    // causal: rows before the tile's first key are masked for every key
    const int i_begin = causal ? max(0, k0 - q0) : 0;
    for (int i = i_begin; i < n; ++i) {
      const float* qrow = qs + i * d;
      const float* grow = gs + i * d;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int dd = t * L + lane;
        if (dd < d) {
          s += qrow[dd] * kr[t];
          dp += grow[dd] * vr[t];
        }
      }
      s = lane_sum<L>(s);
      dp = lane_sum<L>(dp);
      const bool ok = live && (!causal || q0 + i >= kj);
      const float p = ok ? expf(s * scale - ls[i]) : 0.f;
      const float ds = p * (dp - dl[i]) * scale;
#pragma unroll
      for (int t = 0; t < DPER; ++t) {
        const int dd = t * L + lane;
        if (dd < d) {
          dva[t] += p * grow[dd];
          dka[t] += ds * qrow[dd];
        }
      }
    }
  }

  if (live) {
    const size_t base = ((size_t)bh * sk + kj) * d;
#pragma unroll
    for (int t = 0; t < DPER; ++t) {
      const int dd = t * L + lane;
      if (dd < d) {
        dk[base + dd] = dka[t];
        dv[base + dd] = dva[t];
      }
    }
  }
}

template <typename T, int L>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int sq, int sk, int d,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int BK = THREADS / L;
  const int smem = (2 * BQ * d + 2 * BQ) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sk + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<T, L><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int sq, int sk, int d,
                     float scale, int causal, cudaStream_t stream) {
  if (d <= 4 * DPER)
    return launch<T, 4>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                        scale, causal, stream);
  if (d <= 8 * DPER)
    return launch<T, 8>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                        scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout share it). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b,
                                 int h, int sq, int sk, int d, float scale,
                                 int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dk, dv, b * h, sq, sk,
                           d, scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b * h,
                                   sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
