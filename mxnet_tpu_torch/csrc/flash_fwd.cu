// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/attention.py::_pallas_forward
// (grid (B*H, q-blocks, kv-blocks), online softmax carried in VMEM across
// the sequential kv axis). Same contract: q (B,H,Sq,D), k/v (B,H,Sk,D) in
// float32 or bfloat16, computed in float32; out float32 (B,H,Sq,D) and
// lse = m + log(l) float32 (B,H,Sq). Masked scores are pinned to -1e30 and
// l is clamped at 1e-30, as in the reference.
//
// What bounds it here: at the serving shapes (B=1, H=4, S<=128, D=64) the
// work is a few MFLOP over a few hundred KB, far below a microsecond of
// either peak; the kernel is bound by launch and latency. The simple design
// keeps it to one launch with no second pass: one thread block per
// (b*h, 64-row q-tile); the TPU grid's kv axis becomes a loop inside the
// block over 64-key K/V tiles staged in shared memory as float32; causal
// tiles that start past the q-tile's last row are never loaded; the ragged
// Sk tail is zero-filled and masked. Four threads own one query row, each
// holding a quarter of q and of the accumulator in registers (dimension
// i*4 + lane, so the four read consecutive shared-memory words and the
// eight rows of a warp read the same ones); a row's score is reduced across
// its four threads with two shuffles. CUDA cores in float32 only: tensor
// cores, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per thread block
constexpr int BK = 64;              // keys per shared-memory tile
constexpr int QUAD = 4;             // threads per query row
constexpr int THREADS = BQ * QUAD;  // 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// DPER: register slots per thread for q and the accumulator (D <= 4*DPER)
template <typename T, int DPER>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale,
                 int causal) {
  extern __shared__ float smem[];
  float* ks = smem;           // [BK][d]
  float* vs = smem + BK * d;  // [BK][d]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / QUAD;
  const int lane = threadIdx.x % QUAD;
  const int qi = q0 + row;
  const bool live = qi < sq;

  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  float qr[DPER];
  float acc[DPER];
#pragma unroll
  for (int i = 0; i < DPER; ++i) {
    const int dd = i * QUAD + lane;
    qr[i] = (live && dd < d) ? to_float(qb[(size_t)qi * d + dd]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

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

    float s[BK];
    float m_blk = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPER; ++i) {
        const int dd = i * QUAD + lane;
        if (dd < d) part += qr[i] * ks[j * d + dd];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = t0 + j;
      const bool ok = kj < sk && (!causal || qi >= kj);
      s[j] = ok ? part * scale : NEG_INF;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DPER; ++i) {
      const int dd = i * QUAD + lane;
      float a = 0.f;
      if (dd < d) {
#pragma unroll
        for (int j = 0; j < BK; ++j) a += s[j] * vs[j * d + dd];
      }
      acc[i] = acc[i] * corr + a;
    }
    m = m_new;
  }

  if (live) {
    const float lc = fmaxf(l, 1e-30f);
    float* ob = out + ((size_t)bh * sq + qi) * d;
#pragma unroll
    for (int i = 0; i < DPER; ++i) {
      const int dd = i * QUAD + lane;
      if (dd < d) ob[dd] = acc[i] / lc;
    }
    if (lane == 0) lse[(size_t)bh * sq + qi] = m + logf(lc);
  }
}

template <typename T, int DPER>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  const int smem = 2 * BK * d * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, DPER><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bh, int sq, int sk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 8>(q, k, v, out, lse, bh, sq, sk, d, scale, causal,
                        stream);
  if (d <= 64)
    return launch<T, 16>(q, k, v, out, lse, bh, sq, sk, d, scale, causal,
                         stream);
  if (d <= 128)
    return launch<T, 32>(q, k, v, out, lse, bh, sq, sk, d, scale, causal,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int sq,
                             int sk, int d, float scale, int causal, int dtype,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, b * h, sq, sk, d, scale, causal,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, b * h, sq, sk, d, scale,
                                   causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
