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
// What bounds it here: the operations. Each block recomputes its score
// tiles over the full D once per output slice, and every product runs on
// the CUDA cores at the float32 rate; the route is for correctness at
// widths no model of the repository's zoo uses, not for speed.
//
// Design: the OUTPUT's head dimension is cut into slices of DS = 128 on
// the grid's z axis. A block owns BR = 16 rows (queries for the forward
// and dQ, keys for dK/dV) and one slice; it streams the other side in
// tiles of BC = 32 rows. For each tile it forms the 16x32 score tile
// S = Q.K^T (and dP = dO.V^T in the backward) over the FULL D, staging
// both operands through shared memory in chunks of DC = 32 dimensions,
// then accumulates P.V (or dS.K, P^T.dO and dS^T.Q) for its own slice
// only, one output column per thread and 16 rows in registers. Only the
// first slice writes lse.
//
// The forward and the backward agree on every score bit: all three
// kernels form S through tile_dot(), whose every entry is one fmaf chain
// over d = 0, 1, ..., D-1 in that order (an fmaf's product is exact, so
// swapping its two factors, as dK/dV does with K's rows owned, changes
// nothing), then multiply by the scale once. The backward's
// p = exp(s*scale - lse) therefore sees exactly the forward's s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BR = 16;    // rows a block owns
constexpr int BC = 32;    // rows of a streamed tile
constexpr int DC = 32;    // head dimensions per staged chunk
constexpr int DS = 128;   // output columns per block (one per thread)
constexpr int THREADS = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// acc[i] += A[a0 + r] . B[b0 + c_i] over d = 0..D-1, one fmaf at a time in
// order of d, for the thread's r = tid / 8 and c_i = tid % 8 + 8 i. Rows
// past a_rows / b_rows read as zero. A is (*, d) row-major from a, B from
// b. as_/bs_ are [BR][DC + 1] and [BC][DC + 1] floats of shared memory.
template <typename T>
__device__ void tile_dot(const T* __restrict__ a, int a0, int a_rows,
                         const T* __restrict__ b, int b0, int b_rows, int d,
                         float* as_, float* bs_, float (&acc)[4]) {
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  for (int dc = 0; dc < d; dc += DC) {
    for (int e = tid; e < BR * DC; e += THREADS) {
      const int row = e / DC, col = e % DC;
      const bool in = a0 + row < a_rows && dc + col < d;
      as_[row * (DC + 1) + col] =
          in ? to_float(a[(size_t)(a0 + row) * d + dc + col]) : 0.f;
    }
    for (int e = tid; e < BC * DC; e += THREADS) {
      const int row = e / DC, col = e % DC;
      const bool in = b0 + row < b_rows && dc + col < d;
      bs_[row * (DC + 1) + col] =
          in ? to_float(b[(size_t)(b0 + row) * d + dc + col]) : 0.f;
    }
    __syncthreads();
    // zero-filled dimensions past d add fmaf(0, 0, acc) == acc exactly
#pragma unroll 8
    for (int j = 0; j < DC; ++j) {
      const float x = as_[r * (DC + 1) + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = __fmaf_rn(x, bs_[(c + 8 * i) * (DC + 1) + j], acc[i]);
    }
    __syncthreads();
  }
}

// rows [r0, r0 + BC) x columns [c0, c0 + DS) of x (n, d) into dst [BC][DS]
// as float, zero outside
template <typename T>
__device__ void stage_slice(const T* __restrict__ x, int r0, int n, int d,
                            int c0, float* dst) {
  for (int e = threadIdx.x; e < BC * DS; e += THREADS) {
    const int row = e / DS, col = e % DS;
    const bool in = r0 + row < n && c0 + col < d;
    dst[e] = in ? to_float(x[(size_t)(r0 + row) * d + c0 + col]) : 0.f;
  }
}

struct Shared {
  float as_[BR * (DC + 1)];
  float bs_[BC * (DC + 1)];
  float p[BR * (BC + 1)];
  float ds[BR * (BC + 1)];
  float corr[BR];
  float m[BR];
  float l[BR];
  float x[BC * DS];
  float y[BC * DS];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int sq, int sk, int d, float scale,
                int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BR;
  const int c0 = blockIdx.z * DS;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  if (tid < BR) {
    sh.m[tid] = NEG_INF;
    sh.l[tid] = 0.f;
  }
  float o[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) o[r] = 0.f;
  const int kv_end = causal ? min(sk, q0 + BR) : sk;
  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = 0; t0 < kv_end; t0 += BC) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    tile_dot(qb, q0, sq, kb, t0, sk, d, sh.as_, sh.bs_, acc);
    const int r = tid >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (tid & 7) + 8 * i;
      const int key = t0 + c, row = q0 + r;
      const bool ok = key < sk && (!causal || row >= key);
      sh.p[r * (BC + 1) + c] = ok ? acc[i] * scale : NEG_INF;
    }
    stage_slice(vb, t0, sk, d, c0, sh.x);
    __syncthreads();
    // the online softmax: warp w updates rows 4w .. 4w+3, a key per lane
    for (int rr = 0; rr < 4; ++rr) {
      const int row = 4 * warp + rr;
      const float s = sh.p[row * (BC + 1) + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sh.m[row];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sh.p[row * (BC + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sh.corr[row] = corr;
        sh.l[row] = sh.l[row] * corr + sum;
        sh.m[row] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r2 = 0; r2 < BR; ++r2) {
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < BC; ++c)
        s = __fmaf_rn(sh.p[r2 * (BC + 1) + c], sh.x[c * DS + tid], s);
      o[r2] = o[r2] * sh.corr[r2] + s;
    }
    __syncthreads();
  }
  const int col = c0 + tid;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const int row = q0 + r;
    if (row >= sq) break;
    const float lc = fmaxf(sh.l[r], 1e-30f);
    if (col < d) out[((size_t)bh * sq + row) * d + col] = o[r] / lc;
    if (blockIdx.z == 0 && tid == 0)
      lse[(size_t)bh * sq + row] = sh.m[r] + logf(lc);
  }
}

// dK and dV for 16 keys and one slice of their columns
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int sq, int sk, int d, float scale,
                int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BR;
  const int c0 = blockIdx.z * DS;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  float ak[BR], av[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) ak[r] = av[r] = 0.f;
  // causal: queries before this block's first key see none of its keys
  const int q_begin = causal ? (k0 / BC) * BC : 0;
  for (int t0 = q_begin; t0 < sq; t0 += BC) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    tile_dot(kb, k0, sk, qb, t0, sq, d, sh.as_, sh.bs_, s);
    tile_dot(vb, k0, sk, gb, t0, sq, d, sh.as_, sh.bs_, dp);
    const int r = tid >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (tid & 7) + 8 * i;
      const int qi = t0 + c, key = k0 + r;
      const bool ok = qi < sq && key < sk && (!causal || qi >= key);
      const float p = ok ? expf(s[i] * scale - lb[qi]) : 0.f;
      sh.p[r * (BC + 1) + c] = p;
      sh.ds[r * (BC + 1) + c] = ok ? p * (dp[i] - db[qi]) * scale : 0.f;
    }
    stage_slice(gb, t0, sq, d, c0, sh.x);
    stage_slice(qb, t0, sq, d, c0, sh.y);
    __syncthreads();
#pragma unroll
    for (int r2 = 0; r2 < BR; ++r2) {
      float sv = 0.f, sk_ = 0.f;
#pragma unroll 8
      for (int c = 0; c < BC; ++c) {
        sv = __fmaf_rn(sh.p[r2 * (BC + 1) + c], sh.x[c * DS + tid], sv);
        sk_ = __fmaf_rn(sh.ds[r2 * (BC + 1) + c], sh.y[c * DS + tid], sk_);
      }
      av[r2] += sv;
      ak[r2] += sk_;
    }
    __syncthreads();
  }
  const int col = c0 + tid;
  if (col >= d) return;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const int key = k0 + r;
    if (key >= sk) break;
    dk[((size_t)bh * sk + key) * d + col] = ak[r];
    dv[((size_t)bh * sk + key) * d + col] = av[r];
  }
}

// dQ for 16 queries and one slice of their columns
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int sq, int sk, int d, float scale,
               int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BR;
  const int c0 = blockIdx.z * DS;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  float aq[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) aq[r] = 0.f;
  const int kv_end = causal ? min(sk, q0 + BR) : sk;
  for (int t0 = 0; t0 < kv_end; t0 += BC) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    tile_dot(qb, q0, sq, kb, t0, sk, d, sh.as_, sh.bs_, s);
    tile_dot(gb, q0, sq, vb, t0, sk, d, sh.as_, sh.bs_, dp);
    const int r = tid >> 3;
    const int row = q0 + r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (tid & 7) + 8 * i;
      const int key = t0 + c;
      const bool ok = row < sq && key < sk && (!causal || row >= key);
      const float p = ok ? expf(s[i] * scale - lb[row]) : 0.f;
      sh.ds[r * (BC + 1) + c] = ok ? p * (dp[i] - db[row]) * scale : 0.f;
    }
    stage_slice(kb, t0, sk, d, c0, sh.x);
    __syncthreads();
#pragma unroll
    for (int r2 = 0; r2 < BR; ++r2) {
      float sq_ = 0.f;
#pragma unroll 8
      for (int c = 0; c < BC; ++c)
        sq_ = __fmaf_rn(sh.ds[r2 * (BC + 1) + c], sh.x[c * DS + tid], sq_);
      aq[r2] += sq_;
    }
    __syncthreads();
  }
  const int col = c0 + tid;
  if (col >= d) return;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const int row = q0 + r;
    if (row >= sq) break;
    dq[((size_t)bh * sq + row) * d + col] = aq[r];
  }
}

constexpr int SMEM = sizeof(Shared);

// 43,520 bytes: under the 48 KB a launch takes without an opt-in
static_assert(SMEM <= 48 * 1024, "shared memory past the default limit");

dim3 grid_for(int bh, int rows, int d) {
  return dim3(bh, (rows + BR - 1) / BR, (d + DS - 1) / DS);
}

bool shape_ok(int bh, int sq, int sk, int d) {
  return d >= 8 && d % 8 == 0 && bh >= 1 && sq >= 1 && sk >= 1 &&
         (sq + BR - 1) / BR <= 65535 && (sk + BR - 1) / BR <= 65535 &&
         (d + DS - 1) / DS <= 65535;
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int bh, int sq, int sk, int d, float scale,
                int causal, cudaStream_t stream) {
  wide_fwd_kernel<T><<<grid_for(bh, sq, d), THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv,
                int bh, int sq, int sk, int d, float scale, int causal,
                cudaStream_t stream) {
  wide_dkv_kernel<T><<<grid_for(bh, sk, d), THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dq_, int bh, int sq,
               int sk, int d, float scale, int causal, cudaStream_t stream) {
  wide_dq_kernel<T><<<grid_for(bh, sq, d), THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_), sq, sk, d, scale, causal);
  return cudaGetLastError();
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
