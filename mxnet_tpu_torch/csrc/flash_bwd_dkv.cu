// Flash-attention backward, dK and dV, for Hopper (sm_90a), on the tensor
// cores at float32 accuracy.
//
// Replaces the first Pallas TPU kernel of
// mxnet_tpu/ops/attention.py::_pallas_backward (kernel_dkv: grid
// (B*H, k-blocks, q-blocks), q-blocks innermost, the (block_k, D) dK and dV
// accumulators carried in VMEM across the sequential q axis). Same contract:
// q/dout (B,H,Sq,D), k/v (B,H,Sk,D) in float32, bfloat16 or float16,
// computed in float32; lse and delta = rowsum(dout*out) float32 (B,H,Sq);
// dk/dv float32 (B,H,Sk,D). P is recomputed from lse: s = q.k * scale, masked (key past
// Sk or, causal, after the query) to p = 0 exactly as a score pinned to
// -1e30 gives; p = exp(s - lse), dp = dout.v, ds = p * (dp - delta) *
// scale; dV += p^T dout and dK += ds^T q.
//
// What bounds it here: at the training shape (B=32, H=4, S=128, D=64,
// causal) the work is 8 FLOP per (q, k) pair and dimension, ~0.54 GFLOP,
// over ~25 MB of inputs and outputs: bytes bound the card (~8 us), but a
// float32 kernel on the CUDA cores is held far above that by its
// multiply-adds. So the four products run on the tensor cores in
// tf32_mma.cuh's split TF32 (mma.sync.m16n8k8), transposed so that keys
// are the rows:
//   - S^T = K.Q^T in exactly flash_fwd.cu's arithmetic and k-step order
//     for each (query, key) element (the exact three-way split, six
//     products in the same order, each 8-wide k-step summed from zero and
//     added on the CUDA cores): lse came from there, and p = exp(s - lse)
//     is only consistent when s is computed the same way;
//   - dP^T = V.dO^T in 3xTF32: it feeds the cancellation in dp - delta,
//     and the split keeps it at float32's accuracy: chip_smoke.py's phase
//     6 (a training step's gradients, card vs CPU, within 1e-3) passes
//     with a wide margin (PERF.md), and the exact split costs time
//     (profile_kernels_torch.py times both);
//   - dV += P^T.dO and dK += dS^T.Q in 3xTF32, k-steps (8 queries) summed
//     from zero.
// bfloat16 and float16 operands are exact in TF32: S and dP take one
// product, dV and dK two (P or dS split, dO or Q exact). Float32 issues 3.75 TF32 products per
// operation on average (6, 3, 3 and 3 for the four products).
//
// Design: one block of 4 warps per (b*h, key tile), the TPU grid's q axis
// a loop inside the block. The block's K and V rows are staged in shared
// memory once and split on the fly at each use (held split in registers
// beside the two accumulators, dK and dV, they would spill). Q, dO, lse and
// delta tiles of BQ queries are staged with cp.async (16 bytes a thread,
// rows padded by 16 bytes for conflict-free fragment loads) in a two-stage
// ring: tile i+1 loads while tile i is computed. Q's and dO's rows in
// shared memory are already the column-major B operand of K.Q^T and
// V.dO^T, so nothing is transposed. A warp takes its query n-tiles (8
// queries) GROUP at a time: S^T and dP^T into accumulator fragments, P^T
// and dS^T formed in place, and each feeds its product (dV += P^T.dO,
// dK += dS^T.Q) as the A operand with no shuffle: the eight queries of a
// k-step are taken in the order (0,2,4,6,1,3,5,7) and dO's and Q's rows
// are read in that order. Causal: the loop starts at the first q-tile that
// reaches the key tile, groups of n-tiles that end before a warp's first
// key or start past Sq are skipped, and the key tiles with the most
// q-tiles (the first) launch first. Rule for the key tile: 32 keys (2 key
// warps of 16 keys times 2 query groups) when b*h*ceil(Sk/32) blocks give
// every SM one; else 16 keys (4 query groups). The query groups split each
// q-tile's n-tiles and sum their dK/dV parts through shared memory at the
// end, in warp order. Against 64-key blocks of 4 key warps, this halves
// the serial work of the causal key tile 0, which walks every q-tile, and
// with 2 n-tiles at once the kernel stays within 255 registers without
// spilling (profile_kernels_torch.py times the alternatives). Every dK/dV
// element is summed in a fixed order and written once: no atomics, the
// same bits on every launch.

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int GROUP = 2;  // query n-tiles of S^T and dP^T a warp computes at once

// KS: k-steps of 8 head dimensions (D <= 8*KS; FULL_D: D == 8*KS). KW:
// key warps of 16 keys per block; the 4 warps are KW key warps times
// QG = 4/KW query groups, query group qg taking each q-tile's n-tiles qg,
// qg + QG, ...
template <typename T, int KS, int KW, bool FULL_D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int d,
                     float scale, int causal) {
  constexpr int QG = 4 / KW;
  constexpr int BKK = KW * 16;             // keys per block
  constexpr int BQ = KS <= 8 ? 64 : 32;    // queries per shared-memory tile
  constexpr int NT = BQ / 8;               // 8-query n-tiles per tile
  constexpr int NU = NT / QG;              // n-tiles per warp
  constexpr int NG = NU < GROUP ? NU : GROUP;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int SC = KS < 8 ? KS : 8;  // dimension tiles of dK/dV at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int stride = d + EPC;  // padded row: conflict-free fragment loads
  T* ks = smem;                     // [BKK][stride]
  T* vs = ks + BKK * stride;        // [BKK][stride]
  T* ring = vs + BKK * stride;      // 2 x (q [BQ][stride], dout [BQ][stride])
  float* rows = reinterpret_cast<float*>(ring + 2 * 2 * BQ * stride);
                                    // 2 x (lse [BQ], delta [BQ])
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int qg = warp % QG;
  const int kl = (warp / QG) * 16;  // the warp's first key in the block
  const int g = (tid % 32) >> 2;    // fragment row group
  const int t = tid & 3;            // thread in the group
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKK;
  const int kw0 = k0 + kl;          // the warp's first key
  const int ksn = FULL_D ? KS : d / 8;  // k-steps in use

  const T* qb = q + (size_t)bh * sq * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;

  // causal: q-tiles that end before the key tile starts see none of it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = q_begin < sq ? (sq - q_begin + BQ - 1) / BQ : 0;
  const int cpr = d / EPC;  // 16-byte copies per row

  auto stage = [&](int buf, int q0) {
    T* qs = ring + buf * 2 * BQ * stride;
    T* gs = qs + BQ * stride;
    for (int e = tid; e < BQ * cpr; e += 128) {
      const int r = e / cpr;
      const int c = (e % cpr) * EPC;
      const bool in = q0 + r < sq;
      const size_t off = in ? (size_t)(q0 + r) * d + c : 0;
      cp_async16(qs + r * stride + c, qb + off, in ? 16 : 0);
      cp_async16(gs + r * stride + c, gb + off, in ? 16 : 0);
    }
    float* ls = rows + buf * 2 * BQ;
    for (int e = tid; e < BQ; e += 128) {
      const bool in = q0 + e < sq;
      const int at = in ? q0 + e : 0;
      cp_async4(ls + e, lb + at, in ? 4 : 0);
      cp_async4(ls + BQ + e, db + at, in ? 4 : 0);
    }
  };

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[s][i] = dva[s][i] = 0.f;

  if (ntiles > 0) {
    // the block's K and V rows, once, in the first group with q-tile 0
    for (int e = tid; e < BKK * cpr; e += 128) {
      const int r = e / cpr;
      const int c = (e % cpr) * EPC;
      const bool in = k0 + r < sk;
      const size_t off = in ? ((size_t)bh * sk + k0 + r) * d + c : 0;
      cp_async16(ks + r * stride + c, k + off, in ? 16 : 0);
      cp_async16(vs + r * stride + c, v + off, in ? 16 : 0);
    }
    stage(0, q_begin);
  }
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = q_begin + it * BQ;
    if (it + 1 < ntiles) stage((it + 1) & 1, q0 + BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qs = ring + (it & 1) * 2 * BQ * stride;
    const T* gs = qs + BQ * stride;
    const float* ls = rows + (it & 1) * 2 * BQ;
    const float* dl = ls + BQ;
    // this warp's n-tiles qg + QG u in [u_lo, u_hi): those starting before
    // Sq and (causal) ending at or after the warp's first key
    const int jq = min(NT, (sq - q0 + 7) / 8);
    const int jl = causal ? max(0, kw0 - q0) / 8 : 0;
    const int u_hi = jq > qg ? (jq - qg + QG - 1) / QG : 0;
    const int u_lo = jl > qg ? (jl - qg + QG - 1) / QG : 0;
    // one group after another: unrolled, the compiler interleaves the
    // groups and runs out of registers
#pragma unroll 1
    for (int u0 = 0; u0 < NU; u0 += NG) {
      if (u0 + NG <= u_lo || u0 >= u_hi) continue;
      // S^T = K.Q^T and dP^T = V.dO^T over the group's n-tiles, keys as
      // rows: c0 (key g, query 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
      float sc[NG][4], dp[NG][4];
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[u][i] = dp[u][i] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ksn) {
          // A: a0 K[g][8s+t], a1 K[g+8][8s+t], a2 K[g][8s+t+4],
          // a3 K[g+8][8s+t+4]; B: b0 Q[8j+g][8s+t], b1 Q[8j+g][8s+t+4]
          const int ao = (kl + g) * stride + 8 * s + t;
          const float ak[4] = {to_float(ks[ao]), to_float(ks[ao + 8 * stride]),
                               to_float(ks[ao + 4]),
                               to_float(ks[ao + 8 * stride + 4])};
          const float av[4] = {to_float(vs[ao]), to_float(vs[ao + 8 * stride]),
                               to_float(vs[ao + 4]),
                               to_float(vs[ao + 8 * stride + 4])};
          float qf[NG][2], gf[NG][2];
#pragma unroll
          for (int u = 0; u < NG; ++u) {
            const int o = (8 * (qg + QG * (u0 + u)) + g) * stride + 8 * s + t;
            qf[u][0] = to_float(qs[o]);
            qf[u][1] = to_float(qs[o + 4]);
            gf[u][0] = to_float(gs[o]);
            gf[u][1] = to_float(gs[o + 4]);
          }
          kstep_lr<6, EXACT, false>(sc, ak, qf);
          kstep_lr<3, EXACT, false>(dp, av, gf);
        }
      }
      // P^T into sc, dS^T into dp; masked pairs give exactly 0
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kw0 + g + 8 * (i >> 1);
          const int qi = 8 * (qg + QG * (u0 + u)) + 2 * t + (i & 1);
          const int query = q0 + qi;
          const bool ok = query < sq && key < sk && (!causal || query >= key);
          const float p = ok ? expf(sc[u][i] * scale - ls[qi]) : 0.f;
          sc[u][i] = p;
          dp[u][i] = p * (dp[u][i] - dl[qi]) * scale;
        }
      // dV += P^T.dO and dK += dS^T.Q, one k-step per n-tile. The k-step's
      // logical query c is query 2c (c < 4) or 2(c-4)+1, so the A fragment
      // is the score fragment as it stands: a0 (g, query 2t) = c0,
      // a1 (g+8, 2t) = c2, a2 (g, 2t+1) = c1, a3 (g+8, 2t+1) = c3;
      // b0 = dO[2t][dim], b1 = dO[2t+1][dim] (Q's for dK).
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const float pa[4] = {sc[u][0], sc[u][2], sc[u][1], sc[u][3]};
        const float da[4] = {dp[u][0], dp[u][2], dp[u][1], dp[u][3]};
        const int ro = (8 * (qg + QG * (u0 + u)) + 2 * t) * stride + g;
#pragma unroll
        for (int s0 = 0; s0 < KS; s0 += SC) {
          if (s0 < ksn) {
            float gv[SC][2], qv[SC][2], part[SC][4];
#pragma unroll
            for (int s = 0; s < SC; ++s) {
              const bool in = FULL_D || s0 + s < ksn;
              const int o = ro + 8 * (s0 + s);
              gv[s][0] = in ? to_float(gs[o]) : 0.f;
              gv[s][1] = in ? to_float(gs[o + stride]) : 0.f;
              qv[s][0] = in ? to_float(qs[o]) : 0.f;
              qv[s][1] = in ? to_float(qs[o + stride]) : 0.f;
            }
            // acc[s0 .. s0+SC) through part (registers: no copy)
#pragma unroll
            for (int s = 0; s < SC; ++s)
#pragma unroll
              for (int i = 0; i < 4; ++i) part[s][i] = dva[s0 + s][i];
            kstep_split<EXACT>(part, pa, gv);
#pragma unroll
            for (int s = 0; s < SC; ++s)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                dva[s0 + s][i] = part[s][i];
                part[s][i] = dka[s0 + s][i];
              }
            kstep_split<EXACT>(part, da, qv);
#pragma unroll
            for (int s = 0; s < SC; ++s)
#pragma unroll
              for (int i = 0; i < 4; ++i) dka[s0 + s][i] = part[s][i];
          }
        }
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

  // sum the query groups' dK/dV parts of the block's keys through shared
  // memory (the staging space is free after the loop's last barrier), in
  // query-group order
  float* pk = reinterpret_cast<float*>(smem_raw);  // [QG][BKK][d]
  float* pv = pk + QG * BKK * d;                    // [QG][BKK][d]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = qg * BKK + kl + g + 8 * r;
#pragma unroll
    for (int s = 0; s < KS; ++s)
      if (s < ksn) {
        *reinterpret_cast<float2*>(pk + rr * d + 8 * s + 2 * t) =
            make_float2(dka[s][2 * r], dka[s][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + rr * d + 8 * s + 2 * t) =
            make_float2(dva[s][2 * r], dva[s][2 * r + 1]);
      }
  }
  __syncthreads();
  for (int e = tid; e < BKK * d; e += 128) {
    const int key = k0 + e / d;
    if (key >= sk) continue;
    float sum_k = pk[e], sum_v = pv[e];
#pragma unroll
    for (int c = 1; c < QG; ++c) {
      sum_k += pk[c * BKK * d + e];
      sum_v += pv[c * BKK * d + e];
    }
    const size_t at = ((size_t)bh * sk + key) * d + e % d;
    dk[at] = sum_k;
    dv[at] = sum_v;
  }
}

template <typename T, int KS, int KW, bool FULL_D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int sq, int sk, int d,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = KS <= 8 ? 64 : 32;
  // shared memory: K/V rows and the Q/dO/lse/delta ring, or the query
  // groups' dK/dV parts if larger
  auto bytes = [](int dd) {
    const int row = (dd + 16 / (int)sizeof(T)) * (int)sizeof(T);
    const int staging = (2 * KW * 16 + 4 * BQ) * row + 4 * BQ * 4;
    const int merge = 2 * 64 * dd * 4;  // QG * BKK = 64 rows
    return staging > merge ? staging : merge;
  };
  // the largest head dimension this instance takes (8 KS) sets the opt-in
  static bool opted_in[MAX_DEVICES];
  const cudaError_t e = smem_opt_in(flash_bwd_dkv_kernel<T, KS, KW, FULL_D>,
                                    opted_in, bytes(8 * KS));
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (sk + KW * 16 - 1) / (KW * 16));
  flash_bwd_dkv_kernel<T, KS, KW, FULL_D><<<grid, 128, bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

// 32-key tiles (2 key warps, 2 query groups) when they give every SM a
// block, else 16-key tiles (4 query groups)
template <typename T, int KS>
cudaError_t dispatch_tile(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int bh,
                          int sq, int sk, int d, float scale, int causal,
                          cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const bool wide = (long long)bh * ((sk + 31) / 32) >= sms;
  if (d == 8 * KS)  // the head dimension fills the k-steps: no tail checks
    return wide ? launch<T, KS, 2, true>(q, k, v, dout, lse, delta, dk, dv,
                                         bh, sq, sk, d, scale, causal, stream)
                : launch<T, KS, 1, true>(q, k, v, dout, lse, delta, dk, dv,
                                         bh, sq, sk, d, scale, causal, stream);
  return wide ? launch<T, KS, 2, false>(q, k, v, dout, lse, delta, dk, dv, bh,
                                        sq, sk, d, scale, causal, stream)
              : launch<T, KS, 1, false>(q, k, v, dout, lse, delta, dk, dv, bh,
                                        sq, sk, d, scale, causal, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int sq, int sk, int d,
                     float scale, int causal, cudaStream_t stream) {
  if (d % 8 != 0 || d < 8) return cudaErrorInvalidValue;
  if (d <= 32)
    return dispatch_tile<T, 4>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               d, scale, causal, stream);
  if (d <= 64)
    return dispatch_tile<T, 8>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               d, scale, causal, stream);
  if (d <= 128)
    return dispatch_tile<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                                d, scale, causal, stream);
  if (d <= 256)  // KS 32 spills registers (PERF.md); right, not fast
    return dispatch_tile<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                                d, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and dout share
// it). q, k, v and dout must be 16-byte aligned (cp.async). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b,
                                 int h, int sq, int sk, int d, float scale,
                                 int causal, int dtype, void* stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dk, dv, b * h, sq, sk,
                           d, scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b * h,
                                   sq, sk, d, scale, causal, s);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dk, dv, b * h,
                                   sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
