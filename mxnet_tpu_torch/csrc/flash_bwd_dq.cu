// Flash-attention backward, dQ, for Hopper (sm_90a), on the tensor cores at
// float32 accuracy.
//
// Replaces the second Pallas TPU kernel of
// mxnet_tpu/ops/attention.py::_pallas_backward (kernel_dq: grid
// (B*H, q-blocks, k-blocks), k-blocks innermost, the (block_q, D) dQ
// accumulator carried in VMEM across the sequential k axis). Same contract
// as flash_bwd_dkv.cu: q/dout (B,H,Sq,D), k/v (B,H,Sk,D) in float32,
// bfloat16 or float16, computed in float32; lse and delta =
// rowsum(dout*out) float32 (B,H,Sq); dq float32 (B,H,Sq,D). P is recomputed from lse: s = q.k *
// scale, masked (key past Sk or, causal, after the query) to p = 0 exactly
// as a score pinned to -1e30 gives; p = exp(s - lse), dp = dout.v,
// ds = p * (dp - delta) * scale, dQ += ds k.
//
// What bounds it here: at the training shape (B=32, H=4, S=128, D=64,
// causal) the work is 6 FLOP per (q, k) pair and dimension, ~0.41 GFLOP,
// over ~21 MB of inputs and outputs: bytes bound the card (~6 us), but a
// float32 kernel on the CUDA cores is held far above that by its
// multiply-adds. So the three products run on the tensor cores, in
// tf32_mma.cuh's split TF32 (mma.sync.m16n8k8), K1's (flash_fwd.cu)
// machinery with V replaced by K and P by dS:
//   - S = Q.K^T in exactly flash_fwd.cu's arithmetic and k-step order (the
//     exact three-way split, six products, each 8-wide k-step summed from
//     zero and added on the CUDA cores): lse came from there, and
//     p = exp(s - lse) is only consistent when s is computed the same way;
//   - dP = dO.V^T in 3xTF32: it feeds the cancellation in dp - delta,
//     and the split keeps it at float32's accuracy: chip_smoke.py's phase
//     6 (a training step's gradients, card vs CPU, within 1e-3) passes
//     with a wide margin (PERF.md), and the exact split costs time
//     (profile_kernels_torch.py times both);
//   - dQ += dS.K in 3xTF32, k-steps (8 keys) summed from zero.
// bfloat16 and float16 operands are exact in TF32: S and dP take one
// product, dQ two (dS split, K exact). Float32 issues 4 TF32 products per operation on
// average (6, 3 and 3 for the three products).
//
// Design: blocks of 4 warps, each warp owning 16 query rows, whose lse and
// delta sit in registers. The block's Q and dO rows are staged in shared
// memory once, with the first K/V tile, and split at each use (held in
// registers, even unsplit, they took 64 registers a thread at D 64 and
// pushed the kernel into spills). K/V tiles of BK keys are staged with
// 16-byte cp.async in a two-stage ring (tile j+1 loads while tile j is
// computed); every row is padded by 16 bytes so the fragment loads hit 32
// distinct banks. A warp takes its n-tiles (8 keys) GROUP at a time: S and
// dP into accumulator fragments, then P and dS formed in place, and dS feeds
// dQ += dS.K as its A operand with no shuffle: the eight keys of each k-step
// are taken in the order (0,2,4,6,1,3,5,7) and K's rows are read in that
// order. The passes of a split product each run over all the group's (or all
// the dimension tiles') accumulators before the next starts, with no branch
// between them. Causal key tiles past a q-tile are never loaded, groups of
// n-tiles past a warp's last row or past Sk are skipped, and the grid
// launches the longest q-tiles first. Rule for the q-tile: 32 rows (2 row
// groups of 16 rows times 2 key groups) when b*h*ceil(Sq/32) blocks give
// every SM one; else 16 rows (4 key groups). The key groups split each key
// tile's n-tiles and sum their dQ parts through shared memory at the end, in
// warp order. Against K1's 64-row tiles this halves the serial work of the
// longest causal q-tile, and with 2 n-tiles at once the kernel stays within
// 255 registers without spilling (profile_kernels_torch.py times the
// alternatives). Every dQ element is summed in a fixed order and written
// once: no atomics, the same bits on every launch.

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int GROUP = 2;  // n-tiles of S and dP a warp computes at once

// KS: k-steps of 8 head dimensions (D <= 8*KS; FULL_D: D == 8*KS). RG: row
// groups of 16 query rows per block; the 4 warps are RG row groups times
// KG = 4/RG key groups, key group kg taking the tile's n-tiles kg,
// kg + KG, ...
template <typename T, int KS, int RG, bool FULL_D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int sq, int sk, int d, float scale, int causal) {
  constexpr int KG = 4 / RG;
  constexpr int BK = KS <= 8 ? 64 : 32;  // keys per shared-memory tile
  constexpr int NT = BK / 8;             // 8-key n-tiles per tile
  constexpr int NU = NT / KG;            // n-tiles per warp
  constexpr int NG = NU < GROUP ? NU : GROUP;
  constexpr int BQ = RG * 16;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int SC = KS < 8 ? KS : 8;  // dimension tiles of dQ at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int stride = d + EPC;  // padded row: conflict-free fragment loads
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int kg = warp % KG;
  const int g = (tid % 32) >> 2;  // fragment row group
  const int t = tid & 3;          // thread in the group
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int r0 = q0 + (warp / KG) * 16;  // the warp's first row
  const int ksn = FULL_D ? KS : d / 8;   // k-steps in use

  const T* qb = q + (size_t)bh * sq * d;
  const T* gb = dout + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  T* qs = smem + 2 * 2 * BK * stride;  // [BQ][stride], after the K/V ring
  T* gs = qs + BQ * stride;            // [BQ][stride] dout

  // lse and delta of rows g and g+8
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lr[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    dr[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }

  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  const int ntiles = (kv_end + BK - 1) / BK;
  const int cpr = d / EPC;  // 16-byte copies per row

  auto stage = [&](int buf, int t0) {
    T* ks = smem + buf * 2 * BK * stride;
    T* vs = ks + BK * stride;
    for (int e = tid; e < BK * cpr; e += 128) {
      const int r = e / cpr;
      const int c = (e % cpr) * EPC;
      const bool in = t0 + r < sk;
      const size_t off = in ? (size_t)(t0 + r) * d + c : 0;
      cp_async16(ks + r * stride + c, kb + off, in ? 16 : 0);
      cp_async16(vs + r * stride + c, vb + off, in ? 16 : 0);
    }
  };

  float acc[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] = 0.f;

  // the block's Q and dO rows, once, in the first group with K/V tile 0
  for (int e = tid; e < BQ * cpr; e += 128) {
    const int r = e / cpr;
    const int c = (e % cpr) * EPC;
    const bool in = q0 + r < sq;
    const size_t off = in ? (size_t)(q0 + r) * d + c : 0;
    cp_async16(qs + r * stride + c, qb + off, in ? 16 : 0);
    cp_async16(gs + r * stride + c, gb + off, in ? 16 : 0);
  }
  if (ntiles > 0) stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage((it + 1) & 1, (it + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = smem + (it & 1) * 2 * BK * stride;
    const T* vs = ks + BK * stride;
    const int t0 = it * BK;
    // n-tiles holding a key <= the warp's last row (all unless causal) and
    // < Sk, and how many of them are this warp's (n-tile kg + KG u)
    int jn = min(NT, (sk - t0 + 7) / 8);
    if (causal) jn = min(jn, max(0, (r0 + 16 - t0 + 7) / 8));
    const int nu = jn > kg ? (jn - kg + KG - 1) / KG : 0;
    // one group after another: unrolled, the compiler interleaves the
    // groups and runs out of registers
#pragma unroll 1
    for (int u0 = 0; u0 < NU; u0 += NG) {
      if (u0 >= nu) break;
      // S = Q.K^T and dP = dO.V^T over the group's n-tiles:
      // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
      float sc[NG][4], dp[NG][4];
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[u][i] = dp[u][i] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ksn) {
          // A: a0 Q[g][8s+t], a1 Q[g+8][8s+t], a2 Q[g][8s+t+4],
          // a3 Q[g+8][8s+t+4] (dO's the same);
          // B: b0 K[key 8j+g][8s+t], b1 K[key 8j+g][8s+t+4] (V's the same)
          const int ao = (r0 - q0 + g) * stride + 8 * s + t;
          const float qa[4] = {to_float(qs[ao]), to_float(qs[ao + 8 * stride]),
                               to_float(qs[ao + 4]),
                               to_float(qs[ao + 8 * stride + 4])};
          const float ga[4] = {to_float(gs[ao]), to_float(gs[ao + 8 * stride]),
                               to_float(gs[ao + 4]),
                               to_float(gs[ao + 8 * stride + 4])};
          float kf[NG][2], vf[NG][2];
#pragma unroll
          for (int u = 0; u < NG; ++u) {
            const int o = (8 * (kg + KG * (u0 + u)) + g) * stride + 8 * s + t;
            kf[u][0] = to_float(ks[o]);
            kf[u][1] = to_float(ks[o + 4]);
            vf[u][0] = to_float(vs[o]);
            vf[u][1] = to_float(vs[o + 4]);
          }
          kstep_lr<6, EXACT, true>(sc, qa, kf);
          kstep_lr<3, EXACT, true>(dp, ga, vf);
        }
      }
      // P and dS in place; masked pairs give exactly 0
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + g + 8 * (i >> 1);
          const int key = t0 + 8 * (kg + KG * (u0 + u)) + 2 * t + (i & 1);
          const bool ok = row < sq && key < sk && (!causal || row >= key);
          const float p = ok ? expf(sc[u][i] * scale - lr[i >> 1]) : 0.f;
          sc[u][i] = p * (dp[u][i] - dr[i >> 1]) * scale;
        }
      // dQ += dS.K, one k-step per n-tile. The k-step's logical key c is
      // key 2c (c < 4) or 2(c-4)+1, so dS's A fragment is the score
      // fragment as it stands: a0 (g, key 2t) = c0, a1 (g+8, 2t) = c2,
      // a2 (g, 2t+1) = c1, a3 (g+8, 2t+1) = c3; b0 = K[2t][dim],
      // b1 = K[2t+1][dim].
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const float da[4] = {sc[u][0], sc[u][2], sc[u][1], sc[u][3]};
        const T* kr = ks + (8 * (kg + KG * (u0 + u)) + 2 * t) * stride + g;
#pragma unroll
        for (int s0 = 0; s0 < KS; s0 += SC) {
          if (s0 < ksn) {
            float kv[SC][2];
#pragma unroll
            for (int s = 0; s < SC; ++s) {
              const bool in = FULL_D || s0 + s < ksn;
              kv[s][0] = in ? to_float(kr[8 * (s0 + s)]) : 0.f;
              kv[s][1] = in ? to_float(kr[stride + 8 * (s0 + s)]) : 0.f;
            }
            float part[SC][4];  // acc[s0 .. s0+SC) (registers: no copy)
#pragma unroll
            for (int s = 0; s < SC; ++s)
#pragma unroll
              for (int i = 0; i < 4; ++i) part[s][i] = acc[s0 + s][i];
            kstep_split<EXACT>(part, da, kv);
#pragma unroll
            for (int s = 0; s < SC; ++s)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[s0 + s][i] = part[s][i];
          }
        }
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

  // sum the key groups' dQ parts of the block's rows through shared
  // memory (the ring is free after the loop's last barrier), in key-group
  // order
  float* po = reinterpret_cast<float*>(smem_raw);  // [KG][BQ][d]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = kg * BQ + r0 - q0 + g + 8 * r;
#pragma unroll
    for (int s = 0; s < KS; ++s)
      if (s < ksn)
        *reinterpret_cast<float2*>(po + rr * d + 8 * s + 2 * t) =
            make_float2(acc[s][2 * r], acc[s][2 * r + 1]);
  }
  __syncthreads();
  for (int e = tid; e < BQ * d; e += 128) {
    const int row = q0 + e / d;
    if (row >= sq) continue;
    float sum = po[e];
#pragma unroll
    for (int c = 1; c < KG; ++c) sum += po[c * BQ * d + e];
    dq[((size_t)bh * sq + row) * d + e % d] = sum;
  }
}

template <typename T, int KS, int RG, bool FULL_D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int BK = KS <= 8 ? 64 : 32;
  // shared memory: the K/V ring and the Q/dO rows, or the key groups' dQ
  // parts if larger
  auto bytes = [](int dd) {
    const int row = (dd + 16 / (int)sizeof(T)) * (int)sizeof(T);
    const int staging = (2 * 2 * BK + 2 * RG * 16) * row;
    const int merge = 64 * dd * 4;  // KG * BQ = 64 rows
    return staging > merge ? staging : merge;
  };
  // the largest head dimension this instance takes (8 KS) sets the opt-in
  static bool opted_in[MAX_DEVICES];
  const cudaError_t e = smem_opt_in(flash_bwd_dq_kernel<T, KS, RG, FULL_D>,
                                    opted_in, bytes(8 * KS));
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (sq + RG * 16 - 1) / (RG * 16));
  flash_bwd_dq_kernel<T, KS, RG, FULL_D><<<grid, 128, bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// 32-row q-tiles (2 row groups, 2 key groups) when they give every SM a
// block, else 16-row q-tiles (4 key groups)
template <typename T, int KS>
cudaError_t dispatch_tile(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int sq, int sk,
                          int d, float scale, int causal,
                          cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const bool wide = (long long)bh * ((sq + 31) / 32) >= sms;
  if (d == 8 * KS)  // the head dimension fills the k-steps: no tail checks
    return wide ? launch<T, KS, 2, true>(q, k, v, dout, lse, delta, dq, bh,
                                         sq, sk, d, scale, causal, stream)
                : launch<T, KS, 1, true>(q, k, v, dout, lse, delta, dq, bh,
                                         sq, sk, d, scale, causal, stream);
  return wide ? launch<T, KS, 2, false>(q, k, v, dout, lse, delta, dq, bh, sq,
                                        sk, d, scale, causal, stream)
              : launch<T, KS, 1, false>(q, k, v, dout, lse, delta, dq, bh, sq,
                                        sk, d, scale, causal, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d % 8 != 0 || d < 8) return cudaErrorInvalidValue;
  if (d <= 32)
    return dispatch_tile<T, 4>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                               scale, causal, stream);
  if (d <= 64)
    return dispatch_tile<T, 8>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                               scale, causal, stream);
  if (d <= 128)
    return dispatch_tile<T, 16>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                                scale, causal, stream);
  if (d <= 256)  // KS 32 spills registers (PERF.md); right, not fast
    return dispatch_tile<T, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                                scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and dout share
// it). q, k, v and dout must be 16-byte aligned (cp.async). Returns the
// launch's cudaGetLastError().
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int b, int h,
                                int sq, int sk, int d, float scale, int causal,
                                int dtype, void* stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dq, b * h, sq, sk, d,
                           scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b * h, sq,
                                   sk, d, scale, causal, s);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dq, b * h, sq,
                                   sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
