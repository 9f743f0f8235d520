// Flash-attention forward for Hopper (sm_90a), on the tensor cores at
// float32 accuracy.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/attention.py::_pallas_forward
// (grid (B*H, q-blocks, kv-blocks), online softmax carried in VMEM across
// the sequential kv axis). Same contract: q (B,H,Sq,D), k/v (B,H,Sk,D) in
// float32, bfloat16 or float16, computed in float32; out float32
// (B,H,Sq,D) and lse = m + log(l) float32 (B,H,Sq). Masked scores are
// pinned to -1e30 and l is clamped at 1e-30, as in the reference.
//
// What bounds it here: at the main paths' shapes (S <= 128, D 64) bytes
// set the card's bound (~5 us at (32,4,128,64)), but a float32 kernel on
// the CUDA cores is held far above it by its multiply-adds and their
// shared-memory operands. So both products run on the tensor cores with
// mma.sync.m16n8k8 in TF32, split to keep float32 accuracy (the package
// never computes attention in plain TF32):
//   - P.V in 3xTF32: x = big + small with big = tf32(x), small =
//     tf32(x - big), summed as p_small.v_big + p_big.v_small +
//     p_big.v_big (the dropped small.small term is ~2^-22 of the product);
//   - Q.K^T from an exact three-way split, x = x1 + x2 + x3 (11 + 11 + 3
//     bits), in the six products above 2^-33 of q.k: the scores feed exp()
//     and every weight, and with 3xTF32 scores a training step's
//     gradients missed the plain version's by more than chip_smoke.py's
//     phase 6 allows, where these match it as float32 does;
//   - each 8-wide k-step is accumulated from zero and added to the running
//     sums on the CUDA cores, rounded to nearest: the tensor core
//     truncates as it accumulates, and a long chain of truncations biases
//     the sums.
// bfloat16 and float16 operands are exact in TF32: Q.K^T takes one
// product and P.V two (P split, V exact).
//
// Design: blocks of 4 warps; each warp owns 16 query rows, whose Q
// fragments sit in registers. K/V tiles of BK keys are staged in shared
// memory with cp.async, 16 bytes a thread, in a two-stage ring (tile j+1
// loads while tile j is computed), rows padded by 16 bytes so the fragment
// loads hit 32 distinct banks. The scores stay in the accumulator fragments
// for the row max and sum (two quad shuffles); they feed the P.V product as
// its A operand without a shuffle, because the eight keys of each k-step
// are taken in the order (0,2,4,6,1,3,5,7) and V's rows are read in that
// same order. The three passes of a split product each run over all of a
// warp's accumulators before the next starts, and no branch stands between
// them, so a tensor-core instruction never waits on the one before it.
// Causal key tiles past a q-tile are never loaded, n-tiles past a warp's
// last row are skipped, and the grid launches the longest q-tiles first.
// Rule for the q-tile: 64 rows (4 warps of 16 rows) when b*h*ceil(Sq/64)
// blocks give every SM one; else 16 rows, with the 4 warps splitting each
// key tile's n-tiles and merging their softmax states through shared
// memory at the end, so a small problem (serving, b*h = 4) runs 4 times
// as many blocks, each with a quarter of the serial work per warp. The
// ragged Sk tail is zero-filled and masked.

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

// KS: k-steps of 8 head dimensions (D <= 8*KS; FULL_D: D == 8*KS). RG: row groups of 16
// query rows per block; the block's 4 warps are RG row groups times
// KG = 4/RG key groups, and key group kg takes the tile's n-tiles kg,
// kg + KG, ... (the key groups' partial softmax states are merged at the
// end). Each product's three passes run over all of the warp's
// accumulators in turn, so consecutive tensor-core instructions never
// wait for each other's result.
template <typename T, int KS, int RG, bool FULL_D>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale,
                 int causal) {
  constexpr int KG = 4 / RG;
  constexpr int BK = KS <= 8 ? 64 : 32;  // keys per shared-memory tile
  constexpr int NT = BK / 8;             // 8-key n-tiles per tile
  constexpr int NU = NT / KG;            // n-tiles per warp
  constexpr int BQ = RG * 16;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int SC = KS < 8 ? KS : 8;  // V k-steps held at once
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
  const int ksn = FULL_D ? KS : d / 8;  // k-steps in use

  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  // Q's A fragments: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
  float qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1);
      const int col = 8 * s + t + 4 * (i >> 1);
      qa[s][i] = (s < ksn && row < sq) ? to_float(qb[(size_t)row * d + col])
                                       : 0.f;
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

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums
  float o[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[s][i] = 0.f;

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
    // n-tiles holding keys <= the warp's last row (all of them unless
    // causal), and how many of them are this warp's (n-tile kg + KG u).
    // A warp with none skips the tile; one with some computes all its
    // n-tiles, the rest masked: no branch between its tensor-core
    // instructions, which would keep them from overlapping.
    const int jn = causal ? min(NT, max(0, (r0 + 16 - t0 + 7) / 8)) : NT;
    const int nu = jn > kg ? (jn - kg + KG - 1) / KG : 0;
    if (nu > 0) {
      // S = Q.K^T: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
      float sc[NU][4];
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[u][i] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ksn) {
          // these 8 dimensions into a fresh accumulator, added to the
          // scores on the CUDA cores: the tensor core truncates as it
          // accumulates, and a long chain of truncations biases the scores
          float tq[NU][4] = {};
          if (EXACT) {
            uint32_t a1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a1[i] = __float_as_uint(qa[s][i]);
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              const T* kr = ks + (8 * (kg + KG * u) + g) * stride + 8 * s + t;
              const uint32_t b1[2] = {__float_as_uint(to_float(kr[0])),
                                      __float_as_uint(to_float(kr[4]))};
              mma(tq[u], a1, b1);
            }
          } else {
            // b0 = K[key 8j+g][dim 8s+t], b1 = K[key 8j+g][dim 8s+t+4]
            uint32_t a1[4], a2[4], a3[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split3(qa[s][i], a1[i], a2[i], a3[i]);
            uint32_t b1[NU][2], b2[NU][2], b3[NU][2];
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              const T* kr = ks + (8 * (kg + KG * u) + g) * stride + 8 * s + t;
              split3(to_float(kr[0]), b1[u][0], b2[u][0], b3[u][0]);
              split3(to_float(kr[4]), b1[u][1], b2[u][1], b3[u][1]);
            }
            // the six products above 2^-33 of a.b, smallest first
#pragma unroll
            for (int u = 0; u < NU; ++u) mma(tq[u], a3, b1[u]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma(tq[u], a2, b2[u]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma(tq[u], a1, b3[u]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma(tq[u], a2, b1[u]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma(tq[u], a1, b2[u]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma(tq[u], a1, b1[u]);
          }
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) sc[u][i] += tq[u][i];
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + g + 8 * (i >> 1);
          const int key = t0 + 8 * (kg + KG * u) + 2 * t + (i & 1);
          const bool ok = u < nu && key < sk && (!causal || row >= key);
          sc[u][i] = ok ? sc[u][i] * scale : NEG_INF;
          mx[i >> 1] = fmaxf(mx[i >> 1], sc[u][i]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[u][i] = expf(sc[u][i] - m[i >> 1]);
          l[i >> 1] += sc[u][i];
        }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        o[s][0] *= corr[0];
        o[s][1] *= corr[0];
        o[s][2] *= corr[1];
        o[s][3] *= corr[1];
      }
      // O += P.V. The k-step's logical key c is key 2c (c < 4) or
      // 2(c-4)+1, so P's A fragment is the score fragment as it stands:
      // a0 (g, key 2t) = c0, a1 (g+8, 2t) = c2, a2 (g, 2t+1) = c1,
      // a3 (g+8, 2t+1) = c3; and b0 = V[2t][dim], b1 = V[2t+1][dim].
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float pa[4] = {sc[u][0], sc[u][2], sc[u][1], sc[u][3]};
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(pa[i], pb[i], ps[i]);
        const T* vr = vs + (8 * (kg + KG * u) + 2 * t) * stride + g;
#pragma unroll
        for (int s0 = 0; s0 < KS; s0 += SC) {
          uint32_t bb[SC][2], bs[SC][2];
          float tv[SC][4] = {};  // fresh, as for the scores
#pragma unroll
          for (int s = 0; s < SC; ++s) {
            if (s0 + s < ksn) {
              operand<EXACT>(to_float(vr[8 * (s0 + s)]), bb[s][0], bs[s][0]);
              operand<EXACT>(to_float(vr[stride + 8 * (s0 + s)]), bb[s][1],
                             bs[s][1]);
            }
          }
#pragma unroll
          for (int s = 0; s < SC; ++s)
            if (s0 + s < ksn) mma(tv[s], ps, bb[s]);
          if (!EXACT) {
#pragma unroll
            for (int s = 0; s < SC; ++s)
              if (s0 + s < ksn) mma(tv[s], pb, bs[s]);
          }
#pragma unroll
          for (int s = 0; s < SC; ++s)
            if (s0 + s < ksn) mma(tv[s], pb, bb[s]);
#pragma unroll
          for (int s = 0; s < SC; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[s0 + s][i] += tv[s][i];
        }
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (KG == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < sq) {
        const float lc = fmaxf(l[r], 1e-30f);
        float* ob = out + ((size_t)bh * sq + row) * d + 2 * t;
#pragma unroll
        for (int s = 0; s < KS; ++s)
          if (s < ksn)
            *reinterpret_cast<float2*>(ob + 8 * s) =
                make_float2(o[s][2 * r] / lc, o[s][2 * r + 1] / lc);
        if (t == 0) lse[(size_t)bh * sq + row] = m[r] + logf(lc);
      }
    }
    return;
  }
  // merge the key groups' states (m_k, l_k, o_k) of the block's rows
  // through shared memory (the staging ring is free after the loop's last
  // barrier): out = sum_k o_k e^(m_k - m) / sum_k l_k e^(m_k - m), with
  // m = max_k m_k
  float* po = reinterpret_cast<float*>(smem_raw);  // [KG][BQ][d]
  float* pm = po + KG * BQ * d;                      // [KG][BQ]
  float* pl = pm + KG * BQ;                          // [KG][BQ]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = kg * BQ + r0 - q0 + g + 8 * r;
    if (t == 0) {
      pm[rr] = m[r];
      pl[rr] = l[r];
    }
#pragma unroll
    for (int s = 0; s < KS; ++s)
      if (s < ksn)
        *reinterpret_cast<float2*>(po + rr * d + 8 * s + 2 * t) =
            make_float2(o[s][2 * r], o[s][2 * r + 1]);
  }
  __syncthreads();
  for (int e = tid; e < BQ * d; e += 128) {
    const int rr = e / d;
    const int row = q0 + rr;
    if (row >= sq) continue;
    float mt = NEG_INF;
#pragma unroll
    for (int c = 0; c < KG; ++c) mt = fmaxf(mt, pm[c * BQ + rr]);
    float lt = 0.f, ot = 0.f;
#pragma unroll
    for (int c = 0; c < KG; ++c) {
      const float w = expf(pm[c * BQ + rr] - mt);
      lt += pl[c * BQ + rr] * w;
      ot += po[c * BQ * d + e] * w;
    }
    const float lc = fmaxf(lt, 1e-30f);
    out[((size_t)bh * sq + row) * d + e % d] = ot / lc;
    if (e % d == 0) lse[(size_t)bh * sq + row] = mt + logf(lc);
  }
}

template <typename T, int KS, int RG, bool FULL_D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int BK = KS <= 8 ? 64 : 32;
  // shared memory: the K/V ring, or the key groups' merge if larger
  auto bytes = [](int dd) {
    const int ring = 2 * 2 * BK * (dd + 16 / (int)sizeof(T)) * (int)sizeof(T);
    const int merge = RG == 4 ? 0 : 64 * (dd + 2) * 4;  // KG * BQ = 64 rows
    return ring > merge ? ring : merge;
  };
  // the largest head dimension this instance takes (8 KS) sets the opt-in
  static bool opted_in[MAX_DEVICES];
  const cudaError_t e = smem_opt_in(flash_fwd_kernel<T, KS, RG, FULL_D>,
                                    opted_in, bytes(8 * KS));
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (sq + RG * 16 - 1) / (RG * 16));
  flash_fwd_kernel<T, KS, RG, FULL_D><<<grid, 128, bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// 64-row q-tiles (4 row groups) when they give every SM a block, else
// 16-row q-tiles whose keys are split over 4 key groups
template <typename T, int KS>
cudaError_t dispatch_tile(const void* q, const void* k, const void* v,
                          void* out, void* lse, int bh, int sq, int sk, int d,
                          float scale, int causal, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const bool wide = (long long)bh * ((sq + 63) / 64) >= sms;
  if (d == 8 * KS)  // the head dimension fills the k-steps: no tail checks
    return wide ? launch<T, KS, 4, true>(q, k, v, out, lse, bh, sq, sk, d,
                                         scale, causal, stream)
                : launch<T, KS, 1, true>(q, k, v, out, lse, bh, sq, sk, d,
                                         scale, causal, stream);
  return wide ? launch<T, KS, 4, false>(q, k, v, out, lse, bh, sq, sk, d,
                                        scale, causal, stream)
              : launch<T, KS, 1, false>(q, k, v, out, lse, bh, sq, sk, d,
                                        scale, causal, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bh, int sq, int sk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d % 8 != 0 || d < 8) return cudaErrorInvalidValue;
  if (d <= 32)
    return dispatch_tile<T, 4>(q, k, v, out, lse, bh, sq, sk, d, scale,
                               causal, stream);
  if (d <= 64)
    return dispatch_tile<T, 8>(q, k, v, out, lse, bh, sq, sk, d, scale,
                               causal, stream);
  if (d <= 128)
    return dispatch_tile<T, 16>(q, k, v, out, lse, bh, sq, sk, d, scale,
                                causal, stream);
  if (d <= 256)  // KS 32 spills registers (PERF.md); right, not fast
    return dispatch_tile<T, 32>(q, k, v, out, lse, bh, sq, sk, d, scale,
                                causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k and v share it).
// k and v must be 16-byte aligned (cp.async). Returns the launch's cudaGetLastError().
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int sq,
                             int sk, int d, float scale, int causal, int dtype,
                             void* stream) {
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, b * h, sq, sk, d, scale, causal,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, b * h, sq, sk, d, scale,
                                   causal, s);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, out, lse, b * h, sq, sk, d, scale,
                                   causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
