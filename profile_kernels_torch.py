"""What the design choices of the flash-forward (K1), flash-backward (K2a
dK/dV, K2b dQ), paged-decode (K3) and multi-query paged (K4) kernels, and
of the wide route's forward, dK/dV and dQ (K1 wide, K2a wide, K2b wide),
are worth, for the PyTorch/CUDA port, on one GPU.

    python3 profile_kernels_torch.py [--parent DIR]

Builds each kernel as it is and in variants that undo one design choice
(a copy of the source and of the shared headers, edited by string
replacement, one ``nvcc`` per copy, all started together), binds each with
``ctypes`` and times them side by side with ``chip_smoke.device_ms`` at the
main paths' shapes, beside the yardstick of ``chip_smoke.py`` phase 8.
Each variant's largest difference from the plain version is printed too
(the one-product variant shows why the kernel splits its operands), and
for K2 the registers and spill bytes ``ptxas`` reports for the float32
instances at head dimension 64 (the training path's). K3 is timed at the
serving shape and at contexts 1024 and 4096 (B 32 and B 1); with
``--parent DIR`` (a checkout of an earlier commit) that tree's
``paged_decode.cu`` is built beside and held against this one bit for bit
on the smoke's inputs, and its ``flash_wide.cu`` timed beside this one's.
K1 wide, K2a wide and K2b wide are timed at chip_smoke.py phase 8's
shape and at (2,8,2048,512), f32 causal, each in variants that undo one
choice (rows or keys per block, warps and chains of S, ring depth and
chunk sizes, resident Q or K/V, Q and dO staged whole, who issues the
copies, register prefetch, the order of tiles, tensor-core output
products) or drop a part of the work (where the time goes), beside SDPA's
forward and backward, with the ptxas registers and spills of their
float32 instances. The flash kernels are also timed at head dimension
256 (float32) and in float16 at the training shape, beside the ptxas
registers and spills of every instance with 32 k-steps. Last, the rate of
the ``mma.sync`` TF32 instruction that the flash kernels are built on,
with 1 to 16 warps per SM, each warp keeping 8 independent accumulators.
Needs CUDA and ``nvcc``; exits non-zero without them.
"""
import ctypes
import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

DISPATCH = ("  const bool wide = (long long)bh * ((sq + 63) / 64) >= sms;")
K1_VARIANTS = {
    "as built": {},
    "cvt.rna rounding": {
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;":
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));'
        "\n  return r;"},
    "3xTF32 Q.K^T": {
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a3, b1[u]);\n": "",
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a2, b2[u]);\n": "",
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a1, b3[u]);\n": ""},
    "one TF32 product": {
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a3, b1[u]);\n": "",
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a2, b2[u]);\n": "",
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a1, b3[u]);\n": "",
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a2, b1[u]);\n": "",
        "#pragma unroll\n            for (int u = 0; u < NU; ++u) mma(tq[u], a1, b2[u]);\n": "",
        "#pragma unroll\n          for (int s = 0; s < SC; ++s)\n"
        "            if (s0 + s < ksn) mma(tv[s], ps, bb[s]);\n": "",
        "          if (!EXACT) {\n#pragma unroll\n"
        "            for (int s = 0; s < SC; ++s)\n"
        "              if (s0 + s < ksn) mma(tv[s], pb, bs[s]);\n"
        "          }\n": ""},
    "no fresh accumulators": {
        "          for (int u = 0; u < NU; ++u)\n#pragma unroll\n"
        "            for (int i = 0; i < 4; ++i) sc[u][i] += tq[u][i];\n":
        "          for (int u = 0; u < NU; ++u)\n#pragma unroll\n"
        "            for (int i = 0; i < 4; ++i) sc[u][i] = tq[u][i];\n",
        "          float tq[NU][4] = {};\n": "          float (&tq)[NU][4] = sc;\n",
        "          float tv[SC][4] = {};  // fresh, as for the scores\n": "",
        "mma(tv[s], ps, bb[s]);": "mma(o[s0 + s], ps, bb[s]);",
        "mma(tv[s], pb, bs[s]);": "mma(o[s0 + s], pb, bs[s]);",
        "            if (s0 + s < ksn) mma(tv[s], pb, bb[s]);\n#pragma unroll\n"
        "          for (int s = 0; s < SC; ++s)\n#pragma unroll\n"
        "            for (int i = 0; i < 4; ++i) o[s0 + s][i] += tv[s][i];\n":
        "            if (s0 + s < ksn) mma(o[s0 + s], pb, bb[s]);\n"},
    "64-row q-tiles only": {DISPATCH: "  const bool wide = true;"},
    "16-row q-tiles only": {DISPATCH: "  const bool wide = false;"},
}
def _ring1(stage_call):
    """One staging buffer in flight: a tile is loaded only after the one
    before it was computed (no overlap of loads and compute)."""
    return {
        "    if (it + 1 < ntiles) %s;\n    cp_async_commit();\n"
        "    cp_async_wait<1>();\n" % stage_call: "    cp_async_wait<0>();\n",
        "    __syncthreads();  // the next stage overwrites this buffer\n":
        "    __syncthreads();  // the next stage overwrites this buffer\n"
        "    if (it + 1 < ntiles) %s;\n    cp_async_commit();\n" % stage_call}


# the wide launches of K2a (32-key blocks) and K2b (32-row q-tiles) at a
# full head dimension, and their dispatch rules; a 64-key or 64-row variant
# (one query or key group) still writes its dK/dV or dQ through the
# shared-memory sum
WIDE_K2A = "    return wide ? launch<T, KS, 2, true>(q, k, v, dout, lse, delta, dk, dv,"
WIDE_K2B = "    return wide ? launch<T, KS, 2, true>(q, k, v, dout, lse, delta, dq, bh,"
RULE_K2A = "  const bool wide = (long long)bh * ((sk + 31) / 32) >= sms;"
RULE_K2B = "  const bool wide = (long long)bh * ((sq + 31) / 32) >= sms;"
# both kernels run their groups of n-tiles one after another
UNROLLED = {"#pragma unroll 1\n    for (int u0 = 0; u0 < NU; u0 += NG) {":
            "#pragma unroll\n    for (int u0 = 0; u0 < NU; u0 += NG) {"}
K2A_VARIANTS = {
    "as built": {},
    "exact-split dP": {"kstep_lr<3, EXACT, false>(dp, av, gf);":
                       "kstep_lr<6, EXACT, false>(dp, av, gf);"},
    "64-key blocks": {WIDE_K2A: WIDE_K2A.replace("KS, 2, true", "KS, 4, true")},
    "16-key blocks only": {RULE_K2A: "  const bool wide = false;"},
    "ring depth 1": _ring1("stage((it + 1) & 1, q0 + BQ)"),
    "4 n-tiles at once": {"constexpr int GROUP = 2;": "constexpr int GROUP = 4;"},
    "group loop unrolled": UNROLLED,
}
K2B_VARIANTS = {
    "as built": {},
    "exact-split dP": {"kstep_lr<3, EXACT, true>(dp, ga, vf);":
                       "kstep_lr<6, EXACT, true>(dp, ga, vf);"},
    "64-row q-tiles": {WIDE_K2B: WIDE_K2B.replace("KS, 2, true", "KS, 4, true")},
    "16-row q-tiles only": {RULE_K2B: "  const bool wide = false;"},
    "ring depth 1": _ring1("stage((it + 1) & 1, (it + 1) * BK)"),
    "4 n-tiles at once": {"constexpr int GROUP = 2;": "constexpr int GROUP = 4;"},
    "group loop unrolled": UNROLLED,
}
# the float32 instances at head dimension 64 (KS 8, full D) with 64-, 32-
# and 16-row/key tiles: 32 is the training path's, 16 small grids' (e.g.
# chip_smoke.py phase 6), 64 the variants'
K2_INSTANCES = (("64", "IfLi8ELi4ELb1EE"), ("32", "IfLi8ELi2ELb1EE"),
                ("16", "IfLi8ELi1ELb1EE"))
K3_VARIANTS = {
    "as built": {},
    "256 threads": {"constexpr int THREADS = 512;": "constexpr int THREADS = 256;"},
    "a warp per position": {"constexpr int TPP = 4; ": "constexpr int TPP = 32;"},
    "2 threads per position": {"constexpr int TPP = 4; ": "constexpr int TPP = 2; "},
    "64-position chunks, 4 slots": {
        "constexpr int CH_MAX = 256;": "constexpr int CH_MAX = 64;",
        "constexpr int STAGES = 3;": "constexpr int STAGES = 4;"},
    "128-position chunks": {"constexpr int CH_MAX = 256;": "constexpr int CH_MAX = 128;"},
    "V chains per dim only": {
        "      for (int e = tid; e < jn * dp; e += THREADS) {\n"
        "        const int jj = jlo + e / dp;\n"
        "        const int dim = e % dp;\n":
        "      for (int e = tid; e < dp; e += THREADS)\n"
        "      for (int jj = jlo; jj < jlo + jn; ++jj) {\n"
        "        const int dim = e;\n"},
    "cp.async through L1 (.ca)": {
        "cp.async.cg.shared.global [%0], [%1], 16;":
        "cp.async.ca.shared.global [%0], [%1], 16;"},
    # where the time goes (wrong results): the copies and the softmax
    # bookkeeping alone; the launch and the prologue alone
    "no scoring, no V pass": {
        "for (int base = x.c0; base < x.c1; base += THREADS / TPP) {":
        "for (int base = x.c0; base < x.c0; base += THREADS / TPP) {",
        "for (int e = tid; e < jn * dp; e += THREADS) {":
        "for (int e = tid; e < 0; e += THREADS) {"},
    "prologue only": {"  const int njobs = nseg > 0 ?":
                      "  const int njobs = 0 && nseg > 0 ?"},
}
K4_VARIANTS = {
    "as built": {},
    "256 threads": {"      <<<grid, BLOCK_THREADS, smem, stream>>>(":
                    "      <<<grid, 256, smem, stream>>>("},
    "2-slot ring": {"constexpr int STAGES = 4;": "constexpr int STAGES = 2;"},
}
# the wide route's forward (K1 wide) and dQ (K2b wide) in csrc/flash_wide.cu
# (D > 256): the design's choices undone one at a time, and where the time
# goes (wrong results): without the score chains, without the output
# product, neither
WIDE_FWD_S = ("      if (warp < FWD_S_WARPS)\n"
              "        chains(acc, QRES ? qres + dc : st, qs_stride,\n"
              "               QRES ? st : st + RB * KS, KS, min(FWD_DC, d - dc), li, sc);\n")
WIDE_FWD_PV = "      out_product(o, ps, st, (j - nk) * VC, li, oc);\n"
WIDE_DQ_S = ("        chains(acc, QRES ? qres + dc : st, qs_stride, ks, KS, dn, li, sc);\n"
             "      else if (dp_warp)\n"
             "        chains(acc, QRES ? gres + dc : st + RB * KS, qs_stride, ks + KB * KS,\n"
             "               KS, dn, li, sc);\n")
WIDE_DQ_PV = "      out_product(o, dss, st, (j - nk) * VC, li, oc);\n"
# rotated: each row block starts at its own key tile (blockIdx.y mod its
# tiles), so that the row blocks of one head do not read the same K/V
# tile at once
ROTATED = {"n / per * KB": "(n / per + blockIdx.y) % ntiles * KB"}
Q_STREAMED = {
    "  return d <= WMAX ? fwd_launch<T, true>": "  return false ? fwd_launch<T, true>",
    "  return d <= WMAX ? dq_launch<T, true>": "  return false ? dq_launch<T, true>"}
# the chains with the next step's operands loaded ahead (tried: no gain
# once the copies are issued by other warps)
PREFETCH = {
    "  float4 x[MR], y[NC];\n"
    "#pragma unroll (UNROLL)\n"
    "  for (int j = 0; j < n; j += 4) {\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < MR; ++i) x[i] = load4(a + (r + 4 * i) * sa + j);\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < NC; ++k) y[k] = load4(b + (c + 8 * k) * sb + j);\n":
    "  float4 x[MR], y[NC];\n"
    "  for (int i = 0; i < MR; ++i) x[i] = load4(a + (r + 4 * i) * sa);\n"
    "  for (int k = 0; k < NC; ++k) y[k] = load4(b + (c + 8 * k) * sb);\n"
    "#pragma unroll (UNROLL)\n"
    "  for (int j = 0; j < n; j += 4) {\n"
    "    const int jn = j + 4 < n ? j + 4 : j;\n"
    "    float4 xn[MR], yn[NC];\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < MR; ++i) xn[i] = load4(a + (r + 4 * i) * sa + jn);\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < NC; ++k) yn[k] = load4(b + (c + 8 * k) * sb + jn);\n",
    "        acc[i][k] = __fmaf_rn(x[i].w, y[k].w, acc[i][k]);\n"
    "      }\n"
    "  }\n":
    "        acc[i][k] = __fmaf_rn(x[i].w, y[k].w, acc[i][k]);\n"
    "      }\n"
    "    for (int i = 0; i < MR; ++i) x[i] = xn[i];\n"
    "    for (int k = 0; k < NC; ++k) y[k] = yn[k];\n"
    "  }\n"}
ALL_ISSUE = {"constexpr int ISSUERS = 128;": "constexpr int ISSUERS = 0;"}
# the forward's and dQ's copies taken row by row by each issuing warp, and
# their chains unrolled by 4, as dK/dV's
ROW_COPIES = {"template <typename T, bool ROWS = false>":
              "template <typename T, bool ROWS = true>"}
CHAINS_UNROLL4 = {"int UNROLL = 2>": "int UNROLL = 4>"}
WIDE_FWD_VARIANTS = {
    "as built": {},
    "copies row by row": ROW_COPIES,
    "chains unrolled by 4": CHAINS_UNROLL4,
    "register prefetch in the chains": PREFETCH,
    "32 rows per block": {"constexpr int FWD_RB = 16;": "constexpr int FWD_RB = 32;"},
    "copies issued by every warp": ALL_ISSUE,
    "S on 8 warps (4x1 chains each)": dict(ALL_ISSUE, **{
        "constexpr int FWD_S_WARPS = 4;": "constexpr int FWD_S_WARPS = 8;"}),
    "S on 2 warps (4x4 chains each)": {"constexpr int FWD_S_WARPS = 4;":
                                       "constexpr int FWD_S_WARPS = 2;"},
    "3-stage ring": {"constexpr int FWD_STAGES = 2;": "constexpr int FWD_STAGES = 3;"},
    "4-stage ring, 64-dim S chunks, 8-key V chunks": {
        "constexpr int FWD_STAGES = 2;": "constexpr int FWD_STAGES = 4;",
        "constexpr int FWD_DC = 128;": "constexpr int FWD_DC = 64;",
        "constexpr int VC = 16;": "constexpr int VC = 8;"},
    "Q streamed (no resident rows)": Q_STREAMED,
    "tiles rotated by row block": ROTATED,
    "no S chains": {WIDE_FWD_S: ""},
    "no output product": {WIDE_FWD_PV: ""},
    "neither": {WIDE_FWD_S: "", WIDE_FWD_PV: ""},
}
WIDE_DQ_VARIANTS = {
    "as built": {},
    "copies row by row": ROW_COPIES,
    "chains unrolled by 4": CHAINS_UNROLL4,
    "copies issued by every warp": ALL_ISSUE,
    "register prefetch in the chains": PREFETCH,
    "S and dP on 4 warps each (4x2 chains)": dict(ALL_ISSUE, **{
        "constexpr int DQ_S_WARPS = 2;": "constexpr int DQ_S_WARPS = 4;"}),
    "S and dP on 1 warp each (4x8 chains)": {
        "constexpr int DQ_S_WARPS = 2;": "constexpr int DQ_S_WARPS = 1;"},
    "2-stage ring": {"constexpr int DQ_STAGES = 4;": "constexpr int DQ_STAGES = 2;"},
    "32-dim S chunks, 8-key chunks": {
        "constexpr int DQ_DC = 64;": "constexpr int DQ_DC = 32;",
        "constexpr int VC = 16;": "constexpr int VC = 8;"},
    "Q streamed (no resident rows)": Q_STREAMED,
    "tiles rotated by row block": ROTATED,
    "no S/dP chains": {WIDE_DQ_S: "        ;\n"},
    "no output product": {WIDE_DQ_PV: ""},
    "neither": {WIDE_DQ_S: "        ;\n", WIDE_DQ_PV: ""},
}
# the wide dK/dV (K2a wide): the design's choices undone one at a time,
# and where the time goes (wrong results)
WIDE_DKV_S = ("      if (s_warp)\n"
              "        chains<T, MR, NC, DKV_UNROLL>(acc, ks, KRES ? RS : QS, st, QS, dn,\n"
              "                                      li, sc);\n"
              "      else if (dp_warp)\n"
              "        chains<T, MR, NC, DKV_UNROLL>(acc, vs, KRES ? RS : QS, st + QT * QS,\n"
              "                                      QS, dn, li, sc);\n")
WIDE_DKV_PV = {
    "          out_product<T, TR, QT, QT + 4, QS>(dva, pss, st + QT * QS, 0, li,\n"
    "                                             oc);\n"
    "          out_product<T, TR, QT, QT + 4, QS>(dka, dss, st, 0, li, oc);\n": "",
    "      out_product<T, TR, OC, QT + 4, RS>(dva, pss, st + OC * RS, kc, li, oc);\n"
    "      out_product<T, TR, OC, QT + 4, RS>(dka, dss, st, kc, li, oc);\n": ""}
DKV_CHUNKED = {"constexpr int DKV_DC = WMAX;": "constexpr int DKV_DC = 128;"}
# key blocks of one head side by side on the grid's x axis (its Q and dO
# shared in L2 by the blocks in flight), not the heads
DKV_HEADS_OUTER = {
    "  const int bh = blockIdx.x;\n  const int k0 = blockIdx.y * KR;":
    "  const int bh = blockIdx.y;\n  const int k0 = blockIdx.x * KR;",
    "  const dim3 grid(bh, (sk + KR - 1) / KR, slices(d));":
    "  const dim3 grid((sk + KR - 1) / KR, bh, slices(d));"}
# the copies spread over the issuing threads in turn, a division per copy
FLAT_COPIES = {"stage_async<T, true>": "stage_async<T, false>"}
# the output products on the tensor cores in 3xTF32 (tf32_mma.cuh's
# kstep_split, as K2a at D <= 256): each warp one m16 tile of the 16 keys
# x 8 n-tiles of its 64 columns, accumulators in C-fragment layout
TC_OUT_FNS = r"""
template <typename T, int N, int YS>
__device__ __forceinline__ void tc_out(float (&acc)[8][4],
                                       const float* __restrict__ w,
                                       const T* __restrict__ y, int kc,
                                       int lane, int col0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < N; k8 += 8) {
    const float* w0 = w + kc + k8 + t;
    const float a[4] = {w0[g * (QT + 4)], w0[(g + 8) * (QT + 4)],
                        w0[g * (QT + 4) + 4], w0[(g + 8) * (QT + 4) + 4]};
    float b[8][2];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      b[u][0] = tf32mma::to_float(y[(k8 + t) * YS + col0 + 8 * u + g]);
      b[u][1] = tf32mma::to_float(y[(k8 + t + 4) * YS + col0 + 8 * u + g]);
    }
    tf32mma::kstep_split<sizeof(T) == 2, 8>(acc, a, b);
  }
}

__device__ __forceinline__ void tc_store(float* __restrict__ dst,
                                         const float (&acc)[8][4], int k0,
                                         int sk, int ld, int c0, int width,
                                         int lane, int col0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int col = col0 + 8 * u + 2 * t;
    if (col >= width) continue;
    if (k0 + g < sk)
      *reinterpret_cast<float2*>(dst + (size_t)(k0 + g) * ld + c0 + col) =
          make_float2(acc[u][0], acc[u][1]);
    if (k0 + g + 8 < sk)
      *reinterpret_cast<float2*>(dst + (size_t)(k0 + g + 8) * ld + c0 + col) =
          make_float2(acc[u][2], acc[u][3]);
  }
}

// dK and dV for KR keys"""
TC_OUT = {
    "\n// dK and dV for KR keys": TC_OUT_FNS,
    "  float dka[TR][2][4] = {}, dva[TR][2][4] = {};":
    "  float dka[8][4] = {}, dva[8][4] = {};",
    "          out_product<T, TR, QT, QT + 4, QS>(dva, pss, st + QT * QS, 0, li,\n"
    "                                             oc);\n"
    "          out_product<T, TR, QT, QT + 4, QS>(dka, dss, st, 0, li, oc);\n":
    "          tc_out<T, QT, QS>(dva, pss, st + QT * QS, 0, lane, warp * 64);\n"
    "          tc_out<T, QT, QS>(dka, dss, st, 0, lane, warp * 64);\n",
    "      out_product<T, TR, OC, QT + 4, RS>(dva, pss, st + OC * RS, kc, li, oc);\n"
    "      out_product<T, TR, OC, QT + 4, RS>(dka, dss, st, kc, li, oc);\n":
    "      tc_out<T, OC, RS>(dva, pss, st + OC * RS, kc, lane, warp * 64);\n"
    "      tc_out<T, OC, RS>(dka, dss, st, kc, lane, warp * 64);\n",
    "  store_out(dk + (size_t)bh * sk * d, dka, one, k0, sk, d, c0, width, li, oc);\n"
    "  store_out(dv + (size_t)bh * sk * d, dva, one, k0, sk, d, c0, width, li, oc);\n":
    "  tc_store(dk + (size_t)bh * sk * d, dka, k0, sk, d, c0, width, lane, warp * 64);\n"
    "  tc_store(dv + (size_t)bh * sk * d, dva, k0, sk, d, c0, width, lane, warp * 64);\n"}
# S^T and dP^T: each thread 2 keys x 2 queries (4 loads per 16 fmaf, not
# 5), a warp 8 keys x 16 queries
CHAINS_2X2 = {
    "static_assert(QT % (8 * DKV_S_WARPS) == 0 &&":
    "static_assert(KR % (4 * DKV_S_WARPS) == 0 &&",
    "constexpr int TR = KR / 4, MR = KR / 4, NC = QT / (8 * DKV_S_WARPS);":
    "constexpr int TR = KR / 4, MR = KR / (4 * DKV_S_WARPS), NC = QT / 8;",
    "  const int sc = warp % DKV_S_WARPS * 8 * NC + lj;":
    "  const int sc = lj, kw = warp % DKV_S_WARPS * 4 * MR;",
    "(acc, ks, KRES ? RS : QS,": "(acc, ks + kw * (KRES ? RS : QS), KRES ? RS : QS,",
    "(acc, vs, KRES ? RS : QS,": "(acc, vs + kw * (KRES ? RS : QS), KRES ? RS : QS,",
    "              dst[(li + 4 * a) * (QT + 4) + sc + 8 * b] = acc[a][b];":
    "              dst[(kw + li + 4 * a) * (QT + 4) + sc + 8 * b] = acc[a][b];"}
WIDE_DKV_VARIANTS = {
    "as built": {},
    "copies issued by every warp": ALL_ISSUE,
    "copies spread over the issuers (a division per copy)": FLAT_COPIES,
    "chains unrolled by 4": {"constexpr int DKV_UNROLL = 8;":
                             "constexpr int DKV_UNROLL = 4;"},
    "chains unrolled by 2": {"constexpr int DKV_UNROLL = 8;":
                             "constexpr int DKV_UNROLL = 2;"},
    "S and dP on 1 warp each (4x2 chains)": {
        "constexpr int DKV_S_WARPS = 2;": "constexpr int DKV_S_WARPS = 1;"},
    "2x2 chains (2 keys x 2 queries a thread)": CHAINS_2X2,
    "Q/dO in 128-dim chunks, then 8-row output chunks": DKV_CHUNKED,
    "128-dim chunks, 3-stage ring": dict(DKV_CHUNKED, **{
        "constexpr int DKV_STAGES = 2;": "constexpr int DKV_STAGES = 3;"}),
    "128-dim chunks, 4-stage ring": dict(DKV_CHUNKED, **{
        "constexpr int DKV_STAGES = 2;": "constexpr int DKV_STAGES = 4;"}),
    "32 keys per block (128-dim chunks)": dict(DKV_CHUNKED, **{
        "constexpr int KR = 16;": "constexpr int KR = 32;"}),
    "key blocks of a head side by side (heads outer)": DKV_HEADS_OUTER,
    "output products on the tensor cores (3xTF32)": TC_OUT,
    "no S/dP chains": {WIDE_DKV_S: ""},
    "no output products": WIDE_DKV_PV,
    "neither": dict(WIDE_DKV_PV, **{WIDE_DKV_S: ""}),
}
# the shapes: chip_smoke.py phase 8's and a long one
WIDE_SHAPES = ((8, 2, 128, 512), (2, 8, 2048, 512))
MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x * 1e-3f + i);
  b[0] = a[0];
  b[1] = a[1];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(void* out, int blocks, int threads, int iters, void* stream) {
  mma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return cudaGetLastError();
}
"""


def _variants(kernel, variants, out_dir, build, nvcc):
    """Start one nvcc per variant of ``kernel``: each in a directory of its
    own, holding a copy of the source and of the shared headers (which the
    source's quoted includes find first), each replacement made in the
    file that holds its text."""
    names = [kernel.source] + sorted(glob.glob(os.path.join(build.CSRC,
                                                            "*.cuh")))
    procs = {}
    for name, reps in variants.items():
        texts = {path: open(path).read() for path in names}
        for a, b in reps.items():
            path = next((p for p in names if a in texts[p]), None)
            if path is None:
                raise RuntimeError("%s variant %r: %r not in the source or "
                                   "its headers" % (kernel.name, name, a[:60]))
            texts[path] = texts[path].replace(a, b)
        vdir = os.path.join(out_dir, "%s-%d" % (kernel.name, len(procs)))
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for path, text in texts.items():
            with open(os.path.join(vdir, os.path.basename(path)), "w") as f:
                f.write(text)
        stem = os.path.join(vdir, os.path.splitext(
            os.path.basename(kernel.source))[0])
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"]
        procs[name] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def ptxas_report(log):
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from the ``-Xptxas -v`` output of one build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _bind(procs, kernel, logs=None):
    fns = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s %r:\n%s"
                               % (kernel.name, name, log))
        if logs is not None:
            logs[name] = log
        fn = getattr(ctypes.CDLL(os.path.abspath(stem + ".so")), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fns[name] = fn
    return fns


def _parent_k3(parent, out_dir, build, nvcc):
    """The parent tree's paged_decode.cu and headers, built as they are."""
    src = os.path.join(parent, "mxnet_tpu_torch", "csrc")
    vdir = os.path.join(out_dir, "paged_decode-parent")
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    for path in [os.path.join(src, "paged_decode.cu")] + glob.glob(
            os.path.join(src, "*.cuh")):
        shutil.copy(path, vdir)
    stem = os.path.join(vdir, "paged_decode")
    return subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), stem


def _k3_inputs(C, B, ctx, page_dtype=torch.float32):
    """K3's inputs as chip_smoke.time_paged makes them: the serving mix
    (ctx None) or every sequence at context ctx."""
    rng = np.random.default_rng(3)
    if ctx is None:
        nb = 8
        lens = [int(x) for x in rng.integers(1, 129, B)]
    else:
        nb = ctx // 16
        lens = [ctx] * B
    return C.paged_inputs(rng, B, page_dtype, lens, N=max(257, B * nb + 1),
                          nb=nb)


def _wide_entry(regs, kernel, qres):
    """ptxas (registers, spill stores) of the float32 instance of a wide
    kernel with Q resident or streamed."""
    tag = "%sIfLb%dE" % (kernel, int(qres))
    return next(("%d/%d" % (r, st) for n, (r, st, _) in regs.items()
                 if tag in n), "?")


def time_wide(C, build, A, out_dir, nvcc, fwd_variants=None, dq_variants=None,
              others=None, dkv_variants=None):
    """K1 wide, K2a wide and K2b wide variants (``flash_wide.cu`` copies)
    at ``WIDE_SHAPES``, f32 causal, beside SDPA (forward; backward: autograd
    through it less its forward); ``others`` ({label: path} of
    ``flash_wide.cu`` files, e.g. an earlier tree's) are built and timed
    beside them. Prints us per call, the max abs error against the plain
    version and the ptxas registers / spill store bytes of the f32
    instances (Q or K/V resident, streamed)."""
    fwd_variants = WIDE_FWD_VARIANTS if fwd_variants is None else fwd_variants
    dq_variants = WIDE_DQ_VARIANTS if dq_variants is None else dq_variants
    dkv_variants = (WIDE_DKV_VARIANTS if dkv_variants is None
                    else dkv_variants)
    logs_f, logs_q, logs_k = {}, {}, {}
    procs_f = _variants(build.FLASH_WIDE_FWD, fwd_variants, out_dir, build,
                        nvcc)
    procs_q = _variants(build.FLASH_WIDE_BWD_DQ, dq_variants, out_dir, build,
                        nvcc)
    procs_k = _variants(build.FLASH_WIDE_BWD_DKV, dkv_variants, out_dir,
                        build, nvcc)
    fwd = _bind(procs_f, build.FLASH_WIDE_FWD, logs_f)
    dqs = _bind(procs_q, build.FLASH_WIDE_BWD_DQ, logs_q)
    dkvs = _bind(procs_k, build.FLASH_WIDE_BWD_DKV, logs_k)
    procs = {}
    for i, (label, path) in enumerate((others or {}).items()):
        vdir = os.path.join(out_dir, "flash_wide-other-%d" % i)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for src in [path] + glob.glob(os.path.join(build.CSRC, "*.cuh")):
            shutil.copy(src, vdir)
        shutil.move(os.path.join(vdir, os.path.basename(path)),
                    os.path.join(vdir, "flash_wide.cu"))
        stem = os.path.join(vdir, "flash_wide")
        procs[label] = (stem, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for label, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (label, log))
        lib = ctypes.CDLL(os.path.abspath(stem + ".so"))
        for fns, kernel, logs in ((fwd, build.FLASH_WIDE_FWD, logs_f),
                                  (dqs, build.FLASH_WIDE_BWD_DQ, logs_q),
                                  (dkvs, build.FLASH_WIDE_BWD_DKV, logs_k)):
            fn = getattr(lib, kernel.symbol)
            fn.argtypes = kernel.argtypes
            fns[label] = fn
            logs[label] = log
    stream = torch.cuda.current_stream().cuda_stream
    F = torch.nn.functional
    for kernel, fns, logs in (("wide_fwd_kernel", fwd, logs_f),
                              ("wide_dq_kernel", dqs, logs_q),
                              ("wide_dkv_kernel", dkvs, logs_k)):
        print("%s ptxas registers/spill stores, f32 (resident; streamed): "
              "%s" % (kernel, ", ".join(
                  "%s %s; %s" % (name, _wide_entry(ptxas_report(log), kernel, 1),
                                 _wide_entry(ptxas_report(log), kernel, 0))
                  for name, log in logs.items())), flush=True)
    rng = np.random.default_rng(9)
    for b, h, s, d in WIDE_SHAPES:
        q, k, v = C.flash_inputs(rng, b, h, s, s, d, torch.float32)
        g = C.flash_inputs(rng, b, h, s, s, d, torch.float32)[0]
        scale = d ** -0.5
        ref_out, ref_lse = A._flash_forward_plain(q, k, v, True, scale)
        ref_dq, ref_dk, ref_dv = A._flash_backward_plain(
            q, k, v, ref_out, ref_lse, g, True, scale)
        delta = (ref_out * g).sum(dim=-1)
        out, lse, dq, dk, dv = (torch.empty_like(x)
                                for x in (q, ref_lse, q, k, v))
        dims = (b, h, s, s, d, scale, 1, 0, stream)
        for label, fns, call_args, outs, refs in (
                ("K1 wide", fwd, lambda: (q.data_ptr(), k.data_ptr(),
                                          v.data_ptr(), out.data_ptr(),
                                          lse.data_ptr()),
                 (out, lse), (ref_out, ref_lse)),
                ("K2b wide", dqs, lambda: tuple(x.data_ptr() for x in (
                    q, k, v, g, ref_lse, delta, dq)), (dq,), (ref_dq,)),
                ("K2a wide", dkvs, lambda: tuple(x.data_ptr() for x in (
                    q, k, v, g, ref_lse, delta, dk, dv)), (dk, dv),
                 (ref_dk, ref_dv))):
            cells = []
            for name, fn in fns.items():
                def call(fn=fn):
                    code = fn(*call_args(), *dims)
                    assert code == 0, code
                call()
                torch.cuda.synchronize()
                err = max((o - r).abs().max().item()
                          for o, r in zip(outs, refs))
                cells.append("%s %.4f (%.1e)" % (name, C.device_ms(call) * 1e3,
                                                 err))
            print("  %s (%d,%d,%d,%d): %s" % (label, b, h, s, d,
                                              ", ".join(cells)), flush=True)
        lib = C.device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)) * 1e3
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        lib_fb = C.device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
            g)) * 1e3
        lib_f = C.device_ms(lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=True)) * 1e3
        print("  SDPA forward (%d,%d,%d,%d) %.4f, backward (fwd+bwd less fwd) "
              "%.4f" % (b, h, s, d, lib, lib_fb - lib_f), flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_kernels_torch: no CUDA device", file=sys.stderr)
        return 2
    parent = sys.argv[sys.argv.index("--parent") + 1] \
        if "--parent" in sys.argv else None
    import chip_smoke as C
    from mxnet_tpu_torch.ops import _build as build
    from mxnet_tpu_torch.ops import attention as A

    print(C.card_line(), flush=True)
    nvcc = build._nvcc()
    out_dir = os.path.join(build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "mma_rate.cu"), "w") as f:
        f.write(MMA_BENCH)
    mma = subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", os.path.join(out_dir, "mma_rate.so"),
         os.path.join(out_dir, "mma_rate.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    k1_logs = {}
    k1 = _bind(_variants(build.FLASH_FWD, K1_VARIANTS, out_dir, build, nvcc),
               build.FLASH_FWD, k1_logs)
    par = _parent_k3(parent, out_dir, build, nvcc) if parent else None
    k3v = _bind(_variants(build.PAGED_DECODE, K3_VARIANTS, out_dir, build,
                          nvcc), build.PAGED_DECODE)
    k4 = _bind(_variants(build.PAGED_DECODE_MULTI, K4_VARIANTS, out_dir,
                         build, nvcc), build.PAGED_DECODE_MULTI)
    k2_logs = {"dkv": {}, "dq": {}}
    k2a = _bind(_variants(build.FLASH_BWD_DKV, K2A_VARIANTS, out_dir, build,
                          nvcc), build.FLASH_BWD_DKV, k2_logs["dkv"])
    k2b = _bind(_variants(build.FLASH_BWD_DQ, K2B_VARIANTS, out_dir, build,
                          nvcc), build.FLASH_BWD_DQ, k2_logs["dq"])
    stream = torch.cuda.current_stream().cuda_stream
    F = torch.nn.functional

    print("K1 flash_fwd, causal f32, us per call (max abs err vs plain):")
    rng = np.random.default_rng(2)
    for b, h, s, d in ((32, 4, 128, 64), (1, 4, 128, 64)):
        q, k, v = C.flash_inputs(rng, b, h, s, s, d, torch.float32)
        ref, _ = A._flash_forward_plain(q, k, v, True, d ** -0.5)
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], device="cuda")
        cells = []
        for name, fn in k1.items():
            def call(fn=fn):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(), b, h, s, s, d,
                          d ** -0.5, 1, 0, stream)
                assert code == 0, code
            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            cells.append("%s %.4f (%.1e)" % (name, C.device_ms(call) * 1e3,
                                             err))
        lib = C.device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)) * 1e3
        print("  (%d,%d,%d,%d): %s | SDPA %.4f" % (b, h, s, d,
                                                   ", ".join(cells), lib),
              flush=True)

    b, h, s, d = 32, 4, 128, 64
    print("K2 flash backward at the training shape (%d,%d,%d,%d), causal "
          "f32, us per call (max abs err vs plain; ptxas registers/spill "
          "store bytes of the f32 D 64 instances by rows or keys per tile):"
          % (b, h, s, d))
    rng = np.random.default_rng(5)
    q, k, v = C.flash_inputs(rng, b, h, s, s, d, torch.float32)
    g = C.flash_inputs(rng, b, h, s, s, d, torch.float32)[0]
    out, lse = A.flash_attention_forward(q, k, v, True)
    delta = (out * g).sum(dim=-1)
    ref = A._flash_backward_plain(q, k, v, out, lse, g, True, d ** -0.5)
    grads = [torch.empty_like(q) for _ in range(3)]
    ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta)]
    dims = (b, h, s, s, d, d ** -0.5, 1, 0, stream)
    for label, fns, outs, refs, logs in (
            ("K2a flash_bwd_dkv", k2a, grads[1:], ref[1:], k2_logs["dkv"]),
            ("K2b flash_bwd_dq", k2b, grads[:1], ref[:1], k2_logs["dq"])):
        cells = []
        for name, fn in fns.items():
            def call(fn=fn):
                code = fn(*ptrs, *(x.data_ptr() for x in outs), *dims)
                assert code == 0, code
            call()
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
            regs = ptxas_report(logs[name])
            spills = ["%s: %d/%d" % (rows, r, st) for rows, tag in K2_INSTANCES
                      for n, (r, st, _) in regs.items() if tag in n]
            cells.append("%s %.4f (%.1e; %s)" % (name, C.device_ms(call) * 1e3,
                                                 err, ", ".join(spills)))
        print("  %s: %s" % (label, ", ".join(cells)), flush=True)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    lib_fb = C.device_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, g))
    lib_f = C.device_ms(lambda: F.scaled_dot_product_attention(
        *leaves, is_causal=True))
    print("  SDPA backward (fwd+bwd less fwd) %.4f" % ((lib_fb - lib_f) * 1e3),
          flush=True)

    print("K4 paged_decode_multi, verify shapes (B 32, bs 16, H 4, D 64, "
          "f32), us per call:")
    for T in (1, 4, 16):
        rng = np.random.default_rng(7)
        lens = C.verify_lens(rng, 32, T, hi=128 - T)
        q, kp, vp, bt, cl = C.paged_inputs(rng, 32, torch.float32, lens)
        ref = A.paged_attention_multi_reference(q, kp, vp, bt, cl)
        out = torch.empty_like(q)
        cells = []
        for name, fn in k4.items():
            def call(fn=fn):
                code = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                          bt.data_ptr(), cl.data_ptr(), out.data_ptr(), 32, T,
                          4, 64, kp.shape[0], 16, 8, 0.125, 0, stream)
                assert code == 0, code
            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            cells.append("%s %.4f (%.1e)" % (name, C.device_ms(call) * 1e3,
                                             err))
        q1, c1 = q[:, 0].contiguous(), cl[:, 0].contiguous()
        k3 = C.device_ms(lambda: A.paged_attention(q1, kp, vp, bt, c1)) * 1e3
        print("  T %d: %s | K3 (lane 0 alone) %.4f" % (T, ", ".join(cells),
                                                       k3), flush=True)

    print("K3 paged_decode (bs 16, H 4, D 64, f32 pages), us per call "
          "(max abs err vs plain):")
    for B, ctx in ((32, None), (32, 1024), (32, 4096), (1, 1024), (1, 4096)):
        q, kp, vp, bt, cl = _k3_inputs(C, B, ctx)
        nb = bt.shape[1]
        ref = A.paged_attention_reference(q, kp, vp, bt, cl)
        out = torch.empty_like(q)
        cells = []
        for name, fn in k3v.items():
            def call(fn=fn):
                code = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                          bt.data_ptr(), cl.data_ptr(), out.data_ptr(), B, 4,
                          64, kp.shape[0], 16, nb, 0.125, 0, stream)
                assert code == 0, code
            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            cells.append("%s %.4f (%.1e)" % (name, C.device_ms(call) * 1e3,
                                             err))
        print("  B %d, %s: %s" % (B, "serving contexts 1..128" if ctx is None
                                  else "context %d" % ctx, ", ".join(cells)),
              flush=True)

    if par is not None:
        proc, stem = par
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for the parent's K3:\n" + log)
        fn = getattr(ctypes.CDLL(os.path.abspath(stem + ".so")),
                     "mxt_paged_decode")
        # the parent's interface is this tree's (PR 6 on)
        fn.argtypes = build.PAGED_DECODE.argtypes
        print("K3 against the parent's (%s) build, bit for bit, and us per "
              "call (this tree | parent):" % parent)
        for B, ctx, pdt in ((32, None, torch.float32),
                            (32, None, torch.bfloat16),
                            (8, 1024, torch.float32),
                            (32, 4096, torch.float32)):
            q, kp, vp, bt, cl = _k3_inputs(C, B, ctx, pdt)
            nb = bt.shape[1]
            mine = A.paged_attention(q, kp, vp, bt, cl)
            theirs = torch.empty_like(q)

            def old():
                code = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                          bt.data_ptr(), cl.data_ptr(), theirs.data_ptr(), B,
                          4, 64, kp.shape[0], 16, nb, 0.125,
                          A._DTYPE_CODE[pdt], stream)
                assert code == 0, code
            old()
            torch.cuda.synchronize()
            same = torch.equal(mine, theirs)
            print("  B %d, %s, %s pages: bitwise equal %s; %.4f | %.4f"
                  % (B, "serving contexts" if ctx is None else
                     "context %d" % ctx, str(pdt)[6:], same,
                     C.device_ms(lambda: A.paged_attention(q, kp, vp, bt,
                                                           cl)) * 1e3,
                     C.device_ms(old) * 1e3), flush=True)
            if not same:
                raise RuntimeError("K3 differs from the parent's K3")

    print("Flash kernels past D 128 and in float16, causal, us per call "
          "(max abs err vs plain):")
    for b, h, s_, d, dt in ((32, 4, 128, 256, torch.float32),
                            (32, 4, 128, 256, torch.bfloat16),
                            (32, 4, 128, 64, torch.float16),
                            (32, 4, 128, 64, torch.float32)):
        rng = np.random.default_rng(5)
        q, k, v = C.flash_inputs(rng, b, h, s_, s_, d, dt)
        g = C.flash_inputs(rng, b, h, s_, s_, d, dt)[0]
        out, lse = A.flash_attention_forward(q, k, v, True)
        ref_out, _ = A._flash_forward_plain(q, k, v, True, d ** -0.5)
        delta = (out * g.float()).sum(dim=-1)
        grads = [torch.empty(q.shape, device="cuda") for _ in range(3)]
        ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta)]
        dims = (b, h, s_, s_, d, d ** -0.5, 1, A._DTYPE_CODE[dt], stream)
        ref = A._flash_backward_plain(q, k, v, out.to(dt), lse, g, True,
                                      d ** -0.5)
        t_fwd = C.device_ms(lambda: A.flash_attention_forward(q, k, v, True))
        build.FLASH_BWD_DKV.launch(*ptrs, grads[1].data_ptr(),
                                   grads[2].data_ptr(), *dims)
        build.FLASH_BWD_DQ.launch(*ptrs, grads[0].data_ptr(), *dims)
        torch.cuda.synchronize()
        err = max((a - r.float()).abs().max().item()
                  for a, r in zip(grads, ref))
        t_dkv = C.device_ms(lambda: build.FLASH_BWD_DKV.launch(
            *ptrs, grads[1].data_ptr(), grads[2].data_ptr(), *dims))
        t_dq = C.device_ms(lambda: build.FLASH_BWD_DQ.launch(
            *ptrs, grads[0].data_ptr(), *dims))
        print("  (%d,%d,%d,%d) %s: K1 %.4f (%.1e), K2a %.4f, K2b %.4f "
              "(gradients %.1e against the plain version's, float32)"
              % (b, h, s_, d, str(dt)[6:], t_fwd * 1e3,
                 (out - ref_out).abs().max().item(), t_dkv * 1e3,
                 t_dq * 1e3, err), flush=True)
    print("ptxas registers / spill store bytes of the 32-k-step (D 136..256) "
          "instances:")
    logs = {"flash_fwd": k1_logs["as built"],
            "flash_bwd_dkv": k2_logs["dkv"]["as built"],
            "flash_bwd_dq": k2_logs["dq"]["as built"]}
    for name, text in logs.items():
        # the template arguments <dtype, KS, row/key groups, full D>
        cells = ["%s %d/%d" % (re.search(r"kernelI(.*?)EEv", fn_name).group(1),
                               r, st)
                 for fn_name, (r, st, _) in sorted(ptxas_report(text).items())
                 if re.search(r"Li32ELi\dELb", fn_name)]
        print("  %s: %s" % (name, ", ".join(cells)), flush=True)

    time_wide(C, build, A, out_dir, nvcc, others=None if parent is None else {
        "parent": os.path.join(parent, "mxnet_tpu_torch", "csrc",
                               "flash_wide.cu")})

    log, _ = mma.communicate()
    if mma.returncode:
        raise RuntimeError("nvcc failed for the mma rate kernel:\n" + log)
    lib = ctypes.CDLL(os.path.join(out_dir, "mma_rate.so"))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 16 * 32, device="cuda")
    print("mma.sync m16n8k8 TF32 (8 independent accumulators per warp):")
    for warps in (1, 4, 8, 16):
        iters = 2000

        def call():
            assert lib.run(buf.data_ptr(), sms, warps * 32, iters,
                           stream) == 0
        ms = C.device_ms(call, n=5)
        n = sms * warps * iters * 8
        print("  %2d warps per SM: %.1f TFLOP/s" % (warps,
                                                   n * 2048 / ms / 1e9),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
