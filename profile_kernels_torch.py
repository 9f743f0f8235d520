"""What the design choices of the flash-forward (K1) and multi-query paged
(K4) kernels are worth, for the PyTorch/CUDA port, on one GPU.

    python3 profile_kernels_torch.py

Builds each kernel as it is and in variants that undo one design choice
(a copy of the source edited by string replacement, one ``nvcc`` per
copy, all started together), binds each with ``ctypes`` and times them
side by side with ``chip_smoke.device_ms`` at the main paths' shapes,
beside the yardstick of ``chip_smoke.py`` phase 8. Each variant's largest
difference from the plain version is printed too (the one-product
variant shows why the kernel splits its operands). Last, the rate of the
``mma.sync`` TF32 instruction that K1 is built on, with 1 to 16 warps per
SM, each warp keeping 8 independent accumulators. Needs CUDA and
``nvcc``; exits non-zero without them.
"""
import ctypes
import os
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
K4_VARIANTS = {
    "as built": {},
    "256 threads": {"      <<<grid, BLOCK_THREADS, smem, stream>>>(":
                    "      <<<grid, 256, smem, stream>>>("},
    "2-slot ring": {"constexpr int STAGES = 4;": "constexpr int STAGES = 2;"},
}
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
    """Start one nvcc per variant of ``kernel``'s source."""
    src = open(kernel.source).read()
    procs = {}
    for name, reps in variants.items():
        text = src
        for a, b in reps.items():
            if a not in text:
                raise RuntimeError("%s variant %r: %r not in the source"
                                   % (kernel.name, name, a[:60]))
            text = text.replace(a, b)
        stem = os.path.join(out_dir, "%s-%d" % (kernel.name, len(procs)))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-o", stem + ".so",
               stem + ".cu"]
        procs[name] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _bind(procs, kernel):
    fns = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s %r:\n%s"
                               % (kernel.name, name, log))
        fn = getattr(ctypes.CDLL(os.path.abspath(stem + ".so")), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("profile_kernels_torch: no CUDA device", file=sys.stderr)
        return 2
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
    k1 = _bind(_variants(build.FLASH_FWD, K1_VARIANTS, out_dir, build, nvcc),
               build.FLASH_FWD)
    k4 = _bind(_variants(build.PAGED_DECODE_MULTI, K4_VARIANTS, out_dir,
                         build, nvcc), build.PAGED_DECODE_MULTI)
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
                          4, 64, kp.shape[0], 16, 8, 0.125, 0, 0, stream)
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
