"""Where the C predict call's time goes, on one NVIDIA GPU.

    python3 profile_capi_torch.py

Builds the port's C library and ``predict_client.c`` (as ``chip_smoke.py``
phase 26 does), writes the zoo Transformer-LM at ``chip_smoke.TRAIN``'s
width with seeded Xavier weights as a checkpoint, and times one predict
call (set input, forward, read the 256 x 32000 probabilities) at batch 2
x 128 five ways: the Python ``Predictor``; the C API through ``ctypes`` in
this process; ``predict_client`` in a process of its own; the same with
glibc's allocator told to keep freed memory (``MALLOC_MMAP_THRESHOLD_``,
``MALLOC_TRIM_THRESHOLD_``), so each call's 32 MB host buffers are not
fresh pages; and the bare copy of the output to the host. Prints the
card's name and power limit and one JSON line of medians (ms).
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

REPS = 20
# glibc keeps allocations below this on its heap, and the heap's free top
# below the trim threshold: a freed 32 MB buffer is reused, not unmapped
KEEP_FREED = {"MALLOC_MMAP_THRESHOLD_": str(32 << 20),
              "MALLOC_TRIM_THRESHOLD_": str(1 << 30)}


def main():
    if not torch.cuda.is_available():
        print("profile_capi_torch: no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _capi
    from mxnet_tpu_torch.ops import _build as build
    from mxnet_tpu_torch.predict import Predictor

    card = cs.card_line()
    build.build([build.FLASH_FWD])
    work = tempfile.mkdtemp(prefix="capi-profile-")
    lib, paths = cs.capi_build(work)
    d = os.path.join(work, "capi")
    T = cs.TRAIN["seq_len"]
    net = mx.models.transformer_lm(**cs.TRAIN)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (2, T))],
             label_shapes=[("softmax_label", (2, T))])
    mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(0)))
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    del mod
    sym_json, blob = cs._save_checkpoint(mx, os.path.join(d, "lm"), net,
                                         params)
    X, _ = cs.lm_stream(2, seed=26)
    X.tofile(os.path.join(d, "tokens.f32"))
    shapes = {"data": (2, T), "softmax_label": (2, T)}
    res = {}
    py = Predictor(sym_json, blob, input_shapes=shapes)
    res["python_predictor"] = cs.median_ms(
        lambda: py.forward(data=X).get_output(0), REPS)
    out = py._exe.outputs[0].data
    res["output_to_host"] = cs.median_ms(lambda: out.cpu(), REPS)
    cp = cs.CPredictor(lib, sym_json, blob, shapes)
    res["c_api_in_process"] = cs.median_ms(lambda: cp.predict(X), REPS)
    cp.free()
    cmd = [paths["predict_client"], str(REPS),
           os.path.join(d, "lm-symbol.json"), os.path.join(d, "lm-0000.params"),
           os.path.join(d, "tokens.f32"), os.path.join(d, "out.f32"),
           "2", "2", str(T), "+softmax_label", "2", "2", str(T)]
    for name, extra in (("c_client_process", {}),
                        ("c_client_process_keep_freed", KEEP_FREED)):
        env = dict(_capi.client_env(), **extra)
        t0 = time.perf_counter()
        r = cs.subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=cs.CAPI_TIMEOUT)
        cs.check(r.returncode == 0, "predict_client: %s" % r.stderr[-2000:])
        res[name] = float(r.stdout.split("MEDIAN_MS")[1].split()[0])
        res[name + "_wall_s"] = time.perf_counter() - t0
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
