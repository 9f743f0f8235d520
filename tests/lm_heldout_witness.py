"""The zoo Transformer-LM's loss on a batch it has not been trained on,
under three trainers on the CPU from the same parameters over the same
batches: the JAX package's ``SPMDTrainer``, the port's ``SPMDTrainer``
and the port's Python-free runtime (``MXTrainNative*`` through ctypes).

The data is ``examples/train_lm.py``'s synthetic stream (token t+1 =
token t + 1 mod V, each sequence from a random start; numpy seed 0), the
parameters the port's Xavier initializer's (torch seed 0), the rule Adam
at 1e-3. The run takes ``--steps`` steps over ``--batches`` distinct
batches of 32 sequences, cycled, then one more step on the first batch;
each step's loss is the cross-entropy of its forward, which runs before
its update, so the last line is the first batch's loss on the trained
parameters. Full width (vocab 32000, model 256, 4 heads, ffn 1024, seq
128); ``--layers`` sets the depth.

Not collected by pytest (a minute or more per trainer at 4 layers, about
3 GB): run it as::

    JAX_PLATFORMS=cpu python tests/lm_heldout_witness.py --layers 4 --batches 8
"""
import argparse
import ctypes
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

V, T, B, LR = 32000, 128, 32, float(np.float32(1e-3))


def lm(pkg, cfg):
    """The zoo Transformer-LM's symbol from ``pkg``'s model zoo."""
    import importlib

    return importlib.import_module(pkg + ".models.transformer_lm").get_symbol(
        **cfg)


def config(layers):
    return dict(vocab_size=V, num_layers=layers, model_dim=256, num_heads=4,
                ffn_dim=1024, seq_len=T)


def stream(n):
    rng = np.random.RandomState(0)
    x = (rng.randint(0, V, (n, 1)) + np.arange(T)) % V
    return x.astype(np.float32), ((x + 1) % V).astype(np.float32)


def order(batches, steps):
    return [s % batches for s in range(steps)] + [0]


def cross_entropy(prob, y):
    prob = np.asarray(prob, np.float32).reshape(-1, V)
    lab = y.reshape(-1).astype(np.int64)
    return float(-np.log(np.maximum(prob[np.arange(lab.size), lab],
                                    1e-8)).mean())


def initial(cfg):
    import torch

    import mxnet_tpu_torch as mx

    sym = lm("mxnet_tpu_torch", cfg)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(0)))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def jax_losses(cfg, init, X, Y, steps):
    import jax

    from mxnet_tpu.parallel import build_mesh
    from mxnet_tpu.parallel.spmd import SPMDTrainer

    with jax.default_matmul_precision("highest"):
        mesh = build_mesh({"dp": 1}, list(jax.devices("cpu"))[:1])
        tr = SPMDTrainer(lm("mxnet_tpu", cfg), mesh,
                         data_shapes=[("data", (B, T))],
                         label_shapes=[("softmax_label", (B, T))],
                         optimizer="adam",
                         optimizer_params={"learning_rate": LR})
        params = {n: jax.device_put(init[n]) for n in tr.param_names}
        auxs, states = {}, tr.init_opt_state()
        for k in steps:
            sl = slice(k * B, (k + 1) * B)
            params, auxs, states, outs = tr.step(
                params, auxs, states,
                {"data": X[sl], "softmax_label": Y[sl]})
            yield k, cross_entropy(outs[0], Y[sl])


def port_losses(cfg, init, X, Y, steps):
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

    sym = lm("mxnet_tpu_torch", cfg)
    pnames = [n for n in sym.list_arguments()
              if n not in ("data", "softmax_label")]
    opt = mx.optimizer.create("adam", sym=sym,
                              param_idx2name={n: n for n in pnames},
                              learning_rate=LR)
    tr = SPMDTrainer(sym, "cpu", [("data", (B, T))], opt,
                     label_shapes=[("softmax_label", (B, T))])
    params = {n: torch.tensor(init[n]) for n in tr.param_names}
    states, buf = tr.init_opt_state(), tr.input_buffers()
    for k in steps:
        sl = slice(k * B, (k + 1) * B)
        buf["data"].copy_(torch.tensor(X[sl]))
        buf["softmax_label"].copy_(torch.tensor(Y[sl]))
        outs = tr.step(params, {}, states)
        yield k, cross_entropy(outs[0].detach().numpy(), Y[sl])


def runtime_losses(cfg, init, X, Y, steps):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _predict_native

    os.environ["MXNET_DEFAULT_CONTEXT"] = "cpu"
    lib = _predict_native.load()
    sym = lm("mxnet_tpu_torch", cfg)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    c = ctypes

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError("%s: %s" % (what, lib.MXGetLastError()))

    with tempfile.TemporaryDirectory() as d:
        art = os.path.join(d, "lm_train.mxa")
        mx.export_train_artifact(sym, shapes, art, optimizer="adam",
                                 optimizer_params={"learning_rate": LR},
                                 arg_params=init, platform="cpu")
        h = c.c_void_p()
        ok(lib.MXTrainNativeCreateFromFile(art.encode(), c.byref(h)),
           "MXTrainNativeCreateFromFile")
        prob = np.empty((B * T, V), np.float32)
        for k in steps:
            sl = slice(k * B, (k + 1) * B)
            for name, v in ((b"data", X[sl]), (b"softmax_label", Y[sl])):
                v = np.ascontiguousarray(v)
                ok(lib.MXTrainNativeSetInput(
                    h, name, v.ctypes.data_as(c.POINTER(c.c_float)), v.size),
                   "MXTrainNativeSetInput")
            ok(lib.MXTrainNativeStep(h, c.c_float(LR)), "MXTrainNativeStep")
            ok(lib.MXTrainNativeGetOutput(
                h, 0, prob.ctypes.data_as(c.POINTER(c.c_float)), prob.size),
               "MXTrainNativeGetOutput")
            yield k, cross_entropy(prob, Y[sl])
        ok(lib.MXTrainNativeFree(h), "MXTrainNativeFree")


TRAINERS = {"jax": jax_losses, "port": port_losses, "runtime": runtime_losses}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batches", type=int, default=8,
                    help="distinct batches, cycled")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trainers", default="jax,port,runtime")
    a = ap.parse_args()
    cfg = config(a.layers)
    X, Y = stream(B * a.batches)
    init = initial(cfg)
    steps = order(a.batches, a.steps)
    print("layers %d, %d distinct batches, %d steps, then the first batch"
          % (a.layers, a.batches, a.steps), flush=True)
    for name in a.trainers.split(","):
        losses = []
        for s, (k, loss) in enumerate(TRAINERS[name](cfg, init, X, Y,
                                                     steps), 1):
            losses.append(loss)
            print("%-7s step %2d batch %d loss %.6f" % (name, s, k, loss),
                  flush=True)
        print("%-7s the first batch: %.6f at step 1, %.6f after %d steps"
              % (name, losses[0], losses[-1], a.steps), flush=True)


if __name__ == "__main__":
    main()
