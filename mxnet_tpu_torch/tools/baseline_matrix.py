"""Measured evidence for the SSD, DCGAN and LSTM-LM configurations (the
port's counterpart of ``tools/baseline_matrix.py``): SSD-300 training
throughput and overfit mAP, DCGAN stability and throughput (the classic
two-Module loop, and the whole adversarial iteration as one CUDA graph),
LSTM-LM perplexity to its floor and the bucketed fused path's scaling.

    python -m mxnet_tpu_torch.tools.baseline_matrix \\
        ssd|ssd_overfit|dcgan|dcgan_fused|lstm|lstm_scaling|all \\
        [--quick] [--device cpu]

One JSON line per measurement (the JAX tool's metric names and fields,
plus ``device`` and, on a card, its ``name`` and ``power_limit``). The
widths are the JAX tool's: SSD-300 at 300x300 (4 classes), DCGAN ngf =
ndf = 32, nc 1, 64x64, z 100, and a 2x128 LSTM over a 5000-word vocabulary
of the standard library's docstrings. Reference counterparts:
example/ssd/train.py + evaluate.py, example/gan/dcgan.py,
example/rnn/lstm_bucketing.py.

``dcgan_fused`` is the JAX tool's one-program iteration on the port: one
step over ``executor.build_graph_fn`` and ``parallel/fused_opt.make_rule``
(Adam, beta1 0.5) — G forward, D's gradients on the real then the fake
batch (summed), D's update, G's gradients through the updated D, G's
update, with the auxiliary states chained real -> fake -> G step. It runs
eagerly once, then as one CUDA graph per iteration: ``z`` is drawn inside
the graph from the port's ``mx.random`` generator, registered with the
graph so every replay draws anew, and the real batch is picked from a
device-resident pool by an index written before each replay. The losses
are read every ``loss_every`` steps.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from . import _device

_FIELDS = {}


def _dev():
    return torch.device(_FIELDS.get("device", "cuda:0"))


def _ctx():
    import mxnet_tpu_torch as mx

    dev = _dev()
    return mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0)


def _sync():
    dev = _dev()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def emit(metric, value, unit, extra=None):
    rec = {"metric": metric, "value": float(value), "unit": unit}
    if extra:
        rec.update(extra)
    rec.update(_FIELDS)
    print(json.dumps(rec), flush=True)
    return rec


def set_device(device):
    """Resolve ``--device`` (raising without a card) and stamp it, with the
    card's name and power limit, on every record."""
    dev = _device.resolve(device)
    _FIELDS.clear()
    _FIELDS.update(_device.fields(dev))
    return dev


# ---------------------------------------------------------------- SSD ----
def synth_det_data(n, num_classes, seed=0, size=300):
    """Images with 1-3 axis-aligned coloured rectangles; labels are the
    boxes. Classes are colour-coded so the task is learnable."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 3, size, size), np.float32)
    Y = -np.ones((n, 8, 5), np.float32)
    for i in range(n):
        X[i] += rng.rand(3, 1, 1) * 0.1  # background tint
        for j in range(rng.randint(1, 4)):
            cls = rng.randint(0, num_classes)
            x0, y0 = rng.rand(2) * 0.55 + 0.05
            w, h = 0.15 + rng.rand(2) * 0.25
            x1, y1 = min(x0 + w, 0.98), min(y0 + h, 0.98)
            px0, py0, px1, py1 = (np.array([x0, y0, x1, y1]) * size).astype(int)
            # class encoded in channel intensity pattern
            X[i, cls % 3, py0:py1, px0:px1] = 0.5 + 0.5 * ((cls // 3) % 2)
            X[i, (cls + 1) % 3, py0:py1, px0:px1] = 0.25
            Y[i, j] = [cls, x0, y0, x1, y1]
    return X, Y


def _ssd_map(mx, arg, aux, num_classes, batch, X, Y, ctx):
    """Training-set mAP through MultiBoxDetection, scored by
    ``mx.metric.MApMetric`` (11-point VOC07)."""
    from ..models import ssd

    det = mx.mod.Module(ssd.get_symbol(num_classes=num_classes),
                        label_names=None, context=ctx)
    det.bind(data_shapes=[("data", (batch, 3, 300, 300))], for_training=False)
    det.set_params(arg, aux, allow_missing=True)
    metric = mx.metric.MApMetric(ovp_thresh=0.5, voc07=True, score_thresh=0.1)
    for i in range(0, len(X), batch):
        db = mx.io.DataBatch(data=[mx.nd.array(X[i:i + batch], ctx=ctx)],
                             label=[mx.nd.array(Y[i:i + batch], ctx=ctx)])
        det.forward(db, is_train=False)
        metric.update(db.label, det.get_outputs())
    return metric.get()[1]


def run_ssd(quick=False):
    """Host-fed SSD-300 through ``Module.fit`` (steady epochs' images/s),
    then the training set's mAP. Returns (rate, mAP, the per-batch
    MultiBox metric values)."""
    import mxnet_tpu_torch as mx
    from ..models import ssd
    from .train_ssd import MultiBoxMetric

    num_classes = 4
    batch = 8 if quick else 32
    n = 4 * batch
    epochs = 2 if quick else 30
    ctx = _ctx()
    X, Y = synth_det_data(n, num_classes)
    it = mx.io.NDArrayIter({"data": X}, {"label": Y}, batch, label_name="label")
    net = ssd.get_symbol_train(num_classes=num_classes)
    mod = mx.mod.Module(net, label_names=["label"], context=ctx)
    times, trajectory = [], []

    def batch_cb(param):
        times.append(time.perf_counter())
        trajectory.append(tuple(param.eval_metric.get()[1]))

    t0 = time.perf_counter()
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.002, "momentum": 0.9,
                              "wd": 5e-4},
            initializer=mx.init.Xavier(), eval_metric=MultiBoxMetric(),
            batch_end_callback=[batch_cb], force_init=True)
    per_epoch = len(times) // epochs
    steady = times[per_epoch:]  # the first epoch builds the step
    if len(steady) >= 2:
        rate = batch * (len(steady) - 1) / (steady[-1] - steady[0])
    else:
        rate = batch * len(times) / (time.perf_counter() - t0)
    emit("ssd300_train_imgs_per_sec", rate, "img/s", {"batch": batch})
    arg, aux = mod.get_params()
    mean_ap = _ssd_map(mx, arg, aux, num_classes, batch, X, Y, ctx)
    emit("ssd300_overfit_mAP@0.5", mean_ap, "mAP",
         {"classes": num_classes, "epochs": epochs,
          "metric_first_last_[ce,smoothl1]": [trajectory[0], trajectory[-1]]})
    return rate, mean_ap, trajectory


def run_ssd_overfit(steps=3000, batch=16, n=32, lr=5e-4, log_every=200,
                    seed=0):
    """Device-resident SSD overfit: the batches are staged on the device
    once and reused, the fused path runs one CUDA graph per step with no
    per-step host traffic, and the losses are read every ``log_every``
    steps. Emits the compute-bound training rate and the set's mAP."""
    import mxnet_tpu_torch as mx
    from ..models import ssd
    from .train_ssd import MultiBoxMetric

    num_classes = 4
    ctx = _ctx()
    X, Y = synth_det_data(n, num_classes, seed=seed)
    net = ssd.get_symbol_train(num_classes=num_classes)
    mod = mx.mod.Module(net, label_names=["label"], context=ctx)
    mod.bind(data_shapes=[("data", (batch, 3, 300, 300))],
             label_shapes=[("label", (batch, Y.shape[1], 5))])
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(kvstore="device", optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    batches = [mx.io.DataBatch(data=[mx.nd.array(X[i:i + batch], ctx=ctx)],
                               label=[mx.nd.array(Y[i:i + batch], ctx=ctx)])
               for i in range(0, n, batch)]
    metric = MultiBoxMetric()
    t_start = time.perf_counter()
    steps_timed0 = 0
    trajectory = []
    for step in range(steps):
        b = batches[step % len(batches)]
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        if step == len(batches):  # the step is built and captured by now
            _sync()
            t_start = time.perf_counter()
            steps_timed0 = step
        if (step + 1) % log_every == 0 or step == steps - 1:
            metric.reset()
            mod.update_metric(metric, b.label)  # the only host read
            _, vals = metric.get()
            trajectory.append((step + 1, vals[0], vals[1]))
    _sync()
    dt = time.perf_counter() - t_start
    rate = batch * (steps - steps_timed0) / dt
    fused = getattr(mod, "_fused", None)
    emit("ssd300_train_imgs_per_sec_resident", rate, "img/s",
         {"batch": batch, "loss_trajectory_[step,ce,smoothl1]": trajectory[-6:],
          "fused": fused is not None,
          "captures": getattr(getattr(fused, "trainer", None), "captures", 0),
          "note": "device-resident batches; the compute-bound rate"})
    arg, aux = mod.get_params()
    mean_ap = _ssd_map(mx, arg, aux, num_classes, batch, X, Y, ctx)
    emit("ssd300_overfit_mAP@0.5_resident", mean_ap, "mAP",
         {"classes": num_classes, "steps": steps, "images": n, "lr": lr})
    return rate, mean_ap, trajectory


# -------------------------------------------------------------- DCGAN ----
DCGAN = dict(ngf=32, ndf=32, nc=1, z_dim=100, lr=2e-4, beta1=0.5, pool=8)


def _dcgan_modules(mx, batch, ctx, need_grads=True):
    """The generator and discriminator modules, bound and initialized
    (Normal(0.02)), with their Adam optimizers."""
    from ..models import make_discriminator, make_generator

    gen = make_generator(ngf=DCGAN["ngf"], nc=DCGAN["nc"])
    dis = make_discriminator(ndf=DCGAN["ndf"])
    gen_mod = mx.mod.Module(gen, data_names=("rand",), label_names=None,
                            context=ctx)
    gen_mod.bind(data_shapes=[("rand", (batch, DCGAN["z_dim"], 1, 1))],
                 inputs_need_grad=need_grads)
    gen_mod.init_params(initializer=mx.init.Normal(0.02))
    dis_mod = mx.mod.Module(dis, data_names=("data",), label_names=("label",),
                            context=ctx)
    dis_mod.bind(data_shapes=[("data", (batch, DCGAN["nc"], 64, 64))],
                 label_shapes=[("label", (batch,))], inputs_need_grad=need_grads)
    dis_mod.init_params(initializer=mx.init.Normal(0.02))
    if need_grads:
        for mod in (gen_mod, dis_mod):
            mod.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": DCGAN["lr"],
                                                 "beta1": DCGAN["beta1"]})
    return gen_mod, dis_mod


def real_pool(rng, batch):
    """``DCGAN['pool']`` batches of "real" data: discs (an offline MNIST
    stand-in), in [-1, 1], as numpy (the JAX tool's draws)."""
    yy, xx = np.mgrid[:64, :64]
    pool = []
    for _ in range(DCGAN["pool"]):
        x = np.zeros((batch, 1, 64, 64), np.float32)
        for i in range(batch):
            cx, cy = rng.randint(16, 48, 2)
            r = rng.randint(6, 16)
            x[i, 0] = (((xx - cx) ** 2 + (yy - cy) ** 2) < r * r) * 1.0
        pool.append(x * 2 - 1)
    return pool


def _ce_dev(mx, prob, positive):
    """The discriminator head's (sigmoid) binary cross-entropy against all
    1 (``positive``) or all 0 labels, on the device."""
    p = prob.reshape((-1,))
    if not positive:
        p = 1.0 - p
    return mx.nd.mean(-mx.nd.log(mx.nd.maximum(p, 1e-8)))


def classic_gan_iteration(mx, gen_mod, dis_mod, z, real, ones, zeros,
                          want_loss=True):
    """One iteration of the JAX tool's two-Module loop: G forward; D on
    real then fake, the gradients summed by hand; D update; D on the fake
    batch toward "real"; G backward from D's input gradient; G update.
    Returns (D loss, G loss) as device NDArrays, or (None, None)."""
    gen_mod.forward(mx.io.DataBatch(data=[z], label=[]), is_train=True)
    fake = gen_mod.get_outputs()[0]
    dis_mod.forward(mx.io.DataBatch(data=[real], label=[ones]), is_train=True)
    d_real = _ce_dev(mx, dis_mod.get_outputs()[0], True) if want_loss else None
    dis_mod.backward()
    grads_real = [[g.copy() if g is not None else None for g in gl]
                  for gl in dis_mod._exec_group.grad_arrays]
    dis_mod.forward(mx.io.DataBatch(data=[fake], label=[zeros]), is_train=True)
    d_fake = _ce_dev(mx, dis_mod.get_outputs()[0], False) if want_loss else None
    dis_mod.backward()
    for gl, rl in zip(dis_mod._exec_group.grad_arrays, grads_real):
        for g, r in zip(gl, rl):
            if g is not None:
                g += r
    dis_mod.update()
    dis_mod.forward(mx.io.DataBatch(data=[fake], label=[ones]), is_train=True)
    g_loss = _ce_dev(mx, dis_mod.get_outputs()[0], True) if want_loss else None
    dis_mod.backward()
    gen_mod.backward([dis_mod.get_input_grads()[0]])
    gen_mod.update()
    if not want_loss:
        return None, None
    return 0.5 * (d_real + d_fake), g_loss


def run_dcgan(quick=False, steps=None):
    """The classic loop: two Modules, one host-orchestrated iteration per
    step over a device-resident pool of real batches. Returns (images/s,
    D losses, G losses), the losses read every 10th step and the last."""
    import mxnet_tpu_torch as mx

    batch = 16 if quick else 64
    steps = steps or (10 if quick else 200)
    ctx = _ctx()
    gen_mod, dis_mod = _dcgan_modules(mx, batch, ctx)
    rng = np.random.RandomState(0)
    pool = [mx.nd.array(x, ctx=ctx) for x in real_pool(rng, batch)]
    loss_every = 10
    d_losses, g_losses = [], []
    t_start = None
    ones = mx.nd.ones((batch,), ctx=ctx)
    zeros = mx.nd.zeros((batch,), ctx=ctx)
    for step in range(steps):
        if step == 2:
            _sync()
            t_start = time.perf_counter()  # after the first steps' set-up
        z = mx.nd.array(rng.randn(batch, DCGAN["z_dim"], 1, 1), ctx=ctx)
        real = pool[rng.randint(len(pool))]
        want = step % loss_every == 0 or step == steps - 1
        d, g = classic_gan_iteration(mx, gen_mod, dis_mod, z, real, ones,
                                     zeros, want)
        if want:
            d_losses.append(float(d.asnumpy()))
            g_losses.append(float(g.asnumpy()))
    _sync()
    dt = time.perf_counter() - t_start
    rate = batch * (steps - 2) / dt
    emit("dcgan_train_imgs_per_sec", rate, "img/s", {"batch": batch})
    third = max(len(d_losses) // 3, 1)
    emit("dcgan_d_loss_final_third", float(np.mean(d_losses[-third:])), "ce",
         {"first_third": float(np.mean(d_losses[:third]))})
    emit("dcgan_g_loss_final_third", float(np.mean(g_losses[-third:])), "ce",
         {"first_third": float(np.mean(g_losses[:third]))})
    if not (np.isfinite(d_losses).all() and np.isfinite(g_losses).all()):
        raise FloatingPointError("dcgan: a loss is not finite: D %s G %s"
                                 % (d_losses, g_losses))
    return rate, d_losses, g_losses


class FusedGAN:
    """DCGAN's whole iteration as one step over device tensors (see the
    module): the parameters, Adam slots and BatchNorm statistics of both
    nets are static tensors written in place, so the step can be captured
    as one CUDA graph and replayed.

    ``params``: ``(gen_args, gen_auxs, dis_args, dis_auxs)``, dicts of
    numpy arrays or tensors (the classic modules' initial values).
    ``pool``: the real batches. :meth:`step` runs one iteration (eagerly
    on the CPU and at the first call on a card, then captured, then
    replayed); :meth:`eager_step` always runs it eagerly, drawing ``z``
    unless one is given."""

    SITE = "mxnet_tpu_torch/tools/baseline_matrix.py:FusedGAN"
    PROGRAM = "bench.dcgan_fused"

    def __init__(self, params, pool, batch, device):
        import mxnet_tpu_torch as mx
        from ..executor import build_graph_fn
        from ..models import make_discriminator, make_generator
        from ..parallel import fused_opt

        self.device = torch.device(device)
        self.batch = batch
        gen = make_generator(ngf=DCGAN["ngf"], nc=DCGAN["nc"])
        dis = make_discriminator(ndf=DCGAN["ndf"])
        self.g_fn = build_graph_fn(gen)
        self.d_fn = build_graph_fn(dis)
        self.g_args = gen.list_arguments()
        self.g_auxn = gen.list_auxiliary_states()
        self.d_args = dis.list_arguments()
        self.d_auxn = dis.list_auxiliary_states()
        self.g_pnames = [n for n in self.g_args if n != "rand"]
        self.d_pnames = [n for n in self.d_args if n not in ("data", "label")]
        gp, ga, dp, da = params

        def dev(v):
            return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   dtype=torch.float32).to(self.device).clone()

        self.gp = {n: dev(gp[n]) for n in self.g_pnames}
        self.ga = {n: dev(ga[n]) for n in self.g_auxn}
        self.dp = {n: dev(dp[n]) for n in self.d_pnames}
        self.da = {n: dev(da[n]) for n in self.d_auxn}
        # the classic Module's Adam: rescale_grad 1/batch, as Module sets it
        opt = mx.optimizer.create("adam", learning_rate=DCGAN["lr"],
                                  beta1=DCGAN["beta1"],
                                  rescale_grad=1.0 / batch)
        self.rule = fused_opt.make_rule(opt)
        self.gs = {n: self.rule.init_state(self.gp[n].shape, self.device)
                   for n in self.g_pnames}
        self.ds = {n: self.rule.init_state(self.dp[n].shape, self.device)
                   for n in self.d_pnames}
        self.pool = torch.stack([dev(x) for x in pool])
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sel = torch.zeros((), dtype=torch.int64, device=self.device)
        self.lr = torch.zeros((), **f32)
        self.z = torch.zeros((batch, DCGAN["z_dim"], 1, 1), **f32)
        self.ones = torch.ones((batch,), **f32)
        self.zeros = torch.zeros((batch,), **f32)
        self.d_loss = torch.zeros((), **f32)
        self.g_loss = torch.zeros((), **f32)
        from .. import random as _random

        self.gen = _random.generator(self.device)   # draws z; a graph registers it
        self.t = 0
        self.graph = None
        self.captures = 0
        self.replays = 0

    # ---- the step ---------------------------------------------------------
    def _g_forward(self, leaves, z):
        args = [z if n == "rand" else leaves[n] for n in self.g_args]
        outs, new_aux = self.g_fn(args, [self.ga[n] for n in self.g_auxn], True)
        return outs[0], new_aux

    def _d_forward(self, params, x, label):
        args = [x if n == "data" else label if n == "label" else params[n]
                for n in self.d_args]
        outs, new_aux = self.d_fn(args, [self.da[n] for n in self.d_auxn], True)
        with torch.no_grad():  # the statistics chain: real -> fake -> G step
            for n, v in zip(self.d_auxn, new_aux):
                self.da[n].copy_(v)
        return outs[0]

    @staticmethod
    def _ce(p):
        """Mean -log of the probabilities of the wanted label."""
        return torch.mean(-torch.log(torch.clamp_min(p.reshape(-1), 1e-8)))

    def _run(self, z=None):
        """The iteration over the static tensors; ``z`` given is copied
        into the static buffer instead of a draw."""
        with torch.no_grad():
            if z is None:
                self.z.copy_(torch.randn(self.z.shape, device=self.device,
                                         generator=self.gen))
            else:
                self.z.copy_(z)
        real = torch.index_select(self.pool, 0, self.sel.reshape(1))[0]
        with torch.enable_grad():
            gl = {n: self.gp[n].detach().requires_grad_(True) for n in self.g_pnames}
            fake, g_aux = self._g_forward(gl, self.z)
            with torch.no_grad():
                for n, v in zip(self.g_auxn, g_aux):
                    self.ga[n].copy_(v)
            dl = {n: self.dp[n].detach().requires_grad_(True) for n in self.d_pnames}
            p_real = self._d_forward(dl, real, self.ones)
            p_fake = self._d_forward(dl, fake.detach(), self.zeros)
            # the heads ignore the gradient they are given: D's gradient is
            # the sum of the two heads' (p - label), as the classic loop sums
            d_grads = torch.autograd.grad(
                [p_real, p_fake], [dl[n] for n in self.d_pnames],
                [torch.ones_like(p_real), torch.ones_like(p_fake)],
                allow_unused=True)
        with torch.no_grad():
            self.d_loss.copy_(0.5 * (self._ce(p_real) + self._ce(1.0 - p_fake)))
            for n, g in zip(self.d_pnames, d_grads):
                self.rule.apply_(self.dp[n], torch.zeros_like(self.dp[n])
                                 if g is None else g, self.ds[n], self.lr, 0.0)
        with torch.enable_grad():
            p_gen = self._d_forward(self.dp, fake, self.ones)   # the updated D
            g_grads = torch.autograd.grad(
                [p_gen], [gl[n] for n in self.g_pnames], [torch.ones_like(p_gen)],
                allow_unused=True)
        with torch.no_grad():
            self.g_loss.copy_(self._ce(p_gen))
            for n, g in zip(self.g_pnames, g_grads):
                self.rule.apply_(self.gp[n], torch.zeros_like(self.gp[n])
                                 if g is None else g, self.gs[n], self.lr, 0.0)

    def _prepare(self, sel):
        """Write the step's inputs: the pool index and Adam's step size at
        this step's count ``t`` (fused_opt's host arithmetic)."""
        self.t += 1
        self.sel.fill_(int(sel))
        self.lr.fill_(self.rule.step_lr(DCGAN["lr"], self.t))

    def eager_step(self, sel, z=None):
        self._prepare(sel)
        self._run(z)

    def step(self, sel):
        """One iteration: eager on the CPU and at a card's first call, then
        captured (at the second) and replayed."""
        if self.device.type != "cuda" or self.t == 0:
            return self.eager_step(sel)
        if self.graph is None:
            self.capture()
        self._prepare(sel)
        self.graph.replay()
        self.replays += 1

    def capture(self):
        """Record the iteration into a CUDA graph (nothing runs), with the
        device's generator registered so replays draw fresh ``z``, the
        garbage collector off across the capture and the capture charged
        to ``compileobs``."""
        from .. import compileobs

        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError("dcgan_fused draws z inside the graph and torch "
                               "%s cannot register a generator with a CUDA "
                               "graph" % torch.__version__)
        graph.register_generator_state(self.gen)
        torch.cuda.synchronize(self.device)
        gc.collect()
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with compileobs.record_compile(self.PROGRAM, site=self.SITE), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._run()
        finally:
            if gc_was:
                gc.enable()
        self.graph = graph
        self.captures += 1

    # ---- state, for checks ------------------------------------------------
    def state(self):
        """Copies of every tensor the step writes, by name."""
        out = {}
        for tag, d in (("gp", self.gp), ("ga", self.ga), ("dp", self.dp),
                       ("da", self.da)):
            for n, v in d.items():
                out["%s:%s" % (tag, n)] = v.clone()
        for tag, d in (("gs", self.gs), ("ds", self.ds)):
            for n, slots in d.items():
                for k, v in enumerate(slots):
                    out["%s:%s:%d" % (tag, n, k)] = v.clone()
        out["z"] = self.z.clone()
        out["d_loss"] = self.d_loss.clone()
        out["g_loss"] = self.g_loss.clone()
        return out

    def load_state(self, state, t):
        """Write a :meth:`state` back in place (the graph reads these
        addresses) and set the update count."""
        with torch.no_grad():
            for tag, d in (("gp", self.gp), ("ga", self.ga), ("dp", self.dp),
                           ("da", self.da)):
                for n, v in d.items():
                    v.copy_(state["%s:%s" % (tag, n)])
            for tag, d in (("gs", self.gs), ("ds", self.ds)):
                for n, slots in d.items():
                    for k, v in enumerate(slots):
                        v.copy_(state["%s:%s:%d" % (tag, n, k)])
        self.t = t


def dcgan_initial(mx, batch, ctx):
    """The classic run's initial parameters (its modules, initialized the
    same way): ``(gen_args, gen_auxs, dis_args, dis_auxs)`` as numpy."""
    gen_mod, dis_mod = _dcgan_modules(mx, batch, ctx, need_grads=False)
    ga, gx = gen_mod.get_params()
    da, dx = dis_mod.get_params()
    return tuple({k: v.asnumpy() for k, v in d.items()} for d in (ga, gx, da, dx))


def run_dcgan_fused(quick=False, steps=None, loss_every=10):
    """The fused iteration (see :class:`FusedGAN`): images/s as the median
    of 5 synchronized windows after the first 2 steps, and the losses read
    every ``loss_every`` steps. Returns (images/s, D losses, G losses,
    the FusedGAN)."""
    import mxnet_tpu_torch as mx

    batch = 16 if quick else 64
    if steps is None:
        steps = 10 if quick else 200
    if steps < 4:
        raise ValueError("steps must be >= 4 (timing starts after 2 "
                         "set-up steps)")
    ctx = _ctx()
    rng = np.random.RandomState(0)
    params = dcgan_initial(mx, batch, ctx)
    gan = FusedGAN(params, real_pool(rng, batch), batch, _dev())
    d_losses, g_losses = [], []
    n_windows = min(5, max(steps - 2, 1))
    bounds = [2 + ((steps - 2) * k) // n_windows for k in range(n_windows + 1)]
    marks = []
    for i in range(steps):
        if i in bounds:
            _sync()
            marks.append(time.perf_counter())
        gan.step(rng.randint(DCGAN["pool"]))
        if i % loss_every == 0 or i == steps - 1:
            d_losses.append(float(gan.d_loss))
            g_losses.append(float(gan.g_loss))
    _sync()
    marks.append(time.perf_counter())
    window_rates = [batch * (b1 - b0) / (t1 - t0)
                    for b0, b1, t0, t1 in zip(bounds, bounds[1:], marks, marks[1:])
                    if t1 > t0 and b1 > b0]
    rate = float(np.median(window_rates))
    emit("dcgan_fused_train_imgs_per_sec", rate, "img/s",
         {"batch": batch, "loss_every": loss_every,
          "band_lo": min(window_rates), "band_hi": max(window_rates),
          "windows": len(window_rates), "captures": gan.captures,
          "replays": gan.replays})
    third = max(len(d_losses) // 3, 1)
    emit("dcgan_fused_d_loss_final_third", float(np.mean(d_losses[-third:])),
         "ce", {"first_third": float(np.mean(d_losses[:third]))})
    emit("dcgan_fused_g_loss_final_third", float(np.mean(g_losses[-third:])),
         "ce", {"first_third": float(np.mean(g_losses[:third]))})
    if not (np.isfinite(d_losses).all() and np.isfinite(g_losses).all()):
        raise FloatingPointError("dcgan_fused: a loss is not finite: D %s G %s"
                                 % (d_losses, g_losses))
    return rate, d_losses, g_losses, gan


# ------------------------------------------------------------ LSTM-LM ----
def stdlib_corpus(vocab_size=10000, max_sentences=None):
    """~1M words of real English: the Python standard library's docstrings
    (available offline everywhere; ``examples/lstm_bucketing.py``'s
    corpus). Lines become sentences; the top ``vocab_size`` words keep
    their identity, the rest map to <unk>."""
    import importlib
    import inspect
    import re
    import warnings

    warnings.filterwarnings("ignore")
    texts = []
    for name in sorted(sys.stdlib_module_names):
        if name.startswith("_") or name in (
                "antigravity", "this", "idlelib", "tkinter", "turtle",
                "turtledemo"):
            continue
        try:
            mod = importlib.import_module(name)
        except Exception:  # fwlint: disable=swallowed-exception — an optional stdlib module that does not import adds no text
            continue
        if mod.__doc__:
            texts.append(mod.__doc__)
        for obj_name, obj in list(vars(mod).items()):
            if obj_name.startswith("_"):
                continue
            try:
                doc = inspect.getdoc(obj)
            except Exception:  # fwlint: disable=swallowed-exception — an attribute whose docstring cannot be read adds no text
                continue
            if doc:
                texts.append(doc)
    word_re = re.compile(r"[a-z']+")
    lines = []
    for t in texts:
        for line in t.lower().splitlines():
            words = word_re.findall(line)
            if len(words) >= 4:
                lines.append(words)
    counts = {}
    for line in lines:
        for w in line:
            counts[w] = counts.get(w, 0) + 1
    keep = sorted(counts, key=counts.get, reverse=True)[: vocab_size - 2]
    vocab = {"<pad>": 0, "<unk>": 1}
    for w in keep:
        vocab[w] = len(vocab)
    sentences = [[vocab.get(w, 1) for w in line] for line in lines]
    if max_sentences:
        sentences = sentences[:max_sentences]
    return sentences, vocab


def run_lstm(quick=False, batch=32, buckets=(8, 16, 24, 32), epochs=None,
             max_sentences=None):
    """A 2x128 LSTM LM through ``BucketingModule.fit`` (the fused path:
    one CUDA graph per bucket on a card), its sentences padded with 0, the
    label ``Perplexity(ignore_label=0)`` leaves out. Returns (perplexity
    per epoch, steady epochs' padded tokens/s)."""
    import mxnet_tpu_torch as mx

    if max_sentences is None:
        max_sentences = 1000 if quick else 4000
    sent, vocab = stdlib_corpus(vocab_size=5000, max_sentences=max_sentences)
    # padded with 0, the label Perplexity ignores, as the reference's
    # example pads (the JAX tool pads with -1, which its metric counts)
    it = mx.rnn.BucketSentenceIter(sent, batch, buckets=list(buckets),
                                   invalid_label=0)
    num_hidden, num_embed = 128, 128
    cell = mx.rnn.SequentialRNNCell()
    for i in range(2):
        cell.add(mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=len(vocab),
                                 output_dim=num_embed, name="embed")
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=len(vocab), name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=it.default_bucket_key,
                                 context=_ctx())
    if epochs is None:
        epochs = 2 if quick else 10
    records = []  # (epoch, ppl, t)

    def cb(param):
        records.append((param.epoch, param.eval_metric.get()[1],
                        time.perf_counter()))

    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 1e-3},
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            batch_end_callback=[cb], force_init=True)
    ppl_per_epoch = []
    for e in range(epochs):
        eps = [r for r in records if r[0] == e]
        if eps:
            ppl_per_epoch.append(float(eps[-1][1]))
    # steady padded tokens/s from epochs > 0 (epoch 0 captures each
    # bucket); the padded tokens of an epoch from one host pass
    it.reset()
    epoch_tokens = sum(int(b.data[0].shape[0]) * int(b.data[0].shape[1])
                       for b in it)
    n_batches = len([r for r in records if r[0] == 0])
    avg_tokens = epoch_tokens / max(n_batches, 1)
    tok_rates = []
    for e in range(1, epochs):
        ts = [r[2] for r in records if r[0] == e]
        if len(ts) >= 2:
            tok_rates.append(avg_tokens * (len(ts) - 1) / (ts[-1] - ts[0]))
    emit("lstm_lm_perplexity_floor", ppl_per_epoch[-1], "ppl",
         {"epoch1": ppl_per_epoch[0], "trajectory": ppl_per_epoch})
    if tok_rates:
        emit("lstm_lm_tokens_per_sec", float(np.median(tok_rates)), "tok/s",
             {"batch": batch, "buckets": list(buckets)})
    return ppl_per_epoch, tok_rates


def run_lstm_scaling(quick=False, repeats=5):
    """Tokens/s against batch size and bucket count, each row the median
    of ``repeats`` runs with its min/max."""
    rows = []
    combos = [(32, (16, 32)), (128, (16, 32)), (512, (16, 32)),
              (128, (8, 16, 24, 32))]
    if quick:
        combos = combos[:2]
        repeats = min(repeats, 2)
    for batch, buckets in combos:
        per_run = []
        for _ in range(repeats):
            _, rates = run_lstm(quick=True, batch=batch, buckets=buckets,
                                epochs=2, max_sentences=max(1000, batch * 12))
            per_run.append(float(np.median(rates)) if rates else float("nan"))
        med = float(np.median(per_run))
        rows.append((batch, len(buckets), med))
        emit("lstm_scaling_tokens_per_sec", med, "tok/s",
             {"batch": batch, "n_buckets": len(buckets), "median_of": repeats,
              "min": float(np.min(per_run)), "max": float(np.max(per_run))})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", choices=["ssd", "ssd_overfit", "dcgan",
                                       "dcgan_fused", "lstm", "lstm_scaling",
                                       "all"])
    ap.add_argument("--quick", action="store_true", help="tiny sizes")
    ap.add_argument("--steps", type=int, default=3000,
                    help="ssd_overfit optimization steps")
    ap.add_argument("--lr", type=float, default=5e-4,
                    help="ssd_overfit learning rate")
    _device.add_argument(ap)
    a = ap.parse_args(argv)
    set_device(a.device)
    if a.config in ("ssd", "all"):
        run_ssd(a.quick)
    if a.config == "ssd_overfit":
        if a.quick:
            run_ssd_overfit(steps=30, batch=4, n=8, log_every=10)
        else:
            run_ssd_overfit(steps=a.steps, lr=a.lr)
    if a.config in ("dcgan", "all"):
        run_dcgan(a.quick)
    if a.config in ("dcgan_fused", "all"):
        run_dcgan_fused(a.quick)
    if a.config in ("lstm", "all"):
        run_lstm(a.quick)
    if a.config in ("lstm_scaling", "all"):
        run_lstm_scaling(a.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
