"""Train DCGAN through two ``Module``\\ s — the port's twin of the JAX
package's ``examples/dcgan.py`` (reference: example/gan/dcgan.py), with
its flags:

    python3 -m mxnet_tpu_torch.tools.dcgan

The generator (``ngf`` 32, one channel: the example's widths) and the
discriminator (``ndf`` 32) are the zoo's ``make_generator`` /
``make_discriminator``, each a ``Module`` bound with
``inputs_need_grad=True``, ``Normal(0.02)`` weights and Adam (lr
``--lr``, beta1 0.5). Each step is the example's five calls: G forward;
D on the fake batch (label 0), its gradients copied, D on the real batch
(label 1) and the copies added in; D update; D on the fake batch with
label 1 and G's backward from D's input gradient; G update. Real images
are seeded uniform in [-1, 1] (the example's ``rand * 2 - 1``), eight
batches made once on the device and cycled; the noise is drawn on the
device each step.

The run prints one JSON line: images/s and the host wall per step (the
median after the first two steps, each synchronized), the discriminator's
loss (the mean binary cross-entropy of its real and fake halves) and the
generator's (the cross-entropy of D(fake) against label 1) averaged over
the first and the last third of the steps, and where it ran (the card's
``nvidia-smi`` name and power limit). It runs on the card unless
``--device cpu`` is given.
"""
import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools.train_imagenet import device_record

#: real batches made once and cycled
POOL = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--z-dim", type=int, default=100)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.0002)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    return ap.parse_args(argv)


def make_modules(batch, z_dim, lr, device, ngf=32, nc=1):
    """The generator and discriminator modules, bound, initialized and
    with their optimizers: the example's setup."""
    gen = mx.mod.Module(mx.models.make_generator(ngf=ngf, nc=nc),
                        data_names=("rand",), label_names=None, context=device)
    gen.bind(data_shapes=[("rand", (batch, z_dim, 1, 1))], inputs_need_grad=True)
    dis = mx.mod.Module(mx.models.make_discriminator(ndf=ngf),
                        data_names=("data",), label_names=("label",),
                        context=device)
    dis.bind(data_shapes=[("data", (batch, nc, 64, 64))],
             label_shapes=[("label", (batch,))], inputs_need_grad=True)
    for mod in (gen, dis):
        mod.init_params(initializer=mx.init.Normal(0.02))
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": lr, "beta1": 0.5})
    return gen, dis


def _bce(prob, positive):
    """Mean binary cross-entropy of the discriminator's probabilities
    against all-1 (``positive``) or all-0 labels, a device scalar."""
    p = prob.data.reshape(-1)
    return -torch.log(torch.clamp_min(p if positive else 1 - p, 1e-8)).mean()


def gan_step(gen, dis, z, real, ones, zeros):
    """One step of the example's loop; returns (D loss, G loss) as device
    scalars."""
    gen.forward(mx.io.DataBatch([z], None), is_train=True)
    fake = gen.get_outputs()[0]
    dis.forward(mx.io.DataBatch([fake], [zeros]), is_train=True)
    d_fake = _bce(dis.get_outputs()[0], False)
    dis.backward()
    grads_fake = [[g.copy() for g in grads] for grads in dis._exec_group.grad_arrays]
    dis.forward(mx.io.DataBatch([real], [ones]), is_train=True)
    d_real = _bce(dis.get_outputs()[0], True)
    dis.backward()
    for gss, gfs in zip(dis._exec_group.grad_arrays, grads_fake):
        for gs, gf in zip(gss, gfs):
            gs += gf
    dis.update()
    dis.forward(mx.io.DataBatch([fake], [ones]), is_train=True)
    g_loss = _bce(dis.get_outputs()[0], True)
    dis.backward()
    gen.backward([dis.get_input_grads()[0]])
    gen.update()
    return 0.5 * (d_real + d_fake), g_loss


class Feed:
    """Seeded real batches (``POOL`` of them, uniform in [-1, 1]) and noise
    on ``device``, drawn from a generator of their own."""

    def __init__(self, batch, z_dim, nc, device, seed=0):
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self.real = [mx.nd.NDArray(torch.rand((batch, nc, 64, 64), generator=self._gen,
                                              device=device) * 2 - 1)
                     for _ in range(POOL)]
        self.ones = mx.nd.NDArray(torch.ones(batch, device=device))
        self.zeros = mx.nd.NDArray(torch.zeros(batch, device=device))
        self._shape = (batch, z_dim, 1, 1)
        self._device = device

    def noise(self):
        return mx.nd.NDArray(torch.randn(self._shape, generator=self._gen,
                                         device=self._device))


def train(batch, z_dim, lr, steps, device, ngf=32, nc=1, epochs=1):
    """``epochs`` x ``steps`` GAN steps; returns (generator, discriminator,
    feed, record)."""
    mx.random.seed(0)
    gen, dis = make_modules(batch, z_dim, lr, device, ngf, nc)
    feed = Feed(batch, z_dim, nc, device)
    losses, walls = [], []
    for epoch in range(epochs):
        for step in range(steps):
            t0 = time.perf_counter()
            losses.append(gan_step(gen, dis, feed.noise(), feed.real[step % POOL],
                                   feed.ones, feed.zeros))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
        gen.forward(mx.io.DataBatch([feed.noise()], None), is_train=False)
        sample = gen.get_outputs()[0].asnumpy()
        logging.info("epoch %d: sample mean %.4f std %.4f", epoch, sample.mean(),
                     sample.std())
    d, g = (torch.stack([pair[i] for pair in losses]).cpu().numpy() for i in (0, 1))
    third = max(len(d) // 3, 1)
    warm = min(2, len(walls) - 1)
    step_s = float(np.median(walls[warm:]))
    record = {
        "batch_size": batch, "z_dim": z_dim, "ngf": ngf, "ndf": ngf, "nc": nc,
        "steps": len(walls), "first_step_s": walls[0], "step_s": step_s,
        "images_per_sec": batch / step_s,
        "d_loss": {"first_third": float(d[:third].mean()),
                   "last_third": float(d[-third:].mean())},
        "g_loss": {"first_third": float(g[:third].mean()),
                   "last_third": float(g[-third:].mean())},
        "finite": bool(np.isfinite(d).all() and np.isfinite(g).all()),
        "device": device_record(device),
    }
    return gen, dis, feed, record


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = mx.context.resolve(args.device)
    _, _, _, record = train(args.batch_size, args.z_dim, args.lr,
                            args.steps_per_epoch, device, epochs=args.num_epochs)
    print(json.dumps(record), flush=True)
    return 0 if record["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
