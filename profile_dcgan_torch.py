"""Where DCGAN's step time goes on one GPU, and how it moves with the host.

    python3 profile_dcgan_torch.py

The GAN step of ``mxnet_tpu_torch/tools/dcgan.py`` at MXNet's example
widths (ngf = ndf = 64, 3 channels, 64x64 images, z 100, batch 64) runs
on the classic Module path, so its host wall depends on the host's time
per op as much as on the card. The script trains it ``STEPS`` steps at a
time in five settings, one process: alone, twice; beside a large live
Python heap (``HEAP`` lists, which a full garbage collection walks); with
that heap frozen out of the collector (``gc.freeze``); and with
``HELD_GB`` of device memory held. For each it prints the host wall per
step (median after two, synchronized), images/s and the host time to
enqueue one small op; then one ``torch.profiler`` window of three steps
(device busy, busy share, device operations, time by kernel class, the
largest kernels), beside the card's ``nvidia-smi`` name and power limit.
It needs a card and exits 2 without one.
"""
import gc
import sys

import numpy as np
import torch

STEPS = 30
HEAP = 6_000_000
HELD_GB = 6


def main():
    if not torch.cuda.is_available():
        print("profile_dcgan_torch: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch.tools import dcgan

    cs.log(cs.card_line())
    device = torch.device("cuda", 0)

    def run(label):
        gc.collect()
        gen, dis, feed, rec = dcgan.train(cs.DCGAN_BATCH, cs.DCGAN_Z, cs.DCGAN_LR,
                                          STEPS, device, **cs.DCGAN)
        cs.log("%s: host wall per step %.5f s, %.1f images/s, %.3f us per "
               "small op" % (label, rec["step_s"], rec["images_per_sec"],
                             cs.host_us_per_op()))
        return gen, dis, feed, rec

    run("alone")
    run("alone, again")
    heap = [[i, str(i)] for i in range(HEAP)]
    run("beside %d live lists" % HEAP)
    gc.freeze()
    run("beside %d live lists, frozen" % HEAP)
    gc.unfreeze()
    del heap
    held = [torch.empty(HELD_GB * 2 ** 28, device=device)]
    run("with %d GB held on the card" % HELD_GB)
    del held
    torch.cuda.empty_cache()
    gen, dis, feed, rec = run("alone, last")

    def step():
        dcgan.gan_step(gen, dis, feed.noise(), feed.real[0], feed.ones, feed.zeros)

    cs.log_profile("DCGAN GAN step", cs.device_profile(step), rec["step_s"])
    sizes = [np.prod(a.shape) for m in (gen, dis) for a in m.get_params()[0].values()]
    cs.log("parameters: %d in %d arrays" % (sum(sizes), len(sizes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
