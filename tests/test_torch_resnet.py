"""The port's ResNet against the JAX package's, on the CPU.

The zoo symbol (``models.resnet``): JSON byte for byte, argument and
auxiliary-state names, and inferred shapes for ResNet-50 and ResNet-18 at
224 and ResNet-20 at cifar's 32 (no compile: symbols only). Then two
small ResNets trained by ``Module.fit`` for a few steps from the same
parameters in both packages, both on their fused one-program step
(``kvstore='device'`` on one CPU context): a bottleneck net of one unit
per stage on 3x64x64 and ResNet-20 on 3x32x32, float32, SGD with momentum
and weight decay. Final parameters and BatchNorm moving statistics are
compared at 1e-4 absolute and relative: float32 with another summation
order in the convolutions, compounded over the steps. ResNet-20 trains at
lr 0.005, the bottleneck net at 0.05: with BatchNorm over 4 samples the
20-layer net multiplies a rounding difference about 30 times a step at lr
0.05 (1.3e-5 after one step, 2.0e-3 after three; 4.9e-5 after three at
0.005), so only the smaller rate keeps three steps a test of the
arithmetic rather than of the net's sensitivity.
"""
import importlib

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

JRN = importlib.import_module("mxnet_tpu.models.resnet")
TRN = importlib.import_module("mxnet_tpu_torch.models.resnet")

TOL = 1e-4

ZOO = {
    "resnet50_224": dict(num_classes=1000, num_layers=50,
                         image_shape="3,224,224"),
    "resnet18_224": dict(num_classes=1000, num_layers=18,
                         image_shape="3,224,224"),
    "resnet20_cifar32": dict(num_classes=10, num_layers=20,
                             image_shape="3,32,32"),
    "resnet50_224_nhwc": dict(num_classes=1000, num_layers=50,
                              image_shape="224,224,3", layout="NHWC"),
}


@pytest.mark.parametrize("case", sorted(ZOO))
def test_resnet_symbol_matches_jax(case):
    kw = ZOO[case]
    with jmx.name.NameManager():
        js = JRN.get_symbol(**kw)
    with tmx.name.NameManager():
        ts = tmx.models.resnet(**kw)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    dshape = (2,) + tuple(int(x) for x in kw["image_shape"].split(","))
    for got, want in zip(ts.infer_shape(data=dshape),
                         js.infer_shape(data=dshape)):
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    # the symbol JSON of either package loads in the other
    assert tmx.sym.load_json(js.tojson()).tojson() == js.tojson()


def test_resnet_depth_config_matches_jax():
    for layers, height in ((18, 224), (34, 224), (50, 224), (101, 224),
                           (152, 224), (20, 32), (56, 32), (164, 32)):
        assert TRN.depth_config(layers, height) == JRN.depth_config(layers,
                                                                    height)
    with pytest.raises(ValueError):
        TRN.depth_config(21, 32)


# (builder arguments, data shape, learning rate)
FIT = {
    "bottleneck_64": (dict(units=(1, 1, 1, 1), num_stages=4,
                           filter_list=(8, 16, 32, 64, 128), num_classes=10,
                           image_shape=(3, 64, 64), bottle_neck=True),
                      (3, 64, 64), 0.05),
    "resnet20_32": (dict(units=(3, 3, 3), num_stages=3,
                         filter_list=(16, 16, 32, 64), num_classes=10,
                         image_shape=(3, 32, 32), bottle_neck=False),
                    (3, 32, 32), 0.005),
}
BATCH, STEPS = 4, 3


def _params(sym, dshape, seed):
    """Seeded He-scaled weights, BN gamma near 1, nonzero beta and moving
    statistics, for every argument and auxiliary state."""
    args, _, auxs = sym.infer_shape(data=(BATCH,) + dshape)
    rng = np.random.RandomState(seed)
    arg_params = {}
    for name, shape in zip(sym.list_arguments(), args):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("_gamma"):
            v = 1 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        arg_params[name] = v.astype(np.float32)
    aux_params = {}
    for name, shape in zip(sym.list_auxiliary_states(), auxs):
        v = (0.1 * rng.randn(*shape) if name.endswith("mean")
             else 1 + 0.1 * rng.rand(*shape))
        aux_params[name] = v.astype(np.float32)
    return arg_params, aux_params


def _fit(mx, sym, X, Y, arg_params, aux_params, lr):
    it = mx.io.NDArrayIter(X, Y, batch_size=BATCH)
    ctx = mx.cpu()
    mod = mx.mod.Module(sym, context=ctx)
    mod.fit(it, num_epoch=1, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in arg_params.items()},
            aux_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in aux_params.items()},
            eval_metric=mx.metric.Accuracy())
    assert mod._fused is not None, "kvstore='device' must take the fused path"
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


@pytest.mark.parametrize("case", sorted(FIT))
def test_resnet_fused_fit_matches_jax(case):
    kw, dshape, lr = FIT[case]
    with jmx.name.NameManager():
        js = JRN.resnet(**kw)
    with tmx.name.NameManager():
        ts = TRN.resnet(**kw)
    assert ts.tojson() == js.tojson()
    arg_params, aux_params = _params(ts, dshape, seed=len(case))
    rng = np.random.RandomState(9)
    X = rng.rand(BATCH * STEPS, *dshape).astype(np.float32)
    Y = rng.randint(0, 10, (BATCH * STEPS,)).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        j_args, j_auxs = _fit(jmx, js, X, Y, arg_params, aux_params, lr)
    t_args, t_auxs = _fit(tmx, ts, X, Y, arg_params, aux_params, lr)
    assert sorted(t_args) == sorted(j_args)
    assert sorted(t_auxs) == sorted(j_auxs)
    moved = max(np.abs(t_args[n] - arg_params[n]).max() for n in arg_params)
    assert moved > 1e-3 * lr / 0.005, "the parameters did not move"
    for n in j_args:
        np.testing.assert_allclose(t_args[n], j_args[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    for n in j_auxs:
        assert np.abs(t_auxs[n] - aux_params[n]).max() > 0, n
        np.testing.assert_allclose(t_auxs[n], j_auxs[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
