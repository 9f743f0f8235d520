"""Parity of the port's image-classification zoo with the JAX
package, on the CPU.

Every ported zoo symbol's JSON is the JAX package's byte for byte and
infers the same shapes at its full size. The networks that take small
images run one inference forward from the same weights, carried across
as a ``.params`` file that both packages read: outputs within 1e-4 of
the largest JAX output (float32; only the summation order differs). One
``Module.fit`` epoch of a narrow AlexNet (AlexNet's layers at narrow
widths: LRN, Dropout, max pooling) with the same dropout mask installed
in both packages, a ``MultiFactorScheduler`` boundary inside the epoch
and top-5 accuracy, on the classic path and on the fused step, against
the JAX package's same path: parameters within 1e-4, metrics equal.
``FeedForward`` trains, predicts and scores as the ``Module`` path does,
and ``tools/train_imagenet.py`` runs on the CPU.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu_torch.ops import sample

OUT_TOL = 1e-4
FIT_TOL = 1e-4

# (builder, kwargs, data shape for infer_shape at full size)
ZOO = [
    ("mlp", {}, (2, 1, 28, 28)),
    ("lenet", {}, (2, 1, 28, 28)),
    ("alexnet", {}, (2, 3, 224, 224)),
    ("vgg", {"num_layers": 16}, (2, 3, 224, 224)),
    ("vgg", {"num_layers": 11, "batch_norm": True}, (2, 3, 224, 224)),
    ("googlenet", {}, (2, 3, 224, 224)),
    ("inception_bn", {}, (2, 3, 224, 224)),
    ("inception_v3", {}, (2, 3, 299, 299)),
    ("inception_resnet_v2", {}, (2, 3, 299, 299)),
    ("resnext", {"num_layers": 50, "image_shape": "3,224,224"}, (2, 3, 224, 224)),
]
ZOO_IDS = ["%s-%d" % (z[0], i) for i, z in enumerate(ZOO)]


def _both(name, kwargs):
    with jmx.name.NameManager():
        js = getattr(jmodels, name)(**kwargs)
    with tmx.name.NameManager():
        ts = getattr(tmx.models, name)(**kwargs)
    return js, ts


@pytest.mark.parametrize("name,kwargs,shape", ZOO, ids=ZOO_IDS)
def test_zoo_symbol_json_and_shapes_match_jax(name, kwargs, shape):
    js, ts = _both(name, kwargs)
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape(data=shape) == js.infer_shape(data=shape)


# networks at small images: (builder, kwargs, data shape)
SMALL = [
    ("mlp", {}, (2, 1, 28, 28)),
    ("lenet", {}, (2, 1, 28, 28)),
    ("alexnet", {"num_classes": 10}, (2, 3, 67, 67)),
    ("vgg", {"num_classes": 10, "num_layers": 11, "batch_norm": True}, (2, 3, 32, 32)),
    ("googlenet", {"num_classes": 10}, (1, 3, 64, 64)),
    ("resnext", {"num_classes": 10, "num_layers": 8, "image_shape": "3,32,32",
                 "num_group": 4}, (2, 3, 32, 32)),
]


@pytest.mark.parametrize("name,kwargs,shape", SMALL,
                         ids=["%s-%d" % (s[0], i) for i, s in enumerate(SMALL)])
def test_zoo_forward_matches_jax(tmp_path, name, kwargs, shape):
    js, ts = _both(name, kwargs)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    tm = tmx.mod.Module(ts, context=tmx.cpu())
    tm.bind(data_shapes=[("data", shape)],
            label_shapes=[("softmax_label", shape[:1])], for_training=False)
    tm.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2,
                                   rng=torch.Generator().manual_seed(3)))
    path = str(tmp_path / "zoo.params")
    tm.save_params(path)
    jm = jmx.mod.Module(js, context=jmx.cpu())
    jm.bind(data_shapes=[("data", shape)],
            label_shapes=[("softmax_label", shape[:1])], for_training=False)
    jm.load_params(path)
    tm.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())], None),
               is_train=False)
    jm.forward(jmx.io.DataBatch([jmx.nd.array(x)], None), is_train=False)
    t = tm.get_outputs()[0].asnumpy()
    j = jm.get_outputs()[0].asnumpy()
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= OUT_TOL * np.abs(j).max()


# ------------------------------------------------- narrow AlexNet fit
BATCH, SHAPE, CLASSES = 8, (3, 67, 67), 10
KEEP = 0.5


def _narrow_alexnet(mx):
    """AlexNet's layer sequence at narrow widths (67x67 images)."""
    sym = mx.sym
    x = sym.Variable("data")
    for name, kernel, stride, pad, filters, lrn, pool in (
            ("conv1", (11, 11), (4, 4), None, 8, True, True),
            ("conv2", (5, 5), (1, 1), (2, 2), 16, True, True),
            ("conv3", (3, 3), (1, 1), (1, 1), 16, False, False),
            ("conv4", (3, 3), (1, 1), (1, 1), 16, False, False),
            ("conv5", (3, 3), (1, 1), (1, 1), 8, False, True)):
        kw = {} if pad is None else {"pad": pad}
        x = sym.Convolution(x, name=name, kernel=kernel, stride=stride,
                            num_filter=filters, **kw)
        x = sym.Activation(x, act_type="relu")
        if lrn:
            x = sym.LRN(x, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
        if pool:
            x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(2, 2))
    x = sym.Flatten(x)
    for name in ("fc1", "fc2"):
        x = sym.FullyConnected(x, name=name, num_hidden=32)
        x = sym.Activation(x, act_type="relu")
        x = sym.Dropout(x, p=1 - KEEP)
    x = sym.FullyConnected(x, name="fc3", num_hidden=CLASSES)
    return sym.SoftmaxOutput(x, name="softmax")


def _fit_data():
    rng = np.random.RandomState(6)
    X = rng.randn(3 * BATCH, *SHAPE).astype(np.float32)
    y = rng.randint(0, CLASSES, (3 * BATCH,)).astype(np.float32)
    bern = rng.rand(BATCH, 32) < KEEP
    return X, y, bern


def _fit(mx, sym, kvstore, X, y, arg_params):
    mod = mx.mod.Module(sym, context=mx.cpu())
    it = mx.io.NDArrayIter(X, y, BATCH, shuffle=False)
    metric = mx.metric.create(["acc", mx.metric.TopKAccuracy(top_k=5)])
    sched = mx.lr_scheduler.MultiFactorScheduler(step=[1], factor=0.1)
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": sched},
            arg_params=arg_params, eval_metric=metric)
    return mod, metric


@pytest.mark.parametrize("kvstore", ["local", "device"], ids=["classic", "fused"])
def test_narrow_alexnet_fit_matches_jax(monkeypatch, kvstore):
    import jax
    import jax.numpy as jnp

    X, y, bern = _fit_data()
    # the same mask in every Dropout of every step, in both packages
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(bern))
    monkeypatch.setattr(sample, "dropout_mask",
                        lambda rng, shape, keep, dtype, device:
                        torch.from_numpy(bern).to(dtype) / keep)
    with jmx.name.NameManager():
        js = _narrow_alexnet(jmx)
    with tmx.name.NameManager():
        ts = _narrow_alexnet(tmx)
    assert ts.tojson() == js.tojson()
    shapes = dict(zip(ts.list_arguments(),
                      ts.infer_shape(data=(BATCH,) + SHAPE)[0]))
    rng = np.random.RandomState(2)
    arg_params = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                      if len(s) > 1 else np.zeros(s)).astype(np.float32)
                  for n, s in shapes.items() if n not in ("data", "softmax_label")}
    tmod, tmetric = _fit(tmx, ts, kvstore, X, y,
                         {n: tmx.nd.array(v, ctx=tmx.cpu()) for n, v in arg_params.items()})
    jmod, jmetric = _fit(jmx, js, kvstore, X, y,
                         {n: jmx.nd.array(v) for n, v in arg_params.items()})
    assert (tmod._fused is not None) == (kvstore == "device")
    tp, jp = tmod.get_params()[0], jmod.get_params()[0]
    for n in arg_params:
        a, b = tp[n].asnumpy(), jp[n].asnumpy()
        assert np.abs(a - arg_params[n]).max() > 0, n
        assert np.abs(a - b).max() <= FIT_TOL * max(np.abs(b).max(), 1e-6), n
    assert tmetric.get() == jmetric.get()


# ------------------------------------------------------------ FeedForward
def _ff_data():
    rng = np.random.RandomState(9)
    X = rng.randn(40, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (40,)).astype(np.float32)
    return X, y


def test_feedforward_equals_the_module_path(tmp_path):
    X, y = _ff_data()
    net = tmx.models.mlp(num_classes=10)
    init = lambda: tmx.init.Xavier(rng=torch.Generator().manual_seed(4))  # noqa: E731
    np.random.seed(0)
    ff = tmx.model.FeedForward(net, ctx=tmx.cpu(), num_epoch=2,
                               numpy_batch_size=8, initializer=init(),
                               learning_rate=0.1, momentum=0.9)
    ff.fit(X, y)
    np.random.seed(0)
    it = tmx.io.NDArrayIter(X, y, 8, shuffle=True, last_batch_handle="roll_over")
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd", initializer=init(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    args, _ = mod.get_params()
    for n, v in args.items():
        np.testing.assert_array_equal(ff.arg_params[n].asnumpy(), v.asnumpy())
    pred = ff.predict(X)
    want = mod.predict(tmx.io.NDArrayIter(X, y, 8, last_batch_handle="pad")).asnumpy()
    np.testing.assert_array_equal(pred, want)
    acc = ff.score(tmx.io.NDArrayIter(X, y, 8), eval_metric="acc")
    assert acc == dict(mod.score(tmx.io.NDArrayIter(X, y, 8), "acc"))["accuracy"]
    ff.save(str(tmp_path / "ff"))
    back = tmx.model.FeedForward.load(str(tmp_path / "ff"), 2, ctx=tmx.cpu())
    np.testing.assert_array_equal(back.predict(X), pred)
    made = tmx.model.FeedForward.create(net, X, y, ctx=tmx.cpu(), num_epoch=1,
                                        numpy_batch_size=8, learning_rate=0.1)
    assert made.predict(X).shape == (40, 10)


def test_feedforward_matches_jax_predict(tmp_path):
    """Parameters carried across as a checkpoint: the JAX package's
    FeedForward predicts what the port's does."""
    X, y = _ff_data()
    np.random.seed(1)
    ff = tmx.model.FeedForward(tmx.models.lenet(num_classes=10), ctx=tmx.cpu(),
                               num_epoch=1, numpy_batch_size=8,
                               initializer=tmx.init.Xavier(
                                   rng=torch.Generator().manual_seed(5)))
    ff.fit(X, y)
    ff.save(str(tmp_path / "le"))
    jff = jmx.model.FeedForward.load(str(tmp_path / "le"), 1, ctx=jmx.cpu())
    t, j = ff.predict(X), jff.predict(X)
    assert np.abs(t - j).max() <= OUT_TOL * np.abs(j).max()


# ------------------------------------------------------- train_imagenet
def test_train_imagenet_tool_on_the_cpu(capsys, tmp_path):
    from mxnet_tpu_torch.tools import train_imagenet

    train_imagenet.main(["--device", "cpu", "--network", "lenet",
                         "--image-shape", "1,28,28", "--num-classes", "10",
                         "--batch-size", "8", "--num-examples", "32",
                         "--num-epochs", "2", "--lr", "0.05",
                         "--lr-step-epochs", "0.5", "--disp-batches", "2",
                         "--data-dir", str(tmp_path)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps"] == 8 and rec["fused"] is True
    assert rec["device"]["platform"] == "cpu"
    assert set(rec["train"]) == {"accuracy", "top_k_accuracy_5"}
    assert np.isfinite(rec["images_per_sec"])
    (tmp_path / "train.rec").write_bytes(b"")
    with pytest.raises(tmx.MXNetError, match="holds no records"):
        train_imagenet.main(["--device", "cpu", "--network", "mlp",
                             "--data-dir", str(tmp_path)])
    # a train.rec of JPEGs: ImageRecordIter, on the Python pipeline while
    # a train.idx lets it shuffle, then on the native stage
    w = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "train.idx"),
                                       str(tmp_path / "train.rec"), "w")
    r = np.random.RandomState(0)
    for i in range(16):
        img = (r.rand(r.randint(30, 40), r.randint(30, 40), 3) * 255).astype(np.uint8)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i % 10), i, 0), img))
    w.close()
    for backend in ("python", "native"):
        if backend == "native":
            (tmp_path / "train.idx").unlink()
        train_imagenet.main(["--device", "cpu", "--network", "lenet",
                             "--image-shape", "3,28,28", "--num-classes", "10",
                             "--batch-size", "8", "--num-examples", "16",
                             "--data-dir", str(tmp_path), "--data-nthreads", "1"])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["steps"] == 2 and rec["fused"] is True
        assert rec["data"]["backend"] == backend
        assert rec["data"]["wire"] == ("uint8" if backend == "native" else "float32")
        assert all(np.isfinite(v) for v in rec["train"].values())
