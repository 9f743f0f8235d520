"""The port's data pipeline against the JAX package's, on the CPU.

RecordIO files are held byte for byte across the packages; ``imdecode``,
the resizes, crops and every augmenter against the JAX numpy cores with
the same seeded draws (bitwise: both run the same cv2/PIL calls and
numpy arithmetic); ``ImageIter``, ``ImageRecordIter`` and
``ImageDetRecordIter`` batch streams on the Python pipeline at one decode
thread bit for bit, and at three as multisets of images; the native host
stage, built here with ``g++`` against libjpeg from the port's own copy of
the sources, bit for bit against the JAX package's native stage (the same
sources; a stage built with nvJPEG decodes on the card and is measured by
``chip_smoke.py``). Positions (``state_dict``/``load_state``,
``set_partition``), the uint8 wire through ``Module.fit`` (classic and
fused) against the JAX package within 1e-6, and ``fit(auto_resume=...)``
seeking instead of drawing batches.
"""
import collections
import io as _io
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu import image as JI
from mxnet_tpu import image_det as JD
from mxnet_tpu_torch import image as TI
from mxnet_tpu_torch import image_det as TD
from mxnet_tpu_torch.base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(r, h, w, quality=90):
    from PIL import Image

    bio = _io.BytesIO()
    Image.fromarray((r.rand(h, w, 3) * 255).astype(np.uint8)).save(
        bio, format="JPEG", quality=quality)
    return bio.getvalue()


def _write_rec(mx, path, n=22, seed=0, det=False):
    """``n`` records of JPEGs 40-70 px a side (labels class i % 5, or for
    ``det`` one to three boxes [2, 5, cls, x0, y0, x1, y1, ...])."""
    r = np.random.RandomState(seed)
    w = mx.recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(n):
        buf = _jpeg(r, r.randint(40, 70), r.randint(40, 70))
        if det:
            boxes = []
            for _ in range(r.randint(1, 4)):
                x0, y0 = r.rand(2) * 0.5
                boxes += [r.randint(0, 3), x0, y0, x0 + 0.3, y0 + 0.3]
            label = np.array([2, 5] + boxes, np.float32)
        else:
            label = float(i % 5)
        w.write_idx(i, mx.recordio.pack(mx.recordio.IRHeader(0, label, i, 0), buf))
    w.close()
    return path + ".rec"


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp("recs")
    return {"cls": _write_rec(J, str(d / "cls")),
            "det": _write_rec(J, str(d / "det"), seed=1, det=True),
            "dir": d}


# ---- records ----------------------------------------------------------------
def test_records_are_byte_equal_across_packages(tmp_path):
    for mx in (J, T):
        _write_rec(mx, str(tmp_path / mx.__name__), det=True)
        r = np.random.RandomState(4)
        img = (r.rand(30, 20, 3) * 255).astype(np.uint8)
        with open(str(tmp_path / mx.__name__) + ".img", "wb") as f:
            f.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, [1.0, 2.0], 3, 0),
                                         img, quality=80))
    for ext in (".rec", ".idx", ".img"):
        a = open(str(tmp_path / "mxnet_tpu") + ext, "rb").read()
        b = open(str(tmp_path / "mxnet_tpu_torch") + ext, "rb").read()
        assert a == b, ext
    blob = open(str(tmp_path / "mxnet_tpu_torch.img"), "rb").read()
    (jh, ji), (th, ti) = J.recordio.unpack_img(blob), T.recordio.unpack_img(blob)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jh.label, th.label)
    rec = T.recordio.MXIndexedRecordIO(str(tmp_path / "mxnet_tpu_torch.idx"),
                                       str(tmp_path / "mxnet_tpu_torch.rec"), "r")
    jrec = J.recordio.MXIndexedRecordIO(str(tmp_path / "mxnet_tpu.idx"),
                                        str(tmp_path / "mxnet_tpu.rec"), "r")
    assert rec.keys == jrec.keys
    assert rec.read_idx(7) == jrec.read_idx(7)


@pytest.mark.parametrize("parts", [1, 3])
def test_native_sharded_reader_matches_jax(recs, parts):
    for part in range(parts):
        got = list(T.recordio.RecReader(recs["cls"], part, parts))
        want = list(J.recordio.RecReader(recs["cls"], part, parts))
        assert got == want and got
    assert T.recordio.RecReader(recs["cls"])._handle is not None


# ---- images and augmenters ---------------------------------------------------
def test_imdecode_resize_and_crops_match_jax():
    r = np.random.RandomState(2)
    buf = _jpeg(r, 45, 61)
    np.testing.assert_array_equal(TI.imdecode_np(buf), JI.imdecode_np(buf))
    np.testing.assert_array_equal(TI.imdecode_np(buf, to_rgb=False, flag=0),
                                  JI.imdecode_np(buf, to_rgb=False, flag=0))
    arr = JI.imdecode_np(buf)
    im = TI.imdecode(buf)
    assert im.context.type == "cpu" and im.dtype == np.uint8
    np.testing.assert_array_equal(im.asnumpy(), arr)
    for interp in (0, 1, 2):
        np.testing.assert_array_equal(TI.imresize_np(arr, 33, 20, interp),
                                      JI.imresize_np(arr, 33, 20, interp))
        np.testing.assert_array_equal(TI.resize_short_np(arr, 30, interp),
                                      JI.resize_short_np(arr, 30, interp))
    for fn in ("random_crop_np", "center_crop_np", "random_size_crop_np"):
        random.seed(5)
        got = getattr(TI, fn)(arr, (24, 20))
        random.seed(5)
        want = getattr(JI, fn)(arr, (24, 20))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    np.testing.assert_array_equal(
        TI.color_normalize(im, [1.0, 2.0, 3.0], [2.0, 2.0, 4.0]).asnumpy(),
        JI.color_normalize_np(arr, [1.0, 2.0, 3.0], [2.0, 2.0, 4.0]))
    assert TI.scale_down((10, 40), (20, 20)) == JI.scale_down((10, 40), (20, 20))


def test_every_augmenter_matches_jax():
    r = np.random.RandomState(6)
    arr = (r.rand(50, 64, 3) * 255).astype(np.uint8)
    kw = dict(resize=40, rand_crop=True, rand_resize=True, rand_mirror=True,
              mean=True, std=True, brightness=0.3, contrast=0.3,
              saturation=0.3, pca_noise=0.1)
    tl, jl = TI.CreateAugmenter((3, 24, 24), **kw), JI.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
    for seed in range(3):
        outs = []
        for augs in (tl, jl):
            random.seed(seed)
            np.random.seed(seed)
            x = arr
            for a in augs:
                x = a.apply_np(x)
            outs.append(np.asarray(x))
        np.testing.assert_array_equal(outs[0], outs[1])
    random.seed(1)
    flipped = TI.HorizontalFlipAug(1.0)(T.nd.array(arr, ctx=T.cpu(), dtype=np.uint8))
    np.testing.assert_array_equal(flipped.asnumpy(), arr[:, ::-1])
    assert TI.supports_np(TI.ResizeAug(3)) and not TI.supports_np(TI.Augmenter())


def test_det_augmenters_match_jax():
    r = np.random.RandomState(8)
    arr = (r.rand(60, 80, 3) * 255).astype(np.uint8)
    boxes = np.array([[1, .1, .1, .5, .6], [2, .4, .3, .9, .8]], np.float32)
    kw = dict(resize=70, rand_crop_prob=1.0, num_crop_sampler=3,
              min_crop_scales=0.3, min_crop_overlaps=(0.1, 0.3, 0.5),
              max_crop_trials=20, rand_pad_prob=1.0, max_pad_scale=2.0,
              rand_mirror_prob=0.5, brightness=0.2, contrast=0.2,
              saturation=0.2, mean=np.array([1.0, 2.0, 3.0]))
    tl = TD.CreateDetAugmenter((3, 32, 32), **kw)
    jl = JD.CreateDetAugmenter((3, 32, 32), **kw)
    for seed in range(4):
        outs = []
        for augs in (tl, jl):
            rng = random.Random(seed)
            random.seed(seed)
            x, b = arr, boxes
            for a in augs:
                x, b = a.apply_np(x, b, rng)
            outs.append((np.asarray(x), np.asarray(b)))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_image_iter_matches_jax(recs):
    streams = []
    for mx in (J, T):
        random.seed(3)
        it = mx.image.ImageIter(4, (3, 24, 24), path_imgrec=recs["cls"],
                                path_imgidx=recs["cls"][:-4] + ".idx",
                                shuffle=True, rand_crop=True, rand_mirror=True)
        streams.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for b in it])
    assert len(streams[0]) == len(streams[1]) == 6
    for (a, la, pa), (b, lb, pb) in zip(*streams):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


# ---- the record iterators ------------------------------------------------------
AUG = dict(rand_crop=True, rand_mirror=True, mean_r=123.0, mean_g=117.0,
           mean_b=104.0, std_r=58.0, std_g=57.0, std_b=57.5, seed=3)


def _stream(mx, rec, backend, threads=1, cls="ImageRecordIter", **kw):
    random.seed(7)
    it = getattr(mx.io_image, cls)(path_imgrec=rec, batch_size=5,
                                   backend=backend, preprocess_threads=threads,
                                   **kw)
    # copies: the JAX package's native batches alias the stage's buffers,
    # which later pops reuse (ROADMAP.md C12)
    out = [(b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(), b.pad)
           for b in it]
    it.close()
    return out


def _same(a, b):
    assert len(a) == len(b) and a
    for (x, lx, px), (y, ly, py) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(lx, ly)
        assert px == py


@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_image_record_iter_python_stream_matches_jax(recs, wire):
    kw = dict(AUG, data_shape=(3, 28, 28), wire_dtype=wire, resize=36)
    got = _stream(T, recs["cls"], "python", **kw)
    _same(got, _stream(J, recs["cls"], "python", **kw))
    assert got[0][0].dtype == (np.uint8 if wire == "uint8" else np.float32)
    assert got[-1][2] == 3                  # 22 records in batches of 5


def test_image_record_iter_three_threads_same_multiset(recs):
    """Three decode threads: the same images and labels (a center crop
    draws nothing), the order by record kept."""
    kw = dict(data_shape=(3, 28, 28), wire_dtype="uint8", threads=3)
    got = _stream(T, recs["cls"], "python", **kw)
    want = _stream(J, recs["cls"], "python", **kw)

    def bag(s):
        return collections.Counter(
            (x.tobytes(), float(l)) for b, lab, _ in s for x, l in zip(b, lab))

    assert bag(got) == bag(want)


def test_image_det_record_iter_stream_matches_jax(recs):
    kw = dict(data_shape=(3, 32, 32), rand_mirror_prob=0.5, rand_pad_prob=0.5,
              max_pad_scale=2.0, rand_crop_prob=0.8, num_crop_sampler=3,
              min_crop_scales=0.3, min_crop_overlaps=(0.1, 0.3, 0.5),
              max_crop_trials=20, mean_r=123.0, mean_g=117.0, mean_b=104.0,
              max_objects=4, cls="ImageDetRecordIter")
    got = _stream(T, recs["det"], None, **kw)
    _same(got, _stream(J, recs["det"], None, **kw))
    assert got[0][1].shape == (5, 4, 5)


@pytest.mark.parametrize("threads", [1, 3])
def test_native_stage_matches_jax_native_stage(recs, threads):
    """One decode thread with random crops and flips; three with the
    deterministic chain (which record a worker takes, and so which of
    the per-worker draws it gets, depends on scheduling)."""
    aug = AUG if threads == 1 else dict(mean_r=1.0, seed=3)
    kw = dict(aug, data_shape=(3, 28, 28), resize=36, threads=threads)
    got = _stream(T, recs["cls"], "native", **kw)
    _same(got, _stream(J, recs["cls"], "native", **kw))
    assert T._native.decoder() == "libjpeg"


def test_native_batches_survive_a_slow_consumer(recs):
    """The stage runs ahead (prefetch 1, two decode threads) while the
    consumer holds every batch and sleeps: no batch it holds changes."""
    it = T.io_image.ImageRecordIter(recs["cls"], (3, 28, 28), 2,
                                    backend="native", prefetch_buffer=1,
                                    preprocess_threads=2, resize=36)
    held = []
    for b in it:
        held.append((b.data[0], b.data[0].asnumpy().copy()))
        time.sleep(0.02)
    it.close()
    want = _stream(J, recs["cls"], "native", data_shape=(3, 28, 28),
                   resize=36)
    flat = np.concatenate([w[0] for w in want])[:22]
    got = np.concatenate([h[0].asnumpy() for h in held])[:22]
    np.testing.assert_array_equal(got, flat)
    for nd_arr, copy in held:
        np.testing.assert_array_equal(nd_arr.asnumpy(), copy)


def test_c12_jax_native_batches_alias_the_stage_buffers(recs):
    """The JAX package's native batches are views of the stage's pooled
    buffers, released one pop later: a batch held past the next
    iterator's run changes under its holder; the port's do not."""
    kw = dict(data_shape=(3, 28, 28), resize=36, backend="native",
              preprocess_threads=1)
    drift = {}
    for mx in (J, T):
        runs = []
        for _ in range(2):
            it = mx.io_image.ImageRecordIter(recs["cls"], batch_size=5, **kw)
            held = [b.data[0] for b in it]
            it.close()
            runs.append((held, np.concatenate([h.asnumpy().copy()
                                               for h in held])))
        first_held, first_at_end = runs[0]
        later = np.concatenate([h.asnumpy() for h in first_held])
        drift[mx.__name__] = float((later != first_at_end).mean())
    assert drift["mxnet_tpu_torch"] == 0.0
    assert drift["mxnet_tpu"] > 0.0, drift


def test_native_gate_counts_fallbacks_and_explicit_native_raises(recs):
    from mxnet_tpu_torch import telemetry

    before = telemetry.counter("io.native_decode_fallback", reason="shuffle").value
    it = T.io_image.ImageRecordIter(recs["cls"], (3, 28, 28), 4, shuffle=True,
                                    path_imgidx=None)
    assert it._native is None and it._wire is None
    it.close()
    assert telemetry.counter("io.native_decode_fallback",
                             reason="shuffle").value == before + 1
    with pytest.raises(MXNetError, match="native decode stage"):
        T.io_image.ImageRecordIter(recs["cls"], (3, 28, 28), 4, shuffle=True,
                                   backend="native")
    auto = T.io_image.ImageRecordIter(recs["cls"], (3, 28, 28), 4)
    assert auto._native is not None and auto._wire is not None
    auto.close()


@pytest.mark.parametrize("backend", ["python", "native"])
def test_state_dict_load_state_and_set_partition(recs, backend):
    """The native stage draws per (seed, epoch, worker), so its random
    crops and flips resume exactly; the Python pipeline's draw from the
    global ``random`` as its threads run ahead, so it resumes a
    deterministic chain (as the JAX package's does)."""
    aug = AUG if backend == "native" else dict(resize=36)
    kw = dict(aug, data_shape=(3, 28, 28), wire_dtype="uint8",
              preprocess_threads=1)
    it = T.io_image.ImageRecordIter(recs["cls"], batch_size=4, backend=backend, **kw)
    it.next()
    it.next()
    state = it.state_dict()
    rest = [b.data[0].asnumpy() for b in it]
    it.close()
    assert state == {"type": "ImageRecordIter", "epoch": 0, "batches": 2}
    again = T.io_image.ImageRecordIter(recs["cls"], batch_size=4, backend=backend, **kw)
    again.load_state(state)
    resumed = [b.data[0].asnumpy() for b in again]
    assert len(resumed) == len(rest) == 4
    for want, got in zip(rest, resumed):
        np.testing.assert_array_equal(got, want)
    # set_partition: the JAX package's shard, bit for bit
    for mx in (T, J):
        random.seed(9)
        sh = mx.io_image.ImageRecordIter(recs["cls"], batch_size=4,
                                         backend=backend, **kw)
        sh.set_partition(2, 1)
        sh_out = [b.data[0].asnumpy().copy() for b in sh]
        sh.close()
        if mx is T:
            port = sh_out
    assert len(port) == len(sh_out)
    for a, b in zip(port, sh_out):
        np.testing.assert_array_equal(a, b)


def test_ndarray_iter_and_device_feed_positions():
    X = np.arange(40, dtype=np.float32).reshape(10, 4)
    it = T.io.NDArrayIter(X, np.arange(10, dtype=np.float32), batch_size=3)
    it.next()
    state = it.state_dict()
    jit = J.io.NDArrayIter(X, np.arange(10, dtype=np.float32), batch_size=3)
    jit.next()
    assert state == jit.state_dict()
    feed = T.io.DeviceFeedIter(it, ctx=T.cpu())
    rest = [b.data[0].asnumpy() for b in feed]
    assert [r[0, 0] for r in rest] == [12.0, 24.0, 36.0]
    feed.close()
    it2 = T.io.NDArrayIter(X, np.arange(10, dtype=np.float32), batch_size=3)
    it2.load_state(state)
    np.testing.assert_array_equal(it2.next().data[0].asnumpy(), rest[0])


# ---- the wire through Module.fit ----------------------------------------------
def _net(mx):
    x = mx.sym.Convolution(mx.sym.Variable("data"), num_filter=4, kernel=(3, 3),
                           name="c1")
    x = mx.sym.Pooling(mx.sym.Activation(x, act_type="tanh"), global_pool=True,
                       kernel=(1, 1), pool_type="avg")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _fit(mx, rec, kvstore, wire):
    random.seed(1)
    it = mx.io_image.ImageRecordIter(rec, (3, 28, 28), 6, backend="python",
                                     preprocess_threads=1, wire_dtype=wire,
                                     **AUG)
    net = _net(mx)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(6, 3, 28, 28), softmax_label=(6,))[0]))
    r = np.random.RandomState(5)
    args = {k: mx.nd.array(r.uniform(-0.3, 0.3, s).astype(np.float32), ctx=mx.cpu())
            for k, s in sorted(shapes.items()) if k not in ("data", "softmax_label")}
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=2, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, arg_params=args)
    it.close()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_wire_through_module_fit_matches_jax(recs, kvstore):
    want, _ = _fit(J, recs["cls"], "local", "uint8")
    got, mod = _fit(T, recs["cls"], kvstore, "uint8")
    assert (mod._fused is not None) == (kvstore == "device")
    if mod._fused is not None:
        # the step's static input is the uint8 NHWC batch
        buf = mod._fused.trainer.input_buffers()["data"]
        assert str(buf.dtype) == "torch.uint8" and tuple(buf.shape) == (6, 28, 28, 3)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    flt, _ = _fit(T, recs["cls"], kvstore, "float32")
    for k in want:
        np.testing.assert_allclose(flt[k], got[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_auto_resume_seeks_with_load_state(tmp_path):
    """A sidecar with the iterator's state: the resumed fit seeks (draws
    no batch to get there) and equals the uninterrupted run."""
    X = np.random.RandomState(0).standard_normal((24, 6)).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32)
    net = T.sym.SoftmaxOutput(T.sym.FullyConnected(T.sym.Variable("data"),
                                                   num_hidden=2, name="fc"),
                              name="softmax")

    class Counting(T.io.NDArrayIter):
        drawn = 0

        def next(self):
            batch = super().next()
            Counting.drawn += 1
            return batch

    def fit(prefix=None, cut=None):
        mod = T.mod.Module(net, context=T.cpu())
        it = Counting(X, Y, batch_size=4)

        def stop(param):
            if cut is not None and param.epoch == 1 and param.nbatch + 1 == cut:
                mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
                # the position after batch `cut` (fit has already drawn
                # the next batch when its callback runs)
                T.model.save_resume_state(
                    prefix, 1, cut,
                    iter_state={"type": "NDArrayIter", "cursor": (cut - 1) * 4})
                raise KeyboardInterrupt

        T.random.seed(0)
        np.random.seed(0)
        try:
            mod.fit(it, num_epoch=3, optimizer="sgd", auto_resume=prefix,
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                    initializer=T.init.Uniform(0.1), batch_end_callback=stop)
        except KeyboardInterrupt:
            return None
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    whole = fit()
    prefix = str(tmp_path / "m")
    assert fit(prefix, cut=2) is None
    Counting.drawn = 0
    resumed = fit(prefix)
    assert Counting.drawn == 4 + 6        # epoch 1's last 4 batches, epoch 2
    for k in whole:
        np.testing.assert_allclose(resumed[k], whole[k], rtol=1e-6, atol=1e-7)


# ---- the native build and import hygiene -------------------------------------------
def test_native_build_races_across_processes(tmp_path):
    """Three processes build the stage into one empty directory at once:
    the file lock lets one compile, the others load its library."""
    code = ("import sys; from mxnet_tpu_torch import _native as n;"
            "n.BUILD_DIR = sys.argv[1]; print(n.decoder())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [o.strip() for o, _ in outs] == ["libjpeg"] * 3
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(tmp_path)
                                   if f.endswith(".tmp")]


def test_caffe_op_and_native_stage_load_no_jax_package(recs):
    code = ("import sys, numpy as np; import mxnet_tpu_torch as mx;"
            "from mxnet_tpu_torch.contrib.caffe import CaffeOp;"
            "net = CaffeOp(mx.sym.Variable('data'), prototxt='layer { name: \"c\" "
            "type: \"InnerProduct\" inner_product_param { num_output: 3 } }');"
            "it = mx.io_image.ImageRecordIter(sys.argv[1], (3, 28, 28), 4,"
            " backend='native'); it.next(); it.close();"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu', 'tools')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code, recs["cls"]], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
