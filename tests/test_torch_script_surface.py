"""The script surface of the port against the JAX package: ``mx.Context``
and its ``with`` scope, ``mx.tpu``/``mx.context.auto``, ``mx.utils``,
``nd.waitall``/``nd.imdecode``, and the rest of ``mx.io`` (``ResizeIter``,
``PrefetchingIter``, ``MNISTIter``, ``CSVIter``, ``maybe_device_feed``).
The same seeded arrays or files go through both packages and must give
the same batches, pads and positions."""
import gzip
import io as _io
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch.base import MXNetError


# ---- the context ---------------------------------------------------------
@pytest.mark.parametrize("mx", [J, T], ids=["jax", "port"])
def test_context_with_scope_contract(mx):
    """``with ctx:`` makes ctx the thread's current context, nests, and
    restores the outer one on exit (reference: context.py:24-93)."""
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        with mx.Context("cpu", 1):
            assert mx.current_context() == mx.cpu(1)
            assert mx.current_context() != mx.cpu()
        assert mx.current_context() == mx.cpu()
    c = mx.Context(mx.tpu(2))
    assert (c.device_type, c.device_id) == ("tpu", 2)
    assert str(mx.gpu(1)) == "gpu(1)" and repr(mx.cpu()) == "cpu(0)"
    assert mx.tpu(0) != mx.gpu(0) and hash(mx.cpu(3)) == hash(mx.cpu(3))
    assert mx.context.auto() == (mx.tpu() if mx.context.num_tpus() else mx.cpu())
    assert mx.context.num_gpus() == mx.context.num_tpus()


def test_port_context_is_the_device_torch_reads(monkeypatch):
    """A port Context goes into torch calls as is and compares equal to
    the torch.device of the same device; outside a ``with`` block the
    current context is the card, which raises without CUDA, unless
    MXNET_DEFAULT_CONTEXT=cpu."""
    c = T.cpu()
    assert torch.zeros(2, device=c).device.type == "cpu"
    assert torch.device(c) == torch.device("cpu") == c
    assert c.type == "cpu" and c.index is None
    g = T.tpu(1)
    assert g.type == "cuda" and g.index == 1 and torch.device(g) == torch.device("cuda", 1)
    assert pickle.loads(pickle.dumps(g)) == g
    assert T.nd.zeros((2,), ctx=T.cpu()).context == T.cpu()
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            T.current_context()
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    assert T.current_context() == T.cpu()
    with T.cpu():
        mod = T.mod.Module(T.sym.SoftmaxOutput(T.sym.Variable("data")))
    assert mod._context[0].type == "cpu"


def test_script_names_resolve_and_later_names_say_their_item():
    for name in ("Context", "current_context", "tpu", "kv", "FeedForward",
                 "Optimizer", "rnd"):
        assert hasattr(T, name), name
    for mod, names in ((T.context, ("num_tpus", "auto", "num_gpus")),
                       (T.io, ("ResizeIter", "PrefetchingIter", "MNISTIter",
                               "CSVIter", "ImageRecordIter",
                               "maybe_device_feed")),
                       (T.nd, ("waitall", "imdecode")),
                       (T.utils, ("split_data", "clip_global_norm", "makedirs",
                                  "seed_everything"))):
        for n in names:
            assert callable(getattr(mod, n)), n
    # ported with ROADMAP.md A6b
    for mod, name in ((T.mod, "ParallelLMModule"), (T.parallel, "build_mesh"),
                      (T, "executor_manager")):
        assert hasattr(mod, name), name
    # ported with A7's training half: the JAX package's entry points
    for name, attrs in (
            ("profiler", ("profiler_set_config", "profiler_set_state",
                          "dump_profile", "emit_span", "record_span")),
            ("monitor", ("Monitor",)), ("mon", ("Monitor",)),
            ("guard", ("GuardPolicy", "TrainingGuard", "Sentinel",
                       "BadStepError", "StallError", "resolve")),
            ("compileobs", ("symbol_digest", "diff_signatures", "summary",
                            "program_table", "oom_guard", "reset",
                            "device_memory_stats", "update_memory_gauges"))):
        for attr in attrs:
            assert callable(getattr(getattr(J, name), attr)), (name, attr)
            assert callable(getattr(getattr(T, name), attr)), (name, attr)
    # ported with A7's compiler half
    for name, attrs in (
            ("compile_cache", ("enable", "disable", "fingerprint", "make_key",
                               "classify_compile", "save_executable",
                               "load_executable", "prune", "stats")),
            ("graphpass", ("optimize", "active_passes", "run_pass",
                           "register_pass", "structural_hash")),
            ("rtc", ("Rtc",))):
        for attr in attrs:
            assert callable(getattr(getattr(J, name), attr)), (name, attr)
            assert callable(getattr(getattr(T, name), attr)), (name, attr)
    # ported with A8b
    for attr in ("export_predict_artifact", "export_train_artifact",
                 "load_artifact_manifest"):
        assert callable(getattr(J.export_artifact, attr)), attr
        assert callable(getattr(T.export_artifact, attr)), attr
    assert T.export_artifact.MAGIC == J.export_artifact.MAGIC
    assert callable(T.export_predict_artifact)
    assert callable(T.export_train_artifact)
    assert not hasattr(T, "no_such_name")


# ---- utils and ndarray ----------------------------------------------------
def test_utils_match_jax(tmp_path):
    x = np.random.RandomState(0).randn(10, 6).astype(np.float32)
    for axis, n, even in ((0, 2, True), (1, 3, True), (0, 3, False)):
        want = J.utils.split_data(J.nd.array(x), n, batch_axis=axis, even_split=even)
        got = T.utils.split_data(T.nd.array(x, ctx=T.cpu()), n, batch_axis=axis,
                                 even_split=even)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    for mx in (J, T):
        with pytest.raises(ValueError):
            mx.utils.split_data(mx.nd.array(x, ctx=mx.cpu()), 3)
    for max_norm in (0.5, 100.0):
        ja = [J.nd.array(x), J.nd.array(x[:2] * 3)]
        ta = [T.nd.array(x, ctx=T.cpu()), T.nd.array(x[:2] * 3, ctx=T.cpu())]
        jn, tn = J.utils.clip_global_norm(ja, max_norm), T.utils.clip_global_norm(ta, max_norm)
        assert abs(jn - tn) <= 1e-5 * jn
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6, atol=1e-7)
    T.utils.makedirs(str(tmp_path / "a" / "b"))
    T.utils.makedirs(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    T.utils.seed_everything(7)
    a = np.random.rand(3), T.random.uniform(shape=(3,), ctx=T.cpu()).asnumpy()
    T.utils.seed_everything(7)
    b = np.random.rand(3), T.random.uniform(shape=(3,), ctx=T.cpu()).asnumpy()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_imdecode_and_waitall_match_jax():
    from PIL import Image

    r = np.random.RandomState(3)
    bio = _io.BytesIO()
    Image.fromarray((r.rand(20, 24, 3) * 255).astype(np.uint8)).save(bio, format="PNG")
    buf = bio.getvalue()
    for kw in ({}, {"clip_rect": (2, 3, 14, 17)}, {"channels": 1}):
        want = J.nd.imdecode(buf, **kw).asnumpy()
        got = T.nd.imdecode(buf, **kw).asnumpy()
        assert got.shape == want.shape and got.dtype == want.dtype, kw
        np.testing.assert_array_equal(got, want)
    mean = np.full((3, 20, 24), 100.0, np.float32)
    want = J.nd.imdecode(buf, mean=J.nd.array(mean)).asnumpy()
    got = T.nd.imdecode(buf, mean=T.nd.array(mean, ctx=T.cpu())).asnumpy()
    np.testing.assert_allclose(got, want)
    out = T.nd.zeros((2, 3, 20, 24), ctx=T.cpu(), dtype=np.uint8)
    T.nd.imdecode(buf, out=out, index=1)
    np.testing.assert_array_equal(out.asnumpy()[1], J.nd.imdecode(buf).asnumpy())
    T.nd.waitall()


# ---- iterators --------------------------------------------------------------
def _batches(it):
    return [([d.asnumpy().copy() for d in b.data],
             [l.asnumpy().copy() for l in b.label], b.pad) for b in it]


def _same_stream(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


def _arrays(n=23, seed=0):
    r = np.random.RandomState(seed)
    return r.randn(n, 3).astype(np.float32), r.randint(0, 4, n).astype(np.float32)


def test_resize_iter_matches_jax_and_resumes():
    X, Y = _arrays()
    runs = {}
    for mx in (J, T):
        it = mx.io.ResizeIter(mx.io.NDArrayIter(X, Y, batch_size=4), 9)
        assert it.batch_size == 4 and it.provide_data[0][1] == (4, 3)
        runs[mx] = _batches(it)
        it.reset()
        assert len(_batches(it)) == 9
    _same_stream(runs[T], runs[J])
    it = T.io.ResizeIter(T.io.NDArrayIter(X, Y, batch_size=4), 9)
    for _ in range(7):      # across the inner iterator's reset
        it.next()
    state = it.state_dict()
    jt = J.io.ResizeIter(J.io.NDArrayIter(X, Y, batch_size=4), 9)
    for _ in range(7):
        jt.next()
    assert state == jt.state_dict()
    again = T.io.ResizeIter(T.io.NDArrayIter(X, Y, batch_size=4), 9)
    again.load_state(state)
    _same_stream(_batches(again), runs[T][7:])


def test_prefetching_iter_matches_jax_and_resumes():
    X, Y = _arrays()
    X2, _ = _arrays(seed=1)
    runs = {}
    for mx in (J, T):
        it = mx.io.PrefetchingIter(
            [mx.io.NDArrayIter(X, Y, batch_size=5),
             mx.io.NDArrayIter(X2, Y, batch_size=5, data_name="data2",
                               label_name="label2")],
            rename_data=[{"data": "a"}, {"data2": "b"}])
        assert [d[0] for d in it.provide_data] == ["a", "b"]
        runs[mx] = _batches(it)
        it.reset()
        runs[mx] += _batches(it)
    _same_stream(runs[T], runs[J])
    assert runs[T][4][2] == 2       # the last batch's pad
    it = T.io.PrefetchingIter(T.io.NDArrayIter(X, Y, batch_size=5))
    it.next()
    it.next()
    state = it.state_dict()
    assert state == {"type": "PrefetchingIter",
                     "inner": [{"type": "NDArrayIter", "cursor": 5}]}
    rest = _batches(it)
    again = T.io.PrefetchingIter(T.io.NDArrayIter(X, Y, batch_size=5))
    again.load_state(state)
    _same_stream(_batches(again), rest)


def _write_mnist(path, n, seed):
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = r.randint(0, 10, n).astype(np.uint8)
    with gzip.open(path + "-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(path + "-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return path + "-images-idx3-ubyte", path + "-labels-idx1-ubyte"


@pytest.mark.parametrize("kw", [dict(flat=True, shuffle=True, seed=3),
                                dict(flat=False, shuffle=False),
                                dict(flat=True, num_parts=2, part_index=1)],
                         ids=["flat-shuffled", "image", "part"])
def test_mnist_iter_matches_jax(tmp_path, kw):
    img, lab = _write_mnist(str(tmp_path / "train"), 37, 0)
    its = {mx: mx.io.MNISTIter(image=img, label=lab, batch_size=8, **kw)
           for mx in (J, T)}
    assert its[T].provide_data[0][1] == its[J].provide_data[0][1]
    runs = {mx: _batches(it) for mx, it in its.items()}
    _same_stream(runs[T], runs[J])
    it = its[T]
    it.reset()
    it.next()
    state = it.state_dict()
    rest = _batches(it)
    again = T.io.MNISTIter(image=img, label=lab, batch_size=8, **kw)
    again.load_state(state)
    _same_stream(_batches(again), rest)
    with open(str(tmp_path / "bad"), "wb") as f:
        f.write(struct.pack(">IIII", 7, 0, 28, 28))
    with pytest.raises(MXNetError, match="Invalid MNIST"):
        T.io.MNISTIter(image=str(tmp_path / "bad"), label=lab)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    r = np.random.RandomState(2)
    data = r.randn(13, 6).astype(np.float32)
    np.savetxt(str(tmp_path / "d.csv"), data, delimiter=",")
    np.savetxt(str(tmp_path / "l.csv"), r.randint(0, 3, 13), delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4,
              round_batch=round_batch)
    runs = {mx: _batches(mx.io.CSVIter(**kw)) for mx in (J, T)}
    _same_stream(runs[T], runs[J])
    assert runs[T][0][0][0].shape == (4, 2, 3)
    no_label = T.io.CSVIter(data_csv=kw["data_csv"], data_shape=(6,), batch_size=5)
    assert [d.name for d in no_label.provide_label] == ["label"]
    assert float(np.abs(next(iter(no_label)).label[0].asnumpy()).sum()) == 0.0


def test_image_record_iter_forwarder():
    from mxnet_tpu_torch import io_image

    with pytest.raises(TypeError):
        T.io.ImageRecordIter(no_such_argument=1)
    assert T.io.ImageRecordIter.__doc__ and io_image.ImageRecordIter


def test_maybe_device_feed(monkeypatch):
    X, Y = _arrays()
    base = T.io.NDArrayIter(X, Y, batch_size=4)
    monkeypatch.delenv("MXNET_FEED_DEPTH", raising=False)
    assert T.io.maybe_device_feed(base, [T.cpu()]) is base
    monkeypatch.setenv("MXNET_FEED_DEPTH", "2")
    feed = T.io.maybe_device_feed(base, [T.cpu()])
    assert isinstance(feed, T.io.DeviceFeedIter) and feed.depth == 2
    assert T.io.maybe_device_feed(feed, [T.cpu()]) is feed
    _same_stream(_batches(feed), _batches(T.io.NDArrayIter(X, Y, batch_size=4)))
    feed.close()
    # fit wraps its training iterator in the feed, and closes it
    net = T.sym.SoftmaxOutput(T.sym.FullyConnected(T.sym.Variable("data"),
                                                   num_hidden=4), name="softmax")
    mod = T.mod.Module(net, context=T.cpu())
    mod.fit(T.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1)
    assert mod.binded
