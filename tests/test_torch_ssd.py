"""SSD-300 in the port against the JAX package: the zoo symbols' JSON and
shapes, one training step of the real symbol at batch 2 on the CPU,
``MApMetric``, and ``tools/train_ssd.py``.

The step is held with the JAX package's ReLU masks and max-pooling
choices installed in the port (``mxnet_tpu_torch.test_utils.
installed_decisions``): in float32 the two packages' rounding lands a
few of the ~50 million ReLU inputs and pooling near-ties on the other
side of zero, and the gradient jumps there (``ROADMAP.md`` C6). The
matching targets are compared exactly, the outputs within 1e-4 of the
largest, each parameter's gradient within 1e-3 of its largest. The
detections are in score order: rows whose scores agree within the
tolerance may trade places.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu.models.ssd as JS
import mxnet_tpu_torch as T
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import ssd as TS
from mxnet_tpu_torch.test_utils import (decision_names, detections_match,
                                        installed_decisions)
from mxnet_tpu_torch.tools import train_ssd

OUT_TOL = 1e-4
GRAD_TOL = 1e-3
BATCH = 2


@pytest.mark.parametrize("builder", ["get_symbol_train", "get_symbol"])
def test_symbols_json_and_shapes_match_jax(builder):
    syms = []
    for mx, zoo in ((J, JS), (T, TS)):
        with mx.name.NameManager():
            syms.append(getattr(zoo, builder)(num_classes=20))
    assert syms[0].tojson() == syms[1].tojson()
    shapes = {"data": (BATCH, 3, 300, 300)}
    if builder == "get_symbol_train":
        shapes["label"] = (BATCH, 8, 5)
    got = syms[1].infer_shape(**shapes)
    assert got == syms[0].infer_shape(**shapes)
    want = ([(BATCH, 21, 8732), (BATCH, 8732 * 4), (BATCH, 8732), (BATCH, 8732, 6)]
            if builder == "get_symbol_train" else [(BATCH, 8732, 6)])
    assert got[1] == want


def _ssd_step(mx, zoo, names, install=None):
    """One training step of SSD-300 through ``mx`` at batch 2 from seeded
    parameters and the tool's synthetic set: (outputs, the values named
    ``names``, gradients)."""
    X, Y = train_ssd.synthetic_set(BATCH, 20)
    with mx.name.NameManager():
        net = zoo.get_symbol_train(num_classes=20)
    ints = net.get_internals()
    group = mx.sym.Group([net] + [ints[n] for n in names])
    exe = group.simple_bind(ctx=mx.cpu(), data=X.shape, label=Y.shape)
    r = np.random.RandomState(0)
    for n in group.list_arguments():
        a = exe.arg_dict[n]
        if n == "data":
            a[:] = X
        elif n == "label":
            a[:] = Y
        elif n.endswith("_scale"):
            a[:] = np.full(a.shape, 20, np.float32)
        elif n.endswith("_bias"):
            a[:] = np.zeros(a.shape, np.float32)
        else:
            fan_in = int(np.prod(a.shape[1:]))
            a[:] = (r.standard_normal(a.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    if install is None:
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward()
    else:
        with installed_decisions(group, install):
            outs = [o.asnumpy() for o in exe.forward(is_train=True)]
            exe.backward()
    grads = {n: exe.grad_dict[n].asnumpy() for n in group.list_arguments()
             if n not in ("data", "label")}
    return outs[:4], dict(zip(names, outs[4:])), grads


def test_train_step_matches_jax():
    with T.name.NameManager():
        names = decision_names(TS.get_symbol_train(num_classes=20))
    j_out, values, j_grad = _ssd_step(J, JS, names)
    t_out, _, t_grad = _ssd_step(T, TS, [], install=values)
    cls_prob, loc_loss, cls_target, det = range(4)
    np.testing.assert_array_equal(t_out[cls_target], j_out[cls_target])
    assert (t_out[cls_target] > 0).sum() > 0 and (t_out[cls_target] == 0).sum() > 0
    for k in (cls_prob, loc_loss):
        err = np.abs(t_out[k] - j_out[k]).max() / np.abs(j_out[k]).max()
        assert err <= OUT_TOL, (k, err)
    assert detections_match(t_out[det], j_out[det], OUT_TOL) is not None
    assert sorted(t_grad) == sorted(j_grad)
    for n in j_grad:
        err = np.abs(t_grad[n] - j_grad[n]).max() / max(np.abs(j_grad[n]).max(), 1e-30)
        assert err <= GRAD_TOL, (n, err)


def _detections(r, n_img, n_det, n_cls):
    det = -np.ones((n_img, n_det, 6), np.float32)
    for i in range(n_img):
        k = r.randint(n_det // 2, n_det)
        xy = r.uniform(0, 0.6, (k, 2))
        det[i, :k, 0] = r.randint(0, n_cls, k)
        det[i, :k, 1] = r.uniform(0, 1, k)
        det[i, :k, 2:4] = xy
        det[i, :k, 4:] = xy + r.uniform(0.05, 0.4, (k, 2))
    return det


def _labels(r, n_img, n_obj, n_cls, difficult):
    lab = -np.ones((n_img, n_obj, 6 if difficult else 5), np.float32)
    for i in range(n_img):
        k = r.randint(1, n_obj + 1)
        xy = r.uniform(0, 0.6, (k, 2))
        lab[i, :k, 0] = r.randint(0, n_cls, k)
        lab[i, :k, 1:3] = xy
        lab[i, :k, 3:5] = xy + r.uniform(0.05, 0.4, (k, 2))
        if difficult:
            lab[i, :k, 5] = r.rand(k) < 0.2
    return lab


@pytest.mark.parametrize("kw", [{}, {"voc07": False},
                                {"class_names": ["a", "b", "c", "d"], "score_thresh": 0.3},
                                {"use_difficult": True, "ovp_thresh": 0.3},
                                {"pred_idx": 1}])
def test_map_metric_matches_jax(kw):
    r = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        lab = _labels(r, 4, 5, 4, difficult="use_difficult" in kw or not kw)
        det = _detections(r, 4, 30, 4)
        # a detection that is a ground-truth box, so that some match
        det[:, 0, 0], det[:, 0, 2:] = lab[:, 0, 0], lab[:, 0, 1:5]
        batches.append((lab, det))
    got = []
    for mx in (J, T):
        m = mx.metric.MApMetric(**kw)
        for lab, det in batches:
            preds = [mx.nd.array(det, ctx=mx.cpu())]
            if kw.get("pred_idx"):
                preds.insert(0, mx.nd.array(np.zeros(1), ctx=mx.cpu()))
            m.update([mx.nd.array(lab, ctx=mx.cpu())], preds)
        got.append(m.get())
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-12)
    assert np.isfinite(got[1][1]).any()


def test_map_metric_by_name():
    assert isinstance(T.metric.create("map"), T.metric.MApMetric)


def test_train_ssd_tool_on_cpu(capsys):
    rc = train_ssd.main(["--device", "cpu", "--batch-size", "2", "--num-examples", "4",
                         "--evaluate"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps"] == 2 and rec["fused"] and rec["device"]["platform"] == "cpu"
    assert np.isfinite(rec["train"]["CrossEntropy"]) and np.isfinite(rec["train"]["SmoothL1"])
    assert np.isfinite(rec["mAP"])


def test_train_ssd_data_dir_with_rec_raises(tmp_path):
    """An empty train.rec raises; detection records train through
    ImageDetRecordIter, augmented, and are read in order for --evaluate."""
    (tmp_path / "train.rec").write_bytes(b"")
    args = train_ssd.parse_args(["--device", "cpu", "--data-dir", str(tmp_path)])
    with pytest.raises(MXNetError, match="holds no records"):
        train_ssd.get_iter(args)
    w = T.recordio.MXRecordIO(str(tmp_path / "train.rec"), "w")
    r = np.random.RandomState(0)
    for i in range(4):
        img = (r.rand(40, 50, 3) * 255).astype(np.uint8)
        label = np.array([2, 5, i % 3, 0.1, 0.2, 0.6, 0.7], np.float32)
        w.write(T.recordio.pack_img(T.recordio.IRHeader(0, label, i, 0), img))
    w.close()
    args = train_ssd.parse_args(["--device", "cpu", "--data-dir", str(tmp_path),
                                 "--batch-size", "2", "--data-nthreads", "1"])
    for shuffle in (True, False):
        it = train_ssd.get_iter(args, shuffle=shuffle)
        batches = list(it)
        it.close()
        assert type(it).__name__ == "ImageDetRecordIter" and len(batches) == 2
        assert batches[0].data[0].shape == (2, 3, 300, 300)
        assert batches[0].label[0].shape == (2, 32, 5)
    first = batches[0].label[0].asnumpy()
    np.testing.assert_allclose(first[0, 0], [0, 0.1, 0.2, 0.6, 0.7], rtol=1e-6)
    assert (first[0, 1:] == -1).all()


def test_synthetic_set_is_the_examples():
    """The tool's set equals examples/train_ssd.py's get_iter data."""
    X, Y = train_ssd.synthetic_set(6, 20)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(X, rng.rand(6, 3, 300, 300).astype(np.float32))
    assert Y.shape == (6, 8, 5) and (Y[:, 0, 0] >= 0).all() and (Y[:, 3:] == -1).all()
