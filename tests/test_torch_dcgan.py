"""DCGAN through two Modules, the port against the JAX package, on the CPU.

* the zoo's generator and discriminator serialize to the JAX package's
  JSON byte for byte;
* ``Deconvolution`` with ``adj`` (also past the stride, where torch's
  ``output_padding`` cannot take it), ``target_shape`` (which the JAX
  package's shape rule does not read) and groups: shapes, outputs and
  gradients against the JAX op (1e-5);
* two steps of ``examples/dcgan.py``'s loop (G forward; D on fake and on
  real with the gradients summed by hand; D update; D on fake with label
  1; G backward from D's input gradient; G update) at ngf = ndf = 4,
  nc 1, batch 2, from the same parameters (made by the JAX package's
  ``Normal(0.02)`` and carried over as numpy): both modules' parameters,
  BatchNorm statistics and Adam states within 1e-4 of the JAX package's;
* ``tools/dcgan.py`` at a tiny size on the CPU prints its JSON line with
  finite losses;
* a regression head through ``Module.fit``: ``LinearRegressionOutput`` is
  a loss, so the fit takes the fused path, and it ends where the classic
  path ends (1e-5).
"""
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu import models as JM
from mxnet_tpu.ops import registry as JR
from mxnet_tpu_torch.ops import registry as TR
from mxnet_tpu_torch.test_utils import Case, run_case

STEP_TOL = 1e-4
BATCH, Z, NGF, NC = 2, 8, 4, 1


@pytest.mark.parametrize("args", [(64, 3), (32, 1), (4, 1)])
def test_symbols_json_equal_jax(args):
    """Built under a fresh NameManager each (the unnamed Flatten takes
    the manager's count)."""
    ngf, nc = args
    jsons = []
    for mx, models in ((J, JM), (T, T.models)):
        with mx.name.NameManager():
            jsons.append((models.make_generator(ngf, nc).tojson(),
                          models.make_discriminator(ngf).tojson()))
    assert jsons[0] == jsons[1]


DECONV = {
    "adj": ({"kernel": (4, 4), "stride": (3, 3), "pad": (1, 2), "adj": (2, 1),
             "num_filter": 5}, (2, 3, 3, 4), (3, 5, 4, 4)),
    "adj_past_stride": ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 0),
                         "adj": (2, 3), "num_filter": 2, "no_bias": True},
                        (1, 2, 3, 3), (2, 2, 3, 3)),
    "target_shape": ({"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
                      "target_shape": (9, 9), "num_filter": 3},
                     (2, 4, 4, 4), (4, 3, 4, 4)),
    "groups": ({"kernel": (3, 3), "stride": (2, 2), "num_group": 2,
                "num_filter": 6, "dilate": (1, 2)}, (2, 4, 5, 3), (4, 3, 3, 3)),
    "1d": ({"kernel": (3,), "stride": (2,), "pad": (1,), "adj": (1,),
            "num_filter": 2}, (2, 3, 5), (3, 2, 3)),
}


@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution_matches_jax(case):
    attrs, dshape, wshape = DECONV[case]
    r = np.random.RandomState(1)
    inputs = [r.randn(*dshape).astype(np.float32), r.randn(*wshape).astype(np.float32)]
    if not attrs.get("no_bias"):
        inputs.append(r.randn(attrs["num_filter"]).astype(np.float32))
    c = Case("Deconvolution", attrs, inputs)
    shapes = []
    for reg in (JR, TR):
        op = reg.get_op("Deconvolution")
        shapes.append(op.infer_shape(op.canonicalize_attrs(attrs)[0],
                                     [dshape, None] + ([] if attrs.get("no_bias")
                                                       else [None]))[:2])
    assert shapes[0] == shapes[1]
    (j_out,), j_grad, _ = run_case(J, c, J.cpu())
    (t_out,), t_grad, _ = run_case(T, c, T.cpu())
    assert t_out.shape == j_out.shape == tuple(shapes[0][1][0])
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-5)
    for n in j_grad:
        np.testing.assert_allclose(t_grad[n], j_grad[n], rtol=1e-5, atol=1e-5)


def _modules(mx, gparams, dparams):
    ctx = mx.cpu()
    gen = mx.mod.Module(mx.models.make_generator(NGF, NC) if mx is T
                        else JM.make_generator(NGF, NC),
                        data_names=("rand",), label_names=None, context=ctx)
    gen.bind(data_shapes=[("rand", (BATCH, Z, 1, 1))], inputs_need_grad=True)
    dis = mx.mod.Module(mx.models.make_discriminator(NGF) if mx is T
                        else JM.make_discriminator(NGF),
                        data_names=("data",), label_names=("label",), context=ctx)
    dis.bind(data_shapes=[("data", (BATCH, NC, 64, 64))],
             label_shapes=[("label", (BATCH,))], inputs_need_grad=True)
    for mod, (args, auxs) in ((gen, gparams), (dis, dparams)):
        if args is None:
            mod.init_params(initializer=mx.init.Normal(0.02))
        else:
            mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in args.items()},
                            aux_params={k: mx.nd.array(v, ctx=ctx) for k, v in auxs.items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 2e-4, "beta1": 0.5})
    return gen, dis


def gan_step(mx, gen, dis, real, z):
    """One step of examples/dcgan.py's loop."""
    ctx = mx.cpu()
    gen.forward(mx.io.DataBatch([mx.nd.array(z, ctx=ctx)], None), is_train=True)
    fake = gen.get_outputs()[0]
    dis.forward(mx.io.DataBatch([fake], [mx.nd.zeros((BATCH,), ctx=ctx)]), is_train=True)
    dis.backward()
    grads_fake = [[g.copy() for g in grads] for grads in dis._exec_group.grad_arrays]
    dis.forward(mx.io.DataBatch([mx.nd.array(real, ctx=ctx)],
                                [mx.nd.ones((BATCH,), ctx=ctx)]), is_train=True)
    dis.backward()
    for gss, gfs in zip(dis._exec_group.grad_arrays, grads_fake):
        for gs, gf in zip(gss, gfs):
            gs += gf
    dis.update()
    dis.forward(mx.io.DataBatch([fake], [mx.nd.ones((BATCH,), ctx=ctx)]), is_train=True)
    dis.backward()
    gen.backward([dis.get_input_grads()[0]])
    gen.update()


def _state(mod):
    args, auxs = mod.get_params()
    updater = mod._updater
    if getattr(mod, "_fused", None) is not None:
        states = pickle.loads(mod._fused.get_states_bytes())
    else:
        states = pickle.loads(updater.get_states())
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()}, states)


def _flat(states):
    out = []
    for k in sorted(states):
        v = states[k]
        vs = v if isinstance(v, (list, tuple)) else [v]
        out.extend(np.asarray(getattr(x, "asnumpy", lambda: x)()) for x in vs)
    return out


def test_two_gan_steps_match_jax():
    r = np.random.RandomState(0)
    data = [(r.rand(BATCH, NC, 64, 64).astype(np.float32) * 2 - 1,
             r.randn(BATCH, Z, 1, 1).astype(np.float32)) for _ in range(2)]
    J.random.seed(0)
    jgen, jdis = _modules(J, (None, None), (None, None))
    start = [_state(m)[:2] for m in (jgen, jdis)]
    tgen, tdis = _modules(T, *start)
    for mx, gen, dis in ((J, jgen, jdis), (T, tgen, tdis)):
        for real, z in data:
            gan_step(mx, gen, dis, real, z)
    for what, jm, tm in (("generator", jgen, tgen), ("discriminator", jdis, tdis)):
        (ja, jx, js), (ta, tx, ts) = _state(jm), _state(tm)
        for k in ja:
            assert not np.allclose(ja[k], start[0 if jm is jgen else 1][0][k]) \
                or k.endswith("gamma"), (what, k, "did not move")
            np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=STEP_TOL,
                                       err_msg="%s %s" % (what, k))
        for k in jx:
            np.testing.assert_allclose(tx[k], jx[k], rtol=0, atol=STEP_TOL,
                                       err_msg="%s %s" % (what, k))
        assert sorted(ts) == sorted(js) and len(_flat(js)) == 2 * len(ja)
        for a, b in zip(_flat(ts), _flat(js)):
            np.testing.assert_allclose(a, b, rtol=0, atol=STEP_TOL, err_msg=what)


def _regression_fit(fused):
    sym = T.sym.LinearRegressionOutput(
        T.sym.FullyConnected(T.sym.Variable("data"), num_hidden=1, name="fc"),
        name="lro")
    r = np.random.RandomState(2)
    X = r.randn(32, 5).astype(np.float32)
    Y = (X @ r.randn(5, 1)).astype(np.float32).reshape(-1)
    it = T.io.NDArrayIter(X, Y, batch_size=8, label_name="lro_label")
    mod = T.mod.Module(sym, label_names=("lro_label",), context=T.cpu())
    old = os.environ.get("MXNET_MODULE_NO_FUSED")
    os.environ["MXNET_MODULE_NO_FUSED"] = "0" if fused else "1"
    try:
        T.random.seed(0)
        mod.fit(it, num_epoch=3, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": 0.05},
                initializer=T.init.Xavier(), eval_metric="mse")
    finally:
        if old is None:
            os.environ.pop("MXNET_MODULE_NO_FUSED")
        else:
            os.environ["MXNET_MODULE_NO_FUSED"] = old
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_regression_head_is_a_loss_and_fit_fuses():
    for name in ("LinearRegressionOutput", "MAERegressionOutput",
                 "LogisticRegressionOutput", "SVMOutput", "MakeLoss"):
        assert TR.get_op(name).is_loss and JR.get_op(name).is_loss, name
    fused, fp = _regression_fit(True)
    classic, cp = _regression_fit(False)
    assert fused._fused is not None and classic._fused is None
    for k in cp:
        np.testing.assert_allclose(fp[k], cp[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_tool_prints_its_record(capsys):
    import json

    from mxnet_tpu_torch.tools import dcgan

    assert dcgan.main(["--device", "cpu", "--batch-size", "2", "--num-epochs", "2",
                       "--steps-per-epoch", "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps"] == 6 and rec["finite"] and rec["nc"] == 1 and rec["ngf"] == 32
    assert rec["images_per_sec"] > 0 and rec["device"]["platform"] == "cpu"
    for k in ("d_loss", "g_loss"):
        assert set(rec[k]) == {"first_third", "last_third"}
