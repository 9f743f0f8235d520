"""The port's monitor, profiler and compile/memory observability
(``mxnet_tpu_torch/{monitor,profiler,compileobs}.py``), activation
recompute (``MXNET_BACKWARD_DO_MIRROR``) and the torn-checkpoint fault
points, held against the JAX package on the CPU.

Sizes are small: an MLP (8 → 16 → 4) and the tiny Transformer-LM of
``test_torch_training.py`` (vocab 23, 2 layers, d 32). Float32 on both
sides: statistics and gradients compare within 1e-5 relative (only the
summation order differs); the port's mirrored gradients equal its plain
ones bitwise (the same ops in the same order, run twice).
"""
import contextlib
import importlib
import json
import logging
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

B, N, DIN, HID, CLS = 4, 16, 8, 16, 4


def _mlp(pkg, dropout=0.0):
    x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=HID,
                               name="fc1")
    x = pkg.sym.Activation(x, act_type="relu", name="relu1")
    if dropout:
        x = pkg.sym.Dropout(x, p=dropout, name="drop1")
    x = pkg.sym.FullyConnected(x, num_hidden=CLS, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _params(seed=0):
    net = _mlp(tmx)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(data=(B, DIN))[0]))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, DIN).astype(np.float32),
            rng.randint(0, CLS, N).astype(np.float32))


def _fit(pkg, kvstore="local", num_epoch=1, module=None, **kw):
    X, Y = _data()
    mod = module or pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=B), num_epoch=num_epoch,
            kvstore=kvstore, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                        for n, v in _params().items()}, **kw)
    return mod


def _host(mod):
    return {n: a.asnumpy().copy() for n, a in mod.get_params()[0].items()}


# ---------------------------------------------------------------- monitor
def test_monitor_stats_match_jax():
    """fit(monitor=Monitor(2, pattern)) on the classic path: the same
    records, in the same order, each within 1e-5 relative."""
    got = {}
    for pkg in (tmx, jmx):
        mon = pkg.mon.Monitor(2, pattern="fc.*|relu.*")
        recs = got[pkg] = []
        mon.toc_print = lambda mon=mon, recs=recs: recs.extend(mon.toc())
        _fit(pkg, monitor=mon)
    t, j = got[tmx], got[jmx]
    assert [(s, n) for s, n, _ in t] == [(s, n) for s, n, _ in j]
    assert {s for s, _, _ in t} == {1, 3}           # steps 0 and 2
    names = {n for _, n, _ in t}
    assert {"fc1_output", "relu1_output", "fc2_output", "fc1_weight",
            "fc1_weight_grad"} <= names
    for (_, name, a), (_, _, b) in zip(t, j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, err_msg=name)


def test_fit_monitor_hands_over_from_the_fused_path(monkeypatch):
    """One fused epoch, then fit(monitor=...) on the same module: it leaves
    the fused path with its Adam moments and update count and ends where
    a classic run of both epochs ends."""
    mod = _fit(tmx, kvstore="device")
    assert mod._fused is not None and mod._fused.trainer.replays == 0
    mon = tmx.mon.Monitor(1, pattern="fc2_output")
    seen = []
    mon.toc_print = lambda: seen.extend(mon.toc())
    _fit(tmx, kvstore="device", module=mod, monitor=mon, begin_epoch=1,
         num_epoch=2)
    assert mod._fused is None and mod._monitor_installed
    assert [n for _, n, _ in seen] == ["fc2_output"] * (N // B)
    monkeypatch.setenv("MXNET_MODULE_NO_FUSED", "1")
    classic = _fit(tmx, kvstore="device", num_epoch=2)
    want = _host(classic)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n, v in _host(mod).items():
        np.testing.assert_allclose(v, want[n], rtol=0, atol=1e-5 * scale,
                                   err_msg=n)


# ---------------------------------------------------------------- profiler
def _profiled_script(pkg, mode, path):
    """profiler_example's steps: an executor's fwd+bwd, imperative ops and
    a short fit, under the profiler."""
    pkg.profiler.profiler_set_config(mode=mode, filename=str(path))
    pkg.profiler.profiler_set_state("run")
    try:
        ex = _mlp(pkg).simple_bind(ctx=pkg.cpu(), data=(B, DIN))
        ex.arg_dict["data"][:] = _data()[0][:B]
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        a = pkg.nd.array(np.eye(8, dtype=np.float32), ctx=pkg.cpu())
        a = pkg.nd.dot(a, a)
        a = a / pkg.nd.norm(a)
        a.wait_to_read()
        _fit(pkg)
    finally:
        pkg.profiler.profiler_set_state("stop")
    pkg.profiler.dump_profile()
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["all", "symbolic"])
def test_profiler_trace_has_the_jax_schema_and_spans(tmp_path, mode):
    traces = {pkg: _profiled_script(pkg, mode, tmp_path / ("%s.json" % i))
              for i, pkg in enumerate((tmx, jmx))}
    names = {}
    for pkg, trace in traces.items():
        assert set(trace) == {"traceEvents", "displayTimeUnit"}
        evs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
        for e in evs:
            assert set(e) - {"args"} == {"name", "cat", "ph", "ts", "dur",
                                         "pid", "tid"}, e
        key = [(e["tid"], e["ts"]) for e in evs]
        assert key == sorted(key)
        assert {m["args"]["name"] for m in meta} == {"compile"}
        cats = {e["cat"] for e in evs}
        assert ("operator" in cats) == (mode == "all"), (pkg, cats)
        names[pkg] = {e["name"] for e in evs
                      if e["cat"] not in ("operator", "compile")}
        steps = [e for e in evs if e["name"] == "fit.step"]
        assert [e["args"]["nbatch"] for e in steps] == list(range(N // B))
    assert names[tmx] == names[jmx]
    assert "executor_fwd_bwd[softmax]" in names[tmx]


def test_profiler_trace_dir_writes_a_torch_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_PROFILER_TRACE_DIR", str(tmp_path / "dev"))
    tmx.profiler.profiler_set_state("run")
    x = tmx.nd.array(np.ones((16, 16), np.float32), ctx=tmx.cpu())
    tmx.nd.dot(x, x).wait_to_read()
    tmx.profiler.profiler_set_state("stop")
    path = tmx.profiler.last_device_trace()
    assert os.path.dirname(path) == str(tmp_path / "dev")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------- compileobs
ZOO = [
    ("mlp", {}), ("lenet", {}), ("alexnet", {}), ("vgg", {"num_layers": 11}),
    ("vgg", {"num_layers": 16, "batch_norm": True}), ("googlenet", {}),
    ("inception_bn", {}), ("inception_v3", {}), ("inception_resnet_v2", {}),
    ("resnext", {"num_layers": 50, "image_shape": "3,224,224"}),
    ("resnet", {"num_layers": 50}), ("transformer_lm", {}),
    ("make_generator", {}), ("make_discriminator", {}),
    ("models.lstm_lm", {}), ("models.ssd", {}),
]


def _zoo_json(name, kwargs):
    with jmx.name.NameManager():
        if name.startswith("models."):
            mod = importlib.import_module("mxnet_tpu." + name)
            fn = getattr(mod, "get_symbol_train", None) or mod.get_symbol
        else:
            fn = getattr(importlib.import_module("mxnet_tpu.models"), name)
        net = fn(**kwargs)
        if not hasattr(net, "tojson"):  # a bucketing sym_gen: bucket 10's
            net = net(10)[0]
        return net.tojson()


@pytest.mark.parametrize("name,kwargs", ZOO,
                         ids=["%s-%d" % (z[0], i) for i, z in enumerate(ZOO)])
def test_symbol_digest_matches_jax_for_the_zoo(name, kwargs):
    js = _zoo_json(name, kwargs)
    got = tmx.compileobs.symbol_digest(tmx.sym.load_json(js))
    assert got == jmx.compileobs.symbol_digest(jmx.sym.load_json(js))
    assert re.fullmatch(r"[0-9a-f]{16}", got)


def _sig(*leaves):
    return tuple(leaves)


SIGS = [
    ("same", _sig(("[0]", "", (4, 8), "float32")),
     _sig(("[0]", "", (4, 8), "float32"))),
    ("batch", _sig(("[0]", "", (4, 8), "float32")),
     _sig(("[0]", "", (2, 8), "float32"))),
    ("seq_len", _sig(("[0]", "", (4, 8), "float32"), ("[1]", "", (3,), "int32")),
     _sig(("[0]", "", (4, 16), "float32"), ("[1]", "", (3,), "int32"))),
    ("image_axis", _sig(("[0]", "", (4, 3, 8, 8), "float32")),
     _sig(("[0]", "", (4, 1, 8, 8), "float32"))),
    ("dtype", _sig(("[0]", "", (4, 8), "float32")),
     _sig(("[0]", "", (4, 8), "bfloat16"))),
    ("rank", _sig(("[0]", "", (4, 8), "float32")),
     _sig(("[0]", "", (4, 8, 1), "float32"))),
    ("structure", _sig(("[0]", "", (4, 8), "float32")),
     _sig(("[0]", "", (4, 8), "float32"), ("[1]", "", (1,), "float32"))),
    ("renamed", _sig(("[0]", "", (4, 8), "float32")),
     _sig(("[x]", "", (4, 8), "float32"))),
    ("second_leaf", _sig(("[0]", "", (4, 8), "float32"), ("[1]", "", (4, 5), "float32")),
     _sig(("[0]", "", (4, 8), "float32"), ("[1]", "", (4, 6), "float32"))),
]


@pytest.mark.parametrize("case,old,new", SIGS, ids=[s[0] for s in SIGS])
def test_diff_signatures_matches_jax(case, old, new):
    assert (tmx.compileobs.diff_signatures(old, new)
            == jmx.compileobs.diff_signatures(old, new))


def _bucket_sym(pkg):
    x = pkg.sym.sum(pkg.sym.Variable("data"), axis=1)
    x = pkg.sym.FullyConnected(x, num_hidden=8, name="bfc1")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def test_bucketing_fit_records_a_seq_len_recompile():
    """Buckets 5 and 3 of one graph: each package's registry attributes
    the second bucket's first fwd+bwd to a seq_len change. (The JAX
    package also compiles the training forward as a program of its own,
    ``executor.fwd_train``, for the outputs; the port's training forward
    is half of its ``executor.fwd_bwd``.)"""
    got = {}
    rng = np.random.RandomState(0)
    batches = [(rng.rand(B, T, DIN).astype(np.float32),
                rng.randint(0, 8, B).astype(np.float32)) for T in (5, 3, 5, 3)]
    for pkg in (tmx, jmx):
        pkg.compileobs.reset()
        bmod = pkg.mod.BucketingModule(lambda k, pkg=pkg: (
            _bucket_sym(pkg), ("data",), ("softmax_label",)),
            default_bucket_key=5, context=pkg.cpu())
        bmod.bind([("data", (B, 5, DIN))], [("softmax_label", (B,))])
        bmod.init_params(pkg.init.One())
        bmod.init_optimizer(optimizer="sgd")
        for x, y in batches:
            bmod.forward_backward(pkg.io.DataBatch(
                [pkg.nd.array(x, ctx=pkg.cpu())], [pkg.nd.array(y, ctx=pkg.cpu())],
                bucket_key=x.shape[1],
                provide_data=[pkg.io.DataDesc("data", x.shape)],
                provide_label=[pkg.io.DataDesc("softmax_label", y.shape)]))
            bmod.update()
        got[pkg] = [(r["program"], r["cause"], r["old_shape"], r["new_shape"])
                    for r in pkg.compileobs.recompile_log()
                    if r["program"] != "executor.fwd_train"]
    assert got[tmx] == got[jmx] == [
        ("executor.fwd_bwd", "seq_len", [B, 5, DIN], [B, 3, DIN])]
    row = next(r for r in tmx.compileobs.program_table()
               if r["program"] == "executor.fwd_bwd")
    assert (row["compile_count"], row["run_count"], row["recompile_count"]) \
        == (2, 2, 1)


def test_oom_guard_reports_the_program_and_reraises(caplog):
    for pkg in (tmx, jmx):
        caplog.clear()
        with caplog.at_level(logging.ERROR), pkg.fault.inject("oom:"):
            with pytest.raises(pkg.base.MXNetError, match="RESOURCE_EXHAUSTED"):
                with pkg.compileobs.oom_guard("executor.fwd"):
                    pass
        assert "OOM at program 'executor.fwd'" in caplog.text, pkg
        # in a fit: the third step's fwd+bwd dies, and a later step runs
        caplog.clear()
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        with caplog.at_level(logging.ERROR), \
                pkg.fault.inject("oom:after=2,times=1"):
            with pytest.raises(pkg.base.MXNetError, match="RESOURCE_EXHAUSTED"):
                _fit(pkg, module=mod)
        assert "OOM at program 'executor.fwd_bwd'" in caplog.text, pkg
        X, Y = _data()
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(X[:B], ctx=pkg.cpu())],
            [pkg.nd.array(Y[:B], ctx=pkg.cpu())]))
        mod.update()
        assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()
    report = tmx.compileobs.dump_oom_report("x", MXNetError("out of memory"))
    assert {"program", "device_memory", "top_allocations", "programs"} \
        <= set(report)
    assert tmx.compileobs.is_oom_error(torch.cuda.OutOfMemoryError("boom"))


def test_registry_summary_and_compile_report(tmp_path, monkeypatch):
    from mxnet_tpu_torch.tools import compile_report

    sink = tmp_path / "run.jsonl"
    monkeypatch.setenv("MXNET_TELEMETRY_FILE", str(sink))
    tmx.telemetry.reset()
    tmx.telemetry.enable()
    try:
        tmx.compileobs.reset()
        _fit(tmx, kvstore="device")
        summary = tmx.compileobs.summary()
        tmx.telemetry.flush()
    finally:
        tmx.telemetry.disable()
    assert summary["programs"] >= 1 and summary["compile_count"] >= 1
    row = next(r for r in tmx.compileobs.program_table()
               if r["program"] == "fused.step")
    assert row["compile_count"] == 1 and row["run_count"] == N // B - 1
    assert row["arg_bytes"] > 0
    live = compile_report.render(compile_report.from_registry())
    offline = compile_report.analyze(compile_report.load_records([str(sink)]))
    assert "fused.step" in live
    assert any(p["program"] == "fused.step" for p in offline["programs"])
    assert compile_report.main([str(sink)]) == 0


def test_memory_analysis_on_the_cpu_gives_sizes_and_no_peak():
    ex = _mlp(tmx).simple_bind(ctx=tmx.cpu(), data=(B, DIN))
    ma = ex.memory_analysis()
    args = sum(a.asnumpy().nbytes for a in ex.arg_arrays)
    assert ma.argument_size_in_bytes == args
    # outputs (B, CLS) plus a gradient per argument that takes one
    grads = sum(a.asnumpy().nbytes for a, g in zip(ex.arg_arrays,
                                                    ex.grad_arrays)
                if g is not None)
    assert ma.output_size_in_bytes == B * CLS * 4 + grads
    assert ma.peak_memory_in_bytes == 0 and ma.temp_size_in_bytes == 0


# ---------------------------------------------------------------- mirror
LM = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48,
          seq_len=16)


def _lm_grads(pkg, mirror, monkeypatch, calls=None):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1" if mirror else "0")
    lm = importlib.import_module(pkg.__name__ + ".models.transformer_lm")
    with pkg.name.NameManager():
        sym = lm.get_symbol(**LM)
    T = LM["seq_len"]
    ex = sym.simple_bind(ctx=pkg.cpu(), data=(B, T), softmax_label=(B, T))
    rng = np.random.RandomState(0)
    for n, a in ex.arg_dict.items():
        if n not in ("data", "softmax_label"):
            a[:] = (rng.randn(*a.shape) * 0.1).astype(np.float32)
    X = rng.randint(0, LM["vocab_size"], (B, T)).astype(np.float32)
    ex.arg_dict["data"][:] = X
    ex.arg_dict["softmax_label"][:] = (X + 1) % LM["vocab_size"]
    ex.forward(is_train=True)
    ex.backward()
    return {n: g.asnumpy().copy() for n, g in ex.grad_dict.items()
            if g is not None and n not in ("data", "softmax_label")}


def test_mirror_gradients_equal_plain_and_jax(monkeypatch):
    from mxnet_tpu_torch.ops import attention as TA

    calls = {"fwd": 0}
    fwd = TA.flash_attention_forward

    def count(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    plain = _lm_grads(tmx, False, monkeypatch)
    monkeypatch.setattr(TA, "flash_attention_forward", count)
    mirrored = _lm_grads(tmx, True, monkeypatch)
    monkeypatch.undo()
    # backward recomputed the forward: K1 twice per layer in one step
    assert calls["fwd"] == 2 * LM["num_layers"]
    jax_mirrored = _lm_grads(jmx, True, monkeypatch)
    for n in plain:
        np.testing.assert_array_equal(mirrored[n], plain[n], err_msg=n)
        np.testing.assert_allclose(mirrored[n], jax_mirrored[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_mirror_over_dropout_replays_the_forward_masks(monkeypatch, kvstore):
    """A Dropout net fit with and without recompute, from one seed: bitwise
    equal, so the recompute drew the forward's masks (classic and fused)."""
    ends = []
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        torch.manual_seed(5)
        mod = tmx.mod.Module(_mlp(tmx, dropout=0.5), context=tmx.cpu())
        ends.append(_host(_fit(tmx, kvstore=kvstore, module=mod)))
    for n in ends[0]:
        np.testing.assert_array_equal(ends[1][n], ends[0][n], err_msg=n)


# ---------------------------------------------------------------- torn files
def _checkpoint(pkg, prefix, epoch):
    net = _mlp(pkg)
    args = {n: pkg.nd.array(v + epoch, ctx=pkg.cpu())
            for n, v in _params().items()}
    pkg.model.save_checkpoint(prefix, epoch, net, args, {})


@pytest.mark.parametrize("spec,torn", [
    ("checkpoint_write:crash_after_bytes=100", "symbol.json"),
    ("checkpoint_write:crash_after_bytes=100,after=1", "0002.params"),
    ("checkpoint_between_files:crash=1", None),
], ids=["torn_symbol", "torn_params", "between_files"])
def test_torn_checkpoints_are_skipped_as_in_jax(tmp_path, spec, torn):
    for pkg in (tmx, jmx):
        prefix = str(tmp_path / pkg.__name__ / "ck")
        os.makedirs(os.path.dirname(prefix))
        _checkpoint(pkg, prefix, 1)
        with pkg.fault.inject(spec), pytest.raises(pkg.fault.InjectedCrash):
            _checkpoint(pkg, prefix, 2)
        files = os.listdir(os.path.dirname(prefix))
        tmp = [f for f in files if ".tmp." in f]
        if torn is None:
            assert not tmp and "ck-0002.params" not in files
        else:
            assert len(tmp) == 1 and torn in tmp[0]
            assert os.path.getsize(os.path.join(os.path.dirname(prefix),
                                                tmp[0])) == 100
        _, args, _, epoch = pkg.model.load_latest_valid_checkpoint(prefix)
        assert epoch == 1
        np.testing.assert_array_equal(args["fc1_weight"].asnumpy(),
                                      _params()["fc1_weight"] + 1)
