"""The port's repo tools (``mxnet_tpu_torch/tools/``) against the JAX
package's (``tools/``), on the CPU, at small sizes.

* ``gen_op_docs``: both registries rendered through both generators give
  the same ops, aliases, inputs and parameters (297 names);
* ``gen_api_docs``: for every module of the JAX tool's list, the port's
  public names and signatures against the JAX package's; every difference
  is in ``API_DIFFERENCES`` with its reason and its ``ROADMAP.md`` C item;
* ``c_api_coverage``: the port's libraries classify all 128 reference
  declarations, every one the JAX manifest calls implemented is exported
  or mapped, and the committed manifest is current;
* ``bandwidth``: ``get_shapes`` as the JAX tool's; one push+pull over
  ``local`` and ``device`` with two CPU contexts pulls the JAX package's
  values;
* ``bench_pipeline``: the dataset and its ``.rec`` byte for byte the JAX
  tool's; a small ladder emits the JAX tool's metric names, its native
  rungs on libjpeg;
* ``baseline_matrix``: DCGAN's quick run's losses from the same
  parameters and numpy draws as the JAX tool's: D's first record (before
  any update) within 1e-4, G's (after D's first update) within 1e-3, the
  last within 5 % (see the test); the fused iteration,
  eager, within 1e-5 of the classic loop over 3 steps (bitwise so far);
  the LSTM's quick perplexities within 1e-4 (relative) of the JAX tool's
  (both padding with 0, the label the metric ignores);
  one SSD step at batch 2 emits both records;
* ``tools/serving_report.py --json`` over the port's serving telemetry:
  each request's phases sum to its latency.

Every tool refuses to run on a card that is not there.
"""
import contextlib
import functools
import importlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch.base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A JAX tool module (``tools/<name>.py``) by import."""
    return importlib.import_module("tools." + name)


def _port_tool(name):
    return importlib.import_module("mxnet_tpu_torch.tools." + name)


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


# ---- gen_op_docs -------------------------------------------------------------
def _rows(text):
    return {m.group(1): m.group(0)
            for m in re.finditer(r"^\| `([^`]+)` \|.*$", text, re.M)}


def test_operator_index_matches_the_jax_tools():
    """Both registries through the port's generator, and the JAX
    registry through the JAX tool (its write caught): one row per op,
    the same inputs, parameters and aliases."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    gen = _port_tool("gen_op_docs")
    port_text, n_port = gen.render(treg)
    jax_via_port, n_jax = gen.render(jreg)
    caught = {}

    class _Sink(io.StringIO):
        def __exit__(self, *exc):
            caught["text"] = self.getvalue()
            return super().__exit__(*exc)

    jtool = _jax_tool("gen_op_docs")
    jtool.open = lambda path, mode="r": _Sink()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jtool.main()
    finally:
        del jtool.open
    assert len(treg._OP_REGISTRY) == len(jreg._OP_REGISTRY) == 297
    assert n_port == n_jax
    rows = _rows(port_text)
    assert rows == _rows(jax_via_port) == _rows(caught["text"])
    assert len(rows) == n_port


def test_doc_tools_write_their_files_and_refuse_a_missing_card(tmp_path, capsys):
    gen_op, gen_api = _port_tool("gen_op_docs"), _port_tool("gen_api_docs")
    out = str(tmp_path / "ops.md")
    assert gen_op.main(["--out", out, "--device", "cpu"]) == 0
    rec = _records(capsys.readouterr().out)[-1]
    assert rec["ops"] == 221 and rec["names"] == 297 and rec["device"] == "cpu"
    assert open(out).read().startswith("# Operator index")
    out = str(tmp_path / "api.md")
    assert gen_api.main(["--out", out, "--device", "cpu"]) == 0
    assert _records(capsys.readouterr().out)[-1]["modules"] == 39
    assert "## Parallel (mesh over CUDA positions)" in open(out).read()
    import torch

    if not torch.cuda.is_available():
        for tool in ("gen_op_docs", "gen_api_docs", "c_api_coverage",
                     "bandwidth", "bench_pipeline"):
            with pytest.raises(MXNetError, match="no CUDA device"):
                _port_tool(tool).main(["--out", out] if "docs" in tool else [])
        with pytest.raises(MXNetError, match="no CUDA device"):
            _port_tool("baseline_matrix").main(["dcgan", "--quick"])


# ---- gen_api_docs --------------------------------------------------------------
def test_committed_api_reference_is_what_gen_api_docs_renders(capsys, tmp_path):
    """``mxnet_tpu_torch/docs/api_python.md`` is the file ``gen_api_docs
    --device cpu`` writes from this tree (chip_smoke's phase 29(e) checks
    the card's rendering against it too)."""
    gen_api = _port_tool("gen_api_docs")
    out = str(tmp_path / "api.md")
    assert gen_api.main(["--out", out, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert open(out).read() == open(gen_api.OUT).read(), (
        "stale: run python -m mxnet_tpu_torch.tools.gen_api_docs --device cpu")


# (JAX module, name) -> (reason, ROADMAP C item)
API_DIFFERENCES = {
    ("mxnet_tpu.ndarray", "imperative_invoke"): (
        "the port adds ctx= (where an op with no array input makes its "
        "output)", "C35"),
    ("mxnet_tpu.ndarray", "NDArray.__init__"): (
        "a port NDArray wraps one torch tensor; ctx/base/index are the JAX "
        "package's device-array views", "C35"),
    ("mxnet_tpu.module", "BaseModule.data_names"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "BaseModule.data_shapes"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "BaseModule.get_input_grads"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "BaseModule.install_monitor"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "BaseModule.label_shapes"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "BaseModule.output_names"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "BaseModule.output_shapes"): (
        "abstract in the JAX package; every port module defines it", "C35"),
    ("mxnet_tpu.module", "DataParallelExecutorGroup.bind_exec"): (
        "an internal of Module: the port's binds over shared executors",
        "C35"),
    ("mxnet_tpu.module", "DataParallelExecutorGroup.decide_slices"): (
        "an internal of Module: the port slices by DataDesc", "C35"),
    ("mxnet_tpu.io", "NDArrayIter.__init__"): (
        "no wire= (the uint8 wire is ImageRecordIter's; C35) and seed= "
        "before the partition arguments", "C35"),
    ("mxnet_tpu.io", "WireSpec.decoded_desc"): (
        "the port's wire batches are NHWC with the batch axis first",
        "C35"),
    ("mxnet_tpu.io", "DeviceFeedIter.__init__"): (
        "depth defaults to 2 where the JAX package reads MXNET_FEED_DEPTH "
        "(maybe_device_feed reads it for fit)", "C35"),
    ("mxnet_tpu.initializer", "Initializer.__init__"): (
        "rng=: a seeded torch.Generator for the draws", "C35"),
    ("mxnet_tpu.initializer", "Uniform.__init__"): ("rng=, as Initializer", "C35"),
    ("mxnet_tpu.initializer", "Normal.__init__"): ("rng=, as Initializer", "C35"),
    ("mxnet_tpu.initializer", "Orthogonal.__init__"): ("rng=, as Initializer",
                                                       "C35"),
    ("mxnet_tpu.initializer", "Xavier.__init__"): ("rng=, as Initializer", "C35"),
    ("mxnet_tpu.initializer", "MSRAPrelu.__init__"): ("rng=, as Initializer",
                                                      "C35"),
    ("mxnet_tpu.initializer", "LSTMBias.__init__"): ("rng=, as Initializer",
                                                     "C35"),
    ("mxnet_tpu.initializer", "FusedRNN.__init__"): ("rng=, as Initializer",
                                                     "C35"),
    ("mxnet_tpu.context", "Context.__init__"): (
        "a port Context is a str subclass whose value is the torch device "
        "string (built by __new__)", "C15"),
    ("mxnet_tpu.context", "Context.jax_device"): (
        "a JAX device; the port's is Context.torch_device", "C15"),
    ("mxnet_tpu.random", "next_key"): (
        "a JAX PRNG key; the port draws from random.generator(device)",
        "C35"),
    ("mxnet_tpu.compileobs", "jit"): (
        "wraps jax.jit; the port's programs are CUDA-graph captures, nvcc "
        "builds and first runs (record_compile, Program)", "C26"),
    ("mxnet_tpu.compileobs", "raw_jit"): ("wraps jax.jit, as jit", "C26"),
    ("mxnet_tpu.compileobs", "live_ndarray_report"): (
        "named live_tensor_report in the port (torch tensors)", "C35"),
    ("mxnet_tpu.compileobs", "record_compile.__init__"): (
        "the port's takes the signature, graph key and digest of a capture",
        "C26"),
    ("mxnet_tpu.compileobs", "oom_guard.__init__"): (
        "inject=: the port's oom fault point", "C35"),
    ("mxnet_tpu.compile_cache", "enable"): (
        "wire_jax= wires jax's disk cache; the port caches nvcc libraries",
        "C35"),
    ("mxnet_tpu.compile_cache", "classify_compile"): (
        "hit=: the port knows whether a library came from the cache", "C35"),
    ("mxnet_tpu.compile_cache", "save_executable"): (
        "a library path in place of a jax executable", "C35"),
    ("mxnet_tpu.compile_cache", "load_executable"): (
        "dest=: where the cached library is copied", "C35"),
    ("mxnet_tpu.parallel", "SPMDTrainer.apply_grads"): (
        "the port's applies the gradients in its grad buffers", "C35"),
    ("mxnet_tpu.parallel", "SPMDTrainer.eval_step_fn"): (
        "a jitted eval function; the port's trainer has forward()", "C35"),
    ("mxnet_tpu.parallel", "SPMDTrainer.grad_step"): (
        "the inputs are the trainer's static buffers (a CUDA graph reads "
        "them), not an argument", "C35"),
    ("mxnet_tpu.parallel", "SPMDTrainer.init_params"): (
        "the port's trainer takes parameters the Module initialized",
        "C35"),
    ("mxnet_tpu.parallel", "SPMDTrainer.step"): (
        "the inputs are the trainer's static buffers, as grad_step", "C35"),
}


def _api_differences():
    """``{(jax module, name): what differs}`` over the JAX tool's list."""
    jtool = _jax_tool("gen_api_docs")
    ptool = _port_tool("gen_api_docs")
    assert [t for t, _, _ in jtool.MODULES][:-3] == \
        [t for t, _, _ in ptool.MODULES][:-3]

    def norm(s):
        return s.replace("mxnet_tpu_torch", "mxnet_tpu")

    def msig(cls, name):
        m = inspect.getattr_static(cls, name)
        if isinstance(m, property):
            return "(property)"
        return ptool.sig(getattr(cls, name))

    out = {}
    for (_, jpath, _), (_, tpath, _) in zip(jtool.MODULES, ptool.MODULES):
        assert tpath == jpath.replace("mxnet_tpu", "mxnet_tpu_torch", 1)
        jm, tm = importlib.import_module(jpath), importlib.import_module(tpath)
        jclasses, jfuncs = ptool.public_members(jm, "mxnet_tpu")
        for n, fn in jfuncs:
            got = getattr(tm, n, None)
            if got is None:
                out[(jpath, n)] = "missing"
            elif norm(ptool.sig(got)) != ptool.sig(fn):
                out[(jpath, n)] = "%s -> %s" % (ptool.sig(fn), ptool.sig(got))
        for n, cls in jclasses:
            tcls = getattr(tm, n, None)
            if tcls is None:
                out[(jpath, n)] = "class missing"
                continue
            for mn, ms, _ in ptool.class_methods(cls):
                key = (jpath, "%s.%s" % (n, mn))
                if not hasattr(tcls, mn):
                    out[key] = "missing"
                elif norm(msig(tcls, mn)) != ms:
                    out[key] = "%s -> %s" % (ms, msig(tcls, mn))
    return out


def test_api_matches_the_jax_package_but_for_the_listed_differences():
    diffs = _api_differences()
    unlisted = {k: v for k, v in diffs.items() if k not in API_DIFFERENCES}
    stale = sorted(k for k in API_DIFFERENCES if k not in diffs)
    assert not unlisted, "API differences with no reason: %s" % unlisted
    assert not stale, "listed differences that are gone: %s" % stale
    for reason, item in API_DIFFERENCES.values():
        assert reason and re.fullmatch(r"C\d+", item)


# ---- c_api_coverage ---------------------------------------------------------------
def test_c_api_coverage_classifies_the_reference(capsys):
    cov = _port_tool("c_api_coverage")
    want = re.findall(r"^\| `(MX\w+)` \| (\S+) \| (\w+) \|",
                      open(os.path.join(ROOT, "docs", "c_api_coverage.md")).read(),
                      re.M)
    assert [(n, h) for n, h, _ in want] == cov.REFERENCE
    assert len(cov.REFERENCE) == 128
    syms = cov.exported_symbols(cov.libraries())
    rows, counts = cov.classify(syms)
    assert len(rows) == 128 and sum(counts.values()) == 128
    for name, _, status in want:
        if status == "implemented":
            assert name in syms or name in cov.MAPPED, name
    # the committed manifest is the one these libraries give
    assert cov.main(["--check", "--device", "cpu"]) == 0, capsys.readouterr()
    rec = _records(capsys.readouterr().out)[-1]
    assert rec["up_to_date"] and rec["implemented"] == counts["implemented"]
    # an unclassified declaration fails
    cov_ref = list(cov.REFERENCE)
    try:
        cov.REFERENCE.append(("MXNoSuchCall", "c_api.h"))
        with pytest.raises(SystemExit, match="MXNoSuchCall"):
            cov.classify(syms)
    finally:
        cov.REFERENCE[:] = cov_ref


# ---- bandwidth --------------------------------------------------------------------
@pytest.mark.parametrize("network", ["resnet", "alexnet", "vgg", "inception-bn"])
def test_bandwidth_shapes_match_the_jax_tool(network):
    jtool = _jax_tool("bandwidth.measure")
    got = _port_tool("bandwidth").get_shapes(network, 1000)
    want = jtool.get_shapes(network, 1000)
    assert [(n, tuple(s)) for n, s in got] == [(n, tuple(s)) for n, s in want]


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_push_pull_with_two_contexts_pulls_the_jax_values(kv_type, capsys):
    """Two CPU contexts push different values into each key and pull the
    sum, in both packages; the tool's own run checks its sums."""
    shapes = _port_tool("bandwidth").get_shapes("alexnet", 10)[-4:]
    pulled = {}
    for mx in (J, T):
        kv = mx.kv.create(kv_type)
        ctxs = [mx.cpu(0), mx.cpu(1)]
        outs = []
        for i, (_, shape) in enumerate(shapes):
            kv.init(i, mx.nd.zeros(shape, ctx=ctxs[0]))
            vals = [mx.nd.array(np.full(shape, 1.5 + k + i, np.float32),
                                ctx=c) for k, c in enumerate(ctxs)]
            kv.push(i, vals)
            out = [mx.nd.zeros(shape, ctx=c) for c in ctxs]
            kv.pull(i, out)
            outs.append([o.asnumpy() for o in out])
        pulled[mx.__name__] = outs
    for i, (got, want) in enumerate(zip(pulled["mxnet_tpu_torch"],
                                        pulled["mxnet_tpu"])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.all(g == 2 * (1.5 + i) + 1)
    bw = _port_tool("bandwidth")
    assert bw.main(["--device", "cpu", "--kv-store", kv_type, "--network",
                    "alexnet", "--num-devices", "2", "--iters", "1",
                    "--test-gradient-ratio", "0.5"]) == 0
    text = capsys.readouterr().out
    rec = _records(text)[-1]
    assert text.startswith("kvstore=%s devices=2 " % kv_type)
    assert rec["values_checked"] and rec["bytes_moved_per_iter"] == \
        4 * rec["bytes"] and rec["gb_per_sec"] > 0


# ---- bench_pipeline ---------------------------------------------------------------
BENCH_PIPELINE_METRICS = {
    # tools/bench_pipeline.py's names, less its *_unavailable flags
    "host_cpu_count", "decode_pil_imgs_per_sec", "decode_cv2_imgs_per_sec",
    "recorditer_imgs_per_sec", "native_vs_python_b_speedup",
    "rec_device_put_imgs_per_sec", "kv_split_c_fp32", "kv_split_c_uint8",
    "kv_split_c_native", "native_c_vs_bprime", "rec_training_imgs_per_sec",
    "stage_p50s_fp32", "kv_split_d_fp32", "stage_p50s_uint8",
    "kv_split_d_uint8", "stage_p50s_uint8_feed", "kv_split_d_uint8_feed",
    "stage_p50s_uint8_native", "kv_split_d_uint8_native",
}


def test_pipeline_dataset_and_records_match_the_jax_tool(tmp_path):
    jtool, ptool = _jax_tool("bench_pipeline"), _port_tool("bench_pipeline")
    recs = {}
    for name, tool in (("jax", jtool), ("port", ptool)):
        d = tmp_path / name
        d.mkdir()
        img_dir, lst = tool.gen_dataset(str(d), 6, 32)
        with contextlib.redirect_stdout(io.StringIO()):
            recs[name] = tool.pack(str(d), img_dir, lst)
        assert sorted(os.listdir(img_dir)) == ["img_%05d.jpg" % i for i in range(6)]
    for suffix in (".rec", ".idx", ".lst"):
        a = open(recs["jax"][:-4] + suffix, "rb").read()
        b = open(recs["port"][:-4] + suffix, "rb").read()
        assert a == b, suffix
    for f in os.listdir(str(tmp_path / "jax" / "imgs")):
        assert open(str(tmp_path / "jax" / "imgs" / f), "rb").read() == \
            open(str(tmp_path / "port" / "imgs" / f), "rb").read()


def test_pipeline_ladder_emits_the_jax_metric_names(tmp_path, capsys):
    ptool = _port_tool("bench_pipeline")
    assert ptool.main(["--n", "32", "--size", "48", "--batch", "8", "--reps",
                       "2", "--batches", "2", "--device", "cpu", "--keep",
                       str(tmp_path)]) == 0
    recs = _records(capsys.readouterr().out)
    assert {r["metric"] for r in recs} == BENCH_PIPELINE_METRICS
    assert not [r for r in recs if r["metric"].endswith("_unavailable")]
    native = [r for r in recs if r.get("backend") == "native"]
    assert len(native) == 3 and {r["decoder"] for r in native} == {"libjpeg"}
    for r in recs:
        assert r["device"] == "cpu" and np.isfinite(r["value"])
    assert len([r for r in recs if r["metric"] == "recorditer_imgs_per_sec"]) == 5
    assert len([r for r in recs if r["metric"] == "rec_training_imgs_per_sec"]) == 4


# ---- baseline_matrix --------------------------------------------------------------
@pytest.fixture
def matrix():
    bm = _port_tool("baseline_matrix")
    bm.set_device("cpu")
    return bm


def _load_init(monkeypatch, name, params):
    """Make ``mx.init.<name>(...)`` load ``params`` in both packages."""
    monkeypatch.setattr(J.init, name, lambda *a, **k: J.init.Load(dict(params)))
    monkeypatch.setattr(T.init, name, lambda *a, **k: T.init.Load(dict(params)))


def test_dcgan_quick_losses_match_the_jax_tool(matrix, monkeypatch):
    with T.cpu():
        T.random.seed(0)
        ga, gx, da, dx = matrix.dcgan_initial(T, 16, T.cpu())
    _load_init(monkeypatch, "Normal", dict(ga, **gx, **da, **dx))
    with contextlib.redirect_stdout(io.StringIO()):
        with T.cpu():
            _, t_d, t_g = matrix.run_dcgan(quick=True)
        _, j_d, j_g = _jax_tool("baseline_matrix").run_dcgan(quick=True)
    assert len(t_d) == len(j_d) == 2
    # D's first record comes before any update: within 1e-4; G's first
    # follows D's first update (1e-3 of it), the last 10 steps
    np.testing.assert_allclose(t_d[0], j_d[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_g[0], j_g[0], rtol=1e-3, atol=0)
    # Adam's first updates are about lr * sign(gradient), and the
    # packages' first D gradients differ by ~1e-3 of their largest (float32
    # rounding through five BatchNorm'd deconvolutions: G's output differs
    # by ~3e-5), so gradient elements near zero take opposite signs and
    # their weights part by 2 * lr; after 10 steps the losses agree to a
    # few percent (2.3 % measured for D, 0.01 % for G)
    np.testing.assert_allclose([t_d[1], t_g[1]], [j_d[1], j_g[1]], rtol=0.05,
                               atol=0)


def test_fused_dcgan_step_is_the_classic_iteration(matrix):
    """Three iterations of the fused step, eager on the CPU, against the
    classic two-Module loop given the same z and real batch: both nets'
    parameters and BatchNorm statistics and the losses within 1e-5."""
    batch = 4
    with T.cpu():
        T.random.seed(3)
        params = matrix.dcgan_initial(T, batch, T.cpu())
        pool = matrix.real_pool(np.random.RandomState(0), batch)
        gan = matrix.FusedGAN(params, pool, batch, "cpu")
        gen_mod, dis_mod = matrix._dcgan_modules(T, batch, T.cpu())
        ga, gx, da, dx = params
        gen_mod.set_params({k: T.nd.array(v) for k, v in ga.items()},
                           {k: T.nd.array(v) for k, v in gx.items()})
        dis_mod.set_params({k: T.nd.array(v) for k, v in da.items()},
                           {k: T.nd.array(v) for k, v in dx.items()})
        ones, zeros = T.nd.ones((batch,)), T.nd.zeros((batch,))
        zs = []
        for s in range(3):
            sel = (3 * s + 1) % len(pool)
            gan.step(sel)
            zs.append(gan.z.clone())
            d, g = matrix.classic_gan_iteration(
                T, gen_mod, dis_mod, T.nd.array(gan.z.numpy()),
                T.nd.array(pool[sel]), ones, zeros)
            for mod, p, a in ((gen_mod, gan.gp, gan.ga), (dis_mod, gan.dp, gan.da)):
                args, auxs = mod.get_params()
                for k, v in args.items():
                    np.testing.assert_allclose(p[k].numpy(), v.asnumpy(), rtol=0,
                                               atol=1e-5, err_msg="%d %s" % (s, k))
                for k, v in auxs.items():
                    np.testing.assert_allclose(a[k].numpy(), v.asnumpy(), rtol=0,
                                               atol=1e-5, err_msg="%d %s" % (s, k))
            assert abs(float(gan.d_loss) - float(d.asnumpy())) <= 1e-5
            assert abs(float(gan.g_loss) - float(g.asnumpy())) <= 1e-5
    assert gan.t == 3 and gan.captures == 0
    assert not np.array_equal(zs[0].numpy(), zs[1].numpy())


def _lstm_params(mx, vocab, buckets):
    """Seeded parameters of the tool's LSTM LM, by name."""
    cell = mx.rnn.SequentialRNNCell()
    for i in range(2):
        cell.add(mx.rnn.LSTMCell(num_hidden=128, prefix="lstm_l%d_" % i))
    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=128, name="embed")
    outputs, _ = cell.unroll(max(buckets), inputs=embed, merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(outputs, shape=(-1, 128)),
                                 num_hidden=vocab, name="pred")
    shapes, _, _ = pred.infer_shape(data=(32, max(buckets)))
    out = {}
    for n, s in zip(pred.list_arguments(), shapes):
        if n != "data":
            rs = np.random.RandomState(zlib.crc32(n.encode()))
            out[n] = rs.uniform(-0.08, 0.08, s).astype(np.float32)
    return out


def test_lstm_quick_perplexities_match_the_jax_tool(matrix, monkeypatch):
    """The corpus is the port's copy of ``examples/lstm_bucketing.py``'s:
    equal to it when both read the same interpreter state. (A first pass
    imports every stdlib module, which sets submodules as attributes of
    packages read before them: a later pass reads more docstrings. So the
    two runs share one corpus.)"""
    buckets = (8, 16, 24, 32)
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import lstm_bucketing
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    matrix.stdlib_corpus(vocab_size=5000, max_sentences=10)
    corpus = matrix.stdlib_corpus(vocab_size=5000, max_sentences=1000)
    assert corpus == lstm_bucketing.stdlib_corpus(vocab_size=5000,
                                                  max_sentences=1000)
    monkeypatch.setattr(matrix, "stdlib_corpus", lambda **kw: corpus)
    monkeypatch.setattr(lstm_bucketing, "stdlib_corpus", lambda **kw: corpus)
    # the port's tool pads with 0, the label its metric ignores (the
    # reference example's choice); the JAX tool pads with -1, which its
    # Perplexity(ignore_label=0) counts: held here on the port's choice
    monkeypatch.setattr(J.rnn, "BucketSentenceIter", functools.partial(
        J.rnn.BucketSentenceIter, invalid_label=0))
    _load_init(monkeypatch, "Xavier", _lstm_params(T, 5000, buckets))
    with contextlib.redirect_stdout(io.StringIO()):
        np.random.seed(11)
        with T.cpu():
            t_ppl, _ = matrix.run_lstm(quick=True)
        np.random.seed(11)
        j_ppl, _ = _jax_tool("baseline_matrix").run_lstm(quick=True)
    assert len(t_ppl) == len(j_ppl) == 2 and t_ppl[1] < t_ppl[0]
    np.testing.assert_allclose(t_ppl, j_ppl, rtol=1e-4, atol=0)


def test_ssd_one_step_contract(matrix, capsys):
    """One device-resident SSD-300 step at batch 2: both records, finite,
    with the JAX tool's fields."""
    with T.cpu():
        rate, mean_ap, traj = matrix.run_ssd_overfit(steps=1, batch=2, n=2,
                                                     log_every=1)
    recs = _records(capsys.readouterr().out)
    assert [r["metric"] for r in recs] == ["ssd300_train_imgs_per_sec_resident",
                                           "ssd300_overfit_mAP@0.5_resident"]
    assert rate > 0 and 0 <= mean_ap <= 1 and len(traj) == 1
    assert all(np.isfinite(v) for v in traj[0])
    assert recs[0]["fused"] and {"batch", "loss_trajectory_[step,ce,smoothl1]",
                                 "device"} <= set(recs[0])


# ---- serving_report over the port's telemetry -----------------------------------
def test_serving_report_closes_over_the_ports_telemetry(tmp_path, monkeypatch):
    """An engine on the CPU with a pool too small for its load (so one
    request is preempted) writes ``MXNET_TELEMETRY_FILE``; the JAX
    package's ``tools/serving_report.py --json`` reads it: each request's
    phases sum to its latency, the preempted one shows replay."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import ServingConfig, ServingEngine

    sink = tmp_path / "serving.jsonl"
    monkeypatch.setenv("MXNET_TELEMETRY_FILE", str(sink))
    telemetry.reset()
    telemetry.enable()
    try:
        cfg = ServingConfig(vocab_size=23, num_layers=2, model_dim=32,
                            num_heads=2, ffn_dim=48, max_len=64, block_size=8,
                            num_blocks=7, max_batch=4, prefills_per_step=4)
        eng = ServingEngine(cfg, seed=3, device="cpu")
        long_a = eng.submit([1, 2, 3, 4, 5, 6, 7, 8] * 2, 20, request_id="long-a")
        short_b = eng.submit([9, 10, 11], 20, request_id="short-b")
        while not (long_a.finished() and short_b.finished()):
            eng.step()
        assert long_a.preemptions + short_b.preemptions > 0
    finally:
        telemetry.disable()
        telemetry.reset()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "serving_report.py"),
         "--json", str(sink)], capture_output=True, text=True, check=True,
        timeout=120)
    rep = json.loads(out.stdout)
    by_id = {r["request_id"]: r for r in rep["requests"]}
    assert set(by_id) == {"long-a", "short-b"}
    for r in by_id.values():
        assert r["state"] == "finished" and r["e2e_s"] > 0
        assert abs(r["phase_sum_s"] - r["e2e_s"]) <= max(1e-3, 0.05 * r["e2e_s"]), r
    preempted = [r for r in by_id.values() if r["preemptions"] > 0]
    assert preempted and all(r["phases"]["replay"] > 0 for r in preempted)
    assert rep["steps"] and max(s["occupancy"] for s in rep["steps"]) >= 1


def test_perplexity_reads_a_negative_label_as_the_jax_package():
    """C36: ``BucketSentenceIter`` pads labels with -1; with
    ``ignore_label=0`` a -1 counts, and numpy's index (the JAX package's,
    the reference's) reads the row's last column for it. The port read
    column 0 (found by the LSTM comparison above)."""
    rs = np.random.RandomState(5)
    prob = rs.dirichlet(np.ones(7), size=12).astype(np.float32)
    label = rs.randint(-1, 7, size=(3, 4)).astype(np.float32)
    label[0, 0] = -1
    got = {}
    for mx in (J, T):
        m = mx.metric.Perplexity(ignore_label=0)
        m.update([mx.nd.array(label, ctx=mx.cpu())],
                 [mx.nd.array(prob, ctx=mx.cpu())])
        got[mx.__name__] = m.get()[1]
    lab = label.reshape(-1).astype(int)
    keep = lab != 0
    want = np.exp(-np.log(prob[np.arange(12), lab][keep]).mean())
    np.testing.assert_allclose(got["mxnet_tpu_torch"], got["mxnet_tpu"], rtol=1e-6)
    np.testing.assert_allclose(got["mxnet_tpu_torch"], want, rtol=1e-6)


def test_filled_api_gaps_behave_as_the_jax_package():
    """The names PR 24 added where the API comparison found a plain
    omission, each against the JAX package's behaviour."""
    shapes, types = [("data", (2, 3)), ("label", (2,))], [("data", np.float16),
                                                          ("label", np.int32)]
    for t, j in ((None, None), (types, types)):
        got = [(d.name, tuple(d.shape), np.dtype(d.dtype))
               for d in T.io.DataDesc.get_list(shapes, t)]
        want = [(d.name, tuple(d.shape), np.dtype(d.dtype))
                for d in J.io.DataDesc.get_list(shapes, j)]
        assert got == want
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    cursors = []
    for mx in (T, J):
        it = mx.io.NDArrayIter(x, batch_size=2, last_batch_handle="roll_over")
        list(it)
        it.hard_reset()
        cursors.append((it.cursor, next(it).data[0].asnumpy().tolist()))
    assert cursors[0] == cursors[1]
    h = T.telemetry.Histogram("t", (0.1, 1.0))
    with h.time():
        pass
    assert h.count == 1
    data = T.sym.Variable("data")
    net = T.sym.FullyConnected(data, num_hidden=3, name="fc")
    with T.cpu():
        mod = T.mod.Module(net, label_names=None, context=T.cpu())
        it = T.io.NDArrayIter(x, batch_size=2)
        mod.bind(it.provide_data, for_training=False)
        mod.init_params(initializer=T.init.Uniform(0.1))
        whole = mod.predict(it).asnumpy()
        parts = np.concatenate([o[0].asnumpy() for o, _, _ in mod.iter_predict(it)])
        np.testing.assert_array_equal(parts, whole)
        assert mod.get_states(merge_multi_context=False) == []
        mod.set_states()
        upd = T.optimizer.get_updater(T.optimizer.create("sgd"))
        moved = upd.sync_state_context((T.nd.zeros((2,)), None), T.cpu())
        assert moved[1] is None and moved[0].context == T.cpu()
    with pytest.raises(DeprecationWarning):
        T.optimizer.create("sgd").set_lr_scale({})
    assert T.model.BatchEndParam is T.module.BatchEndParam
