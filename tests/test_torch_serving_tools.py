"""The port's serving tools and telemetry exposition against the JAX
package's, on the CPU.

``prometheus_text()``, ``dump()``, ``state_summary()`` and ``totals()``
render the same lines and values as the JAX registry for metric names a
test registers in both (only those are compared: the JAX registry holds
others); the JSON-lines sink (``{rank}`` expansion, events as they happen,
snapshots from the flusher) writes the records the JAX sink writes. The
serve twin (``mxnet_tpu_torch.tools.serve``) answers on ``127.0.0.1:0``
with ``--device cpu``: ``/generate`` returns the JAX server's tokens and
echoes ``X-Request-Id``, and ``/metrics``, ``/healthz``, ``/stats``,
``/drain`` and the error paths answer with the JAX server's statuses; it
serves a checkpoint through ``--checkpoint PREFIX --epoch N``.
``bench_serving`` runs on the CPU and prints a record with the JAX tool's
keys (read from its source) plus ``device``.
"""
import argparse
import ast
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mxnet_tpu import telemetry as JT
from mxnet_tpu_torch import telemetry as TT
from mxnet_tpu_torch.tools import bench_serving, serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48,
             max_len=32, block_size=8, num_blocks=64, max_batch=8,
             kv_dtype="float32", seed=3)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        "jax_tools_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _register(t, tag):
    """The same instruments, with the same values, in registry ``t``."""
    t.counter("serving.shed", test=tag).inc(3)
    t.gauge("serving.queue_depth", test=tag).set(2.5)
    h = t.histogram("serving.ttft_seconds", test=tag)
    for v in (0.0002, 0.003, 0.2, 40.0):
        h.observe(v)
    t.histogram("serving.tpot_seconds", test=tag)       # empty


def _mine(lines, tag):
    return [ln for ln in lines if 'test="%s"' % tag in ln]


def test_prometheus_and_snapshots_match_jax():
    tag = "prom"
    for t in (JT, TT):
        _register(t, tag)
    jtext, ttext = JT.prometheus_text(), TT.prometheus_text()
    assert _mine(ttext.splitlines(), tag) == _mine(jtext.splitlines(), tag)
    assert len(_mine(ttext.splitlines(), tag)) == 2 + 2 * 19
    for name in ("serving.shed", "serving.queue_depth",
                 "serving.ttft_seconds", "serving.tpot_seconds"):
        pname = "mxnet_" + name.replace(".", "_")
        for text in (jtext, ttext):
            assert "# TYPE %s " % pname in text
        jhelp = [ln for ln in jtext.splitlines()
                 if ln.startswith("# HELP %s " % pname)]
        assert jhelp == [ln for ln in ttext.splitlines()
                         if ln.startswith("# HELP %s " % pname)]
    jd, td = JT.dump(include_events=False), TT.dump(include_events=False)
    assert set(td) == set(jd)
    for kind in ("counters", "gauges", "histograms"):
        mine = {k: v for k, v in td[kind].items() if "test=%s" % tag in k}
        assert mine and mine == {k: v for k, v in jd[kind].items()
                                 if "test=%s" % tag in k}
    assert TT.state_summary(("serving.ttft",))["serving.ttft_seconds{test=prom}"] \
        == JT.state_summary(("serving.ttft",))["serving.ttft_seconds{test=prom}"]
    assert TT.totals("serving.shed")[1] >= 3


def _sink_records(t, tmp, tag):
    path = os.path.join(str(tmp), "tel-{rank}.jsonl")
    t.set_rank(7)
    try:
        t.start_flusher(path, interval_s=60)
        t.counter("serving.drains", test=tag).inc(2)
        t.event("serving.drain", engine=tag, waiting=1)
        t.stop_flusher()
    finally:
        t.set_rank(None)
    with open(os.path.join(str(tmp), "tel-7.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_jsonl_sink_writes_what_jax_writes(tmp_path):
    tag = "sink"
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jrec = _sink_records(JT, tmp_path / "jax", tag)
    trec = _sink_records(TT, tmp_path / "port", tag)
    assert [r["type"] for r in trec] == [r["type"] for r in jrec] \
        == ["event", "snapshot"]
    jev, tev = (dict(r[0], ts=0) for r in (jrec, trec))
    assert tev == jev and tev["rank"] == 7
    jsn, tsn = jrec[1], trec[1]
    assert set(tsn) == set(jsn) and tsn["rank"] == 7
    key = "serving.drains{test=%s}" % tag
    assert tsn["counters"][key] == jsn["counters"][key] == 2


def _args(**over):
    kw = dict(MODEL, checkpoint=None, epoch=1, warmup=False, max_queue=None,
              default_timeout_ms=None, max_restarts=None, device="cpu")
    kw.update(over)
    return argparse.Namespace(**kw)


class _Server:
    """One tool's server over its supervised engine, on a free port."""

    def __init__(self, tool, args):
        self.sup = tool.build_supervisor(args)
        self.stop = threading.Event()
        self.driver = threading.Thread(target=self.sup.run_loop,
                                       args=(self.stop,), daemon=True)
        self.driver.start()
        self.httpd = tool.make_server(self.sup, "127.0.0.1", 0,
                                      driver=self.driver,
                                      drain_cb=self.sup.start_drain)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def call(self, path, body=None, headers=None):
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        req = urllib.request.Request(
            "http://127.0.0.1:%d%s" % (self.port, path), data=data,
            headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def close(self):
        self.stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def test_serve_twin_answers_as_the_jax_server():
    servers = {"jax": _Server(_jax_tool("serve"), _args()),
               "port": _Server(serve, _args())}
    try:
        out = {}
        for name, s in servers.items():
            res = {}
            res["gen"] = s.call("/generate", {"tokens": [5, 6, 7],
                                              "max_new_tokens": 6},
                                {"X-Request-Id": "req-1"})
            res["gen2"] = s.call("/generate", {"tokens": [1, 2, 3, 4, 9, 11,
                                                          2, 8, 1],
                                               "max_new_tokens": 9})
            res["bad"] = s.call("/generate", {"max_new_tokens": 3})
            res["long"] = s.call("/generate", {"tokens": [1] * 30,
                                               "max_new_tokens": 9})
            res["stats"] = s.call("/stats")
            res["metrics"] = s.call("/metrics")
            res["health"] = s.call("/healthz")
            res["nope"] = s.call("/nope")
            res["drain"] = s.call("/drain", b"")
            res["health2"] = s.call("/healthz")
            res["shed"] = s.call("/generate", {"tokens": [1],
                                               "max_new_tokens": 1})
            out[name] = res
        j, t = out["jax"], out["port"]
        for key in j:
            assert t[key][0] == j[key][0], (key, t[key][0], j[key][0])
        for key in ("gen", "gen2"):
            assert json.loads(t[key][2])["tokens"] \
                == json.loads(j[key][2])["tokens"]
        assert t["gen"][1]["X-Request-Id"] == "req-1"
        assert json.loads(t["gen"][2])["request_id"] == "req-1"
        assert t["metrics"][1]["Content-Type"] == j["metrics"][1]["Content-Type"]
        assert b"mxnet_serving_generated_tokens" in t["metrics"][2]
        stats = json.loads(t["stats"][2])
        assert stats["completed"] == 2 and "compiles" in stats
        assert json.loads(t["health2"][2]) == json.loads(j["health2"][2])
        assert t["shed"][1].get("Retry-After") is not None
    finally:
        for s in servers.values():
            s.close()


def test_serve_twin_serves_a_checkpoint(tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ServingConfig, ServingEngine
    from mxnet_tpu_torch.serving import model as M

    cfg = ServingConfig(vocab_size=MODEL["vocab"], num_layers=2,
                        model_dim=32, num_heads=2, ffn_dim=48, max_len=32,
                        block_size=8, num_blocks=64, max_batch=8)
    params = M.random_params(cfg, seed=11)
    net = mx.models.transformer_lm(vocab_size=MODEL["vocab"], num_layers=2,
                                   model_dim=32, num_heads=2, ffn_dim=48,
                                   seq_len=32)
    prefix = str(tmp_path / "lm")
    mx.model.save_checkpoint(prefix, 3, net,
                             {n: mx.nd.array(v, ctx=mx.cpu())
                              for n, v in params.items()}, {})
    eng = serve.build_engine(_args(checkpoint=prefix, epoch=3))
    want = ServingEngine(cfg, arg_params=params, device="cpu")
    prompts = [[1, 2, 3], [7, 8]]
    assert eng.generate(prompts, 5) == want.generate(prompts, 5)


def _jax_record_keys():
    tree = ast.parse(open(os.path.join(ROOT, "tools",
                                       "bench_serving.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "rec"
                        for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record in tools/bench_serving.py")


def test_bench_serving_record_has_the_jax_keys(capsys):
    rec = bench_serving.main(
        ["--requests", "6", "--max-new", "4", "--num-layers", "2",
         "--model-dim", "32", "--vocab", "64", "--max-len", "64",
         "--max-batch", "8", "--spec-k", "2", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _jax_record_keys()
    assert len(want) > 20 and want <= set(rec)
    assert set(printed) == set(rec) and "device" in rec
    assert rec["device"]["platform"] == "cpu"
    assert rec["generated_tokens"] == 24 and rec["value"] > 0
    # warmup captured every bucket once; the timed window captured none
    n_pre, n_dec = 3, 4                 # max_len 64 / bs 16; max_batch 8
    assert rec["compile"]["programs"] == 4
    assert rec["compile"]["compile_count"] == 2 * (n_pre + n_dec) + n_dec
    assert rec["compile"]["recompile_count"] == 0
    assert rec["compile_stall_total_s"] == 0.0
    assert rec["spec"]["enabled"] and rec["spec"]["k"] == 2
    assert np.isfinite(rec["ttft_p99_s"])


def test_bench_serving_refuses_a_workload_past_max_len():
    with pytest.raises(SystemExit):
        bench_serving.main(["--max-new", "200", "--device", "cpu"])
