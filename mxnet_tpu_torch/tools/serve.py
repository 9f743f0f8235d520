"""Standing HTTP/JSON inference server over mxnet_tpu_torch.serving (the
port of the JAX package's ``tools/serve.py``: the same endpoints, status
codes, headers, drain and flags, without ``--cache-dir``).

The minimal front end for the paged-KV continuous-batching engine: one
engine-driver thread runs the step loop, HTTP handler threads submit
requests and block on their completion events — continuous batching means
N in-flight requests share every decode step. The engine runs on the card
(``--device``, default ``cuda``; ``--device cpu`` for the plain path):

    python -m mxnet_tpu_torch.tools.serve --num-layers 2 --model-dim 64 \\
        --vocab 256 --warmup &
    curl -d '{"tokens": [5, 6, 7], "max_new_tokens": 8}' \\
        http://127.0.0.1:8090/generate

Endpoints:
  POST /generate  {"tokens": [int...], "max_new_tokens": N,
                   "eos_id": optional int, "request_id": optional str,
                   "timeout_s": optional float}
                  -> {"tokens": [int...], "request_id": str,
                      "ttft_s": float, "latency_s": float,
                      "preemptions": int}
                  The request identity (X-Request-Id header or body
                  "request_id"; auto-assigned otherwise) threads through
                  every serving.request lifecycle event. The reply
                  echoes it in both the X-Request-Id header and the
                  body. Failure statuses are classified: 503 +
                  Retry-After when
                  the engine shed the request (queue full / draining /
                  restarting), 504 when its deadline expired, 500 when
                  the engine aborted under it.
  POST /drain     begin graceful drain: admission closes (new work shed
                  with 503), inflight requests finish up to
                  --drain-timeout, then the process exits 0. SIGTERM
                  triggers the same sequence.
  GET  /stats     engine snapshot (queue/blocks/latency/phases/SLO/
                  resilience/supervisor/compiles) as JSON
  GET  /metrics   Prometheus text exposition of the telemetry registry
  GET  /healthz   {"ok": true, "state": "serving"}; 503 with state
                  "draining" (load balancers: stop routing here) or
                  "dead" (engine driver gone)

Weights come from --checkpoint PREFIX --epoch N (a trained Transformer-LM
checkpoint, read with ``mx.model.load_checkpoint``; either package's files;
shapes must match the --num-layers/--model-dim/... flags) or, when
omitted, from the deterministic seeded initializer — byte-identical
across processes for a given --seed, and to the JAX package's.

--warmup captures every shape bucket's CUDA graph before listening, so
the first requests pay no capture wall (``stats()["compiles"]``).

--top renders mxtop-style live stat columns to stderr once a second:

    reqs  act wait |  kv blocks used/total  frag | tok/s  ttft p50/p99  lat p50/p99
"""
import argparse
import json
import sys
import threading
import time


def build_engine(args):
    import numpy as np

    from mxnet_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(
        vocab_size=args.vocab, num_layers=args.num_layers,
        model_dim=args.model_dim, num_heads=args.num_heads,
        ffn_dim=args.ffn_dim, max_len=args.max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_batch=args.max_batch,
        kv_dtype=np.dtype(args.kv_dtype),
        max_queue=getattr(args, "max_queue", None),
        default_timeout_ms=getattr(args, "default_timeout_ms", None))
    arg_params = None
    if args.checkpoint:
        from mxnet_tpu_torch import model as mxmodel

        _sym, arg_params, _aux = mxmodel.load_checkpoint(args.checkpoint,
                                                         args.epoch)
    return ServingEngine(cfg, arg_params=arg_params, seed=args.seed,
                         device=getattr(args, "device", None))


def build_supervisor(args):
    """Supervised engine: the factory rebuilds pool + engine after an
    abort, re-capturing every bucket's graph when --warmup is set (CUDA
    graphs do not outlive their engine)."""
    from mxnet_tpu_torch.serving import EngineSupervisor

    def factory():
        eng = build_engine(args)
        if getattr(args, "warmup", False):
            eng.warmup()
        return eng

    return EngineSupervisor(factory,
                            max_restarts=getattr(args, "max_restarts", None))


def _columns(stats):
    def ms(v):
        return "--" if v is None else "%.0f" % (v * 1000.0)

    slo = stats.get("slo") or {}
    goodput = slo.get("goodput")
    extra = ""
    prefix = stats.get("prefix") or {}
    if prefix.get("enabled") and prefix.get("lookups"):
        extra += " | pfx %.0f%%" % (100.0 * prefix.get("hit_rate", 0.0))
    spec = stats.get("spec") or {}
    if spec.get("enabled"):
        extra += " | acc %.0f%%" % (100.0 * spec.get("acceptance_rate", 0.0))
    res = stats.get("resilience") or {}
    if res.get("shed") or res.get("timed_out") or res.get("cancelled"):
        extra += " | shed %d to %d cx %d" % (res.get("shed", 0),
                                             res.get("timed_out", 0),
                                             res.get("cancelled", 0))
    sup = stats.get("supervisor") or {}
    if sup.get("restarts"):
        extra += " | rst %d" % sup["restarts"]
    if res.get("draining"):
        extra += " | DRAINING"
    return ("reqs %3d | act %3d wait %3d | kv %4d/%-4d frag %5d | "
            "%6.1f tok/s | ttft %s/%s ms | lat %s/%s ms | slo %s%s | steps %d"
            % (stats["active"] + stats["waiting"], stats["active"],
               stats["waiting"], stats["kv_blocks_used"],
               stats["kv_blocks_total"],
               int(stats.get("kv_blocks_frag_slots", 0)),
               stats["tokens_per_sec"], ms(stats["ttft_p50_s"]),
               ms(stats["ttft_p99_s"]), ms(stats["latency_p50_s"]),
               ms(stats["latency_p99_s"]),
               "--" if goodput is None else "%.0f%%" % (goodput * 100.0),
               extra, stats["steps"]))


def make_server(engine, host, port, driver=None, drain_cb=None):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import env_float
    from mxnet_tpu_torch.serving import (CANCELLED, FINISHED, TIMED_OUT,
                                         ServingOverloadError)

    # bound on a handler thread's done_event wait when the request has no
    # deadline of its own: a wedged or aborted engine must not hang every
    # open client connection forever
    handler_timeout_s = env_float("MXNET_SERVING_HANDLER_TIMEOUT_S", 300.0)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # quiet: telemetry is the log
            pass

        def _reply(self, code, body, ctype="application/json",
                   request_id=None, retry_after_s=None):
            data = body if isinstance(body, bytes) else \
                json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            if request_id is not None:
                self.send_header("X-Request-Id", request_id)
            if retry_after_s is not None:
                # RFC 9110 delta-seconds (integer, >= 1): the client's
                # backoff hint from the engine's occupancy/goodput gauges
                self.send_header("Retry-After",
                                 str(max(1, int(round(retry_after_s)))))
            self.end_headers()
            self.wfile.write(data)

        def _client_gone(self):
            """True when the client hung up: on a request-response
            connection with the request body fully read, a readable
            socket means EOF (or pipelined garbage we won't answer)."""
            import select
            import socket

            try:
                r, _w, _x = select.select([self.connection], [], [], 0)
                if not r:
                    return False
                return self.connection.recv(1, socket.MSG_PEEK) == b""
            except (OSError, ValueError):
                return True

        def do_GET(self):
            if self.path == "/healthz":
                # a dead engine driver means every /generate would hang
                # on its done_event — report it, don't claim healthy; a
                # draining server still answers inflight work but load
                # balancers must stop routing new requests here
                if driver is not None and not driver.is_alive():
                    self._reply(503, {"ok": False, "state": "dead"})
                elif getattr(engine, "draining", False):
                    self._reply(503, {"ok": False, "state": "draining"})
                else:
                    self._reply(200, {"ok": True, "state": "serving"})
            elif self.path == "/stats":
                self._reply(200, engine.stats())
            elif self.path == "/metrics":
                self._reply(200, telemetry.prometheus_text().encode(),
                            ctype="text/plain; version=0.0.4")
            else:
                self._reply(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path == "/drain":
                if drain_cb is None:
                    self._reply(501, {"error": "drain not wired (library "
                                               "embedding without a "
                                               "drain_cb)"})
                    return
                self._reply(202, {"draining": True})
                drain_cb()
                return
            if self.path != "/generate":
                self._reply(404, {"error": "unknown path %s" % self.path})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                tokens = body["tokens"]
                max_new = int(body["max_new_tokens"])
                eos_id = body.get("eos_id")
                timeout_s = body.get("timeout_s")
                # wire identity: header wins over body; engine assigns
                # one when the caller sent neither
                request_id = (self.headers.get("X-Request-Id")
                              or body.get("request_id"))
                req = engine.submit(tokens, max_new, eos_id=eos_id,
                                    request_id=request_id,
                                    timeout_s=timeout_s)
            except ServingOverloadError as e:
                # shed, not enqueued: tell the client when to come back
                self._reply(503, {"error": str(e), "reason": e.reason,
                                  "retry_after_s": e.retry_after_s},
                            retry_after_s=e.retry_after_s)
                return
            except (KeyError, TypeError, ValueError) as e:
                self._reply(400, {"error": str(e)})
                return
            except RuntimeError as e:   # engine aborted permanently
                self._reply(500, {"error": str(e)})
                return
            # bounded wait (never hang a client thread forever behind a
            # wedged or aborted engine): the request's own deadline plus
            # sweep slack when it has one, the handler bound otherwise —
            # and watch the connection so an abandoned stream is
            # cancelled instead of decoding to max_new_tokens for nobody
            if req.deadline_t is not None:
                bound = req.deadline_t + 5.0
            else:
                bound = time.time() + handler_timeout_s
            gone = False
            while not req.done_event.wait(0.1):
                if time.time() >= bound:
                    engine.cancel(req)
                    self._reply(504, {
                        "error": "request did not finish within the "
                                 "handler bound (engine wedged?)",
                        "state": req.state,
                        "request_id": req.request_id},
                        request_id=req.request_id)
                    return
                if self._client_gone():
                    gone = True
                    engine.cancel(req)
                    # no reply possible; wait briefly for the sweep to
                    # free the KV blocks, then release the handler thread
                    req.done_event.wait(5.0)
                    return
            if req.state == FINISHED:
                self._reply(200, {
                    "tokens": list(req.generated),
                    "request_id": req.request_id,
                    "ttft_s": round(req.first_token_t - req.arrival_t, 6),
                    "latency_s": round(req.finish_t - req.arrival_t, 6),
                    "preemptions": req.preemptions,
                }, request_id=req.request_id)
            elif req.state == TIMED_OUT:
                self._reply(504, {"error": req.error, "state": req.state,
                                  "tokens_done": len(req.generated),
                                  "request_id": req.request_id},
                            request_id=req.request_id)
            elif req.state == CANCELLED:
                if not gone:   # cancelled server-side (drain straggler)
                    self._reply(503, {"error": req.error,
                                      "state": req.state,
                                      "request_id": req.request_id},
                                request_id=req.request_id)
            else:   # FAILED: the engine aborted under this request
                self._reply(500, {"error": req.error, "state": req.state,
                                  "preemptions": req.preemptions,
                                  "request_id": req.request_id},
                            request_id=req.request_id)

    class Server(ThreadingHTTPServer):
        # a client burst SYNs far more connections at once than
        # socketserver's default backlog of 5: overflowed handshakes get
        # reset by the kernel and the client sees ECONNRESET before the
        # request ever reaches admission control — shedding is the
        # engine's job (503 + Retry-After), not the listen queue's
        request_queue_size = 128

    return Server((host, port), Handler)


def main(argv=None):
    from mxnet_tpu_torch.base import env_float, env_int

    ap = argparse.ArgumentParser(
        description="paged-KV continuous-batching LLM server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int,
                    default=env_int("MXNET_SERVING_PORT", 8090))
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--model-dim", type=int, default=64)
    ap.add_argument("--num-heads", type=int, default=2)
    ap.add_argument("--ffn-dim", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--kv-dtype", default="float32")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint prefix to serve (with --epoch)")
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0,
                    help="deterministic init seed when no checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every shape bucket's graph before "
                         "listening (first real requests pay no capture "
                         "wall)")
    ap.add_argument("--top", action="store_true",
                    help="render live stat columns to stderr")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-queue bound: submits past it are shed "
                         "with 503 + Retry-After (0 = unbounded; default "
                         "MXNET_SERVING_MAX_QUEUE)")
    ap.add_argument("--default-timeout-ms", type=int, default=None,
                    help="deadline for requests whose body sends no "
                         "timeout_s (0 = none; default "
                         "MXNET_SERVING_DEFAULT_TIMEOUT_MS)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="supervisor restart budget before the engine is "
                         "failed permanently (default "
                         "MXNET_SERVING_MAX_RESTARTS)")
    ap.add_argument("--drain-timeout", type=float,
                    default=env_float("MXNET_SERVING_DRAIN_S", 30.0),
                    help="seconds SIGTERM//drain waits for inflight work "
                         "before cancelling stragglers and exiting")
    args = ap.parse_args(argv)

    t0 = time.time()
    sup = build_supervisor(args)   # factory warms up when --warmup is set
    if args.warmup:
        captures = sum(c["count"] for c in
                       sup.engine.stats()["compiles"].values())
        print("warmup: %.1fs (%d bucket graphs captured)"
              % (time.time() - t0, captures), file=sys.stderr)

    stop = threading.Event()
    driver = threading.Thread(target=sup.run_loop, args=(stop,),
                              name="serving-engine-driver", daemon=True)
    driver.start()
    if args.top:
        def top():
            while not stop.wait(1.0):
                print(_columns(sup.stats()), file=sys.stderr)
        threading.Thread(target=top, name="serving-top",
                         daemon=True).start()

    httpd = None
    drained = threading.Event()

    def drain():
        """Graceful drain: close admission, flip /healthz to draining, finish inflight work up to
        the drain deadline, cancel stragglers, stop, exit 0."""
        if drained.is_set():
            return
        drained.set()
        sup.start_drain()
        print("draining: admission closed, waiting up to %.0fs for "
              "inflight work" % args.drain_timeout, file=sys.stderr)
        deadline = time.time() + args.drain_timeout
        while time.time() < deadline and sup.has_work():
            time.sleep(0.1)
        n = sup.cancel_all()
        if n:
            print("drain deadline: cancelled %d straggler(s)" % n,
                  file=sys.stderr)
            t_end = time.time() + 5.0
            while time.time() < t_end and sup.has_work():
                time.sleep(0.05)
        stop.set()
        if httpd is not None:
            httpd.shutdown()

    def drain_async():
        threading.Thread(target=drain, name="serving-drain",
                         daemon=True).start()

    import signal

    signal.signal(signal.SIGTERM, lambda _sig, _frm: drain_async())

    httpd = make_server(sup, args.host, args.port, driver=driver,
                        drain_cb=drain_async)
    eng = sup.engine
    print("serving on http://%s:%d (pool: %d blocks x %d slots)"
          % (args.host, args.port, eng.pool.num_usable,
             eng.pool.block_size), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        httpd.server_close()
    if drained.is_set():
        print("drained: exiting 0", file=sys.stderr)


if __name__ == "__main__":
    main()
