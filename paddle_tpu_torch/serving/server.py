"""HTTP front-end for :class:`~paddle_tpu_torch.serving.ServingEngine` —
port of ``paddle_tpu/serving/server.py`` (stdlib ``http.server`` on
daemon threads). Endpoints:

* ``POST /generate`` — JSON in, tokens out. Request body::

      {"prompt_ids": [1, 2, 3],          # required, token ids
       "max_new_tokens": 32,             # optional sampling params
       "temperature": 0.0, "top_k": 0, "top_p": 1.0,
       "eos_token_id": null,
       "adapter_id": 0,                  # LoRA tenant slot, 0 = base
       "deadline_s": null,               # optional budget, > 0
       "stream": false}

  A non-streaming response is one JSON object with ``token_ids``,
  ``ttft_ms``, ``latency_ms``, ``finish_reason`` and ``trace_id``. With
  ``"stream": true`` the response is chunked ``application/x-ndjson``:
  one ``{"token": id}`` line per generated token as it decodes, then a
  final ``{"done": true, ...}`` summary line carrying the ``trace_id``.
* ``GET /healthz`` — liveness plus the engine's ``stats()``, the
  rank/job/last-step-age probe fields (``observability.fleet``), and
  ``"status": "degraded"`` while the queue is at ``max_queue_depth``.
* ``GET /statusz`` — the SLO observatory page (HTML; ``?format=json``
  for the payload): burn rates, scheduler occupancy, top in-flight
  requests by KV block-seconds.
* ``GET /metrics`` / ``GET /metrics.json`` — the registry's
  Prometheus-text / JSON expositions (the ``serving_*`` families).
* ``GET /fleetz`` — the single-process fleet document
  (``observability.fleet.fleetz_snapshot``: identity, liveness and the
  goodput ledger's ``local_goodput``); a ``RouterServer`` answers it
  with its fleet.
* ``POST /debug/profile?seconds=N`` — a bounded on-demand
  ``torch.profiler`` window (``observability.profile``): 200 with the
  capture directory, 400 on a bad duration, 409 while one is live, 500
  when the capture cannot start (no card).

Graceful degradation: with ``max_queue_depth`` set, ``POST /generate``
sheds load with ``503 + Retry-After`` (counted in
``serving_rejections_total{reason="queue_full"}``) instead of queueing
unboundedly, and a request may carry ``"deadline_s"``: 400 when it is
not above 0, and ``504`` when the request cannot finish in time, which
also aborts it in the engine (its slot and KV blocks go back). The
queue depth counts the requests being submitted too (a submit waits for
the engine's lock while a step runs), so a burst arriving during one
step cannot all pass the check, as it could in the reference. The shed
policy is a seam (``_overloaded``, ``_shed_error``, ``shed_reason``)
that the fleet router's server overrides.

Distributed tracing: ``POST /generate`` parses an incoming W3C
``traceparent`` header (or mints a trace id), threads the id through
the engine — every span of the request carries it — and echoes a
``traceparent`` on EVERY response, errors included, plus ``trace_id`` in
the final NDJSON line and in every error body.
"""
from __future__ import annotations

import http.server
import json
import queue
import threading
from typing import Optional

__all__ = ["Server", "Handler"]


class _HTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer carrying a back-reference to the owning
    :class:`Server` so a module-level handler class (subclassable by the
    fleet router's front-end) can reach engine/policy state."""

    daemon_threads = True
    #: listen backlog: a burst of concurrent clients must reach the shed
    #: path (503), not a refused connection (the stdlib's default is 5)
    request_queue_size = 128

    def __init__(self, addr, handler_class, owner):
        self._owner = owner
        super().__init__(addr, handler_class)


class Handler(http.server.BaseHTTPRequestHandler):
    """The serving HTTP protocol, engine-agnostic: everything it needs
    from the owning :class:`Server` (engine, shed policy, timeouts)
    goes through ``self.srv`` — ``serving.fleet.server`` subclasses
    this and swaps the engine for a router."""

    protocol_version = "HTTP/1.1"

    @property
    def srv(self) -> "Server":
        return self.server._owner

    def log_message(self, *a):
        pass  # keep pytest/example output quiet

    # -- helpers ---------------------------------------------------
    def _json(self, code: int, payload: dict, headers=None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _html(self, body: bytes):
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None

    # -- routes ----------------------------------------------------
    def do_GET(self):  # noqa: N802 (stdlib API)
        from paddle_tpu_torch.observability import fleet, get_registry
        if self.path.startswith("/healthz"):
            stats = self.srv.engine.stats()
            depth = self.srv.max_queue_depth
            degraded = depth is not None and \
                stats.get("waiting", 0) >= depth
            self._json(200, {
                "status": "degraded" if degraded else "ok",
                **stats,
                # wedged-but-listening probe fields: rank/job
                # identity + age of the last engine step
                **fleet.healthz_fields(),
                **({"max_queue_depth": depth}
                   if depth is not None else {})})
        elif self.path.startswith("/fleetz"):
            self._json(200, fleet.fleetz_snapshot())
        elif self.path.startswith("/statusz"):
            from paddle_tpu_torch.observability import (
                requests as obs_requests)
            payload = obs_requests.statusz_payload(
                engine_stats=self.srv.engine.stats())
            if "format=json" in self.path:
                self._json(200, payload)
            else:
                self._html(obs_requests.render_statusz_html(
                    payload).encode())
        elif self.path.startswith("/metrics.json"):
            self._json(200, get_registry().to_json())
        elif self.path.startswith("/metrics"):
            body = get_registry().prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": "not found"})

    def handle_one_request(self):
        # client disconnects (timeout, ctrl-C, LB retry) are
        # routine, not errors: swallow the broken pipe instead
        # of letting socketserver dump a traceback per drop.
        # The request itself is aborted in the engine at the
        # point the disconnect is detected (_stream_response) or
        # when its deadline expires (_sync_response).
        try:
            super().handle_one_request()
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def do_POST(self):  # noqa: N802 (stdlib API)
        if self.path.startswith("/debug/profile"):
            self._profile_capture()
            return
        if not self.path.startswith("/generate"):
            self._json(404, {"error": "not found"})
            return
        # trace identity exists from the first byte: a rejected
        # request still hands the client an id it can bring to a
        # postmortem (headers parse before the body can fail)
        from paddle_tpu_torch.observability import (
            requests as obs_requests)
        trace_id = obs_requests.parse_traceparent(
            self.headers.get("traceparent")) \
            or obs_requests.new_trace_id()
        tp = {"traceparent":
              obs_requests.format_traceparent(trace_id)}
        body = self._read_body()
        if not isinstance(body, dict) or not isinstance(
                body.get("prompt_ids"), list):
            self._json(400, {"error": "body must be a JSON "
                             "object with prompt_ids",
                             "trace_id": trace_id}, headers=tp)
            return
        with self.srv._admit_lock:
            shed = self.srv._overloaded()
            if not shed:
                self.srv._admitting += 1
        if shed:
            # shed load instead of queueing unboundedly: the
            # client (or LB) retries against a recovering server
            from .engine import serving_metrics
            serving_metrics()["rejections"].inc(
                reason=self.srv.shed_reason)
            self._json(
                503, {"error": self.srv._shed_error(),
                      "trace_id": trace_id},
                headers={"Retry-After":
                         str(self.srv.retry_after_s), **tp})
            return
        try:
            sub = self._submit(body, trace_id, tp)
        finally:
            with self.srv._admit_lock:
                self.srv._admitting -= 1
        if sub is None:
            return
        handle, tokens_q, timeout = sub
        if tokens_q is not None:
            self._stream_response(handle, tokens_q, timeout, tp)
        else:
            self._sync_response(handle, timeout, tp)

    def _submit(self, body, trace_id, tp):
        """Validate the deadline and submit: ``(handle, token queue or
        None, timeout)``, or None once a 400 went out."""
        try:
            deadline_s = body.get("deadline_s")
            deadline_s = None if deadline_s is None \
                else float(deadline_s)
            if deadline_s is not None and deadline_s <= 0:
                raise ValueError("deadline_s must be > 0")
        except (TypeError, ValueError) as e:
            self._json(400, {"error": f"bad deadline_s: {e}",
                             "trace_id": trace_id}, headers=tp)
            return None
        timeout = self.srv.request_timeout \
            if deadline_s is None \
            else min(self.srv.request_timeout, deadline_s)
        stream = bool(body.get("stream", False))
        tokens_q = queue.Queue() if stream else None

        def on_token(req, tok):
            if tokens_q is not None:
                tokens_q.put(tok)

        try:
            handle = self.srv.engine.submit(
                body["prompt_ids"],
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                eos_token_id=body.get("eos_token_id"),
                on_token=on_token if stream else None,
                trace_id=trace_id,
                adapter_id=int(body.get("adapter_id", 0)))
        except (ValueError, TypeError, RuntimeError) as e:
            # TypeError: well-formed JSON, wrong field types
            # (e.g. "max_new_tokens": null) — still a 400
            self._json(400, {"error": str(e),
                             "trace_id": trace_id}, headers=tp)
            return None
        return handle, tokens_q, timeout

    def _profile_capture(self):
        """Bounded on-demand device-trace window. 400 on a
        garbage duration, 409 while a capture is already live
        (one at a time, process-wide)."""
        from urllib.parse import parse_qs, urlparse

        from paddle_tpu_torch.observability import profile as obs_profile

        qs = parse_qs(urlparse(self.path).query)
        raw = qs.get("seconds", ["2"])[0]
        try:
            seconds = obs_profile.bound_seconds(raw)
        except (TypeError, ValueError) as e:
            self._json(400, {"error": f"bad seconds: {e}"})
            return
        try:
            out_dir, seconds = obs_profile.start_timed_capture(
                seconds, label="serving")
        except obs_profile.CaptureBusy as e:
            self._json(409, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — the card refused to trace
            self._json(500, {"error": f"capture failed: {e}"})
            return
        self._json(200, {"status": "capturing",
                         "seconds": seconds,
                         "trace_dir": out_dir})

    def _abort(self, handle):
        """Deadline blown: cancel the engine-side request so
        abandoned work stops holding batch slots / KV blocks."""
        abort = getattr(self.srv.engine, "abort", None)
        if abort is not None:
            try:
                abort(handle.req_id, reason="client deadline")
            except Exception:
                pass  # best-effort; the 504 already went out

    def _sync_response(self, handle, timeout, tp):
        # getattr: duck-typed engines (tests, shims) may hand
        # back handles without the id fields
        ids = {"request_id": getattr(handle, "req_id", None),
               "trace_id": getattr(handle, "trace_id", None)}
        try:
            res = handle.result(timeout)
        except TimeoutError:
            from .engine import serving_metrics
            serving_metrics()["rejections"].inc(reason="deadline")
            self._json(504, {"error": "request timed out after "
                             f"{timeout}s", **ids}, headers=tp)
            self._abort(handle)
            return
        except RuntimeError as e:
            self._json(500, {"error": str(e), **ids}, headers=tp)
            return
        self._json(200, _result_json(res), headers=tp)

    def _stream_response(self, handle, tokens_q, timeout, tp):
        # a disconnect mid-stream aborts the engine-side request
        # too: decoding thousands of tokens into a dead socket
        # would hold a batch slot + KV blocks that live requests
        # are being 503-shed for
        try:
            self._stream_body(handle, tokens_q, timeout, tp)
        except (BrokenPipeError, ConnectionResetError):
            self._abort(handle)
            raise

    def _stream_body(self, handle, tokens_q, timeout, tp):
        import time as _time

        from paddle_tpu_torch.observability import trace

        t_stream0 = _time.perf_counter_ns()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in tp.items():
            self.send_header(k, v)
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

        # INACTIVITY deadline, reset on every token: a healthy
        # long generation streams past the timeout; only a
        # stalled/dead engine goes silent that long (a
        # per-request deadline_s tightens it per client)
        deadline = _time.monotonic() + timeout
        sent = 0
        # the chain's stream phase: HTTP delivery of the tokens
        # the engine's decode span produced. Emitted in the
        # finally so stalls and client disconnects — the very
        # requests a trace postmortem is opened for — still get
        # their span (outcome says which exit was taken).
        outcome = "disconnected"
        try:
            while True:
                if _time.monotonic() > deadline:
                    outcome = "stalled"
                    from .engine import serving_metrics
                    serving_metrics()["rejections"].inc(
                        reason="deadline")
                    chunk({"done": True,
                           "error": "stream stalled: no token for "
                           f"{timeout}s",
                           "trace_id": handle.trace_id})
                    self.wfile.write(b"0\r\n\r\n")
                    self._abort(handle)
                    return
                try:
                    tok = tokens_q.get(timeout=0.05)
                    chunk({"token": int(tok)})
                    sent += 1
                    deadline = _time.monotonic() + timeout
                    continue
                except queue.Empty:
                    pass
                if handle.wait(0):
                    # engine done: flush stragglers, then summary
                    while True:
                        try:
                            chunk({"token":
                                   int(tokens_q.get_nowait())})
                            sent += 1
                        except queue.Empty:
                            break
                    outcome = "ok"
                    try:
                        res = handle.result(0.1)
                        chunk({"done": True, **_result_json(res)})
                    except (TimeoutError, RuntimeError) as e:
                        outcome = "error"
                        chunk({"done": True, "error": str(e),
                               "trace_id": handle.trace_id})
                    self.wfile.write(b"0\r\n\r\n")
                    return
        finally:
            trace.span("serving", "stream", t_stream0,
                       _time.perf_counter_ns(),
                       args={"req": handle.req_id,
                             "trace": handle.trace_id,
                             "tokens": sent,
                             "outcome": outcome})


class Server:
    """Owns the engine's background loop and an HTTP listener.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``close()`` drains the engine and stops both threads.
    """

    #: the request handler class; fleet front-ends swap in a subclass
    handler_class = Handler
    #: rejection label for the 503 shed path (serving_rejections_total)
    shed_reason = "queue_full"

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 300.0,
                 max_queue_depth: Optional[int] = None,
                 retry_after_s: int = 1):
        self.engine = engine
        self.request_timeout = request_timeout
        self.max_queue_depth = max_queue_depth
        self.retry_after_s = int(retry_after_s)
        # requests past the shed check and not yet queued in the engine
        # (a submit waits for the engine's lock while a step runs): the
        # shed check counts them, or a burst arriving during one step
        # would all pass it
        self._admitting = 0
        self._admit_lock = threading.Lock()
        self._httpd = _HTTPServer((host, port), self.handler_class, self)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-torch-serving-http",
            daemon=True)

    # -- shed policy (overridden by the fleet router front-end) ------------
    def _overloaded(self) -> bool:
        """Queue depth (waiting requests and those being submitted) at
        the shed threshold? (None = never)"""
        if self.max_queue_depth is None:
            return False
        return self.engine.stats()["waiting"] + self._admitting \
            >= self.max_queue_depth

    def _shed_error(self) -> str:
        return ("server overloaded: scheduler queue exceeds "
                f"max_queue_depth {self.max_queue_depth}")

    def start(self) -> "Server":
        self.engine.start()
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self, drain: bool = True, stop_engine: bool = True):
        """Stop accepting, optionally finish in-flight work, stop the
        HTTP listener (and, unless ``stop_engine=False``, the engine
        loop — leave it running to rebind a new listener later)."""
        if self._thread.is_alive():
            # shutdown() blocks on serve_forever's ack — only safe when
            # the listener loop actually ran (close() before start()
            # must not hang)
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        if stop_engine:
            self.engine.shutdown(drain=drain)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc):
        self.close()


def _result_json(res: dict) -> dict:
    out = dict(res)
    ttft, lat = out.pop("ttft_s", None), out.pop("latency_s", None)
    out["ttft_ms"] = None if ttft is None else round(ttft * 1e3, 3)
    out["latency_ms"] = None if lat is None else round(lat * 1e3, 3)
    return out
