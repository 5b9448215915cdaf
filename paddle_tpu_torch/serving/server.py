"""HTTP front-end for :class:`~paddle_tpu_torch.serving.ServingEngine` —
port of ``paddle_tpu/serving/server.py`` (stdlib ``http.server`` on
daemon threads). Endpoints:

* ``POST /generate`` — JSON in, tokens out. Request body::

      {"prompt_ids": [1, 2, 3],          # required, token ids
       "max_new_tokens": 32,             # optional sampling params
       "temperature": 0.0, "top_k": 0, "top_p": 1.0,
       "eos_token_id": null,
       "stream": false}

  A non-streaming response is one JSON object with ``token_ids``,
  ``ttft_ms``, ``latency_ms`` and ``finish_reason``. With ``"stream":
  true`` the response is chunked ``application/x-ndjson``: one
  ``{"token": id}`` line per generated token as it decodes, then a
  final ``{"done": true, ...}`` summary line.
* ``GET /healthz`` — liveness plus the engine's ``stats()``.

The reference's ``/statusz``, ``/metrics``, ``/fleetz``,
``/debug/profile``, load shedding, per-request deadlines and trace
propagation are not ported yet.
"""
from __future__ import annotations

import http.server
import json
import queue
import threading
import time

__all__ = ["Server", "Handler"]


class _HTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer carrying a back-reference to its
    :class:`Server`."""

    daemon_threads = True

    def __init__(self, addr, handler_class, owner):
        self._owner = owner
        super().__init__(addr, handler_class)


class Handler(http.server.BaseHTTPRequestHandler):
    """The serving HTTP protocol; reaches the engine through ``self.srv``."""

    protocol_version = "HTTP/1.1"

    @property
    def srv(self) -> "Server":
        return self.server._owner

    def log_message(self, *a):
        pass  # keep test output quiet

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.startswith("/healthz"):
            self._json(200, {"status": "ok", **self.srv.engine.stats()})
        else:
            self._json(404, {"error": "not found"})

    def handle_one_request(self):
        # client disconnects are routine, not errors
        try:
            super().handle_one_request()
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def do_POST(self):  # noqa: N802 (stdlib API)
        if not self.path.startswith("/generate"):
            self._json(404, {"error": "not found"})
            return
        body = self._read_body()
        if not isinstance(body, dict) or not isinstance(
                body.get("prompt_ids"), list):
            self._json(400, {"error": "body must be a JSON object with "
                                      "prompt_ids"})
            return
        stream = bool(body.get("stream", False))
        tokens_q = queue.Queue() if stream else None
        try:
            handle = self.srv.engine.submit(
                body["prompt_ids"],
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                eos_token_id=body.get("eos_token_id"),
                on_token=(lambda req, tok: tokens_q.put(tok))
                if stream else None)
        except (ValueError, TypeError, RuntimeError) as e:
            self._json(400, {"error": str(e)})
            return
        if stream:
            try:
                self._stream_body(handle, tokens_q)
            except (BrokenPipeError, ConnectionResetError):
                # decoding into a dead socket would hold a slot and KV
                # blocks: abort the engine-side request too
                self.srv.engine.abort(handle.req_id, reason="disconnected")
                raise
        else:
            self._sync_response(handle)

    def _sync_response(self, handle):
        timeout = self.srv.request_timeout
        try:
            res = handle.result(timeout)
        except TimeoutError:
            self._json(504, {"error": f"request timed out after "
                                      f"{timeout}s",
                             "request_id": handle.req_id})
            self.srv.engine.abort(handle.req_id, reason="timeout")
            return
        except RuntimeError as e:
            self._json(500, {"error": str(e), "request_id": handle.req_id})
            return
        self._json(200, _result_json(res))

    def _stream_body(self, handle, tokens_q):
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

        # inactivity deadline, reset on every token: only a stalled
        # engine goes silent that long
        timeout = self.srv.request_timeout
        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() > deadline:
                chunk({"done": True,
                       "error": f"stream stalled: no token for {timeout}s"})
                self.wfile.write(b"0\r\n\r\n")
                self.srv.engine.abort(handle.req_id, reason="stalled")
                return
            try:
                chunk({"token": int(tokens_q.get(timeout=0.05))})
                deadline = time.monotonic() + timeout
                continue
            except queue.Empty:
                pass
            if handle.wait(0):
                # engine done: flush stragglers, then the summary
                while True:
                    try:
                        chunk({"token": int(tokens_q.get_nowait())})
                    except queue.Empty:
                        break
                try:
                    chunk({"done": True,
                           **_result_json(handle.result(0.1))})
                except (TimeoutError, RuntimeError) as e:
                    chunk({"done": True, "error": str(e)})
                self.wfile.write(b"0\r\n\r\n")
                return


class Server:
    """Owns the engine's background loop and an HTTP listener.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``close()`` drains the engine and stops both threads.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 300.0):
        self.engine = engine
        self.request_timeout = request_timeout
        self._httpd = _HTTPServer((host, port), Handler, self)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-torch-serving-http",
            daemon=True)

    def start(self) -> "Server":
        self.engine.start()
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self, drain: bool = True):
        """Stop accepting, optionally finish in-flight work, stop the
        listener and the engine loop."""
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
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
