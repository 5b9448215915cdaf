"""HTTP front-end for the fleet router — port of
``paddle_tpu/serving/fleet/server.py``.

:class:`RouterServer` is :class:`~paddle_tpu_torch.serving.server.Server`
with a :class:`~.router.FleetRouter` in the engine seat — the whole
``/generate`` protocol (sync + NDJSON streaming, traceparent echo,
deadlines) is inherited unchanged; what this module changes is the
policy around it:

* **Shed** — the 503 path fires only when EVERY live serving replica's
  queue is at the depth limit, and counts under
  ``serving_rejections_total{reason="fleet_saturated"}``, still with
  ``Retry-After`` and the traceparent echo.
* **GET /fleetz** — the router's aggregate view: fleet occupancy,
  per-replica health, headroom and prefix-cache rows, routing counters.
* **GET /statusz** — the SLO observatory page with a ``fleet`` section
  folded into the payload (HTML; ``?format=json`` for the payload).
"""
from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.serving.server import Handler, Server

__all__ = ["RouterServer", "RouterHandler"]


class RouterHandler(Handler):
    """Adds the fleet aggregate views; everything else inherits."""

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.startswith("/fleetz"):
            self._json(200, self.srv.engine.fleetz())
        elif self.path.startswith("/statusz"):
            from paddle_tpu_torch.observability import requests as obs_requests
            payload = obs_requests.statusz_payload(
                engine_stats=self.srv.engine.stats())
            payload["fleet"] = self.srv.engine.fleetz()
            if "format=json" in self.path:
                self._json(200, payload)
            else:
                self._html(obs_requests.render_statusz_html(
                    payload).encode())
        else:
            super().do_GET()


class RouterServer(Server):
    """``Server`` over a :class:`FleetRouter`: same constructor shape
    (``max_queue_depth`` becomes the PER-REPLICA saturation depth for
    the fleet-wide shed condition)."""

    handler_class = RouterHandler
    shed_reason = "fleet_saturated"

    def _overloaded(self) -> bool:
        return self.engine.saturated(self.max_queue_depth)

    def _shed_error(self) -> str:
        depth: Optional[int] = self.max_queue_depth
        return ("fleet saturated: every live replica's queue is at "
                f"max_queue_depth {depth} (or no replica is alive)")
