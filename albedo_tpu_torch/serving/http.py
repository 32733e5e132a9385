"""HTTP plane: routes, input hardening, load shedding, graceful shutdown.

Port of ``albedo_tpu/serving/http.py``: the same routes, status codes and
JSON bodies. ``POST /admin/reload`` answers 503 ("no hot-swap manager
configured"), as the JAX server does without a manager: the hot-swap
manager is not ported yet.

Reference parity: the Django web layer — ``app/views.py`` + ``app/urls.py``
(index page) and ``app/admin.py`` (list/search screens) — extended with the
online engine's operational surface:

  GET  /                       index page (route listing)
  GET  /healthz                liveness probe (also /healthz/live)
  GET  /healthz/ready          readiness: 503 until a VALIDATED model
                               generation is promoted; JSON reports the
                               generation, batcher warmth, breaker states
  GET  /metrics                Prometheus text exposition (0.0.4)
  GET  /recommend/<user_id>?k=30&exclude_seen=1&deadline_ms=250   engine top-k
  GET  /admin/repos?q=&limit=  repo list/search
  GET  /admin/users?q=&limit=  user list/search
  POST /admin/reload[?artifact=]                  503: no hot-swap manager
  POST /cache/invalidate[?user_id=]               explicit cache invalidation

Hardening (held against the JAX server in ``tests/test_torch_serving_http.py``):

- ``k``/``limit`` are clamped to sane ranges (negative, zero, and absurd
  values used to flow straight into ``ALSModel.recommend``/``df.head``);
  non-integer values are a 400, not a traceback.
- ``q`` is length-capped before it reaches pandas.
- Unexpected exceptions return a 500 **with a JSON body** — the seed's
  handler only caught ValueError/KeyError and left the socket to die.
- Queue overflow and deadline sheds (``QueueOverflow`` and its
  ``DeadlineExceeded`` subclass) return 429 + ``Retry-After`` priced from
  the batcher's observed throughput; ``deadline_ms`` opts a request into
  deadline-aware admission control.
- A submit racing a hot-swap retirement (``BatcherClosed``) is retried
  inside the service against the live generation; one escaping anyway is a
  503 + ``Retry-After``, not a 500 — the engine is mid-transition, not
  broken.

``serve()`` returns a :class:`ServerHandle`: context-manager friendly,
idempotent ``shutdown()`` that stops accepting, joins the server thread, and
drains the service's batcher — tests never leak threads.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from albedo_tpu_torch.serving.batcher import BatcherClosed, QueueOverflow
from albedo_tpu_torch.serving.service import RecommendationService

log = logging.getLogger(__name__)

MAX_LIMIT = 500
MAX_QUERY_CHARS = 256

_INDEX_HTML = """<!doctype html>
<html><head><title>Albedo-TPU</title></head>
<body><h1>Albedo-TPU</h1>
<p>A github repo recommender, served from trained artifacts.</p>
<ul>
<li>GET /recommend/&lt;user_id&gt;?k=30&amp;exclude_seen=1&amp;deadline_ms=250</li>
<li>GET /admin/repos?q=tensor&amp;limit=20</li>
<li>GET /admin/users?q=vinta&amp;limit=20</li>
<li>GET /metrics</li>
<li>GET /healthz (liveness) · /healthz/ready (readiness)</li>
<li>POST /admin/reload?artifact=&lt;name&gt;</li>
<li>POST /cache/invalidate?user_id=123</li>
</ul></body></html>"""


class BadRequest(ValueError):
    """Client error with a message safe to echo back."""


def _int_param(q: dict, name: str, default: int, lo: int, hi: int) -> int:
    """Parse + clamp an integer query param; junk is a 400, extremes clamp."""
    raw = q.get(name, [None])[0]
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        raise BadRequest(f"{name} must be an integer, got {raw!r}") from None
    return max(lo, min(value, hi))


def _str_param(q: dict, name: str, default: str = "") -> str:
    return q.get(name, [default])[0][:MAX_QUERY_CHARS]


def _make_handler(service: RecommendationService):
    metrics = service.metrics

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200, extra: dict | None = None) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json", extra)

        _KNOWN_ROUTES = frozenset(
            {"healthz", "metrics", "recommend", "admin", "cache"}
        )

        def _route(self) -> str:
            """Metrics label for the request path — normalized to the known
            route set so a URL scanner can't mint unbounded counter children
            (label cardinality = len(_KNOWN_ROUTES) + 2, forever)."""
            parts = [p for p in urlparse(self.path).path.split("/") if p]
            if not parts:
                return "index"
            return parts[0] if parts[0] in self._KNOWN_ROUTES else "other"

        def _dispatch(self, method: str) -> None:
            t0 = time.perf_counter()
            code = 500
            try:
                code = self._handle(method)
            except BadRequest as e:
                code = 400
                self._json({"error": str(e)}, code=400)
            except QueueOverflow as e:
                # Load shedding (queue overflow, deadline shed, adaptive
                # admission, or the brownout shed tier): tell the client when
                # to come back — priced from throughput, the adaptive limit,
                # and the brownout level — and WHICH tier shed it, instead of
                # letting it hang. A 429 here is the overload design working.
                code = 429
                retry_after = getattr(e, "retry_after_s", None) or 1.0
                body = {"error": str(e)}
                tier = getattr(e, "tier", None)
                if tier is not None:
                    body["brownout"] = {
                        "level": getattr(e, "level", None), "tier": tier,
                    }
                self._json(
                    body, code=429,
                    extra={"Retry-After": str(max(1, round(retry_after)))},
                )
            except BatcherClosed:
                # The request raced a hot-swap retirement past the service's
                # own retry: transient by construction — the next generation
                # is live. 503 + come-right-back, never a 500.
                code = 503
                self._json(
                    {"error": "engine generation transition in progress"},
                    code=503, extra={"Retry-After": "1"},
                )
            except BrokenPipeError:
                code = 499  # client went away mid-response; nothing to send
            except Exception as e:  # noqa: BLE001 — 500-with-JSON, never a hung socket
                log.exception("unhandled error serving %s", self.path)
                code = 500
                try:
                    self._json({"error": f"internal error: {type(e).__name__}"}, code=500)
                except OSError:
                    pass
            finally:
                metrics.requests.inc(route=self._route(), status=str(code))
                metrics.request_latency.observe(time.perf_counter() - t0)

        def _handle(self, method: str) -> int:
            url = urlparse(self.path)
            q = parse_qs(url.query)
            parts = [p for p in url.path.split("/") if p]

            if method == "POST":
                if parts[:2] == ["admin", "reload"]:
                    artifact = _str_param(q, "artifact", "")
                    # Bare artifact file names only (a path from the network
                    # must never reach an unpickler); junk is a 400 whether
                    # or not reloads are configured, as in the JAX server.
                    if artifact and (
                        "/" in artifact or "\\" in artifact
                        or artifact.startswith(".")
                    ):
                        raise BadRequest(
                            "artifact must be a bare artifact file name"
                        )
                    # The hot-swap manager is not ported: the JAX server's
                    # answer when it has none.
                    self._json({"error": "no hot-swap manager configured"}, code=503)
                    return 503
                if parts[:2] == ["cache", "invalidate"]:
                    raw_uid = _str_param(q, "user_id", "")
                    if raw_uid:
                        try:
                            uid = int(raw_uid)
                        except ValueError:
                            raise BadRequest(f"user_id must be an integer, got {raw_uid!r}") from None
                        n = service.invalidate(uid)
                    else:
                        n = service.invalidate()
                    self._json({"invalidated": n})
                    return 200
                self._json({"error": "not found"}, code=404)
                return 404

            if not parts:
                self._send(200, _INDEX_HTML.encode(), "text/html")
                return 200
            if parts[0] == "healthz":
                if parts[1:2] == ["ready"]:
                    # Readiness: route traffic here only once a VALIDATED
                    # model generation is promoted. Liveness stays separate —
                    # a not-yet-ready process is healthy, just not servable.
                    ready, report = service.readiness()
                    self._json(report, code=200 if ready else 503)
                    return 200 if ready else 503
                if parts[1:] in ([], ["live"]):
                    self._json({"ok": True})  # liveness (/healthz, /healthz/live)
                    return 200
                # A misspelled readiness probe (/healthz/readiness, ...) must
                # fail loudly, not report a cold process as healthy.
                self._json({"error": "not found"}, code=404)
                return 404
            if parts[0] == "metrics":
                # Per-stage timings refresh at scrape time (shared Timer).
                if service.pipeline is not None:
                    metrics.observe_timer(service.pipeline.timer)
                self._send(
                    200, metrics.render().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                return 200
            if parts[0] == "recommend" and len(parts) == 2:
                try:
                    user_id = int(parts[1])
                except ValueError:
                    raise BadRequest(f"user id must be an integer, got {parts[1]!r}") from None
                k = _int_param(q, "k", service.default_k, 1, service.max_k)
                exclude_seen = _str_param(q, "exclude_seen", "1") != "0"
                # Admission control opt-in: a client deadline (ms) the
                # batcher sheds against instead of computing doomed work.
                deadline_ms = _int_param(q, "deadline_ms", 0, 0, 120_000)
                deadline = (
                    time.monotonic() + deadline_ms / 1e3 if deadline_ms else None
                )
                code, body = service.handle_recommend(
                    user_id, k=k, exclude_seen=exclude_seen, deadline=deadline
                )
                self._json(body, code=code)
                return code
            if parts[:2] == ["admin", "repos"]:
                limit = _int_param(q, "limit", 20, 1, MAX_LIMIT)
                self._json(service.search_repos(_str_param(q, "q"), limit))
                return 200
            if parts[:2] == ["admin", "users"]:
                limit = _int_param(q, "limit", 20, 1, MAX_LIMIT)
                self._json(service.search_users(_str_param(q, "q"), limit))
                return 200
            self._json({"error": "not found"}, code=404)
            return 404

        def do_GET(self):  # noqa: N802 — http.server API
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

    return Handler


class ServerHandle:
    """Running server + its thread + the service it fronts.

    Drop-in for the seed's raw ``ThreadingHTTPServer`` return value
    (``server_address``, ``shutdown()``), plus context management and a
    drain-on-shutdown guarantee: in-flight batches finish, the batcher
    worker stops, and the server thread is joined — no leaked threads
    between tests.
    """

    def __init__(self, server: ThreadingHTTPServer, thread: threading.Thread,
                 service: RecommendationService):
        self._server = server
        self._thread = thread
        self._service = service
        self._down = False
        self._lock = threading.Lock()

    @property
    def server_address(self):
        return self._server.server_address

    @property
    def service(self) -> RecommendationService:
        return self._service

    def shutdown(self) -> None:
        with self._lock:
            if self._down:
                return
            self._down = True
        self._server.shutdown()          # stop accepting; finish in-flight
        self._thread.join(timeout=10.0)
        self._server.server_close()
        self._service.close()            # drain + stop the batchers

    close = shutdown

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class _Server(ThreadingHTTPServer):
    # http.server listens with a backlog of 5 (the JAX server keeps it): at
    # 64 concurrent clients the accept queue overflows and the dropped
    # connections retry after 1 s and 3 s. The backlog covers the batcher's
    # default queue bound instead (PERF.md, "The listen backlog").
    request_queue_size = 256
    # Request-handler threads must not pin the process (or tests) open.
    daemon_threads = True


def serve(
    service: RecommendationService, host: str = "127.0.0.1", port: int = 8080
) -> ServerHandle:
    """Start the server; returns a :class:`ServerHandle` (``shutdown()`` to
    stop, or use as a context manager). Port 0 picks a free port
    (``handle.server_address[1]``)."""
    server = _Server((host, port), _make_handler(service))
    thread = threading.Thread(
        target=server.serve_forever, name="albedo-http", daemon=True
    )
    thread.start()
    return ServerHandle(server, thread, service)
