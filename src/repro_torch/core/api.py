"""Standardized RESTful API — paper Section 2.2.3, as a real HTTP server
(counterpart of ``repro/core/api.py``).

The surface is a declarative, versioned route table (``core/router.py``);
``swagger.json``, ``GET /v2/routes`` and dispatch are all projections of
the same table, so the spec covers every routable endpoint and nothing
else.

v1 (bare and under ``/v1/``, the JAX package's envelopes):

    GET    /                           -> exchange info
    GET    /models                     -> catalogue (metadata list)
    GET    /model/{id}/metadata        -> asset metadata
    GET    /model/{id}/labels          -> labels (if any)
    POST   /model/{id}/predict         -> {"status": "ok", "predictions": ...}
    POST   /model/{id}/deploy          -> deploy an asset
    GET    /health                     -> per-deployment stats
    GET    /swagger.json               -> auto-generated OpenAPI spec

v2 (structured error codes; concurrent predicts are coalesced into engine
decode batches by the deployment's ``BatchedService``):

    GET    /v2/models                  -> catalogue + deployment status
    POST   /v2/model/{id}/predict      -> single input
    POST   /v2/model/{id}/stream       -> SSE token stream (event: token /
                                          done / error; disconnect cancels)
    POST   /v2/model/{id}/predict_batch-> explicit multi-input
    POST   /v2/model/{id}/jobs         -> async submit (202 + job id)
    GET    /v2/jobs/{job_id}           -> poll a job
    GET    /v2/jobs/{job_id}/events    -> attach to a job's SSE stream
                                          (resume: Last-Event-ID/?from_seq=)
    DELETE /v2/jobs/{job_id}           -> cancel a queued/running job;
                                          drop a finished job's record
    GET    /v2/jobs/{job_id}/trace     -> a job's span timeline
    GET    /v2/trace/export            -> Chrome trace-event JSON
    POST   /v2/model/{id}/deploy       -> deploy (service mode, qos, paged
                                          KV / prefix cache, trace, faults
                                          and brownout knobs)
    DELETE /v2/model/{id}              -> undeploy
    GET    /v2/model/{id}/stats        -> service-level stats
    GET    /v2/metrics                 -> serving metrics (JSON, or
                                          Prometheus text with
                                          ?format=prometheus)
    GET    /v2/health                  -> liveness / readiness /
                                          degradation (503 when any
                                          deployment is not ready)
    GET    /v2/routes                  -> the route table itself

QoS: v2 predict/predict_batch/stream/jobs bodies accept ``priority``
(interactive | batch | best_effort), ``client`` (the ``X-MAX-Client``
header wins over the body field) and ``deadline_ms`` (shed with
``DEADLINE_EXCEEDED`` if the request cannot start in time).

Robustness: engine faults surface as structured ``ENGINE_FAULT`` (500)
once the service's bounded retry budget is spent; brownout shedding
surfaces as ``DEGRADED`` / ``CIRCUIT_OPEN`` (503). The ``faults`` and
``brownout`` deploy knobs are validated before any teardown, as the JAX
server validates them.

Not ported yet: replica groups. A deploy body field of theirs
(``replicas``, ``mesh_slice``) answers 501 ``NOT_IMPLEMENTED`` naming the
field and does nothing else.

Every 429/503 carries ``Retry-After`` (the error's ``retry_after_s`` when
the brownout controller set one). Implemented on the stdlib
``ThreadingHTTPServer``. Deployments build on ``device="cuda"`` unless
``build_kw`` names another device (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl

from repro_torch.core.assets import EXCHANGE
from repro_torch.core.deployment import DeploymentManager
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.router import RequestCtx, Response, Router, StreamEvent
from repro_torch.core.service import ServiceOverloaded
from repro_torch.core.wrapper import MAXError, PromptTooLong
from repro_torch.serving.faults import BrownoutConfig, FaultSpec
from repro_torch.serving.qos import PRIORITIES, AdmissionError

API_VERSION = "v1"          # of the back-compat surface
API_VERSIONS = ("v1", "v2")
SERVER_NAME = "Model Asset eXchange (PyTorch)"

# structured error codes (v2) -> HTTP status
ERROR_STATUS = {
    "BAD_JSON": 400,
    "MISSING_INPUT": 400,
    "INVALID_INPUT": 400,
    "MODEL_NOT_FOUND": 404,
    "NOT_DEPLOYED": 404,
    "JOB_NOT_FOUND": 404,
    "TRACE_NOT_FOUND": 404,
    "NOT_FOUND": 404,
    "METHOD_NOT_ALLOWED": 405,
    "QUEUE_FULL": 429,
    "RATE_LIMITED": 429,
    # prompt + generated tokens reached the deployment's max_seq
    "MAX_SEQ_EXCEEDED": 400,
    # the prompt alone leaves no generation headroom
    "PROMPT_TOO_LONG": 400,
    # the shared KV page pool ran dry: a capacity condition of the
    # deployment, not a malformed request
    "KV_POOL_EXHAUSTED": 503,
    # an engine fault whose retry budget ran out (or whose tokens had
    # already streamed, which forbids a replay)
    "ENGINE_FAULT": 500,
    # brownout SOFT shed a best_effort request; retryable after backoff
    "DEGRADED": 503,
    # brownout HARD opened the admission circuit for all classes
    "CIRCUIT_OPEN": 503,
    "CANCELLED": 499,
    "INTERNAL": 500,
    # a field of a feature the port does not serve yet
    "NOT_IMPLEMENTED": 501,
    "TIMEOUT": 504,
    "DEADLINE_EXCEEDED": 504,
}

# body fields of unported features, by route
UNPORTED_PREDICT_FIELDS = ()
UNPORTED_DEPLOY_FIELDS = ("replicas", "mesh_slice")


class ApiError(Exception):
    """Client-visible failure with a structured code; formatted per API
    generation by the dispatcher (flat string for v1, object for v2)."""

    def __init__(self, code: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.code = code
        self.status = ERROR_STATUS.get(code, 400)
        self.retry_after_s = retry_after_s


def _v1_error(message: str) -> Dict[str, Any]:
    return {"status": "error", "error": message}


def _v2_error(code: str, message: str, **extra) -> Dict[str, Any]:
    return {"status": "error",
            "error": {"code": code, "message": message}, **extra}


def _with_retry_after(resp: Response) -> Response:
    """Every 429/503 tells the client when to come back (whole seconds,
    RFC 9110; 1 second unless the error carries ``retry_after_s``)."""
    if resp.status in (429, 503) and "Retry-After" not in resp.headers:
        after = 1.0
        if isinstance(resp.body, dict):
            err = resp.body.get("error")
            if isinstance(err, dict) and isinstance(
                    err.get("retry_after_s"), (int, float)):
                after = float(err["retry_after_s"])
        resp.headers["Retry-After"] = str(max(1, math.ceil(after)))
    return resp


_ENVELOPE_SCHEMA = {
    "type": "object",
    "properties": {"status": {"type": "string"},
                   "predictions": {"type": "array"},
                   "model_id": {"type": "string"},
                   "latency_ms": {"type": "number"}},
}
_INPUT_SCHEMA = {"type": "object", "properties": {"input": {}},
                 "required": ["input"]}
_QOS_PROPS = {
    "priority": {"type": "string", "enum": list(PRIORITIES)},
    "client": {"type": "string",
               "description": "fairness/rate-limit identity "
                              "(X-MAX-Client header wins)"},
    "deadline_ms": {"type": "number",
                    "description": "shed if not started within this budget"},
}
_INPUT_SCHEMA_V2 = {"type": "object",
                    "properties": {"input": {}, **_QOS_PROPS},
                    "required": ["input"]}
_SSE_SCHEMA = {
    "type": "string",
    "description": "server-sent events: `id: <seq>` / `event: "
                   "token|done|error` / `data: <json>` frames; token data "
                   "carries {token_ids, text}, done carries "
                   "{envelope, usage}, error carries {code, message}",
}


def build_router(server: Optional["MAXServer"] = None) -> Router:
    """The route table. With ``server=None`` handlers are unbound and the
    table is spec-only (used by :func:`build_swagger` outside a server)."""
    r = Router()

    def h(name):
        return getattr(server, name) if server is not None else None

    def v1(method, tmpl, name, **kw):
        # every v1 route answers both bare and /v1-prefixed
        r.add(method, tmpl, h(name), version="v1", **kw)
        r.add(method, "/v1" + tmpl, h(name), version="v1", **kw)

    r.add("GET", "/", h("_h_root"), version="v1", summary="Exchange info")
    r.add("GET", "/v1", h("_h_root"), version="v1", summary="Exchange info")
    v1("GET", "/models", "_h_models", summary="List model assets")
    v1("GET", "/health", "_h_health", summary="Deployment health")
    v1("GET", "/model/{model_id}/metadata", "_h_metadata",
       summary="Asset metadata")
    v1("GET", "/model/{model_id}/labels", "_h_labels",
       summary="Prediction labels")
    v1("POST", "/model/{model_id}/predict", "_h_predict_v1",
       summary="Synchronous predict (standardized envelope)",
       request_schema=_INPUT_SCHEMA, response_schema=_ENVELOPE_SCHEMA)
    v1("POST", "/model/{model_id}/deploy", "_h_deploy_v1",
       summary="Deploy an asset")
    v1("GET", "/swagger.json", "_h_swagger",
       summary="This OpenAPI document")

    r.add("GET", "/v2/models", h("_h_models_v2"),
          summary="Catalogue with deployment/service status")
    r.add("POST", "/v2/model/{model_id}/predict", h("_h_predict_v2"),
          summary="Predict; concurrent requests are micro-batched into "
                  "engine decode batches (QoS: priority/client/deadline_ms)",
          request_schema=_INPUT_SCHEMA_V2, response_schema=_ENVELOPE_SCHEMA)
    r.add("POST", "/v2/model/{model_id}/predict_batch",
          h("_h_predict_batch_v2"),
          summary="Explicit multi-input predict",
          request_schema={"type": "object",
                          "properties": {"inputs": {"type": "array"},
                                         **_QOS_PROPS},
                          "required": ["inputs"]})
    r.add("POST", "/v2/model/{model_id}/stream", h("_h_stream_v2"),
          summary="Streaming predict: server-sent events — `token` deltas "
                  "with monotone ids, terminal `done` (envelope + usage) "
                  "or `error` (structured code); disconnecting cancels "
                  "the generation (QoS fields as /predict)",
          request_schema=_INPUT_SCHEMA_V2,
          response_schema=_SSE_SCHEMA, response_media="text/event-stream")
    r.add("POST", "/v2/model/{model_id}/jobs", h("_h_job_submit"),
          summary="Submit an async generation job",
          request_schema=_INPUT_SCHEMA_V2)
    r.add("GET", "/v2/jobs/{job_id}", h("_h_job_get"),
          summary="Poll an async job")
    r.add("GET", "/v2/jobs/{job_id}/events", h("_h_job_events"),
          summary="Attach to a job's event stream (SSE); resume with "
                  "Last-Event-ID or ?from_seq= from the job's bounded "
                  "replay buffer",
          response_schema=_SSE_SCHEMA, response_media="text/event-stream")
    r.add("DELETE", "/v2/jobs/{job_id}", h("_h_job_delete"),
          summary="Cancel a queued/running job (it finishes with state "
                  "'cancelled' and its decode slot frees at the next "
                  "chunk boundary); on a finished job, delete the record")
    r.add("GET", "/v2/jobs/{job_id}/trace", h("_h_job_trace"),
          summary="Span timeline for a job's request: queue/prefill/decode "
                  "phases, QoS decision, deferred park/unpark, prefix-cache "
                  "hit tokens vs cold prefill, per-chunk emission, stalls")
    r.add("GET", "/v2/trace/export", h("_h_trace_export"),
          summary="Chrome-trace-event JSON across all deployments (load in "
                  "Perfetto / chrome://tracing): per-slot lanes, scheduler "
                  "ticks, KV-pool and prefix-cache occupancy counters")
    r.add("POST", "/v2/model/{model_id}/deploy", h("_h_deploy_v2"),
          summary="Deploy an asset (optional {'service': sync|batched|auto,"
                  " 'qos': {...}, 'paged': bool, 'page_size': int,"
                  " 'kv_pool_blocks': int, 'prefix_cache': bool,"
                  " 'prefix_cache_pages': int, 'trace': bool,"
                  " 'trace_buffer': int, 'slow_trace_ms': number} — the kv"
                  " knobs select the paged KV cache layout, the prefix knobs"
                  " enable content-addressed KV page sharing on top of it,"
                  " and the trace knobs size request-lifecycle tracing /"
                  " slow-request capture; 'faults': {...} arms deterministic"
                  " fault injection and 'brownout': {...} tunes the"
                  " NORMAL/SOFT/HARD degradation controller)")
    r.add("DELETE", "/v2/model/{model_id}", h("_h_undeploy"),
          summary="Undeploy an asset")
    r.add("GET", "/v2/model/{model_id}/stats", h("_h_stats_v2"),
          summary="Service-level stats (batching, queue, jobs, QoS)")
    r.add("GET", "/v2/metrics", h("_h_metrics"),
          summary="Serving metrics: requests by class/outcome, queue-wait "
                  "percentiles, shed counts (?format=prometheus for text "
                  "exposition)")
    r.add("GET", "/v2/health", h("_h_health_v2"),
          summary="Liveness / readiness / degradation across deployments: "
                  "200 when every deployed service is ready, 503 (with "
                  "Retry-After) when any worker is dead or a brownout "
                  "circuit is open")
    r.add("GET", "/v2/routes", h("_h_routes"),
          summary="The route table (source of truth for this spec)")
    return r


def _asset_paths(registry: ModelRegistry) -> Dict[str, Any]:
    """Concrete per-asset v1 paths (the paper's per-model Swagger GUI)."""
    paths: Dict[str, Any] = {}
    for asset in registry.list():
        mid = asset.metadata.id
        paths[f"/model/{mid}/predict"] = {
            "post": {
                "summary": f"Predict with {asset.metadata.name}",
                "requestBody": {"content": {"application/json": {
                    "schema": {"type": "object",
                               "properties": {"input": {}}}}}},
                "responses": {"200": {
                    "description": "standardized envelope",
                    "content": {"application/json": {
                        "schema": _ENVELOPE_SCHEMA}}}},
            }
        }
        paths[f"/model/{mid}/metadata"] = {
            "get": {"summary": f"Metadata for {asset.metadata.name}",
                    "responses": {"200": {"description": "metadata"}}}}
    return paths


def build_swagger(registry: ModelRegistry,
                  router: Optional[Router] = None) -> Dict[str, Any]:
    """OpenAPI spec covering every route in the table plus concrete
    per-asset paths."""
    router = router or build_router(None)
    return router.openapi(title=SERVER_NAME,
                          version="+".join(API_VERSIONS),
                          extra_paths=_asset_paths(registry))


class MAXServer:
    """Owns the HTTP server + deployment manager. Thread-safe; used by
    tests and the launcher as ``with MAXServer(...) as s:`` requests to
    ``s.url``. ``build_kw`` goes to every asset build (``device`` defaults
    to ``"cuda"``)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 manager: Optional[DeploymentManager] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 auto_deploy: bool = True, build_kw: Optional[dict] = None,
                 service_mode: Optional[str] = None,
                 service_kw: Optional[dict] = None):
        self.registry = registry if registry is not None else EXCHANGE
        if manager is not None:
            if service_mode is not None or service_kw is not None:
                raise ValueError(
                    "pass service_mode/service_kw on the DeploymentManager "
                    "when supplying one explicitly — they only configure "
                    "the internally created manager")
            self.manager = manager
        else:
            self.manager = DeploymentManager(
                self.registry, service_mode=service_mode or "auto",
                service_kw=service_kw)
        self._owns_manager = manager is None
        self.auto_deploy = auto_deploy
        self.build_kw = build_kw or {}
        self.router = build_router(self)
        self._job_index: Dict[str, str] = {}     # job id -> asset id
        self._job_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None):
                # a handler may return a pre-rendered non-JSON body (the
                # Prometheus exposition) through the _raw escape hatch
                if isinstance(payload, dict) and "_raw" in payload:
                    body = payload["_raw"].encode()
                    ctype = payload.get("_content_type", "text/plain")
                else:
                    body = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_sse(self, resp: Response):
                """Incremental SSE frames. No Content-Length: the HTTP/1.0
                connection close delimits the stream. A failed write (the
                client went away) closes the event iterator, which is how
                a disconnect reaches the scheduler (the service generator
                sees GeneratorExit)."""
                self.send_response(resp.status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Accel-Buffering", "no")
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                events = resp.events
                last_seq = -1
                try:
                    while True:
                        try:
                            ev = next(events)
                        except StopIteration:
                            break
                        except Exception as e:   # event-source fault:
                            # structured last frame; reuse last_seq so a
                            # reconnecting client's Last-Event-ID does not
                            # regress
                            ev = StreamEvent(
                                "error", {"code": "INTERNAL",
                                          "message": str(e)}, last_seq)
                            events = iter(())
                        last_seq = ev.seq
                        frame = (f"id: {ev.seq}\n"
                                 f"event: {ev.event}\n"
                                 f"data: {json.dumps(ev.data)}\n\n")
                        try:
                            self.wfile.write(frame.encode())
                            self.wfile.flush()
                        except OSError:          # client disconnected
                            break
                finally:
                    close = getattr(resp.events, "close", None)
                    if close is not None:
                        close()

            def _respond(self, resp: Response):
                if resp.streaming:
                    self._send_sse(resp)
                else:
                    self._send(resp.status, resp.body, resp.headers)

            def _hdrs(self):
                return {k.lower(): v for k, v in self.headers.items()}

            def do_GET(self):
                self._respond(outer.dispatch("GET", self.path, None,
                                             headers=self._hdrs()))

            def do_DELETE(self):
                self._respond(outer.dispatch("DELETE", self.path, None,
                                             headers=self._hdrs()))

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    data = json.loads(raw.decode() or "{}")
                except json.JSONDecodeError:
                    if self.path.startswith("/v2/"):
                        self._send(400, _v2_error("BAD_JSON", "bad JSON"))
                    else:
                        self._send(400, _v1_error("bad JSON"))
                    return
                self._respond(outer.dispatch("POST", self.path, data,
                                             headers=self._hdrs()))

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- dispatch ---------------------------------------------------------------

    def dispatch(self, method: str, path: str, body: Optional[Any],
                 headers: Optional[Dict[str, str]] = None) -> Response:
        """Route + run a handler, normalized to a :class:`Response`."""
        path, _, qs = path.partition("?")
        query = dict(parse_qsl(qs))
        route, params, allowed = self.router.dispatch(method, path)
        v2 = path.startswith("/v2/")
        if route is None:
            if allowed:
                msg = f"{method} not allowed for {path}"
                if v2:
                    return Response(405, _v2_error(
                        "METHOD_NOT_ALLOWED", msg,
                        allowed=sorted(set(allowed))))
                return Response(405, _v1_error(msg))
            msg = f"no route {path}"
            return Response(404, _v2_error("NOT_FOUND", msg) if v2
                            else _v1_error(msg))
        try:
            resp = Response.adapt(
                route.handler(RequestCtx(method, path, params, body,
                                         query=query,
                                         headers=headers or {})))
        except ApiError as e:
            payload = _v2_error(e.code, str(e)) if v2 else _v1_error(str(e))
            if v2 and e.retry_after_s is not None:
                payload["error"]["retry_after_s"] = e.retry_after_s
            resp = Response(e.status, payload)
        except Exception as e:          # container fault isolation
            payload = _v2_error("INTERNAL", str(e)) if v2 \
                else _v1_error(str(e))
            resp = Response(500, payload)
        return _with_retry_after(resp)

    # -- shared helpers ---------------------------------------------------------

    def _ensure_deployed(self, asset_id: str):
        # a KeyError here is a model lookup failure and nothing else —
        # wrapper faults deeper in the request stay 500s
        try:
            return self.manager.get(asset_id)
        except KeyError as e:
            if not self.auto_deploy:
                raise ApiError("NOT_DEPLOYED", str(e)) from None
        try:
            self.registry.get(asset_id)       # raises KeyError if unknown
        except KeyError as e:
            raise ApiError("MODEL_NOT_FOUND", str(e)) from None
        return self.manager.deploy(asset_id, **self.build_kw)

    @staticmethod
    def _require_input(body: Any) -> Any:
        """The request body must be a JSON object carrying a non-null
        ``input`` key (v1 and v2)."""
        if not isinstance(body, dict):
            raise ApiError("MISSING_INPUT",
                           "request body must be a JSON object with an "
                           "'input' key")
        if "input" not in body:
            raise ApiError("MISSING_INPUT", "missing required key 'input'")
        if body["input"] is None:
            raise ApiError("INVALID_INPUT", "'input' must not be null")
        return body["input"]

    @staticmethod
    def _require_qos(ctx) -> Optional[Dict[str, Any]]:
        """Request-scoped QoS fields: body ``priority`` / ``client`` /
        ``deadline_ms`` plus the ``X-MAX-Client`` header (the header wins:
        proxies inject it, bodies are client-authored). None when the
        request carries no QoS at all (the service applies defaults)."""
        body = ctx.body if isinstance(ctx.body, dict) else {}
        qos: Dict[str, Any] = {}
        priority = body.get("priority")
        if priority is not None:
            if not isinstance(priority, str):
                raise ApiError("INVALID_INPUT", "'priority' must be a string")
            qos["priority"] = priority
        client = ctx.headers.get("x-max-client") or body.get("client")
        if client is not None:
            if not isinstance(client, str) or not client:
                raise ApiError("INVALID_INPUT",
                               "'client' must be a non-empty string")
            qos["client"] = client
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None:
            if (isinstance(deadline_ms, bool)
                    or not isinstance(deadline_ms, (int, float))
                    or deadline_ms <= 0):
                raise ApiError("INVALID_INPUT",
                               "'deadline_ms' must be a positive number")
            qos["deadline_s"] = float(deadline_ms) / 1e3
        return qos or None

    @staticmethod
    def _reject_unported(body: Any, fields) -> None:
        """501 for the first non-null body field of a feature the port
        does not serve yet, before anything else happens."""
        if not isinstance(body, dict):
            return
        for key in fields:
            if body.get(key) is not None:
                raise ApiError("NOT_IMPLEMENTED",
                               f"{key!r} is not implemented by the PyTorch "
                               "port yet")

    @staticmethod
    def _v2_envelope(env: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """Service envelope -> (status, v2 envelope with structured error)."""
        if env.get("status") == "ok":
            return 200, env
        if env.get("status") == "cancelled":
            return ERROR_STATUS["CANCELLED"], env
        code = env.get("code", "INVALID_INPUT")
        out = _v2_error(code, str(env.get("error", "prediction failed")))
        if isinstance(env.get("retry_after_s"), (int, float)):
            out["error"]["retry_after_s"] = env["retry_after_s"]
        if "model_id" in env:
            out["model_id"] = env["model_id"]
        return ERROR_STATUS.get(code, 400), out

    # -- v1 handlers -------------------------------------------------------------

    def _h_root(self, ctx) -> Tuple[int, Dict[str, Any]]:
        return 200, {"name": SERVER_NAME,
                     "api_version": API_VERSION,
                     "api_versions": list(API_VERSIONS),
                     "assets": len(self.registry),
                     "deployed": self.manager.deployed()}

    def _h_models(self, ctx) -> Tuple[int, Dict[str, Any]]:
        return 200, {"models": [a.metadata.to_json()
                                for a in self.registry.list()]}

    def _h_health(self, ctx) -> Tuple[int, Dict[str, Any]]:
        return 200, {"deployments": self.manager.health()}

    def _h_swagger(self, ctx) -> Tuple[int, Dict[str, Any]]:
        return 200, build_swagger(self.registry, self.router)

    def _h_metadata(self, ctx) -> Tuple[int, Dict[str, Any]]:
        try:
            asset = self.registry.get(ctx.params["model_id"])
        except KeyError as e:
            raise ApiError("MODEL_NOT_FOUND", str(e)) from None
        return 200, asset.metadata.to_json()

    def _h_labels(self, ctx) -> Tuple[int, Dict[str, Any]]:
        dep = self._ensure_deployed(ctx.params["model_id"])
        return 200, {"labels": dep.wrapper.labels()}

    def _h_predict_v1(self, ctx) -> Tuple[int, Dict[str, Any]]:
        inp = self._require_input(ctx.body)
        dep = self._ensure_deployed(ctx.params["model_id"])
        env = dep.predict(inp)
        code = env.pop("code", None)   # v1 errors stay flat strings, but
        if env["status"] == "ok":      # transient overload/timeouts must
            return 200, env            # not read as permanent 400s
        return ERROR_STATUS.get(code, 400), env

    def _h_deploy_v1(self, ctx) -> Tuple[int, Dict[str, Any]]:
        try:
            self.manager.deploy(ctx.params["model_id"], **self.build_kw)
        except KeyError as e:
            raise ApiError("MODEL_NOT_FOUND", str(e)) from None
        return 200, {"status": "ok", "deployed": self.manager.deployed()}

    # -- v2 handlers -------------------------------------------------------------

    def _h_models_v2(self, ctx) -> Tuple[int, Dict[str, Any]]:
        models = []
        for a in self.registry.list():
            m = a.metadata.to_json()
            try:  # racing a concurrent undeploy must not 404 the listing
                m["service"] = self.manager.get(a.metadata.id).service.kind
                m["deployed"] = True
            except KeyError:
                m["deployed"] = False
            models.append(m)
        return 200, {"status": "ok", "models": models}

    def _h_predict_v2(self, ctx) -> Tuple[int, Dict[str, Any]]:
        inp = self._require_input(ctx.body)
        self._reject_unported(ctx.body, UNPORTED_PREDICT_FIELDS)
        qos = self._require_qos(ctx)
        dep = self._ensure_deployed(ctx.params["model_id"])
        return self._v2_envelope(dep.predict(inp, qos))

    def _h_stream_v2(self, ctx) -> Response:
        """SSE predict: input/QoS validation failures are plain JSON 4xx
        (the stream never opened); after validation everything, admission
        rejection included, arrives as SSE events."""
        inp = self._require_input(ctx.body)
        self._reject_unported(ctx.body, UNPORTED_PREDICT_FIELDS)
        qos = self._require_qos(ctx)
        dep = self._ensure_deployed(ctx.params["model_id"])
        return Response.sse(dep.predict_stream(inp, qos))

    def _job_model(self, job_id: str) -> str:
        with self._job_lock:
            model_id = self._job_index.get(job_id)
        if model_id is None:
            raise ApiError("JOB_NOT_FOUND", f"unknown job {job_id!r}")
        return model_id

    def _job_service(self, job_id: str):
        model_id = self._job_model(job_id)
        try:
            return model_id, self.manager.get(model_id).service
        except KeyError:
            raise ApiError("JOB_NOT_FOUND",
                           f"job {job_id!r} no longer exists "
                           f"(model {model_id!r} undeployed?)") from None

    def _h_job_events(self, ctx) -> Response:
        job_id = ctx.params["job_id"]
        model_id = self._job_model(job_id)
        # resume cursor: Last-Event-ID is the last seq the client SAW
        # (deliver strictly after it); ?from_seq= is the first seq to
        # deliver (inclusive)
        from_seq = 0
        last_id = ctx.headers.get("last-event-id")
        try:
            if ctx.query.get("from_seq") is not None:
                from_seq = int(ctx.query["from_seq"])
            elif last_id is not None:
                from_seq = int(last_id) + 1
        except ValueError:
            raise ApiError("INVALID_INPUT",
                           "from_seq / Last-Event-ID must be integers") \
                from None
        try:
            events = self.manager.get(model_id).service.job_events(
                job_id, max(0, from_seq))
        except KeyError:
            raise ApiError("JOB_NOT_FOUND",
                           f"job {job_id!r} no longer exists "
                           f"(model {model_id!r} undeployed?)") from None
        return Response.sse(events)

    def _h_predict_batch_v2(self, ctx) -> Tuple[int, Dict[str, Any]]:
        if not isinstance(ctx.body, dict) or "inputs" not in ctx.body:
            raise ApiError("MISSING_INPUT", "missing required key 'inputs'")
        inputs = ctx.body["inputs"]
        if not isinstance(inputs, list) or not inputs:
            raise ApiError("INVALID_INPUT",
                           "'inputs' must be a non-empty array")
        self._reject_unported(ctx.body, UNPORTED_PREDICT_FIELDS)
        qos = self._require_qos(ctx)
        dep = self._ensure_deployed(ctx.params["model_id"])
        results = [self._v2_envelope(env)[1]
                   for env in dep.predict_batch(inputs, qos)]
        ok = sum(1 for r in results if r.get("status") == "ok")
        return 200, {"status": "ok" if ok == len(results) else "partial",
                     "results": results, "count": len(results)}

    def _h_job_submit(self, ctx) -> Tuple[int, Dict[str, Any]]:
        inp = self._require_input(ctx.body)
        self._reject_unported(ctx.body, UNPORTED_PREDICT_FIELDS)
        qos = self._require_qos(ctx)
        model_id = ctx.params["model_id"]
        dep = self._ensure_deployed(model_id)
        try:
            job = dep.submit_job(inp, qos)
        except ServiceOverloaded as e:
            raise ApiError("QUEUE_FULL", str(e)) from None
        except AdmissionError as e:
            raise ApiError(e.code, str(e),
                           retry_after_s=getattr(e, "retry_after_s", None)
                           ) from None
        except PromptTooLong as e:
            raise ApiError("PROMPT_TOO_LONG", str(e)) from None
        except MAXError as e:
            raise ApiError("INVALID_INPUT", str(e)) from None
        with self._job_lock:
            self._job_index[job.id] = model_id
            while len(self._job_index) > 4096:   # bounded, like job records
                self._job_index.pop(next(iter(self._job_index)))
        return 202, {"status": "ok", "job": job.to_json(),
                     "poll": f"/v2/jobs/{job.id}"}

    def _h_job_get(self, ctx) -> Tuple[int, Dict[str, Any]]:
        job_id = ctx.params["job_id"]
        model_id, service = self._job_service(job_id)
        try:
            job = service.get_job(job_id)
        except KeyError:
            raise ApiError("JOB_NOT_FOUND",
                           f"job {job_id!r} no longer exists "
                           f"(model {model_id!r} undeployed?)") from None
        return 200, {"status": "ok", "job": job.to_json()}

    def _h_job_delete(self, ctx) -> Tuple[int, Dict[str, Any]]:
        """DELETE on a queued or running job cancels it (the job finishes
        with state 'cancelled', its decode slot frees at the next chunk
        boundary and is backfilled); a finished job's record is dropped."""
        job_id = ctx.params["job_id"]
        try:
            _, service = self._job_service(job_id)
        except ApiError:
            with self._job_lock:    # undeployed: records are gone anyway
                self._job_index.pop(job_id, None)
            raise
        if service.cancel_job(job_id):
            # the record survives so the client can poll the cancelled state
            return 200, {"status": "ok", "cancelled": job_id,
                         "poll": f"/v2/jobs/{job_id}"}
        deleted = service.delete_job(job_id)
        with self._job_lock:
            self._job_index.pop(job_id, None)
        if not deleted:
            raise ApiError("JOB_NOT_FOUND",
                           f"job {job_id!r} no longer exists") from None
        return 200, {"status": "ok", "deleted": job_id}

    def _h_job_trace(self, ctx) -> Tuple[int, Dict[str, Any]]:
        """The request's span timeline; cancelled, shed and exhausted jobs
        have one too (every retire path records a complete trace)."""
        job_id = ctx.params["job_id"]
        model_id, service = self._job_service(job_id)
        try:
            trace = service.get_trace(job_id)
        except KeyError as e:
            raise ApiError("TRACE_NOT_FOUND", str(e).strip("'\"")) from None
        return 200, {"status": "ok", "job_id": job_id,
                     "model_id": model_id, "trace": trace}

    def _h_trace_export(self, ctx) -> Tuple[int, Dict[str, Any]]:
        """Chrome-trace-event JSON for every traced deployment, one
        Perfetto process per model (all tracers share one clock)."""
        events = []
        pid = 0
        for asset_id in self.manager.deployed():
            try:
                service = self.manager.get(asset_id).service
            except KeyError:
                continue            # undeployed between list and get
            if service.tracer is not None:
                pid += 1
                events.extend(service.tracer.to_chrome(
                    pid=pid, process_name=asset_id))
        return 200, {"traceEvents": events, "displayTimeUnit": "ms"}

    @staticmethod
    def _engine_knobs(body: Dict[str, Any]) -> Dict[str, Any]:
        """The KV cache layout knobs of a v2 deploy body, validated as the
        JAX package validates them (``api.py:827-895``)."""
        engine_kw: Dict[str, Any] = {}
        if body.get("paged") is not None:
            if not isinstance(body["paged"], bool):
                raise ApiError("INVALID_INPUT", "'paged' must be a boolean")
            engine_kw["paged"] = body["paged"]
        for key in ("page_size", "kv_pool_blocks"):
            if body.get(key) is not None:
                v = body[key]
                if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                    raise ApiError("INVALID_INPUT",
                                   f"{key!r} must be a positive integer")
                engine_kw.setdefault("paged", True)
                engine_kw[key] = v
        # prefix caching rides the paged layout; asking for it implies it
        if body.get("prefix_cache") is not None:
            if not isinstance(body["prefix_cache"], bool):
                raise ApiError("INVALID_INPUT",
                               "'prefix_cache' must be a boolean")
            engine_kw["prefix_cache"] = body["prefix_cache"]
            if body["prefix_cache"]:
                engine_kw.setdefault("paged", True)
        if body.get("prefix_cache_pages") is not None:
            v = body["prefix_cache_pages"]
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                raise ApiError("INVALID_INPUT",
                               "'prefix_cache_pages' must be a positive "
                               "integer")
            if engine_kw.get("prefix_cache") is False:
                raise ApiError("INVALID_INPUT",
                               "'prefix_cache_pages' conflicts with "
                               "'prefix_cache': false")
            engine_kw["prefix_cache_pages"] = v
            engine_kw.setdefault("prefix_cache", True)
            engine_kw.setdefault("paged", True)
        return engine_kw

    @staticmethod
    def _trace_knobs(body: Dict[str, Any]) -> Dict[str, Any]:
        """The request-tracing knobs of a v2 deploy body: service-level
        overrides, validated as the JAX package validates them."""
        out: Dict[str, Any] = {}
        if body.get("trace") is not None:
            if not isinstance(body["trace"], bool):
                raise ApiError("INVALID_INPUT", "'trace' must be a boolean")
            out["trace"] = body["trace"]
        if body.get("trace_buffer") is not None:
            v = body["trace_buffer"]
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                raise ApiError("INVALID_INPUT",
                               "'trace_buffer' must be a positive integer")
            if out.get("trace") is False:
                raise ApiError("INVALID_INPUT",
                               "'trace_buffer' conflicts with "
                               "'trace': false")
            out["trace_buffer"] = v
            out.setdefault("trace", True)
        if body.get("slow_trace_ms") is not None:
            v = body["slow_trace_ms"]
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v <= 0:
                raise ApiError("INVALID_INPUT",
                               "'slow_trace_ms' must be a positive number")
            if out.get("trace") is False:
                raise ApiError("INVALID_INPUT",
                               "'slow_trace_ms' conflicts with "
                               "'trace': false")
            out["slow_trace_ms"] = float(v)
            out.setdefault("trace", True)
        return out

    @staticmethod
    def _robustness_knobs(body: Dict[str, Any]) -> Dict[str, Any]:
        """The ``faults`` and ``brownout`` knobs of a v2 deploy body:
        service-level overrides, validated as the JAX server validates
        them (a list of fault specs is per replica, and this server has no
        replica groups)."""
        out: Dict[str, Any] = {}
        if body.get("faults") is not None:
            faults = body["faults"]
            if isinstance(faults, list):
                raise ApiError("INVALID_INPUT",
                               "a 'faults' list requires 'replicas' > 1 "
                               "(one spec per replica)")
            if not isinstance(faults, dict):
                raise ApiError("INVALID_INPUT",
                               "'faults' must be an object (all replicas) "
                               "or a list of objects (per replica)")
            try:
                FaultSpec.from_json(faults)
            except (TypeError, ValueError) as e:
                raise ApiError("INVALID_INPUT",
                               f"bad 'faults' spec: {e}") from None
            out["faults"] = faults
        if body.get("brownout") is not None:
            if not isinstance(body["brownout"], dict):
                raise ApiError("INVALID_INPUT",
                               "'brownout' must be an object")
            try:
                BrownoutConfig.from_json(body["brownout"])
            except (TypeError, ValueError) as e:
                raise ApiError("INVALID_INPUT",
                               f"bad 'brownout' config: {e}") from None
            out["brownout"] = body["brownout"]
        return out

    def _h_deploy_v2(self, ctx) -> Tuple[int, Dict[str, Any]]:
        body = ctx.body if isinstance(ctx.body, dict) else {}
        self._reject_unported(body, UNPORTED_DEPLOY_FIELDS)
        mode = body.get("service")
        if mode is not None and mode not in ("sync", "batched", "auto"):
            raise ApiError("INVALID_INPUT",
                           f"unknown service mode {mode!r}")
        qos = body.get("qos")
        if qos is not None and not isinstance(qos, dict):
            raise ApiError("INVALID_INPUT", "'qos' must be an object")
        engine_kw = self._engine_knobs(body)
        if engine_kw.get("paged"):
            # the engine's page_size/max_seq rule, checked BEFORE the
            # redeploy tears the healthy deployment down
            max_seq = self.build_kw.get("max_seq", 128)
            page = engine_kw.get("page_size", 16)
            if max_seq % page:
                raise ApiError(
                    "INVALID_INPUT",
                    f"page_size {page} must divide the deployment's "
                    f"max_seq {max_seq}")
        service_overrides = {**self._trace_knobs(body),
                             **self._robustness_knobs(body)}
        try:
            dep = self.manager.deploy(ctx.params["model_id"],
                                      service_mode=mode, qos=qos,
                                      force=bool(engine_kw)
                                      or bool(service_overrides),
                                      service_overrides=service_overrides
                                      or None,
                                      **{**self.build_kw, **engine_kw})
        except KeyError as e:
            raise ApiError("MODEL_NOT_FOUND", str(e)) from None
        except ValueError as e:     # mode/qos infeasible for this wrapper
            raise ApiError("INVALID_INPUT", str(e)) from None
        cfg = dep.service.qos_cfg
        out = {"status": "ok", "model_id": dep.asset_id,
               "service": dep.service.kind, "replicas": 1,
               "qos": {"policy": cfg.policy, "rate": cfg.rate,
                       "max_queue_per_class": cfg.max_queue,
                       "class_weights": dict(cfg.class_weights)},
               "deployed": self.manager.deployed()}
        engine = getattr(dep.wrapper, "engine", None)
        if engine is not None:
            out["kv_cache"] = engine.kv_stats()
        return 200, out

    def _h_undeploy(self, ctx) -> Tuple[int, Dict[str, Any]]:
        model_id = ctx.params["model_id"]
        if not self.manager.undeploy(model_id):
            raise ApiError("NOT_DEPLOYED",
                           f"asset {model_id!r} is not deployed")
        return 200, {"status": "ok", "model_id": model_id,
                     "deployed": self.manager.deployed()}

    def _h_stats_v2(self, ctx) -> Tuple[int, Dict[str, Any]]:
        model_id = ctx.params["model_id"]
        try:
            dep = self.manager.get(model_id)
        except KeyError:
            raise ApiError("NOT_DEPLOYED",
                           f"asset {model_id!r} is not deployed") from None
        return 200, {"status": "ok", "model_id": model_id,
                     "service": dep.service.stats(),
                     "requests": dep.stats.requests,
                     "errors": dep.stats.errors,
                     "mean_latency_ms": round(dep.stats.mean_latency_ms, 2)}

    def _h_health_v2(self, ctx) -> Tuple[int, Dict[str, Any]]:
        """Aggregate liveness/readiness: the process answering is
        liveness; readiness needs every deployed service ready (a live
        worker, the brownout circuit closed). The 503 carries Retry-After,
        so a load balancer stops routing here until it clears."""
        deployments: Dict[str, Any] = {}
        ready = True
        degraded = False
        for asset_id in self.manager.deployed():
            try:
                service = self.manager.get(asset_id).service
            except KeyError:
                continue            # undeployed between list and get
            h = service.health()
            deployments[asset_id] = h
            ready = ready and bool(h.get("ready"))
            degraded = degraded or h.get("degradation", "normal") != "normal"
        status = 200 if ready else 503
        return status, {"status": "ok" if ready else "error",
                        "live": True, "ready": ready,
                        "degraded": degraded,
                        "deployments": deployments}

    def _h_metrics(self, ctx) -> Tuple[int, Dict[str, Any]]:
        reg = self.manager.metrics
        if ctx.query.get("format") == "prometheus":
            return 200, {"_raw": reg.to_prometheus(),
                         "_content_type": "text/plain; version=0.0.4"}
        out = reg.to_json()
        tokens = sum(v for k, v in out["counters"].items()
                     if k.startswith("max_generated_tokens_total"))
        out["derived"] = {
            "tokens_per_s": round(tokens / max(out["uptime_s"], 1e-9), 3)}
        return 200, {"status": "ok", "metrics": out}

    def _h_routes(self, ctx) -> Tuple[int, Dict[str, Any]]:
        return 200, {"status": "ok", "routes": self.router.table()}

    # -- lifecycle ----------------------------------------------------------------

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread:                # shutdown() waits for serve_forever
            self._server.shutdown()
            self._thread.join(timeout=5)
        self._server.server_close()
        if self._owns_manager:
            # batched workers are daemon threads holding whole engines;
            # leaking them would outlive the server
            for asset_id in self.manager.deployed():
                self.manager.undeploy(asset_id)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
