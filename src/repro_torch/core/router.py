"""Declarative, versioned HTTP routing for the MAX REST surface (the
port's copy of ``repro/core/router.py``).

A single *route table*: each :class:`Route` binds

    method + path template + handler + OpenAPI fragment

and the table is the one source of truth for dispatch, ``GET /v2/routes``
introspection and ``swagger.json`` generation, so the spec cannot drift
from the routable surface.

Path templates use ``{param}`` placeholders (OpenAPI syntax), e.g.
``/v2/model/{model_id}/predict``. Handlers receive a :class:`RequestCtx`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union,
)

_PARAM_RE = re.compile(r"\{(\w+)\}")


@dataclass
class RequestCtx:
    """Everything a handler needs: matched path params, parsed JSON body,
    query-string params, and (lower-cased) request headers."""
    method: str
    path: str
    params: Dict[str, str] = field(default_factory=dict)
    body: Optional[Any] = None
    query: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)


@dataclass
class StreamEvent:
    """One server-sent event: ``event:`` name, JSON ``data:`` payload, and
    a per-stream monotonically increasing ``id:`` sequence number (the
    resume cursor for ``Last-Event-ID``)."""
    event: str                      # token | done | error
    data: Dict[str, Any]
    seq: int = 0


@dataclass
class Response:
    """What a handler returns: a JSON body OR an event iterator the HTTP
    layer renders as ``text/event-stream``.

    Handlers may return a bare ``(status, dict)`` tuple, which the
    dispatcher normalizes through :meth:`adapt`; the dict
    ``_raw``/``_content_type`` escape hatch carries a pre-rendered body
    (the Prometheus exposition). Streaming handlers return :meth:`sse`;
    the HTTP layer closes the event iterator when the client disconnects
    or the stream ends, which is how a disconnect reaches the service
    layer (a generator sees ``GeneratorExit``)."""
    status: int = 200
    body: Optional[Dict[str, Any]] = None
    headers: Dict[str, str] = field(default_factory=dict)
    events: Optional[Iterator[StreamEvent]] = None

    @classmethod
    def adapt(cls, result: Union["Response", Tuple[int, Dict[str, Any]]]
              ) -> "Response":
        if isinstance(result, Response):
            return result
        status, body = result
        return cls(status=status, body=body)

    @classmethod
    def sse(cls, events: Iterable[StreamEvent], *,
            status: int = 200) -> "Response":
        return cls(status=status, events=iter(events))

    @property
    def streaming(self) -> bool:
        return self.events is not None


HandlerResult = Union[Tuple[int, Dict[str, Any]], Response]
Handler = Callable[[RequestCtx], HandlerResult]


@dataclass
class Route:
    method: str                       # GET | POST | DELETE
    template: str                     # /v2/model/{model_id}/predict
    handler: Optional[Handler]        # None for spec-only (unbound) tables
    summary: str = ""
    version: str = "v2"               # which API generation owns the route
    request_schema: Optional[Dict[str, Any]] = None
    response_schema: Optional[Dict[str, Any]] = None
    response_media: str = "application/json"  # e.g. text/event-stream
    tags: Tuple[str, ...] = ()
    _regex: re.Pattern = field(init=False, repr=False)

    def __post_init__(self):
        self.method = self.method.upper()
        pattern = _PARAM_RE.sub(r"(?P<\1>[^/]+)", re.escape(self.template)
                                .replace(r"\{", "{").replace(r"\}", "}"))
        self._regex = re.compile(f"^{pattern}$")

    def match(self, path: str) -> Optional[Dict[str, str]]:
        m = self._regex.match(path)
        return m.groupdict() if m else None

    def to_json(self) -> Dict[str, Any]:
        return {"method": self.method, "path": self.template,
                "summary": self.summary, "version": self.version,
                "media": self.response_media}


class Router:
    """Ordered route table with exact-template dispatch and 405 detection."""

    def __init__(self):
        self.routes: List[Route] = []

    def add(self, method: str, template: str, handler: Optional[Handler],
            *, summary: str = "", version: str = "v2",
            request_schema: Optional[Dict[str, Any]] = None,
            response_schema: Optional[Dict[str, Any]] = None,
            response_media: str = "application/json",
            tags: Tuple[str, ...] = ()) -> Route:
        route = Route(method, template, handler, summary=summary,
                      version=version, request_schema=request_schema,
                      response_schema=response_schema,
                      response_media=response_media, tags=tags)
        self.routes.append(route)
        return route

    def dispatch(self, method: str, path: str
                 ) -> Tuple[Optional[Route], Dict[str, str], List[str]]:
        """Resolve ``(route, path_params, allowed_methods)``.

        ``route is None`` with non-empty ``allowed_methods`` means the path
        exists but not for this method (HTTP 405); empty means 404.
        """
        method = method.upper()
        allowed: List[str] = []
        for route in self.routes:
            params = route.match(path)
            if params is None:
                continue
            if route.method == method:
                return route, params, [route.method]
            allowed.append(route.method)
        return None, {}, allowed

    def table(self) -> List[Dict[str, Any]]:
        return [r.to_json() for r in self.routes]

    # -- OpenAPI -----------------------------------------------------------

    def openapi(self, *, title: str, version: str,
                extra_paths: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """Project the route table into an OpenAPI 3 document. Every route in
        the table appears; ``extra_paths`` merges concrete per-asset paths."""
        paths: Dict[str, Dict[str, Any]] = {}
        for route in self.routes:
            op: Dict[str, Any] = {
                "summary": route.summary or route.template,
                "tags": list(route.tags) or [route.version],
                "responses": {"200": {
                    "description": "standardized envelope"
                    if route.response_media == "application/json"
                    else "server-sent event stream",
                    "content": {route.response_media: {
                        "schema": route.response_schema
                        or {"type": "object"}}}}},
            }
            params = _PARAM_RE.findall(route.template)
            if params:
                op["parameters"] = [
                    {"name": p, "in": "path", "required": True,
                     "schema": {"type": "string"}} for p in params]
            if route.method in ("POST", "PUT", "PATCH"):
                op["requestBody"] = {"content": {"application/json": {
                    "schema": route.request_schema or {"type": "object"}}}}
            paths.setdefault(route.template, {})[route.method.lower()] = op
        for path, ops in (extra_paths or {}).items():
            paths.setdefault(path, {}).update(
                {k: v for k, v in ops.items() if k not in paths.get(path, {})})
        return {"openapi": "3.0.0",
                "info": {"title": title, "version": version},
                "paths": paths}
