"""Deployment units (counterpart of ``repro/core/deployment.py``).

The paper isolates each wrapped model in a Docker container. Here the
isolation unit is a *deployment*: its own wrapper, engine, parameters and
KV cache on the card, behind its own :class:`InferenceService`. The
service decides HOW requests execute (per call on the request thread, or
continuous batching on a worker thread); the deployment stays the unit of
stats and lifecycle.

:class:`DeploymentManager` is the orchestrator: deploy / undeploy / route,
with per-deployment health and request stats. It is safe under
``ThreadingHTTPServer``: stats updates are locked, and two concurrent
deploys of one asset build it once. A redeploy tears the old deployment
down before it builds the new one, so two full-width models never sit on
the card at once. One :class:`MetricsRegistry` is shared by every
deployment, so ``/v2/metrics`` is the whole exchange's view.

Not ported yet: replica groups (``replicas``, ``mesh_slice``).
"""

from __future__ import annotations

import gc
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.registry import EXCHANGE, ModelRegistry
from repro_torch.core.service import InferenceService, Job, make_service
from repro_torch.core.wrapper import MAXModelWrapper
from repro_torch.device import DeviceLike
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.qos import QoSConfig
from repro_torch.serving.tracing import now as _now


@dataclass
class DeploymentStats:
    requests: int = 0
    errors: int = 0
    total_latency_s: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record(self, latency_s: float, ok: bool):
        # one thread per connection: += on a field is not atomic
        with self._lock:
            self.requests += 1
            self.total_latency_s += latency_s
            if not ok:
                self.errors += 1

    @property
    def mean_latency_ms(self) -> float:
        return (self.total_latency_s / self.requests * 1e3
                if self.requests else 0.0)


@dataclass
class Deployment:
    asset_id: str
    service: InferenceService
    created_at: float = field(default_factory=_now)   # monotonic; uptime
    stats: DeploymentStats = field(default_factory=DeploymentStats)

    @property
    def wrapper(self) -> MAXModelWrapper:
        return self.service.wrapper

    def predict(self, inp: Any,
                qos: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        t0 = _now()
        env = self.service.predict(inp, qos)
        self.stats.record(_now() - t0, env.get("status") == "ok")
        return env

    def predict_batch(self, inputs: List[Any],
                      qos: Optional[Dict[str, Any]] = None
                      ) -> List[Dict[str, Any]]:
        t0 = _now()
        envs = self.service.predict_batch(inputs, qos)
        per_input = (_now() - t0) / max(len(inputs), 1)
        for env in envs:
            self.stats.record(per_input, env.get("status") == "ok")
        return envs

    def submit_job(self, inp: Any,
                   qos: Optional[Dict[str, Any]] = None) -> Job:
        return self.service.submit_job(inp, qos)

    def predict_stream(self, inp: Any,
                       qos: Optional[Dict[str, Any]] = None):
        """Streaming predict; the request counts once, when its stream
        terminates (done, error or disconnect)."""
        t0 = _now()

        def wrapped():
            ok = False
            try:
                for ev in self.service.predict_stream(inp, qos):
                    if ev.event == "done":
                        ok = True
                    yield ev
            finally:
                self.stats.record(_now() - t0, ok)
        return wrapped()


class DeploymentManager:
    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 service_mode: str = "auto",
                 service_kw: Optional[Dict[str, Any]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else EXCHANGE
        self.service_mode = service_mode
        self.service_kw = service_kw or {}
        # one registry across all deployments: /v2/metrics is the whole
        # exchange's view, labelled per model/class/outcome
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._deployments: Dict[str, Deployment] = {}
        self._building: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    def deploy(self, asset_id: str, *, service_mode: Optional[str] = None,
               qos: Optional[Any] = None, force: bool = False,
               service_overrides: Optional[Dict[str, Any]] = None,
               device: DeviceLike = "cuda", **build_kw) -> Deployment:
        """Deploy ``asset_id`` built with ``build_kw`` on ``device``. A
        live deployment is returned as it is unless ``force`` (explicit
        engine or service knobs), an explicit ``qos`` config or a concrete
        ``service_mode`` of another kind asks for a rebuild; the old one is
        undeployed first. ``service_overrides`` (the tracing knobs and the
        robustness ones, ``faults`` and ``brownout``) are merged over the
        manager-wide ``service_kw``."""
        if qos is not None and not isinstance(qos, QoSConfig):
            qos = QoSConfig.from_json(qos)    # validate before any teardown
        while True:
            with self._lock:
                dep = self._deployments.get(asset_id)
            if dep is not None:
                if qos is None and not force and (
                        service_mode in (None, "auto")
                        or dep.service.kind == service_mode):
                    return dep
                dep = None            # or the undeploy could not free it
                self.undeploy(asset_id)
            with self._lock:
                if asset_id in self._deployments:
                    continue                    # someone redeployed first
                done = self._building.get(asset_id)
                if done is None:
                    done = self._building[asset_id] = threading.Event()
                    break                       # we are the builder
            # another thread is building this asset: wait, then re-check —
            # if its build failed we loop around and build it ourselves
            done.wait()
        try:
            service_kw = dict(self.service_kw)
            service_kw.setdefault("metrics", self.metrics)
            if qos is not None:
                service_kw["qos"] = qos             # per-deploy override
            if service_overrides:
                service_kw.update(service_overrides)
            wrapper = self.registry.get(asset_id).build(device=device,
                                                        **build_kw)
            service = make_service(wrapper, service_mode or self.service_mode,
                                   **service_kw)
            dep = Deployment(asset_id, service)
            with self._lock:
                self._deployments[asset_id] = dep
            return dep
        finally:
            with self._lock:
                self._building.pop(asset_id, None)
            done.set()

    def undeploy(self, asset_id: str) -> bool:
        with self._lock:
            dep = self._deployments.pop(asset_id, None)
        if dep is None:
            return False
        dep.service.close()
        # finished requests hold a closed service in reference cycles (a
        # token sink closes over its service): collect them now, so the
        # deployment's weights and KV cache leave the card before a
        # redeploy builds the next one
        del dep
        gc.collect()
        return True

    def get(self, asset_id: str) -> Deployment:
        try:
            return self._deployments[asset_id]
        except KeyError:
            raise KeyError(f"asset {asset_id!r} is not deployed") from None

    def deployed(self) -> List[str]:
        return sorted(self._deployments)

    def health(self) -> Dict[str, Any]:
        # mesh_slice / replicas keep the JAX package's envelope: one
        # replica, no slice
        return {
            aid: {
                "uptime_s": round(_now() - d.created_at, 1),
                "requests": d.stats.requests,
                "errors": d.stats.errors,
                "mean_latency_ms": round(d.stats.mean_latency_ms, 2),
                "mesh_slice": None,
                "service": d.service.kind,
                "replicas": 1,
            }
            for aid, d in list(self._deployments.items())
        }
