"""The MAX framework of the PyTorch port (counterpart of ``repro.core``).

- wrapper.py    MAXModelWrapper + standardized envelope (Sec. 2.2.1)
- registry.py   the model exchange catalogue (Sec. 2.2.2)
- assets.py     the wrapped assets the port serves
- router.py     declarative versioned route table + OpenAPI projection
- service.py    the execution strategy (continuous batching)
- api.py        standardized RESTful API, v1 + v2 (Sec. 2.2.3)
- deployment.py the deployment unit and its manager
"""

from repro_torch.core.wrapper import MAXError, MAXModelWrapper, ModelMetadata
from repro_torch.core.registry import EXCHANGE, ModelAsset, ModelRegistry
from repro_torch.core.service import (
    BatchedService, InferenceService, ServiceOverloaded, make_service,
)
from repro_torch.core.deployment import Deployment, DeploymentManager
from repro_torch.core.router import RequestCtx, Response, Route, Router
from repro_torch.core.api import ApiError, MAXServer, build_router, build_swagger

__all__ = [
    "ApiError", "BatchedService", "Deployment", "DeploymentManager",
    "EXCHANGE", "InferenceService", "MAXError", "MAXModelWrapper",
    "MAXServer", "ModelAsset", "ModelMetadata", "ModelRegistry",
    "RequestCtx", "Response", "Route", "Router", "ServiceOverloaded",
    "build_router", "build_swagger", "make_service",
]
