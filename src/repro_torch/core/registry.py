"""The Model Asset eXchange registry — paper Section 2.2.2 (the PyTorch
port's copy of ``repro/core/registry.py``).

An :class:`ModelAsset` binds metadata + a :class:`ModelConfig` + a builder
that produces a ready :class:`MAXModelWrapper` (params initialised or loaded
from a checkpoint). The registry is the discoverable catalogue: MAX shipped
30+ wrapped models; the port registers the assets it can serve so far, and
users add theirs via ``register``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.wrapper import MAXModelWrapper, ModelMetadata


@dataclass
class ModelAsset:
    metadata: ModelMetadata
    config: ModelConfig
    builder: Callable[..., MAXModelWrapper]      # (asset, **kw) -> wrapper
    tags: tuple = ()

    def build(self, **kw) -> MAXModelWrapper:
        return self.builder(self, **kw)


class ModelRegistry:
    def __init__(self):
        self._assets: Dict[str, ModelAsset] = {}
        self._lock = threading.Lock()

    def register(self, asset: ModelAsset, *, overwrite: bool = False):
        with self._lock:
            if asset.metadata.id in self._assets and not overwrite:
                raise ValueError(f"asset {asset.metadata.id!r} already registered")
            self._assets[asset.metadata.id] = asset
        return asset

    def get(self, asset_id: str) -> ModelAsset:
        try:
            return self._assets[asset_id]
        except KeyError:
            raise KeyError(
                f"unknown asset {asset_id!r}; have {sorted(self._assets)}") from None

    def list(self, *, type_filter: Optional[str] = None,
             tag: Optional[str] = None) -> List[ModelAsset]:
        out = []
        for a in self._assets.values():
            if type_filter and a.metadata.type != type_filter:
                continue
            if tag and tag not in a.tags:
                continue
            out.append(a)
        return sorted(out, key=lambda a: a.metadata.id)

    def __contains__(self, asset_id: str) -> bool:
        return asset_id in self._assets

    def __len__(self) -> int:
        return len(self._assets)


# The process-wide exchange (populated by repro_torch.core.assets on import).
EXCHANGE = ModelRegistry()
