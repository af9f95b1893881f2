"""JAX-package parameters -> the port's parameters.

The input is either the nested dict of numpy arrays the JAX package's
``build_model(cfg).init`` gives after ``tree_map(np.asarray, params)``,
or the flat ``"layers/attn/wq"``-keyed arrays of a
``training/checkpoint.py`` ``.npz`` (the hybrid's ``"blocks/l0/rec/..."``
and ``"tail/..."``, the SSM's ``"layers/tm/..."`` and ``"layers/cm/..."``,
MoE's ``"layers/moe/w_router|w_gate|w_up|w_down"`` alike). Both packages
keep the same stacked layouts, so each leaf crosses over as it is; only
the container changes. This module never imports jax: callers do the
jax -> numpy step.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

SEP = "/"


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"layers/attn/wq": a, ...}`` -> ``{"layers": {"attn": {"wq": a}}}``."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def to_torch_params(params: Mapping[str, Any], *, device="cuda",
                    dtype=None) -> Dict[str, Any]:
    """Nested or flat numpy parameters -> nested dict of tensors on
    ``device`` (``dtype`` casts floating leaves; default keeps them)."""
    device = resolve_device(device)
    if any(SEP in k for k in params):
        params = unflatten(params)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: no numpy->torch path
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(params)


def check_like(params: Mapping[str, Any], like: Mapping[str, Any],
               path: str = "") -> None:
    """Raise ``ValueError`` unless ``params`` has exactly the keys and leaf
    shapes of ``like`` (e.g. ``model.init(None, "meta")``)."""
    if set(params) != set(like):
        raise ValueError(f"parameter keys at {path or '/'}: got "
                         f"{sorted(params)}, expected {sorted(like)}")
    for k, v in like.items():
        where = f"{path}{SEP}{k}" if path else k
        if isinstance(v, Mapping):
            if not isinstance(params[k], Mapping):
                raise ValueError(f"parameter {where}: expected a subtree")
            check_like(params[k], v, where)
        elif tuple(params[k].shape) != tuple(v.shape):
            raise ValueError(f"parameter {where}: shape "
                             f"{tuple(params[k].shape)}, expected "
                             f"{tuple(v.shape)}")
