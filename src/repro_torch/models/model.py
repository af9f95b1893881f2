"""Unified model API (counterpart of ``repro/models/model.py``).

``build_model(cfg)`` returns a :class:`Model` of plain functions over a
parameter dict and tensors:

- ``init(generator, device) -> params``
- ``forward(params, batch) -> logits``
- ``loss(params, batch) -> (scalar, metrics)`` (cross entropy, plus the
  router's aux losses for MoE, as the JAX package's)
- ``prefill(params, batch, cache_len=None) -> (last_logits, cache)``
- ``decode_step(params, cache, tokens, active=None) -> (logits, cache)``
- ``init_cache(batch, seq_len, device, paged=None) -> cache``

Every family the port serves (dense, MoE, hybrid, SSM) is decoder-only and
goes to ``models/transformer.py``, which branches by ``cfg.family`` as
the JAX package's does (the JAX package's audio family goes to
``encdec``, not ported). The default types are the JAX package's: f32
parameters, a bf16 cache. ``init`` and ``init_cache`` default to
``device="cuda"`` and raise without a GPU.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

F32 = torch.float32


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def cross_entropy(logits, targets, cfg: ModelConfig, mask=None):
    """logits [..., V_padded] f32; targets int < logical vocab. Padded vocab
    columns are excluded from the partition function."""
    V = cfg.padded_vocab_size
    if V != cfg.vocab_size:
        logits = torch.cat([logits[..., :cfg.vocab_size],
                            logits[..., cfg.vocab_size:] - 1e9], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def build_model(cfg: ModelConfig, param_dtype=F32,
                cache_dtype=torch.bfloat16) -> Model:
    def init(generator=None, device="cuda"):
        return transformer.init_params(cfg, param_dtype, device=device,
                                       generator=generator)

    def forward(params, batch):
        return transformer.forward(params, batch, cfg)

    def loss(params, batch):
        logits, (lb, z) = transformer.forward(params, batch, cfg,
                                             return_aux=True)
        ce = cross_entropy(logits, batch["targets"], cfg,
                           batch.get("loss_mask"))
        total, metrics = ce, {"ce": ce}
        if cfg.is_moe:
            total = ce + cfg.router_aux_loss_coef * lb \
                + cfg.router_z_loss_coef * z
            metrics.update(moe_lb=lb, moe_z=z)
        metrics["loss"] = total
        return total, metrics

    def prefill(params, batch, cache_len=None):
        return transformer.prefill(params, batch, cfg, cache_len=cache_len,
                                   cache_dtype=cache_dtype)

    def decode_step(params, cache, tokens, active=None):
        return transformer.decode_step(params, cache, tokens, cfg,
                                       active=active)

    def init_cache(batch_size, seq_len, device="cuda", paged=None):
        return transformer.init_cache(cfg, batch_size, seq_len, cache_dtype,
                                      device=device, paged=paged)

    return Model(cfg, init, forward, loss, prefill, decode_step, init_cache)
