"""Token sampling pieces (counterpart of ``repro/serving/sampling.py``).

Sampling is sync-free on the device: greedy is an argmax, temperature
sampling is Gumbel-max with noise drawn from an explicit
``torch.Generator`` (``argmax(logits / T + g)``, ``g = -log(-log(u))``,
is a draw from ``softmax(logits / T)``). The JAX package draws from
``jax.random`` instead, so sampled tokens agree in distribution, not
token for token.
"""

from __future__ import annotations

from typing import Optional

import torch


def mask_padded_vocab(logits, logical_vocab: int):
    V = logits.shape[-1]
    if V == logical_vocab:
        return logits
    col = torch.arange(V, device=logits.device) < logical_vocab
    return torch.where(col, logits, -1e9)


def gumbel_noise(shape, generator: Optional[torch.Generator], device):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 1e-7)))
