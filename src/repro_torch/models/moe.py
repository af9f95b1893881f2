"""Mixture-of-Experts layer: top-k router + capacity-bucketed scatter
dispatch (counterpart of ``repro/models/moe.py``).

1. Router: ``logits = x @ w_router`` in f32 -> softmax -> top-k (sorted,
   as ``jax.lax.top_k``), the probabilities renormalised over the k.
2. Position-in-expert by a one-hot cumsum over the assignments in
   token-major, k-minor order; an assignment past the capacity ``C`` of
   its expert goes to the sink slot ``E*C`` (token dropping). Which
   assignment overflows depends on that order: padded prompt tokens come
   after the real ones, so they never take a real token's slot.
3. Scatter to ``[E*C (+1 sink), d]``, three grouped matmuls (gate, up,
   down) with SiLU gating through ``kernels/ops.py::gmm`` (the CUDA kernel
   for CUDA tensors, its plain version on the CPU), then gather and
   combine weighted by the router's probabilities.

``C`` depends on how many tokens share the call, so a forward over T
tokens and a prefill followed by decode steps are the same function only
when neither drops an assignment; a decode step of B <= 8 tokens never
drops (``C >= 8 >= B``).

The aux losses (Switch load balance, router z-loss) are returned as in
JAX; serving ignores them. Parameter leaves keep the JAX package's shapes,
with an optional leading stack (``lead``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import _matmul_f32, dense_init

F32 = torch.float32


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar
    z_loss: torch.Tensor              # scalar
    expert_fraction: torch.Tensor     # [E] tokens routed per expert / T


def moe_init(cfg, dtype, device, gen, lead=()):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    return {
        "w_router": dense_init(lead + (d, E), d, F32, device, gen),  # f32
        "w_gate": dense_init(lead + (E, d, f), d, dtype, device, gen),
        "w_up": dense_init(lead + (E, d, f), d, dtype, device, gen),
        "w_down": dense_init(lead + (E, f, d), f, dtype, device, gen),
    }


def capacity(num_tokens: int, num_experts: int, k: int, factor: float) -> int:
    c = int(math.ceil(num_tokens * k / num_experts * factor))
    return max(8, ((c + 7) // 8) * 8)  # a multiple of 8, as the JAX package


def _one_hot(idx, n: int):
    """int32 one-hot of ``idx`` over ``n`` classes (no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def dispatch_slots(top_i, num_experts: int, cap: int):
    """top_i [T, K] -> slot [T*K]: ``expert * cap + position`` for each
    assignment, in token-major, k-minor order; ``num_experts * cap`` (the
    sink) past an expert's capacity."""
    flat_e = top_i.reshape(-1)
    onehot = _one_hot(flat_e, num_experts)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    return torch.where(pos < cap, flat_e * cap + pos, num_experts * cap)


def moe_apply(params, x, cfg, *, capacity_factor=None):
    """x [B, S, d] -> (y [B, S, d], MoEAux)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = capacity(T, E, K, capacity_factor or cfg.moe_capacity_factor)
    xf = x.reshape(T, d)

    # ---- route
    logits = _matmul_f32(xf.float(), params["w_router"])          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1, sorted=True)      # [T, K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- dispatch (every non-sink slot is written at most once; the
    #      sink row takes the overflow in any order and is discarded)
    slot = dispatch_slots(top_i, E, C)                            # [T*K]
    token_idx = torch.arange(T * K, device=x.device) // K
    dispatched = xf.new_zeros((E * C + 1, d))
    dispatched.index_copy_(0, slot, xf.index_select(0, token_idx))
    dx = dispatched[:E * C].view(E, C, d)

    # ---- expert compute: three grouped matmuls
    gate = _kops.gmm(dx, params["w_gate"]).float()
    up = _kops.gmm(dx, params["w_up"]).float()
    h = (F.silu(gate) * up).to(x.dtype)
    dy = _kops.gmm(h, params["w_down"]).to(x.dtype)

    # ---- combine
    dy_flat = torch.cat([dy.reshape(E * C, d), dy.new_zeros((1, d))])
    per_assign = dy_flat.index_select(0, slot)                    # [T*K, d]
    weighted = per_assign * top_p.reshape(T * K, 1).to(x.dtype)
    y = weighted.view(T, K, d).sum(dim=1)

    # ---- aux losses: fraction of assignments per expert vs mean router
    #      probability (Switch eq. 4-6), and the router z-loss
    frac = _one_hot(top_i, E).to(F32).mean(dim=(0, 1)) * K
    mean_prob = probs.mean(dim=0)
    lb = E * (frac / K * mean_prob).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return y.view(B, S, d), MoEAux(lb, z, frac)
