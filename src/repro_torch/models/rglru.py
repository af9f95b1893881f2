"""Griffin/RecurrentGemma recurrent block: conv1d(4) + RG-LRU
(counterpart of ``repro/models/rglru.py``).

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate, block-diagonal)
    i_t = sigmoid(W_x x_t + b_x)          (input gate, block-diagonal)
    a_t = exp(-c * softplus(Lambda) * r_t)            c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is elementwise (diagonal). Prefill runs it through
``kernels/ops.py::rglru_scan``: the CUDA kernel for CUDA tensors, the
plain sequential scan for CPU tensors (the JAX package's CPU path is an
associative scan: the same function, summed in another order). Decode is
a single O(1) state update in plain PyTorch, as in JAX.

Block layout (Griffin Fig. 2): x -> [branch A: linear -> GeLU]
                                  [branch B: linear -> conv1d(4) -> RG-LRU]
                               merge A*B -> linear out.

Parameter leaves keep the JAX package's shapes, with an optional leading
stack (``lead``) as ``transformer.init_params`` draws whole layer stacks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import _matmul_f32, dense_init

F32 = torch.float32
NUM_BLOCKS = 8
CONV_WIDTH = 4
RGLRU_C = 8.0


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rglru_init(cfg, dtype, device, gen, lead=()):
    d, w = cfg.d_model, cfg.lru_width
    bw = w // NUM_BLOCKS
    lead = tuple(lead)

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=F32, device=device)

    lam = torch.linspace(0.3, 1.5, w, dtype=F32, device=device)
    return {
        "w_in_rnn": dense_init(lead + (d, w), d, dtype, device, gen),
        "w_in_gate": dense_init(lead + (d, w), d, dtype, device, gen),
        "w_out": dense_init(lead + (w, d), w, dtype, device, gen),
        "conv_w": dense_init(lead + (CONV_WIDTH, w), CONV_WIDTH, dtype,
                             device, gen),
        "conv_b": zeros(w),
        "gate_a_w": dense_init(lead + (NUM_BLOCKS, bw, bw), bw, F32, device,
                               gen),
        "gate_a_b": zeros(w),
        "gate_x_w": dense_init(lead + (NUM_BLOCKS, bw, bw), bw, F32, device,
                               gen),
        "gate_x_b": zeros(w),
        # softplus(lambda) init so a^c spans ~(0.9, 0.999)
        "lam": lam.expand(lead + (w,)).clone(),
    }


def _block_linear(x, w, b):
    """x [..., W] with block-diagonal w [NB, bw, bw] -> [..., W]."""
    nb, bw = w.shape[0], w.shape[1]
    xb = x.reshape(tuple(x.shape[:-1]) + (nb, bw))
    yb = torch.einsum("...ni,nij->...nj", xb.float(), w)
    return yb.reshape(x.shape) + b


def _gates(params, x):
    """a_t and the gated input b_t. x [..., W] f32."""
    r = torch.sigmoid(_block_linear(x, params["gate_a_w"],
                                    params["gate_a_b"]))
    i = torch.sigmoid(_block_linear(x, params["gate_x_w"],
                                    params["gate_x_b"]))
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r        # [..., W] <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, mult * (i * x)


def rglru_scan(params, x):
    """Sequence form. x [B, S, W] -> h [B, S, W] (f32 in, f32 out)."""
    a, b = _gates(params, x.float())
    h, _ = _kops.rglru_scan(a, b)
    return h


def rglru_step(params, x_t, h_prev):
    """Decode step. x_t [B, W], h_prev [B, W] -> (h_t, h_t)."""
    a, b = _gates(params, x_t.float())
    h = a * h_prev + b
    return h, h


# ---------------------------------------------------------------------------
# temporal conv1d (depthwise, width 4, causal)
# ---------------------------------------------------------------------------

def conv1d_scan(params, x):
    """x [B, S, W] -> [B, S, W]; causal depthwise conv of width 4."""
    w, b = params["conv_w"].float(), params["conv_b"]
    out = x.float() * w[-1]
    for i in range(1, CONV_WIDTH):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i].float()
        out = out + shifted * w[CONV_WIDTH - 1 - i]
    return out + b


def conv1d_step(params, x_t, conv_state):
    """x_t [B, W]; conv_state [B, CONV_WIDTH-1, W] (previous inputs, oldest
    first). Returns (y_t [B, W], new_state)."""
    w, b = params["conv_w"], params["conv_b"]
    hist = torch.cat([conv_state, x_t[:, None].to(conv_state.dtype)], dim=1)
    y = torch.einsum("btw,tw->bw", hist.float(), w.float()) + b
    return y, hist[:, 1:]


# ---------------------------------------------------------------------------
# full recurrent block
# ---------------------------------------------------------------------------

def recurrent_block_apply(params, x, *, return_state: bool = False):
    """Prefill/scoring. x [B, S, d] -> [B, S, d] (+ final decode state)."""
    gate = gelu(_matmul_f32(x, params["w_in_gate"]))
    rnn_in = _matmul_f32(x, params["w_in_rnn"]).to(x.dtype)
    conv_out = conv1d_scan(params, rnn_in)
    h = rglru_scan(params, conv_out)
    merged = (gate * h).to(x.dtype)
    y = _matmul_f32(merged, params["w_out"]).to(x.dtype)
    if not return_state:
        return y
    state = {
        "h": h[:, -1],
        "conv": rnn_in[:, -(CONV_WIDTH - 1):].float(),
    }
    return y, state


def recurrent_block_step(params, x_t, state):
    """Decode. x_t [B, d]; state {'h': [B, W], 'conv': [B, 3, W]}."""
    gate = gelu(_matmul_f32(x_t, params["w_in_gate"]))
    rnn_in = _matmul_f32(x_t, params["w_in_rnn"]).to(x_t.dtype)
    conv_out, conv_state = conv1d_step(params, rnn_in, state["conv"])
    h, _ = rglru_step(params, conv_out, state["h"])
    merged = (gate * h).to(x_t.dtype)
    y = _matmul_f32(merged, params["w_out"]).to(x_t.dtype)
    return y, {"h": h, "conv": conv_state}


def recurrent_state_init(cfg, batch, device):
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=F32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, w), dtype=F32,
                            device=device),
    }
