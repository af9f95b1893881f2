"""Model configuration system.

Every architecture in the exchange is described by a single frozen
``ModelConfig``. Configs are *data*: model code in ``repro_torch.models``
consumes them and the MAX registry exposes them as discoverable assets.
This is the PyTorch port's own copy of the JAX package's
``repro.configs.base``; the two must stay field-for-field identical so a
config means the same model on both sides.

Conventions
-----------
- ``vocab_size`` is the *logical* vocabulary from the source model card;
  ``padded_vocab_size`` rounds up to a multiple of ``VOCAB_PAD`` so the
  embedding/LM-head shard evenly over the 16-way ``model`` mesh axis.
- For MoE configs ``d_ff`` is the *per-expert* hidden width (matching the
  assignment table) and every layer is an MoE layer unless
  ``moe_layer_period`` says otherwise.
- ``block_pattern`` describes hybrid stacking (e.g. RecurrentGemma's
  recurrent/recurrent/attention blocks). Empty pattern = uniform stack.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

VOCAB_PAD = 256  # multiple that keeps vocab shardable over 16-way TP


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    # -- identity -----------------------------------------------------------
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    source: str = ""                 # citation for the config numbers

    # -- core transformer dims ---------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # explicit; NOT always d_model//num_heads
    d_ff: int = 0                    # dense MLP width, or per-expert width
    vocab_size: int = 0              # logical vocab

    # -- attention ----------------------------------------------------------
    qk_norm: bool = False            # Qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # enables long-context decode
    attn_logit_softcap: Optional[float] = None

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    router_z_loss_coef: float = 0.0001

    # -- hybrid (RecurrentGemma) ---------------------------------------------
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn")
    lru_width: int = 0                     # RG-LRU recurrence width
    local_attn_window: int = 0             # window for hybrid local attention

    # -- SSM / RWKV6 ----------------------------------------------------------
    rwkv_head_dim: int = 64

    # -- encoder-decoder (Whisper) --------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0                   # fixed frame count (1500)
    cross_attention: bool = False
    decoder_only_decode: bool = True       # decode shapes exercise decoder

    # -- VLM -------------------------------------------------------------------
    num_image_tokens: int = 0              # stub patch embeddings prepended

    # -- misc -------------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Schedule hint consumed by training/schedule.py (MiniCPM uses WSD).
    lr_schedule: str = "cosine"            # cosine | wsd

    # ======================================================================
    # derived quantities
    # ======================================================================
    @property
    def padded_vocab_size(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if the architecture can decode at 512k (sub-quadratic path)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    # -- hybrid stacking ------------------------------------------------------
    @property
    def num_pattern_blocks(self) -> int:
        if not self.block_pattern:
            return 0
        return self.num_layers // len(self.block_pattern)

    @property
    def num_tail_layers(self) -> int:
        """Layers left over after whole pattern blocks (RG-9b: 38 = 12*3 + 2).

        Tail layers are recurrent (the pattern's majority type).
        """
        if not self.block_pattern:
            return 0
        return self.num_layers - self.num_pattern_blocks * len(self.block_pattern)

    # -- parameter counting (analytic, used by roofline) -----------------------
    def attn_params(self) -> int:
        d, q, kv = self.d_model, self.q_dim, self.kv_dim
        return d * q + 2 * d * kv + q * d  # wq, wk, wv, wo

    def mlp_params(self) -> int:
        # gated SwiGLU: up, gate, down
        return 3 * self.d_model * self.d_ff

    def moe_layer_params(self) -> int:
        return self.num_experts * self.mlp_params() + self.d_model * self.num_experts

    def rglru_params(self) -> int:
        d, w = self.d_model, self.lru_width
        # in/out projections (x2 gated branches) + recurrence gates + diag a
        return 2 * d * w + w * d + 2 * w * w // 8 + 2 * w  # block-diag gates (8 blocks)

    def rwkv_layer_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,o projections + decay/bonus + lora mixers
        tm = 5 * d * d + 2 * d + 6 * d * 96
        cm = 2 * d * self.d_ff + self.d_ff * 0  # rwkv6 channel mix: k, v (+r gate d*d)
        cm = d * self.d_ff + self.d_ff * d + d * d
        return tm + cm

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + layers + head)."""
        d = self.d_model
        emb = self.padded_vocab_size * d
        head = 0 if self.tie_embeddings else self.padded_vocab_size * d
        total = emb + head

        if self.family == "ssm":
            total += self.num_layers * self.rwkv_layer_params()
            return total

        if self.family == "hybrid":
            n_attn = sum(
                1 for i in range(self.num_layers)
                if self.layer_type(i) == "attn"
            )
            n_rec = self.num_layers - n_attn
            per_mlp = self.mlp_params()
            total += n_attn * (self.attn_params() + per_mlp)
            total += n_rec * (self.rglru_params() + per_mlp)
            return total

        per_layer = self.attn_params()
        per_layer += self.moe_layer_params() if self.is_moe else self.mlp_params()
        total += self.num_layers * per_layer
        if self.family == "audio":
            # encoder stack + decoder cross-attention
            enc = self.encoder_layers * (self.attn_params() + self.mlp_params())
            cross = self.num_layers * self.attn_params()
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        emb = self.padded_vocab_size * d
        head = 0 if self.tie_embeddings else self.padded_vocab_size * d
        per_layer = self.attn_params()
        per_layer += self.num_experts_per_tok * self.mlp_params()
        per_layer += self.d_model * self.num_experts  # router
        return emb + head + self.num_layers * per_layer

    def layer_type(self, i: int) -> str:
        """Layer type at depth i: 'attn' | 'rec' | 'moe' | 'dense' | 'rwkv'."""
        if self.family == "ssm":
            return "rwkv"
        if self.block_pattern:
            if i >= self.num_pattern_blocks * len(self.block_pattern):
                return self.block_pattern[0]  # tail layers take majority type
            return self.block_pattern[i % len(self.block_pattern)]
        return "moe" if self.is_moe else "attn"

    def validate(self) -> None:
        assert self.d_model > 0 and self.num_layers > 0
        assert self.vocab_size > 0
        if self.family != "ssm":
            assert self.num_heads > 0 and self.head_dim > 0
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                f"{self.name}: heads {self.num_heads} not grouped by kv "
                f"{self.num_kv_heads}"
            )
        if self.is_moe:
            assert 0 < self.num_experts_per_tok <= self.num_experts
        if self.family == "hybrid":
            assert self.block_pattern and self.lru_width > 0
        if self.family == "audio":
            assert self.encoder_layers > 0 and self.encoder_seq > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# smoke-test reduction
# ---------------------------------------------------------------------------

def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts.

    The reduced config preserves the family's structure (GQA grouping, MoE
    top-k, hybrid pattern, enc-dec, VLM stub) so the smoke test exercises the
    same code paths as the full config.
    """
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=256,
        d_ff=512,
        vocab_size=512,
    )
    if cfg.family == "ssm":
        kw.update(num_heads=256 // cfg.rwkv_head_dim,
                  num_kv_heads=256 // cfg.rwkv_head_dim, head_dim=cfg.rwkv_head_dim)
    else:
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
                  head_dim=64)
        if cfg.num_kv_heads == cfg.num_heads:   # MHA stays MHA
            kw["num_kv_heads"] = 4
        if cfg.num_kv_heads == 1:               # MQA stays MQA
            kw["num_kv_heads"] = 1
    if cfg.is_moe:
        kw.update(num_experts=4, num_experts_per_tok=min(2, cfg.num_experts_per_tok))
    if cfg.family == "hybrid":
        # one (rec, attn) miniature of the pattern -> 2 layers
        kw.update(block_pattern=("rec", "attn"), num_layers=2, lru_width=256,
                  local_attn_window=min(cfg.local_attn_window, 128) or 64)
    if cfg.family == "audio":
        kw.update(encoder_layers=2, encoder_seq=64)
    if cfg.family == "vlm":
        kw.update(num_image_tokens=8)
    if cfg.sliding_window is not None:
        kw.update(sliding_window=64)
    return cfg.replace(**kw)
