"""Qwen3-MoE-235B-A22B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,          # Qwen3 uses head_dim=128 decoupled from d_model
    d_ff=1536,             # per-expert intermediate width
    vocab_size=151_936,
    num_experts=128,
    num_experts_per_tok=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)
