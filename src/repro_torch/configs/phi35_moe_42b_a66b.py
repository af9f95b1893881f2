"""Phi-3.5-MoE — 16-expert top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,             # per-expert
    vocab_size=32_064,
    num_experts=16,
    num_experts_per_tok=2,
    rope_theta=10_000.0,
    norm_eps=1e-5,
)
