"""Qwen3-4B — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (4B sibling per assignment)",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
    sliding_window=4096,   # enables long_500k decode (beyond-paper variant)
)
