"""RWKV6-7B (Finch) — attention-free, data-dependent decay [arXiv:2404.05892].

Time-mix state is O(1) in sequence length, so all decode shapes including
``long_500k`` run natively. heads = d_model / 64 = 64.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=14_336,
    vocab_size=65_536,
    norm_eps=1e-5,
)
