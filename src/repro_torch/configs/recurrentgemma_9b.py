"""RecurrentGemma-9B — RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427].

38 layers = 12 x (rec, rec, attn) blocks + 2 tail recurrent layers.
Local attention window 2048; MQA (kv=1). Long-context decode is native:
RG-LRU state is O(1) in sequence length and the attention cache is bounded
by the window.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,        # MQA
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_attn_window=2048,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
)
