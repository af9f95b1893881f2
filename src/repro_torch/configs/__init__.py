"""Config registry of the PyTorch port: ``get_config(arch_id)``.

Only the architectures the port serves are registered; the JAX package's
registry (``repro.configs``) lists every assigned architecture.
"""

from repro_torch.configs.base import ModelConfig, pad_to, reduce_for_smoke
from repro_torch.configs.phi35_moe_42b_a66b import CONFIG as _phi35_moe
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rg_9b
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6_7b

CONFIGS: dict[str, ModelConfig] = {
    c.name: c for c in (_qwen3_4b, _rg_9b, _rwkv6_7b, _phi35_moe,
                         _qwen3_moe)}

for _c in CONFIGS.values():
    _c.validate()


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]


__all__ = ["CONFIGS", "ModelConfig", "get_config", "pad_to",
           "reduce_for_smoke"]
