"""Concrete wrappers + the populated exchange (counterpart of
``repro/core/assets.py``; the text-generation assets of the dense, MoE,
hybrid and SSM families so far).

Builders default to the REDUCED config (same family, 2 layers) like the
JAX package; ``smoke=False`` selects the full published widths. Weights
are random, drawn on the target device from a seeded ``torch.Generator``
(a full-width init through the host would take minutes), or come from the
JAX package through ``params=`` (numpy, see ``models/convert.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch

from repro_torch.configs import CONFIGS
from repro_torch.configs.base import ModelConfig, reduce_for_smoke
from repro_torch.core.registry import EXCHANGE, ModelAsset
from repro_torch.core.wrapper import MAXError, MAXModelWrapper, ModelMetadata
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.models.convert import check_like, to_torch_params
from repro_torch.serving import GenerationEngine, GenerationResult

_TYPE_BY_FAMILY = {"dense": "Text Generation", "moe": "Text Generation",
                   "hybrid": "Text Generation", "ssm": "Text Generation"}


class _EngineWrapper(MAXModelWrapper):
    """Shared plumbing: model + params + generation engine."""

    def __init__(self, asset: ModelAsset, *, smoke: bool = True,
                 max_batch: int = 4, max_seq: int = 128, seed: int = 0,
                 decode_chunk: int = 8, paged: bool = False,
                 page_size: int = 16, kv_pool_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 device: DeviceLike = "cuda",
                 params: Optional[Mapping[str, Any]] = None):
        dev = resolve_device(device)
        cfg = asset.config
        if smoke:
            cfg = reduce_for_smoke(cfg)
        self.cfg = cfg
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.params = self.model.init(gen, dev)
        else:
            self.params = to_torch_params(params, device=dev)
            check_like(self.params, self.model.init(None, "meta"))
        self.engine = GenerationEngine(self.model, self.params,
                                       max_batch=max_batch, max_seq=max_seq,
                                       eos_id=TOKENIZER.eos_id,
                                       decode_chunk=decode_chunk,
                                       paged=paged, page_size=page_size,
                                       kv_pool_blocks=kv_pool_blocks,
                                       prefix_cache=prefix_cache,
                                       prefix_cache_pages=prefix_cache_pages,
                                       device=dev)
        self.MODEL_META_DATA = asset.metadata

    def _result(self, tokens: List[int], prompt_len: int) -> GenerationResult:
        return GenerationResult(tokens=list(tokens), prompt_len=prompt_len,
                                steps=len(tokens), finished=True)

    def format_stream_delta(self, token_ids: List[int]):
        # byte-level tokenizer: chunk decodes concatenate to the full text
        # (a multi-byte codepoint split across chunks renders as
        # replacement chars in the delta only; clients always get the ids)
        return TOKENIZER.decode(token_ids)


class TextGenerationWrapper(_EngineWrapper):
    def _pre_process(self, inp: Any) -> Dict[str, Any]:
        if isinstance(inp, str):
            inp = {"text": inp}
        if not isinstance(inp, dict) or "text" not in inp:
            raise MAXError("input must be a string or {'text': ...}")
        toks = TOKENIZER.encode(str(inp["text"]))
        # longest ADMISSIBLE prompt: ring caches pad prompts to their
        # bucket and treat the padding as context
        max_len = self.engine.max_prompt_len()
        return {
            "tokens": toks[:max_len],
            "max_new_tokens": int(inp.get("max_new_tokens", 16)),
            "temperature": float(inp.get("temperature", 0.0)),
        }

    def _predict(self, x: Dict[str, Any]) -> Any:
        res = self.engine.generate(
            [x["tokens"]], max_new_tokens=x["max_new_tokens"],
            temperature=x["temperature"])
        return res[0]

    def _post_process(self, r) -> Any:
        out = {"generated_text": TOKENIZER.decode(r.tokens),
               "generated_tokens": len(r.tokens),
               "prompt_tokens": r.prompt_len}
        if r.first_token_s is not None:
            out["ttft_ms"] = round(r.first_token_s * 1e3, 3)
        return [out]

    # generation protocol — lets BatchedService coalesce concurrent
    # requests into one decode batch
    def prepare_generation(self, inp: Any):
        x = self._pre_process(inp)
        return x["tokens"], {"max_new_tokens": x["max_new_tokens"],
                             "temperature": x["temperature"]}, None

    def format_generation(self, tokens: List[int], prompt_len: int) -> Any:
        return self._post_process(self._result(tokens, prompt_len))


def _make_asset(cfg: ModelConfig) -> ModelAsset:
    t = _TYPE_BY_FAMILY[cfg.family]
    meta = ModelMetadata(
        id=cfg.name,
        name=cfg.name.replace("-", " ").title(),
        description=(f"{cfg.family} backbone, {cfg.num_layers}L "
                     f"d={cfg.d_model} ({cfg.param_count() / 1e9:.1f}B "
                     "params)"),
        type=t,
        source=cfg.source,
    )
    return ModelAsset(metadata=meta, config=cfg,
                      builder=lambda asset, **kw: TextGenerationWrapper(
                          asset, **kw),
                      tags=(cfg.family,))


def populate_exchange():
    if len(EXCHANGE) > 0:
        return EXCHANGE
    for cfg in CONFIGS.values():
        EXCHANGE.register(_make_asset(cfg))
    return EXCHANGE


populate_exchange()
