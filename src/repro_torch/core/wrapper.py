"""The MAX framework wrapper — the paper's Section 2.2.1 (the PyTorch port's
copy of ``repro/core/wrapper.py``).

To wrap a model you inherit :class:`MAXModelWrapper`, declare
``MODEL_META_DATA``, and implement ``_pre_process`` / ``_predict`` /
``_post_process``. ``predict()`` chains them and the API layer wraps the
result in the standardized envelope ``{"status": "ok", "predictions": ...}``
(paper Fig. 3 / the sentiment-classifier JSON example).

The paper's wrappers hide *frameworks* (TF vs PyTorch vs Theano); a caller
of this wrapper cannot tell the PyTorch port from the JAX package: the
envelopes are the same.
"""

from __future__ import annotations

import abc
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.serving.tracing import now as _now


@dataclass(frozen=True)
class ModelMetadata:
    """Standardized asset metadata (paper: /model/metadata endpoint)."""
    id: str
    name: str
    description: str
    type: str                       # e.g. "Text Classification"
    source: str = ""
    license: str = "Apache-2.0"
    framework: str = "pytorch"
    version: str = "1.0.0"
    labels: tuple = ()

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        d["labels"] = list(self.labels)
        return d


class MAXError(Exception):
    """Raised by wrappers for client-visible failures (400-class)."""


class PromptTooLong(MAXError):
    """The tokenized prompt leaves no KV generation headroom — rejected at
    validation time (structured ``PROMPT_TOO_LONG``, HTTP 400) instead of
    burning a prefill + decode slot just to retire with nothing
    generated."""


class MAXModelWrapper(abc.ABC):
    """Base wrapper. Subclasses set MODEL_META_DATA and implement hooks.

    The contract (paper Section 2.2.1-2.2.2): wrapping only requires
    inheriting this class and converting model input/output to data
    structures the framework accepts — JSON-compatible Python values.
    """

    MODEL_META_DATA: ModelMetadata

    def _pre_process(self, inp: Any) -> Any:
        return inp

    @abc.abstractmethod
    def _predict(self, x: Any) -> Any:
        ...

    def _post_process(self, result: Any) -> Any:
        return result

    # -- public, standardized API ------------------------------------------

    @property
    def metadata(self) -> ModelMetadata:
        return self.MODEL_META_DATA

    def predict(self, inp: Any) -> Any:
        """pre -> predict -> post. Returns JSON-compatible predictions."""
        pre = self._pre_process(inp)
        raw = self._predict(pre)
        return self._post_process(raw)

    def predict_envelope(self, inp: Any) -> Dict[str, Any]:
        """The standardized response envelope (paper Fig. 3)."""
        t0 = _now()
        try:
            preds = self.predict(inp)
            return {
                "status": "ok",
                "predictions": preds,
                "model_id": self.metadata.id,
                "latency_ms": round((_now() - t0) * 1e3, 3),
            }
        except MAXError as e:
            return {"status": "error", "error": str(e),
                    "model_id": self.metadata.id}

    # -- optional batch hook ---------------------------------------------------

    def predict_batch(self, inputs: List[Any]) -> List[Any]:
        """Predictions for several independent inputs. The default loops
        ``predict``; wrappers whose backend can score many inputs in one
        compiled call override this (the v2 ``predict_batch`` endpoint and
        ``SyncService`` route through here)."""
        return [self.predict(i) for i in inputs]

    def predict_batch_envelope(self, inputs: List[Any]
                               ) -> List[Dict[str, Any]]:
        """Per-input envelopes — one input failing must not fail the rest."""
        if type(self).predict_batch is MAXModelWrapper.predict_batch:
            # no real batch implementation: go per-input directly, so a bad
            # input fails alone instead of forcing a full re-run
            return [self.predict_envelope(i) for i in inputs]
        t0 = _now()
        try:
            all_preds = self.predict_batch(inputs)
        except MAXError:
            # overridden batch path rejected the set (typically during
            # pre-processing, before the expensive scoring) — isolate
            return [self.predict_envelope(i) for i in inputs]
        dt = round((_now() - t0) * 1e3 / max(len(inputs), 1), 3)
        return [{"status": "ok", "predictions": p,
                 "model_id": self.metadata.id, "latency_ms": dt}
                for p in all_preds]

    # -- optional generation protocol (continuous batching) ---------------------

    def supports_generation(self) -> bool:
        """True when the wrapper exposes ``prepare_generation`` /
        ``format_generation`` (and a slot-based ``engine``) so a
        ``BatchedService`` can coalesce its requests into decode batches."""
        return (type(self).prepare_generation
                is not MAXModelWrapper.prepare_generation)

    def prepare_generation(self, inp: Any):
        """Validate+tokenize ``inp`` -> ``(prompt_tokens, gen_kwargs, extra)``
        for the scheduler. Raise :class:`MAXError` for bad input."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support batched generation")

    def format_generation(self, tokens: List[int], prompt_len: int) -> Any:
        """Generated token ids -> the wrapper's JSON predictions."""
        raise NotImplementedError

    def format_stream_delta(self, token_ids: List[int]) -> Optional[str]:
        """Best-effort text rendering of a *partial* token chunk for
        streaming ``token`` events (``None`` when the wrapper has no
        incremental text form — clients always get the raw ids). Called
        at the decode loop's sync point: must be cheap and side-effect
        free."""
        return None

    # -- optional endpoints -----------------------------------------------------

    def labels(self) -> List[str]:
        return list(self.metadata.labels)

    def input_schema(self) -> Dict[str, Any]:
        """OpenAPI-ish input schema; overridden by typed wrappers."""
        return {"type": "object", "properties": {"input": {}}}
