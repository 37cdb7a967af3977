"""Request and result records of the serving engines (counterpart:
physics_llm_inference_tpu/serve/engine.py:84-109).

Only `GenerationRequest` and `GenerationResult` are ported; the paged engine
(serve/paged_engine.py) takes and returns them. The slot `InferenceEngine` is
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GenerationRequest:
    """Ref GenerationRequest ch10/engine.py:19-30."""

    prompt_tokens: list[int]
    max_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    stop_tokens: tuple[int, ...] = ()
    request_id: str | None = None


@dataclass
class GenerationResult:
    """Ref GenerationResult ch10/engine.py:33-43."""

    request_id: str
    tokens: list[int]
    finish_reason: str
    ttft_s: float | None
    total_s: float

    @property
    def tokens_per_s(self) -> float:
        return len(self.tokens) / self.total_s if self.total_s > 0 else 0.0
