"""Serving front end (counterpart: physics_llm_inference_tpu/serve): the
slot engine, the paged engine (serve/paged_engine.py), the OpenAI schema,
the tokenizer pool and the HTTP server (serve/http_server.py)."""
from .api_types import (
    ChatCompletionRequest, ChatCompletionResponse, ChatCompletionChunk,
    ChatMessage, Usage,
)
from .tokenizer_pool import TokenizerPool
from .engine import InferenceEngine, EngineConfig, GenerationRequest, GenerationResult

__all__ = [
    "ChatCompletionRequest", "ChatCompletionResponse", "ChatCompletionChunk",
    "ChatMessage", "Usage", "TokenizerPool",
    "InferenceEngine", "EngineConfig", "GenerationRequest", "GenerationResult",
]
