"""OpenAI Chat Completions schema as dataclasses (ref ch10/api_types.py:
request from_dict L48-63, response factory + usage L89-115, streaming chunk +
to_sse L158-177). Pure data layer — shared by the HTTP server and clients.

A copy of physics_llm_inference_tpu/serve/api_types.py: the original's
package imports jax (its serve/__init__.py imports the engine), so it cannot
load here.
"""
from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field, asdict


@dataclass
class ChatMessage:
    role: str
    content: str


@dataclass
class ChatCompletionRequest:
    model: str = "default"
    messages: list[ChatMessage] = field(default_factory=list)
    max_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    stream: bool = False
    stop: list[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionRequest":
        """Ref ch10/api_types.py:48-63."""
        msgs = [ChatMessage(role=m.get("role", "user"),
                            content=m.get("content", ""))
                for m in d.get("messages", [])]
        stop = d.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            model=d.get("model", "default"),
            messages=msgs,
            max_tokens=int(d.get("max_tokens", 128)),
            temperature=float(d.get("temperature", 1.0)),
            top_p=float(d.get("top_p", 1.0)),
            top_k=int(d.get("top_k", 0)),
            stream=bool(d.get("stream", False)),
            stop=stop,
        )

    def prompt_text(self) -> str:
        """Flatten chat messages into a prompt (simple role-tagged format)."""
        return "\n".join(f"{m.role}: {m.content}" for m in self.messages)


@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens

    def to_dict(self) -> dict:
        return {"prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "total_tokens": self.total_tokens}


def _new_id() -> str:
    return f"chatcmpl-{uuid.uuid4().hex[:24]}"


@dataclass
class ChatCompletionResponse:
    id: str
    model: str
    content: str
    finish_reason: str
    usage: Usage
    created: int = field(default_factory=lambda: int(time.time()))

    @classmethod
    def create(cls, model: str, content: str, finish_reason: str,
               prompt_tokens: int, completion_tokens: int) -> "ChatCompletionResponse":
        """Ref ch10/api_types.py:89-115."""
        return cls(id=_new_id(), model=model, content=content,
                   finish_reason=finish_reason,
                   usage=Usage(prompt_tokens, completion_tokens))

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "object": "chat.completion",
            "created": self.created,
            "model": self.model,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": self.content},
                "finish_reason": self.finish_reason,
            }],
            "usage": self.usage.to_dict(),
        }


@dataclass
class ChatCompletionChunk:
    id: str
    model: str
    delta: str
    finish_reason: str | None = None
    created: int = field(default_factory=lambda: int(time.time()))

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [{
                "index": 0,
                "delta": ({"content": self.delta} if self.delta else {}),
                "finish_reason": self.finish_reason,
            }],
        }

    def to_sse(self) -> str:
        """Server-sent-events framing (ref ch10/api_types.py:175-177)."""
        return f"data: {json.dumps(self.to_dict())}\n\n"


SSE_DONE = "data: [DONE]\n\n"
