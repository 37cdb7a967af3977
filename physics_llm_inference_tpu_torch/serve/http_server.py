"""OpenAI-compatible HTTP server with SSE streaming (counterpart:
physics_llm_inference_tpu/serve/http_server.py), on stdlib http.server.

Endpoints:
  POST /v1/chat/completions   — chat (stream=true → SSE chunks)
  POST /v1/completions        — raw prompt completion
  GET  /v1/models             — model listing
  GET  /metrics               — engine/scheduler/pool stats
  GET  /health                — liveness

Threading model: HTTP threads tokenize and enqueue; ONE background engine
thread owns the device and loops engine.step(), so every dispatch, every
CUDA graph capture a first request at a new bucket makes included, runs on
that thread. Either engine serves: the slot InferenceEngine or the
PagedInferenceEngine, each with `submit_request(..., listener=)` and
serve/lifecycle.py's `wait_result` and `abort_request`.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .api_types import (SSE_DONE, ChatCompletionChunk, ChatCompletionRequest,
                        ChatCompletionResponse)
from .engine import GenerationRequest
from .tokenizer_pool import TokenizerPool


class ServingLoop:
    """Background thread stepping the engine (slot or paged) while work
    exists. A lockstep engine (parallel/multihost.DPServingGroup, whose
    `lockstep` is True) is also stepped when idle, every 50 ms: each of its
    steps is the broadcast the other ranks wait on."""

    def __init__(self, engine):
        self.engine = engine
        self._lockstep = getattr(engine, "lockstep", False)
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _busy(self) -> bool:
        if self._lockstep:
            return self.engine.has_work()
        sched = self.engine.scheduler
        return bool(sched.waiting or sched.running)

    def _run(self):
        while not self._stop:
            if self._busy():
                self.engine.step()
                # hand the engine lock over: step() releases it and takes
                # it again at once, so a handler thread blocked in
                # submit_request or abort_request would wait for the
                # engine to go idle; a yield lets it in between two steps
                time.sleep(0)
            else:
                if self._lockstep:
                    self.engine.step()
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def notify(self):
        self._wake.set()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)


def make_handler(engine, tokenizer: TokenizerPool,
                 loop: ServingLoop, model_name: str = "default"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        # ---------------- helpers
        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str):
            self._json(code, {"error": {"message": msg, "code": code}})

        def _read_body(self) -> dict | None:
            try:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return None

        # ---------------- routes
        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._json(200, engine.stats())
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model"}]})
            else:
                self._error(404, f"no route {self.path}")

        def do_POST(self):
            if self.path not in ("/v1/chat/completions", "/v1/completions"):
                self._error(404, f"no route {self.path}")
                return
            body = self._read_body()
            if body is None:
                self._error(400, "invalid JSON body")
                return
            try:
                req = ChatCompletionRequest.from_dict(body)
                if self.path == "/v1/completions":
                    prompt = str(body.get("prompt", ""))
                else:
                    prompt = req.prompt_text()
                    if not req.messages:
                        self._error(400, "messages must be non-empty")
                        return
                tokens = tokenizer.tokenize(prompt)
                stop_tokens = tuple(
                    t for s in req.stop for t in tokenizer.tokenize(s)[:1])
                gen = GenerationRequest(
                    prompt_tokens=tokens, max_tokens=req.max_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, stop_tokens=stop_tokens)
                if req.stream:
                    self._stream(req, gen)
                else:
                    self._complete(req, gen, len(tokens))
            except ValueError as e:
                self._error(400, str(e))
            except Exception as e:  # per-request isolation
                self._error(500, f"{type(e).__name__}: {e}")

        def _complete(self, req, gen, prompt_tokens):
            rid = engine.submit_request(gen)
            loop.notify()
            res = engine.wait_result(rid)
            text = tokenizer.detokenize(res.tokens)
            resp = ChatCompletionResponse.create(
                model=req.model, content=text,
                finish_reason=res.finish_reason,
                prompt_tokens=prompt_tokens,
                completion_tokens=len(res.tokens))
            self._json(200, resp.to_dict())

        def _stream(self, req, gen):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(data: str):
                payload = data.encode()
                self.wfile.write(f"{len(payload):X}\r\n".encode()
                                 + payload + b"\r\n")
                self.wfile.flush()

            # the listener goes in with the request: the serving loop may
            # be stepping, and could emit a token before a later attach
            buf: list[int] = []
            rid = engine.submit_request(gen, listener=buf)
            loop.notify()
            sent = 0
            cid = f"chatcmpl-{rid}"
            while True:
                res = engine.get_result(rid)
                while sent < len(buf):
                    chunk = ChatCompletionChunk(
                        id=cid, model=req.model,
                        delta=tokenizer.detokenize([buf[sent]]))
                    write_chunk(chunk.to_sse())
                    sent += 1
                if res is not None and sent >= len(buf):
                    write_chunk(ChatCompletionChunk(
                        id=cid, model=req.model, delta="",
                        finish_reason=res.finish_reason).to_sse())
                    write_chunk(SSE_DONE)
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    engine._listeners.pop(rid, None)
                    return
                time.sleep(0.002)

    return Handler


class InferenceServer:
    """HTTP server + serving loop wrapper."""

    def __init__(self, engine, host: str = "127.0.0.1",
                 port: int = 8000, tokenizer: TokenizerPool | None = None,
                 model_name: str = "default"):
        self.engine = engine
        self.tokenizer = tokenizer or TokenizerPool()
        self.loop = ServingLoop(engine)
        handler = make_handler(engine, self.tokenizer, self.loop, model_name)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.loop.shutdown()

    def close(self):
        """Tear down WITHOUT a running serve_forever loop: socketserver's
        shutdown() blocks on an event only serve_forever sets, so a server
        that was constructed but never served must close this way."""
        self.httpd.server_close()
        self.loop.shutdown()
