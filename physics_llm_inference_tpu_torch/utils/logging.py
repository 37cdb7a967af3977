"""Structured logging (counterpart: physics_llm_inference_tpu/utils/logging.py).

JSON-lines events with component, level and timestamp, for any log
collector; a plain-text mode for humans. The same records as the JAX
package's logger, field for field.
"""
from __future__ import annotations

import json
import sys
import time


class StructuredLogger:
    LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

    def __init__(self, component: str, level: str = "info",
                 json_mode: bool = True, stream=None):
        self.component = component
        self.level = self.LEVELS[level]
        self.json_mode = json_mode
        self.stream = stream or sys.stderr

    def _emit(self, level: str, event: str, **fields):
        if self.LEVELS[level] < self.level:
            return
        record = {"ts": time.time(), "level": level,
                  "component": self.component, "event": event, **fields}
        if self.json_mode:
            self.stream.write(json.dumps(record, default=str) + "\n")
        else:
            extras = " ".join(f"{k}={v}" for k, v in fields.items())
            self.stream.write(
                f"[{level}] {self.component}: {event} {extras}\n")
        self.stream.flush()

    def debug(self, event: str, **f):
        self._emit("debug", event, **f)

    def info(self, event: str, **f):
        self._emit("info", event, **f)

    def warn(self, event: str, **f):
        self._emit("warn", event, **f)

    def error(self, event: str, **f):
        self._emit("error", event, **f)


def get_logger(component: str, **kw) -> StructuredLogger:
    return StructuredLogger(component, **kw)
