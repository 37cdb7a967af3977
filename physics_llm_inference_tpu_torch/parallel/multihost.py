"""Multi-process serving: the world's set-up and the lockstep leader/worker
loop with broadcast admission (counterpart:
physics_llm_inference_tpu/parallel/multihost.py).

The JAX package runs one SPMD program per host, and every host must issue
the same jitted dispatches in the same order. The port runs one process per
rank, each with its own engine over its shard, and the same contract holds:
every rank's host-side decisions (admission order, buckets, chunks,
horizons, slots) must agree. They are deterministic functions of the
request stream and the engine's configuration, so it suffices to replicate
the stream: rank 0 (the leader) owns intake, and each iteration broadcasts
the newly submitted requests (a length, then the JSON payload as uint8)
before every rank steps its engine.
"""
from __future__ import annotations

import datetime
import json
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from .mesh import check_nccl_devices, default_backend, make_mesh

DEFAULT_TIMEOUT_S = 600


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Initialize torch.distributed: from `coordinator_address`
    ("host:port") with `num_processes` and `process_id`, or, with none of
    them, from the environment torch.distributed.run sets (WORLD_SIZE,
    RANK, MASTER_ADDR, MASTER_PORT). A world of one process initializes
    nothing. `timeout` (seconds) bounds every collective's wait."""
    if dist.is_initialized():
        return _info()
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if num_processes <= 1:
        return {"processes": 1, "process_id": 0,
                "local_devices": torch.cuda.device_count(),
                "backend": None}
    backend = backend or default_backend()
    if backend == "nccl":
        check_nccl_devices(int(os.environ.get("LOCAL_WORLD_SIZE",
                                              num_processes)))
    kw = {"timeout": datetime.timedelta(seconds=timeout)}
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                **kw)
    else:
        dist.init_process_group(backend, init_method="env://", **kw)
    return _info()


def _info() -> dict:
    return {"processes": dist.get_world_size(),
            "process_id": dist.get_rank(),
            "local_devices": torch.cuda.device_count(),
            "backend": dist.get_backend()}


def pod_mesh(tp: int | None = None, backend: str | None = None,
             device=None):
    """The serving mesh of the world: TP over the ranks of one host (its
    LOCAL_WORLD_SIZE by default), data-parallel across hosts."""
    n = dist.get_world_size()
    tp = tp or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % tp:
        raise ValueError(f"TP width {tp} must divide {n} ranks")
    return make_mesh(data=n // tp, model=tp, backend=backend, device=device)


def is_leader() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


# --------------------------------------------------------------- broadcast

def _wire_device() -> torch.device:
    """Where the default group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_bytes(payload: bytes | None) -> bytes:
    """A byte string from rank 0 to every rank: the length first, so every
    rank can size its buffer, then the payload as uint8. In a world of one
    process the payload comes back as it is."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return payload or b""
    dev = _wire_device()
    src = payload if is_leader() else b""
    n = torch.tensor([len(src)], dtype=torch.int64, device=dev)
    dist.broadcast(n, 0)
    n = int(n.item())
    if n == 0:
        return b""
    if is_leader():
        buf = torch.from_numpy(np.frombuffer(src, dtype=np.uint8).copy())
        buf = buf.to(dev)
    else:
        buf = torch.empty(n, dtype=torch.uint8, device=dev)
    dist.broadcast(buf, 0)
    return buf.cpu().numpy().tobytes()


def encode_admissions(reqs, stop: bool = False) -> bytes:
    """A batch of GenerationRequests as the admission broadcast's JSON."""
    recs = [{
        "id": r.request_id,
        "prompt": [int(t) for t in r.prompt_tokens],
        "max_tokens": int(r.max_tokens),
        "temperature": float(r.temperature),
        "top_p": float(r.top_p),
        "top_k": int(getattr(r, "top_k", 0) or 0),
        "stop_tokens": [int(t) for t in r.stop_tokens],
    } for r in reqs]
    return json.dumps({"stop": stop, "requests": recs}).encode()


def decode_admissions(data: bytes):
    """Inverse of encode_admissions -> (requests, stop)."""
    from ..serve.lifecycle import GenerationRequest

    if not data:
        return [], False
    d = json.loads(data.decode())
    reqs = []
    for rec in d["requests"]:
        kw = dict(prompt_tokens=rec["prompt"],
                  max_tokens=rec["max_tokens"],
                  temperature=rec["temperature"],
                  top_p=rec["top_p"],
                  stop_tokens=tuple(rec["stop_tokens"]),
                  request_id=rec["id"])
        if rec.get("top_k"):
            kw["top_k"] = rec["top_k"]
        reqs.append(GenerationRequest(**kw))
    return reqs, d["stop"]


# --------------------------------------------------------- leader/worker

class DPServingGroup:
    """The lockstep loop over one engine per rank.

    Leader (rank 0): takes requests through submit() (or submit_request(),
    with a stream listener, which is what InferenceServer calls); each
    step() broadcasts the pending admissions, submits them to its own
    engine and runs one engine iteration. Workers: run_worker_loop()
    receives each broadcast, submits the same requests to their engine and
    steps, until the leader's shutdown() lands. Request ids are the
    leader's and travel in the broadcast, so every rank's scheduler holds
    the same queues, and each rank's engine issues the same dispatches.

    As an engine for InferenceServer (`lockstep` is True): its serving
    loop steps the group even when idle, so the workers' waits stay short
    of the process group's timeout; results, stats and the scheduler are
    the leader engine's. Aborts would change one rank's scheduler alone,
    so abort_request raises.
    """

    lockstep = True

    def __init__(self, engine):
        self.engine = engine
        self.leader = is_leader()
        self._pending = []
        self._waiting_listeners: dict = {}
        self._next_id = 0
        self._stopped = False
        # submit() runs on the server's handler threads, step() on its loop
        self._intake = threading.Lock()

    def __getattr__(self, name):
        # wait_result, get_result, stats, scheduler, ...: the engine's
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    # ---- leader-side intake
    def submit(self, req, listener: list | None = None) -> str:
        if not self.leader:
            raise RuntimeError("submit() is leader-only; workers receive")
        with self._intake:
            if req.request_id is None:
                req.request_id = f"dp-{self._next_id}"
            self._next_id += 1
            self._pending.append(req)
            if listener is not None:
                self._waiting_listeners[req.request_id] = listener
        return req.request_id

    submit_request = submit

    def abort_request(self, request_id: str) -> bool:
        raise NotImplementedError("an abort on the leader alone would break "
                                  "the ranks' lockstep")

    def has_work(self) -> bool:
        sched = self.engine.scheduler
        return bool(self._pending or sched.waiting or sched.running)

    def _admit(self, reqs) -> None:
        for r in reqs:
            with self._intake:
                listener = self._waiting_listeners.pop(r.request_id, None)
            self.engine.submit_request(r, listener=listener)

    def step(self) -> dict:
        """One lockstep iteration: broadcast admissions, submit, step.
        Returns the engine's {request_id: [tokens]}, the same on every
        rank."""
        with self._intake:
            pending, self._pending = self._pending, []
        payload = encode_admissions(pending) if self.leader else None
        reqs, stop = decode_admissions(broadcast_bytes(payload))
        self._admit(reqs)
        if stop:
            self._stopped = True
            return {}
        return self.engine.step()

    def shutdown(self) -> None:
        if not self.leader:
            raise RuntimeError("shutdown() is the leader's")
        if not self._stopped:
            broadcast_bytes(encode_admissions([], stop=True))
        self._stopped = True

    def run_worker_loop(self, max_iters: int | None = None) -> None:
        """Worker main: step in lockstep with the leader until shutdown."""
        if self.leader:
            raise RuntimeError("run_worker_loop() is for workers")
        it = 0
        while max_iters is None or it < max_iters:
            it += 1
            reqs, stop = decode_admissions(broadcast_bytes(None))
            self._admit(reqs)
            if stop:
                self._stopped = True
                return
            self.engine.step()

    def run_until_done(self, max_iters: int = 10_000) -> dict:
        """Leader driver: step until every submitted request finished, then
        broadcast shutdown. Returns {request_id: GenerationResult}."""
        if not self.leader:
            raise RuntimeError("run_until_done() is the leader's")
        with self._intake:
            ids = [r.request_id for r in self._pending]
        done: dict = {}
        for _ in range(max_iters):
            self.step()
            for rid in ids:
                if rid not in done:
                    res = self.engine.get_result(rid)
                    if res is not None:
                        done[rid] = res
            if len(done) == len(ids) and not self.has_work():
                break
        self.shutdown()
        return done
