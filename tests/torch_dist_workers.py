"""Worker processes of the parallel tests (tests/test_torch_parallel.py,
test_torch_tp_serving.py, test_torch_multihost.py).

Torch only: a spawned child unpickles its target by this module's name, so
it never imports a test module, and so never jax. `World` spawns one
process a rank over a gloo group initialized from a file under the test's
tmp_path (no fixed port to collide between xdist workers), with a short
timeout; each rank returns plain Python and numpy values, pickled to a file
the parent reads. A rank that raises fails the run with its traceback.
"""
from __future__ import annotations

import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

PG_TIMEOUT_S = 120


def _child(rank, world, init_file, fn_name, args, out_dir):
    torch.set_num_threads(1)   # beside other processes: one thread each
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        res = globals()[fn_name](rank, world, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class World:
    """`world` spawned gloo ranks running fn_name(rank, world, *args),
    started at once; results() waits for them (the parent can compute its
    references meanwhile) and returns each rank's result, or raises with
    the failing ranks' tracebacks."""

    def __init__(self, fn_name: str, world: int, tmp_path, *args,
                 timeout: float = 300):
        import time

        ctx = torch.multiprocessing.get_context("spawn")
        self.name, self.world = fn_name, world
        self.out = tmp_path / f"world-{fn_name}"
        self.out.mkdir()
        self.procs = [ctx.Process(target=_child,
                                  args=(r, world, str(self.out / "pg"),
                                        fn_name, args, str(self.out)))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def results(self) -> list:
        import time

        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = {r: (self.out / f"{r}.err").read_text()
                for r in range(self.world)
                if (self.out / f"{r}.err").exists()}
        codes = [p.exitcode for p in self.procs]
        if hung or errs or any(codes):
            raise AssertionError(f"{self.name}: ranks hung {hung}, exit "
                                 f"codes {codes}, errors {errs}")
        return [pickle.loads((self.out / f"{r}.pkl").read_bytes())
                for r in range(self.world)]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy() if t.is_floating_point() \
            else t.detach().cpu().numpy()
    return t


# ------------------------------------------------------------ serving

def engine_run(eng, prompts, max_tokens: int, temperature: float = 0.0,
               tag: str = "r"):
    """Submit every prompt at once, run until done: (tokens, finish
    reasons, dispatch_trace). The same function drives the JAX engines."""
    from physics_llm_inference_tpu_torch.serve.lifecycle import \
        GenerationRequest

    req_type = getattr(eng, "request_type", GenerationRequest)
    eng.dispatch_trace = []
    rids = [eng.submit_request(req_type(
        prompt_tokens=list(p), max_tokens=max_tokens,
        temperature=temperature, request_id=f"{tag}{i}"))
        for i, p in enumerate(prompts)]
    eng.run_until_done(rids)
    res = [eng.get_result(r) for r in rids]
    return ([list(map(int, r.tokens)) for r in res],
            [r.finish_reason for r in res],
            [tuple(x) for x in eng.dispatch_trace])


def tp_serving(rank, world, params, qparams, cfg, prompts, slot_kw, paged_kw,
               radix_kw, radix_prompt):
    """Both engines on this rank's shard: the slot engine over data 2 x
    model 2 (fp32 and INT8 weights with an INT8 pool), a sampled slot run,
    the paged engine over model 4 (fp32 and INT8), and radix reuse."""
    from physics_llm_inference_tpu_torch.parallel import make_mesh
    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    dm = make_mesh(data=2, model=2, device="cpu")
    m4 = make_mesh(model=4, device="cpu")
    out = {"coords": (dm.coords, m4.coords)}
    for name, p, kv in (("fp32", params, None), ("int8", qparams, "int8")):
        eng = InferenceEngine(p, cfg, EngineConfig(**slot_kw, kv_dtype=kv),
                              mesh=dm)
        out[f"slot_{name}"] = engine_run(eng, prompts, 8)
        out[f"slot_{name}_pool"] = tuple(
            (eng._k.q if kv else eng._k).shape)
        peng = PagedInferenceEngine(
            p, cfg, PagedEngineConfig(**paged_kw, kv_dtype=kv), mesh=m4)
        out[f"paged_{name}"] = engine_run(peng, prompts, 8)
    eng = InferenceEngine(params, cfg, EngineConfig(**slot_kw), mesh=dm)
    out["sampled"] = engine_run(eng, prompts[:2], 6, temperature=0.8)
    peng = PagedInferenceEngine(params, cfg, PagedEngineConfig(**radix_kw),
                                mesh=m4)
    out["radix"] = [engine_run(peng, [radix_prompt], 4, tag=t)[0][0]
                    for t in ("a", "b")]
    out["radix_hits"] = peng.stats()["radix_hit_tokens"]
    return out


# ------------------------------------------------------------ parallel

def parallel_layer(rank, world, params, cfg, ids, mlp, moe_cases, moe_bad,
                   ring):
    """The mesh, its collectives, the TP forward and cached decode, the TP
    MLP, expert parallelism and ring attention, on four ranks."""
    from physics_llm_inference_tpu_torch.models.transformer import (KVSlice,
                                                                    forward)
    from physics_llm_inference_tpu_torch.parallel import (
        make_mesh, moe_layer_ep, tp_local_config, tp_mlp, tp_prepare_params)
    from physics_llm_inference_tpu_torch.parallel.mesh import group_timeout
    from physics_llm_inference_tpu_torch.parallel.ring_attention import \
        ring_attention

    out = {}
    dm = make_mesh(data=2, model=2, device="cpu")
    dem = make_mesh(data=1, expert=2, model=2, device="cpu")
    m4 = make_mesh(model=4, device="cpu")
    out["coords"] = (dm.coords, dem.coords, m4.coords, m4.transport)
    # seconds each axis group waits for its peers
    out["timeouts"] = sorted({group_timeout(g).total_seconds()
                              for m in (dm, dem, m4)
                              for g in m.groups.values()})
    refusals = []
    for kw in (dict(model=3), dict(model=4, backend="nccl")):
        try:
            make_mesh(device="cpu", **kw)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals

    # collectives over model (4 ranks)
    i = m4.index("model")
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * i
    out["collectives"] = {
        "all_reduce": _np(m4.all_reduce(x, "model")),
        "all_gather": _np(m4.all_gather(x, "model", dim=1)),
        "all_to_all": _np(m4.all_to_all(x, "model", split_dim=0,
                                        concat_dim=1)),
        "ring_shift": _np(m4.ring_shift(x, "model")),
        "broadcast": _np(m4.broadcast(x, "model", src=2)),
    }

    # TP forward over model 4
    local = tp_prepare_params(params, cfg, m4)
    lcfg = tp_local_config(cfg, 4, data_axis=None, mesh=m4)
    logits, _ = forward(local, torch.as_tensor(ids["forward"]), lcfg)
    out["forward"] = _np(logits)

    # prefill + one decode step over data 2 x model 2: this data rank's
    # batch rows, this model rank's KV heads
    d, m = dm.index("data"), dm.index("model")
    local = tp_prepare_params(params, cfg, dm)
    lcfg = tp_local_config(cfg, 2, mesh=dm)
    per = ids["decode"].shape[0] // 2
    rows = ids["decode"][d * per:(d + 1) * per]
    kv_shape = (cfg.num_layers, rows.shape[0], 16, lcfg.num_kv_heads,
                cfg.head_dim)
    k, v = torch.zeros(kv_shape), torch.zeros(kv_shape)
    l1, kvs = forward(local, torch.as_tensor(rows), lcfg,
                      kv=KVSlice(k, v, 0), last_only=True)
    k_prefill = k.clone()     # the decode step writes the cache in place
    tok = l1[:, -1].argmax(-1)
    l2, _ = forward(local, tok[:, None], lcfg, kv=kvs, last_only=True)
    out["decode"] = (_np(l1), _np(l2), _np(k_prefill))

    # the explicit TP MLP over model 4
    out["mlp"] = _np(tp_mlp(m4, *(torch.as_tensor(a) for a in mlp)))

    # expert parallelism over 4 ranks
    ep = make_mesh(expert=4, device="cpu")
    out["ep"] = {name: _np(moe_layer_ep(ep, torch.as_tensor(xe), p, moe))
                 for name, (xe, p, moe) in moe_cases.items()}
    bad = []
    for xe, p, moe in moe_bad:
        try:
            moe_layer_ep(ep, torch.as_tensor(xe), p, moe)
            bad.append(None)
        except ValueError as e:
            bad.append(str(e))
    out["ep_refusals"] = bad

    # ring attention over model 4: this rank's sequence chunk
    q, kr, vr = (torch.as_tensor(a) for a in ring)
    s = q.shape[2] // 4
    chunk = [t[:, :, i * s:(i + 1) * s] for t in (q, kr, vr)]
    out["ring"] = {c: _np(ring_attention(m4, *chunk, causal=c))
                   for c in (True, False)}

    # the scaling benchmark's measurements and the EP run of ep_scaling
    from physics_llm_inference_tpu_torch.bench import ep_scaling, scaling
    out["scaling"] = (
        scaling.measure_tp_decode(cfg, m4, batch=2, cache_len=16, iters=2),
        scaling.measure_dp_step(cfg, make_mesh(data=4, device="cpu"),
                                batch_per_replica=2, cache_len=16, iters=2))
    out["ep_scaling"] = ep_scaling.executed(ep, tokens=16, d=32, f=64)
    return out


# ------------------------------------------------------------ multihost

def dp_group(rank, world, params, cfg, stream, engine_kw):
    """Two ranks, one engine each, in lockstep through DPServingGroup: the
    leader submits the stream in two waves; then pod_mesh, and the CLI's
    `serve --tp 2 --check` in this world."""
    import os

    from physics_llm_inference_tpu_torch import cli
    from physics_llm_inference_tpu_torch.parallel import (
        DPServingGroup, is_leader, local_mesh_shape, pod_mesh)
    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)
    from physics_llm_inference_tpu_torch.serve.lifecycle import \
        GenerationRequest

    eng = InferenceEngine(params, cfg, EngineConfig(**engine_kw))
    eng.dispatch_trace = []
    group = DPServingGroup(eng)
    out = {"leader": is_leader()}
    if group.leader:
        reqs = [GenerationRequest(**r) for r in stream]
        group.submit(reqs[0])
        group.step()
        for r in reqs[1:]:
            group.submit(r)
        done = group.run_until_done()
        out["tokens"] = {rid: list(res.tokens) for rid, res in done.items()}
    else:
        group.run_worker_loop()
    out["trace"] = [tuple(x) for x in eng.dispatch_trace]
    out["results"] = {rid: list(res.tokens)
                      for rid, res in eng._results.items()}
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    out["pod_mesh"] = local_mesh_shape(pod_mesh(backend="gloo",
                                                device="cpu"))
    os.environ["WORLD_SIZE"] = str(world)
    cli.main(["serve", "--config", "toy", "--tp", "2", "--device", "cpu",
              "--dist-backend", "gloo", "--port", "0", "--check", "--slots",
              "2", "--max-seq-len", "64"])
    return out


class OneRankMesh:
    """A mesh of one rank and no process group, whose collectives are the
    identity: a TP local config over it runs the models' TP hooks and
    must give the single-device numbers."""

    world = 1
    device = torch.device("cpu")
    transport = "none"

    def __init__(self, **shape):
        self.shape = shape

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return 0

    def all_reduce(self, t, axis):
        return t.clone()

    def all_gather(self, t, axis, dim=0):
        return t.clone()
