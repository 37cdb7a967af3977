"""The port's continuous batcher, chunked prefill, mixed batch and overlap
modules against the JAX package's, on the same request streams.

Each case of tests/test_sched.py's TestContinuousBatcher,
TestChunkedPrefill, TestMixedBatch and TestOverlap runs on both packages;
then a seeded random stream drives both side by side, plan for plan.
"""
import dataclasses

import numpy as np
import pytest

import physics_llm_inference_tpu.sched as jsched
import physics_llm_inference_tpu_torch.sched as tsched

PKGS = {"jax": jsched, "torch": tsched}


def req(s, rid, plen=8, max_new=4, priority=0):
    return s.Request(request_id=rid, prompt_tokens=list(range(plen)),
                     max_new_tokens=max_new, priority=priority)


def as_dict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


@pytest.fixture(params=sorted(PKGS))
def s(request):
    return PKGS[request.param]


# ------------------------------------------- TestContinuousBatcher, both

def test_batcher_admit_and_finish_transitions(s):
    b = s.ContinuousBatcher(s.ContinuousBatcherConfig(max_batch_size=2))
    for i in range(3):
        b.add_request(req(s, f"r{i}", max_new=2))
    plan = b.schedule_iteration()
    assert plan.prefill_ids == ["r0", "r1"]
    assert b.stats()["waiting"] == 1
    b.step({"r0": 5, "r1": 6})
    b.step({"r0": 5, "r1": 6})
    plan = b.schedule_iteration()
    assert plan.prefill_ids == ["r2"]
    assert b.stats()["finished"] == 2


def test_batcher_token_budget_blocks_admission(s):
    b = s.ContinuousBatcher(s.ContinuousBatcherConfig(
        max_batch_size=10, max_tokens_in_batch=20))
    b.add_request(req(s, "big", plen=15, max_new=4))
    b.add_request(req(s, "small", plen=8, max_new=4))
    plan = b.schedule_iteration()
    assert plan.prefill_ids == ["big"]
    assert b.stats()["waiting"] == 1


def test_batcher_decode_ids_after_prefill(s):
    b = s.ContinuousBatcher()
    b.add_request(req(s, "a"))
    b.schedule_iteration()
    plan = b.schedule_iteration()
    assert plan.decode_ids == ["a"] and plan.num_decode_tokens == 1


# --------------------------------------------- TestChunkedPrefill, both

def test_chunk_boundaries(s):
    c = s.ChunkedPrefillScheduler(s.ChunkConfig(chunk_size=4,
                                                max_chunks_per_iteration=8))
    c.add_request(req(s, "a", plen=10))
    for want in ([(0, 4)], [(4, 8)], [(8, 10)]):
        assert [(k.start, k.end) for k in c.schedule_chunks()] == want
    assert [r.request_id for r in c.get_decode_ready()] == ["a"]


def test_chunks_per_iteration_cap(s):
    c = s.ChunkedPrefillScheduler(s.ChunkConfig(chunk_size=4,
                                                max_chunks_per_iteration=2))
    for i in range(4):
        c.add_request(req(s, f"r{i}", plen=4))
    assert len(c.schedule_chunks()) == 2
    assert len(c.schedule_chunks()) == 2


def test_in_flight_served_before_pending(s):
    c = s.ChunkedPrefillScheduler(s.ChunkConfig(chunk_size=4,
                                                max_chunks_per_iteration=1))
    c.add_request(req(s, "a", plen=8))
    c.schedule_chunks()
    c.add_request(req(s, "b", plen=4))
    assert c.schedule_chunks()[0].request_id == "a"


# ------------------------------------------------- TestMixedBatch, both

def test_mixed_batch_budget_split(s):
    m = s.MixedBatchScheduler(s.MixedBatchConfig(
        max_batch_tokens=100, max_prefill_tokens=40, max_decode_batch=64,
        prefill_priority=0.5))
    prefills = [req(s, "p1", plen=30), req(s, "p2", plen=30)]
    decodes = [req(s, f"d{i}") for i in range(80)]
    batch = m.build_batch(prefills, decodes)
    assert batch.prefill_ids == ["p1"]
    assert batch.num_prefill_tokens == 30
    assert len(batch.decode_ids) == 64
    assert 0 < batch.prefill_fraction < 1


# ---------------------------------------------------- TestOverlap, both

def test_overlap_speedup_bound(s):
    out = s.simulate_overlap_vs_sequential([1.0] * 5, [0.3] * 5)
    assert out["speedup"] == pytest.approx(1.3 / 1.006, rel=0.1)
    assert out["overlap_ratio"] > 0.8


def test_overlap_transfer_bound_workload(s):
    out = s.simulate_overlap_vs_sequential([0.1] * 3, [1.0] * 3)
    assert out["overlapped_time"] >= 3.0


def test_overlap_streams_are_independent(s):
    o = s.OverlapScheduler()
    o.schedule_compute("c1", 1.0)
    o.schedule_transfer("t1", 1.0)
    assert o.makespan == pytest.approx(1.0)


# --------------------------------------------- side by side, plan for plan

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_continuous_batcher_plans_equal(seed):
    rng = np.random.default_rng(seed)
    arrivals = [(int(rng.integers(0, 12)), f"r{i}", int(rng.integers(1, 40)),
                 int(rng.integers(1, 9))) for i in range(24)]
    stop = int(rng.integers(0, 50))
    cfg = dict(max_batch_size=5, max_tokens_in_batch=120)
    bs = {k: p.ContinuousBatcher(p.ContinuousBatcherConfig(**cfg))
          for k, p in PKGS.items()}
    for it in range(40):
        plans = {}
        for k, b in bs.items():
            p = PKGS[k]
            for t, rid, plen, mx in arrivals:
                if t == it:
                    b.add_request(p.Request(
                        request_id=rid, prompt_tokens=list(range(plen)),
                        max_new_tokens=mx, sampling=p.request.SamplingParams(
                            stop_tokens=(stop,))))
            plans[k] = as_dict(b.schedule_iteration())
            b.step({rid: int((it * 7 + len(rid)) % 50)
                    for rid in plans[k]["prefill_ids"] + plans[k]["decode_ids"]})
        assert plans["jax"] == plans["torch"], it
        assert bs["jax"].stats() == bs["torch"].stats(), it
    assert [r.finish_reason for r in bs["jax"].finished] == \
        [r.finish_reason for r in bs["torch"].finished]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_prefill_plans_equal(seed):
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(1, 30)) for _ in range(12)]
    cs = {k: p.ChunkedPrefillScheduler(p.ChunkConfig(
        chunk_size=8, max_chunks_per_iteration=3)) for k, p in PKGS.items()}
    for it in range(20):
        out = {}
        for k, c in cs.items():
            if it < len(lens):
                c.add_request(req(PKGS[k], f"r{it}", plen=lens[it]))
            out[k] = ([as_dict(x) for x in c.schedule_chunks()],
                      [r.request_id for r in c.get_decode_ready()],
                      c.stats())
        assert out["jax"] == out["torch"], it


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_batch_plans_equal(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(max_batch_tokens=int(rng.integers(32, 256)),
               max_prefill_tokens=int(rng.integers(16, 128)),
               max_decode_batch=int(rng.integers(4, 64)),
               prefill_priority=float(rng.uniform(0.1, 0.9)))
    pre = [(f"p{i}", int(rng.integers(1, 80)), int(rng.integers(0, 40)))
           for i in range(10)]
    dec = [f"d{i}" for i in range(int(rng.integers(0, 100)))]
    batches = {}
    for k, p in PKGS.items():
        prefill_queue = []
        for rid, plen, pos in pre:
            r = req(p, rid, plen=plen)
            r.prefill_pos = min(pos, plen)
            prefill_queue.append(r)
        b = p.MixedBatchScheduler(p.MixedBatchConfig(**cfg)).build_batch(
            prefill_queue, [req(p, rid) for rid in dec])
        batches[k] = (as_dict(b), b.total_tokens, b.prefill_fraction)
    assert batches["jax"] == batches["torch"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_schedules_equal(seed):
    rng = np.random.default_rng(seed)
    ops = [(str(rng.choice(["c", "t", "a"])), float(rng.uniform(0, 2)))
           for _ in range(30)]
    out = {}
    for k, p in PKGS.items():
        o = p.OverlapScheduler()
        ends = []
        for kind, dur in ops:
            if kind == "c":
                ends.append(o.schedule_compute("c", dur))
            elif kind == "t":
                ends.append(o.schedule_prefetch("t", dur))
            else:
                ends.append(o.advance_time(o.time + dur if dur > 1 else None))
        out[k] = (ends, o.makespan, o.compute_overlap_ratio(),
                  [as_dict(x) for x in o.completed],
                  p.simulate_overlap_vs_sequential(
                      [d for _, d in ops[:10]], [d for _, d in ops[10:20]]))
    assert out["jax"] == out["torch"]
