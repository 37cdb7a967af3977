"""The port's lockstep serving layer (parallel/multihost.py) against the
JAX package's: the admission codec byte for byte, the determinism contract
on one process, and a real two-process DPServingGroup (spawned gloo ranks,
tests/torch_dist_workers.py, which imports no jax) whose ranks issue the
same dispatch_trace as the JAX group on the same stream; in that world, the
CLI's `serve --tp 2 --check`. Without a launched world, --tp 2 names the
launcher.
"""
import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from physics_llm_inference_tpu.models import ModelConfig, init_params
from physics_llm_inference_tpu.parallel import multihost as jmh
from physics_llm_inference_tpu.serve import (EngineConfig,
                                             GenerationRequest as JRequest,
                                             InferenceEngine as JEngine)
from physics_llm_inference_tpu_torch import cli
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TModelConfig
from physics_llm_inference_tpu_torch.parallel import multihost as tmh
from physics_llm_inference_tpu_torch.serve import engine as tengine
from physics_llm_inference_tpu_torch.serve.lifecycle import \
    GenerationRequest as TRequest
from torch_parity import to_numpy

CFG = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
           dtype="float32")
ENGINE = dict(num_slots=4, max_seq_len=64, prompt_buckets=(8, 16, 32))
STREAM = [dict(prompt_tokens=[5, 17, 3], max_tokens=5, temperature=0.0,
               request_id="a"),
          dict(prompt_tokens=[9, 1, 4, 4, 2, 7], max_tokens=4,
               temperature=0.7, top_p=0.9, top_k=5, stop_tokens=(99,),
               request_id="b"),
          dict(prompt_tokens=[33] * 12, max_tokens=3, temperature=0.0,
               request_id="c")]
GREEDY = ("a", "c")


def _jax_group_run(params):
    eng = JEngine(params, ModelConfig(**CFG), EngineConfig(**ENGINE))
    eng.dispatch_trace = []
    group = jmh.DPServingGroup(eng)
    reqs = [JRequest(**r) for r in STREAM]
    group.submit(reqs[0])
    group.step()
    for r in reqs[1:]:
        group.submit(r)
    group.run_until_done()
    return ([tuple(x) for x in eng.dispatch_trace],
            {rid: list(res.tokens) for rid, res in eng._results.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = init_params(jax.random.PRNGKey(0), ModelConfig(**CFG))
    tparams = params_from_jax(to_numpy(params), device="cpu")
    world = workers.World("dp_group", 2, tmp_path_factory.mktemp("dp"),
                          tparams, TModelConfig(**CFG), STREAM, ENGINE)
    return _jax_group_run(params), world.results(), tparams


def test_codec_bytes_match_jax():
    jb = jmh.encode_admissions([JRequest(**r) for r in STREAM])
    tb = tmh.encode_admissions([TRequest(**r) for r in STREAM])
    assert tb == jb
    assert tmh.encode_admissions([], stop=True) == \
        jmh.encode_admissions([], stop=True)
    reqs, stop = tmh.decode_admissions(tb)
    assert not stop and [r.request_id for r in reqs] == ["a", "b", "c"]
    for got, want in zip(reqs, STREAM):
        assert isinstance(got, TRequest)
        assert got.prompt_tokens == list(want["prompt_tokens"])
        assert got.max_tokens == want["max_tokens"]
        assert got.temperature == want["temperature"]
        assert got.top_k == want.get("top_k", 0)
        assert got.stop_tokens == tuple(want.get("stop_tokens", ()))
    # the decoded requests encode to the same bytes again
    assert tmh.encode_admissions(reqs) == tb


def test_codec_stop_and_empty():
    reqs, stop = tmh.decode_admissions(tmh.encode_admissions([], stop=True))
    assert stop and reqs == []
    assert tmh.decode_admissions(b"") == ([], False)


def test_single_process_world():
    assert tmh.broadcast_bytes(b"hello") == b"hello"
    assert tmh.broadcast_bytes(None) == b""
    info = tmh.initialize_multihost()
    assert info["processes"] == 1 and tmh.is_leader()


def test_replicas_issue_identical_dispatches(runs):
    """The lockstep contract on one process: two port replicas fed the same
    stream issue the same dispatch_trace as each other and as JAX's."""
    (jtrace, _), _, tparams = runs
    traces = []
    for _ in range(2):
        eng = tengine.InferenceEngine(tparams, TModelConfig(**CFG),
                                      tengine.EngineConfig(**ENGINE))
        eng.dispatch_trace = []
        group = tmh.DPServingGroup(eng)
        for r in STREAM:
            group.submit(TRequest(**r))
        done = group.run_until_done()
        assert set(done) == {"a", "b", "c"}
        traces.append([tuple(x) for x in eng.dispatch_trace])
    assert traces[0] == traces[1] and len(traces[0]) > 0


def test_two_process_group_in_lockstep(runs):
    (jtrace, jtokens), got, _ = runs
    leader, worker = got
    assert leader["leader"] and not worker["leader"]
    assert leader["trace"] == worker["trace"] == jtrace
    assert leader["results"] == worker["results"]
    # run_until_done reports what was pending when it was called
    assert set(leader["tokens"]) == {"b", "c"}
    assert set(leader["results"]) == {"a", "b", "c"}
    for rid in GREEDY:
        assert leader["results"][rid] == jtokens[rid]
    assert len(leader["results"]["b"]) == 4


def test_pod_mesh_and_cli_check_in_a_world(runs):
    _, got, _ = runs
    # pod_mesh: TP over the ranks of the host; the CLI's --check returned
    assert [o["pod_mesh"] for o in got] == [{"data": 1, "model": 2}] * 2


def test_cli_tp_without_a_world_names_the_launcher(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run "
                                         "--nproc-per-node 4"):
        cli.main(["serve", "--config", "toy", "--tp", "2", "--dp", "2",
                  "--device", "cpu", "--check"])


def test_group_is_a_leader_engine_for_the_server():
    """Under InferenceServer the group takes requests with listeners,
    steps while idle (its loop's heartbeat) and refuses aborts."""
    eng = tengine.InferenceEngine(
        params_from_jax(to_numpy(init_params(jax.random.PRNGKey(0),
                                             ModelConfig(**CFG))),
                        device="cpu"),
        TModelConfig(**CFG), tengine.EngineConfig(**ENGINE))
    group = tmh.DPServingGroup(eng)
    assert group.lockstep and not group.has_work()
    buf = []
    rid = group.submit_request(TRequest(prompt_tokens=[1, 2, 3],
                                        max_tokens=3), listener=buf)
    assert group.has_work() and not eng.scheduler.waiting
    while group.get_result(rid) is None:
        group.step()
    assert buf == group.get_result(rid).tokens and len(buf) == 3
    with pytest.raises(NotImplementedError):
        group.abort_request(rid)
    group.step()        # idle: a heartbeat, nothing to do
    assert not group.has_work()
