"""The port's paged serving path against the JAX package's.

First the host-only modules the port carries as copies (block pool, radix
cache, native radix cache, scheduler), on the same operation sequences as
their originals. Then the port's PagedInferenceEngine against the JAX
engine on the same request streams: the f32 toy model of
tests/test_paged_engine.py with block size 8, radix on and off, decode
horizons 1 and 8, f32 and INT8 pools, and a pool small enough to force radix
eviction and preemption. Greedy tokens, finish reasons, the dispatch trace,
radix hits and preemptions must be identical."""
import jax
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu import native as j_native
from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models import init_params as j_init
from physics_llm_inference_tpu.ops import sampling as j_sampling
from physics_llm_inference_tpu.runtime import paged_kv as j_paged_kv
from physics_llm_inference_tpu.runtime import radix_cache as j_radix
from physics_llm_inference_tpu.sched import request as j_request
from physics_llm_inference_tpu.sched import scheduler as j_sched
from physics_llm_inference_tpu.serve import paged_engine as j_engine
from physics_llm_inference_tpu.serve.engine import \
    GenerationRequest as JRequest
from physics_llm_inference_tpu_torch import native as t_native
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.ops import sampling as t_sampling
from physics_llm_inference_tpu_torch.runtime import paged_kv as t_paged_kv
from physics_llm_inference_tpu_torch.runtime import radix_cache as t_radix
from physics_llm_inference_tpu_torch.sched import request as t_request
from physics_llm_inference_tpu_torch.sched import scheduler as t_sched
from physics_llm_inference_tpu_torch.serve import paged_engine as t_engine
from physics_llm_inference_tpu_torch.serve.engine import \
    GenerationRequest as TRequest
from torch_parity import TOL, to_numpy

# the toy model of tests/test_paged_engine.py
TOY = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
           dtype="float32")


# ------------------------------------------------------------ host copies

def _pool_ops(mod):
    """One operation sequence on a PagedKVCache; returns what it saw."""
    pool = mod.PagedKVCache(num_blocks=12, block_size=4, num_layers=2,
                            num_kv_heads=2, head_dim=8)
    seen = [pool.can_allocate(9), pool.blocks_needed(9)]
    a = pool.allocate("a", 9)
    b = pool.allocate("b", 5, shared_blocks=a.block_ids[:2])
    seen += [list(a.block_ids), list(b.block_ids), pool.stats()]
    seen += [pool.extend("a", 4), pool.extend("b", 1), pool.extend("b", 7)]
    pool.ref_blocks([a.block_ids[0]])
    seen += [pool.free("a"), pool.can_allocate(30, b.block_ids[:2])]
    with pytest.raises(RuntimeError):
        pool.allocate("c", 100)
    seen += [pool.release_blocks([a.block_ids[0], 99]), pool.free("b"),
             pool.free("b"), sorted(pool.free_blocks), pool.stats(),
             pool.block_bytes(), dict(pool.ref_counts)]
    return seen


def test_paged_kv_copy_matches_original():
    assert _pool_ops(t_paged_kv) == _pool_ops(j_paged_kv)


def _radix_ops(cache):
    seen = [cache.insert([1, 2, 3, 4, 5], [10, 11, 12, 13, 14]),
            cache.insert([1, 2, 3, 9], [10, 11, 12, 20]),
            cache.insert([7, 8], [30, 31]),
            cache.match_prefix([1, 2, 3, 4, 6]),
            cache.match_prefix([1, 2, 3, 9, 9], lock=True),
            cache.match_prefix([5]), cache.total_cached_tokens()]
    seen.append(sorted(cache.evict(2)))        # the locked path survives
    cache.unlock([1, 2, 3, 9, 9])
    seen += [sorted(cache.evict(3)), cache.match_prefix([1, 2, 3, 9]),
             cache.total_cached_tokens(), cache.hit_rate()]
    return seen


@pytest.mark.parametrize("backend", ["python", "native"])
def test_radix_cache_copy_matches_original(backend):
    if backend == "python":
        clock = iter(range(1000))
        got = _radix_ops(t_radix.RadixCache(time_fn=lambda: next(clock)))
        clock = iter(range(1000))
        want = _radix_ops(j_radix.RadixCache(time_fn=lambda: next(clock)))
    else:
        assert t_native.available() and j_native.available()
        got = _radix_ops(t_native.NativeRadixCache())
        want = _radix_ops(j_native.NativeRadixCache())
        assert isinstance(t_native.make_radix_cache(),
                          t_native.NativeRadixCache)
    assert got == want
    assert isinstance(t_native.make_radix_cache(prefer_native=False),
                      t_radix.RadixCache)


def test_native_block_pool_matches_original():
    def ops(mod):
        pool = mod.NativeBlockPool(6, 4)
        a = pool.alloc(4)
        pool.ref(a[:2])
        return [a, pool.free_blocks(), pool.alloc(3), pool.release(a),
                pool.release(a[:1]), pool.free_blocks(), pool.alloc(2)]

    assert ops(t_native) == ops(j_native)


def _sched_run(req_mod, sched_mod, pool_mod):
    """Admission under a token budget, policy order, preemption on pool
    pressure and retirement; returns every decision by request id."""
    pool = pool_mod.PagedKVCache(num_blocks=6, block_size=4)
    sched = sched_mod.Scheduler(
        sched_mod.SchedulerConfig(max_batch_size=3, max_tokens_per_batch=40,
                                  policy=sched_mod.SchedulingPolicy.PRIORITY,
                                  kv_reserve="prompt"), kv_pool=pool)
    lens = [5, 3, 9, 4, 7, 2]
    for i, n in enumerate(lens):
        sched.add_request(req_mod.Request(f"r{i}", list(range(1, n + 1)),
                                          max_new_tokens=4,
                                          priority=i % 3))
    log = []
    for it in range(6):
        out = sched.schedule()
        log.append(([r.request_id for r in out.prefill],
                    [r.request_id for r in out.decode],
                    [r.request_id for r in out.preempted],
                    out.num_prefill_tokens, out.num_decode_tokens))
        victims = sched._preempt_for(12) if it == 1 else []
        log.append([v.request_id for v in victims])
        if it >= 2 and sched.running:
            sched.update([sorted(sched.running)[0]])
        log.append(sched.stats())
    return log


def test_scheduler_copy_matches_original():
    got = _sched_run(t_request, t_sched, t_paged_kv)
    want = _sched_run(j_request, j_sched, j_paged_kv)
    assert got == want
    assert any(entry for i, entry in enumerate(got) if i % 3 == 1)  # preempted


@pytest.mark.parametrize("k", [[0, 1, 5, 100], [3, -1, 17, 2]])
def test_dynamic_top_k_matches_reference(k):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(4, 100)).astype(np.float32)
    logits[1, :10] = logits[1, 10]                  # ties at the k-th value
    want = j_sampling._apply_top_k_dynamic(jax.numpy.asarray(logits),
                                           jax.numpy.asarray(k))
    got = t_sampling._apply_top_k_dynamic(torch.from_numpy(logits),
                                          torch.tensor(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # per-request top-k through sample_token: greedy rows stay argmax, a
    # top-1 row is its argmax whatever the temperature
    gen = torch.Generator().manual_seed(0)
    toks = t_sampling.sample_token(torch.from_numpy(logits), gen,
                                   temperature=torch.tensor([0., 1., 1., 0.]),
                                   top_k=torch.tensor([0, 1, 5, 3]),
                                   top_p=torch.ones(4))
    top = logits.argmax(-1)
    assert toks[0] == top[0] and toks[1] == top[1] and toks[3] == top[3]
    assert int(toks[2]) in np.argsort(-logits[2])[:5]


# ------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def toy():
    jcfg = JConfig(**TOY)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, TConfig(**TOY), jparams, params_from_jax(to_numpy(jparams),
                                                          device="cpu")


def _stream(seed: int, n: int):
    """n greedy requests: ragged prompts, every third one sharing a
    two-block prefix, a few with stop tokens."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, 100, 16)]
    out = []
    for i in range(n):
        tail = [int(t) for t in rng.integers(1, 100, int(rng.integers(1, 14)))]
        prompt = shared + tail if i % 3 == 0 else tail + [int(i)]
        stop = (int(rng.integers(1, 100)),) if i % 4 == 1 else ()
        out.append((prompt, int(rng.integers(3, 12)), stop))
    return out


def _serve(eng, req_cls, waves):
    """Submit each wave, run it to the end; returns everything compared."""
    eng.dispatch_trace = []
    results = []
    for wave in waves:
        rids = [eng.submit_request(req_cls(prompt_tokens=p, max_tokens=m,
                                           temperature=0.0, stop_tokens=st))
                for p, m, st in wave]
        eng.run_until_done(rids)
        results += [(eng.get_result(r).tokens, eng.get_result(r).finish_reason)
                    for r in rids]
    return dict(results=results, trace=eng.dispatch_trace,
                radix_hits=eng.stats()["radix_hit_tokens"],
                preempted=eng.scheduler.num_preempted,
                pool=eng.pool.stats())


ENGINE_CASES = {
    "radix-h8-f32": dict(decode_horizon=8),
    "noradix-h1-f32": dict(decode_horizon=1, enable_radix=False),
    "radix-h8-int8": dict(decode_horizon=8, kv_dtype="int8"),
    "pressure-h8-int8": dict(decode_horizon=8, kv_dtype="int8",
                             num_blocks=9, max_batch=4),
    "pressure-h1-f32": dict(decode_horizon=1, num_blocks=9, max_batch=3),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine(toy, case):
    jcfg, tcfg, jparams, tparams = toy
    kw = dict(num_blocks=32, block_size=8, max_batch=4,
              max_blocks_per_request=8, prompt_buckets=(8, 16, 32))
    kw.update(ENGINE_CASES[case])
    stream = _stream(len(case), 10)
    waves = [stream[:6], stream[6:]]
    want = _serve(j_engine.PagedInferenceEngine(
        jparams, jcfg, j_engine.PagedEngineConfig(**kw)), JRequest, waves)
    got = _serve(t_engine.PagedInferenceEngine(
        tparams, tcfg, t_engine.PagedEngineConfig(**kw)), TRequest, waves)
    assert got["results"] == want["results"]
    assert got["trace"] == want["trace"]
    for key in ("radix_hits", "preempted", "pool"):
        assert got[key] == want[key], key
    horizons = {t[1] for t in want["trace"] if t[0] == "decode"}
    if kw.get("enable_radix", True):
        assert want["radix_hits"] > 0
    if case.startswith("pressure"):
        assert want["preempted"] > 0
    assert (max(horizons) > 1) == (kw["decode_horizon"] > 1)


def test_int8_pool_contents_match_after_serving(toy):
    """After one served wave on INT8 pools the port's pools hold the JAX
    engine's codes outside the trash block: layer 0 bit for bit (scales to
    f32 rounding); deeper layers within one int8 level, since K6 rounds
    p * v_scale to bf16 against another running max than the Pallas kernel's
    block-by-block softmax, so the attention output differs in bf16 ulps."""
    jcfg, tcfg, jparams, tparams = toy
    kw = dict(num_blocks=24, block_size=8, max_batch=4,
              max_blocks_per_request=8, prompt_buckets=(8, 16, 32),
              kv_dtype="int8", enable_radix=False)
    wave = _stream(3, 4)
    je = j_engine.PagedInferenceEngine(jparams, jcfg,
                                       j_engine.PagedEngineConfig(**kw))
    te = t_engine.PagedInferenceEngine(tparams, tcfg,
                                       t_engine.PagedEngineConfig(**kw))
    assert _serve(je, JRequest, [wave])["results"] == \
        _serve(te, TRequest, [wave])["results"]
    nb = kw["num_blocks"]
    jq, js = np.asarray(je._k.q)[:, :nb], np.asarray(je._k.s)[:, :nb]
    tq, ts = te._k.q[:, :nb].numpy(), te._k.s[:, :nb].numpy()
    np.testing.assert_array_equal(tq[0], jq[0])
    np.testing.assert_allclose(ts[0], js[0], **TOL["float32"])
    diff = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    np.testing.assert_allclose(ts, js, **TOL["bfloat16"])


def test_prefill_compile_stats_match_jax_engine(toy):
    """stats()["prefill_compile"], the prefill step cache keyed by the
    prompt bucket, against the JAX engine's compile cache on one request
    stream: after warmup() (every bucket once) and after each wave."""
    jcfg, tcfg, jparams, tparams = toy
    kw = dict(num_blocks=32, block_size=8, max_batch=4,
              max_blocks_per_request=8, prompt_buckets=(8, 16, 32),
              decode_horizon=4)
    je = j_engine.PagedInferenceEngine(jparams, jcfg,
                                       j_engine.PagedEngineConfig(**kw))
    te = t_engine.PagedInferenceEngine(tparams, tcfg,
                                       t_engine.PagedEngineConfig(**kw))
    je.warmup(buckets=(8, 16))
    te.warmup(buckets=(8, 16))
    seen = [(te.stats()["prefill_compile"], je.stats()["prefill_compile"])]
    stream = _stream(7, 8)
    for wave in (stream[:5], stream[5:]):
        got = _serve(te, TRequest, [wave])
        want = _serve(je, JRequest, [wave])
        assert got["results"] == want["results"]
        assert got["trace"] == want["trace"]
        seen.append((te.stats()["prefill_compile"],
                     je.stats()["prefill_compile"]))
    for got, want in seen:
        assert got == want
    assert seen[-1][1]["hits"] > 0 and seen[0][1]["misses"] == 2
