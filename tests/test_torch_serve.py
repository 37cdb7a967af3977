"""The port's serving front end against the JAX package's: the schema
(api_types), the tokenizer pool and the benchmark harness (copies, held to
their originals on the same inputs), then the port's InferenceServer on
port 0 over each port engine, beside the JAX server over the JAX engine of
the same kind on the same weights: routes, status codes, SSE framing, and
greedy completion text identical to the JAX server's. Then the port's CLI
on the CPU. Every socket has a timeout and every server shuts down."""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import pytest

from physics_llm_inference_tpu.bench import harness as j_harness
from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models import init_params as j_init
from physics_llm_inference_tpu.serve import api_types as j_api
from physics_llm_inference_tpu.serve import engine as j_engine
from physics_llm_inference_tpu.serve import http_server as j_http
from physics_llm_inference_tpu.serve import paged_engine as j_paged
from physics_llm_inference_tpu.serve import tokenizer_pool as j_tok
from physics_llm_inference_tpu_torch import cli
from physics_llm_inference_tpu_torch.bench import harness as t_harness
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.serve import api_types as t_api
from physics_llm_inference_tpu_torch.serve import engine as t_engine
from physics_llm_inference_tpu_torch.serve import http_server as t_http
from physics_llm_inference_tpu_torch.serve import paged_engine as t_paged
from physics_llm_inference_tpu_torch.serve import tokenizer_pool as t_tok
from torch_parity import to_numpy

# the server model of tests/test_serve.py (vocab 256: the dummy tokenizer)
SERVE_TOY = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
                 dtype="float32")
TIMEOUT = 60


# ------------------------------------------------------------ host copies

REQUEST_BODIES = [
    {"model": "m", "messages": [{"role": "user", "content": "hi"}],
     "max_tokens": 5, "temperature": 0.2, "stream": True, "stop": "END"},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"content": "x"}], "top_k": "3", "top_p": 0.5,
     "stop": ["a", "b"]},
    {},
]


def _chunk(mod, **kw):
    return mod.ChatCompletionChunk(created=7, **kw)


@pytest.mark.parametrize("body", REQUEST_BODIES)
def test_api_types_match_jax(body):
    got = t_api.ChatCompletionRequest.from_dict(body)
    want = j_api.ChatCompletionRequest.from_dict(body)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.prompt_text() == want.prompt_text()
    resp = [mod.ChatCompletionResponse.create("m", "out", "stop", 10, 5)
            for mod in (t_api, j_api)]
    d = [r.to_dict() for r in resp]
    for x in d:
        x.pop("id"), x.pop("created")
    assert d[0] == d[1] and d[0]["usage"]["total_tokens"] == 15
    assert resp[0].id.startswith("chatcmpl-")
    for kw in (dict(id="x", model="m", delta="tok"),
               dict(id="x", model="m", delta="", finish_reason="stop")):
        assert _chunk(t_api, **kw).to_sse() == _chunk(j_api, **kw).to_sse()
    assert t_api.SSE_DONE == j_api.SSE_DONE


def _pool_ops(mod):
    pool = mod.TokenizerPool(num_workers=3)
    seen = [pool.tokenize("abc"), pool.tokenize("hé"),
            pool.detokenize([104, 105, 300]),
            pool.tokenize_batch(["a", "bb", "ccc"])]
    done = threading.Event()
    box = []
    pool.tokenize_async("xy", lambda ids: (box.append(ids), done.set()))
    assert done.wait(10)
    seen += [box[0], pool.stats()]
    return seen


def test_tokenizer_pool_matches_jax():
    assert _pool_ops(t_tok) == _pool_ops(j_tok)


@pytest.mark.parametrize("concurrency", [1, 4])
def test_harness_matches_jax(concurrency):
    vals = [float(i) for i in range(1, 101)] + [0.5, 250.0]
    for p in (0, 50, 90, 99, 100):
        assert t_harness.percentile(vals, p) == j_harness.percentile(vals, p)
    assert t_harness.percentile([], 50) == j_harness.percentile([], 50)

    def mock(prompt, max_tokens):
        return {"tokens": list(prompt[:max_tokens]), "ttft_s": 0.001}

    outs = []
    for mod in (t_harness, j_harness):
        cfg = mod.BenchmarkConfig(num_requests=10, concurrency=concurrency,
                                  max_tokens=4, prompt_len=6)
        res = mod.run_benchmark(cfg, mock)
        d = res.to_dict()
        outs.append((res.num_requests, res.total_tokens, res.ttfts_s,
                     sorted(d), sorted(d["latency"]),
                     [ln.split(":")[0] for ln in res.summary().split("\n")]))
    assert outs[0] == outs[1] and outs[0][1] == 40


# --------------------------------------------------------------- servers

def _engines(kind, jparams, tparams):
    jcfg, tcfg = JConfig(**SERVE_TOY), TConfig(**SERVE_TOY)
    if kind == "slot":
        kw = dict(num_slots=4, max_seq_len=96, prompt_buckets=(16, 32, 64))
        return (j_engine.InferenceEngine(jparams, jcfg,
                                         j_engine.EngineConfig(**kw)),
                t_engine.InferenceEngine(tparams, tcfg,
                                         t_engine.EngineConfig(**kw)))
    kw = dict(max_batch=4, num_blocks=64, block_size=16,
              max_blocks_per_request=6, prompt_buckets=(16, 32))
    return (j_paged.PagedInferenceEngine(jparams, jcfg,
                                         j_paged.PagedEngineConfig(**kw)),
            t_paged.PagedInferenceEngine(tparams, tcfg,
                                         t_paged.PagedEngineConfig(**kw)))


@pytest.fixture(scope="module")
def weights():
    jparams = j_init(jax.random.PRNGKey(0), JConfig(**SERVE_TOY))
    return jparams, params_from_jax(to_numpy(jparams), device="cpu")


@pytest.fixture(scope="module", params=["slot", "paged"])
def servers(request, weights):
    """(kind, JAX server, port server) over engines of one kind."""
    je, te = _engines(request.param, *weights)
    started = []
    try:
        for mod, eng in ((j_http, je), (t_http, te)):
            started.append(mod.InferenceServer(eng, port=0)
                           .start_background())
        yield request.param, started[0], started[1]
    finally:
        for srv in started:
            srv.shutdown()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(srv, path, body, raw=None):
    req = urllib.request.Request(
        _url(srv, path), data=raw if raw is not None
        else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=TIMEOUT) as r:
        return json.load(r)


def _status(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code


def _chat(srv, content, max_tokens, **kw):
    body = dict(messages=[{"role": "user", "content": content}],
                max_tokens=max_tokens, temperature=0.0, **kw)
    with _post(srv, "/v1/chat/completions", body) as r:
        if kw.get("stream"):
            return r.read().decode()
        return json.load(r)


def test_health_and_models(servers):
    _, _, srv = servers
    assert _get(srv, "/health") == {"status": "ok"}
    assert _get(srv, "/v1/models")["data"][0]["id"] == "default"


@pytest.mark.parametrize("content,max_tokens", [("hello", 5),
                                                ("abc abc abc abc", 9)])
def test_chat_text_matches_jax_server(servers, content, max_tokens):
    _, jsrv, srv = servers
    got, want = (_chat(s, content, max_tokens) for s in (srv, jsrv))
    assert got["object"] == "chat.completion"
    assert got["usage"] == want["usage"]
    assert got["usage"]["completion_tokens"] == max_tokens
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    assert got["choices"][0]["finish_reason"] == "length"


def test_completions_route_matches_jax_server(servers):
    _, jsrv, srv = servers
    body = {"prompt": "once upon", "max_tokens": 4, "temperature": 0.0}
    outs = []
    for s in (srv, jsrv):
        with _post(s, "/v1/completions", body) as r:
            outs.append(json.load(r)["choices"][0]["message"]["content"])
    assert outs[0] == outs[1]


def test_streaming_sse_matches_jax_server(servers):
    _, jsrv, srv = servers
    texts = []
    for s in (srv, jsrv):
        body = _chat(s, "hi there", 6, stream=True)
        events = [e for e in body.split("\n\n") if e.startswith("data: ")]
        assert events[-1] == "data: [DONE]"
        deltas = [json.loads(e[6:]) for e in events[:-1]]
        assert deltas[-1]["choices"][0]["finish_reason"] == "length"
        parts = [d["choices"][0]["delta"].get("content", "") for d in deltas]
        assert sum(1 for p in parts if p) <= 6
        texts.append("".join(parts))
    assert texts[0] == texts[1]
    assert texts[0] == _chat(srv, "hi there", 6)["choices"][0]["message"][
        "content"]


def test_metrics_serialize(servers):
    kind, jsrv, srv = servers
    got, want = _get(srv, "/metrics"), _get(jsrv, "/metrics")
    assert sorted(got) == sorted(want)
    assert got["total_requests"] >= 1
    if kind == "paged":
        assert "pool" in got and "radix" in got


def test_error_codes(servers):
    _, _, srv = servers
    assert _status(lambda: _post(srv, "/v1/chat/completions", None,
                                 raw=b"{not json")) == 400
    assert _status(lambda: _post(srv, "/v1/chat/completions",
                                 {"max_tokens": 4})) == 400
    assert _status(lambda: _post(srv, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x" * 200}],
        "max_tokens": 50})) == 400
    assert _status(lambda: _post(srv, "/v1/nope", {})) == 404
    assert _status(lambda: _get(srv, "/nope")) == 404


def test_concurrent_chats_match_solo(servers):
    """Eight clients at once: each gets the text it gets alone."""
    _, _, srv = servers
    prompts = [f"r{i} " + "ab" * i for i in range(8)]   # within 32 tokens
    solo = [_chat(srv, p, 4)["choices"][0]["message"]["content"]
            for p in prompts[:2]]
    out = [None] * len(prompts)

    def one(i):
        out[i] = _chat(srv, prompts[i], 4)["choices"][0]["message"][
            "content"]

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert out[:2] == solo and all(o is not None for o in out)


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_sse_misses_no_token_when_the_loop_steps_first(weights, kind):
    """The engine steps twice between the request's intake and the return
    of submit_request, as the serving loop can while a handler thread is
    between the two: the SSE stream still carries every token (a listener
    attached after submit_request lost the first ones)."""
    _, eng = _engines(kind, *weights)
    srv = t_http.InferenceServer(eng, port=0).start_background()
    try:
        want = _chat(srv, "hi there", 6)["choices"][0]["message"]["content"]
        submit = eng.submit_request

        def submit_then_step(*a, **kw):
            rid = submit(*a, **kw)
            eng.step()
            eng.step()
            return rid

        eng.submit_request = submit_then_step
        body = _chat(srv, "hi there", 6, stream=True)
    finally:
        srv.shutdown()
    events = [e for e in body.split("\n\n") if e.startswith("data: ")]
    parts = [json.loads(e[6:])["choices"][0]["delta"].get("content", "")
             for e in events[:-1]]
    assert "".join(parts) == want and len(events) == 6 + 2


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_serving_loop_lets_abort_in(weights, kind):
    """abort_request from another thread while the serving loop steps the
    engine: the loop yields the engine lock between steps, so the abort
    lands while the request runs (without the yield the caller waited for
    the engine to go idle, and the request ran to its end)."""
    _, eng = _engines(kind, *weights)
    loop = t_http.ServingLoop(eng)
    try:
        rid = eng.submit_request(t_engine.GenerationRequest(
            prompt_tokens=[1, 2, 3], max_tokens=90, temperature=0.0))
        loop.notify()
        res = None
        for _ in range(TIMEOUT * 100):
            r = eng.scheduler.running.get(rid)
            if r is not None and len(r.output_tokens) >= 2:
                break
            threading.Event().wait(0.01)
        assert eng.abort_request(rid)
        res = eng.wait_result(rid, timeout=TIMEOUT)
    finally:
        loop.shutdown()
    assert not loop._thread.is_alive()
    assert res is not None and res.finish_reason == "aborted"
    assert 2 <= len(res.tokens) < 90


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("paged", [False, True])
def test_cli_serve_check(paged, capsys):
    cli.main(["serve", "--config", "toy", "--check", "--device", "cpu",
              "--port", "0"] + (["--paged", "--max-seq-len", "256"]
                                if paged else []))
    assert "[cli] check ok" in capsys.readouterr().err


def test_cli_generate_and_bench(capsys):
    cli.main(["generate", "--config", "toy", "--device", "cpu", "--prompt",
              "hello", "--max-tokens", "5", "--int8"])
    out, err = capsys.readouterr()
    assert len(out.rstrip("\n")) == 5 and "tok/s" in err
    cli.main(["bench", "--config", "toy", "--device", "cpu", "--requests",
              "2", "--prompt-len", "8", "--max-tokens", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["num_requests"] == 2 and res["tokens_per_s"] > 0


def test_cli_refusals(monkeypatch):
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["generate", "--config", "toy", "--prompt", "hi"])
    with pytest.raises(FileNotFoundError):   # --ckpt loads, and x.npz is not there
        cli.main(["serve", "--config", "toy", "--ckpt", "x.npz",
                  "--device", "cpu", "--check"])
    # --tp above 1 without a launched world: the launcher command
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="python -m torch.distributed.run"):
        cli.main(["serve", "--config", "toy", "--tp", "2", "--device",
                  "cpu", "--check"])
    with pytest.raises(SystemExit):
        cli.main(["serve", "--config", "nope", "--device", "cpu"])
