"""DeepSeek-V2's parts in the port (multi-head latent attention over the
INT8 latent cache, YaRN, the leading dense layer, top-k without
renormalisation, shared experts, the dropless routed-pairs prefill) held
against the plain float32 reference `tests/plain_deepseek_v2.py` on seeded
random weights at a toy shape, on the CPU, where every kernel takes its
plain version.

Tolerances: the program runs float32 activations here, so it and the
reference differ by float32 summation orders (~1e-6 relative) and, where a
latent or rope-key value lands within that of a rounding boundary of the
int8 cache format, by one code of that token (its scale, ~1% of the
token's largest value, in one key): logits within 2e-3 of their scale.
The absorbed decode against the decompressed form differs by summation
order alone: 1e-5.
"""
import copy
import math

import numpy as np
import pytest
import torch

from benchmark.arch import deepseek_v2 as bench_ds
from physics_llm_inference_tpu_torch.models import mla, moe
from physics_llm_inference_tpu_torch.models.config import (
    DEEPSEEK_V2_LITE_CONFIG, ModelConfig, MoEConfig, YarnScaling)
from physics_llm_inference_tpu_torch.models.quant import quantize_params_int8
from physics_llm_inference_tpu_torch.models.transformer import (
    KVSlice, _ffn, forward, init_params, layer_view)
from physics_llm_inference_tpu_torch.ops import rope as t_rope
from physics_llm_inference_tpu_torch.runtime.generate import cached_generate
from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache
from physics_llm_inference_tpu_torch.utils import tracing
from tests import plain_deepseek_v2 as plain

TOY = {
    "model_type": "deepseek_v2", "hidden_size": 64, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
    "intermediate_size": 96, "moe_intermediate_size": 32,
    "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                     "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096},
    "vocab_size": 256, "max_position_embeddings": 4096,
    "precision": {"weights": "int8", "kv_cache": "int8",
                  "activations": "float32"},
    "assumed": {"expert_capacity_factor": 2.7},
}
TOL = 2e-3


@pytest.fixture(scope="module")
def model():
    w = bench_ds.weights(TOY, 2**31 + 5, "cpu")
    return w, bench_ds.program_params(w), bench_ds.model_config(TOY)


def _prompts(seed=3, lens=(7, 19, 12)):
    r = np.random.default_rng(seed)
    return [r.integers(1, TOY["vocab_size"], n).tolist() for n in lens]


def _close(got, want, tol=TOL):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale


def test_config_defaults_leave_the_other_models_alone():
    cfg = ModelConfig(vocab_size=8, hidden_dim=16, num_layers=1, num_heads=2,
                      num_kv_heads=1, intermediate_dim=8)
    assert not cfg.mla and cfg.norm_topk_prob and not cfg.router_f32
    assert (cfg.shared_expert_dim, cfg.first_k_dense_replace) == (0, 0)
    ds = DEEPSEEK_V2_LITE_CONFIG
    assert (ds.num_layers, ds.num_experts, ds.kv_lora_rank, ds.vocab_size,
            ds.shared_expert_dim) == (27, 64, 512, 102400, 2816)
    # every pair of a 64-row step fits its expert: the grouped kernels'
    # 64 slots, none dropped
    assert int(ds.expert_capacity_factor * 64 * 6 / 64) == 64


def test_yarn_frequencies_and_scale_by_hand():
    """DeepSeek-V2-Lite's rope: dim 64, base 1e4, factor 40 over 4096
    positions, beta 32 / 1. Correction dims: floor(64 ln(4096 / (64 pi)) /
    (2 ln 1e4)) = floor(10.47) = 10 and ceil(64 ln(4096 / (2 pi)) /
    (2 ln 1e4)) = ceil(22.51) = 23; below 10 base's frequencies, from 23
    base's / 40, between a linear blend; mscale 1 + 0.0707 ln 40."""
    yarn = YarnScaling()
    inv = t_rope.yarn_inv_freq(64, 10000.0, yarn)
    base = 1.0 / 10000.0 ** (torch.arange(0, 64, 2).double() / 64)
    for i in (0, 5, 10):
        assert float(inv[i]) == pytest.approx(float(base[i]), rel=1e-6)
    for i in (23, 28, 31):
        assert float(inv[i]) == pytest.approx(float(base[i]) / 40, rel=1e-6)
    ramp = (16 - 10) / 13
    assert float(inv[16]) == pytest.approx(
        float(base[16]) * (ramp / 40 + (1 - ramp)), rel=1e-6)
    assert t_rope.yarn_mscale(40, 0.707) == pytest.approx(1.2608038, rel=1e-6)
    assert t_rope.yarn_attention_scale(192, yarn) == pytest.approx(
        192 ** -0.5 * 1.2608038 ** 2, rel=1e-6)
    assert t_rope.yarn_attention_scale(192, yarn) == pytest.approx(0.1147214,
                                                                   rel=1e-5)
    # the reference's frequencies are the same numbers
    cfg = dict(TOY, qk_rope_head_dim=64)
    torch.testing.assert_close(plain.yarn_inv_freq(cfg), inv, rtol=1e-6,
                               atol=0)


def test_deinterleaved_rope_on_a_hand_built_vector():
    """x = (a0, a1, a2, a3) at position 1 with frequencies (w0, w1): the
    pairs (a0, a1), (a2, a3) become halves (a0, a2 | a1, a3), then
    rotate-half: (a0 c0 - a1 s0, a2 c1 - a3 s1, a1 c0 + a0 s0,
    a3 c1 + a2 s1). A random-weight test cannot see this layout."""
    a = torch.tensor([1.0, 2.0, 3.0, 4.0])
    cfg = dict(TOY, qk_rope_head_dim=4,
               rope_scaling=dict(TOY["rope_scaling"], factor=1.0))
    w0, w1 = 1.0, 1e4 ** -0.5
    c0, s0, c1, s1 = math.cos(w0), math.sin(w0), math.cos(w1), math.sin(w1)
    want = torch.tensor([1 * c0 - 2 * s0, 3 * c1 - 4 * s1,
                         2 * c0 + 1 * s0, 4 * c1 + 3 * s1])
    seq = torch.stack([torch.zeros(4), a])[:, None, :]       # (T 2, H 1, 4)
    got_ref = plain.rope(seq, cfg)[1, 0]
    torch.testing.assert_close(got_ref, want, rtol=1e-6, atol=1e-6)
    cos = torch.tensor([[[c0, c1]]])
    sin = torch.tensor([[[s0, s1]]])
    got = t_rope.apply_rope_deinterleaved(a.view(1, 1, 1, 4), cos, sin)
    torch.testing.assert_close(got.view(4), want, rtol=1e-6, atol=1e-6)


def test_benchmark_copy_of_the_reference_is_bit_equal(model):
    w, _, _ = model
    prompts = _prompts()
    pos = [list(range(len(p))) for p in prompts]
    ours = plain.logits(w, TOY, prompts, pos)
    theirs = bench_ds.logits(w, TOY, prompts, pos)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_prefill_logits_match_the_reference(model):
    w, params, cfg = model
    prompts = _prompts()
    want = plain.logits(w, TOY, prompts,
                        [list(range(len(p))) for p in prompts])
    for p, ref in zip(prompts, want):
        got, _ = forward(params, torch.tensor([p]), cfg)
        _close(got[0], ref)
    # the padded batch through the latent cache (cached_generate's prefill)
    b, s = len(prompts), 32
    cache = KVCache.create(cfg, b, s + 4, dtype=torch.int8)
    ids = torch.zeros((b, s), dtype=torch.long)
    for i, p in enumerate(prompts):
        ids[i, s - len(p):] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts])
    slots = torch.arange(s)[None].expand(b, s)
    positions = (slots - (s - lens)[:, None]).clamp_min(0)
    got, _ = forward(params, ids, cfg, kv=cache.as_slice(),
                     positions=positions, slots=slots,
                     valid_from=(s - lens).int(), k_limit=s, fresh_kv=True)
    for i, (p, ref) in enumerate(zip(prompts, want)):
        _close(got[i, s - len(p):], ref)


def test_decode_through_the_latent_cache_matches_the_reference(model):
    """Prefill, then one forward a token through the LatentKV cache (the
    absorbed decode, the step cached_generate's loop runs): every
    generated position's logits against the reference's full forward."""
    w, params, cfg = model
    prompts = _prompts(lens=(5, 11))
    b, s, new = len(prompts), 16, 6
    cache = KVCache.create(cfg, b, s + new, dtype=torch.int8)
    assert cache.kind == "latent_int8"
    ids = torch.zeros((b, s), dtype=torch.long)
    for i, p in enumerate(prompts):
        ids[i, s - len(p):] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts])
    vfrom = (s - lens).int()
    slots = torch.arange(s)[None].expand(b, s)
    logits, kv = forward(params, ids, cfg, kv=cache.as_slice(),
                         positions=(slots - vfrom[:, None]).clamp_min(0),
                         slots=slots, valid_from=vfrom, last_only=True,
                         k_limit=s, fresh_kv=True)
    steps = [logits[:, 0]]
    toks = [logits[:, 0].argmax(-1)]
    for i in range(new - 1):
        slot = torch.full((b,), s + i)
        logits, _ = forward(params, toks[-1][:, None], cfg,
                            kv=KVSlice(cache.k, None, slot),
                            positions=(lens + i)[:, None],
                            slots=slot[:, None], valid_from=vfrom,
                            last_only=True)
        steps.append(logits[:, 0])
        toks.append(logits[:, 0].argmax(-1))
    for r, p in enumerate(prompts):
        seq = p + [int(t[r]) for t in toks[:-1]]
        ref = plain.logits(w, TOY, [seq],
                           [list(range(len(p) - 1, len(seq)))])[0]
        _close(torch.stack([x[r] for x in steps]), ref)


def test_cached_generate_serves_the_references_tokens(model):
    """cached_generate (captured-loop's eager form on the CPU) through the
    INT8 latent cache: every served token is the reference's best at its
    position, up to a near-tie of the tolerance's size."""
    w, params, cfg = model
    prompts = _prompts(lens=(9, 4, 14))
    out = cached_generate(params, cfg, prompts, 8, temperature=0.0,
                          kv_dtype=torch.int8, prompt_bucket=16)
    for p, toks in zip(prompts, out.tokens):
        seq = p + [int(t) for t in toks[:-1]]
        ref = plain.logits(w, TOY, [seq],
                           [list(range(len(p) - 1, len(seq)))])[0]
        gap = ref.max(-1).values - ref.gather(
            1, torch.as_tensor(toks, dtype=torch.long)[:, None])[:, 0]
        assert float(gap.max()) <= TOL * float(ref.abs().max())


def test_absorbed_decode_equals_the_decompressed_form(model):
    """One layer's attention for a new token at slot T: the absorbed form
    (queries through W_UK, the plain MLA decode kernel over the latent
    cache a prefill of T tokens wrote, W_UV) against the decompressed form
    (k and v through W_kv_b, per-head attention) over the same T + 1
    tokens without a cache, which pass through the same int8 format:
    equal up to summation order."""
    _, params, cfg = model
    bp = layer_view(params["blocks"], 1)
    g = torch.Generator().manual_seed(11)
    b, t = 2, 9
    x = torch.randn((b, t + 1, cfg.hidden_dim), generator=g)
    cache = KVCache.create(cfg, b, t + 1, dtype=torch.int8).k
    pos = torch.arange(t + 1)[None].expand(b, t + 1)
    cos, sin = mla.rope_cos_sin(cfg, pos)
    vfrom = torch.tensor([0, 3], dtype=torch.int32)
    mla.mla_attention(bp, x[:, :t], cfg, cos[:, :t], sin[:, :t], kv=cache,
                      start=0, slots=pos[:, :t], valid_from=vfrom, layer=1,
                      fresh_kv=True)
    slot = torch.full((b,), t)
    absorbed = mla.mla_attention(bp, x[:, t:], cfg, cos[:, t:], sin[:, t:],
                                 kv=cache, start=slot, slots=slot[:, None],
                                 valid_from=vfrom, layer=1)
    whole = mla.mla_attention(bp, x, cfg, cos, sin, valid_from=vfrom)
    torch.testing.assert_close(absorbed[:, 0], whole[:, t], rtol=1e-5,
                               atol=1e-5)


def test_topk_without_renormalisation_and_shared_experts(model):
    _, params, cfg = model
    g = torch.Generator().manual_seed(2)
    x = torch.randn((10, cfg.hidden_dim), generator=g)
    bp = layer_view(params["blocks"], 2)
    w, idx, probs = moe.router(x, bp["moe_gate"], 3, norm=False, f32=True,
                               scaling=1.0)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    torch.testing.assert_close(w, top.values[:, :3], rtol=0, atol=0)
    assert bool((w.sum(-1) < 1).all())
    w2, _, _ = moe.router(x, bp["moe_gate"], 3, norm=False, f32=True,
                          scaling=2.5)
    torch.testing.assert_close(w2, 2.5 * w)
    # the FFN of an MoE layer: the routed sum plus the shared SwiGLU
    from physics_llm_inference_tpu_torch.models.config import moe_config
    from physics_llm_inference_tpu_torch.models.transformer import _linear
    routed = moe.moe_forward(x, {"gate": bp["moe_gate"], "w1": bp["moe_w1"],
                                 "w3": bp["moe_w3"], "w2": bp["moe_w2"]},
                             moe_config(cfg))
    gate, up = _linear(x, bp["shared_w_gate_up"]).chunk(2, dim=-1)
    shared = _linear(torch.nn.functional.silu(gate) * up,
                     bp["shared_w_down"])
    torch.testing.assert_close(_ffn(bp, x, cfg), routed + shared)
    # layer 0 is the dense one
    dense = layer_view(params["blocks"], 0)
    assert "w_gate_up" in dense and "moe_gate" not in dense
    assert "w_gate_up" not in bp and "shared_w_down" in bp


@pytest.mark.parametrize("int8,pads", [(False, False), (True, True)])
def test_dropless_prefill_equals_the_grid(int8, pads, monkeypatch):
    """Mixtral's toy shape (8 experts, top-2, capacity factor 4.0 = E / K):
    200 tokens give a capacity of 200 > 64 slots, so the routed pairs go
    through `_dropless`; the grid path (forced by lifting MAX_SLOTS) gives
    the same output, and the route's row counts are recorded."""
    e, d, f, t = 8, 32, 48, 200
    g = torch.Generator().manual_seed(4)
    params = {"gate": torch.randn((d, e), generator=g) * d ** -0.5,
              "w1": torch.randn((e, d, f), generator=g) * d ** -0.5,
              "w3": torch.randn((e, d, f), generator=g) * d ** -0.5,
              "w2": torch.randn((e, f, d), generator=g) * f ** -0.5}
    if int8:
        q = quantize_params_int8({"embed": None, "norm": None,
                                  "lm_head": torch.ones(1, 1),
                                  "blocks": {"moe_w1": params["w1"][None],
                                             "moe_w3": params["w3"][None],
                                             "moe_w2": params["w2"][None]}})
        for n in ("w1", "w3", "w2"):
            qt = q["blocks"]["moe_" + n]
            params[n] = type(qt)(qt.q[0], qt.s[0])
    cfg = MoEConfig(num_experts=e, num_experts_per_tok=2, capacity_factor=4.0)
    x = torch.randn((t, d), generator=g)
    valid = torch.rand((t,), generator=g) > 0.2 if pads else None
    tracing.RECORDER.clear()
    got = moe.moe_forward(x, params, cfg, valid=valid)
    spans = [s for s in tracing.RECORDER.snapshot().spans
             if s.name == "moe.prefill_route"]
    assert len(spans) == 1
    pairs = 2 * (int(valid.sum()) if pads else t)
    assert spans[0].attrs["pairs"] == pairs
    assert spans[0].attrs["rows_mean"] == pairs / e
    assert spans[0].attrs["rows_max"] >= pairs / e
    monkeypatch.setattr(moe, "MAX_SLOTS", 10**9)
    want = moe.moe_forward(x, params, cfg, valid=valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if pads:
        assert not got[~valid].any()


def test_cached_generate_records_its_spans(model):
    _, params, cfg = model
    tracing.RECORDER.clear()
    out = cached_generate(params, cfg, _prompts(lens=(4, 6)), 3,
                          temperature=0.0, kv_dtype=torch.int8,
                          prompt_bucket=8)
    spans = {s.name: s for s in tracing.RECORDER.snapshot().spans}
    pre, dec = spans["generate.prefill"], spans["generate.decode"]
    assert pre.key == dec.key and pre.end_ns <= dec.start_ns
    want = {"rows": 2, "prompt_bucket": 8, "new_tokens": 3,
            "cache": "latent_int8",
            "cache_bytes_per_token": 3 * (32 + 16 + 8)}
    assert pre.attrs == dec.attrs == want
    assert out.tokens.shape == (2, 3)
    # at DeepSeek-V2-Lite's widths: 27 x 584 bytes a token
    ds = KVCache.create(DEEPSEEK_V2_LITE_CONFIG, 1, 8, dtype=torch.int8,
                        device="meta")
    assert ds.bytes_per_token(DEEPSEEK_V2_LITE_CONFIG) == 27 * 584 == 15768


def test_prefill_in_row_slices_equals_one_forward(model, monkeypatch):
    """A prefill over more than PREFILL_TOKENS padded tokens runs in slices
    of whole rows; the tokens and the cache are those of one forward."""
    from physics_llm_inference_tpu_torch.runtime import generate
    _, params, cfg = model
    prompts = _prompts(lens=(5, 9, 3, 12))
    one = cached_generate(params, cfg, prompts, 4, temperature=0.0,
                          kv_dtype=torch.int8, prompt_bucket=16)
    monkeypatch.setattr(generate, "PREFILL_TOKENS", 32)   # 2 rows a slice
    sliced = cached_generate(params, cfg, prompts, 4, temperature=0.0,
                             kv_dtype=torch.int8, prompt_bucket=16)
    np.testing.assert_array_equal(one.tokens, sliced.tokens)


def test_init_params_gives_layer_zero_a_dense_ffn():
    cfg = bench_ds.model_config(TOY)
    p = quantize_params_int8(init_params(torch.Generator().manual_seed(0),
                                         cfg, device="cpu"))
    blocks = p["blocks"]
    assert blocks["w_gate_up"].q.shape == (1, 64, 192)
    assert blocks["moe_w1"].q.shape == (2, 8, 64, 32)
    assert blocks["shared_w_down"].q.shape == (2, 32, 64)
    assert blocks["wkv_b"].q.shape == (3, 32, 4 * 32)
    out = cached_generate(p, cfg, _prompts(lens=(6, 3)), 3, temperature=0.0,
                          kv_dtype=torch.int8, prompt_bucket=8)
    for prompt, toks in zip(_prompts(lens=(6, 3)), out.tokens):
        seq = prompt + [int(x) for x in toks[:-1]]
        logits, _ = forward(p, torch.tensor([seq]), cfg)
        assert logits[0, len(prompt) - 1:].argmax(-1).tolist() == \
            toks.tolist()


def test_paths_without_mla_refuse_it(model):
    from physics_llm_inference_tpu_torch.kernels import fused_decode
    from physics_llm_inference_tpu_torch.parallel import ep, tp
    from physics_llm_inference_tpu_torch.runtime.speculative import \
        speculative_generate
    from physics_llm_inference_tpu_torch.serve.engine import InferenceEngine
    from physics_llm_inference_tpu_torch.serve.paged_engine import \
        PagedInferenceEngine
    _, params, cfg = model
    for make in (lambda: PagedInferenceEngine(params, cfg),
                 lambda: InferenceEngine(params, cfg),
                 lambda: speculative_generate(params, cfg, [[1, 2]], 2),
                 lambda: tp.tp_local_config(cfg, 2),
                 lambda: fused_decode.fused_decode_step(
                     params["blocks"], None, None, None, None, None, None,
                     None, None, None, cfg)):
        with pytest.raises(NotImplementedError, match="MLA"):
            make()
    from physics_llm_inference_tpu_torch.models.config import moe_config
    with pytest.raises(NotImplementedError, match="MLA"):
        ep.moe_layer_ep(None, torch.zeros(4, 64), {}, moe_config(cfg))
    with pytest.raises(ValueError, match="INT8 latent"):
        KVCache.create(cfg, 1, 8)
    # the fused gate stays shut: the per-op path is MLA's decode
    from physics_llm_inference_tpu_torch.models.transformer import \
        _fused_decode_ok
    cache = KVCache.create(cfg, 8, 16, dtype=torch.int8)
    assert not _fused_decode_ok(params, copy.copy(cfg), 8, cache.as_slice())
