"""K3: fused greedy head, RMSNorm -> INT8 lm_head matmul -> argmax.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/lmhead.py`
`lmhead_greedy` (`_lmhead_kernel`). The CUDA kernel is `csrc/lmhead.cu`:
bound by the (D, V) int8 head bytes, it normalizes each row once, streams the
head through K1's weight stream (its "stream" route, on the plan
`w8a16_stream.plan`) into f32 partials, then sums each logit's
partials in a fixed order, rounds it to bf16 and folds each column range's
(max, first index) into a per-row 64-bit atomicMax, so the (B, V) logits
never reach device memory. The logits are rounded to bf16 before the argmax
and ties go to the first index: both are part of the contract
(lmhead.py:50-57 in the JAX package). A head whose rows are not whole
16-byte vectors (D % 8, V % 16) runs on a zero-padded copy; the padded
columns take no part in the argmax.

`lmhead_greedy` is the entry point: a CPU tensor goes to
`lmhead_greedy_plain`; a CUDA tensor goes to the kernel or raises.
`lmhead_greedy_ok` mirrors the JAX gate, so the model takes this head for
exactly the shapes the JAX package does.
"""
from __future__ import annotations

import torch

from ..ops.norms import rms_norm
from . import _build
from .int8_matmul import int8_matmul_plain, num_sms
from .w8a16_stream import plan

launches = 0  # kernel launches made by lmhead_greedy


def _pick_tk(D: int, V: int) -> int:
    TK = 512
    while TK > 128 and TK * V > (5 << 20):
        TK //= 2
    return TK


def lmhead_greedy_ok(B: int, D: int, V: int, itemsize: int = 2) -> bool:
    """The JAX package's eligibility gate (lmhead.py:70-88), mirrored so the
    port's forward takes the fused head for the same shapes. The CUDA kernel
    itself has no such limits."""
    if V % 128 != 0:
        return False
    TK = _pick_tk(D, V)
    if D % TK != 0:
        return False
    scratch = B * D * itemsize + B * V * 4
    operands = B * D * itemsize + 2 * TK * V + 4 * V
    return scratch + operands <= (60 << 20)


def lmhead_greedy_plain(x, norm_w, lm_q, lm_s, eps: float = 1e-5):
    """rms_norm -> int8_matmul_plain (f32 logits) -> bf16 round -> first-max
    argmax. x: (B, D); norm_w: (D,); lm_q: (D, V) int8; lm_s: (V,) or (1, V)
    f32. Returns (B,) int32."""
    xn = rms_norm(x, norm_w, eps)
    logits = int8_matmul_plain(xn, lm_q, lm_s, out_dtype=torch.float32)
    logits = logits.to(torch.bfloat16).float()
    return torch.argmax(logits, dim=-1).to(torch.int32)


def lmhead_greedy(x, norm_w, lm_q, lm_s, eps: float = 1e-5):
    """Greedy next-token ids (B,) int32 from the final hidden state x (B, D)."""
    global launches
    if not x.is_cuda:
        return lmhead_greedy_plain(x, norm_w, lm_q, lm_s, eps)
    B, D = x.shape
    V = lm_q.shape[1]
    if lm_q.shape != (D, V) or norm_w.numel() != D or lm_s.numel() != V:
        raise ValueError(f"lmhead_greedy: x {tuple(x.shape)}, lm_q "
                         f"{tuple(lm_q.shape)}, lm_s {tuple(lm_s.shape)}")
    if x.dtype != torch.bfloat16 or norm_w.dtype != torch.bfloat16 \
            or lm_q.dtype != torch.int8 or lm_s.dtype != torch.float32:
        raise TypeError("kernel takes bf16 x and norm, int8 head, f32 scales")
    for t in (x, norm_w, lm_q, lm_s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors on one device")
    dp, vp = -(-D // 8) * 8, -(-V // 16) * 16
    lm_s = lm_s.reshape(-1)
    if (dp, vp) != (D, V) or lm_q.data_ptr() % 16 or lm_s.data_ptr() % 16:
        q, s = lm_q.new_zeros((dp, vp)), lm_s.new_zeros((vp,))
        q[:D, :V], s[:V] = lm_q, lm_s
        lm_q, lm_s = q, s
    pl = plan(B, vp, dp, num_sms(x.device))
    xn = torch.empty((B, dp), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((pl.partials, B, vp), dtype=torch.float32,
                     device=x.device)
    packed = torch.empty((B,), dtype=torch.int64, device=x.device)
    tok = torch.empty((B,), dtype=torch.int32, device=x.device)
    err = _build.lib().pli_lmhead_greedy(
        x.data_ptr(), norm_w.data_ptr(), lm_q.data_ptr(), lm_s.data_ptr(),
        xn.data_ptr(), ws.data_ptr(), packed.data_ptr(), tok.data_ptr(), B,
        D, dp, V, vp, eps, *pl.args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lmhead_greedy")
    launches += 1
    return tok
