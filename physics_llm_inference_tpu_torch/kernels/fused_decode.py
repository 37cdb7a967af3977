"""K4 and K8: the whole INT8-KV decode step, all layers, in one launch.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/fused_decode.py`
`fused_decode_step` (`_kernel`, `_fused_decode_step`) in its three modes,
each a template instance of the CUDA kernel `csrc/fused_decode.cu`:
- W8A16 (the default): int8 weights, bf16 activations; f32 partials of
  each GEMM phase land in a workspace and are summed in a fixed order, and
  the per-channel scale comes after the sum.
- W4A16 (`QuantizedTensor4` stacks): nibble-packed weights with group
  scales (`int4_group_size`). A unit reads each packed byte once and makes
  both output columns it holds; each scale group's product is scaled by
  its scale row and added in K order, as the TPU kernel adds `acc * s` per
  K-tile.
- W8A8 (`cfg.act_quant == "int8"`, int8 stacks): each activation row is
  quantized to int8 (absmax over the row) after ln1, attention, ln2 and
  silu; int8 x int8 products accumulate exact int32 partials, then
  `(f32(sum) * row_scale) * w_scale`, as the TPU kernel's N-phase tiles.
The step is one persistent cooperative launch whose per-layer phases (QKV
partials; RoPE and KV quantize; attention over the INT8 cache plus the
current token; WO; norm; gate/up; silu·up; down) are separated by
grid-wide barriers; the attention loop is K2's. Every mode streams its
weights: `w8a16_stream.plan` gives each block an even share of every GEMM phase's
(slab, k-tile) units (W4A16: over the packed bytes), and a producer warp a
block streams the tiles of that share, phase after phase and layer after
layer, through a TMA ring that runs ahead across the barriers
(`csrc/w8a16_stream.cuh`).

The numerics are the TPU kernel's, not the per-op path's: the residual
stream stays f32 across all layers and is cast once at the end; qkv, gate
and up are rounded to bf16 after their f32 sums; K is rounded to bf16 after
RoPE before it is quantized; the current token attends through the
dequantized int8 values the cache will hold; p·v_scale is rounded to bf16
before P@V. Hold the kernel against `fused_decode_step_plain`, never
against the per-op path: the two differ at bf16 near-ties.

`fused_decode_step` is the entry point: a CPU tensor goes to
`fused_decode_step_plain`; a CUDA tensor goes to the kernel instance of its
mode (`fused_decode_mode`) or raises. Each mode counts its own launches.

K8 `fused_paged_decode_step` replaces the TPU kernel
`fused_paged_decode_step` (`_paged_kernel_r5`) of the same file: the same
CUDA kernel in its paged address mode, over the merged INT8 block pools
(kernels/paged_attention.py), with the new K/V written into the pools in
place. Its attention math is the slot kernel's, so its plain twin gathers
each request's blocks into a slot view and runs `fused_decode_step_plain`.
`fused_paged_decode_ok` is the reference's gate without its VMEM budget.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..models.quant import QuantizedTensor, QuantizedTensor4, unpack_int4
from ..ops.norms import rms_norm
from . import _build
from .int8_matmul import int8_matmul_plain
from .paged_attention import write_position
from .w8a16_stream import SLAB4
from .w8a16_stream import plan as _plan

launches = 0         # W8A16 launches of fused_decode_step
w4a16_launches = 0   # W4A16 launches of fused_decode_step
w8a8_launches = 0    # W8A8 launches of fused_decode_step
paged_launches = 0   # kernel launches made by fused_paged_decode_step

W8A16, W4A16, W8A8 = 0, 1, 2     # the modes, as csrc/fused_decode.cu numbers them
_K8 = 3                          # K8's kernel instance in csrc/fused_decode.cu
_NEG_INF = -1e30
_DMAX, _GMAX = 128, 8   # the attention loop's head_dim and group limits
_MATS = ("wqkv", "wo", "w_gate_up", "w_down")
# the phases of one layer in the kernel's order, each ended by a grid
# barrier: the phase clock's stamps (`clock=`) fall at these barriers
PHASES = ("qkv_gemm", "rope_kv", "attention", "wo_gemm", "norm2", "gu_gemm",
          "silu", "down_gemm", "norm1")
PHASES_W8A8 = (PHASES[:3] + ("attn_quant",) + PHASES[3:7] + ("silu_quant",)
               + PHASES[7:])
GEMM_PHASES = {"qkv_gemm": "wqkv", "wo_gemm": "wo", "gu_gemm": "w_gate_up",
               "down_gemm": "w_down"}
_grid: dict[tuple, int] = {}  # (device index, instance) -> blocks of one launch
_workspaces: dict[tuple, dict] = {}  # (device, shapes) -> scratch tensors


def _pick_tile(dim: int, target: int) -> int:
    """The TPU kernel's N-tile (fused_decode.py:1176-1180)."""
    for c in (target, 512, 256, 128):
        if c <= target and dim % c == 0:
            return c
    return dim


def _pick_ktile(k: int, row_bytes: int, cap: int = 3 << 20) -> int:
    """Largest power-of-2 K-tile dividing k whose (tile x N-row) block stays
    under `cap` bytes (the TPU kernel's `_pick_ktile`, fused_decode.py:
    1183-1189)."""
    for c in (1024, 512, 256, 128, 64, 32, 16, 8):
        if k % c == 0 and c * row_bytes <= cap:
            return c
    return k


def int4_group_size(k: int, n: int) -> int:
    """The scale group of an INT4 (K, N) matrix: the TPU kernel's K-tile for
    it (fused_decode.py:1192-1197), so each tile sees one scale row. Packed
    rows are n // 2 bytes. At the 7B widths: 1,024 for wqkv and wo, 256 for
    w_gate_up and w_down."""
    return _pick_ktile(k, n // 2)


def fused_decode_mode(blocks, cfg) -> int:
    """W8A16, W4A16 or W8A8 from the block stacks' type and
    `cfg.act_quant`, as the TPU kernel picks its body (`w4`, `act8`). Mixed
    stacks and W4A8 raise: the TPU kernel takes neither."""
    kinds = {type(blocks[n]) for n in _MATS}
    act8 = cfg.act_quant == "int8"
    if kinds == {QuantizedTensor4}:
        if act8:
            raise ValueError("the fused decode kernel has no W4A8 mode")
        return W4A16
    if kinds == {QuantizedTensor}:
        return W8A8 if act8 else W8A16
    raise TypeError("the fused decode kernel takes all-int8 or all-int4 "
                    f"block stacks, got {sorted(k.__name__ for k in kinds)}")


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half in f32: x (B, H, hd), cos/sin (B, 1, hd/2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _quant(x: torch.Tensor):
    """Per-head absmax int8 over the last axis, as XLA evaluates the TPU
    kernel's quantizer: the scale `max(amax, 1e-8) / 127` becomes a product
    with the f32 reciprocal of 127; `round(x / s)` stays a division.
    Returns (q int8, s (..., 1) f32)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = amax.clamp_min(1e-8) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    q = torch.round(x / s).clamp_(-127, 127)
    return q.to(torch.int8), s


def _round_pv(pv: torch.Tensor) -> torch.Tensor:
    """p * v_scale rounded to bf16 before P@V, as the TPU kernel rounds it
    (a function of its own, so a check can leave the rounding out)."""
    return pv.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, w, layer: int) -> torch.Tensor:
    """f32 (a @ w.q[layer]) * w.s[layer]."""
    return int8_matmul_plain(a, w.q, w.s, layer=layer, out_dtype=torch.float32)


def _rms_exact(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """W8A8's f32 rms(x) * w, the row that is quantized without a bf16
    rounding: the mean of squares is summed in f64 and rounded once, and
    the reciprocal is 1 / sqrt, both correctly rounded, so the CUDA kernel
    (an f64 block sum, IEEE sqrtf and division) gets the same bits. Its
    last bit decides activation codes at exact .5 ties, which bf16 rows
    such as embeddings produce often."""
    ms = (x.double() ** 2).mean(dim=-1, keepdim=True).float()
    return x * (1.0 / torch.sqrt(ms + eps)) * w.float()


def _proj(acc, a, w, layer: int, mode: int, tk: int | None = None):
    """acc (None: zero) plus the f32 product of one layer's linear, as the
    TPU kernel forms it in each mode:
    - W8A16: a bf16, (a @ q) * s after the whole K sum;
    - W4A16: a bf16, each scale group's (a @ q_g) * s_g added in K order;
    - W8A8: a = (codes, row scales); each K-tile of `tk` rows (default all
      of K) is an exact integer product (f64 holds it exactly), then
      (f32(product) * row_scale) * s, added in K order."""
    if mode == W8A16:
        out = _mm(a, w, layer)
        return out if acc is None else acc + out
    if mode == W4A16:
        q, sc, g = unpack_int4(w.q[layer]).float(), w.s[layer], w.group
        af = a.float()
        for i in range(sc.shape[0]):
            part = (af[:, i * g:(i + 1) * g] @ q[i * g:(i + 1) * g]) * sc[i]
            acc = part if acc is None else acc + part
        return acc
    a8, asc = a
    q, k = w.q[layer], a8.shape[1]
    tk = tk or k
    for k0 in range(0, k, tk):
        prod = (a8[:, k0:k0 + tk].double() @ q[k0:k0 + tk].double()).float()
        part = (prod * asc) * w.s[layer]
        acc = part if acc is None else acc + part
    return acc


def write_slots(slot, b: int, device) -> torch.Tensor:
    """A write_cache launch's write slots as a (B,) int32 tensor on
    `device`: a tensor (0-d or (B,)) is used where it lies, so a captured
    step reads each replay's slots; an int is filled on the device."""
    if isinstance(slot, torch.Tensor):
        return (slot.to(device=device, dtype=torch.int32).reshape(-1)
                .expand(b).contiguous())
    return torch.full((b,), int(slot), dtype=torch.int32, device=device)


def fused_decode_step_plain(blocks, x, k_q, k_s, v_q, v_s, q_slot, valid_from,
                            rope_cos_g, rope_sin_g, cfg, slot=None,
                            write_cache: bool = False):
    """Plain torch, with the TPU kernel's numerics (`_kernel`,
    fused_decode.py:70-523) in the mode of `fused_decode_mode`, over all rows
    at once. Attention reads the cache before this step's write, as the TPU
    kernel reads its input block. Arguments and results as
    `fused_decode_step`."""
    if (slot is not None) != write_cache:
        raise ValueError("a write slot goes with write_cache=True")
    mode = fused_decode_mode(blocks, cfg)
    bf = torch.bfloat16
    L, B, S, _ = k_q.shape
    if write_cache:
        # a slot outside [0, S) writes nothing, as in the kernel
        wslot = write_slots(slot, B, x.device).long()
        bidx = torch.arange(B, device=x.device)
        ws = wslot.clamp(0, S - 1)
        ok = ((wslot >= 0) & (wslot < S))[:, None]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g, f = hq // hkv, cfg.intermediate_dim
    sm_scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(S, device=x.device)
    qslot = q_slot.reshape(B).long()
    vfrom = (torch.zeros_like(qslot) if valid_from is None
             else valid_from.reshape(B).long())
    # the cache holds the tokens strictly before the current slot
    live = (kpos[None, :] < qslot[:, None]) & (kpos[None, :] >= vfrom[:, None])
    cos = rope_cos_g.float()[:, None, :]
    sin = rope_sin_g.float()[:, None, :]
    # W8A8 quantizes each f32 row (the TPU kernel's `_qrow`, in `_quant`'s
    # form); the other modes round it to bf16
    if mode == W8A8:
        def norm(t, ln):
            return _quant(_rms_exact(t, ln, cfg.norm_eps))
    else:
        def norm(t, ln):
            return rms_norm(t, ln, cfg.norm_eps).to(bf)
    # W8A8's DOWN phase keeps the TPU kernel's N-phase K-tiles of F
    tk = _pick_tile(f, 512) if mode == W8A8 else None
    xf = x.float()
    new = []
    for l in range(L):
        h = norm(xf, blocks["ln1"][l])
        qkv = _proj(None, h, blocks["wqkv"], l, mode).to(bf).float()
        q = _rope(qkv[:, :hq * hd].reshape(B, hq, hd), cos, sin).to(bf)
        k = _rope(qkv[:, hq * hd:(hq + hkv) * hd].reshape(B, hkv, hd), cos,
                  sin).to(bf).float()
        v = qkv[:, (hq + hkv) * hd:].reshape(B, hkv, hd)
        k8, ks = _quant(k)                          # (B, Hkv, hd), (B, Hkv, 1)
        v8, vs = _quant(v)
        kcur = (k8.float() * ks).to(bf).float()
        vcur = (v8.float() * vs).to(bf).float()

        qg = q.float().reshape(B, hkv, g, hd)
        kc = k_q[l].reshape(B, S, hkv, hd).float()
        vc = v_q[l].reshape(B, S, hkv, hd).float()
        sc = torch.einsum("bhgd,bshd->bhgs", qg, kc)
        sc = sc * (k_s[l][:, :, None, :] * sm_scale)
        sc = sc.masked_fill(~live[:, None, None, :], _NEG_INF)
        s_cur = (qg * kcur[:, :, None, :]).sum(dim=-1, keepdim=True) * sm_scale
        m = torch.maximum(sc.amax(dim=-1, keepdim=True), s_cur)
        p = torch.exp(sc - m)
        p_cur = torch.exp(s_cur - m)
        denom = p.sum(dim=-1, keepdim=True) + p_cur
        pv = torch.einsum("bhgs,bshd->bhgd",
                          _round_pv(p * v_s[l][:, :, None, :]), vc)
        pv = pv + p_cur * vcur[:, :, None, :]
        attn = (pv / denom).reshape(B, hq * hd).to(bf)

        xf = _proj(xf, _quant(attn.float()) if mode == W8A8 else attn,
                   blocks["wo"], l, mode)
        h2 = norm(xf, blocks["ln2"][l])
        gu = _proj(None, h2, blocks["w_gate_up"], l, mode)
        gate = gu[:, :f].to(bf).float()
        up = gu[:, f:].to(bf).float()
        ff = F.silu(gate) * up
        xf = _proj(xf, _quant(ff) if mode == W8A8 else ff.to(bf),
                   blocks["w_down"], l, mode, tk)

        codes = (k8.reshape(B, hkv * hd), ks[..., 0], v8.reshape(B, hkv * hd),
                 vs[..., 0])
        if write_cache:
            # advanced indices around a slice put their axis first: (B, Hkv)
            for vals, scales, (cq, cs) in ((k_q, k_s, codes[:2]),
                                           (v_q, v_s, codes[2:])):
                vals[l][bidx, ws] = torch.where(ok, cq, vals[l][bidx, ws])
                scales[l][bidx, :, ws] = torch.where(
                    ok, cs, scales[l][bidx, :, ws])
        else:
            new.append(codes)
    x_out = xf.to(x.dtype)
    if write_cache:
        return x_out, k_q, k_s, v_q, v_s
    return (x_out, *(torch.stack(t) for t in zip(*new)))


def _launch_grid(device: torch.device, instance: int) -> int:
    """Blocks of one cooperative launch of a kernel instance: a K4 mode,
    or _K8."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if (idx, instance) not in _grid:
        n = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _build.check(_build.lib().pli_fused_decode_grid(
                instance, ctypes.byref(n)), "fused decode (occupancy)")
        _grid[idx, instance] = n.value
    return _grid[idx, instance]


def _workspace(device, L, B, D, F_, QH, KH, HKV, ws_floats) -> dict:
    """The scratch tensors of one launch shape (kept across launches): the
    activation rows, the partials' workspace (`ws_floats` f32), the new K/V
    of a write_cache launch, W8A8's int8 rows (16-byte row pitch: a TMA
    stride), their scales and silu's f32 row, and the kernel's two counters,
    its grid barrier's and its attention items' (zeroed by every launch)."""
    key = (str(device), L, B, D, F_, QH, KH, ws_floats)
    if key not in _workspaces:
        def e(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device=device)

        _workspaces[key] = dict(
            xf=e(B, D, dtype=torch.float32), h=e(B, D), qbuf=e(B, QH),
            attn=e(B, QH), ff=e(B, F_), ws=e(ws_floats, dtype=torch.float32),
            k_new=e(L, B, KH, dtype=torch.int8),
            ks_new=e(L, B, HKV, dtype=torch.float32),
            v_new=e(L, B, KH, dtype=torch.int8),
            vs_new=e(L, B, HKV, dtype=torch.float32),
            # W8A8: the quantized activation rows, a row of scales per
            # quantization point (ln1, attention, ln2, silu) and the silu
            # row's absmax, and silu's f32 (B, F) row
            a8=e(B * -(-max(D, QH, F_) // 16) * 16, dtype=torch.int8),
            asc=e(5, B, dtype=torch.float32),
            ffs=e(B, F_, dtype=torch.float32),
            sync=e(2, dtype=torch.int32))
    return _workspaces[key]


def _shapes(x, cfg) -> dict:
    """(K, N) of each block matrix."""
    D = x.shape[1]
    QH = cfg.num_heads * cfg.head_dim
    QO = QH + 2 * cfg.num_kv_heads * cfg.head_dim
    F_ = cfg.intermediate_dim
    return {"wqkv": (D, QO), "wo": (QH, D), "w_gate_up": (D, 2 * F_),
            "w_down": (F_, D)}


def _weights(blocks, x, L: int, cfg, name: str, mode: int = W8A16):
    """Check the stacked block weights of `mode`, activations and norms the
    kernel takes; returns (wqkv, wo, w_gate_up, w_down). INT8: q (L, K, N),
    s (L, 1, N). INT4: packed q (L, K, N/2) with N/2 a multiple of 16 (a
    TMA stride), s (L, K/G, N) with G = int4_group_size(K, N), a multiple
    of 16 (the consumer's k16 step)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for n, (k, nn) in _shapes(x, cfg).items():
        w = blocks[n]
        if mode == W4A16:
            g = int4_group_size(k, nn)
            want, want_s = (L, k, nn // 2), (L, k // g, nn)
            if nn % 32 or k % g or g % 16:
                raise ValueError(f"{name}: {n} ({k}, {nn}) needs N % 32 == 0 "
                                 "and whole scale groups of 16k rows, k >= 1")
        else:
            want, want_s = (L, k, nn), (L, 1, nn)
        if tuple(w.q.shape) != want or tuple(w.s.shape) != want_s:
            raise ValueError(f"{name}: {n} is {tuple(w.q.shape)} with scales "
                             f"{tuple(w.s.shape)}, expected {want}, {want_s}")
        if w.q.dtype != torch.int8 or w.s.dtype != torch.float32:
            raise TypeError(f"{name} takes int8 (or packed int4) weights, "
                            "f32 scales")
    if hd % 16 or hd > _DMAX or hq % hkv or hq // hkv > _GMAX:
        raise ValueError(f"kernel takes head_dim % 16 == 0, <= {_DMAX} and "
                         f"<= {_GMAX} query heads per kv head")
    if x.shape[1] % 16 or cfg.intermediate_dim % 8:
        raise ValueError("kernel takes hidden_dim % 16 == 0 and "
                         "intermediate_dim % 8 == 0 (16-byte weight rows, "
                         "four-column partial sums)")
    if x.dtype != torch.bfloat16 or blocks["ln1"].dtype != torch.bfloat16 \
            or blocks["ln2"].dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes bf16 activations and norm "
                        "weights")
    ws = tuple(blocks[n] for n in _MATS)
    for t in (x, blocks["ln1"], blocks["ln2"], *(w.q for w in ws),
              *(w.s for w in ws)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors on one device")
    if any(w.q.data_ptr() % 16 for w in ws):
        raise ValueError("int8 weights must be 16-byte aligned")
    return ws


def _scratch(x, L: int, cfg, mode: int, paged: bool = False):
    """(grid, plan, workspace) of one launch. `plan` is what the kernel
    reads for each GEMM phase: `Plan.args()` of its `_plan` (W4A16: over the
    packed bytes). The workspace holds the largest phase's partials: f32
    (W8A16, W4A16) or int32 (W8A8)."""
    B = x.shape[0]
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    grid = _launch_grid(x.device, _K8 if paged else mode)
    shapes = _shapes(x, cfg).values()
    plans = [_plan(B, n // 2, k, grid, SLAB4) if mode == W4A16
             else _plan(B, n, k, grid) for k, n in shapes]
    ws_floats = B * max(pl.partials * n for pl, (_, n) in zip(plans, shapes))
    plan = [v for pl in plans for v in pl.args()]
    D, F_, QH = x.shape[1], cfg.intermediate_dim, cfg.num_heads * hd
    return grid, (ctypes.c_int * 20)(*plan), _workspace(
        x.device, L, B, D, F_, QH, hkv * hd, hkv, ws_floats)


def _new_kv(L: int, B: int, KH: int, hkv: int, device):
    """Fresh (k_new, ks, v_new, vs) buffers of one launch."""
    return (torch.empty((L, B, KH), dtype=torch.int8, device=device),
            torch.empty((L, B, hkv), dtype=torch.float32, device=device),
            torch.empty((L, B, KH), dtype=torch.int8, device=device),
            torch.empty((L, B, hkv), dtype=torch.float32, device=device))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def phase_clock(L: int, mode: int, device) -> torch.Tensor:
    """A zeroed buffer for the phase clock of one launch: 1 + L x phases
    int64 stamps (ns of the device's global timer), the first after the
    initial norm, then one after each phase of each layer (PHASES, or
    PHASES_W8A8 in W8A8). Pass it as `clock=` to `fused_decode_step` or
    `fused_paged_decode_step`; the launch then also ends on a barrier."""
    n = len(PHASES_W8A8 if mode == W8A8 else PHASES)
    return torch.zeros(1 + L * n, dtype=torch.int64, device=device)


def _clock_ptr(clock, L: int, mode: int, x) -> int:
    if clock is None:
        return 0
    n = len(PHASES_W8A8 if mode == W8A8 else PHASES)
    if (clock.dtype != torch.int64 or clock.numel() != 1 + L * n
            or clock.device != x.device or not clock.is_contiguous()):
        raise ValueError(f"the phase clock takes {1 + L * n} int64 stamps "
                         "on the launch's device (phase_clock)")
    return clock.data_ptr()


def fused_decode_step(blocks, x, k_q, k_s, v_q, v_s, q_slot, valid_from,
                      rope_cos_g, rope_sin_g, cfg, slot=None,
                      write_cache: bool = False, clock=None):
    """One decode step over all layers.

    blocks: the stacked block parameters (`wqkv` (L, D, QO), `wo`,
    `w_gate_up`, `w_down`, all QuantizedTensors or all QuantizedTensor4s;
    `ln1`/`ln2` (L, D)); with `cfg.act_quant == "int8"` INT8 stacks run
    W8A8 (`fused_decode_mode`).
    x: (B, D) embedded tokens. k_q/v_q: (L, B, S, Hkv·hd) int8; k_s/v_s:
    (L, B, Hkv, S) f32. q_slot/valid_from: (B,) current slot / first valid
    slot. rope_cos_g/rope_sin_g: (B, hd/2) f32 at each request's position.

    slot + write_cache=True: the new K/V are written IN PLACE, request b's
    at slot[b] of every layer (`slot` a (B,) or 0-d int tensor on the
    device, read by the kernel, or an int; a slot outside [0, S) writes
    nothing), and (x_out, k_q, k_s, v_q, v_s) returned.
    Otherwise (x_out, k_new (L, B, Hkv·hd) int8, ks (L, B, Hkv) f32, v_new,
    vs) for the caller to scatter. `clock` (CUDA only): a `phase_clock`
    buffer the launch fills with its barrier times."""
    global launches, w4a16_launches, w8a8_launches
    if not x.is_cuda:
        return fused_decode_step_plain(blocks, x, k_q, k_s, v_q, v_s, q_slot,
                                       valid_from, rope_cos_g, rope_sin_g,
                                       cfg, slot, write_cache)
    if (slot is not None) != write_cache:
        raise ValueError("a write slot goes with write_cache=True")
    mode = fused_decode_mode(blocks, cfg)
    B, D = x.shape
    L, _, S, KH = k_q.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F_ = cfg.intermediate_dim
    wqkv, wo, wgu, wdn = _weights(blocks, x, L, cfg, "fused_decode_step",
                                  mode)
    if (KH != hkv * hd or k_s.shape != (L, B, hkv, S) or v_q.shape != k_q.shape
            or v_s.shape != k_s.shape or k_q.shape[1] != B
            or rope_cos_g.shape != (B, hd // 2)
            or rope_sin_g.shape != (B, hd // 2)):
        raise ValueError("fused_decode_step: inconsistent cache or rope "
                         "shapes")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8 \
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError("fused_decode_step takes the INT8 cache, f32 scales")
    qslot = q_slot.reshape(B).to(torch.int32).contiguous()
    vfrom = (torch.zeros_like(qslot) if valid_from is None
             else valid_from.reshape(B).to(torch.int32).contiguous())
    cos = rope_cos_g.float().contiguous()
    sin = rope_sin_g.float().contiguous()
    for t in (k_q, k_s, v_q, v_s, cos, sin, qslot, vfrom):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors on one device")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("the int8 cache must be 16-byte aligned")

    grid, plan, w = _scratch(x, L, cfg, mode)
    if write_cache:
        new = (w["k_new"], w["ks_new"], w["v_new"], w["vs_new"])
        wslot = write_slots(slot, B, x.device)
    else:
        new = _new_kv(L, B, KH, hkv, x.device)
        wslot = qslot   # not read: nothing is written
    groups = [int4_group_size(k, n) if mode == W4A16 else 0
              for k, n in _shapes(x, cfg).values()]
    x_out = torch.empty_like(x)
    ptr = [t.data_ptr() for t in (
        x, blocks["ln1"], blocks["ln2"], wqkv.q, wqkv.s, wo.q, wo.s, wgu.q,
        wgu.s, wdn.q, wdn.s, k_q, k_s, v_q, v_s, cos, sin, qslot, vfrom,
        wslot, *new, x_out, w["xf"], w["h"], w["qbuf"], w["attn"], w["ff"],
        w["ws"], w["a8"], w["asc"], w["ffs"], w["sync"])]
    err = _build.lib().pli_fused_decode_step(
        *ptr, _clock_ptr(clock, L, mode, x), ctypes.cast(plan, ctypes.c_void_p),
        L, B, S, D, F_, hq, hkv, hd, int(write_cache), mode, *groups,
        cfg.norm_eps, 1.0 / math.sqrt(hd), grid, _stream(x))
    _build.check(err, "fused_decode_step")
    if mode == W4A16:
        w4a16_launches += 1
    elif mode == W8A8:
        w8a8_launches += 1
    else:
        launches += 1
    if write_cache:
        return x_out, k_q, k_s, v_q, v_s
    return (x_out, *new)


def fused_paged_decode_ok(cfg, B: int, MB: int, BS: int,
                          NB: int | None = None) -> bool:
    """The JAX package's gate for its fused paged kernel (fused_decode.py:
    968-987 with `_paged_rbp`): dense FFN, no activation quantization,
    head_dim and hidden_dim multiples of 128, block size a multiple of 128,
    batch a multiple of 8. Its VMEM ring budget (`_paged_ring_slots`) is TPU
    machinery and is dropped, so MB and NB do not limit the gate."""
    if cfg.num_experts > 0 or cfg.act_quant != "none":
        return False
    if cfg.head_dim % 128 or cfg.hidden_dim % 128:
        return False
    return BS % 128 == 0 and B % 8 == 0


def _gather_pages(kv_pool, kvs_pool, tables, page: int):
    """Each request's blocks of one page (0: K, 1: V) as a slot cache:
    values (L, B, MB·BS, Hkv·hd), scales (L, B, Hkv, MB·BS)."""
    L, _, _, BS, flat = kv_pool.shape
    B, MB = tables.shape
    t = tables.long()
    q = kv_pool.select(2, page)[:, t].reshape(L, B, MB * BS, flat)
    s = kvs_pool.select(2, page)[:, t]                  # (L, B, MB, Hkv, BS)
    s = s.transpose(2, 3).reshape(L, B, s.shape[3], MB * BS)
    return q, s


def _paged_scatter(kv_pool, kvs_pool, tables, lengths, new):
    """Write each layer's new K/V codes (L, B, Hkv·hd) and scales (L, B, Hkv)
    at every request's write position, in place."""
    k_new, ks, v_new, vs = new
    blk, off = write_position(tables, lengths, kv_pool.shape[3])
    for l in range(kv_pool.shape[0]):
        kv_pool[l, blk, 0, off] = k_new[l]
        kv_pool[l, blk, 1, off] = v_new[l]
        # advanced indices around a slice put their axis first: (B, Hkv)
        kvs_pool[l, blk, 0, :, off] = ks[l]
        kvs_pool[l, blk, 1, :, off] = vs[l]


def fused_paged_decode_step_plain(blocks, x, kv_pool, kvs_pool, tables,
                                  lengths, rope_cos_g, rope_sin_g, cfg,
                                  inplace: bool = False):
    """Plain torch: every request's blocks gathered into a slot view, then
    `fused_decode_step_plain` with q_slot = lengths (cut at MB·BS) and
    valid_from = 0, then, with inplace, the codes scattered into the pools.
    Arguments and results as `fused_paged_decode_step`."""
    B, MB = tables.shape
    lens = lengths.reshape(B).long()
    k_q, k_s = _gather_pages(kv_pool, kvs_pool, tables, 0)
    v_q, v_s = _gather_pages(kv_pool, kvs_pool, tables, 1)
    x_out, *new = fused_decode_step_plain(
        blocks, x, k_q, k_s, v_q, v_s, lens.clamp(max=MB * kv_pool.shape[3]),
        None, rope_cos_g, rope_sin_g, cfg)
    if not inplace:
        return (x_out, *new)
    _paged_scatter(kv_pool, kvs_pool, tables, lens, new)
    return (x_out, *new, kv_pool, kvs_pool)


def fused_paged_decode_step(blocks, x, kv_pool, kvs_pool, tables, lengths,
                            rope_cos_g, rope_sin_g, cfg,
                            inplace: bool = False, clock=None):
    """One decode step over all layers, KV in the merged paged INT8 pools.

    blocks, x, rope_cos_g, rope_sin_g: as `fused_decode_step`. kv_pool:
    (L, NB, 2, BS, Hkv·hd) int8, each block's K page at index 0 and V page
    at index 1 of axis 2; kvs_pool: (L, NB, 2, Hkv, BS) f32. tables:
    (B, MB) block ids < NB; lengths: (B,) >= 0 tokens already cached; the
    new token lands at position lengths[b], in block
    tables[b, min(lengths[b] // BS, MB - 1)].

    Returns (x_out, k_new (L, B, Hkv·hd) int8, ks (L, B, Hkv) f32, v_new,
    vs); with inplace=True the new K/V are also written into the pools IN
    PLACE and (…, kv_pool, kvs_pool) appended, as the JAX kernel returns its
    aliased pools. Which of several writes to one block position lands (the
    trash block that inactive rows share) is unspecified. `clock`: as
    `fused_decode_step`'s."""
    global paged_launches
    if not x.is_cuda:
        return fused_paged_decode_step_plain(blocks, x, kv_pool, kvs_pool,
                                             tables, lengths, rope_cos_g,
                                             rope_sin_g, cfg, inplace)
    B, D = x.shape
    L, NB, two, BS, KH = kv_pool.shape
    MB = tables.shape[1]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F_ = cfg.intermediate_dim
    wqkv, wo, wgu, wdn = _weights(blocks, x, L, cfg,
                                  "fused_paged_decode_step")
    if (two != 2 or KH != hkv * hd
            or tuple(kvs_pool.shape) != (L, NB, 2, hkv, BS)
            or tables.shape[0] != B or rope_cos_g.shape != (B, hd // 2)
            or rope_sin_g.shape != (B, hd // 2)):
        raise ValueError("fused_paged_decode_step: inconsistent pool, table "
                         "or rope shapes")
    if kv_pool.dtype != torch.int8 or kvs_pool.dtype != torch.float32:
        raise TypeError("fused_paged_decode_step takes int8 pools, f32 "
                        "scales")
    lens = lengths.reshape(B).to(torch.int32).contiguous()
    tbl = tables.to(torch.int32).contiguous()
    cos = rope_cos_g.float().contiguous()
    sin = rope_sin_g.float().contiguous()
    for t in (kv_pool, kvs_pool, lens, tbl, cos, sin):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors on one device")
    if kv_pool.data_ptr() % 16:
        raise ValueError("the int8 pools must be 16-byte aligned")

    grid, plan, w = _scratch(x, L, cfg, W8A16, paged=True)
    new = _new_kv(L, B, KH, hkv, x.device)
    x_out = torch.empty_like(x)
    ptr = [t.data_ptr() for t in (
        x, blocks["ln1"], blocks["ln2"], wqkv.q, wqkv.s, wo.q, wo.s, wgu.q,
        wgu.s, wdn.q, wdn.s, kv_pool, kvs_pool, cos, sin, lens, tbl, *new,
        x_out, w["xf"], w["h"], w["qbuf"], w["attn"], w["ff"], w["ws"],
        w["sync"])]
    err = _build.lib().pli_fused_paged_decode_step(
        *ptr, _clock_ptr(clock, L, W8A16, x), ctypes.cast(plan, ctypes.c_void_p),
        L, B, NB, MB, BS, D, F_, hq, hkv, hd, int(inplace), cfg.norm_eps,
        1.0 / math.sqrt(hd), grid, _stream(x))
    _build.check(err, "fused_paged_decode_step")
    paged_launches += 1
    if inplace:
        return (x_out, *new, kv_pool, kvs_pool)
    return (x_out, *new)
