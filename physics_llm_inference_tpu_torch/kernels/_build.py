"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), placed in the
repository's ignored `build/` directory, and loaded with ctypes. The
library is built at first use and rebuilt when a source is newer than it.
Only the sources in the repository are used; nothing is fetched.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
LIB_PATH = BUILD_DIR / "libpli_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry point: a pointer or the stream is c_void_p (a
# plain int would be cut to 32 bits), sizes are c_int.
SIGNATURES = {
    # x, w, scale, out, workspace, M, N, K, then the stream route's plan
    # (most partials, tiles, blocks, k-tiles a slab, slabs), stream
    "pli_int8_matmul_stream": [_P] * 5 + [_I] * 8 + [_P],
    # x, w, scale, out, workspace, M, N, K, x rows a block (128 or 256), K
    # splits, stream
    "pli_int8_matmul_wgmma": [_P] * 5 + [_I] * 5 + [_P],
    # q, k_q, k_s, v_q, v_s, q_slot, valid_from, out, B, S, Hq, Hkv, d,
    # scale, stream
    "pli_int8_kv_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _F, _P],
    # x, norm_w, lm_q, lm_s, xn scratch, partials scratch, packed scratch,
    # tokens, B, D, D padded, V, V padded, eps, the stream plan (5 ints),
    # stream
    "pli_lmhead_greedy": [_P] * 8 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # q, k, v, out, q_offset, valid_from, B, Hq, Hkv, Sq, Sk, d, kv_len,
    # causal, the (b, h, s) element strides of q, k and v, scale * log2(e),
    # stream
    "pli_flash_attention": [_P] * 6 + [_I] * 8 + [_L] * 9 + [_F, _P],
    # instance (0-2: K4 in the modes W8A16, W4A16, W8A8; 3: K8), out:
    # blocks of one cooperative launch
    "pli_fused_decode_grid": [_I, _P],
    # x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, k_q, k_s, v_q,
    # v_s, cos, sin, q_slot, valid_from, the write slots (device, (B,)),
    # k_new, ks_new, v_new, vs_new, x_out, then the workspaces xf, h, qbuf,
    # attn, ff, ws, a8, asc, ffs, the grid barrier's counter, the phase clock
    # (null: off), the plan (host: four GEMM phases x 5 ints); L, B, S, D, F,
    # Hq, Hkv, hd, write_cache, mode, the four INT4 group sizes; eps, scale;
    # grid, stream
    "pli_fused_decode_step": [_P] * 37 + [_I] * 14 + [_F, _F, _I, _P],
    # x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, kv, kvs, cos,
    # sin, lengths, tables, k_new, ks_new, v_new, vs_new, x_out, then the
    # workspaces xf, h, qbuf, attn, ff, ws, the counter, the phase clock, the
    # plan; L, B, NB, MB, BS, D, F, Hq, Hkv, hd, inplace; eps, scale; grid,
    # stream
    "pli_fused_paged_decode_step": [_P] * 31 + [_I] * 11 + [_F, _F, _I, _P],
    # q, kv (k), kvs (v), tables, lens, out, B, MB, BS, Hq, Hkv, d, scale,
    # stream
    "pli_int8_paged_decode_attention": [_P] * 6 + [_I] * 6 + [_F, _P],
    "pli_paged_decode_attention": [_P] * 6 + [_I] * 6 + [_F, _P],
    # out: threads, bytes of dynamic shared memory and the runtime's
    # resident blocks an SM of K5's (head_dim 128) and K7's block
    "pli_flash_attention_block": [_P, _P, _P],
    "pli_paged_decode_attention_block": [_P, _P, _P],
    # x, the first stack and its scales, the second stack and its scales,
    # out, workspace, E, C, K, N, stacks, the stream plan (5 ints), stream
    "pli_moe_expert_stream": [_P] * 7 + [_I] * 10 + [_P],
    # a, b, c, M, N, K, route (0 f32, 1 bf16 WMMA, 2 bf16 wgmma + TMA),
    # out_bf16, vec_a, vec_b, stream
    "pli_tiled_matmul": [_P] * 3 + [_I] * 7 + [_P],
    # x, out, num_blocks, block_bytes, stride, vec, stream
    "pli_row_block_copy": [_P, _P, _L, _L, _L, _I, _P],
    # a, b, out, n, dtype (0 f32, 1 bf16), vec, stream
    "pli_vector_add": [_P, _P, _P, _L, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
load_s = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir()
               if p.suffix in (".cu", ".cuh"))


def build(ptxas: dict | None = None) -> Path:
    """Compile csrc/*.cu into build/libpli_kernels.so if missing or stale:
    one nvcc per source, all in parallel, then one link. With `ptxas`,
    each source's ptxas report (registers, spills) is put into it."""
    if not _stale():
        return LIB_PATH
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS if ptxas is None else ["-Xptxas=-v", *NVCC_FLAGS]
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = obj_dir / f"{src.stem}.o"
        cmd = [nvcc, *flags, f"-I{CSRC}", "-c", "-o", str(obj), str(src)]
        jobs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{err}")
        elif ptxas is not None:
            ptxas[name] = err
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *(str(obj) for _, obj, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB_PATH)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; `load_s` counts the
    seconds building and loading it took)."""
    global _lib, load_s
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
            load_s = time.perf_counter() - t0
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def block_shape(entry: str) -> tuple[int, int, int]:
    """(threads, bytes of dynamic shared memory, the CUDA runtime's resident
    blocks an SM) of a kernel's block, from the library's `<entry>_block`
    query."""
    out = [ctypes.c_int() for _ in range(3)]
    check(getattr(lib(), f"{entry}_block")(*map(ctypes.addressof, out)),
          entry)
    return tuple(v.value for v in out)
