"""Build and load the port's CUDA kernels.

All `csrc/*.cu` files are compiled by `nvcc` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), placed in
the repository's ignored `build/` directory, and loaded with ctypes. The
library is built at first use and rebuilt when a source is newer than it.
Only the sources in the repository are used; nothing is fetched.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
LIB_PATH = BUILD_DIR / "libpli_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point: a pointer or the stream is c_void_p (a
# plain int would be cut to 32 bits), sizes are c_int.
SIGNATURES = {
    # x, w, scale, out, workspace, M, N, K, splits, k_tiles_per_split,
    # vec_x, vec_w, stream
    "pli_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_q, k_s, v_q, v_s, q_slot, valid_from, out, B, S, Hq, Hkv, d,
    # scale, stream
    "pli_int8_kv_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _F, _P],
    # x, norm_w, lm_q, lm_s, xn scratch, packed scratch, tokens, B, D, V,
    # eps, vec_w, stream
    "pli_lmhead_greedy": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                          _P],
}

_lock = threading.Lock()
_lib = None


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


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/libpli_kernels.so if missing or stale."""
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in CSRC.glob("*.cu"))
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), *sources]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
