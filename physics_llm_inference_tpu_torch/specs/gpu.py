"""GPU spec + detection (the role of physics_llm_inference_tpu/specs/tpu.py
`get_tpu_spec`), and the decode roofline floor of specs/roofline.py.

Values are the published data-sheet numbers of the H100 SXM (dense, no
sparsity) at its full 700 W power limit; a card set below it runs slower
under load. `get_gpu_spec` raises on a card it does not know rather than
guessing (an H100 PCIe or NVL has other bandwidth). `GPUSpec` carries the
fields and properties of the JAX package's `TPUSpec` that the roofline
reads (`peak_flops`, `peak_int8_ops`, `fp32_tflops`, `hbm_bandwidth`,
`ridge_point`), so the JAX roofline functions accept it too, and the
per-SM limits the occupancy model reads (`specs/occupancy.py`: the CUDA
programming guide's table for compute capability 9.0).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUSpec:
    name: str
    bf16_tflops: float   # dense tensor-core bf16
    int8_tops: float     # dense tensor-core int8
    fp32_tflops: float   # f32 outside the tensor cores
    hbm_gbps: float      # GB/s (1e9 bytes/s)
    # per-SM limits of the occupancy model (specs/occupancy.py)
    sm_count: int
    regs_per_sm: int     # 32-bit registers
    smem_per_sm: int     # bytes of shared memory an SM can give its blocks
    smem_per_block: int  # bytes one block may use (dynamic, after opt-in)
    threads_per_sm: int
    blocks_per_sm: int

    @property
    def peak_flops(self) -> float:
        """Peak bf16 FLOP/s."""
        return self.bf16_tflops * 1e12

    @property
    def peak_int8_ops(self) -> float:
        return self.int8_tops * 1e12

    @property
    def hbm_bandwidth(self) -> float:
        """Bytes/s."""
        return self.hbm_gbps * 1e9

    def ridge_point(self, dtype: str = "bf16") -> float:
        """FLOP/byte at which the card goes memory- -> compute-bound."""
        peak = {"bf16": self.peak_flops, "int8": self.peak_int8_ops,
                "fp32": self.fp32_tflops * 1e12}[dtype]
        return peak / self.hbm_bandwidth


H100_SXM = GPUSpec(name="H100 SXM", bf16_tflops=989.0, int8_tops=1979.0,
                   fp32_tflops=67.0, hbm_gbps=3350.0, sm_count=132,
                   regs_per_sm=65536, smem_per_sm=228 * 1024,
                   smem_per_block=227 * 1024, threads_per_sm=2048,
                   blocks_per_sm=32)

# torch.cuda.get_device_name() substrings of the known cards
GPU_SPECS: dict[str, GPUSpec] = {"H100 80GB HBM3": H100_SXM}


def get_gpu_spec(device_name: str | None = None) -> GPUSpec:
    """The spec of `device_name` (default: CUDA device 0's name)."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to detect")
        device_name = torch.cuda.get_device_name(0)
    for key, spec in GPU_SPECS.items():
        if key in device_name:
            return spec
    raise ValueError(f"no spec for GPU {device_name!r}")


def decode_step_floor_s(weight_bytes: int, kv_bytes: int,
                        spec: GPUSpec) -> float:
    """Memory-bound lower bound of one decode step: every weight byte and
    every live KV byte crosses device memory once."""
    return (weight_bytes + kv_bytes) / spec.hbm_bandwidth
