"""GPU spec + detection (the role of physics_llm_inference_tpu/specs/tpu.py
`get_tpu_spec`), and the decode roofline floor of specs/roofline.py.

Values are the published data-sheet numbers of the H100 SXM (dense, no
sparsity) at its full 700 W power limit; a card set below it runs slower
under load. `get_gpu_spec` raises on a card it does not know rather than
guessing (an H100 PCIe or NVL has other bandwidth).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUSpec:
    name: str
    bf16_tflops: float
    hbm_gbps: float      # GB/s (1e9 bytes/s)

    @property
    def peak_flops(self) -> float:
        return self.bf16_tflops * 1e12

    @property
    def hbm_bandwidth(self) -> float:
        """Bytes/s."""
        return self.hbm_gbps * 1e9


H100_SXM = GPUSpec(name="H100 SXM", bf16_tflops=989.0, hbm_gbps=3350.0)

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
