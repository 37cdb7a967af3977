"""Collective cost models over NVLink and PCIe/network links (counterpart:
physics_llm_inference_tpu/specs/ici.py).

The byte formulas are the ring algorithms' (all-reduce sends 2·D·(N-1)/N
bytes a device); the link constants are NVIDIA's published H100 SXM
figures beside specs/gpu.py's: NVLink 4 at 900 GB/s a GPU (both directions
together, 450 GB/s each way, through NVSwitch to every peer), PCIe Gen5
x16 at 128 GB/s (64 GB/s each way), and a 400 Gb/s network port (50 GB/s
each way). The latencies are orders of magnitude, not data-sheet figures.
Nothing here is a measurement: parallel/ and bench/scaling.py measure.
"""
from __future__ import annotations

from dataclasses import dataclass

from .gpu import H100_SXM, GPUSpec

# data sheet: both directions together
NVLINK_GBPS = 900.0
PCIE_GBPS = 128.0
NETWORK_GBPS = 100.0          # a 400 Gb/s port, both directions
# orders of magnitude of one hop's latency (assumed, not data-sheet)
NVLINK_LATENCY_S = 2e-6
NETWORK_LATENCY_S = 10e-6


def all_reduce_bytes(data_bytes: int, num_devices: int) -> float:
    """Bytes each device sends for a ring all-reduce: 2·D·(N-1)/N."""
    if num_devices <= 1:
        return 0.0
    return 2.0 * data_bytes * (num_devices - 1) / num_devices


def all_gather_bytes(data_bytes: int, num_devices: int) -> float:
    """Bytes each device sends to all-gather D bytes a device."""
    if num_devices <= 1:
        return 0.0
    return data_bytes * (num_devices - 1) / num_devices


def reduce_scatter_bytes(data_bytes: int, num_devices: int) -> float:
    if num_devices <= 1:
        return 0.0
    return data_bytes * (num_devices - 1) / num_devices


def all_to_all_bytes(data_bytes: int, num_devices: int) -> float:
    """Bytes each device sends in an all-to-all of D bytes a device (the
    MoE dispatch)."""
    if num_devices <= 1:
        return 0.0
    return data_bytes * (num_devices - 1) / num_devices


def ring_all_reduce_time(data_bytes: int, num_devices: int,
                         link_bandwidth: float,
                         latency: float = NVLINK_LATENCY_S) -> float:
    """Ring all-reduce wall time: 2(N-1) steps of (latency + D/(N·BW)),
    BW in bytes/s one way."""
    if num_devices <= 1:
        return 0.0
    steps = 2 * (num_devices - 1)
    per_step = latency + data_bytes / (num_devices * link_bandwidth)
    return steps * per_step


def overlap_potential(compute_time: float, comm_time: float) -> float:
    """Fraction of the communication hideable under compute: 1.0 fully
    hidden, 0.0 fully exposed."""
    if comm_time <= 0:
        return 1.0
    return min(compute_time, comm_time) / comm_time


@dataclass
class CollectiveCostModel:
    """Predicted collective times among `spec` GPUs: NVLink inside a node
    (through NVSwitch a device sends at the full one-way rate), the network
    across nodes, or PCIe where `pcie` is set (cards without NVLink)."""

    spec: GPUSpec = H100_SXM
    nvlink_gbps: float = NVLINK_GBPS
    network_gbps: float = NETWORK_GBPS
    pcie: bool = False

    def _bw(self, over_network: bool) -> float:
        """One-way bytes/s a device sends."""
        if over_network:
            return self.network_gbps / 2 * 1e9
        return (PCIE_GBPS if self.pcie else self.nvlink_gbps) / 2 * 1e9

    def _lat(self, over_network: bool) -> float:
        return NETWORK_LATENCY_S if over_network else NVLINK_LATENCY_S

    def all_reduce_time(self, data_bytes: int, n: int,
                        over_network: bool = False) -> float:
        return ring_all_reduce_time(data_bytes, n, self._bw(over_network),
                                    self._lat(over_network))

    def all_gather_time(self, data_bytes: int, n: int,
                        over_network: bool = False) -> float:
        if n <= 1:
            return 0.0
        return (n - 1) * (self._lat(over_network)
                          + data_bytes / (n * self._bw(over_network)))

    def all_to_all_time(self, data_bytes: int, n: int,
                        over_network: bool = False) -> float:
        if n <= 1:
            return 0.0
        return (self._lat(over_network) * (n - 1)
                + all_to_all_bytes(data_bytes, n) / self._bw(over_network))

    def tp_layer_comm_time(self, hidden: int, batch_tokens: int, n: int,
                           dtype_bytes: int = 2) -> float:
        """A block's TP cost: two all-reduces of the activations (after wo
        and after the down projection)."""
        return 2 * self.all_reduce_time(batch_tokens * hidden * dtype_bytes,
                                        n)

    def scaling_efficiency(self, compute_time: float, data_bytes: int,
                           n: int, over_network: bool = False,
                           overlapped: bool = True) -> float:
        """Predicted efficiency of a step spread over n devices."""
        comm = self.all_reduce_time(data_bytes, n, over_network)
        exposed = max(0.0, comm - compute_time) if overlapped else comm
        return (compute_time / (compute_time + exposed)
                if compute_time > 0 else 0.0)
