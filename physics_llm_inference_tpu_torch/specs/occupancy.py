"""Occupancy model for CUDA kernel launches: how many blocks of one kernel
an SM holds at once, and which resource stops the next one.

The Hopper counterpart of physics_llm_inference_tpu/specs/vmem.py, which
calls itself the TPU analogue of the reference's GPU occupancy model
(`theoretical_occupancy` over threads, registers and shared memory). A
block takes its threads (whole warps), its registers and its shared
memory from the SM; the SM holds as many blocks as the scarcest of the
four limits allows (threads, registers, shared memory, and the cap on
resident blocks). The reference's model itself is not in this
repository; the allocation rules here are the CUDA occupancy calculator's
for compute capability 9.0 (chip_smoke.py phase 5e holds the model to the
CUDA runtime's own count for K5's and K7's launches):
- registers go to a warp in units of REG_ALLOC_UNIT = 256, so a thread's
  count is rounded up to a multiple of 8 (256 / 32 threads);
- shared memory goes to a block in units of SMEM_ALLOC_UNIT = 128 bytes,
  plus SMEM_RESERVED = 1 KB the runtime keeps for each block.
The model sees only the launch's numbers: ptxas's registers a thread
(`nvcc -Xptxas -v`), the block's threads, and its static plus dynamic
shared memory. `setmaxnreg` (a warpgroup raising or lowering its own
registers after launch) is not modelled: the launch is admitted on the
count ptxas reports.
"""
from __future__ import annotations

from .gpu import H100_SXM, GPUSpec

WARP = 32
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_BLOCK = 1024
REG_ALLOC_UNIT = 256
SMEM_ALLOC_UNIT = 128
SMEM_RESERVED = 1024

# the order in which a tie between limits is named
LIMITS = ("blocks", "threads", "registers", "shared_memory")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _block_limits(threads: int, regs_per_thread: int, smem_bytes: int,
                  spec: GPUSpec = H100_SXM) -> dict:
    """Blocks an SM could hold by each resource alone. Raises ValueError on
    a launch the card refuses (too many threads, registers or bytes of
    shared memory for one block)."""
    if not 0 < threads <= MAX_THREADS_PER_BLOCK:
        raise ValueError(f"{threads} threads: a block takes 1 to "
                         f"{MAX_THREADS_PER_BLOCK}")
    if not 0 <= regs_per_thread <= MAX_REGS_PER_THREAD:
        raise ValueError(f"{regs_per_thread} registers a thread: at most "
                         f"{MAX_REGS_PER_THREAD}")
    if not 0 <= smem_bytes <= spec.smem_per_block:
        raise ValueError(f"{smem_bytes} bytes of shared memory: a block "
                         f"takes at most {spec.smem_per_block}")
    warps = -(-threads // WARP)
    regs_per_warp = _round_up(regs_per_thread * WARP, REG_ALLOC_UNIT)
    if regs_per_warp * warps > spec.regs_per_sm:
        raise ValueError(f"{regs_per_warp * warps} registers a block: an SM "
                         f"has {spec.regs_per_sm}")
    smem = _round_up(smem_bytes, SMEM_ALLOC_UNIT) + SMEM_RESERVED
    return {
        "blocks": spec.blocks_per_sm,
        "threads": spec.threads_per_sm // (warps * WARP),
        "registers": (spec.regs_per_sm // regs_per_warp // warps
                      if regs_per_warp else spec.blocks_per_sm),
        "shared_memory": spec.smem_per_sm // smem,
    }


def max_resident_blocks(threads: int, regs_per_thread: int, smem_bytes: int,
                        spec: GPUSpec = H100_SXM) -> tuple[int, str]:
    """(blocks of this launch resident on one SM, the limit that binds)."""
    lim = _block_limits(threads, regs_per_thread, smem_bytes, spec)
    blocks = min(lim.values())
    return blocks, next(k for k in LIMITS if lim[k] == blocks)


def occupancy(threads: int, regs_per_thread: int, smem_bytes: int,
              spec: GPUSpec = H100_SXM) -> dict:
    """Theoretical occupancy of one launch: resident blocks and warps an SM,
    the fraction of the SM's warp slots they fill, the binding limit and
    every limit's block count."""
    lim = _block_limits(threads, regs_per_thread, smem_bytes, spec)
    blocks, binding = max_resident_blocks(threads, regs_per_thread,
                                          smem_bytes, spec)
    warps = blocks * -(-threads // WARP)
    return {"blocks_per_sm": blocks, "warps_per_sm": warps,
            "occupancy": warps / (spec.threads_per_sm // WARP),
            "limit": binding, "limits": lim}
