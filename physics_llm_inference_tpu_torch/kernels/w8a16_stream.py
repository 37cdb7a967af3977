"""The host plan of the int8 weight stream (`csrc/w8a16_stream.cuh`), shared
by the fused decode kernels (K4, K8: one plan a GEMM phase), K1's stream
route and K3's head: a GEMM's (m-block, slab, k-tile) units split evenly
over the blocks of one launch (stream-K)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

# the stream's k-tile, slab (weight bytes of a row a unit: 256 int8 columns,
# or 128 packed INT4 bytes) and m-block (w8s::)
KT, SLAB, SLAB4, MT = 64, 256, 128, 64


@dataclass(frozen=True)
class Plan:
    """One GEMM phase split over the grid, as `csrc/w8a16_stream.cuh` walks
    it: `tiles` (m-block, slab, k-tile) units, m-block-major with the k-tile
    innermost; block b of `blocks` takes units [first(b), first(b + 1)); a
    block's run of k-tiles within one slab is one partial, stored at index
    b - owner(the slab's first unit). The kernel gets `partials` too, sizes
    nothing by its own copy of the split, and traps on an index at or past
    it."""
    tiles: int
    blocks: int
    ktn: int        # k-tiles a slab
    slabs: int      # slabs an m-block
    partials: int   # the most partials of one output column

    def first(self, b: int) -> int:
        return b * self.tiles // self.blocks

    def owner(self, t: int) -> int:
        return ((t + 1) * self.blocks - 1) // self.tiles

    def units(self, b: int) -> list[tuple[int, int, int, int, int]]:
        """Block b's share: (m-block, slab, first k-tile, end k-tile,
        partial index) runs."""
        out, t, end = [], self.first(b), self.first(b + 1)
        while t < end:
            u, k0 = divmod(t, self.ktn)
            k1 = min(self.ktn, k0 + end - t)
            out.append((u // self.slabs, u % self.slabs, k0, k1,
                        b - self.owner(u * self.ktn)))
            t += k1 - k0
        return out

    def args(self) -> tuple[int, int, int, int, int]:
        """The five ints the kernel reads for this phase."""
        return self.partials, self.tiles, self.blocks, self.ktn, self.slabs


@lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, grid: int, slab: int = SLAB) -> Plan:
    """The stream-K plan of one GEMM phase, x (m, k) @ w (k, n) with rows
    of n weight bytes (W4A16: the packed n = N/2 and slab = SLAB4), over
    `grid` blocks: (m-block, slab, k-tile) units of MT rows, `slab` bytes
    and KT rows of K, split as evenly as whole units allow, so no phase
    runs a second partial wave and every block's share is within one k-tile
    of the mean."""
    ktn, slabs = -(-k // KT), -(-n // slab)
    tiles = -(-m // MT) * slabs * ktn
    blocks = min(grid, tiles)
    if tiles * blocks >= 1 << 32:
        raise ValueError(f"a GEMM phase of {tiles} units over {blocks} blocks "
                         "is past the kernel's 32-bit plan arithmetic")
    pl = Plan(tiles, blocks, ktn, slabs, 0)
    most = max(pl.owner((u + 1) * ktn - 1) - pl.owner(u * ktn) + 1
               for u in range(tiles // ktn))
    return Plan(tiles, blocks, ktn, slabs, most)
