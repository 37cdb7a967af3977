"""Device mesh over an initialized torch.distributed world (counterpart:
physics_llm_inference_tpu/parallel/mesh.py).

The JAX package is one SPMD program over a `jax.sharding.Mesh`; the port
runs one process per rank. `make_mesh(data, model, expert)` keeps the JAX
axis order, ('data', 'model') or ('data', 'expert', 'model') with `model`
innermost (rank = (d·E + e)·M + m), and builds one process group for each
axis: the ranks that differ only in that axis. The mesh owns the few
collectives the parallel layer needs, each taking an axis name:
`all_reduce` (lax.psum), `all_gather` tiled on a dim, `all_to_all` tiled as
`lax.all_to_all(..., tiled=True)`, `ring_shift` (ring attention's ppermute)
and `broadcast`.

The backend is the caller's: "nccl" (the default on CUDA) or "gloo" (the
default on the CPU); the mesh never swaps one for the other. Gloo takes only
host tensors for most collectives, so on a gloo mesh a CUDA tensor goes
through pinned host memory and back, in one code path (`transport` says
which), so two ranks can share one card. NCCL with more ranks on a host than
visible GPUs raises here, before NCCL's own "Duplicate GPU" error.
The axis groups wait as long as the world does: `new_group` would give
them torch's default (30 minutes on gloo) where the world has its own.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

AXES = ("data", "expert", "model")


def default_backend(device=None) -> str:
    """nccl where the ranks run on CUDA, gloo on the CPU."""
    if device is not None:
        return "nccl" if torch.device(device).type == "cuda" else "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def rank_device(cpu: bool = False) -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK % device_count}, or the CPU
    when asked for it."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: ask for the CPU to run there")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_nccl_devices(local_ranks: int) -> None:
    """NCCL runs one rank per GPU: refuse more ranks on a host than the
    GPUs it sees (NCCL itself fails later with "Duplicate GPU")."""
    have = torch.cuda.device_count()
    if local_ranks > have:
        raise ValueError(f"nccl needs one GPU per rank: {local_ranks} ranks "
                         f"on this host, {have} visible GPUs; use the gloo "
                         f"backend to share a card")


def group_timeout(group=None):
    """How long a collective of `group` (the world by default) waits for
    its peers: the timeout the group was made with."""
    g = group or dist.distributed_c10d._get_default_group()
    dev = "cuda" if dist.get_backend(g) == "nccl" else "cpu"
    return g._get_backend(torch.device(dev)).options._timeout


def _timed(fn):
    """A collective that adds its seconds to the mesh's comm_s while
    counting is on (Mesh.time_collectives)."""
    def call(self, t, *a, **kw):
        if self.comm_s is None:
            return fn(self, t, *a, **kw)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn(self, t, *a, **kw)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.comm_s += time.perf_counter() - t0
        return out

    call.__doc__, call.__name__ = fn.__doc__, fn.__name__
    return call


class Mesh:
    """This rank's view of a (data[, expert], model) mesh: the axis sizes,
    its coordinate on each axis, one process group per axis, its device
    and the collectives over an axis."""

    def __init__(self, shape: dict, backend: str, device: torch.device):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.backend = backend
        self.device = device
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        # seconds spent in collectives while not None (time_collectives)
        self.comm_s = None
        sizes = list(shape.values())
        # coordinates, model innermost
        rem, coords = self.rank, {}
        for name, n in reversed(list(shape.items())):
            coords[name] = rem % n
            rem //= n
        self.coords = {n: coords[n] for n in self.axis_names}
        # one group per line of each axis; every rank makes every group, in
        # the same order, as new_group requires; each waits as the world does
        self.groups, self.members = {}, {}
        timeout = group_timeout()
        for ai, name in enumerate(self.axis_names):
            stride = 1
            for n in sizes[ai + 1:]:
                stride *= n
            for base in range(self.world):
                if (base // stride) % sizes[ai]:
                    continue
                ranks = [base + i * stride for i in range(sizes[ai])]
                g = dist.new_group(ranks, backend=backend, timeout=timeout)
                if self.rank in ranks:
                    self.groups[name], self.members[name] = g, ranks

    @property
    def transport(self) -> str:
        """How a collective moves this rank's tensors."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo through pinned host memory"
        return f"{self.backend} on {self.device.type}"

    def time_collectives(self, on: bool = True) -> None:
        """Start (from 0) or stop counting the seconds spent in collectives
        into `comm_s`. While on, each collective synchronizes the device
        before it starts, so the count holds the collective's own time and
        not the work queued before it."""
        self.comm_s = 0.0 if on else None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (lax.axis_index)."""
        return self.coords[axis]

    # ------------------------------------------------------- collectives

    def _via_host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    @_timed
    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over `axis` (lax.psum); a new tensor, `t` untouched."""
        if self._via_host(t):
            h = self._host(t)
            dist.all_reduce(h, group=self.groups[axis])
            return h.to(t.device)
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.groups[axis])
        return out

    @_timed
    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's `t` along `axis`, concatenated on `dim` in axis
        order (lax.all_gather(..., axis=dim, tiled=True))."""
        n = self.shape[axis]
        src = self._host(t) if self._via_host(t) else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.groups[axis])
        return torch.cat(parts, dim=dim).to(t.device)

    @_timed
    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True): `t`
        cut into n chunks on split_dim, chunk j sent to axis index j; the
        chunks received, concatenated on concat_dim by source index."""
        n = self.shape[axis]
        if t.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                             f"split {n} ways")
        src = t.movedim(split_dim, 0).contiguous()
        if self._via_host(src):
            src = self._host(src)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.groups[axis])
        # out holds n source chunks along dim 0, each one chunk of t
        chunks = out.to(t.device).chunk(n, dim=0)
        return torch.cat([c.movedim(0, split_dim) for c in chunks],
                         dim=concat_dim)

    @_timed
    def ring_shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Send `t` to the next index on `axis` and receive the previous
        one's (lax.ppermute with perm i -> i + 1)."""
        n, i = self.shape[axis], self.coords[axis]
        if n == 1:
            return t.clone()      # the permutation i -> i + 1 is the identity
        ranks, g = self.members[axis], self.groups[axis]
        src = self._host(t) if self._via_host(t) else t.contiguous()
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(i + 1) % n], g),
               dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device)

    @_timed
    def broadcast(self, t: torch.Tensor, axis: str, src: int = 0
                  ) -> torch.Tensor:
        """Index `src`'s `t` on every rank of `axis`."""
        buf = self._host(t) if self._via_host(t) else t.contiguous().clone()
        dist.broadcast(buf, self.members[axis][src], group=self.groups[axis])
        return buf.to(t.device)


def make_mesh(data: int = 1, model: int = 1, expert: int = 1,
              backend: str | None = None, device=None) -> Mesh:
    """The mesh of this process's rank over the initialized world, whose
    size must be data·expert·model. `backend` defaults to nccl on CUDA and
    gloo on the CPU; `device` to `rank_device()`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/multihost.initialize_multihost, or "
                           "launch with python -m torch.distributed.run)")
    n = data * expert * model
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {data}x{expert}x{model} needs {n} ranks, "
                         f"the world has {world}")
    device = torch.device(device) if device is not None else rank_device()
    backend = backend or default_backend(device)
    if backend == "nccl":
        check_nccl_devices(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    shape = ({"data": data, "expert": expert, "model": model} if expert > 1
             else {"data": data, "model": model})
    return Mesh(shape, backend, device)


def local_mesh_shape(mesh: Mesh) -> dict:
    return dict(mesh.shape)
