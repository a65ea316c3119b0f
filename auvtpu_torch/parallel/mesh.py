"""Process meshes over ``torch.distributed`` and query-batch data
parallelism (counterpart of :mod:`auvtpu.parallel.mesh`).

JAX runs one controller over a device mesh.  The port is SPMD over
processes: every rank calls the same function with the same arguments,
holds only its own band or block, and gets back what the JAX function
returns.  A :class:`Mesh` lays the ranks of the default process group out
as a 1-D ``(n,)`` or 2-D ``(ny, nx)`` grid (row-major, as JAX reshapes its
device list) and carries this rank's device.

The collectives here move bytes and add nothing but :func:`psum`'s sums,
which every rank takes in the same rank order, so all ranks hold the same
bits.  The transport is the process group's: ``gloo`` where ranks share a
card or run on the CPU, ``nccl`` where each rank has its own card.  gloo
takes CUDA tensors for some collectives and refuses them for sends and
receives; with gloo every collective here copies a CUDA tensor to the host
and the result back explicitly (:func:`_wire`), so the fills stay on the
card and only the exchanged strips cross the host.

A mesh of one rank needs no process group: every collective is then the
identity, so the sharded functions run in a single process too.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) where none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def transport() -> str:
    """The default process group's backend ('gloo', 'nccl'), or 'none'
    without one."""
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return "none"


def transport_for(device, local_ranks: int) -> str:
    """The backend for ``local_ranks`` ranks of one machine on ``device``:
    'nccl' where :func:`rank_device` gives each rank a card of its own (a
    bare ``cuda`` device and at least as many cards as ranks), 'gloo' where
    ranks share a card or run on the CPU (NCCL refuses two ranks on one
    card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given, where it names an index or
    the CPU; else (``None`` or ``"cuda"``) ``cuda:{local rank % cards}``, so
    the ranks of a machine with one card all share ``cuda:0``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("rank_device: no CUDA device; pass device='cpu' to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", world()[1]))
    return torch.device("cuda", local % n)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a mesh in row-major order over ``shape``, with axis
    names, this process's rank and device.  ``group`` is the process group
    of the mesh's ranks (None: the default group, or no group at all for a
    one-rank mesh in a single process)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    ranks: tuple[int, ...]
    rank: int
    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's position in the mesh's row-major order."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks}")
        return self.ranks.index(self.rank)

    @property
    def coords(self) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.index, self.shape))

    @property
    def transport(self) -> str:
        return transport() if self.size > 1 else "none"

    def peer(self, name: str, hop: int) -> int | None:
        """Global rank of the member ``hop`` steps along axis ``name`` from
        this rank, None past the mesh's edge."""
        a = self.axis_names.index(name)
        c = list(self.coords)
        c[a] += hop
        if not 0 <= c[a] < self.shape[a]:
            return None
        return self.ranks[int(np.ravel_multi_index(c, self.shape))]


def _mesh(shape, axes, device) -> Mesh:
    """Every rank calls this (a subgroup is made collectively): the mesh of
    the first prod(shape) ranks of the default group."""
    n_world, rank = world()
    n = math.prod(shape)
    if n > n_world:
        raise ValueError(f"a mesh of {n} ranks needs as many processes; the process group has {n_world}")
    if len(axes) != len(shape):
        raise ValueError(f"axis names {axes} for a mesh of shape {shape}")
    group = None
    if 1 < n < n_world:
        group = dist.new_group(list(range(n)))
    return Mesh(tuple(shape), tuple(axes), tuple(range(n)), rank, rank_device(device), group)


def make_mesh(n: int | None = None, axis: str = "dp", *, device=None) -> Mesh:
    """1-D mesh over the first ``n`` ranks (default: all).  Every rank of
    the process group calls it; ranks past ``n`` get a mesh they are not
    members of (``mesh.member`` is False) and must not pass it on."""
    return _mesh((world()[0] if n is None else int(n),), (axis,), device)


def make_mesh2d(shape: tuple[int, int] | None = None, axes=("dy", "dx"), *, device=None) -> Mesh:
    """2-D mesh for block-sharded grids (rows x cols).  Default shape: the
    most-square factorisation of the world size, the tall side on rows
    (bathymetry tiles are usually taller than wide)."""
    if shape is None:
        n = world()[0]
        ny = int(np.sqrt(n))
        while n % ny:
            ny -= 1
        shape = (max(ny, n // ny), min(ny, n // ny))
    return _mesh(tuple(int(s) for s in shape), tuple(axes), device)


# ---------------------------------------------------------------------------
# collectives over a mesh
# ---------------------------------------------------------------------------

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the transport takes it: a contiguous host copy of a CUDA
    tensor under gloo (which refuses CUDA tensors for sends and receives),
    the tensor itself otherwise."""
    if t.is_cuda and mesh.transport == "gloo":
        return t.detach().to("cpu", copy=True)
    return t.contiguous()


def _check_member(mesh: Mesh, what: str) -> None:
    if not mesh.member:
        raise ValueError(f"{what}: rank {mesh.rank} is not in the mesh {mesh.ranks}")


def all_gather(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every member's ``t`` (same shape on all), in mesh order, on ``t``'s
    device."""
    if mesh.size == 1:
        return [t]
    w = _wire(mesh, t)
    out = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(out, w, group=mesh.group)
    return [o.to(t.device) for o in out]


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum of every member's ``t``, added in mesh order on every rank, so
    that all ranks hold the same bits."""
    parts = all_gather(mesh, t)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def broadcast(mesh: Mesh, t: torch.Tensor, src_index: int) -> torch.Tensor:
    """The tensor of mesh member ``src_index`` on every rank (``t`` gives the
    shape and dtype elsewhere), on ``t``'s device."""
    if mesh.size == 1:
        return t
    w = _wire(mesh, t)
    dist.broadcast(w, src=mesh.ranks[src_index], group=mesh.group)
    return w.to(t.device)


def barrier(mesh: Mesh) -> None:
    """Wait until every member has reached this point."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def exchange(mesh: Mesh, sends: list, recvs: list) -> list[torch.Tensor]:
    """Point-to-point exchange in one ``batch_isend_irecv``: ``sends`` are
    (global rank, tensor) pairs, ``recvs`` (global rank, shape-like tensor)
    pairs; returns the received tensors on the devices of the ``recvs``
    tensors.  Every send must be matched by the peer's receive, and a pair
    of ranks exchanges at most one message each way per call."""
    if not sends and not recvs:
        return []
    ops, bufs = [], []
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, _wire(mesh, t), peer, group=mesh.group))
    for peer, like in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if like.is_cuda and mesh.transport == "gloo" else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(like.device) for b, (_, like) in zip(bufs, recvs)]


def replicated(mesh: Mesh, *tensors):
    """Each tensor on the mesh's device with the value of the mesh's first
    rank on every member (the JAX package's replicated placement)."""
    _check_member(mesh, "replicated")
    out = [broadcast(mesh, torch.as_tensor(t).to(mesh.device), 0) for t in tensors]
    return out[0] if len(out) == 1 else out


def shard_queries(mesh: Mesh, *arrays):
    """This rank's share of query arrays split along their leading axis.

    Each array is padded to a multiple of the mesh size with its first
    element (so padded lanes do harmless work) and this rank's contiguous
    slice goes to its device; returns (local arrays, n_valid).
    :func:`gather_queries` puts the answers back together."""
    _check_member(mesh, "shard_queries")
    n, i = mesh.size, mesh.index
    out, n_valid = [], None
    for a in arrays:
        a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        n_valid = a.shape[0]
        pad = (-n_valid) % n
        if pad:
            a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
        per = a.shape[0] // n
        out.append(a[i * per:(i + 1) * per].to(mesh.device))
    return out, n_valid


def gather_queries(mesh: Mesh, local: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The answers of every rank's :func:`shard_queries` share, in query
    order, the padding dropped, on every rank."""
    _check_member(mesh, "gather_queries")
    return torch.cat(all_gather(mesh, local))[:n_valid]
