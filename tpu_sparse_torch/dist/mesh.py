"""The row mesh: one process per device, joined by ``torch.distributed``.

Counterpart of ``tpu_sparse/dist/mesh.py``. JAX runs one controller over a
1-D ``jax.sharding.Mesh`` and lets XLA insert the collectives; PyTorch has
no such partitioner, so the port runs one process per card (NCCL) or per
CPU rank (gloo) and calls the collectives itself. ``RowMesh`` takes the
place of the mesh: the process group, this process's rank and the world
size, and the device its tensors live on.

``row_sharding`` / ``replicated`` (JAX's ``NamedSharding`` helpers) have no
tensor counterpart here: a tensor lives whole on its process's device. The
functions of ``dist.partition`` take their role: a row-sharded operand is
the rank's own rows (``shard_dia``, ``shard_vector``, ``shard_general``),
and ``gather_vector`` assembles the whole vector again.

Every collective of the distributed layer goes through the methods below,
which refuse a tensor on another device type than the mesh's (a CUDA
tensor on a gloo group, a CPU tensor on an NCCL group: no backend or
device fallback) and count what they move in ``comm_model``'s recorder.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_sparse_torch.dist import comm_model

# all_gather_into_tensor was renamed all_gather_single; same signature
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA row mesh needs a CUDA device; pass device='cpu' "
                "for a gloo mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported mesh device {device}")
    return device


class RowMesh:
    """A 1-D row partition over a process group (see the module
    docstring). Rank r owns the r-th contiguous run of rows."""

    def __init__(self, group, rank: int, world_size: int,
                 device: torch.device):
        self.group = group
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = device

    # -- identity ------------------------------------------------------
    def _key(self) -> tuple:
        return (id(self.group), self.rank, self.world_size, str(self.device))

    def __eq__(self, other) -> bool:
        return isinstance(other, RowMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"RowMesh(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device})")

    def peer(self, r: int) -> int:
        """The global rank of group rank ``r`` (P2P ops take global
        ranks)."""
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def check(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            if t.device.type != self.device.type:
                raise ValueError(
                    f"a {t.device.type} tensor on a row mesh of "
                    f"{self.device.type} tensors "
                    f"({dist.get_backend(self.group)}): no backend or "
                    f"device fallback")

    # -- collectives -----------------------------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place on a fresh contiguous
        tensor (0-d, (k,) or (k, k)); identical on every rank."""
        self.check(t)
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        comm_model.record("all-reduce", t.numel() * t.element_size())
        return t

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-sized row blocks, concatenated along rows."""
        self.check(x)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * self.world_size,)
                          + tuple(x.shape[1:]))
        _all_gather(out, x, group=self.group)
        comm_model.record("all-gather", out.numel() * out.element_size())
        return out

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]],
                 hops: Sequence[Tuple[int, int]]) -> None:
        """One batch of point-to-point copies: each (tensor, rank) of
        ``sends`` goes to that group rank, each of ``recvs`` is filled from
        it. ``hops`` lists (shift, bytes) of every permute the batch makes
        for the whole ring, counted once each when some pair of ranks is
        that far apart (what a collective-permute of that shift moves per
        rank)."""
        self.check(*(t for t, _ in sends), *(t for t, _ in recvs))
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.peer(r),
                          self.group) for t, r in sends]
        ops += [dist.P2POp(dist.irecv, t, self.peer(r), self.group)
                for t, r in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for shift, nbytes in hops:
            if 0 < shift < self.world_size:
                comm_model.record("collective-permute", nbytes)


def make_row_mesh(device="cuda", group=None) -> RowMesh:
    """The row mesh of the initialised process group (``group`` or the
    world). ``device="cuda"`` (the default) takes this process's current
    card and needs an NCCL group; ``device="cpu"`` a gloo group. A CUDA
    request without a card raises."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_multihost() (or "
            "torch.distributed.init_process_group) first")
    device = _device(device)
    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if device.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(
            f"a {device.type} row mesh needs a {want} group, got "
            f"{backend!r}: no backend fallback")
    return RowMesh(group, dist.get_rank(group), dist.get_world_size(group),
                   device)


def initialize_multihost(device="cuda", timeout_s: float = 600.0,
                         **kwargs) -> None:
    """Join the process group: NCCL for a CUDA mesh (after
    ``torch.cuda.set_device(LOCAL_RANK)``), gloo for ``device="cpu"``.
    ``init_method`` defaults to ``env://`` (the variables ``torchrun``
    sets); other keywords go to ``init_process_group``. A no-op when a
    group is already up."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost(device='cuda') needs a "
                               "CUDA device")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


__all__: List[str] = ["RowMesh", "make_row_mesh", "initialize_multihost"]
