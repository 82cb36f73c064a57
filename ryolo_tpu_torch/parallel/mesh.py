"""Data parallelism and spatial sharding over ranks (counterpart of
``ryolo_tpu/parallel/mesh.py``: ``make_mesh`` :28, ``replicate`` :52,
``shard_batch`` :57).

The JAX package is single-controller: one process jits the step over a
batch sharded along the mesh's ``dp`` axis, and XLA inserts the gradient
all-reduce.  Here each of the ``dp`` ranks is a process of its own, on
``cuda:LOCAL_RANK`` (NCCL) or on the CPU (gloo), and the step reproduces
the single-controller semantics by hand: BatchNorm statistics over the
global batch (:mod:`ryolo_tpu_torch.parallel.sync_bn`), every loss mean
over the global count (the loss functions' ``reducer``), and one sum of
the ranks' gradients per optimizer update
(:func:`all_reduce_grads`).  So ``--dp N`` at global batch B computes what
one process computes at B, up to float32 reassociation.

``batch_sharding`` and ``target_sharding`` have no counterpart: they name
how one process's arrays lie across devices, and a rank holds only its own
rows (:func:`shard_batch`).

The ``sp`` axis splits each image's height over ``sp`` ranks (JAX's
``P("dp", "sp", None, None)``, where XLA's SPMD partitioner inserts the
conv halo exchanges).  The ``dp`` ranks form a ``(dp // sp, sp)`` grid as
JAX's reshape does: rank r is sp index ``r % sp`` of group ``r // sp``.
The batch splits over the groups, each group's ``sp`` ranks hold the same
images and split their rows (:mod:`ryolo_tpu_torch.parallel.spatial`:
the row split, the halo exchange of every conv and pool, the head maps
gathered before the loss).  So every rank of a group computes the same
loss of the group's images: the loss counts and items sum over the groups
(:meth:`Mesh.sum`, over the ranks of one sp index), and the gradients over
all ranks, each rank back-propagating through its own rows.

A :class:`Mesh` is one rank's view.  :func:`make_mesh` joins the process
group (from ``torchrun``'s environment, or from an explicit ``rank`` and
``init_method``); :func:`launch` spawns the ranks itself, so that one
command trains as in JAX.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from ryolo_tpu_torch.utils import trace
from ryolo_tpu_torch.utils.device import resolve_device

# collectives issued, by what they reduce (the synced BatchNorm's forward
# and backward sums, the loss counts and items, the gradient; under sp the
# halo exchanges' forward gathers and backward sums, and the head maps' row
# gathers); the tests and chip_smoke.py read them, and the ``collective``
# counters of :mod:`ryolo_tpu_torch.utils.trace` are this dict
COLLECTIVES = trace.group("collective", {"bn": 0, "loss": 0, "grad": 0,
                                        "halo": 0, "rows": 0})

_CURRENT: Optional["Mesh"] = None


@dataclass(frozen=True)
class Mesh:
    """One rank of the ``dp`` ranks of the default process group: its
    index, its device, and its place in the ``(dp // sp, sp)`` grid with
    the process groups of its row (``sp_group``, the ranks that split the
    same images) and of its column (``dp_group``, one rank of each group;
    ``None``, the whole group, without ``sp``)."""

    dp: int
    rank: int
    device: torch.device
    sp: int = 1
    sp_group: Optional[object] = field(default=None, compare=False)
    dp_group: Optional[object] = field(default=None, compare=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def groups(self) -> int:
        """The number of groups the batch splits over (JAX's ``dp`` axis)."""
        return self.dp // self.sp

    @property
    def group(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A detached copy of ``t`` summed over the groups, one rank of each
        (the losses' counts and items; the ``sp`` ranks of a group hold the
        same ones)."""
        out = t.detach().clone()
        COLLECTIVES["loss"] += 1
        dist.all_reduce(out, group=self.dp_group)
        return out

    def barrier(self):
        dist.barrier()


def current_mesh() -> Optional[Mesh]:
    """The mesh this process joined with :func:`make_mesh`, if any."""
    return _CURRENT


def make_mesh(dp: int, sp: int = 1, device: str = "cuda",
              backend: Optional[str] = None, init_method: str = "env://",
              rank: Optional[int] = None) -> Mesh:
    """Join a process group of ``dp`` ranks, ``sp`` of them splitting each
    image's height (``dp % sp == 0``, as JAX asserts), and return this
    rank's :class:`Mesh`.

    ``rank`` defaults to ``RANK`` of ``torchrun``'s environment (with
    ``init_method="env://"``, ``MASTER_ADDR``/``MASTER_PORT``).  ``device``
    ``cuda`` means ``cuda:LOCAL_RANK`` (the rank itself when ``LOCAL_RANK``
    is unset); an indexed ``cuda:N`` puts every rank on that card, which
    only gloo allows.  ``backend``: NCCL on cards, gloo on the CPU."""
    global _CURRENT
    if sp < 1 or dp % sp:
        raise ValueError(f"dp {dp} not divisible by sp {sp}")
    if rank is None:
        rank = int(os.environ["RANK"])
        if int(os.environ.get("WORLD_SIZE", dp)) != dp:
            raise ValueError(f"dp {dp} but WORLD_SIZE "
                             f"{os.environ['WORLD_SIZE']}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank} of {dp}: {dev} on a machine with "
                           f"{torch.cuda.device_count()} card(s)")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=dp, rank=rank)
    if dist.get_world_size() != dp or dist.get_rank() != rank:
        raise ValueError(f"process group of {dist.get_world_size()} ranks "
                         f"(this one {dist.get_rank()}), asked for rank "
                         f"{rank} of {dp}")
    sp_group = dp_group = None
    if sp > 1:
        # every rank creates every group, in the same order
        for g in range(dp // sp):
            pg = dist.new_group(list(range(g * sp, (g + 1) * sp)))
            if g == rank // sp:
                sp_group = pg
        for i in range(sp):
            pg = dist.new_group(list(range(i, dp, sp)))
            if i == rank % sp:
                dp_group = pg
    _CURRENT = Mesh(dp, rank, dev, sp, sp_group, dp_group)
    return _CURRENT


def close_mesh():
    """Leave the process group joined by :func:`make_mesh`."""
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's group's contiguous rows ``[g·b, (g+1)·b)`` of every
    array of a global batch dict (b = B / groups; ``paths`` likewise): the
    images whole, the height split later
    (:func:`ryolo_tpu_torch.parallel.spatial.spatial_forward`)."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % mesh.groups:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{mesh.groups} groups")
        b = n // mesh.groups
        out[k] = v[mesh.group * b:(mesh.group + 1) * b]
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, in
    place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: Mesh):
    """Sum every parameter's ``.grad`` over the ranks, in one all-reduce of
    one flat float32 buffer (a missing gradient counts as zeros)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    COLLECTIVES["grad"] += 1
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, dp: int, sp: int, init_method: str, backend,
               device: str, target: str, args: tuple):
    import importlib

    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    make_mesh(dp, sp, device=device, backend=backend,
              init_method=init_method, rank=rank)
    try:
        fn(*args)
    finally:
        close_mesh()


def launch(target: str, dp: int, args: tuple = (), device: str = "cuda",
           backend: Optional[str] = None, init_method: Optional[str] = None,
           sp: int = 1):
    """Run ``function(*args)`` of ``target = "module:function"`` in ``dp``
    spawned processes, each after joining the group as its rank
    (:func:`make_mesh` with ``sp``, ``device`` and ``backend``; ``init_method``
    defaults to a free localhost port).  An exception in any rank stops
    the others and raises here.  The function is named, not passed: a
    spawned process does not import a package's ``__main__`` under its own
    name, so a function of one would not unpickle there."""
    import torch.multiprocessing as mp

    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    if dp % sp:
        raise ValueError(f"dp {dp} not divisible by sp {sp}")
    mp.spawn(_rank_main,
             args=(dp, sp, init_method, backend, device, target, args),
             nprocs=dp, join=True)
