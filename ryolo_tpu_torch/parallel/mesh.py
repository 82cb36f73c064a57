"""Data parallelism over ranks (counterpart of ``ryolo_tpu/parallel/mesh.py``:
``make_mesh`` :28, ``replicate`` :52, ``shard_batch`` :57).

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
rows (:func:`shard_batch`).  The ``sp`` axis (image height split across
devices, with the conv halo exchanges that XLA's SPMD partitioner inserts)
is not ported: ROADMAP §A18.

A :class:`Mesh` is one rank's view.  :func:`make_mesh` joins the process
group (from ``torchrun``'s environment, or from an explicit ``rank`` and
``init_method``); :func:`launch` spawns the ranks itself, so that one
command trains as in JAX.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from ryolo_tpu_torch.utils.device import resolve_device

# collectives issued, by what they reduce (the synced BatchNorm's forward
# and backward sums, the loss counts and items, the gradient); the tests
# and chip_smoke.py read them
COLLECTIVES = {"bn": 0, "loss": 0, "grad": 0}

_CURRENT: Optional["Mesh"] = None


@dataclass(frozen=True)
class Mesh:
    """One rank of the ``dp`` ranks of the default process group: its
    index and its device."""

    dp: int
    rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A detached copy of ``t`` summed over the ranks (the losses'
        counts and items)."""
        out = t.detach().clone()
        COLLECTIVES["loss"] += 1
        dist.all_reduce(out)
        return out

    def barrier(self):
        dist.barrier()


def current_mesh() -> Optional[Mesh]:
    """The mesh this process joined with :func:`make_mesh`, if any."""
    return _CURRENT


def make_mesh(dp: int, device: str = "cuda", backend: Optional[str] = None,
              init_method: str = "env://",
              rank: Optional[int] = None) -> Mesh:
    """Join a process group of ``dp`` ranks and return this rank's
    :class:`Mesh`.

    ``rank`` defaults to ``RANK`` of ``torchrun``'s environment (with
    ``init_method="env://"``, ``MASTER_ADDR``/``MASTER_PORT``).  ``device``
    ``cuda`` means ``cuda:LOCAL_RANK`` (the rank itself when ``LOCAL_RANK``
    is unset); an indexed ``cuda:N`` puts every rank on that card, which
    only gloo allows.  ``backend``: NCCL on cards, gloo on the CPU."""
    global _CURRENT
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
    _CURRENT = Mesh(dp, rank, dev)
    return _CURRENT


def close_mesh():
    """Leave the process group joined by :func:`make_mesh`."""
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous rows ``[rank·b, (rank+1)·b)`` of every array
    of a global batch dict (b = B / dp; ``paths`` likewise)."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % mesh.dp:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{mesh.dp} ranks")
        b = n // mesh.dp
        out[k] = v[mesh.rank * b:(mesh.rank + 1) * b]
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


def _rank_main(rank: int, dp: int, init_method: str, backend, device: str,
               target: str, args: tuple):
    import importlib

    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    make_mesh(dp, device=device, backend=backend, init_method=init_method,
              rank=rank)
    try:
        fn(*args)
    finally:
        close_mesh()


def launch(target: str, dp: int, args: tuple = (), device: str = "cuda",
           backend: Optional[str] = None, init_method: Optional[str] = None):
    """Run ``function(*args)`` of ``target = "module:function"`` in ``dp``
    spawned processes, each after joining the group as its rank
    (:func:`make_mesh` with ``device`` and ``backend``; ``init_method``
    defaults to a free localhost port).  An exception in any rank stops
    the others and raises here.  The function is named, not passed: a
    spawned process does not import a package's ``__main__`` under its own
    name, so a function of one would not unpickle there."""
    import torch.multiprocessing as mp

    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    mp.spawn(_rank_main,
             args=(dp, init_method, backend, device, target, args),
             nprocs=dp, join=True)
