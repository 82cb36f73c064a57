"""Spatial sharding (``train --dp N --sp S``): each image's height split
over the ``sp`` ranks of a group, with a halo exchange before every conv
and pool whose window crosses the split (JAX ``make_mesh(n, sp)``,
``ryolo_tpu/parallel/mesh.py:28-36``, ``batch_sharding`` :39, where XLA's
SPMD partitioner inserts the exchanges).

* **The row split** (:func:`row_split`).  The ``h // 32`` stride-32 rows
  split as evenly as possible, the remainder to the first ranks, and every
  level takes the same split scaled by its stride: at 800 px over 2 ranks
  13 + 12 rows at stride 32, 26 + 24 at 16, ..., 416 + 384 input rows.
  A rank's first row then lies on an even row at every stride-2 layer, and
  an upsample doubles a rank's rows into exactly its rows of the finer
  level, so the necks' ``upsample2x`` + ``torch.cat`` need no exchange.
  JAX splits the pixels evenly (400 + 400); the function is the same,
  because the split does not change the result.  A rank may own no rows
  (32 px over 2 ranks, JAX's own multichip check): it runs every layer on
  empty slabs and takes part in every collective.
* **The window.**  A layer of kernel k, stride s and padding p whose rank
  owns output rows ``[o0, o1)`` reads input rows ``[o0·s - p, (o1-1)·s - p
  + k)``: p rows above its own and ``k - p - s`` below (the v5 stem's 6x6
  stride-2 conv, p = 2: 2 and 2; a 3x3 stride-2 conv: 1 and 0; a same-size
  13-pool: 6 and 6).  Rows outside the image hold the layer's own padding
  value, 0 for a conv and -inf for a max pool (``F.max_pool2d`` pads with
  -inf); the layer then runs with no height padding.
* **The exchange** (:class:`_Halo`), an autograd Function.  Forward: one
  ``all_gather`` in the group of every rank's last ``above`` and first
  ``below`` rows (fewer when it owns fewer, zero-padded to a common
  shape); a rank's window takes rows from any rank, so a halo wider than a
  neighbour (SPP's 13-pool needs 6 rows at stride 32, where a rank of a
  96 px image holds 1 or 2) reaches past it.  Backward, its adjoint: each
  rank writes the gradients of the rows it borrowed into a buffer of every
  rank's bands, one ``all_reduce`` sums it, and each rank adds its own
  bands' part to its rows' gradient.  Both are gloo's or NCCL's
  ``all_gather``/``all_reduce``, which gloo also runs on CUDA tensors (two
  ranks sharing one card, ``chip_smoke.py`` phase 18).
* **The head maps** (:func:`gather_rows`): before the loss, every rank of
  a group gathers the three head maps' rows; backward keeps the rank's own
  rows, with no communication.  Every rank of a group then computes the
  same loss of the group's images on whole maps (the losses stay
  unsplit), and its gradient counts each row once, each rank
  back-propagating through its own rows.
* **The synced BatchNorm** needs nothing more: each rank holds distinct
  rows, so the statistics over all ``dp`` ranks are the global batch's
  (:mod:`ryolo_tpu_torch.parallel.sync_bn`, its count the rank's own rows).

:func:`convert_spatial` swaps each ``nn.Conv2d`` of a model for a
:class:`SpatialConv2d` holding the same tensors (the ``.pth`` names do not
change); the pools are functions (``nn/blocks.py``: ``max_pool_same``,
``MaxConv``'s 2x2 pool) and route here themselves.  All of it acts only
inside :func:`spatial_forward`, which splits the rows, runs the model and
gathers the head maps; outside it every layer is the plain one.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ryolo_tpu_torch.parallel.mesh import COLLECTIVES

GRID = 32  # the coarsest stride: the unit of the row split


def row_split(h: int, sp: int, grid: int = GRID) -> List[Tuple[int, int]]:
    """Each of ``sp`` ranks' input rows ``[start, stop)`` of an ``h``-row
    image: the ``h // grid`` rows of stride ``grid`` split as evenly as
    possible, the remainder to the first ranks, scaled by ``grid``."""
    if h % grid:
        raise ValueError(f"image height {h} is not a multiple of {grid}")
    base, extra = divmod(h // grid, sp)
    out, start = [], 0
    for i in range(sp):
        stop = start + (base + (i < extra)) * grid
        out.append((start, stop))
        start = stop
    return out


@dataclass(frozen=True)
class Split:
    """The row split in force: ``sp`` ranks of the process group ``group``
    (``None``: the default group), this rank's ``index``, and the input
    image's height ``h`` and width ``w``.  A tensor's level is read from its
    width, which is never split: stride ``w // width``."""

    sp: int
    index: int
    group: Optional[object]
    h: int
    w: int

    def stride(self, x: torch.Tensor) -> int:
        s = self.w // x.shape[-1]
        if s * x.shape[-1] != self.w or GRID % s:
            raise ValueError(f"width {x.shape[-1]} is no level of a "
                             f"{self.w}-wide image")
        return s

    def rows(self, stride: int) -> List[Tuple[int, int]]:
        """Every rank's rows at the level of ``stride``."""
        return [(a // stride, b // stride)
                for a, b in row_split(self.h, self.sp)]

    def own(self, x: torch.Tensor) -> Tuple[int, int]:
        """This rank's rows of ``x``'s level, checked against ``x``."""
        a, b = self.rows(self.stride(x))[self.index]
        if x.shape[-2] != b - a:
            raise ValueError(f"{x.shape[-2]} rows where the split gives "
                             f"[{a}, {b})")
        return a, b


_ACTIVE: Optional[Split] = None  # the split in force, inside sharded()


@contextlib.contextmanager
def sharded(mesh, h: int, w: int):
    """Layers inside the block split rows as ``mesh``'s ``sp`` ranks do,
    of an ``h`` x ``w`` image."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = Split(mesh.sp, mesh.sp_index, mesh.sp_group, h, w)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def _halo_plan(split: Split, stride: int, above: int, below: int):
    """Where the ``above`` rows over and the ``below`` rows under this
    rank's rows come from: for each of the two, runs ``(src, p0, p1)``,
    ``src`` a rank whose gathered bands hold them at ``[p0, p1)``, or
    ``None`` for rows outside the image (``p1 - p0`` of them); and this
    rank's rows.  A rank's bands: its last ``min(above, n)`` rows ending at
    position ``above``, then its first ``min(below, n)`` rows from there."""
    ranges = split.rows(stride)
    height = ranges[-1][1]
    a, b = ranges[split.index]

    def runs(rows):
        out = []
        for g in rows:
            src = pos = None
            if 0 <= g < height:
                src = next(r for r, (ra, rb) in enumerate(ranges)
                           if ra <= g < rb)
                ra, rb = ranges[src]
                pos = above - (rb - g) if g < a else above + g - ra
            if out and out[-1][0] == src and (src is None
                                              or out[-1][2] == pos):
                out[-1][2] += 1
            else:
                out.append([src, pos or 0, (pos or 0) + 1])
        return [tuple(r) for r in out]

    return runs(range(a - above, a)), runs(range(b, b + below)), (a, b)


class _Halo(torch.autograd.Function):
    """``x`` (this rank's rows) -> its window, ``above`` rows over and
    ``below`` rows under it from the other ranks of the group, rows
    outside the image ``fill`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, split: Split, stride: int, above: int, below: int,
                fill: float):
        up, down, (a, b) = _halo_plan(split, stride, above, below)
        n = b - a
        m_up, m_down = min(above, n), min(below, n)
        band = x.new_zeros(x.shape[:2] + (above + below, x.shape[3]))
        band[:, :, above - m_up:above] = x[:, :, n - m_up:]
        band[:, :, above:above + m_down] = x[:, :, :m_down]
        bands = [torch.empty_like(band) for _ in range(split.sp)]
        COLLECTIVES["halo"] += 1
        dist.all_gather(bands, band, group=split.group)

        def rows(runs):
            return [x.new_full(x.shape[:2] + (p1 - p0, x.shape[3]), fill)
                    if src is None else bands[src][:, :, p0:p1]
                    for src, p0, p1 in runs]

        ctx.split, ctx.runs, ctx.rows = split, (up, down), (above, below, n)
        return torch.cat(rows(up) + [x] + rows(down), 2)

    @staticmethod
    def backward(ctx, g):
        split, (above, below, n) = ctx.split, ctx.rows
        buf = g.new_zeros((split.sp,) + g.shape[:2] + (above + below,
                                                        g.shape[3]))
        for w0, runs in zip((0, above + n), ctx.runs):
            for src, p0, p1 in runs:  # w0: the run's first window row
                if src is not None:
                    buf[src, :, :, p0:p1] += g[:, :, w0:w0 + p1 - p0]
                w0 += p1 - p0
        COLLECTIVES["halo"] += 1
        dist.all_reduce(buf, group=split.group)
        gx = g[:, :, above:above + n].clone()
        mine = buf[split.index]
        m_up, m_down = min(above, n), min(below, n)
        gx[:, :, n - m_up:] += mine[:, :, above - m_up:above]
        gx[:, :, :m_down] += mine[:, :, above:above + m_down]
        return gx, None, None, None, None, None


def window(x: torch.Tensor, k: int, s: int, p: int, fill: float):
    """The rows a layer of kernel ``k``, stride ``s`` and height padding
    ``p`` reads for this rank's output rows, ``fill`` outside the image,
    and the number of those output rows.  A rank with no output rows gets
    ``k`` rows, enough for one output row, which the caller drops (a conv
    or pool refuses an empty input), still joined to ``x`` so that its
    backward runs the exchange's."""
    split = _ACTIVE
    stride = split.stride(x)
    a, b = split.own(x)
    if (b - a) % s or a % s:
        raise ValueError(f"rows [{a}, {b}) do not split at stride {s}")
    n_out = (b - a) // s
    above, below = p, k - p - s
    if above > 0 or below > 0:
        x = _Halo.apply(x, split, stride, max(above, 0), max(below, 0),
                        fill)
    if n_out == 0:
        pad = k - x.shape[2]
        x = torch.cat([x, x.new_full(x.shape[:2] + (pad, x.shape[3]),
                                     fill)], 2)
    return x, n_out


def conv2d(x, weight, bias, stride: int, padding: Tuple[int, int]):
    """``F.conv2d`` of this rank's rows under the split in force."""
    win, n_out = window(x, weight.shape[2], stride, padding[0], 0.0)
    return F.conv2d(win, weight, bias, stride, (0, padding[1]))[:, :, :n_out]


def max_pool2d(x, k: int, s: int, p: int):
    """``F.max_pool2d(x, k, s, p)`` (-inf padding) of this rank's rows
    under the split in force, or of ``x`` whole outside one."""
    if _ACTIVE is None:
        return F.max_pool2d(x, k, stride=s, padding=p)
    win, n_out = window(x, k, s, p, float("-inf"))
    return F.max_pool2d(win, k, stride=s, padding=(0, p))[:, :, :n_out]


def upsample2x(x):
    """Nearest 2x upsample; under the split a rank's rows double into its
    rows of the finer level (checked), so no exchange is needed."""
    if _ACTIVE is None:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    a, b = _ACTIVE.own(x)
    stride = _ACTIVE.stride(x)
    if stride % 2 or _ACTIVE.rows(stride // 2)[_ACTIVE.index] != (2 * a,
                                                                    2 * b):
        raise ValueError(f"rows [{a}, {b}) at stride {stride} do not "
                         "double into the finer level's")
    if a == b:  # F.interpolate refuses an empty input
        return torch.cat([x, x], 3)
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class SpatialConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose forward, inside :func:`spatial_forward`, reads
    its halo (:func:`conv2d`); the plain conv elsewhere."""

    def forward(self, x):
        if _ACTIVE is None:
            return super().forward(x)
        return conv2d(x, self.weight, self.bias, self.stride[0],
                      self.padding)


def convert_spatial(model: nn.Module) -> nn.Module:
    """Every ``nn.Conv2d`` of ``model`` (all of its convs: the 1x1 ones
    read no halo, but a rank with no rows needs the empty-slab guard too)
    made a :class:`SpatialConv2d` in place, holding the same parameter
    tensors under the same names."""
    for mod in model.modules():
        if type(mod) is nn.Conv2d:
            if mod.dilation != (1, 1) or mod.groups != 1 or len(
                    set(mod.stride)) != 1 or mod.padding_mode != "zeros":
                raise NotImplementedError(f"spatial split of {mod}")
            mod.__class__ = SpatialConv2d
    return model


class _GatherRows(torch.autograd.Function):
    """This rank's rows of a map -> the group's whole map; backward keeps
    this rank's rows (module docstring)."""

    @staticmethod
    def forward(ctx, x, split: Split):
        ranges = split.rows(split.stride(x))
        a, b = ranges[split.index]
        most = max(rb - ra for ra, rb in ranges)
        pad = x.new_zeros(x.shape[:2] + (most, x.shape[3]))
        pad[:, :, :b - a] = x
        parts = [torch.empty_like(pad) for _ in range(split.sp)]
        COLLECTIVES["rows"] += 1
        dist.all_gather(parts, pad, group=split.group)
        ctx.rows = (a, b)
        return torch.cat([p[:, :, :rb - ra]
                          for p, (ra, rb) in zip(parts, ranges)], 2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g[:, :, a:b], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The group's whole map from this rank's rows of ``x``, under the
    split in force."""
    return _GatherRows.apply(x, _ACTIVE)


def spatial_forward(model: nn.Module, images: torch.Tensor,
                    mesh) -> Sequence[torch.Tensor]:
    """``model(images)``'s head maps, computed by ``mesh``'s ``sp`` ranks
    on their rows of the group's whole ``images`` (B, 3, H, W) and
    gathered whole on every rank of the group (``model`` converted by
    :func:`convert_spatial`)."""
    h, w = images.shape[2:]
    a, b = row_split(h, mesh.sp)[mesh.sp_index]
    with sharded(mesh, h, w):
        heads = model(images[:, :, a:b])
        return tuple(gather_rows(x) for x in heads)
