"""The row split and the halo exchange of ``train --sp``
(``ryolo_tpu_torch/parallel/spatial.py``), layer by layer, in gloo ranks on
the CPU against the unsplit layer.

Each layer kind runs at its coarsest level (a stride-1 layer's input at
stride 32, a stride-2 layer's at 16) of images of 32, 96 and 160 rows,
over 2 and 3 ranks: 1-3 stride-32 rows a rank, so that the 9- and 13-pools'
halos (4 and 6 rows) reach past a neighbour and past the image, and at 32
px over 2 ranks one rank owns no rows (the JAX package's own multichip
check, ``__graft_entry__.py:107-115``).  The kinds: 3x3 stride 1 and 2,
1x1, the v5 stem's 6x6 stride 2 with padding 2, ``max_pool_same`` 5, 9
and 13, ``MaxConv``'s 2x2 stride-2 pool, and an upsample + concat + 3x3
conv of the necks.  The ranks' output rows put end to end must equal the
unsplit layer within 1e-6 (a conv of a window sums in another order), the
input gradients likewise, and the weight gradient summed over the ranks
within 1e-5.  A pool whose window is padded with 0 instead of -inf, on
negative inputs, must fail.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_dp_ranks
from tests.torch_sp_ranks import (CONV_KINDS, KINDS, POOL_KINDS,
                                  input_strides)

W = 64  # the image's width: 2 columns at stride 32
CASES = {2: (32, 96, 160), 3: (96, 160)}
TOL = {"y": 1e-6, "dx": 1e-6, "dw": 1e-5}


def _inputs(kind, h, seed, negative=False):
    """The kind's whole inputs (NCHW, 4 channels, batch 2), its weight
    and the output gradient ``dy``."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((2, 4, h // s, W // s)).astype(np.float32)
          for s in input_strides(kind)]
    if negative:
        xs = [-np.abs(x) - 0.1 for x in xs]
    weight = None
    shape = ((3, 4) + (CONV_KINDS[kind][0],) * 2 if kind in CONV_KINDS
             else (3, 8, 3, 3) if kind == "upcat" else None)
    if shape is not None:  # outputs of unit scale
        weight = (rng.standard_normal(shape)
                  / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
    y = _reference(kind, xs, weight)
    dy = rng.standard_normal(y.shape).astype(np.float32)
    return xs, weight, dy


def _reference(kind, xs, weight, dy=None):
    """The unsplit layer (plain PyTorch), its output and, with ``dy``, the
    gradients of ``sum(y·dy)``."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    wt = None if weight is None else torch.from_numpy(weight)\
        .requires_grad_(True)
    if kind in CONV_KINDS:
        _, s, p = CONV_KINDS[kind]
        y = F.conv2d(ts[0], wt, None, s, p)
    elif kind == "upcat":
        up = F.interpolate(ts[0], scale_factor=2.0, mode="nearest")
        y = F.conv2d(torch.cat([ts[1], up], 1), wt, None, 1, 1)
    else:
        k, s, p = POOL_KINDS[kind]
        y = F.max_pool2d(ts[0], k, s, p)
    if dy is None:
        return y.detach().numpy()
    (y * torch.from_numpy(dy)).sum().backward()
    return {"y": y.detach().numpy(), "dx": [t.grad.numpy() for t in ts],
            "dw": None if wt is None else wt.grad.numpy()}


def _jobs(sp):
    jobs = []
    for h in CASES[sp]:
        for i, kind in enumerate(KINDS):
            xs, weight, dy = _inputs(kind, h, seed=h + i)
            jobs.append(((kind, h), "tests.torch_sp_ranks:layer",
                         (kind, h, W, xs, weight, dy)))
    # the control: the 13-pool's window padded with 0, on negative inputs
    xs, _, dy = _inputs("pool13", 96, seed=5, negative=True)
    jobs.append((("pool13", 96, "zero"), "tests.torch_sp_ranks:layer",
                 ("pool13", 96, W, xs, None, dy, 0.0)))
    return jobs


@functools.lru_cache(maxsize=None)
def _ranks(sp, tmp):
    from tests.torch_parity import limit_threads

    limit_threads()
    return torch_dp_ranks.run(sp, str(tmp), _jobs(sp), sp=sp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("sp_layers")
    return lambda sp: _ranks(sp, base / f"sp{sp}")


def _assembled(results, key):
    """The ranks' outputs and input gradients put end to end in rank
    order, and the weight gradient summed over the ranks."""
    outs = [r[key] for r in results]
    y = torch.cat([o["y"] for o in outs], 2).numpy()
    dx = [torch.cat([o["dx"][i] for o in outs], 2).numpy()
          for i in range(len(outs[0]["dx"]))]
    dw = None if outs[0]["dw"] is None else sum(
        o["dw"] for o in outs).numpy()
    return y, dx, dw, [o["rows"] for o in outs], [o["halo"] for o in outs]


def _halo_rows(kind):
    """``(above, below)`` rows of the kind's window."""
    if kind == "upcat":
        return 1, 1
    k, s, p = (CONV_KINDS.get(kind) or POOL_KINDS[kind])
    return p, k - p - s


@pytest.mark.parametrize("sp,h", [(sp, h) for sp in CASES
                                  for h in CASES[sp]])
@pytest.mark.parametrize("kind", KINDS)
def test_layer_matches_unsplit(ranks, kind, sp, h):
    from ryolo_tpu_torch.parallel.spatial import row_split

    results = ranks(sp)
    xs, weight, dy = _inputs(kind, h, seed=h + KINDS.index(kind))
    want = _reference(kind, xs, weight, dy)
    y, dx, dw, rows, halos = _assembled(results, (kind, h))
    out_stride = (16 if kind == "upcat"
                  else input_strides(kind)[0] * (2 if kind in (
                      "conv3s2", "conv6s2", "pool2s2") else 1))
    assert rows == [(a // out_stride, b // out_stride)
                    for a, b in row_split(h, sp)]
    np.testing.assert_allclose(y, want["y"], rtol=TOL["y"], atol=TOL["y"])
    for got, w in zip(dx, want["dx"]):
        np.testing.assert_allclose(got, w, rtol=TOL["dx"], atol=TOL["dx"])
    if dw is not None:
        np.testing.assert_allclose(dw, want["dw"], rtol=TOL["dw"],
                                   atol=TOL["dw"])
    # one all-gather forward and one all-reduce backward where the window
    # crosses the split, none where it does not (1x1, the 2x2 pool)
    assert halos == [2 if max(_halo_rows(kind)) > 0 else 0] * sp


@pytest.mark.parametrize("sp", sorted(CASES))
def test_zero_padded_pool_fails(ranks, sp):
    """The 13-pool's window padded with 0: every output row whose window
    reaches past the image differs from the unsplit -inf-padded pool."""
    xs, _, dy = _inputs("pool13", 96, seed=5, negative=True)
    want = _reference("pool13", xs, None, dy)
    y, _, _, _, _ = _assembled(ranks(sp), ("pool13", 96, "zero"))
    assert y.shape == want["y"].shape
    assert np.abs(y - want["y"]).max() > 0.1


@pytest.mark.parametrize("h,sp,want", [
    (800, 2, [(0, 416), (416, 800)]), (96, 3, [(0, 32), (32, 64), (64, 96)]),
    (32, 2, [(0, 32), (32, 32)]), (160, 3, [(0, 64), (64, 128), (128, 160)])])
def test_row_split(h, sp, want):
    from ryolo_tpu_torch.parallel.spatial import row_split

    assert row_split(h, sp) == want
    with pytest.raises(ValueError, match="multiple of 32"):
        row_split(h + 16, sp)
