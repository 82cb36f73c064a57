"""Rank bodies for tests/test_torch_spatial*.py (``train --sp``): each runs
in a gloo rank spawned by ``tests.torch_dp_ranks.run(..., sp=S)`` and
returns what it computed.  Like tests/torch_dp_ranks.py, this module
imports torch and the port only; the JAX references run in the test
process.
"""

import numpy as np
import torch
import torch.nn.functional as F

from tests.torch_dp_ranks import _batch, _mesh, _model

# each layer kind: its inputs' strides (of the image the split is taken
# of) and the layer, from its inputs and its conv weight (None: a pool)
CONV_KINDS = {"conv3": (3, 1, 1), "conv3s2": (3, 2, 1), "conv1": (1, 1, 0),
              "conv6s2": (6, 2, 2)}
POOL_KINDS = {"pool5": (5, 1, 2), "pool9": (9, 1, 4), "pool13": (13, 1, 6),
              "pool2s2": (2, 2, 0)}
KINDS = tuple(CONV_KINDS) + tuple(POOL_KINDS) + ("upcat",)


def input_strides(kind):
    """The strides of a kind's inputs: the coarsest level it can run at
    (a stride-2 layer's input at 16, the rest at 32; ``upcat`` upsamples
    the stride-32 map onto the stride-16 one)."""
    if kind == "upcat":
        return (32, 16)
    if kind in CONV_KINDS:
        return (16,) if CONV_KINDS[kind][1] == 2 else (32,)
    return (16,) if POOL_KINDS[kind][1] == 2 else (32,)


def layer_fn(kind, weight, fill=None):
    """The layer as the model runs it under the split: the port's conv
    (``SpatialConv2d``'s forward) and pool functions.  ``fill``: a pool's
    window padded with ``fill`` instead of -inf (the control that must
    fail)."""
    from ryolo_tpu_torch.nn.blocks import max_pool_same, upsample2x
    from ryolo_tpu_torch.parallel import spatial

    if kind in CONV_KINDS:
        _, s, p = CONV_KINDS[kind]
        return lambda x: spatial.conv2d(x, weight, None, s, (p, p))
    if kind == "upcat":
        return lambda c, f: spatial.conv2d(
            torch.cat([f, upsample2x(c)], 1), weight, None, 1, (1, 1))
    k, s, p = POOL_KINDS[kind]
    if fill is not None:
        def padded(x):
            win, n_out = spatial.window(x, k, s, p, fill)
            return F.max_pool2d(win, k, s, (0, p))[:, :, :n_out]
        return padded
    if s == 1:
        return lambda x: max_pool_same(x, k)
    return lambda x: spatial.max_pool2d(x, k, s, p)


def layer(kind, h, w, inputs, weight, dy, fill=None):
    """This rank's rows of ``kind``'s output for the ``h`` x ``w`` image's
    split, and the gradients of ``sum(y·dy)`` (``dy`` whole; this rank's
    rows of it) for its rows of each input and for the weight (this
    rank's part of the sum over ranks)."""
    from ryolo_tpu_torch.parallel import COLLECTIVES, spatial

    mesh = _mesh()
    before = COLLECTIVES["halo"]
    wt = None if weight is None else torch.from_numpy(weight)\
        .requires_grad_(True)
    with spatial.sharded(mesh, h, w) as split:
        xs = []
        for x in inputs:
            a, b = split.rows(w // x.shape[3])[split.index]
            xs.append(torch.from_numpy(x[:, :, a:b].copy())
                      .requires_grad_(True))
        y = layer_fn(kind, wt, fill)(*xs)
        a, b = split.own(y)
    (y * torch.from_numpy(dy[:, :, a:b].copy())).sum().backward()
    return {"y": y.detach(), "rows": (a, b),
            "dx": [x.grad for x in xs],
            "dw": None if wt is None else wt.grad,
            "halo": COLLECTIVES["halo"] - before}


def forward(cfg, sd, images):
    """The model's head maps of ``images`` (NCHW, the group's whole
    images) by this group's ``sp`` ranks
    (:func:`ryolo_tpu_torch.parallel.spatial.spatial_forward`), gathered
    whole: every halo exchange, the BatchNorms at their running statistics
    (the raw heads of tests/test_checkpoint.py; the training-mode
    statistics are the steps')."""
    from ryolo_tpu_torch.parallel import convert_sync_bn, shard_batch
    from ryolo_tpu_torch.parallel.spatial import (convert_spatial,
                                                  spatial_forward)

    mesh = _mesh()
    model = convert_spatial(convert_sync_bn(_model(cfg, sd))).eval()
    mine = _batch(shard_batch({"images": images}, mesh))
    with torch.no_grad():
        heads = spatial_forward(model, mine["images"], mesh)
    return [h.clone() for h in heads]


def step(cfg, sd, batch, lr, control=None):
    """One SGD step of the port's ``--dp N --sp S`` trainer on this rank's
    group's images of the global ``batch`` (``images`` NCHW).
    ``control="all_ranks"``: the loss counts and items summed over all
    ranks, not over the groups (each target counted ``sp`` times), which
    must fail."""
    import dataclasses

    from ryolo_tpu_torch.parallel import (COLLECTIVES, convert_sync_bn,
                                          shard_batch)
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer

    mesh = _mesh()
    model = convert_sync_bn(_model(cfg, sd))
    mine = _batch(shard_batch(batch, mesh))
    reducer = mesh if control is None else dataclasses.replace(
        mesh, dp_group=None)
    loss_fn = LOSS_FNS[cfg["mode"]](model.anchors, cfg["nc"], cfg["hyp"],
                                    "cpu", reducer=reducer)
    trainer = Trainer(model, loss_fn, "SGD", lr, mesh=mesh)
    before = dict(COLLECTIVES)
    _, items = trainer.train_step(mine, lr, 1)
    return {"sd": {k: v.detach().clone()
                   for k, v in model.state_dict().items()},
            "items": {k: float(v) for k, v in items.items()},
            "collectives": {k: COLLECTIVES[k] - before[k]
                            for k in COLLECTIVES}}


def loader_batches(root, names, hyp, kw, n_batches):
    """This rank's group's first ``n_batches`` loader batches
    (``shard=(group, groups)``, as ``train --dp N --sp S`` loads)."""
    from ryolo_tpu_torch.data.loader import load_data

    mesh = _mesh()
    _, loader = load_data(root, names, "custom", hyp, True,
                          shard=(mesh.group, mesh.groups), **kw)
    out = []
    for i, b in enumerate(loader):
        if i == n_batches:
            break
        out.append({k: (list(v) if k == "paths" else np.asarray(v))
                    for k, v in b.items()})
    return {"group": mesh.group, "batches": out}
