"""Rank bodies for tests/test_torch_parallel*.py: each runs in a process that
:func:`ryolo_tpu_torch.parallel.launch` spawned, after joining a gloo group
on the CPU, and writes what it computed to ``<out>/rank<r>.pt``.

This module imports torch and the port only: the test modules import JAX,
which pins its platform when imported, so the ranks must not import them.
The JAX references are computed in the test process.
"""

import os

import numpy as np
import torch


def run(dp, out, jobs, sp=1):
    """Each ``(key, name, args)`` of ``jobs``, in order, as ``name(*args)``
    of this module (or of ``module`` for a ``"module:name"``) in each of
    ``dp`` gloo ranks on the CPU, ``sp`` of them splitting each image's
    height, all in one process group (a file store under ``out``, so that
    parallel test workers do not collide); returns each rank's ``{key:
    result}``.  Pass
    numpy arrays, not tensors: spawning moves a tensor argument's storage
    into shared memory, which leaves numpy views of the old storage
    dangling."""
    from ryolo_tpu_torch.parallel import launch

    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    if os.path.exists(store):
        os.remove(store)
    launch("tests.torch_dp_ranks:_rank_jobs", dp, (out, jobs), device="cpu",
           init_method=f"file://{store}", sp=sp)
    paths = [os.path.join(out, f"rank{r}.pt") for r in range(dp)]
    results = [torch.load(p, weights_only=False) for p in paths]
    for p in paths:  # full-width state dicts: up to ~0.5 GB a rank
        os.remove(p)
    return results


def _rank_jobs(out, jobs):
    import importlib

    def fn(name):
        module, _, attr = name.rpartition(":")
        return getattr(importlib.import_module(module), attr) if module \
            else globals()[attr]

    results = {key: fn(name)(*args) for key, name, args in jobs}
    torch.save(results, os.path.join(out, f"rank{_mesh().rank}.pt"))


def _mesh():
    from ryolo_tpu_torch.parallel import current_mesh

    torch.set_num_threads(2)
    return current_mesh()


def bn(x, dy, weight, bias, steps):
    """The synced BatchNorm on this rank's rows of ``x`` (NCHW), ``steps``
    forward passes (the running statistics move each time), then the
    backward of ``sum(y·dy)`` through the last."""
    from ryolo_tpu_torch.nn.blocks import BN_EPS, BN_MOMENTUM
    from ryolo_tpu_torch.parallel import COLLECTIVES, SyncBatchNorm2d, \
        shard_batch

    mesh = _mesh()
    mine = shard_batch({"x": x, "dy": dy}, mesh)
    layer = SyncBatchNorm2d(x.shape[1], eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(weight))
        layer.bias.copy_(torch.from_numpy(bias))
    xr = torch.from_numpy(mine["x"]).requires_grad_(True)
    before = dict(COLLECTIVES)
    for _ in range(steps):
        y = layer(xr)
    (y * torch.from_numpy(mine["dy"])).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "dw": layer.weight.grad,
            "db": layer.bias.grad, "mean": layer.running_mean,
            "var": layer.running_var,
            "bn_collectives": COLLECTIVES["bn"] - before["bn"]}


def _model(cfg, sd, mesh=None):
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.parallel import convert_sync_bn

    model = Yolo(cfg["nc"], cfg["model"], mode=cfg["mode"], ver=cfg["ver"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    if mesh is not None:
        convert_sync_bn(model)
    return model


def _batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def step(cfg, sd, batch, lr, dtype="f32", averaged=False):
    """One SGD step of the port's ``--dp`` trainer on this rank's rows of
    the global ``batch`` (``images`` NCHW): synced BatchNorms, means over
    global counts, the ranks' gradients summed.  ``averaged``: a plain
    data-parallel step instead, each rank's loss a mean over its own rows
    and the gradients averaged over the ranks (what a
    ``DistributedDataParallel`` wrapper around the single-process loss
    computes)."""
    from ryolo_tpu_torch.parallel import (COLLECTIVES, all_reduce_grads,
                                          shard_batch)
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer

    mesh = _mesh()
    model = _model(cfg, sd, mesh)
    mine = _batch(shard_batch(batch, mesh))
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    before = dict(COLLECTIVES)
    if averaged:
        loss_fn = LOSS_FNS[cfg["mode"]](model.anchors, cfg["nc"], cfg["hyp"],
                                        "cpu")
        trainer = Trainer(model, loss_fn, "SGD", lr, dt)
        model.train()
        loss, _ = loss_fn(model(mine["images"]), mine)
        loss.backward()
        all_reduce_grads(model.parameters(), mesh)
        for p in model.parameters():
            p.grad /= mesh.dp
        for group in trainer.optimizer.param_groups:
            group["lr"] = lr
        trainer.optimizer.step()
        items = {}
    else:
        loss_fn = LOSS_FNS[cfg["mode"]](model.anchors, cfg["nc"], cfg["hyp"],
                                        "cpu", reducer=mesh)
        trainer = Trainer(model, loss_fn, "SGD", lr, dt, mesh)
        _, items = trainer.train_step(mine, lr, 1)
    return {"sd": {k: v.detach().clone()
                   for k, v in model.state_dict().items()},
            "items": {k: float(v) for k, v in items.items()},
            "collectives": {k: COLLECTIVES[k] - before[k]
                            for k in COLLECTIVES}}


def accumulate(sd, batches, lr):
    """Two micro-batches at ``accumulate=2`` of a small conv + BatchNorm
    net (:func:`small_net`), each on this rank's rows."""
    from ryolo_tpu_torch.parallel import (COLLECTIVES, convert_sync_bn,
                                          shard_batch)
    from ryolo_tpu_torch.train import Trainer

    mesh = _mesh()
    model = convert_sync_bn(small_net())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    trainer = Trainer(model, small_loss(mesh), "SGD", lr, mesh=mesh)
    before = dict(COLLECTIVES)
    counts = []
    for b in batches:
        trainer.train_step(_batch(shard_batch(b, mesh)), lr, 2)
        counts.append(COLLECTIVES["grad"] - before["grad"])
    return {"sd": model.state_dict(), "grad_allreduces": counts,
            "bn_collectives": COLLECTIVES["bn"] - before["bn"]}


def small_net():
    """Two conv + BatchNorm + SiLU blocks and a 1x1 conv."""
    from ryolo_tpu_torch.nn.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d

    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1, bias=False),
        BatchNorm2d(8, eps=BN_EPS, momentum=BN_MOMENTUM), torch.nn.SiLU(),
        torch.nn.Conv2d(8, 8, 3, stride=2, padding=1, bias=False),
        BatchNorm2d(8, eps=BN_EPS, momentum=BN_MOMENTUM), torch.nn.SiLU(),
        torch.nn.Conv2d(8, 2, 1))


def small_loss(reducer=None):
    """A masked mean over the ``mask`` rows and an unmasked mean, as the
    detection losses reduce, for :func:`small_net`."""
    from ryolo_tpu_torch.losses.common import (bce_loss, level_counts,
                                               masked_mean, reduce_items)

    def loss_fn(out, batch):
        mask = batch["mask"][:, None, None, None]
        (n,), shards = level_counts([batch["mask"]], reducer)
        reg = masked_mean((out[:, :1] - 1.0) ** 2,
                          mask.expand_as(out[:, :1]), n * out[0, 0].numel())
        obj = bce_loss(out[:, 1], batch["obj"], shards=shards)
        total = reg + obj
        return total, reduce_items({"reg": reg, "obj": obj,
                                    "total_loss": total}, reducer)

    return loss_fn


def evaluate(cfg, sd, data, kw, sharded=True):
    """The port's ``evaluate(mesh=...)`` of the fused model of ``sd`` (with
    ``sharded=False`` the single-process eval); the detections this rank
    matched, batch by batch and image by image."""
    from ryolo_tpu_torch.eval import evaluator
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.train import LOSS_FNS

    mesh = _mesh() if sharded else None
    model = _model(cfg, sd)
    loss_fn = LOSS_FNS[cfg["mode"]](model.anchors, cfg["nc"], cfg["hyp"],
                                    "cpu", reducer=mesh)
    seen = []
    orig, pipeline = evaluator.get_batch_statistics, evaluator.PIPELINE

    def spy(outputs, *a):
        seen.append([np.asarray(o) for o in outputs])
        return orig(outputs, *a)

    # one matcher thread: the detections in batch order
    evaluator.get_batch_statistics, evaluator.PIPELINE = spy, 1
    try:
        res = evaluator.evaluate(
            fuse_for_inference(model, device="cpu"), loss_fn, data,
            cfg["hyp"], cfg["mode"] == "csl", mesh=mesh, **kw)
    finally:
        evaluator.get_batch_statistics, evaluator.PIPELINE = orig, pipeline
    return {"metrics": [float(v) for v in res[:4]], "loss": res[4],
            "dets": seen}


def train_cli(out, args):
    """``Train(args).train()`` in this rank, counting the checkpoint files
    each rank writes."""
    import ryolo_tpu_torch.train.__main__ as cli

    _mesh()
    writes = []
    for name in ("save_pth", "save_train_state"):
        def counted(*a, _fn=getattr(cli, name), _name=name):
            writes.append(_name)
            return _fn(*a)
        setattr(cli, name, counted)
    cwd = os.getcwd()
    os.chdir(out)
    try:
        cli.Train(args).train()
    finally:
        os.chdir(cwd)
    return {"writes": writes}
