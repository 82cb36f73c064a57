"""The training step (counterpart of ``ryolo_tpu/train/trainer.py``:
``one_cycle`` :32, ``fitness`` :37, ``weights_init_normal`` :43,
``make_optimizer`` :81, ``Trainer`` :93).

The reference recipe (``train.py`` of the reference):

* SGD (momentum 0.937, Nesterov) or Adam, the learning rate set per step
  (warm-up and the per-epoch cosine one-cycle are the caller's);
* gradients summed over ``accumulate`` micro-batches (autograd sums into
  ``.grad``), one update when the count reaches ``accumulate``, then the
  sum resets (``_step_impl`` :147);
* BatchNorm running statistics move every micro-batch
  (:class:`ryolo_tpu_torch.nn.blocks.BatchNorm2d`).

``torch.optim.SGD(momentum=0.937, nesterov=True)`` computes what
``optax.sgd(nesterov=True)`` does: the first step's momentum is the
gradient, the update ``g + 0.937·trace``.

bf16 training (JAX ``train.py:96-103``, ``Yolo(dtype=jnp.bfloat16)``): the
model's forward runs under ``torch.autocast`` in bf16 (convs on float32
weights cast to bf16, BatchNorm reduced in float32 with a bf16 output,
bf16 activations); parameters, gradients, the optimizer and the
BatchNorm running statistics stay float32, and the loss, outside the
autocast region, reads the bf16 head maps as float32.  bf16 needs no loss
scaling.

Data parallelism (``--dp N``, JAX ``make_mesh(N)``): each rank steps on its
shard of the global batch with a model whose BatchNorms are synced
(:func:`ryolo_tpu_torch.parallel.convert_sync_bn`) and a loss whose means
divide by global counts (the loss functions' ``reducer``), so its loss is
its share of the global loss.  :class:`Trainer` with a ``mesh`` sums the
ranks' gradients in one all-reduce right before each update, and not on
the micro-batches that only accumulate (the sum is linear), so the update
is JAX's.  No wrapper (``DistributedDataParallel``) goes around the model:
its state-dict names stay the reference's.

Spatial sharding (``--dp N --sp S``, JAX ``make_mesh(N, sp=S)``): a
``mesh`` with ``sp`` above 1 takes the group's whole images, and each rank
runs the forward on its rows with the convs' and pools' halo exchanges
and gathers the head maps whole before the loss
(:func:`ryolo_tpu_torch.parallel.spatial.spatial_forward`; the Trainer
converts the model's convs, :func:`~ryolo_tpu_torch.parallel.spatial.
convert_spatial`).  The loss and items it returns are global, counted
once per group.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch import nn

from ryolo_tpu_torch.data.device_augment import render_batch, to_device
from ryolo_tpu_torch.losses import csl_loss, kfiou_loss
from ryolo_tpu_torch.parallel.mesh import all_reduce_grads
from ryolo_tpu_torch.parallel.spatial import convert_spatial, spatial_forward
from ryolo_tpu_torch.utils import trace


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """Sinusoidal ramp from y1 to y2 over ``steps``."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def fitness(metrics: np.ndarray) -> float:
    """0.1·mAP@.5 + 0.9·mAP@.5:.95 over [P, R, mAP@.5, mAP@.5:.95]."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return float((metrics * w).sum(0))


def weights_init_normal(model: nn.Module, generator: torch.Generator,
                        conv_std: float = 0.02, bn_std: float = 0.02):
    """Reference init: every conv weight ~ N(0, conv_std), BatchNorm weight
    ~ N(1, bn_std), BatchNorm bias 0; head conv biases (zero) and the
    implicit priors keep their init.  Draws come from ``generator`` (a CPU
    generator; values are copied to the model's device)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                mod.weight.copy_(conv_std * torch.randn(
                    mod.weight.shape, generator=generator))
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.copy_(1.0 + bn_std * torch.randn(
                    mod.weight.shape, generator=generator))
                mod.bias.zero_()
    return model


def make_optimizer(name: str, params, lr: float = 1.0):
    """SGD with Nesterov momentum 0.937, or Adam (optax defaults)."""
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.937, nesterov=True)
    raise NotImplementedError("The specified optimizer is not implemented.")


def _on_device(anchors: Sequence[np.ndarray], device):
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in anchors]


def csl_loss_fn(anchors: Sequence[np.ndarray], nc: int, hyp: dict,
                device, reducer=None) -> Callable:
    """``(outputs, batch) -> (loss, items)`` for the CSL head, with the
    per-level anchors placed on ``device`` once; ``reducer``: the mesh
    whose global batch the means run over (:func:`csl_loss`)."""
    anc = _on_device(anchors, device)

    def loss_fn(outputs, batch):
        return csl_loss(outputs, batch["tgt"], batch["tgt_csl"],
                        batch["tgt_mask"], anc, nc, hyp, reducer)

    return loss_fn


def kfiou_loss_fn(anchors: Sequence[np.ndarray], nc: int, hyp: dict,
                  device, reducer=None) -> Callable:
    """``(outputs, batch) -> (loss, items)`` for the KFIoU head (rotated
    anchors ``(na, 3)`` per level, placed on ``device`` once); the batch
    needs no ``tgt_csl``."""
    anc = _on_device(anchors, device)

    def loss_fn(outputs, batch):
        return kfiou_loss(outputs, batch["tgt"], batch["tgt_mask"], anc, nc,
                          hyp, reducer)

    return loss_fn


# the loss of each head, as the JAX train.py's make_loss_fn (:40) picks it
LOSS_FNS = {"csl": csl_loss_fn, "kfiou": kfiou_loss_fn}


class Trainer:
    """Owns the optimizer and the accumulation count of one model + loss."""

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 optimizer_name: str, base_lr: float,
                 dtype: torch.dtype = torch.float32, mesh=None):
        self.model = model
        self.mesh = mesh  # the ranks whose gradients each update sums
        self.spatial = mesh is not None and mesh.sp > 1
        if self.spatial:
            convert_spatial(model)
        self.loss_fn = loss_fn  # (outputs, batch) -> (loss, items)
        self.optimizer = make_optimizer(optimizer_name, model.parameters(),
                                        base_lr)
        self.accum_count = 0
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        self.dtype = dtype  # the forward's compute dtype

    def train_step(self, batch: Dict[str, torch.Tensor], lr: float,
                   accumulate: int):
        """One micro-batch: forward in train mode, loss, backward (summed
        into ``.grad``), and the update with learning rate ``lr`` once
        ``accumulate`` micro-batches are in (the forward in ``dtype``, the
        loss in float32).  ``batch``: ``images`` (B, 3, S, S) float32 and
        the targets, on the model's device (under ``sp`` the group's whole
        images: this rank runs its rows).  Returns
        ``(loss, items)`` as device tensors, global under a mesh; nothing
        here waits for the device (NCCL's collectives included).  Spans:
        ``train.step`` (unless :meth:`train_step_rendered` opened it) over
        ``train.forward``, ``train.loss``, ``train.backward`` and
        ``train.update`` (over ``train.all_reduce`` under a mesh)."""
        self.model.train()
        images = batch["images"]
        dev = images.device
        with trace.span("train.step", dev, once=True):
            with trace.span("train.forward", dev), torch.autocast(
                    dev.type, dtype=torch.bfloat16,
                    enabled=self.dtype == torch.bfloat16):
                if self.spatial:
                    outputs = spatial_forward(self.model, images, self.mesh)
                else:
                    outputs = self.model(images)
            with trace.span("train.loss", dev):
                loss, items = self.loss_fn(outputs, batch)
            with trace.span("train.backward", dev):
                loss.backward()
            self.accum_count += 1
            if self.accum_count >= accumulate:
                with trace.span("train.update", dev):
                    if self.mesh is not None:
                        with trace.span("train.all_reduce", dev):
                            all_reduce_grads(self.model.parameters(),
                                             self.mesh)
                    for group in self.optimizer.param_groups:
                        group["lr"] = lr
                    self.optimizer.step()
                    self.optimizer.zero_grad(set_to_none=True)
                self.accum_count = 0
        loss = items.get("total_loss", loss)
        return loss.detach(), {k: v.detach() for k, v in items.items()}

    def gather_pending_grads(self):
        """Under a mesh, with micro-batches summed but not yet applied: the
        ranks' gradient sums all-reduced into rank 0, zeros elsewhere, so
        that rank 0's training state (what ``last.state`` saves) holds the
        global sum and the next update's all-reduce still adds it once."""
        if self.mesh is None or self.accum_count == 0:
            return
        all_reduce_grads(self.model.parameters(), self.mesh)
        if not self.mesh.is_main:
            self.drop_pending_grads()

    def drop_pending_grads(self):
        """Zero the summed gradients on this rank (a rank other than 0 after
        loading rank 0's ``last.state``: :meth:`gather_pending_grads`)."""
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.zero_()

    def train_step_rendered(self, spec_batch, bank, lr: float,
                            accumulate: int, n_out: int,
                            method: str = "taps"):
        """Device-side augmentation and :meth:`train_step` in one call:
        the loader's numpy spec batch goes up through pinned memory
        (kilobytes with a tile bank), renders on the current stream
        (:func:`ryolo_tpu_torch.data.device_augment.render_batch`; on a
        card ``method="taps"`` is one launch of the tap renderer) and
        steps, with no host sync in between.  Spans: ``train.step`` over
        ``train.render``, ``train.targets`` and :meth:`train_step`'s."""
        dev = next(self.model.parameters()).device
        with trace.span("train.step", dev):
            with trace.span("train.render", dev):
                batch = {"images": render_batch(spec_batch, n_out, bank=bank,
                                                device=dev, method=method)}
            with trace.span("train.targets", dev):
                for k in ("tgt", "tgt_csl", "tgt_mask"):
                    if k in spec_batch:
                        batch[k] = to_device(spec_batch[k], dev)
            return self.train_step(batch, lr, accumulate)
