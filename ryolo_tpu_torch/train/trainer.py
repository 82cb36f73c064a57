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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch import nn

from ryolo_tpu_torch.data.device_augment import render_batch, to_device
from ryolo_tpu_torch.losses import csl_loss


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


def csl_loss_fn(anchors: Sequence[np.ndarray], nc: int, hyp: dict,
                device) -> Callable:
    """``(outputs, batch) -> (loss, items)`` for the CSL head, with the
    per-level anchors placed on ``device`` once."""
    anc = [torch.as_tensor(a, dtype=torch.float32, device=device)
           for a in anchors]

    def loss_fn(outputs, batch):
        return csl_loss(outputs, batch["tgt"], batch["tgt_csl"],
                        batch["tgt_mask"], anc, nc, hyp)

    return loss_fn


class Trainer:
    """Owns the optimizer and the accumulation count of one model + loss."""

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 optimizer_name: str, base_lr: float):
        self.model = model
        self.loss_fn = loss_fn  # (outputs, batch) -> (loss, items)
        self.optimizer = make_optimizer(optimizer_name, model.parameters(),
                                        base_lr)
        self.accum_count = 0

    def train_step(self, batch: Dict[str, torch.Tensor], lr: float,
                   accumulate: int):
        """One micro-batch: forward in train mode, loss, backward (summed
        into ``.grad``), and the update with learning rate ``lr`` once
        ``accumulate`` micro-batches are in.  ``batch``: ``images`` (B, 3,
        S, S) float32 and the targets, on the model's device.  Returns
        ``(loss, items)`` as device tensors; nothing here waits for the
        device."""
        self.model.train()
        loss, items = self.loss_fn(self.model(batch["images"]), batch)
        loss.backward()
        self.accum_count += 1
        if self.accum_count >= accumulate:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.accum_count = 0
        return loss.detach(), {k: v.detach() for k, v in items.items()}

    def train_step_rendered(self, spec_batch, bank, lr: float,
                            accumulate: int, n_out: int,
                            method: str = "taps"):
        """Device-side augmentation and :meth:`train_step` in one call:
        the loader's numpy spec batch goes up through pinned memory
        (kilobytes with a tile bank), renders on the current stream
        (:func:`ryolo_tpu_torch.data.device_augment.render_batch`; on a
        card ``method="taps"`` is one launch of the tap renderer) and
        steps, with no host sync in between."""
        dev = next(self.model.parameters()).device
        batch = {"images": render_batch(spec_batch, n_out, bank=bank,
                                        device=dev, method=method)}
        for k in ("tgt", "tgt_csl", "tgt_mask"):
            if k in spec_batch:
                batch[k] = to_device(spec_batch[k], dev)
        return self.train_step(batch, lr, accumulate)
