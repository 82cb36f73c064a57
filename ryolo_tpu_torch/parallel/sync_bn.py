"""BatchNorm synced over the ranks of the process group
(:func:`ryolo_tpu_torch.parallel.make_mesh`), with the JAX package's
statistics.

Under ``make_mesh(N)`` the JAX trainer normalises each BatchNorm by the
statistics of the global batch, with the fast variance E[x²] - E[x]² in
float32 (``ryolo_tpu/nn/fused_bn.py:64-71``), and moves the running
variance toward that biased variance (:142-146).  ``nn.SyncBatchNorm``
reduces globally too, but moves the running variance toward the unbiased
variance, n/(n-1) larger.  :class:`SyncBatchNorm2d` keeps JAX's:

* forward: the per-channel sum, sum of squares and count, in float32 (also
  under bf16 autocast), in one all-reduce; ``mean = sum / count``, ``var =
  max(0, sumsq / count - mean²)``, ``y = (x - mean)·(rsqrt(var + eps)·w) +
  b`` in the input's dtype; the running update ``0.9·running + 0.1·batch``;
* backward: Σdy and Σdy·x̂ in one all-reduce, then the closed form of
  ``fused_bn.py:85-96``, ``dx = (dy - Σdy/n - x̂·Σdy·x̂/n)·w·rstd``.  The
  weight and bias gradients are this rank's sums: the trainer's gradient
  all-reduce adds the ranks' (each rank's loss is its share of the global
  loss, so the gradient over the ranks is a sum).

Under ``--sp`` (:mod:`ryolo_tpu_torch.parallel.spatial`) the arithmetic is
the same: a layer normalises a conv's output, which holds this rank's own
rows only (the halo rows are read by the convs, never normalised), so the
counts over the ranks sum to the global batch's pixels and the statistics
are the global batch's.  With one rank the collectives sum nothing and
the layer is JAX's single-device BatchNorm.  :func:`convert_sync_bn`
swaps every :class:`~ryolo_tpu_torch.nn.blocks.BatchNorm2d` of a model
for this one, keeping the parameters, buffers and their names: the
``.pth`` layout does not change.  In eval mode the layer is the plain
BatchNorm.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ryolo_tpu_torch.nn.blocks import BatchNorm2d
from ryolo_tpu_torch.parallel.mesh import COLLECTIVES

_DIMS = (0, 2, 3)


def _view(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        c = x.shape[1]
        x32 = x.float()
        stats = torch.cat([x32.sum(_DIMS), (x32 * x32).sum(_DIMS),
                           x32.new_full((1,), x.numel() // c)])
        COLLECTIVES["bn"] += 1
        dist.all_reduce(stats)
        count = stats[2 * c:]
        mean = stats[:c] / count
        var = torch.clamp_min(stats[c:2 * c] / count - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = (x32 - _view(mean)) * _view(rstd * weight) + _view(bias)
        ctx.save_for_backward(x, weight, mean, rstd, count)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd, count = ctx.saved_tensors
        c = x.shape[1]
        dy32 = dy.float()
        xhat = (x.float() - _view(mean)) * _view(rstd)
        local = torch.cat([dy32.sum(_DIMS), (dy32 * xhat).sum(_DIMS)])
        sums = local.clone()
        COLLECTIVES["bn"] += 1
        dist.all_reduce(sums)
        inv_n = 1.0 / count
        dx = ((dy32 - _view(sums[:c] * inv_n)
               - xhat * _view(sums[c:] * inv_n)) * _view(weight * rstd))
        return dx.to(x.dtype), local[c:], local[:c], None


class SyncBatchNorm2d(BatchNorm2d):
    """:class:`~ryolo_tpu_torch.nn.blocks.BatchNorm2d` with its training
    statistics over the global batch (module docstring)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, var = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                              self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        return y


def convert_sync_bn(model: nn.Module) -> nn.Module:
    """Every :class:`BatchNorm2d` of ``model`` replaced in place by a
    :class:`SyncBatchNorm2d` that holds the same parameter and buffer
    tensors under the same names."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is not BatchNorm2d:
                continue
            sync = SyncBatchNorm2d(child.num_features, eps=child.eps,
                                   momentum=child.momentum)
            for key, t in child._parameters.items():
                sync._parameters[key] = t
            for key, t in child._buffers.items():
                sync._buffers[key] = t
            sync.train(child.training)
            setattr(parent, name, sync)
    return model
