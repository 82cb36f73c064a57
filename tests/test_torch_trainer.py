"""Port trainer against the JAX package: schedules, init, accumulation, the
BatchNorm running statistics, and one full YOLOv7-CSL SGD step at 128 px,
batch 2.

Bounds for the full step (the same jittered weights through
``state_dict_from_flax``), each just above the gap measured on the CPU.
JAX takes a BatchNorm batch variance in one float32 pass, E[x²] - E[x]²,
and PyTorch in two; the fewer values a BatchNorm sees, the more that
difference moves the update, so the step runs at 128 px, where the
stride-32 BatchNorms see n = 32 values per channel (at 64 px, n = 8, the
update gap was 0.15 of a tensor's largest entry):

* loss items within rtol 2e-4 (measured: 5.0e-5 at worst, cls_loss);
* BN running statistics within 2e-4 of the tensor's largest entry
  (measured: 3.9e-5);
* the parameter update (new - old), as the L2 norm of its error over the
  L2 norm of JAX's update: within 0.02 for each tensor (measured: 0.0138 at
  worst) and within 0.0065 over all parameters together (measured:
  0.0052).  JAX's update departs from the port's float64 update by the
  same 0.0054, and the port's float32 update from its float64 one by
  0.0010, so the bound is set by JAX's float32 statistics.  A gradient
  10% off in any one tensor fails the first bound; the gradient of any
  one loss term scaled by 1.1 (reg 0.0073, theta 0.0099, cls 0.089) or
  the IoU score left undetached (0.030) fails the second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_losses import HYP, _targets
from tests.torch_parity import (MODEL_CFG, NC, jax_v7, limit_threads,
                                nhwc_to_nchw, torch_v7)


def test_one_cycle_and_fitness_match_jax():
    from ryolo_tpu.train.trainer import fitness as jax_fitness
    from ryolo_tpu.train.trainer import one_cycle as jax_one_cycle
    from ryolo_tpu_torch.train import fitness, one_cycle

    lf, jlf = one_cycle(1.0, 0.1, 100), jax_one_cycle(1.0, 0.1, 100)
    for x in (0, 13, 50, 99, 100):
        assert lf(x) == jlf(x)
    assert lf(100) == pytest.approx(0.1) and lf(50) == pytest.approx(0.55)
    for m in ([1.0, 1.0, 0.0, 0.0], [0, 0, 1.0, 0], [0.3, 0.2, 0.5, 0.4]):
        assert fitness(np.array(m)) == jax_fitness(np.array(m))


def test_weights_init_normal_statistics():
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import weights_init_normal

    model = Yolo(NC, MODEL_CFG)
    implicit = model.neck.im1.implicit.detach().clone()
    weights_init_normal(model, torch.Generator().manual_seed(0))
    k = model.backbone.elan3.cv7.conv[0].weight
    assert abs(k.std().item() - 0.02) < 0.002 and abs(k.mean().item()) < 0.002
    bn = model.backbone.elan3.cv7.conv[1]
    assert abs(bn.weight.mean().item() - 1) < 0.01
    assert abs(bn.weight.std().item() - 0.02) < 0.01
    assert (bn.bias == 0).all()
    assert (model.neck.conv5.conv[0].bias == 0).all()  # head bias: zeros
    assert torch.equal(model.neck.im1.implicit, implicit)


@pytest.mark.parametrize("module", ["port", "torch"])
def test_bn_running_var_is_biased(module):
    """The running variance moves toward the BIASED batch variance
    (ryolo_tpu/nn/fused_bn.py:69-71); nn.BatchNorm2d's unbiased update is
    n/(n-1) = 8/7 too large at n = 8, and fails here."""
    from ryolo_tpu_torch.nn.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d

    cls = BatchNorm2d if module == "port" else torch.nn.BatchNorm2d
    bn = cls(4, eps=BN_EPS, momentum=BN_MOMENTUM).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        1.0, 2.0, (2, 4, 2, 2)).astype(np.float32))
    bn(x)
    var = x.double().var(dim=(0, 2, 3), unbiased=False)
    want = 0.9 * 1.0 + 0.1 * var
    if module == "torch":
        assert not torch.allclose(bn.running_var.double(), want, rtol=1e-3)
        return
    np.testing.assert_allclose(bn.running_var.numpy(), want.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * x.double().mean((0, 2, 3))).numpy(),
                               rtol=1e-6)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.lin(x)


def test_gradient_accumulation_semantics():
    """accumulate=2: parameters change only at the second micro-batch, by
    the summed gradient (tests/test_trainer.py:72), and the sum resets."""
    from ryolo_tpu_torch.train import Trainer

    torch.manual_seed(0)
    model = _Toy()
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, lambda out, b: (((out - b["y"]) ** 2).mean(), {}),
                 "SGD", 0.1)
    rng = np.random.default_rng(0)
    b1 = {"images": torch.from_numpy(rng.normal(size=(2, 4)).astype(
        np.float32)), "y": torch.ones(2, 4)}
    b2 = {"images": torch.from_numpy(rng.normal(size=(2, 4)).astype(
        np.float32)), "y": -torch.ones(2, 4)}
    tr.train_step(b1, 0.1, 2)
    assert torch.equal(model.lin.weight, p0["lin.weight"])
    assert tr.accum_count == 1
    tr.train_step(b2, 0.1, 2)
    assert tr.accum_count == 0
    assert all(p.grad is None for p in model.parameters())

    # by hand: the summed gradient, first SGD-Nesterov step g + 0.937 g
    ref = _Toy()
    ref.load_state_dict(p0)
    for b in (b1, b2):
        ((ref(b["images"]) - b["y"]) ** 2).mean().backward()
    with torch.no_grad():
        for p, q in zip(model.parameters(), ref.parameters()):
            torch.testing.assert_close(p, q - 0.1 * (1 + 0.937) * q.grad)


def test_learning_rate_is_set_per_step():
    from ryolo_tpu_torch.train import Trainer

    torch.manual_seed(0)
    model = _Toy()
    tr = Trainer(model, lambda out, b: (out.square().mean(), {}), "SGD", 0.1)
    x = {"images": torch.ones(2, 4)}
    tr.train_step(x, 0.05, 1)
    assert tr.optimizer.param_groups[0]["lr"] == 0.05
    w = model.lin.weight.detach().clone()
    tr.train_step(x, 0.0, 1)
    # lr 0: no change, even with momentum carried over
    assert torch.equal(model.lin.weight, w)


def test_train_step_matches_jax():
    from ryolo_tpu.losses import csl_loss as jax_csl
    from ryolo_tpu.train.trainer import Trainer as JaxTrainer
    from ryolo_tpu_torch.nn import STRIDES, make_anchors
    from ryolo_tpu_torch.train import Trainer, csl_loss_fn
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    limit_threads()
    jmodel, variables = jax_v7(seed=3)
    tmodel = torch_v7(variables)
    anchors = make_anchors(STRIDES, MODEL_CFG["anchors"])
    img = np.random.default_rng(7).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    tgt, csl, mask = _targets(8)
    lr = 0.01

    def jloss(outputs, batch):
        return jax_csl(outputs, batch["tgt"], batch["tgt_csl"],
                       batch["tgt_mask"], anchors, NC, HYP)

    jtr = JaxTrainer(jmodel, jloss, "SGD", lr)
    state, jl, jitems = jtr.train_step(
        jtr.init_state(variables),
        {"images": jnp.asarray(img), "tgt": jnp.asarray(tgt),
         "tgt_csl": jnp.asarray(csl), "tgt_mask": jnp.asarray(mask)},
        jnp.float32(lr), jnp.int32(1))
    want = state_dict_from_flax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}, "yolov7")

    before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    ttr = Trainer(tmodel, csl_loss_fn(anchors, NC, HYP, "cpu"), "SGD", lr)
    tl, titems = ttr.train_step(
        {"images": nhwc_to_nchw(img), "tgt": torch.from_numpy(tgt),
         "tgt_csl": torch.from_numpy(csl), "tgt_mask": torch.from_numpy(mask)},
        lr, 1)
    item_err = max(abs(titems[k].item() - float(v)) / abs(float(v))
                   for k, v in jitems.items())
    print(f"items: rel err {item_err:.2e}")
    assert item_err <= 2e-4, item_err
    got = tmodel.state_dict()
    stat_errs, errs, d_gots, d_wants = [], [], [], []
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            stat_errs.append((np.abs(g - w) / (np.abs(w).max())).max())
            continue
        d_want = (w - before[k].numpy()).astype(np.float64).ravel()
        d_got = (g - before[k].numpy()).astype(np.float64).ravel()
        assert np.abs(d_want).max() > 0, k
        errs.append(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))
        d_gots.append(d_got)
        d_wants.append(d_want)
    d_got, d_want = np.concatenate(d_gots), np.concatenate(d_wants)
    total = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
    print(f"stats: max {max(stat_errs):.2e}; update: per tensor max "
          f"{max(errs):.4f}, all parameters {total:.5f}")
    assert max(stat_errs) <= 2e-4, max(stat_errs)
    assert max(errs) <= 0.02, max(errs)
    assert total <= 0.0065, total
    assert len(stat_errs) > 150 and len(errs) > 200
