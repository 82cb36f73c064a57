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
                                nhwc_to_nchw, torch_model)


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
    limit_threads()
    jmodel, variables = jax_v7(seed=3)
    check_train_step(jmodel, variables, "yolov7")


# the float32 step's bounds (module docstring): loss items (rtol), BN
# statistics (of the tensor's largest entry), the update's L2 error in the
# worst tensor and over all parameters
F32_BOUNDS = {"items": 2e-4, "stats": 2e-4, "tensor": 0.02, "total": 0.0065}


def check_train_step(jmodel, variables, ver, mode="csl", img_size=128,
                     bf16=False, bounds=F32_BOUNDS):
    """One SGD step of the JAX ``Trainer.train_step`` and of the port's,
    from the same weights on the same batch (``mode``'s head and loss) of
    ``img_size`` px images, in float32 or, with ``bf16``, with a bf16
    forward on both sides (JAX ``Yolo(dtype=bfloat16)``, the port's
    ``Trainer(dtype=torch.bfloat16)``), held to ``bounds`` (bf16:
    tests/test_torch_trainer_bf16.py's ``check_bf16_update``); returns the
    measured gaps."""
    from ryolo_tpu.losses import csl_loss as jax_csl
    from ryolo_tpu.losses import kfiou_loss as jax_kfiou
    from ryolo_tpu.train.trainer import Trainer as JaxTrainer
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    tmodel = torch_model(variables, ver, mode)
    anchors = tmodel.anchors
    img = np.random.default_rng(7).uniform(
        0, 1, (2, img_size, img_size, 3)).astype(np.float32)
    if bf16:
        jmodel = jmodel.clone(dtype=jnp.bfloat16)
    if mode == "csl":
        tgt, csl, mask = _targets(8)
    else:
        from tests.test_torch_kfiou import kfiou_targets

        (tgt, mask), csl = kfiou_targets(8), None
    lr = 0.01

    def jloss(outputs, batch):
        if mode == "csl":
            return jax_csl(outputs, batch["tgt"], batch["tgt_csl"],
                           batch["tgt_mask"], anchors, NC, HYP)
        return jax_kfiou(outputs, batch["tgt"], batch["tgt_mask"], anchors,
                         NC, HYP)

    batch = {"tgt": tgt, "tgt_mask": mask}
    if csl is not None:
        batch["tgt_csl"] = csl
    jtr = JaxTrainer(jmodel, jloss, "SGD", lr)
    state, jl, jitems = jtr.train_step(
        jtr.init_state(variables),
        dict({k: jnp.asarray(v) for k, v in batch.items()},
             images=jnp.asarray(img)),
        jnp.float32(lr), jnp.int32(1))
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}, ver).items()}

    before = {k: v.detach().clone().numpy()
              for k, v in tmodel.state_dict().items()}

    def port_step(model, dtype):
        ttr = Trainer(model, LOSS_FNS[mode](anchors, NC, HYP, "cpu"), "SGD",
                      lr, dtype)
        return ttr.train_step(
            dict({k: torch.from_numpy(v) for k, v in batch.items()},
                 images=nhwc_to_nchw(img)), lr, 1)[1]

    titems = port_step(tmodel, torch.bfloat16 if bf16 else torch.float32)
    item_err = max(abs(titems[k].item() - float(v)) / abs(float(v))
                   for k, v in jitems.items())
    print(f"items: rel err {item_err:.2e}")
    assert item_err <= bounds["items"], item_err
    got = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    stat_errs, errs, total = update_gaps(got, want, before)
    print(f"stats: max {max(stat_errs):.2e}; update: per tensor max "
          f"{max(errs.values()):.4f}, all parameters {total:.5f}")
    assert max(stat_errs) <= bounds["stats"], max(stat_errs)
    assert len(stat_errs) > 150 and len(errs) > 200
    for k, v in tmodel.state_dict().items():
        assert not v.is_floating_point() or v.dtype == torch.float32, k
    gaps = {"items": item_err, "stats": max(stat_errs),
            "tensor": max(errs.values()), "total": total}
    if not bf16:
        assert max(errs.values()) <= bounds["tensor"], max(errs.values())
        assert total <= bounds["total"], total
        return gaps
    # the port's float32 step from the same weights: JAX's float32 step
    # within the float32 bounds above, so its distance from JAX's bf16 step
    # is JAX's own bf16-to-float32 distance
    t32 = torch_model(variables, ver, mode)
    port_step(t32, torch.float32)
    f32 = {k: v.numpy() for k, v in t32.state_dict().items()}
    return dict(gaps, **check_bf16_update(
        errs, *update_gaps(f32, want, before)[1:],
        total_gap(got, f32, before), bounds))


def check_bf16_update(errs, env, env_total, own_total, bounds):
    """The bf16 step's update (tests/test_torch_trainer_bf16.py says why):
    ``errs`` and ``env`` hold each parameter's update error against JAX's
    bf16 step, of the port's bf16 step and of its float32 one.  Each
    parameter where ``env`` is below ``bounds["held_below"]`` (at least
    ``bounds["held"]`` of them) lies within ``bounds["envelope"]`` times
    its ``env``; the port's bf16 step lies ``own_total`` from its float32
    one, within ``bounds["own"]`` times ``env_total``, JAX's own
    bf16-to-float32 distance over all parameters.  A step that leaves the
    parameters unchanged (an error of 1 in each, over 3 times an ``env``
    below 0.3) and the float32 step (``own_total`` 0) fail these bounds,
    and the check asserts that they do."""
    held = [k for k, e in env.items() if e < bounds["held_below"]]
    assert len(held) >= bounds["held"], sorted(held)

    def gaps(errs, own_total):
        return max(errs[k] / env[k] for k in held), own_total / env_total

    def within(ratio, own):
        return (ratio <= bounds["envelope"]
                and bounds["own"][0] <= own <= bounds["own"][1])

    ratio, own = gaps(errs, own_total)
    print(f"{len(held)} parameters whose update JAX's bf16 rounding moves "
          f"by less than {bounds['held_below']}: within {ratio:.3f} times "
          f"that (worst {max(errs[k] for k in held):.4f}); the port's bf16 "
          f"step lies {own_total:.4f} from its float32 step, {own:.3f} "
          f"times JAX's own {env_total:.4f}")
    assert within(ratio, own), (ratio, own)
    assert not within(*gaps(dict.fromkeys(env, 1.0), 1.0))
    assert not within(*gaps(env, 0.0))
    return {"held": len(held), "envelope": ratio, "own": own}


def _updates(sd, before):
    """Each parameter's update ``sd - before`` (float64, flat), BatchNorm
    statistics left out."""
    return {k: (w - before[k]).astype(np.float64).ravel()
            for k, w in sd.items()
            if not k.endswith(("num_batches_tracked", "running_mean",
                               "running_var"))}


def update_gaps(got, want, before):
    """``(BN statistics errors, {parameter: update error}, update error over
    all parameters)`` of state dict ``got`` against ``want``: a statistic's
    error over the tensor's largest entry, an update's as the L2 norm of its
    error over the L2 norm of ``want``'s update."""
    stat_errs = [np.abs(got[k] - w).max() / np.abs(w).max()
                 for k, w in want.items()
                 if k.endswith(("running_mean", "running_var"))]
    d_got, d_want = _updates(got, before), _updates(want, before)
    errs = {}
    for k, dw in d_want.items():
        assert np.abs(dw).max() > 0, k
        errs[k] = np.linalg.norm(d_got[k] - dw) / np.linalg.norm(dw)
    return stat_errs, errs, total_gap(got, want, before)


def total_gap(got, want, before):
    """The update error of ``got`` against ``want`` over all parameters."""
    d_got, d_want = _updates(got, before), _updates(want, before)
    dg = np.concatenate([d_got[k] for k in d_want])
    dw = np.concatenate(list(d_want.values()))
    return np.linalg.norm(dg - dw) / np.linalg.norm(dw)
