"""One data-parallel SGD step of the port (``train --dp 2``: gloo ranks on
the CPU, each on its row of a global batch of 2 at 128 px) against the JAX
``Trainer.train_step`` under ``make_mesh(2)`` with ``shard_batch(spatial=
False)`` (``train.py:159-168,259-265``), and against the port's own
single-process step on the global batch.

The two images carry 9 targets and none: rank 1's masked means then have
no element of their own, and only means over the global count (the
losses' ``reducer``) give the global loss.  A plain data-parallel step,
each rank's loss a mean over its own row and the gradients averaged, is
shown to miss JAX's update by far.

Bounds: tests/test_torch_trainer.py's float32 bounds (``F32_BOUNDS``) for
the loss items, the BatchNorm statistics and the update.  Measured on the
CPU: the 2-rank v7-CSL update lies 2.1e-4 from the port's single-process
one over all parameters (5.2e-4 in the worst tensor; the synced
BatchNorm's one-pass variance against PyTorch's two-pass one); the
averaged step lies 0.48 from it.  The bf16 step is held to the port's
single-process bf16 step as tests/test_torch_trainer_bf16.py holds the
port's bf16 step to JAX's (``check_bf16_update``): bf16 rounding decides
most of a bf16 update at random weights, and the 2-rank bf16 step lies
1.13 from the single-process one, beside a bf16-to-float32 distance of
1.05.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks
from tests.test_torch_losses import HYP, _targets
from tests.test_torch_trainer import (F32_BOUNDS, check_bf16_update,
                                      total_gap, update_gaps)
from tests.torch_parity import (MODEL_CFG, NC, jax_model, jax_v7,
                                limit_threads, nhwc_to_nchw, torch_model)

IMG, LR = 128, 0.01
# tests/test_torch_trainer_bf16.py's bounds, except the loss items: these
# are held to 1.5 times the float32 step's largest relative item distance
# (measured 0.063 against 0.072, the cls_loss of both)
BF16_BOUNDS = {"items": 1.5, "stats": 0.08, "held_below": 0.3, "held": 15,
               "envelope": 1.5, "own": (0.5, 2.0)}


@functools.lru_cache(maxsize=None)
def _case(mode):
    """JAX weights, the port's state dict of them, and the global batch
    (NHWC images and loader-layout targets, 9 on image 0, none on 1)."""
    if mode == "csl":
        jmodel, variables = jax_v7(seed=3)
        tgt, csl, mask = _targets(8, n=(9, 0))
        batch = {"tgt": tgt, "tgt_csl": csl, "tgt_mask": mask}
    else:
        from tests.test_torch_kfiou import kfiou_targets

        jmodel, variables = jax_model("yolov7", seed=3, mode="kfiou")
        tgt, mask = kfiou_targets(8, n=(9, 0))
        batch = {"tgt": tgt, "tgt_mask": mask}
    assert mask[0].sum() == 9 and mask[1].sum() == 0
    batch["images"] = np.random.default_rng(7).uniform(
        0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    sd = {k: v.numpy().copy()
          for k, v in torch_model(variables, "yolov7", mode).state_dict()
          .items()}
    return jmodel, variables, sd, batch


def _nchw(batch):
    return dict(batch, images=nhwc_to_nchw(batch["images"]).numpy())


def _jax_mesh_step(jmodel, variables, batch, mode, anchors):
    """JAX ``Trainer.train_step`` over ``make_mesh(2)`` (state replicated,
    the batch sharded on ``dp``), as ``train.py --dp 2`` runs it."""
    from ryolo_tpu.losses import csl_loss, kfiou_loss
    from ryolo_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from ryolo_tpu.train.trainer import Trainer as JaxTrainer
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    def jloss(outputs, b):
        if mode == "csl":
            return csl_loss(outputs, b["tgt"], b["tgt_csl"], b["tgt_mask"],
                            anchors, NC, HYP)
        return kfiou_loss(outputs, b["tgt"], b["tgt_mask"], anchors, NC,
                          HYP)

    mesh = make_mesh(2, sp=1)
    jtr = JaxTrainer(jmodel, jloss, "SGD", LR)
    state = jax.device_put(jtr.init_state(variables), replicate(mesh))
    state, _, items = jtr.train_step(
        state, shard_batch(batch, mesh, spatial=False), jnp.float32(LR),
        jnp.int32(1))
    sd = state_dict_from_flax({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(
                                   state.batch_stats)}, "yolov7")
    return {k: v.numpy() for k, v in sd.items()}, {
        k: float(v) for k, v in items.items()}


@functools.lru_cache(maxsize=None)
def _port_step_cached(mode, dtype):
    _, _, sd, batch = _case(mode)
    return _port_step(sd, batch, mode, dtype)


def _port_step(sd, batch, mode, dtype=torch.float32):
    """The port's single-process step on the global batch (``--dp 1``)."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer

    model = Yolo(NC, MODEL_CFG, mode=mode, ver="yolov7")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    trainer = Trainer(model, LOSS_FNS[mode](model.anchors, NC, HYP, "cpu"),
                      "SGD", LR, dtype)
    _, items = trainer.train_step(
        {k: torch.from_numpy(v) for k, v in _nchw(batch).items()}, LR, 1)
    return ({k: v.numpy() for k, v in model.state_dict().items()},
            {k: float(v) for k, v in items.items()})


@pytest.fixture(scope="module")
def csl_ranks(tmp_path_factory):
    """The 2-rank port steps, in one launch: float32, averaged, bf16."""
    limit_threads()
    _, _, sd, batch = _case("csl")
    cfg = {"nc": NC, "model": MODEL_CFG, "mode": "csl", "ver": "yolov7",
           "hyp": HYP}
    args = (cfg, sd, _nchw(batch), LR)
    return torch_dp_ranks.run(2, str(tmp_path_factory.mktemp("dp_csl")), [
        ("f32", "step", args), ("averaged", "step", args + ("f32", True)),
        ("bf16", "step", args + ("bf16",))])


def _sd(res):
    return {k: v.numpy() for k, v in res["sd"].items()}


def _assert_step_within(got, got_items, want, want_items, before, what):
    item_err = max(abs(got_items[k] - v) / abs(v)
                   for k, v in want_items.items())
    stat_errs, errs, total = update_gaps(got, want, before)
    print(f"{what}: items {item_err:.2e}, stats {max(stat_errs):.2e}, "
          f"update: worst tensor {max(errs.values()):.2e}, all {total:.2e}")
    assert item_err <= F32_BOUNDS["items"], item_err
    assert max(stat_errs) <= F32_BOUNDS["stats"], max(stat_errs)
    assert max(errs.values()) <= F32_BOUNDS["tensor"], max(errs.values())
    assert total <= F32_BOUNDS["total"], total
    return total


def _check_dp_step(mode, ranks):
    jmodel, variables, sd, batch = _case(mode)
    tmodel = torch_model(variables, "yolov7", mode)
    want, want_items = _jax_mesh_step(jmodel, variables, batch, mode,
                                      tmodel.anchors)
    single, single_items = _port_step_cached(mode, torch.float32)
    got = _sd(ranks[0])
    for k, v in ranks[1]["sd"].items():  # the ranks stay identical
        assert np.array_equal(v.numpy(), got[k]), k
    assert ranks[0]["items"] == ranks[1]["items"]
    _assert_step_within(got, ranks[0]["items"], want, want_items, sd,
                        f"{mode} --dp 2 against JAX make_mesh(2)")
    _assert_step_within(got, ranks[0]["items"], single, single_items, sd,
                        f"{mode} --dp 2 against the port's --dp 1")
    # every BatchNorm synced twice (forward, backward), the loss counts and
    # items once each, one gradient all-reduce; no row split, so no halo
    # exchange and no head-map gather
    n_bn = sum(k.endswith("running_var") for k in sd)
    assert ranks[0]["collectives"] == {"bn": 2 * n_bn, "loss": 2, "grad": 1,
                                       "halo": 0, "rows": 0}
    return want, sd


def test_csl_step_matches_jax_mesh(csl_ranks):
    want, before = _check_dp_step("csl", [r["f32"] for r in csl_ranks])
    # plain data-parallel averaging of per-rank means misses JAX's update
    avg = _sd(csl_ranks[0]["averaged"])
    gap = total_gap(avg, want, before)
    print(f"averaged per-rank means: update {gap:.3f} from JAX's")
    assert gap > 20 * F32_BOUNDS["total"], gap


def test_bf16_step_matches_single_process(csl_ranks):
    """The 2-rank bf16 step against the port's single-process bf16 step,
    within the envelope that the single-process float32 step draws
    (module docstring)."""
    _, _, sd, batch = _case("csl")
    ref, ref_items = _port_step(sd, batch, "csl", torch.bfloat16)
    f32, f32_items = _port_step_cached("csl", torch.float32)
    got = _sd(csl_ranks[0]["bf16"])
    items = csl_ranks[0]["bf16"]["items"]

    def item_gap(a):
        return max(abs(a[k] - v) / abs(v) for k, v in ref_items.items())

    item_err, item_env = item_gap(items), item_gap(f32_items)
    stat_errs, errs, _ = update_gaps(got, ref, sd)
    _, env, env_total = update_gaps(f32, ref, sd)
    print(f"bf16 --dp 2 against --dp 1: items {item_err:.2e} (the float32 "
          f"step's {item_env:.2e}), stats {max(stat_errs):.2e}")
    assert item_err <= BF16_BOUNDS["items"] * item_env, (item_err, item_env)
    assert max(stat_errs) <= BF16_BOUNDS["stats"], max(stat_errs)
    f32_dp2 = _sd(csl_ranks[0]["f32"])
    check_bf16_update(errs, env, env_total, total_gap(got, f32_dp2, sd),
                      BF16_BOUNDS)
