"""Spatial sharding of the whole model (``train --dp N --sp 2``), gloo ranks
on the CPU, against the JAX package and the port's single process.

* Forward: the head maps (BatchNorms at their running statistics) of
  YOLOv7, YOLOv5 and YOLOv4 (CSL) and YOLOv7-KFIoU at 96 px over
  ``make_mesh(2, sp=2)`` (2 + 1 stride-32 rows: SPP's and SPPCSPC's
  13-pool reaches past the neighbour and past the image; the v5 stem's
  6x6 stride-2 conv), every rank's gathered maps
  against JAX's ``Yolo.apply(train=False)`` on the same weights within the
  raw-head bound of tests/test_checkpoint.py:132-135 (2e-4).
* One SGD step of v7-CSL and v5-CSL at 128 px (2 + 2 rows) under
  ``make_mesh(2, sp=2)`` (one group of 2 images) and ``make_mesh(4, sp=2)``
  (two groups of one image each; group 1 holds no target), against JAX's
  ``Trainer.train_step`` on ``make_mesh(n, sp=2)`` with
  ``shard_batch(..., spatial=True)`` (``train.py:159-168,259-265``) and
  against the port's single-process step, at tests/test_torch_trainer.py's
  ``F32_BOUNDS``; the ranks of a group and the groups end equal.  JAX's
  own height-split step is off on the CPU backend here: its update lies
  0.68 from the same mesh's step with ``spatial=False`` at n = 2
  (``test_jax_height_split_step_is_off``; at n = 4 too): its forward is
  exact, and the gradient of the stride-1 max pools of SPPCSPC/SPPF is
  not (``test_jax_height_split_layer_gradient``), so the port
  is held to JAX's step on the same ``make_mesh(n, sp=2)`` with the batch
  split over its ``dp`` axis alone, which JAX's docstring says computes
  the same function.
* The control: the loss counts and items summed over all ranks instead of
  over the groups (each target counted twice; the loss still finite) must
  miss the update by far.
* The loader: under ``make_mesh(4, sp=2)`` the two ranks of a group load
  byte-equal batches (``shard=(group, groups)``), and the groups differ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks
from tests.test_torch_losses import HYP, _targets
from tests.test_torch_parallel import LOADER_HYP
from tests.test_torch_trainer import F32_BOUNDS, total_gap, update_gaps
from tests.torch_parity import (MODEL_CFG, NC, jax_ver, limit_threads,
                                nhwc_to_nchw, torch_model, ver_mode)

FWD_IMG, STEP_IMG, LR = 96, 128, 0.01
FWD_MODELS = ("yolov7", "yolov5", "yolov4", "yolov7-kfiou")
STEP_MODELS = ("yolov7", "yolov5")
RAW_HEAD_ATOL = 2e-4  # tests/test_checkpoint.py:132-135


@functools.lru_cache(maxsize=None)
def _weights(param):
    """JAX model and variables, and the port's state dict of them."""
    ver, mode = ver_mode(param)
    jmodel, variables = jax_ver(ver, seed=3, mode=mode)
    sd = {k: v.numpy().copy() for k, v in
          torch_model(variables, ver, mode).state_dict().items()}
    return jmodel, variables, sd


def _cfg(param):
    ver, mode = ver_mode(param)
    return {"nc": NC, "model": MODEL_CFG, "mode": mode, "ver": ver,
            "hyp": HYP}


def _images(img, seed=7):
    return np.random.default_rng(seed).uniform(
        0, 1, (2, img, img, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _step_batch():
    """The global batch of the steps: 2 images of 64 px, 9 targets on
    image 0 and none on image 1."""
    tgt, csl, mask = _targets(8, n=(9, 0))
    return {"images": _images(STEP_IMG), "tgt": tgt, "tgt_csl": csl,
            "tgt_mask": mask}


def _nchw(batch):
    return dict(batch, images=nhwc_to_nchw(batch["images"]).numpy())


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from tests.make_synth_data import make_split

    root = tmp_path_factory.mktemp("synth_sp")
    make_split(str(root / "train"), 8, 96, np.random.default_rng(8))
    return root


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory, synth):
    """``{n: each rank's results}`` of one launch of ``n`` ranks, ``sp=2``:
    at n = 2 the forwards, the steps and the control, at n = 4 the steps
    and the loader."""
    limit_threads()
    images = nhwc_to_nchw(_images(FWD_IMG)).numpy()
    step = _nchw(_step_batch())
    jobs = {2: [(("fwd", p), "tests.torch_sp_ranks:forward",
                 (_cfg(p), _weights(p)[2], images)) for p in FWD_MODELS]
            + [(("control", "yolov7"), "tests.torch_sp_ranks:step",
                (_cfg("yolov7"), _weights("yolov7")[2], step, LR,
                 "all_ranks"))],
            4: [(("loader",), "tests.torch_sp_ranks:loader_batches",
                 (str(synth / "train"), ["a", "b"], LOADER_HYP,
                  dict(img_size=96, batch_size=2, augment=True, shuffle=True,
                       drop_last=True, seed=3, workers=2,
                       device_augment=True), 2))]}
    for n in jobs:
        jobs[n] += [(("step", p), "tests.torch_sp_ranks:step",
                     (_cfg(p), _weights(p)[2], step, LR))
                    for p in STEP_MODELS]
    base = tmp_path_factory.mktemp("sp_step")
    return {n: torch_dp_ranks.run(n, str(base / f"n{n}"), j, sp=2)
            for n, j in jobs.items()}


@pytest.mark.parametrize("param", FWD_MODELS)
def test_forward_matches_jax(sp_ranks, param):
    jmodel, variables, _ = _weights(param)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(_images(FWD_IMG)))
    for rank in sp_ranks[2]:
        got = rank[("fwd", param)]
        assert len(got) == 3
        for g, w in zip(got, want):
            w = np.asarray(w).transpose(0, 3, 1, 2)  # JAX heads are NHWC
            assert g.shape == w.shape, (g.shape, w.shape)
            err = np.abs(g.numpy() - w).max()
            print(f"{param}: raw head {tuple(w.shape)} within {err:.2e}")
            assert err <= RAW_HEAD_ATOL, err


@functools.lru_cache(maxsize=None)
def _jax_mesh_step(param, n, spatial=True):
    """JAX ``Trainer.train_step`` over ``make_mesh(n, sp=2)`` (state
    replicated, images sharded on batch and, with ``spatial``, height), as
    ``train.py --dp n --sp 2`` runs it."""
    from ryolo_tpu.losses import csl_loss
    from ryolo_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from ryolo_tpu.train.trainer import Trainer as JaxTrainer
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    jmodel, variables, _ = _weights(param)
    anchors = torch_model(variables, *ver_mode(param)).anchors

    def jloss(outputs, b):
        return csl_loss(outputs, b["tgt"], b["tgt_csl"], b["tgt_mask"],
                        anchors, NC, HYP)

    mesh = make_mesh(n, sp=2)
    jtr = JaxTrainer(jmodel, jloss, "SGD", LR)
    state = jax.device_put(jtr.init_state(variables), replicate(mesh))
    state, _, items = jtr.train_step(
        state, shard_batch(_step_batch(), mesh, spatial=spatial),
        jnp.float32(LR), jnp.int32(1))
    sd = state_dict_from_flax({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(
                                   state.batch_stats)}, ver_mode(param)[0])
    return {k: v.numpy() for k, v in sd.items()}, {
        k: float(v) for k, v in items.items()}


@functools.lru_cache(maxsize=None)
def _port_step(param):
    """The port's single-process step on the global batch."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer

    ver, mode = ver_mode(param)
    model = Yolo(NC, MODEL_CFG, mode=mode, ver=ver)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _weights(param)[2].items()})
    trainer = Trainer(model, LOSS_FNS[mode](model.anchors, NC, HYP, "cpu"),
                      "SGD", LR)
    _, items = trainer.train_step(
        {k: torch.from_numpy(v) for k, v in _nchw(_step_batch()).items()},
        LR, 1)
    return ({k: v.numpy() for k, v in model.state_dict().items()},
            {k: float(v) for k, v in items.items()})


def _sd(res):
    return {k: v.numpy() for k, v in res["sd"].items()}


def _within(got, got_items, want, want_items, before, what):
    item_err = max(abs(got_items[k] - v) / abs(v)
                   for k, v in want_items.items())
    stat_errs, errs, total = update_gaps(got, want, before)
    print(f"{what}: items {item_err:.2e}, stats {max(stat_errs):.2e}, "
          f"update: worst tensor {max(errs.values()):.2e}, all {total:.2e}")
    assert item_err <= F32_BOUNDS["items"], item_err
    assert max(stat_errs) <= F32_BOUNDS["stats"], max(stat_errs)
    assert max(errs.values()) <= F32_BOUNDS["tensor"], max(errs.values())
    assert total <= F32_BOUNDS["total"], total


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("param", STEP_MODELS)
def test_step_matches_jax_mesh(sp_ranks, param, n):
    ranks = [r[("step", param)] for r in sp_ranks[n]]
    before = _weights(param)[2]
    got = _sd(ranks[0])
    for r in ranks[1:]:  # every rank, of either group, ends the same
        for k, v in r["sd"].items():
            assert np.array_equal(v.numpy(), got[k]), k
        assert r["items"] == ranks[0]["items"]
    # JAX's own step with the height split is off here (below): the same
    # mesh with the batch split over its dp axis alone stands for it
    want, want_items = _jax_mesh_step(param, n, spatial=False)
    _within(got, ranks[0]["items"], want, want_items, before,
            f"{param} --dp {n} --sp 2 against JAX make_mesh({n}, sp=2), "
            "spatial=False")
    single, single_items = _port_step(param)
    _within(got, ranks[0]["items"], single, single_items, before,
            f"{param} --dp {n} --sp 2 against the port's --dp 1")
    n_bn = sum(k.endswith("running_var") for k in before)
    # the windows that cross the split: every conv wider than 1x1 and the
    # three same-size pools of SPP/SPPF/SPPCSPC
    n_win = 3 + sum(v.ndim == 4 and v.shape[2] > 1 for k, v in before.items()
                    if k.endswith("weight"))
    # every BatchNorm synced twice, the loss counts and items once each
    # over the groups, one gradient all-reduce, the three head maps
    # gathered, and each window exchanged forward and back, but for the
    # stem's: its input, the image, takes no gradient
    assert ranks[0]["collectives"] == {
        "bn": 2 * n_bn, "loss": 2, "grad": 1, "rows": 3,
        "halo": 2 * n_win - 1}


def test_jax_height_split_step_is_off(n=2):
    """A reference behaviour: on the CPU backend JAX's
    ``Trainer.train_step`` under ``make_mesh(n, sp=2)`` with
    ``shard_batch(spatial=True)`` misses the same mesh's step with the
    batch split on ``dp`` alone (JAX's unsharded function up to float32
    order): from the gradient of the stride-1 max pools on, every layer
    before them is off (ROADMAP §C).  The port is held to the latter."""
    before = _weights("yolov7")[2]
    gap = total_gap(_jax_mesh_step("yolov7", n)[0],
                    _jax_mesh_step("yolov7", n, spatial=False)[0], before)
    print(f"JAX make_mesh({n}, sp=2): the height split's update {gap:.3f} "
          "from the batch split's")
    assert gap > 0.5, gap


def _jax_layer(kind):
    """A layer of the JAX package as a function of NHWC ``x``."""
    import flax.linen as nn
    from jax import lax

    from ryolo_tpu.nn.blocks import max_pool_same

    if kind.startswith("pool_same"):
        return functools.partial(max_pool_same, k=int(kind[9:]))
    if kind == "pool2s2":
        return lambda x: nn.max_pool(x, (2, 2), strides=(2, 2))
    kernel = jnp.asarray(np.random.default_rng(5).standard_normal(
        (3, 3, 4, 4)).astype(np.float32))
    return lambda x: lax.conv_general_dilated(  # conv3s2
        x, kernel, (2, 2), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("kind, off", [
    ("pool_same5", True), ("pool_same9", True), ("pool_same13", True),
    ("pool2s2", False), ("conv3s2", False)])
def test_jax_height_split_layer_gradient(kind, off):
    """Where JAX's height-split step parts (ROADMAP §C): under
    ``make_mesh(2, sp=2)`` with the height sharded, the CPU backend's
    forward of every layer is exact, and so is the gradient of a strided
    conv and of the 2x2 stride-2 pool; the gradient of the stride-1 pools
    of SPP/SPPF/SPPCSPC (``max_pool_same``, whose transpose is
    ``select_and_scatter_add``, partitioned by XLA with collective
    permutes) loses the share of the outputs whose window crosses the
    split.  With a cotangent of ones each output's gradient lands on one
    input, so the gradient sums to the outputs' count; the split's sums
    to fewer."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ryolo_tpu.parallel.mesh import make_mesh

    f = _jax_layer(kind)
    x = np.random.default_rng(4).standard_normal((2, 8, 4, 4)).astype(
        np.float32)
    xs = jax.device_put(x, NamedSharding(make_mesh(2, sp=2),
                                         P("dp", "sp", None, None)))
    fwd = jax.jit(f)
    grad = jax.jit(jax.grad(lambda x: f(x).sum()))
    assert np.array_equal(np.asarray(fwd(xs)), np.asarray(fwd(x)))
    want, got = np.asarray(grad(x)), np.asarray(grad(xs))
    gap = np.abs(got - want).max()
    print(f"{kind}: the height split's gradient within {gap:.3g}; sums "
          f"{got.sum():.6g} split, {want.sum():.6g} unsplit")
    if off:
        assert want.sum() == fwd(x).size
        assert got.sum() < want.sum() and gap >= 1, (got.sum(), gap)
    else:
        assert gap <= 1e-5, gap


def test_all_ranks_loss_count_fails(sp_ranks):
    """Counts summed over every rank, not over the groups: each target
    counts twice and the update misses the single process's by far."""
    single, _ = _port_step("yolov7")
    got = _sd(sp_ranks[2][0][("control", "yolov7")])
    gap = total_gap(got, single, _weights("yolov7")[2])
    print(f"loss counts over all ranks: update {gap:.3f} from --dp 1's")
    assert gap > 20 * F32_BOUNDS["total"], gap


def test_group_ranks_load_equal_batches(sp_ranks):
    ranks = [r[("loader",)] for r in sp_ranks[4]]
    assert [r["group"] for r in ranks] == [0, 0, 1, 1]
    for g in (0, 2):
        a, b = ranks[g]["batches"], ranks[g + 1]["batches"]
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                if k == "paths":
                    assert x[k] == y[k]
                else:
                    assert x[k].dtype == y[k].dtype and np.array_equal(
                        x[k], y[k]), k
    assert ranks[0]["batches"][0]["paths"] != ranks[2]["batches"][0]["paths"]
