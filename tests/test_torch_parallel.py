"""Data parallelism of the port (``ryolo_tpu_torch/parallel/``, ``train
--dp N``) against the JAX package on the CPU: the sharded loader, the
synced BatchNorm, accumulation and the sharded eval.  The ranks are gloo
processes spawned by :func:`ryolo_tpu_torch.parallel.launch`; their bodies
live in tests/torch_dp_ranks.py, which imports no JAX.

* Loader: each rank's batches byte-identical to JAX's ``DataLoader(shard=
  (r, N))``, for a split length that divides by N and one that does not;
  the double-count warning of a sharded eval loader.
* Synced BatchNorm, 2 ranks: outputs, running statistics and gradients
  equal JAX's ``FusedBatchNorm`` on the global batch (atol 1e-5, rtol
  1e-5: float32 sums in another order); ``nn.SyncBatchNorm``'s unbiased
  running variance fails the same check.
* Accumulation 2: one gradient all-reduce, at the update; the result
  equals one process accumulating the two global batches.
* Sharded eval, 2 ranks: the metrics within 1e-5 and the loss items
  within 1e-4 of JAX's ``evaluate(mesh=make_mesh(2))`` and of the port's
  single-process eval (tests/test_parallel.py:73-126 holds JAX's sharded
  eval so), and every image's keep set the single-process one (the
  forward of a batch of 1 and of 2 differ by float32 rounding, ~2e-5 px
  here, so rows pair as tests/test_torch_evaluator.py pairs them);
  ``batch_size % dp`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks
from tests.test_torch_data import assert_same_array
from tests.test_torch_evaluator import _assert_same_keep_set
from tests.test_torch_losses import HYP
from tests.torch_parity import MODEL_CFG, NC, jax_v7, limit_threads

LOADER_HYP = dict(HYP, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, rotate=45,
                  translate=0.1, scale=0.5, flipud=0.5, fliplr=0.5,
                  mosaic=1.0, mixup=0.5)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Train splits of 8 and 7 images at 96 px."""
    from tests.make_synth_data import make_split

    root = tmp_path_factory.mktemp("synth_dp")
    for n in (8, 7):
        make_split(str(root / f"train{n}"), n, 96,
                   np.random.default_rng(n))
    return root


def _loaders(root, n, **kw):
    from ryolo_tpu.data.loader import load_data as jax_load
    from ryolo_tpu_torch.data.loader import load_data

    args = (str(root / f"train{n}"), ["a", "b"], "custom", LOADER_HYP, True)
    kw = dict(img_size=96, augment=True, shuffle=True, drop_last=True,
              seed=3, workers=2, device_augment=True, **kw)
    return jax_load(*args, **kw)[1], load_data(*args, **kw)[1]


@pytest.mark.parametrize("n", [8, 7])
def test_sharded_loader_matches_jax(synth, n):
    """Rank r of 2 at 2 images a batch, byte for byte JAX's shard; with 8
    images (divisible by the global batch 4) global batch i holds the
    unsharded loader's batch i, and the epoch has as many steps."""
    got_paths = []
    for rank in range(2):
        jax_loader, loader = _loaders(synth, n, batch_size=2,
                                      shard=(rank, 2))
        assert len(loader) == len(jax_loader) == (n + 1) // 2 // 2
        for epoch in (0, 1):
            jax_loader.set_epoch(epoch)
            loader.set_epoch(epoch)
            batches = list(loader)
            want = list(jax_loader)
            assert len(batches) == len(want) == len(loader)
            for b, w in zip(batches, want):
                assert b.keys() == w.keys()
                for k in w:
                    if k == "paths":
                        assert b[k] == w[k]
                    else:
                        assert_same_array(b[k], w[k], k)
            if epoch == 0:
                got_paths.append([b["paths"] for b in batches])
    if n % 4 == 0:
        full = _loaders(synth, n, batch_size=4)[1]
        assert len(full) == len(got_paths[0])
        for i, b in enumerate(full):
            assert sorted(b["paths"]) == sorted(got_paths[0][i]
                                                + got_paths[1][i])


def test_sharded_eval_loader_warns(synth):
    from ryolo_tpu_torch.data.loader import load_data

    with pytest.warns(UserWarning, match="DOUBLE-COUNTED"):
        load_data(str(synth / "train7"), ["a", "b"], "custom", LOADER_HYP,
                  True, img_size=96, batch_size=2, augment=False,
                  shuffle=False, shard=(1, 2))


def _jax_bn(x, dy, weight, bias, steps):
    """JAX ``FusedBatchNorm`` (NHWC) on the global batch: ``steps``
    training passes, then the gradients of ``sum(y·dy)`` of the last."""
    from ryolo_tpu.nn.fused_bn import FusedBatchNorm

    bn = FusedBatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    stats = bn.init(jax.random.PRNGKey(0), xh)["batch_stats"]
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    for _ in range(steps):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, xh,
                          mutable=["batch_stats"])
        last, stats = stats, upd["batch_stats"]

    def f(xh, params):
        return bn.apply({"params": params, "batch_stats": last}, xh,
                        mutable=["batch_stats"])[0]

    _, vjp = jax.vjp(f, xh, params)
    dx, dp = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    nchw = (0, 3, 1, 2)
    return {"y": np.asarray(y).transpose(nchw),
            "dx": np.asarray(dx).transpose(nchw),
            "dw": np.asarray(dp["scale"]), "db": np.asarray(dp["bias"]),
            "mean": np.asarray(stats["mean"]),
            "var": np.asarray(stats["var"])}


def test_sync_bn_matches_jax_fused_bn(tmp_path):
    """Two ranks of 2 rows each: the synced BatchNorm equals JAX's on the 4
    rows; ``nn.SyncBatchNorm`` moves the running variance toward the
    unbiased variance and fails.  (With more than one rank it runs only on
    a card, its gather of statistics having no CPU kernel; without a group
    it computes the same update on the global batch, which is what runs
    here.)"""
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, (4, 6, 2, 2)).astype(np.float32)
    dy = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    weight = rng.normal(1.0, 0.2, 6).astype(np.float32)
    bias = rng.normal(0.0, 0.2, 6).astype(np.float32)
    ranks = torch_dp_ranks.run(2, str(tmp_path), [
        ("bn", "bn", (x, dy, weight, bias, 2))])
    ranks = [r["bn"] for r in ranks]
    want = _jax_bn(x, dy, weight, bias, 2)
    got = {k: torch.cat([r[k] for r in ranks]).numpy() for k in ("y", "dx")}
    got.update(dw=sum(r["dw"] for r in ranks).numpy(),
               db=sum(r["db"] for r in ranks).numpy())
    for k in ("mean", "var"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        got[k] = ranks[0][k].numpy()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # forward and backward of the last pass, one forward of the first
    assert ranks[0]["bn_collectives"] == 3

    ref = torch.nn.SyncBatchNorm(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(weight))
        ref.bias.copy_(torch.from_numpy(bias))
    for _ in range(2):
        ref(torch.from_numpy(x))
    np.testing.assert_allclose(ref.running_mean.numpy(), want["mean"],
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(ref.running_var.numpy(), want["var"], rtol=1e-3)


def test_accumulate_two_all_reduces_once(tmp_path):
    """``accumulate=2`` over two micro-batches: no gradient all-reduce at
    the first, one at the update, and the update equals one process
    accumulating the two global batches."""
    from ryolo_tpu_torch.train import Trainer

    rng = np.random.default_rng(1)
    batches = [{"images": rng.normal(0, 1, (4, 3, 8, 8)).astype(np.float32),
                "mask": np.array(m),
                "obj": rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)}
               for m in ([True, False, True, True],
                         [False, False, True, False])]
    net = torch_dp_ranks.small_net()
    sd = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    ranks = torch_dp_ranks.run(2, str(tmp_path), [
        ("acc", "accumulate", (sd, batches, 0.1))])
    res = [r["acc"] for r in ranks]
    assert res[0]["grad_allreduces"] == [0, 1]
    assert res[0]["bn_collectives"] == 2 * 2 * 2  # 2 layers, fwd + bwd

    trainer = Trainer(net, torch_dp_ranks.small_loss(), "SGD", 0.1)
    for b in batches:
        trainer.train_step({k: torch.from_numpy(v) for k, v in b.items()},
                           0.1, 2)
    for k, v in net.state_dict().items():
        assert torch.equal(res[0]["sd"][k], res[1]["sd"][k]), k
        torch.testing.assert_close(res[0]["sd"][k], v, rtol=1e-5,
                                   atol=1e-6)
        if k.endswith(".weight"):  # the update happened
            assert not torch.equal(v, torch.from_numpy(sd[k])), k


EVAL_KW = dict(img_size=96, batch_size=2, conf_thres=0.001, iou_thres=0.65,
               max_targets=32, progress=False)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """3 val images of 96 px (the last batch of 2 is short: rank 1 holds
    only padding there) and jittered v7-CSL weights."""
    from tests import make_synth_data
    from tests.torch_parity import torch_v7

    limit_threads()
    root = tmp_path_factory.mktemp("synth_eval")
    make_synth_data.main(str(root), n_images=6, img_size=96, seed=3)
    data = {"val": str(root / "val"), "names": ["greenbox", "redbox"],
            "type": "custom"}
    jmodel, variables = jax_v7(seed=2)
    sd = {k: v.numpy().copy() for k, v in torch_v7(variables).state_dict()
          .items()}
    return data, jmodel, variables, sd


def test_sharded_eval_matches_jax_and_single(eval_setup, tmp_path):
    from ryolo_tpu.eval.evaluator import evaluate as jax_evaluate
    from ryolo_tpu.losses import csl_loss
    from ryolo_tpu.nn import fuse_for_inference as jax_fuse
    from ryolo_tpu.nn.yolo import STRIDES, make_anchors
    from ryolo_tpu.parallel.mesh import make_mesh

    data, jmodel, variables, sd = eval_setup
    cfg = {"nc": NC, "model": MODEL_CFG, "mode": "csl", "ver": "yolov7",
           "hyp": HYP}
    ranks = torch_dp_ranks.run(2, str(tmp_path), [
        ("eval", "evaluate", (cfg, sd, data, EVAL_KW))])
    ranks = [r["eval"] for r in ranks]
    single = torch_dp_ranks.evaluate(cfg, sd, data, EVAL_KW, sharded=False)

    anchors = make_anchors(STRIDES, MODEL_CFG["anchors"])

    def loss_fn(outputs, batch):
        return csl_loss(outputs, jnp.asarray(batch["tgt"]),
                        jnp.asarray(batch["tgt_csl"]),
                        jnp.asarray(batch["tgt_mask"]), anchors, NC, HYP)

    want = jax_evaluate(*jax_fuse(jmodel, variables), loss_fn, data, HYP,
                        True, mesh=make_mesh(2, sp=1), **EVAL_KW)
    print("metrics", ranks[0]["metrics"], single["metrics"], want[:4])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for ref in (single["metrics"], [float(v) for v in want[:4]]):
        np.testing.assert_allclose(ranks[0]["metrics"], ref, rtol=0,
                                   atol=1e-5)
    assert want[2] > 0
    assert ranks[0]["loss"].keys() == want[4].keys()
    for ref in (single["loss"], want[4]):
        for k, v in ref.items():
            np.testing.assert_allclose(ranks[0]["loss"][k], float(v),
                                       rtol=0, atol=1e-4, err_msg=k)
    # image order: batch 0 = images 0 (rank 0) and 1 (rank 1); batch 1 =
    # image 2 (rank 0), rank 1 holding padding only
    r0, r1 = ranks[0]["dets"], ranks[1]["dets"]
    dets = [r0[0][0], r1[0][0], r0[1][0]]
    assert [len(b) for b in r1] == [1, 0]
    want_dets = [d for b in single["dets"] for d in b]
    assert len(want_dets) == 3 and sum(len(d) for d in dets) > 100
    for g, w in zip(dets, want_dets):
        _assert_same_keep_set(g, w)


def test_sharded_eval_rejects_bad_batch(eval_setup):
    from ryolo_tpu_torch.eval.evaluator import evaluate
    from ryolo_tpu_torch.parallel import Mesh

    data = eval_setup[0]
    with pytest.raises(ValueError, match="not divisible"):
        evaluate(None, None, data, HYP, True,
                 mesh=Mesh(2, 0, torch.device("cpu")),
                 **dict(EVAL_KW, batch_size=3))


def test_dp_options_raise(tmp_path, monkeypatch):
    """``--device cuda:N`` with ``--dp`` above 1 raises (rank r takes
    ``cuda:LOCAL_RANK``), and so does a ``--batch_size`` that ``--dp`` does
    not divide (``train.py:161-164``), before any rank starts."""
    from tests.test_torch_train_cli import _args
    from ryolo_tpu_torch.train.__main__ import Train

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="cuda:LOCAL_RANK"):
        Train(_args(tmp_path, dp=2, device="cuda:1")).train()
    with pytest.raises(SystemExit):
        Train(_args(tmp_path, dp=2, batch_size=3)).train()
