"""``python -m ryolo_tpu_torch.train --dp 2 --sp 2 --device cpu`` and the
per-epoch eval under a spatial mesh, gloo ranks on the CPU.

* The CLI: 2 ranks splitting each 128 px image's height (one group of the
  global batch 2), an epoch of one step (2 train images) with the eval,
  then ``--resume`` to a second epoch as one self-spawning command; rank 0
  alone writes, and the parameters after the epoch lie within
  tests/test_torch_parallel_cli.py's ``BOUNDS`` of the ``--dp 1`` run's.
  One step, because this training amplifies a float32 rounding ~30-fold a
  step (that module's docstring), so that after more steps the order of a
  reduction, not the split, decides the distance.
* ``--sp 2`` with ``--dp 1`` builds no mesh and trains bit for bit as a
  plain run (JAX ``train.py:159-168``); ``--dp 2 --sp 3`` raises before any
  rank starts, as JAX's ``make_mesh`` asserts.
* ``evaluate(mesh=...)`` over 4 ranks, ``sp=2`` (2 groups, each image
  whole on both ranks of its group): the metrics within 1e-5 and the loss
  items within 1e-4 of JAX's ``evaluate(mesh=make_mesh(4, sp=2))`` and of
  the port's single-process eval, as tests/test_torch_parallel.py holds the
  ``--dp`` eval; the two ranks of a group match the same detections.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks
from tests.test_torch_losses import HYP
from tests.test_torch_parallel import EVAL_KW, eval_setup  # noqa: F401
from tests.test_torch_parallel_cli import BOUNDS, _initial_state
from tests.test_torch_train_cli import _args, _run
from tests.test_torch_trainer import update_gaps
from tests.torch_parity import MODEL_CFG, NC

REPO = Path(__file__).resolve().parents[1]
KW = dict(batch_size=2, img_size=128)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """2 train and 2 val images of 128 px, 2 classes."""
    from tests import make_synth_data
    from tests.torch_parity import limit_threads

    limit_threads()
    root = tmp_path_factory.mktemp("synth_sp")
    make_synth_data.main(str(root), n_images=2, img_size=128, seed=5)
    return root


def test_dp2_sp2_cli_trains_evaluates_saves_and_resumes(synth, tmp_path,
                                                        monkeypatch):
    from ryolo_tpu_torch.utils.checkpoint import load_pth

    run = tmp_path / "sp2"
    ranks = torch_dp_ranks.run(2, str(run), [
        ("cli", "train_cli", (str(run), _args(synth, epochs=1, dp=2, sp=2,
                                              model_name="sp", **KW)))],
        sp=2)
    assert ranks[0]["cli"]["writes"] == ["save_pth", "save_pth",
                                         "save_train_state"]
    assert ranks[1]["cli"]["writes"] == []
    out = run / "weights" / "sp"
    epoch1 = load_pth(str(out / "last.pth"))

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "ryolo_tpu_torch.train", "--dp", "2", "--sp",
         "2", "--device", "cpu", "--resume", "--epochs", "2",
         "--batch_size", "2", "--img_size", "128", "--model_name", "sp",
         "--ver", "yolov7", "--data", str(synth / "data.yaml"),
         "--config", str(REPO / "configs/hyp.yaml")],
        cwd=run, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Resumed from weights/sp/last.state at epoch 1" in proc.stderr
    last = load_pth(str(out / "last.pth"))
    assert list(last) == list(epoch1)
    assert not torch.equal(last["backbone.cbs0.conv.0.weight"],
                           epoch1["backbone.cbs0.conv.0.weight"])

    (tmp_path / "dp1").mkdir()
    single = _run(_args(synth, epochs=1, model_name="dp1", **KW),
                  tmp_path / "dp1", monkeypatch)
    want = {k: v.numpy() for k, v in load_pth(str(single / "last.pth"))
            .items()}
    got = {k: v.numpy() for k, v in epoch1.items()}
    stats, _, total = update_gaps(got, want, _initial_state(_args(synth)))
    print(f"--dp 2 --sp 2 against --dp 1 after the epoch: stats "
          f"{max(stats):.2e}, update {total:.4f}")
    assert max(stats) <= BOUNDS["stats"], max(stats)
    assert total <= BOUNDS["total"], total

    # --sp without --dp: no mesh, the plain run bit for bit
    (tmp_path / "sp1").mkdir()
    sp1 = _run(_args(synth, epochs=1, model_name="sp1", sp=2, **KW),
               tmp_path / "sp1", monkeypatch)
    for k, v in load_pth(str(sp1 / "last.pth")).items():
        assert np.array_equal(v.numpy(), want[k]), k


def test_sp_must_divide_dp(tmp_path, monkeypatch):
    from ryolo_tpu_torch.parallel import launch, make_mesh
    from ryolo_tpu_torch.train.__main__ import Train

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="not divisible by --sp 3"):
        Train(_args(tmp_path, dp=2, sp=3)).train()
    for call in (lambda: make_mesh(2, 3, device="cpu"),
                 lambda: launch("x:y", 2, sp=3, device="cpu")):
        with pytest.raises(ValueError, match="not divisible by sp 3"):
            call()


def test_spatial_mesh_eval_matches_jax_and_single(eval_setup,  # noqa: F811
                                                  tmp_path):
    from ryolo_tpu.eval.evaluator import evaluate as jax_evaluate
    from ryolo_tpu.losses import csl_loss
    from ryolo_tpu.nn import fuse_for_inference as jax_fuse
    from ryolo_tpu.nn.yolo import STRIDES, make_anchors
    from ryolo_tpu.parallel.mesh import make_mesh
    from tests.test_torch_evaluator import _assert_same_keep_set

    data, jmodel, variables, sd = eval_setup
    cfg = {"nc": NC, "model": MODEL_CFG, "mode": "csl", "ver": "yolov7",
           "hyp": HYP}
    ranks = torch_dp_ranks.run(4, str(tmp_path), [
        ("eval", "evaluate", (cfg, sd, data, EVAL_KW))], sp=2)
    ranks = [r["eval"] for r in ranks]
    single = torch_dp_ranks.evaluate(cfg, sd, data, EVAL_KW, sharded=False)
    anchors = make_anchors(STRIDES, MODEL_CFG["anchors"])

    def loss_fn(outputs, batch):
        return csl_loss(outputs, jnp.asarray(batch["tgt"]),
                        jnp.asarray(batch["tgt_csl"]),
                        jnp.asarray(batch["tgt_mask"]), anchors, NC, HYP)

    want = jax_evaluate(*jax_fuse(jmodel, variables), loss_fn, data, HYP,
                        True, mesh=make_mesh(4, sp=2), **EVAL_KW)
    print("metrics", ranks[0]["metrics"], single["metrics"], want[:4])
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["loss"] == ranks[0]["loss"]
    for ref in (single["metrics"], [float(v) for v in want[:4]]):
        np.testing.assert_allclose(ranks[0]["metrics"], ref, rtol=0,
                                   atol=1e-5)
    assert want[2] > 0
    for ref in (single["loss"], want[4]):
        for k, v in ref.items():
            np.testing.assert_allclose(ranks[0]["loss"][k], float(v),
                                       rtol=0, atol=1e-4, err_msg=k)
    # a group's two ranks match the same detections; group 0 holds images
    # 0 and 2, group 1 image 1 and then padding only
    for g in (0, 2):
        for a, b in zip(ranks[g]["dets"], ranks[g + 1]["dets"]):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [len(b) for b in ranks[2]["dets"]] == [1, 0]
    dets = [ranks[0]["dets"][0][0], ranks[2]["dets"][0][0],
            ranks[0]["dets"][1][0]]
    want_dets = [d for b in single["dets"] for d in b]
    assert len(want_dets) == 3 and sum(len(d) for d in dets) > 100
    for g, w in zip(dets, want_dets):
        _assert_same_keep_set(g, w)
