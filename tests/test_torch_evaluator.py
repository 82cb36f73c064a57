"""The port's evaluator and ``test`` CLI against the JAX package's
(``ryolo_tpu/eval/evaluator.py``, ``test.py``) on the CPU: uint8 eval
batches byte for byte, and ``evaluate`` on the same deploy-fused
YOLOv7-CSL (jittered weights, 96 px, batch 2 with a short last batch,
conf 0.001, iou 0.65, with the CSL val loss); the ``test`` CLI for the
other versions and for the KFIoU head likewise.

Bounds: the four metrics within 1e-6 with equal keep sets (the forwards
differ between the frameworks by float32 rounding, tests/test_deploy.py:
72-79, which moves a score by ~1e-6); each loss item within rtol 1e-4
(tests/test_torch_losses.py measures the loss itself at rtol 2e-5)."""

import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_losses import HYP
from tests.torch_parity import (MODEL_CFG, NC, jax_model, jax_v7,
                                limit_threads, torch_v7)

REPO = Path(__file__).resolve().parents[1]
IMG, BS, MAX_T = 96, 2, 32
KW = dict(img_size=IMG, batch_size=BS, conf_thres=0.001, iou_thres=0.65,
          max_targets=MAX_T, progress=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Synthetic data (3 val images: the last batch is short), jittered
    JAX weights, and a ``.pth`` of them written by the JAX ``save_pth``."""
    from ryolo_tpu.utils.checkpoint import save_pth
    from tests import make_synth_data

    limit_threads()
    root = tmp_path_factory.mktemp("synth")
    make_synth_data.main(str(root), n_images=6, img_size=IMG, seed=3)
    data = {"val": str(root / "val"), "names": ["greenbox", "redbox"],
            "type": "custom"}
    jmodel, variables = jax_v7(seed=2)
    weights = root / "w.pth"
    save_pth(variables, "yolov7", str(weights))
    return root, data, jmodel, variables, weights


def _capture(monkeypatch, module):
    """Record the per-image detections each evaluator matches."""
    seen = []
    orig = module.get_batch_statistics

    def spy(outputs, *a):
        seen.extend(np.asarray(o) for o in outputs)
        return orig(outputs, *a)

    monkeypatch.setattr(module, "get_batch_statistics", spy)
    return seen


def _jax_eval(jmodel, variables, data, mode="csl", conf=0.001,
              int8=False):
    import math

    import jax.numpy as jnp

    from ryolo_tpu.eval.evaluator import evaluate
    from ryolo_tpu.losses import csl_loss, kfiou_loss
    from ryolo_tpu.nn import fuse_for_inference
    from ryolo_tpu.nn.yolo import STRIDES, make_anchors, make_rotated_anchors

    if mode == "csl":
        anchors = make_anchors(STRIDES, MODEL_CFG["anchors"])

        def loss_fn(outputs, batch):
            return csl_loss(outputs, jnp.asarray(batch["tgt"]),
                            jnp.asarray(batch["tgt_csl"]),
                            jnp.asarray(batch["tgt_mask"]), anchors, NC, HYP)
    else:
        anchors = make_rotated_anchors(
            STRIDES, MODEL_CFG["anchors"],
            [a * math.pi / 180 for a in MODEL_CFG["angles"]])

        def loss_fn(outputs, batch):
            return kfiou_loss(outputs, jnp.asarray(batch["tgt"]),
                              jnp.asarray(batch["tgt_mask"]), anchors, NC,
                              HYP)

    # int8: test.py:62-66's deploy graph, bf16 with the wide convs int8
    model, dep = fuse_for_inference(
        jmodel, variables, dtype=jnp.bfloat16 if int8 else None,
        quantize=int8)
    return evaluate(model, dep, loss_fn, data, HYP, mode == "csl",
                    **dict(KW, conf_thres=conf))


def _port_model_and_loss(variables):
    from ryolo_tpu_torch.nn import STRIDES, fuse_for_inference, make_anchors
    from ryolo_tpu_torch.train import csl_loss_fn

    model = fuse_for_inference(torch_v7(variables), device="cpu")
    loss_fn = csl_loss_fn(make_anchors(STRIDES, MODEL_CFG["anchors"]), NC,
                          HYP, "cpu")
    return model, loss_fn


def _assert_same_keep_set(g, w, score_tol=1e-5):
    """The same detections per image, to the forward's rounding: each row
    of ``g`` pairs with its own row of ``w`` (same class and theta bin,
    boxes within the bounds of tests/test_torch_detect.py).  Rows may
    trade places only where their scores are within the rounding
    (``score_tol``).  Returns the number of rows that trade places."""
    assert g.shape == w.shape
    box = np.abs(g[:, None, :4] - w[None, :, :4]) / (2e-2 + 1e-3 * np.abs(
        w[None, :, :4]))
    cost = np.where((g[:, None, 6] == w[None, :, 6])
                    & (np.abs(g[:, None, 4] - w[None, :, 4]) <= 1e-6),
                    box.max(-1), np.inf)
    pair = cost.argmin(1)
    assert (cost[np.arange(len(g)), pair] <= 1).all()
    assert len(np.unique(pair)) == len(g)
    np.testing.assert_allclose(g[:, 5], w[pair, 5], atol=score_tol)
    moved = np.flatnonzero(pair != np.arange(len(g)))
    np.testing.assert_allclose(g[moved, 5], w[moved, 5], atol=score_tol)
    return len(moved)


def test_uint8_batches_byte_equal_to_jax(setup):
    from ryolo_tpu.data.loader import load_data as jload
    from ryolo_tpu_torch.data.loader import load_data

    root, data = setup[:2]
    kw = dict(img_size=IMG, batch_size=BS, augment=False, shuffle=False,
              max_targets=MAX_T, image_uint8=True)
    _, got = load_data(data["val"], data["names"], "custom", HYP, True, **kw)
    _, want = jload(data["val"], data["names"], "custom", HYP, True, **kw)
    got, want = list(got), list(want)
    assert len(got) == len(want) == 2 and len(got[1]["images"]) == 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["images"].dtype == np.uint8
        for k in g:
            if k == "paths":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="un-augmented"):
        load_data(data["val"], data["names"], "custom", HYP, True,
                  **dict(kw, augment=True))


def test_evaluate_matches_jax(setup, monkeypatch):
    import ryolo_tpu.eval.evaluator as jev
    import ryolo_tpu_torch.eval.evaluator as pev

    root, data, jmodel, variables, _ = setup
    jdets = _capture(monkeypatch, jev)
    pdets = _capture(monkeypatch, pev)
    want = _jax_eval(jmodel, variables, data)
    model, loss_fn = _port_model_and_loss(variables)
    got = pev.evaluate(model, loss_fn, data, HYP, True, device="cpu", **KW)

    assert len(pdets) == len(jdets) == 3
    assert sum(len(d) for d in jdets) > 100
    for g, w in zip(pdets, jdets):
        _assert_same_keep_set(g, w)
    print("metrics", got[:4], want[:4])
    np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=1e-6)
    assert want[2] > 0  # some TP at mAP@.5: the matcher did real work
    assert got[4].keys() == want[4].keys() and len(got[4]) == 5
    for k, v in want[4].items():
        np.testing.assert_allclose(got[4][k], float(v), rtol=1e-4)


def test_uint8_and_float_images_give_identical_results(setup):
    """The device-side /255 of uint8 batches equals the host loader's
    float32 division: evaluating the host-normalized batches gives the
    same numbers to the last bit."""
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.eval.evaluator import (_DIV255, _norm_images,
                                                evaluate)

    root, data, _, variables, _ = setup
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, -1)
    np.testing.assert_array_equal(
        _norm_images(torch.from_numpy(x), torch.from_numpy(_DIV255)).numpy(),
        (x.astype(np.float32) / 255.0).transpose(0, 3, 1, 2))
    model, loss_fn = _port_model_and_loss(variables)
    ref = evaluate(model, loss_fn, data, HYP, True, device="cpu", **KW)
    _, loader = load_data(data["val"], data["names"], "custom", HYP, True,
                          img_size=IMG, batch_size=BS, augment=False,
                          shuffle=False, max_targets=MAX_T)
    batches = list(loader)
    assert batches[0]["images"].dtype == np.float32
    got = evaluate(model, loss_fn, data, HYP, True, device="cpu",
                   batches=batches, **KW)
    assert got[:4] == ref[:4]
    assert got[4] == ref[4]


def test_pad_batch_pads_host_and_device_arrays():
    from ryolo_tpu.eval.evaluator import _pad_batch as jpad
    from ryolo_tpu_torch.eval.evaluator import _pad_batch

    rng = np.random.default_rng(0)
    arrays = {"images": rng.integers(0, 255, (1, 4, 4, 3), np.uint8),
              "tgt": rng.uniform(0, 1, (1, 3, 6)).astype(np.float32),
              "tgt_mask": np.ones((1, 3), bool)}
    want = jpad(arrays, 3)
    got = _pad_batch(dict(arrays, tgt=torch.from_numpy(arrays["tgt"])), 3)
    assert isinstance(got["tgt"], torch.Tensor)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert _pad_batch(arrays, 1) is arrays


def _test_args(weights, data_yaml, **kw):
    a = dict(weight_path=str(weights), mode="csl", ver="yolov7",
             conf_thres=0.001, iou_thres=0.65, batch_size=BS, img_size=IMG,
             data=str(data_yaml), hyp=str(REPO / "configs/hyp.yaml"),
             max_targets=MAX_T, dtype="f32", device="cpu")
    a.update(kw)
    return Namespace(**a)


def test_test_cli_on_cpu(setup):
    """``python -m ryolo_tpu_torch.test`` on the CPU with a ``.pth`` that
    the JAX package wrote: exits 0 and logs the ``all`` row."""
    root, _, _, _, weights = setup
    cmd = [sys.executable, "-m", "ryolo_tpu_torch.test", "--device", "cpu",
           "--ver", "yolov7", "--weight_path", str(weights),
           "--data", str(root / "data.yaml"),
           "--hyp", str(REPO / "configs/hyp.yaml"), "--img_size", str(IMG),
           "--batch_size", str(BS), "--max_targets", str(MAX_T)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Loaded 564 tensors" in r.stderr
    rows = [ln for ln in r.stderr.splitlines() if ln.split()[3:4] == ["all"]]
    assert len(rows) == 1 and rows[0].split()[4] == "3", r.stderr[-2000:]


def test_test_cli_bf16_runs(setup):
    from ryolo_tpu_torch.test import Test

    root, _, _, _, weights = setup
    mp, mr, map50, map5095, items = Test(
        _test_args(weights, root / "data.yaml", dtype="bf16")).run()
    assert all(0.0 <= v <= 1.0 for v in (mp, mr, map50, map5095))
    assert len(items) == 5 and all(np.isfinite(v) for v in items.values())


@pytest.mark.parametrize("ver", ["yolov5", "yolov4"])
def test_test_cli_versions_match_jax(setup, tmp_path, monkeypatch, ver):
    """``--ver yolov5`` (the default) and ``yolov4``: ``Test(args).run()``
    with a ``.pth`` written by the JAX package, against JAX ``evaluate`` on
    the same weights: the metrics and loss items at the bounds of
    ``test_evaluate_matches_jax``.

    The keep sets are held to JAX's post-processing of the port's own head
    maps, exactly (theta within 1e-6, as tests/test_torch_postprocess.py).
    Against JAX's whole run they are ill-conditioned on these images: on a
    flat background neighbouring cells make predictions that are equal in
    exact arithmetic, so float32 rounding can flip the greedy NMS order of
    two such candidates and change what the rest suppress (yolov5 here: 2
    of 538 rows of one image).  The head maps themselves are held to JAX
    by tests/test_torch_model.py."""
    _check_test_cli(setup, tmp_path, monkeypatch, ver, "csl")


@pytest.mark.parametrize("ver,conf", [("yolov7", 0.3), ("yolov5", 0.28)])
def test_test_cli_kfiou_matches_jax(setup, tmp_path, monkeypatch, ver, conf):
    """``--mode kfiou``: ``Test(args).run()`` against JAX ``evaluate`` as
    ``test_test_cli_versions_match_jax`` holds the CSL head (the KFIoU val
    loss, targets without CSL bins), at conf 0.3 (v7) and 0.28 (v5): these
    weights score every one of the 3402 candidates of an image at 0.2-0.32,
    and at conf 0.001 the plain NMS on the CPU takes ~30 s a batch; at
    these a few hundred pass (the full width is held by
    tests/test_torch_kfiou.py and by the card's eval load in
    chip_smoke.py).  The keep sets against JAX's
    ``post_process_kfiou_defer`` of the port's own head maps: the same
    valid rows, scores and classes exactly; the boxes within rtol 1e-6,
    atol 1e-4 (the port rounds the box sigmoids from float64,
    ``ryolo_tpu_torch/nn/heads.py``)."""
    _check_test_cli(setup, tmp_path, monkeypatch, ver, "kfiou", conf)


# the f32 CLI's bounds (module docstring): metrics (atol), loss items (rtol)
F32_BOUNDS = {"metrics": 1e-6, "loss": 1e-4}


@pytest.mark.parametrize("ver,mode,conf", [("yolov5", "csl", 0.001),
                                           ("yolov7", "kfiou", 0.3)])
def test_test_cli_int8_matches_jax(setup, tmp_path, monkeypatch, ver, mode,
                                   conf):
    """``--dtype int8`` (JAX test.py:62-66: the bf16 graph with the wide
    convs int8), the default ``--ver`` with the CSL head and YOLOv7 with the
    KFIoU head (the other pairs in tests/test_torch_detect.py): the keep
    sets equal JAX's post-process of the port's own int8 head maps, as
    ``test_test_cli_versions_match_jax`` holds them; the metrics and loss
    items against JAX ``evaluate`` of JAX's int8 graph.  The dynamic
    activation scale spans a batch: both evaluators give it the same
    batches, two images and then one image and one zero image (the short
    last batch is zero-padded, ``_pad_batch``, JAX evaluator.py:149).  The
    two int8 graphs part by rounding flips (tests/test_torch_int8_graph.py),
    so the bounds are measured ones: metrics within 2e-3 (measured 4.2e-4,
    yolov5-CSL's precision; yolov7-KFIoU finds nothing at conf 0.3 on
    either side), loss items within rtol 1e-3 (measured 1.1e-4)."""
    _check_test_cli(setup, tmp_path, monkeypatch, ver, mode, conf,
                    dtype="int8", bounds={"metrics": 2e-3, "loss": 1e-3})


def _check_test_cli(setup, tmp_path, monkeypatch, ver, mode, conf=0.001,
                    dtype="f32", bounds=F32_BOUNDS):
    import ryolo_tpu.eval.evaluator as jev
    import ryolo_tpu_torch.eval.evaluator as pev
    from ryolo_tpu.eval.postprocess import post_process_defer as jax_pp
    from ryolo_tpu.eval.postprocess import post_process_kfiou_defer as jax_kpp
    from ryolo_tpu.utils.checkpoint import save_pth
    from ryolo_tpu_torch.test import Test, build_parser

    assert build_parser().parse_args([]).ver == "yolov5"
    root, data = setup[:2]
    jmodel, variables = jax_model(ver, seed=2, mode=mode)
    weights = tmp_path / f"{ver}.pth"
    save_pth(variables, ver, str(weights))
    jdets = _capture(monkeypatch, jev)
    pdets = _capture(monkeypatch, pev)
    name = "post_process_defer" if mode == "csl" else \
        "post_process_kfiou_defer"
    calls, pp = [], getattr(pev, name)

    def spy_pp(dec, neck, *a, **kw):
        out = pp(dec, neck, *a, **kw)
        calls.append(((dec, neck) + a, kw, out))
        return out

    monkeypatch.setattr(pev, name, spy_pp)
    want = _jax_eval(jmodel, variables, data, mode, conf, dtype == "int8")
    got = Test(_test_args(weights, root / "data.yaml", ver=ver, mode=mode,
                          conf_thres=conf, dtype=dtype)).run()

    assert len(pdets) == len(jdets) == 3 and len(calls) == 2
    print("detections per image", [len(d) for d in pdets])
    assert sum(len(d) for d in pdets) > 100
    for (dec, neck, *a), kw, (d, v) in calls:
        neck = tuple(jnp.asarray(m.float().permute(0, 2, 3, 1).numpy())
                     for m in neck)
        if mode == "csl":
            wd, wv = jax_pp(jnp.asarray(dec.numpy()), neck, *a, **kw)
            exact, close, tol = [0, 1, 2, 3, 5, 6], [4], dict(atol=1e-6)
        else:
            wd, wv = jax_kpp(tuple(jnp.asarray(s.numpy()) for s in dec),
                             neck, *a, **kw)
            exact, close, tol = [5, 6], [0, 1, 2, 3, 4], dict(rtol=1e-6,
                                                              atol=1e-4)
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(d.numpy()[..., exact],
                                      np.asarray(wd)[..., exact])
        np.testing.assert_allclose(d.numpy()[..., close],
                                   np.asarray(wd)[..., close], **tol)
    print("metrics", got[:4], want[:4])
    print("loss", {k: (got[4][k], float(v)) for k, v in want[4].items()})
    np.testing.assert_allclose(got[:4], want[:4], rtol=0,
                               atol=bounds["metrics"])
    assert got[4].keys() == want[4].keys()
    assert len(got[4]) == (5 if mode == "csl" else 4)
    for k, v in want[4].items():
        np.testing.assert_allclose(got[4][k], float(v), rtol=bounds["loss"])


def test_cuda_without_card_raises(setup, monkeypatch):
    from ryolo_tpu_torch.eval.evaluator import evaluate
    from ryolo_tpu_torch.test import Test, build_parser

    assert build_parser().parse_args([]).device == "cuda"
    root, data, _, variables, weights = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Test(_test_args(weights, root / "data.yaml", device="cuda")).run()
    model, loss_fn = _port_model_and_loss(variables)
    # a mesh whose size does not divide the batch raises, as JAX's does
    # (the sharded eval itself: tests/test_torch_parallel.py)
    from ryolo_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="not divisible"):
        evaluate(model, loss_fn, data, HYP, True,
                 mesh=Mesh(3, 0, torch.device("cpu")), **KW)
