"""Port detect CLI: a CPU smoke run, detections against the JAX detect
path, and a static scan that the port imports nothing of JAX."""

import ast
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests.torch_parity import MODEL_CFG, jax_model, jax_v7, limit_threads

REPO = Path(__file__).resolve().parents[1]
CONF, IOU, IMG, BS = 0.3, 0.4, 128, 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Synthetic images (two square from tests/make_synth_data.py, one
    wide so the letterbox pads) and a .pth of jittered JAX weights
    written by the JAX package's ``save_pth``."""
    from ryolo_tpu.utils.checkpoint import save_pth
    from tests import make_synth_data

    limit_threads()
    root = tmp_path_factory.mktemp("synth")
    make_synth_data.main(str(root), n_images=2, img_size=160)
    img = np.random.default_rng(0).integers(0, 255, (90, 150, 3), np.uint8)
    cv2.imwrite(str(root / "test" / "wide.png"), img)
    jmodel, variables = jax_v7(seed=1)
    weights = root / "w.pth"
    save_pth(variables, "yolov7", str(weights))
    return root, weights, jmodel, variables


def _args(root, weights, **kw):
    a = dict(weight_path=str(weights), mode="csl", ver="yolov7",
             conf_thres=CONF, nms_thres=IOU, batch_size=BS, img_size=IMG,
             data=str(root / "data.yaml"), hyp=str(REPO / "configs/hyp.yaml"),
             ext="png", dtype="f32", packed_input=False, device="cpu")
    a.update(kw)
    return Namespace(**a)


def _jax_detections(root, jmodel, variables, img=IMG, conf=CONF):
    """JAX detect.py's infer (:76-110) on the same letterboxed batches."""
    import jax
    import jax.numpy as jnp

    from ryolo_tpu.data.datasets import ImageDataset
    from ryolo_tpu.eval.postprocess import (post_process_defer,
                                            post_process_kfiou_defer)
    from ryolo_tpu.nn import fuse_for_inference
    from ryolo_tpu.nn.yolo import STRIDES

    model, dep = fuse_for_inference(jmodel, variables)
    anchors = _kfiou_anchors()

    @jax.jit
    def infer(v, images):
        images = images.astype(jnp.float32) / 255.0
        _, (dec, neck) = model.apply(v, images, train=False, decode="defer")
        if jmodel.mode == "csl":
            return post_process_defer(dec, neck, 3, 2, conf, IOU)
        return post_process_kfiou_defer(dec, neck, 18, anchors, STRIDES,
                                        conf, IOU)

    ds = ImageDataset(str(root / "test"), img_size=img, image_uint8=True)
    out = []
    for s in range(0, len(ds), BS):
        items = [ds[j] for j in range(s, min(s + BS, len(ds)))]
        dets, valid = infer(dep, jnp.asarray(np.stack([i for _, i in items])))
        dets, valid = np.asarray(dets), np.asarray(valid)
        out += [(p, dets[b][valid[b]]) for b, (p, _) in enumerate(items)]
    return out


def _spy_post_process(monkeypatch, det_mod):
    """Each batch's ``(dec, heads, (dets, valid))`` as ``Detect.infer``'s
    post-process (``detect._DecodePost``) saw and returned them."""
    calls, post = [], det_mod._DecodePost.post_process

    def spy(chain, dec):
        out = post(chain, dec)
        calls.append((dec, chain.heads, out))
        return out

    monkeypatch.setattr(det_mod._DecodePost, "post_process", spy)
    return calls


def _kfiou_anchors():
    import math

    from ryolo_tpu.nn.yolo import STRIDES, make_rotated_anchors

    return make_rotated_anchors(
        STRIDES, MODEL_CFG["anchors"],
        [a * math.pi / 180 for a in MODEL_CFG["angles"]])


def _assert_same_detections(got, want):
    assert [p for p, _ in got] == [p for p, _ in want]
    assert sum(len(d) for _, d in want) > 0
    for (_, g), (_, w) in zip(got, want):
        # same candidates, classes and bins; the forward differs between
        # the frameworks by f32 rounding (tests/test_deploy.py:72-79)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 6], w[:, 6])
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-6)
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=1e-3, atol=2e-2)
        np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1e-4)


def test_detections_match_jax(setup, tmp_path, monkeypatch):
    from ryolo_tpu_torch.detect import Detect

    root, weights, jmodel, variables = setup
    monkeypatch.chdir(tmp_path)
    got = Detect(_args(root, weights)).detect()
    _assert_same_detections(got, _jax_detections(root, jmodel, variables))
    assert len(list((tmp_path / "outputs" / "inference").glob("*.png"))) == 3


@pytest.mark.parametrize("ver", ["yolov5", "yolov4"])
def test_versions_match_jax(setup, tmp_path, monkeypatch, ver):
    """``--ver yolov5`` (the default) and ``yolov4`` at 96 px: the CLI's
    detections against JAX detect.py's infer, with a ``.pth`` written by
    the JAX package."""
    from ryolo_tpu.utils.checkpoint import save_pth
    from ryolo_tpu_torch.detect import Detect, build_parser

    assert build_parser().parse_args([]).ver == "yolov5"
    root = setup[0]
    jmodel, variables = jax_model(ver, seed=1)
    weights = tmp_path / f"{ver}.pth"
    save_pth(variables, ver, str(weights))
    monkeypatch.chdir(tmp_path)
    # these weights score lower than v7's: a lower threshold keeps rows
    got = Detect(_args(root, weights, ver=ver, img_size=96,
                       conf_thres=0.2)).detect()
    _assert_same_detections(got, _jax_detections(root, jmodel, variables,
                                                 img=96, conf=0.2))


@pytest.mark.parametrize("ver,conf", [("yolov7", 0.3), ("yolov5", 0.28)])
def test_kfiou_matches_jax(setup, tmp_path, monkeypatch, ver, conf):
    """``--mode kfiou`` at 96 px with a ``.pth`` written by the JAX
    package.  These weights score every candidate at 0.2-0.32, so the
    thresholds sit there.  Each batch's post-process equals JAX's
    ``post_process_kfiou_defer`` of the port's own head maps (the same
    valid rows, scores and classes; boxes within rtol 1e-6, atol 1e-4),
    and each image's detections pair up with JAX detect.py's whole run
    (``_assert_same_keep_set``): on the flat synthetic backgrounds rows
    with scores equal in exact arithmetic trade places by float32
    rounding."""
    import jax.numpy as jnp

    import ryolo_tpu_torch.detect as det_mod
    from ryolo_tpu.eval.postprocess import post_process_kfiou_defer as j_pp
    from ryolo_tpu.nn.yolo import STRIDES
    from ryolo_tpu.utils.checkpoint import save_pth
    from tests.test_torch_evaluator import _assert_same_keep_set

    root = setup[0]
    jmodel, variables = jax_model(ver, seed=1, mode="kfiou")
    weights = tmp_path / f"{ver}-kfiou.pth"
    save_pth(variables, ver, str(weights))
    calls = _spy_post_process(monkeypatch, det_mod)
    monkeypatch.chdir(tmp_path)
    got = det_mod.Detect(_args(root, weights, ver=ver, mode="kfiou",
                               img_size=96, conf_thres=conf)).detect()
    assert len(calls) == 2 and sum(len(d) for _, d in got) > 100
    a = (18, _kfiou_anchors(), STRIDES, conf, IOU)
    for scores, heads, (d, v) in calls:
        wd, wv = (np.asarray(x) for x in j_pp(
            tuple(jnp.asarray(s.numpy()) for s in scores),
            tuple(jnp.asarray(h.permute(0, 2, 3, 1).numpy()) for h in heads),
            *a))
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(d.numpy()[..., 5:], wd[..., 5:])
        np.testing.assert_allclose(d.numpy()[..., :5], wd[..., :5],
                                   rtol=1e-6, atol=1e-4)
    want = _jax_detections(root, jmodel, variables, img=96, conf=conf)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _assert_same_keep_set(g, w)


def test_letterbox_and_plot_helpers_match_jax(setup):
    """The port's copies of the host helpers equal the JAX package's."""
    from ryolo_tpu.data.datasets import ImageDataset as JDataset
    from ryolo_tpu.data.datasets import xywha_to_polys_np as j_polys
    from ryolo_tpu.utils.plot import class_color as j_color
    from ryolo_tpu.utils.plot import rescale_boxes as j_rescale
    from ryolo_tpu_torch.data.datasets import ImageDataset, xywha_to_polys_np
    from ryolo_tpu_torch.utils.plot import class_color, rescale_boxes

    root = setup[0]
    got = ImageDataset(str(root / "test"), img_size=IMG)
    want = JDataset(str(root / "test"), img_size=IMG, image_uint8=True)
    assert len(got) == len(want) == 3
    for i in range(3):
        (gp, gi), (wp, wi) = got[i], want[i]
        assert gp == wp and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
    boxes = np.random.default_rng(2).uniform(1, 100, (9, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(xywha_to_polys_np(boxes[:, :5]),
                                  j_polys(boxes[:, :5]))
    for shape in ((90, 150), (150, 90), (128, 128)):
        np.testing.assert_array_equal(rescale_boxes(boxes, IMG, shape),
                                      j_rescale(boxes, IMG, shape))
    assert [class_color(c, 16) for c in range(16)] == \
        [j_color(c, 16) for c in range(16)]


def test_cli_smoke_on_cpu(setup, tmp_path):
    root, weights, _, _ = setup
    cmd = [sys.executable, "-m", "ryolo_tpu_torch.detect", "--device", "cpu",
           "--ver", "yolov7", "--weight_path", str(weights),
           "--data", str(root / "data.yaml"),
           "--hyp", str(REPO / "configs/hyp.yaml"), "--img_size", str(IMG),
           "--batch_size", str(BS), "--conf_thres", str(CONF),
           "--packed_input"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "objects found" in r.stderr
    assert len(list((tmp_path / "outputs" / "inference").glob("*.png"))) == 3


def test_bf16_detect(setup, tmp_path, monkeypatch):
    """--dtype bf16 runs the fused forward in bf16; decode and
    post-processing stay float32."""
    import torch

    from ryolo_tpu_torch.detect import Detect

    root, weights, _, _ = setup
    monkeypatch.chdir(tmp_path)
    det = Detect(_args(root, weights, dtype="bf16"))
    got = det.detect()
    assert len(got) == 3 and sum(len(d) for _, d in got) > 0
    for _, d in got:
        assert d.dtype == np.float32 and np.isfinite(d).all()
        assert (d[:, 5] > CONF).all()
        # theta stays on the 180-bin grid
        bins = d[:, 4] / np.pi * 180.0 + 90.0
        np.testing.assert_allclose(bins, np.round(bins), atol=1e-3)
    model, dtype = det._build_model(2, {"model": MODEL_CFG},
                                    torch.device("cpu"))
    assert dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("ver,mode,conf", [
    ("yolov7", "csl", CONF), ("yolov4", "csl", 0.2),
    ("yolov5", "kfiou", 0.28)])
def test_int8_detect_matches_jax_post_process(setup, tmp_path, monkeypatch,
                                              ver, mode, conf):
    """``--dtype int8`` (the bf16 graph with its wide convs int8, JAX
    detect.py:64-69) at 96 px, each ``--ver`` and ``--mode`` here or in
    tests/test_torch_evaluator.py (``test_test_cli_int8_matches_jax``:
    yolov5-CSL, yolov7-KFIoU): the model carries int8 convs, and each
    batch's detections equal JAX's post-process of the port's own int8
    head maps (CSL: the same rows, theta within 1e-6; KFIoU: the same
    valid rows, scores and classes, boxes within rtol 1e-6, atol 1e-4), as
    ``tests/test_torch_evaluator.py::_check_test_cli`` holds them.  The
    int8 graph itself is held to JAX's by tests/test_torch_int8.py and
    tests/test_torch_int8_graph.py.  The dynamic activation scale spans a
    batch, so the batches are JAX detect.py's: the same letterboxed images
    in the same order, two a batch, the last one short and not padded."""
    import jax.numpy as jnp
    import torch

    import ryolo_tpu_torch.detect as det_mod
    from ryolo_tpu.eval.postprocess import post_process_defer as j_pp
    from ryolo_tpu.eval.postprocess import post_process_kfiou_defer as j_kpp
    from ryolo_tpu.nn.yolo import STRIDES
    from ryolo_tpu.utils.checkpoint import save_pth
    from ryolo_tpu_torch.nn.blocks import Int8Conv

    root, weights = setup[:2]
    if (ver, mode) != ("yolov7", "csl"):
        _, variables = jax_model(ver, seed=1, mode=mode)
        weights = tmp_path / f"{ver}-{mode}.pth"
        save_pth(variables, ver, str(weights))
    calls = _spy_post_process(monkeypatch, det_mod)
    monkeypatch.chdir(tmp_path)
    det = det_mod.Detect(_args(root, weights, ver=ver, mode=mode,
                               img_size=96, conf_thres=conf, dtype="int8"))
    got = det.detect()
    assert len(calls) == 2 and sum(len(d) for _, d in got) > 0
    a = ((3, 2, conf, IOU) if mode == "csl"
         else (18, _kfiou_anchors(), STRIDES, conf, IOU))
    for dec, heads, (d, v) in calls:
        assert all(h.dtype == torch.bfloat16 for h in heads)
        heads = tuple(jnp.asarray(h.float().permute(0, 2, 3, 1).numpy())
                      for h in heads)
        if mode == "csl":
            wd, wv = j_pp(jnp.asarray(dec.numpy()), heads, *a)
            exact, close, tol = [0, 1, 2, 3, 5, 6], [4], dict(atol=1e-6)
        else:
            wd, wv = j_kpp(tuple(jnp.asarray(s.numpy()) for s in dec),
                           heads, *a)
            exact, close, tol = [5, 6], [0, 1, 2, 3, 4], dict(rtol=1e-6,
                                                              atol=1e-4)
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(d.numpy()[..., exact],
                                      np.asarray(wd)[..., exact])
        np.testing.assert_allclose(d.numpy()[..., close],
                                   np.asarray(wd)[..., close], **tol)
    for _, d in got:
        assert d.dtype == np.float32 and (d[:, 5] > conf).all()
    model, dtype = det._build_model(2, {"model": MODEL_CFG},
                                    torch.device("cpu"))
    assert dtype == torch.bfloat16
    assert sum(isinstance(m, Int8Conv) for m in model.modules()) > 20


def test_cuda_without_card_raises(monkeypatch):
    import torch

    from ryolo_tpu_torch.detect import build_parser, resolve_device

    assert build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "ryolo_tpu_torch").rglob("*.py"))
    # the data-parallel package, and the rank bodies the tests spawn
    assert {"__init__.py", "mesh.py", "sync_bn.py", "spatial.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert REPO / "ryolo_tpu_torch" / "display_inputs.py" in files
    files += [REPO / "chip_smoke.py", REPO / "tests" / "torch_dp_ranks.py",
              REPO / "tests" / "torch_sp_ranks.py",
              REPO / "scripts" / "torch_dp_grad_probe.py",
              REPO / "scripts" / "torch_sp_memory.py",
              REPO / "scripts" / "torch_obb_profile.py"]
    assert len(files) > 15
    banned = {"jax", "jaxlib", "flax", "optax", "ryolo_tpu"}
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f}: imports {mod}"
