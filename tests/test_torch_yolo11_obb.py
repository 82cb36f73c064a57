"""YOLO11l-OBB in the port (``--ver yolo11 --mode obb``) against the plain
reference ``reference_torch/yolo11_obb.py`` on seeded random weights: each
new block, the whole forward, the deploy fold, the decode, the
post-process, ``Detect.infer`` and the CLIs, at 64-128 px, batch 2, on the
CPU.  The reference imports nothing of the port and no JAX."""

import filecmp
import math
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from reference_torch import yolo11_obb as R

REPO = Path(__file__).resolve().parents[1]
NC = 15


@pytest.fixture(autouse=True)
def _threads():
    # several pytest-xdist workers share the host's cores
    torch.set_num_threads(2)


@torch.no_grad()
def _seed(model, seed, logit_std=0.1):
    """LeCun-normal kernels, BatchNorm scales and variances U(0.5, 1.5),
    shifts and means N(0, 0.1) (the benchmark's weights); the bare biased
    head convs' biases N(0, ``logit_std``), so that scores spread."""
    gen = torch.Generator().manual_seed(seed)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            normal(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                normal(m.bias, logit_std)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
            normal(m.bias, 0.1)
            normal(m.running_mean, 0.1)
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                 generator=gen))
    return model.eval()


def _models(seed=0, **kw):
    """(reference, port) with the same seeded weights, train structure."""
    from ryolo_tpu_torch.nn import Yolo

    ref = _seed(R.Yolo11OBB(NC), seed, **kw)
    port = Yolo(NC, {}, mode="obb", ver="yolo11").eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    return ref, port


def _images(size, seed=1, b=2):
    return torch.rand((b, 3, size, size),
                      generator=torch.Generator().manual_seed(seed))


def _maps(size=96, seed=3, b=2):
    """Random head maps with spread box, class and angle logits."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, 64 + NC + 1, size // s, size // s),
                        generator=gen) * 2.0 for s in R.STRIDES]


def _block_pairs():
    from ryolo_tpu_torch.nn import blocks as P

    return {
        "C3k": (lambda: P.C3k(16, 16), lambda: R.C3k(16, 16), 16),
        "C3k2-c3k": (lambda: P.C3k2(16, 32, e=0.25),
                     lambda: R.C3k2(16, 32, e=0.25), 16),
        "C3k2-bottleneck": (lambda: P.C3k2(16, 32, c3k=False),
                            lambda: R.C3k2(16, 32, c3k=False), 16),
        "Attention": (lambda: P.Attention(128, 2),
                      lambda: R.Attention(128, 2), 128),
        "PSABlock": (lambda: P.PSABlock(128, 2), lambda: R.PSABlock(128, 2),
                     128),
        "C2PSA": (lambda: P.C2PSA(256), lambda: R.C2PSA(256), 256),
    }


@pytest.mark.parametrize("name", list(_block_pairs()))
def test_block_matches_reference(name):
    make_port, make_ref, ch = _block_pairs()[name]
    ref = _seed(make_ref(), 5)
    port = make_port().eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn((2, ch, 16, 16), generator=torch.Generator()
                    .manual_seed(6))
    with torch.no_grad():
        got, want = port(x), ref(x)
    # the same float32 operations on the same numbers; 2e-5 absolute (the
    # outputs are O(1)) leaves room for a library that orders the
    # attention's matmul sums otherwise, far below a wrong term
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_yolo11l_structure():
    """Scale l as published: 182 convolutions (8 of them depthwise), 26.17
    M parameters, 231.2 GFLOPs of convolutions an image at 1024 px
    (Ultralytics' table: 26.2 M, 232.0)."""
    from ryolo_tpu_torch.nn import Yolo

    with torch.device("meta"):
        model = Yolo(NC, {}, mode="obb", ver="yolo11")
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 182
    assert sum(c.groups > 1 and c.groups == c.in_channels
               for c in convs) == 8
    assert sum(p.numel() for p in model.parameters()) == 26_170_864
    assert (model.na, model.nf) == (1, 64 + NC + 1)
    flops = []
    for c in convs:
        c.register_forward_hook(lambda m, _i, out: flops.append(
            2 * out.numel() * m.in_channels // m.groups
            * m.kernel_size[0] * m.kernel_size[1]))
    with torch.no_grad():
        heads = model.eval()(torch.empty(1, 3, 1024, 1024, device="meta"))
    assert [tuple(h.shape) for h in heads] == [(1, 80, 128, 128),
                                               (1, 80, 64, 64),
                                               (1, 80, 32, 32)]
    assert abs(sum(flops) / 1e9 - 231.21) < 0.01


def test_forward_matches_reference():
    """The train-structure forward's head maps; ``decode=True`` gives them
    in the reference layout with :func:`decode_obb`'s rows."""
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_obb

    ref, port = _models()
    x = _images(64)
    with torch.no_grad():
        want, got = ref(x), port(x)
        outs, rows = port(x, decode=True)
    for g, w, o in zip(got, want, outs):
        assert g.shape == w.shape
        # as the blocks: the same float32 operations
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)
        assert torch.equal(o, g.permute(0, 2, 3, 1)[:, None])
    assert torch.equal(rows, decode_obb(got, NC, STRIDES))


def _fused_gap(port, ref, x):
    from ryolo_tpu_torch.nn import fuse_for_inference

    fused = fuse_for_inference(port)
    with torch.no_grad():
        got, want = fused(x), ref(x)
    return fused, max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))


def test_fused_forward_matches_reference():
    """The deploy fold (BatchNorm into each conv, the depthwise kernels
    channel by channel, each BatchNorm's own eps 1e-3) within
    ``tests/test_deploy.py``'s 1e-3 of the unfused reference; the same
    fold with eps 1e-5 misses it."""
    ref, port = _models(seed=2)
    with torch.no_grad():
        # variances near eps, where eps shows; the scales kept O(1)
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.mul_(2e-3)
                m.weight.mul_((m.running_var + 1e-3).sqrt())
    port.load_state_dict(ref.state_dict())
    x = _images(64, seed=4)
    fused, gap = _fused_gap(port, ref, x)
    assert any(m.groups > 1 for m in fused.modules()
               if isinstance(m, torch.nn.Conv2d))
    # float32 folds reorder the per-channel scale into the kernel: 1e-3 of
    # the largest logit, as test_deploy.py holds the other models
    assert gap < 1e-3, gap
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eps = 1e-5
    assert _fused_gap(port, ref, x)[1] > 1e-2


def test_deferred_box_equals_full_decode():
    """``deferred_obb_box`` at selected indices equals ``decode_obb``'s
    rows there, to the bit (both from float64, rounded once)."""
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_obb, deferred_obb_box

    maps = _maps(128)
    full = decode_obb(maps, NC, STRIDES)
    n = full.shape[1]
    assert n == 16 * 16 + 8 * 8 + 4 * 4
    idx = torch.stack([torch.randperm(n, generator=torch.Generator()
                                      .manual_seed(b))[:77] for b in range(2)])
    got = deferred_obb_box(maps, idx, NC, STRIDES)
    want = full[..., :5].gather(1, idx[..., None].expand(-1, -1, 5))
    assert torch.equal(got, want)
    assert torch.equal(full[..., 5], torch.ones_like(full[..., 5]))


def _corners_match(a, b, tol):
    """Each ``(4, 2)`` polygon of ``a`` has its four corners in ``b``'s, one
    to one, within ``tol``."""
    d = (a[..., :, None, :] - b[..., None, :, :]).norm(dim=-1)  # (..., 4, 4)
    near = d <= tol
    return bool((near.any(-1).all() and near.any(-2).all()))


def test_port_rows_are_the_reference_boxes():
    """The port's rows ``[x, y, h_u, w_u, -theta_u]`` and the reference's
    Ultralytics ``xywhr`` boxes give the same corner polygons, and the
    class sigmoids agree."""
    from ryolo_tpu_torch.geometry import xywha2xyxyxyxy
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_obb

    maps = _maps(96)
    rows = decode_obb(maps, NC, STRIDES)
    boxes, scores = R.decode(maps, NC)
    port = xywha2xyxyxyxy(rows[..., :5].double())
    ref = R.xywhr2xyxyxyxy(boxes.double())
    # float32 decodes of corners up to ~1,000 px: 1e-3 px is 16 ulps there
    assert _corners_match(port, ref, 1e-3)
    assert not _corners_match(port, ref.flip(-1), 1e-3)  # x and y swapped
    # the class sigmoids: the same float32 operation on the same logits
    np.testing.assert_allclose(rows[..., 6:].numpy(), scores.numpy(),
                               rtol=0, atol=1e-7)


def test_post_process_matches_reference_candidates_and_greedy_nms():
    """``post_process_obb_defer`` on the port's maps: its kept rows are the
    reference's candidates (``compare._match``), the same index set as a
    float64 greedy NMS over them (``tests/oracles.py``), and equal to
    ``post_process_fixed`` on the full decode to the bit."""
    from h100_bench.reference.compare import _match, nms_faults
    from ryolo_tpu_torch.eval.postprocess import (MAX_DET,
                                                  post_process_fixed,
                                                  post_process_obb_defer)
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_obb, decode_obb_scores
    from tests.oracles import nms_oracle

    conf, iou = 0.001, 0.3
    maps = _maps(96, seed=8)
    dets, valid = post_process_obb_defer(decode_obb_scores(maps, NC), maps,
                                         NC, STRIDES, conf, iou)
    fdets, fvalid = post_process_fixed(decode_obb(maps, NC, STRIDES), conf,
                                       iou)
    assert torch.equal(dets, fdets) and torch.equal(valid, fvalid)
    rows, cvalid, boxes = R.candidates(maps, NC, conf)
    assert bool(cvalid.all())  # conf 0.001: every position a candidate
    faults = nms_faults(dets.numpy(), valid.numpy(), rows, cvalid, boxes,
                        iou, MAX_DET)
    assert faults == dict(rows_off=0, overlap=0, missed=0, slots=0)
    for b in range(2):
        got = _match(dets[b][valid[b]], rows[b], cvalid[b])
        want = nms_oracle(boxes[b].double().numpy(),
                          rows[b, :, 5].numpy(), iou)
        assert 1 < len(want) < len(rows[b])
        assert got.tolist() == want.tolist()


def test_detect_infer_on_cpu():
    """``Detect.infer`` on the fused model: the eager decode and
    post-process, ``obb.box_decode`` counted as ``B * k``, no upload."""
    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.eval.postprocess import post_process_obb_defer
    from ryolo_tpu_torch.nn import STRIDES, fuse_for_inference
    from ryolo_tpu_torch.nn.heads import decode_obb_scores
    from ryolo_tpu_torch.utils import trace

    _, port = _models(seed=4, logit_std=1.0)
    model = fuse_for_inference(port)
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               np.uint8)
    seen = []
    model.register_forward_hook(lambda _m, _i, out: seen.append(out))
    before = dict(trace.COUNTS)
    cpu = torch.device("cpu")
    dets, valid = Detect(Namespace(conf_thres=0.001, nms_thres=0.65)).infer(
        model, images, torch.float32, cpu, NC, _Stages(cpu))
    got = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
           if v != before.get(k, 0)}
    n = 8 * 8 + 4 * 4 + 2 * 2
    assert got == {"sync.upload": 1, "obb.box_decode": 2 * n}
    w_dets, w_valid = post_process_obb_defer(
        decode_obb_scores(seen[0], NC), seen[0], NC, STRIDES, 0.001, 0.65)
    assert torch.equal(dets, w_dets) and torch.equal(valid, w_valid)
    assert int(valid.sum()) > 2


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A synthetic dataset (``tests/make_synth_data.py``, two classes) and
    a ``.pth`` of seeded YOLO11-OBB weights."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import save_pth
    from tests import make_synth_data

    root = tmp_path_factory.mktemp("synth")
    make_synth_data.main(str(root), n_images=2, img_size=96)
    ref = _seed(R.Yolo11OBB(2), 0, logit_std=1.0)
    model = Yolo(2, {}, mode="obb", ver="yolo11")
    model.load_state_dict(ref.state_dict())
    weights = root / "y11.pth"
    save_pth(model, str(weights))
    return root, weights


def _cli(root, weights, **kw):
    a = dict(weight_path=str(weights), mode="obb", ver="yolo11",
             conf_thres=0.001, nms_thres=0.65, iou_thres=0.65, batch_size=2,
             img_size=64, data=str(root / "data.yaml"),
             hyp=str(REPO / "configs/hyp.yaml"), ext="png", dtype="f32",
             packed_input=False, device="cpu", max_targets=50)
    a.update(kw)
    return Namespace(**a)


def test_detect_and_test_clis(cli_setup, tmp_path, monkeypatch):
    """``detect`` and ``test`` with ``--ver yolo11 --mode obb`` on a saved
    ``.pth``: the fused model, ``Detect.infer`` and the evaluator; the
    parsers take the flags."""
    from ryolo_tpu_torch.detect import Detect
    from ryolo_tpu_torch.detect import build_parser as detect_parser
    from ryolo_tpu_torch.test import Test
    from ryolo_tpu_torch.test import build_parser as test_parser

    root, weights = cli_setup
    for parser in (detect_parser(), test_parser()):
        a = parser.parse_args(["--ver", "yolo11", "--mode", "obb"])
        assert (a.ver, a.mode) == ("yolo11", "obb")
    monkeypatch.chdir(tmp_path)
    found = Detect(_cli(root, weights)).detect()
    assert len(found) == 2 and all(len(d) > 0 for _, d in found)
    assert all(d.shape[1] == 7 and (d[:, 6] < 2).all() for _, d in found)
    mp, mr, map50, map5095, items = Test(_cli(root, weights,
                                              dtype="bf16")).run()
    assert all(0.0 <= v <= 1.0 for v in (mp, mr, map50, map5095))
    assert items == {}  # no OBB loss in the port yet


def test_train_and_int8_refuse_obb(cli_setup):
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.train.__main__ import Train, build_parser

    args = build_parser().parse_args(["--ver", "yolo11", "--mode", "obb",
                                      "--device", "cpu"])
    with pytest.raises(ValueError, match="not supported yet"):
        Train(args).train()
    _, port = _models()
    with pytest.raises(ValueError, match="int8 is not offered"):
        fuse_for_inference(port, quantize=True)
    with pytest.raises(NotImplementedError, match="OBB head"):
        from ryolo_tpu_torch.nn import Yolo
        Yolo(NC, {}, mode="csl", ver="yolo11")


def test_reference_copies_are_identical():
    """The benchmark's copy of the reference is this file, byte for
    byte, and imports nothing but torch and the standard library."""
    import ast

    a = REPO / "reference_torch" / "yolo11_obb.py"
    assert filecmp.cmp(a, REPO / "h100_bench" / "reference" / "yolo11_obb.py",
                       shallow=False)
    mods = {n.module if isinstance(n, ast.ImportFrom) else al.name
            for n in ast.walk(ast.parse(a.read_text()))
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for al in n.names}
    assert {m.split(".")[0] for m in mods} <= {"__future__", "math", "torch"}
    assert math.isclose(R.EPS, 1e-3)
