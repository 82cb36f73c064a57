"""``Detect.infer`` on the card: the decode and post-process replayed as
CUDA graphs against the same call run eagerly.

Every test here needs an NVIDIA GPU and nvcc (the NMS kernels) and skips
without them.  The file imports nothing of JAX, so on a machine without
JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

The replayed ``(dets, valid)`` must equal the eager call's bit for bit:
the graphs run the same kernels on the same inputs.  ``chip_smoke.py``'s
seeded weights at 256 px, batch 4, with a score prior on the head biases that
puts 100 or more candidates above conf 0.7 in the fullest image of each
batch, and at most ``SMALL_K`` (the narrow width); at conf 0.001 nearly
every candidate passes (the full width).
"""

from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
NC, SIZE, BATCH = 16, 256, 4
# each head's obj and class channels within an anchor's features
SCORE_CHANNELS = {"csl": slice(4, 5 + NC), "kfiou": slice(5, 6 + NC)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs replay only on the card")
    return torch.device("cuda")


def _head_convs(model):
    return [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)
            and m.out_channels == model.na * model.nf]


def _prior(heads, na, mode, conf=0.7, target=100):
    """The logit shift of every obj and class channel that puts the
    fullest image of each batch (``heads``: a list of batches' head maps)
    at ``target`` candidates or more above ``conf``."""
    scores = []
    for maps in heads:
        obj, cls = [], []
        for h in maps:
            b, c, gh, gw = h.shape
            v = h.float().view(b, na, c // na, gh * gw)
            v = v[:, :, SCORE_CHANNELS[mode]]
            obj.append(v[:, :, 0].reshape(b, -1))
            cls.append(v[:, :, 1:].amax(2).reshape(b, -1))
        scores.append((torch.cat(obj, 1), torch.cat(cls, 1)))

    def count(p):
        return min(int((torch.sigmoid(obj + p) * torch.sigmoid(cls + p)
                        > conf).sum(1).max()) for obj, cls in scores)
    lo, hi = -30.0, 30.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if count(mid) < target else (lo, mid)
    return hi


def _model(cuda, ver, mode, dtype, batches):
    from chip_smoke import init_weights
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference
    from ryolo_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(str(REPO / "configs" / "hyp.yaml"))["model"]
    model = Yolo(NC, cfg, mode=mode, ver=ver)
    # spread logits (PyTorch's own init gives head maps of ~1e-6)
    init_weights(model, torch.Generator().manual_seed(0))
    model = fuse_for_inference(model.eval(), dtype=dtype, device=cuda)
    with torch.no_grad():
        heads = [model((torch.from_numpy(images).to(cuda).permute(0, 3, 1, 2)
                        .float() / 255.0).to(dtype)) for images in batches]
        p = _prior(heads, model.na, mode)
        for conv in _head_convs(model):
            bias = conv.bias.view(model.na, model.nf)
            bias[:, SCORE_CHANNELS[mode]] += p
    assert len(_head_convs(model)) == 3
    return model


def _eager(model, heads, conf, iou):
    """The call's decode and post-process, eagerly on the card."""
    from ryolo_tpu_torch.eval.postprocess import (post_process_defer,
                                                  post_process_kfiou_defer)
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_csl_defer, decode_kfiou_scores

    with torch.no_grad():
        if model.mode == "csl":
            dec = decode_csl_defer(heads, model.anchors, STRIDES, NC)
            return post_process_defer(dec, heads, model.na, NC, conf, iou)
        scores = decode_kfiou_scores(heads, model.na, NC)
        return post_process_kfiou_defer(scores, heads, model.na,
                                        model.anchors, STRIDES, conf, iou)


@pytest.mark.parametrize("conf,iou,width", [(0.001, 0.65, "full"),
                                            (0.7, 0.2, "small")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ver,mode", [("yolov5", "csl"),
                                      ("yolov7", "kfiou")])
def test_graphs_equal_eager(cuda, ver, mode, dtype, conf, iou, width):
    """Three distinct batches, the first again (a stale static buffer
    would show), then a smaller last batch (a capture of its own): each
    call's ``(dets, valid)`` equal the eager decode and post-process of
    the same head maps, kept results stay as they were, the model's hook
    fires every call, one ``nms_mask`` and one ``nms_scan`` launch a
    call, four replays a call, and captures only at a signature's or a
    width's first call."""
    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.eval.postprocess import SMALL_K
    from ryolo_tpu_torch.ops import _build
    from ryolo_tpu_torch.ops.cuda_nms import LAUNCHES
    from ryolo_tpu_torch.utils import trace

    _build.build(["rotated_nms"])
    rng = np.random.default_rng(7)
    distinct = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
                for _ in range(3)]
    batches = distinct + [distinct[0], distinct[1][:BATCH - 1]]
    model = _model(cuda, ver, mode, dtype, distinct)
    seen = []
    model.register_forward_hook(
        lambda _m, _i, out: seen.append([h.clone() for h in out]))
    det = Detect(Namespace(conf_thres=conf, nms_thres=iou))
    kept = []
    for i, images in enumerate(batches):
        before = dict(LAUNCHES)
        captures = trace.COUNTS["graph.capture"]
        replays = trace.COUNTS["graph.replay"]
        tails = {id(c): len(c.tails) for c in det._chains.values()}
        dets, valid = det.infer(model, images, dtype, cuda, NC,
                                _Stages(cuda))
        assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == \
            {"nms_mask": 1, "nms_scan": 1}
        assert trace.COUNTS["graph.replay"] - replays == 4
        torch.cuda.synchronize()
        assert len(seen) == i + 1, "the model's forward hook did not fire"
        w_dets, w_valid = _eager(model, seen[-1], conf, iou)
        assert torch.equal(valid, w_valid) and torch.equal(dets, w_dets), i
        assert int(valid.sum()) > 0
        # (a) and (b) at a signature's first call, (c_k) and (d_k) at a
        # width's first call of the signature
        new_signatures = len(det._chains) - len(tails)
        new_widths = sum(len(c.tails) - tails.get(id(c), 0)
                         for c in det._chains.values())
        captured = trace.COUNTS["graph.capture"] - captures
        assert captured == 2 * new_signatures + 2 * new_widths, i
        if i == 3:  # the first batch again
            assert captured == 0
        kept.append((dets, valid, dets.cpu(), valid.cpu()))
        for d, v, d_host, v_host in kept:
            assert torch.equal(d.cpu(), d_host)
            assert torch.equal(v.cpu(), v_host)
    assert len(det._chains) == 2  # batches of 4 and of 3
    widths = {k for c in det._chains.values() for k in c.tails}
    assert (widths == {SMALL_K}) == (width == "small"), widths


def test_threshold_compares_in_float32_on_the_card(cuda):
    """A threshold a quarter ulp below a candidate's float32 score: the
    candidate does not pass, on the card as on the CPU."""
    from ryolo_tpu_torch.eval.postprocess import select_scores

    conf = torch.rand(2, 4000, generator=torch.Generator().manual_seed(3))
    s = float(conf[0, 17])
    thres = s - 0.25 * float(np.spacing(np.float32(s)))
    cls = torch.zeros_like(conf, dtype=torch.int32)
    cpu = select_scores((conf, cls), thres)[1]
    card = select_scores((conf.to(cuda), cls.to(cuda)), thres)[1].cpu()
    assert torch.equal(cpu, card) and cpu[0, 17] == -1.0


def _obb_model(cuda, dtype, batches, conf):
    """YOLO11l-OBB, ``init_weights``, fused; at conf 0.7 its class biases
    shifted so that the fullest image of each batch has 100 or more
    candidates above it, as :func:`_prior` does for the anchor heads."""
    from chip_smoke import init_weights
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference

    model = Yolo(NC, {}, mode="obb", ver="yolo11")
    init_weights(model, torch.Generator().manual_seed(0))
    model = fuse_for_inference(model.eval(), dtype=dtype, device=cuda)
    if conf < 0.5:
        return model
    with torch.no_grad():
        cls = [torch.cat([h.float().flatten(2)[:, 64:64 + NC] for h in
                          model((torch.from_numpy(images).to(cuda)
                                 .permute(0, 3, 1, 2).float() / 255.0)
                                .to(dtype))], 2).amax(1)
               for images in batches]

        def count(p):
            return min(int((torch.sigmoid(c + p) > conf).sum(1).max())
                       for c in cls)
        lo, hi = -30.0, 30.0
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if count(mid) < 100 else (lo, mid)
        for branch in model.head.cv3:
            branch[2].bias += hi
    return model


@pytest.mark.parametrize("conf,iou,width", [(0.001, 0.65, "full"),
                                            (0.7, 0.2, "small")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_obb_graphs_equal_eager(cuda, dtype, conf, iou, width):
    """YOLO11l-OBB's chain (score decode; selection and count; top-k with
    the deferred DFL box decode and the NMS inputs; compaction): four
    replays a call, equal to the eager ``post_process_obb_defer`` of the
    same head maps bit for bit, ``obb.box_decode`` counted as ``B * k``
    at every call, one ``nms_mask`` and one ``nms_scan`` launch a call."""
    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.eval.postprocess import (MAX_NMS, SMALL_K,
                                                  post_process_obb_defer)
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_obb_scores
    from ryolo_tpu_torch.ops import _build
    from ryolo_tpu_torch.ops.cuda_nms import LAUNCHES
    from ryolo_tpu_torch.utils import trace

    _build.build(["rotated_nms"])
    rng = np.random.default_rng(11)
    distinct = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
                for _ in range(3)]
    batches = distinct + [distinct[0], distinct[1][:BATCH - 1]]
    model = _obb_model(cuda, dtype, distinct, conf)
    seen = []
    model.register_forward_hook(
        lambda _m, _i, out: seen.append([h.clone() for h in out]))
    det = Detect(Namespace(conf_thres=conf, nms_thres=iou))
    n = sum((SIZE // s) ** 2 for s in STRIDES)
    k = SMALL_K if width == "small" else min(MAX_NMS, n)
    for i, images in enumerate(batches):
        before = dict(LAUNCHES)
        replays = trace.COUNTS["graph.replay"]
        decodes = trace.COUNTS["obb.box_decode"]
        dets, valid = det.infer(model, images, dtype, cuda, NC,
                                _Stages(cuda))
        assert {key: LAUNCHES[key] - before[key] for key in LAUNCHES} == \
            {"nms_mask": 1, "nms_scan": 1}
        assert trace.COUNTS["graph.replay"] - replays == 4
        assert trace.COUNTS["obb.box_decode"] - decodes == len(images) * k
        torch.cuda.synchronize()
        with torch.no_grad():
            w_dets, w_valid = post_process_obb_defer(
                decode_obb_scores(seen[-1], NC), seen[-1], NC, STRIDES,
                conf, iou)
        assert torch.equal(valid, w_valid) and torch.equal(dets, w_dets), i
        assert int(valid.sum()) > 0
    assert len(det._chains) == 2  # batches of 4 and of 3
    assert {w for c in det._chains.values() for w in c.tails} == {k}
