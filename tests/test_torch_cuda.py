"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports nothing of JAX, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bounds: tests/test_pallas_iou.py's (fewer than 5e-4 of pairs off by more
than 1e-3, median difference below 1e-6).  The NMS mask kernel may differ
from its plain version only on knife-edge pairs (plain IoU within 1e-5 of
the threshold: sincosf and the CPU's sin/cos may round one ulp apart); the
scan kernel equals its plain version exactly on the same mask.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def rand_boxes(b, n, seed, spread=60.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([
        rng.uniform(0, spread, (b, n)), rng.uniform(0, spread, (b, n)),
        rng.uniform(2, 40, (b, n)), rng.uniform(2, 40, (b, n)),
        rng.uniform(-180, 180, (b, n))], -1).astype(np.float32))


def _within_bounds(got, want):
    diff = (got.cpu() - want.cpu()).abs()
    assert (diff > 1e-3).float().mean() < 5e-4, diff.max()
    assert diff.median() < 1e-6


@pytest.mark.parametrize("b,n,m", [(8, 64, 64), (8, 64, 1564), (2, 130, 257),
                                   (1, 1, 1)])
def test_kernel_matches_plain_version(cuda, b, n, m):
    from ryolo_tpu_torch.ops.cuda_iou import LAUNCHES, pairwise_rotated_iou

    b1, b2 = rand_boxes(b, n, 1), rand_boxes(b, m, 2)
    before = LAUNCHES["rotated_iou"]
    got = pairwise_rotated_iou(b1.to(cuda), b2.to(cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["rotated_iou"] == before + 1
    _within_bounds(got, pairwise_rotated_iou(b1, b2))


def test_kernel_probes(cuda):
    from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou

    b = rand_boxes(1, 32, 3).to(cuda)
    assert torch.allclose(torch.diagonal(pairwise_rotated_iou(b, b)[0]),
                          torch.ones(32, device=cuda), atol=1e-5)
    z = b.clone()
    z[..., 2:4] = 0.0
    assert torch.all(pairwise_rotated_iou(z, b) == 0)
    s1, s2 = rand_boxes(1, 64, 4, 30.0), rand_boxes(1, 64, 5, 30.0)
    s1[..., :2] += 15 * 4096.0
    s2[..., :2] += 15 * 4096.0
    _within_bounds(pairwise_rotated_iou(s1.to(cuda), s2.to(cuda)),
                   pairwise_rotated_iou(s1, s2))


def test_kernel_raises_instead_of_falling_back(cuda):
    from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou

    b = rand_boxes(1, 4, 6)
    with pytest.raises(ValueError):
        pairwise_rotated_iou(b.to(cuda), b)  # mixed devices
    with pytest.raises(TypeError):
        pairwise_rotated_iou(b.to(cuda).half(), b.to(cuda).half())


def test_nms_on_card_equals_cpu(cuda):
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    rng = np.random.default_rng(7)
    k = 500
    boxes = np.zeros((2, k, 5), np.float32)
    boxes[..., :2] = rng.uniform(0, 200, (2, k, 2))
    boxes[..., 2:4] = rng.uniform(10, 50, (2, k, 2))
    boxes[..., 4] = rng.uniform(-90, 90, (2, k))
    scores = rng.uniform(0, 1, (2, k)).astype(np.float32)
    args = [torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(scores > 0.1)]
    o_cpu, k_cpu = nms_rotated_masked(*args, 0.3, max_keep=100)
    o_gpu, k_gpu = nms_rotated_masked(*[a.to(cuda) for a in args], 0.3,
                                      max_keep=100)
    assert torch.equal(o_cpu, o_gpu.cpu())
    assert torch.equal(k_cpu, k_gpu.cpu())


# -- the NMS kernels (nms_mask, nms_scan) ------------------------------------
# Inputs, probes and the bit comparison are chip_smoke.py's (phase 3).

@pytest.mark.parametrize("b,k,n_valid,thr", [(3, 300, 300, 0.3),
                                             (2, 700, 450, 0.65),
                                             (1, 1, 1, 0.3)])
def test_nms_kernels_match_plain_versions(cuda, b, k, n_valid, thr):
    from chip_smoke import mask_bits, mask_iou, nms_candidates
    from ryolo_tpu_torch.ops import cuda_nms
    from ryolo_tpu_torch.ops.rotated_nms import (decided_rows, nms_mask_plain,
                                                 nms_scan_plain)

    boxes, valid = nms_candidates(torch.Generator().manual_seed(k), b, k,
                                  [k] * (b - 1) + [n_valid])
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    n_rows = decided_rows(valid)
    before = dict(cuda_nms.LAUNCHES)
    mask = cuda_nms.nms_mask(boxes, n_rows, thr)
    torch.cuda.synchronize()
    plain = nms_mask_plain(boxes, n_rows, thr)
    diff = (mask_bits(mask, n_rows) ^ mask_bits(plain, n_rows)).nonzero()
    if len(diff):  # knife-edge pairs only
        assert ((mask_iou(boxes, diff) - thr).abs() <= 1e-5).all()
    for m in (1500, 40):
        keep = cuda_nms.nms_scan(mask, valid, n_rows, m)
        torch.cuda.synchronize()
        assert torch.equal(keep, nms_scan_plain(mask, valid, n_rows, m))
    assert cuda_nms.LAUNCHES == {"nms_mask": before["nms_mask"] + 1,
                                 "nms_scan": before["nms_scan"] + 2}


def test_nms_far_reject_probes(cuda):
    """Pairs where the far reject must not change a bit (circles at the
    margin and just inside it, touching, overlapping by 5e-5 px, identical,
    theta + 180), in one chunk and across chunks."""
    from chip_smoke import mask_bits, reject_probes
    from ryolo_tpu_torch.ops import cuda_nms
    from ryolo_tpu_torch.ops.rotated_nms import decided_rows, nms_mask_plain

    boxes = reject_probes().to(cuda)
    n_rows = decided_rows(torch.ones(boxes.shape[:2], dtype=torch.bool,
                                     device=cuda))
    for thr in (1e-3, 0.5):
        got = mask_bits(cuda_nms.nms_mask(boxes, n_rows, thr), n_rows)
        want = mask_bits(nms_mask_plain(boxes, n_rows, thr), n_rows)
        assert torch.equal(got, want), (got ^ want).nonzero()


def test_nms_kernels_at_max_k(cuda):
    """The scan's shared memory holds MAX_K / 64 words: both kernels launch
    at K = MAX_K (64 rows decided), and one chunk more is refused."""
    from ryolo_tpu_torch.ops import cuda_nms

    k = cuda_nms.MAX_K
    boxes = torch.zeros(1, k, 5, device=cuda)
    boxes[0, :, 0] = 10.0 * torch.arange(k, device=cuda)  # IoU 0.6 in a row
    boxes[0, :, 2:4] = 40.0
    valid = torch.zeros(1, k, dtype=torch.bool, device=cuda)
    valid[0, :64] = True
    n_rows = torch.tensor([64], dtype=torch.int32, device=cuda)
    keep = cuda_nms.nms_scan(cuda_nms.nms_mask(boxes, n_rows, 0.3), valid,
                             n_rows, 1500)
    torch.cuda.synchronize()
    small = cuda_nms.nms_scan(cuda_nms.nms_mask(boxes[:, :64].contiguous(),
                                                n_rows, 0.3),
                              valid[:, :64].contiguous(), n_rows, 1500)
    assert torch.equal(keep[:, :64], small) and not keep[:, 64:].any()
    assert 0 < int(small.sum()) < 64
    with pytest.raises(ValueError, match="K <="):
        cuda_nms.nms_mask(torch.zeros(1, k + 64, 5, device=cuda), n_rows, 0.3)


def test_nms_raises_instead_of_falling_back(cuda, monkeypatch, tmp_path):
    from chip_smoke import nms_candidates
    from ryolo_tpu_torch.ops import _build, cuda_nms
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    boxes, valid = nms_candidates(torch.Generator().manual_seed(0), 1, 70,
                                  [70])
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    n_rows = torch.tensor([70], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_nms.nms_mask(boxes.double(), n_rows, 0.3)
    with pytest.raises(ValueError):
        cuda_nms.nms_mask(boxes, n_rows.cpu(), 0.3)  # mixed devices
    with pytest.raises(ValueError):
        cuda_nms.nms_scan(torch.zeros(1, 70, 1, dtype=torch.int64,
                                      device=cuda), valid, n_rows, 10)
    # a kernel that does not build raises; nothing falls back to the CPU
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nms_rotated_masked(boxes[0], valid[0].float(), valid[0], 0.3)


# -- the canvas warp kernel (B2) --------------------------------------------
# Bound: tests/test_pallas_warp.py:32-36 (max |diff| <= 1, at most 1e-3 of
# values differ); the kernel rounds as the plain version does, so exact
# agreement is expected.

def _warp_inputs(b, s, seed):
    rng = np.random.default_rng(seed)
    c = 2 * s + 2
    canvas = torch.from_numpy(rng.integers(0, 256, (b, 3, c, c),
                                           dtype=np.uint8))
    th = rng.uniform(-np.pi / 4, np.pi / 4, b)
    sc = rng.uniform(0.5, 1.6, b)
    minv = np.zeros((b, 2, 3), np.float32)
    minv[:, 0, 0] = np.cos(th) / sc
    minv[:, 0, 1] = -np.sin(th) / sc
    minv[:, 1, 0] = np.sin(th) / sc
    minv[:, 1, 1] = np.cos(th) / sc
    minv[:, :, 2] = rng.uniform(-0.3 * s, 2.2 * s, (b, 2))
    minv[0] = [[1, 0, 0], [0, 1, 0]]                       # identity
    if b > 1:
        minv[1] = [[1, 0, 9000], [0, 1, -9000]]            # off the canvas
    if b > 2:
        minv[2] = [[2.9, -2.7, 60.0], [2.6, 3.1, -40.0]]   # no span bound
    if b > 3:
        minv[3] = [[1, 0, -31.5], [0, 1, c - 32.5]]        # canvas edge
    active = torch.from_numpy((np.arange(b) % 5 != 4).astype(np.int32))
    return canvas, torch.from_numpy(minv), active


def _warp_equal(got, want):
    diff = (got.cpu() - want.cpu()).abs()
    assert diff.max() <= 1.0, diff.max()
    assert (diff > 0).float().mean() <= 1e-3


@pytest.mark.parametrize("b,s", [(12, 800), (6, 64), (3, 33), (1, 1)])
def test_warp_kernel_matches_plain_version(cuda, b, s):
    from ryolo_tpu_torch.ops.cuda_warp import LAUNCHES, warp_canvas

    canvas, minv, active = _warp_inputs(b, s, b * 1000 + s)
    before = LAUNCHES["warp"]
    got = warp_canvas(canvas.to(cuda), minv.to(cuda), s, active.to(cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["warp"] == before + 1
    want = warp_canvas(canvas, minv, s, active)
    _warp_equal(got, want)
    assert (got[active == 0] == 114.0).all()


def test_warp_kernel_raises_instead_of_falling_back(cuda):
    from ryolo_tpu_torch.ops.cuda_warp import warp_canvas

    canvas, minv, active = _warp_inputs(2, 16, 0)
    with pytest.raises(ValueError):
        warp_canvas(canvas.to(cuda), minv, 16)  # mixed devices
    with pytest.raises(TypeError):
        warp_canvas(canvas.to(cuda).float(), minv.to(cuda), 16)


@pytest.mark.parametrize("method", ["taps", "canvas"])
def test_render_on_card_equals_cpu(cuda, method):
    """A spec batch of mosaic-4 layout rendered on the card (the render
    kernel, or the canvas route's warp kernel) and on the CPU (the plain
    versions): same images."""
    from ryolo_tpu_torch.data.device_augment import render_batch

    rng = np.random.default_rng(3)
    s, b, t = 64, 3, 9
    tiles = rng.integers(0, 1 << 24, (b, t, s, s)).astype(np.int32)
    region = np.zeros((b, t, 4), np.float32)
    offset = np.zeros((b, t, 2), np.float32)
    for k in range(4):
        x, y = (k & 1) * s, (k >> 1) * s
        region[:, k] = [x, y, x + s, y + s]
        offset[:, k] = [x, y]
    hsv = (1 + rng.uniform(-1, 1, (b, t, 3)) * [0.015, 0.7, 0.4]).astype(
        np.float32)
    minv = np.tile(np.array([[1.3, 0.2, 3.0], [-0.2, 1.3, 5.0]], np.float32),
                   (b, 1, 1))
    batch = dict(spec_tiles=tiles, spec_region=region, spec_offset=offset,
                 spec_hsv=hsv, spec_minv=minv,
                 spec_flip=np.array([[1, 0], [0, 1]], bool),
                 spec_mix_idx=np.array([2, -1], np.int32),
                 spec_mix_r=np.array([0.4, 0], np.float32))
    got = render_batch(batch, 2, device=cuda, method=method)
    want = render_batch(batch, 2, device="cpu", method=method)
    _warp_equal(got * 255.0, want * 255.0)


# -- the tap renderer (B2 redesigned) -----------------------------------------
# Inputs are chip_smoke.py's (phase 3): loader-shaped mosaic specs with
# seams, clipped offsets, zero-area slots, identity gains, mixup partners
# and flips.  The kernel repeats the plain version's float32 operations in
# the same order: bit-for-bit equality.

@pytest.mark.parametrize("layout", ["pixel", "bank"])
@pytest.mark.parametrize("b,s", [(12, 800), (6, 64), (3, 33), (1, 1)])
def test_render_kernel_matches_plain_version(cuda, b, s, layout):
    from chip_smoke import render_args, render_inputs
    from ryolo_tpu_torch.ops.cuda_render import LAUNCHES, render_taps
    from ryolo_tpu_torch.ops.render import render_taps_plain

    n_out = {12: 8, 6: 4, 3: 2, 1: 1}[b]
    rows, slot_rows, spec = render_inputs(b, s, n_out, layout, b * 1000 + s,
                                          cuda)
    if b == 6:  # probe affines: far off the canvas, rank one, no span bound
        spec["minv"][1] = [[1, 0, 9e6], [0, 1, -3e7]]
        spec["minv"][2] = [[0.7071, 0.7071, 5], [0.7071, 0.7071, 9]]
        spec["minv"][3] = [[2.9, -2.7, 60.0], [2.6, 3.1, -40.0]]
    args = render_args(spec)
    assert b == 1 or (spec["mix_idx"] >= 0).any()
    before = LAUNCHES["render"]
    got = render_taps(rows, slot_rows, *args, n_out)
    torch.cuda.synchronize()
    assert LAUNCHES["render"] == before + 1
    want = render_taps_plain(rows, slot_rows, *args, n_out)
    assert got.shape == want.shape == (n_out, 3, s, s)
    assert torch.equal(got, want), int((got != want).sum())


def test_render_kernel_raises_instead_of_falling_back(cuda, monkeypatch,
                                                      tmp_path):
    from chip_smoke import render_args, render_inputs
    from ryolo_tpu_torch.data.device_augment import render_specs_banked
    from ryolo_tpu_torch.ops import _build
    from ryolo_tpu_torch.ops.cuda_render import render_taps

    rows, slot_rows, spec = render_inputs(3, 16, 2, "bank", 0, cuda)
    args = render_args(spec)
    with pytest.raises(TypeError):
        render_taps(rows.float(), slot_rows, *args, 2)
    bad = slot_rows.copy()
    bad[0, 0] = rows.shape[0]  # past the bank, in a live slot
    with pytest.raises(ValueError, match="slot rows"):
        render_taps(rows, bad, *args, 2)
    wide = [np.concatenate([a, a], 1) for a in args[:3]]
    with pytest.raises(ValueError, match="tile slots"):
        render_taps(rows, np.concatenate([slot_rows] * 2, 1), *wide,
                    *args[3:], 2)
    # a kernel that does not build raises; nothing falls back to the CPU
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        render_specs_banked(rows, slot_rows, *args, n_out=2)
