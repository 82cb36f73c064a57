"""Port rotated NMS (plain mask + plain scan, the CPU path) against the JAX
package's ``nms_rotated_masked(..., pallas=False)``.

The same numpy inputs go through both; ``order`` and ``keep`` must be
equal.  The orientation test places one pair whose IoU differs by box role
(``IoU(a, b) != IoU(b, a)`` at the ulp level) in one chunk and then in two,
with the threshold between the two values: JAX takes ``IoU(box1=e,
box2=r)`` within a chunk and ``IoU(box1=r, box2=e)`` across chunks, and so
must the port.  The CUDA kernels are held to these plain versions in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import limit_threads

FAR = 1e4  # filler boxes: far from the pair and from each other


@pytest.fixture(autouse=True)
def _threads():
    limit_threads()


def _clustered(rng, b, k, n_clusters=6, spread=12.0, classes=1):
    """Clustered boxes (long suppression chains), scores and valid flags."""
    boxes = np.zeros((b, k, 5), np.float32)
    centres = rng.uniform(0, 300, (b, n_clusters, 2))
    pick = rng.integers(0, n_clusters, (b, k))
    boxes[..., :2] = (np.take_along_axis(centres, pick[..., None], 1)
                      + rng.normal(0, spread, (b, k, 2)))
    boxes[..., 2:4] = rng.uniform(10, 50, (b, k, 2))
    boxes[..., 4] = rng.uniform(-90, 90, (b, k))
    boxes[..., :2] += rng.integers(0, classes, (b, k, 1)) * 4096.0
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    return boxes, scores, scores > 0.15


def _presort(boxes, scores, valid):
    o = np.argsort(-np.where(valid, scores, -1.0), axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, o, 1)  # noqa: E731
    return (np.take_along_axis(boxes, o[..., None], 1), take(scores),
            take(valid))


def _jax(boxes, scores, valid, thr, max_keep, presorted):
    from ryolo_tpu.ops.rotated_nms import nms_rotated_masked

    out = [nms_rotated_masked(jnp.asarray(bx), jnp.asarray(s),
                              jnp.asarray(v), jnp.float32(thr),
                              max_keep=max_keep, presorted=presorted,
                              pallas=False)
           for bx, s, v in zip(boxes, scores, valid)]
    return (np.stack([np.asarray(o) for o, _ in out]),
            np.stack([np.asarray(k) for _, k in out]))


def _port(boxes, scores, valid, thr, max_keep, presorted):
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    o, k = nms_rotated_masked(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), thr,
                              max_keep=max_keep, presorted=presorted)
    return o.numpy(), k.numpy()


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "k_not_multiple_of_64":
        return _clustered(rng, 2, 150) + (0.3, 1500, False)
    if name == "max_keep_mid_chunk":
        return _clustered(rng, 2, 300) + (0.3, 70, False)
    if name == "max_keep_in_first_chunk":
        return _presort(*_clustered(rng, 3, 200)) + (0.4, 25, True)
    if name == "presorted":
        return _presort(*_clustered(rng, 3, 257)) + (0.3, 1500, True)
    if name == "not_presorted_ties":
        boxes, scores, valid = _clustered(rng, 2, 130)
        scores = np.round(scores * 8) / 8  # many equal scores
        return boxes, scores, scores > 0.15, 0.3, 1500, False
    if name == "all_invalid":
        boxes, scores, _ = _clustered(rng, 2, 100)
        return boxes, scores, np.zeros((2, 100), bool), 0.3, 1500, False
    if name == "k_1":
        boxes, scores, _ = _clustered(rng, 2, 1)
        return boxes, scores, np.array([[True], [False]]), 0.3, 1500, False
    if name == "invalid_rows_inside_valid_prefix":
        # presorted, and JAX honours valid per row: invalid rows within the
        # valid prefix are never kept and never suppress; a valid row past
        # 64 * ceil(#valid / 64) is not decided
        boxes, scores, valid = _presort(*_clustered(rng, 2, 200))
        valid = np.zeros_like(valid)
        valid[0, :140] = True
        valid[0, [3, 64, 100]] = False
        valid[1, :70] = True
        valid[1, [10, 11, 63]] = False
        valid[1, 150] = True  # 68 valid: rows 0..127 decided
        return boxes, scores, valid, 0.3, 1500, True
    if name == "class_offset_centres":
        return _clustered(rng, 2, 260, classes=16) + (0.25, 1500, False)
    raise KeyError(name)


CASES = ["k_not_multiple_of_64", "max_keep_mid_chunk",
         "max_keep_in_first_chunk", "presorted", "not_presorted_ties",
         "all_invalid", "k_1", "invalid_rows_inside_valid_prefix",
         "class_offset_centres"]


@pytest.mark.parametrize("name", CASES)
def test_nms_matches_jax(name):
    boxes, scores, valid, thr, max_keep, presorted = _case(name)
    if name == "class_offset_centres":
        assert boxes[..., :2].max() > 15 * 4096
    want = _jax(boxes, scores, valid, thr, max_keep, presorted)
    got = _port(boxes, scores, valid, thr, max_keep, presorted)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1].sum(1) <= max_keep).all()
    if name.startswith("max_keep"):
        assert (got[1].sum(1) == max_keep).all()
    if name == "all_invalid":
        assert not got[1].any()
    if name == "invalid_rows_inside_valid_prefix":
        assert not got[1][0, [3, 64, 100]].any() and not got[1][1, 150]


def _asymmetric_pair():
    """Boxes a, b that overlap and whose plain IoU differs most by box role
    among seeded boxes (8 float32 steps here), and the threshold halfway.
    The asymmetry must beat the few steps by which JAX's jitted IoU rounds
    apart from its eager form (XLA's fusion), so that JAX is a reference at
    this threshold."""
    from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain

    boxes = _clustered(np.random.default_rng(0), 1, 64, n_clusters=2)[0][0]
    t = torch.from_numpy(boxes)[None]
    iou = pairwise_rotated_iou_plain(t, t)[0].numpy()  # [box1, box2]
    lo, hi = np.minimum(iou, iou.T), np.maximum(iou, iou.T)
    gap = np.where((lo > 0.1) & (hi < 0.9), hi - lo, 0.0)
    i, j = np.unravel_index(np.argmax(gap), gap.shape)
    assert gap[i, j] > 0, "no asymmetric pair among the seeded boxes"
    thr = float(np.float32((np.float64(iou[i, j]) + iou[j, i]) / 2))
    return boxes[i], boxes[j], iou[i, j], iou[j, i], thr


def _placed(a, b, gap):
    """``a`` at row 0, ``b`` at row ``gap``, far fillers around them,
    descending scores."""
    k = gap + 66
    boxes = np.zeros((1, k, 5), np.float32)
    boxes[0, :, 0] = FAR + 200.0 * np.arange(k)
    boxes[0, :, 1] = 3 * FAR
    boxes[0, :, 2:4] = (20.0, 10.0)
    boxes[0, 0], boxes[0, gap] = a, b
    scores = np.linspace(1.0, 0.5, k, dtype=np.float32)[None]
    return boxes, scores, np.ones((1, k), bool)


@pytest.mark.parametrize("gap", [1, 65])
def test_nms_orientation_follows_jax(gap):
    """Same chunk (gap 1): b is suppressed iff IoU(box1=a, box2=b) > thr.
    Across chunks (gap 65): iff IoU(box1=b, box2=a) > thr."""
    a, b, iou_ab, iou_ba, thr = _asymmetric_pair()
    assert iou_ab != iou_ba and min(iou_ab, iou_ba) < thr < max(iou_ab, iou_ba)
    boxes, scores, valid = _placed(a, b, gap)
    got = _port(boxes, scores, valid, thr, 1500, True)
    want = _jax(boxes, scores, valid, thr, 1500, True)
    np.testing.assert_array_equal(got[1], want[1])
    value = iou_ab if gap < 64 else iou_ba
    assert got[1][0, gap] == (not value > thr)
    assert got[1][0, :gap].all() and got[1][0, gap + 1:].all()


def test_mask_plain_bits_follow_the_stated_orientation():
    from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain
    from ryolo_tpu_torch.ops.rotated_nms import decided_rows, nms_mask_plain

    boxes = _clustered(np.random.default_rng(5), 2, 150)[0]
    valid = np.arange(150)[None, :] < np.array([[150], [100]])
    thr = 0.3
    sboxes, svalid = torch.from_numpy(boxes), torch.from_numpy(valid)
    n_rows = decided_rows(svalid)
    assert n_rows.tolist() == [150, 128]
    mask = nms_mask_plain(sboxes, n_rows, thr)
    assert mask.shape == (2, 150, 3)
    bits = ((mask[..., None] >> torch.arange(64)) & 1).bool().flatten(2)
    bits = bits[..., :150].numpy()  # [b, r, e]
    iou = pairwise_rotated_iou_plain(sboxes, sboxes).numpy()  # [b, box1, box2]
    r = np.arange(150)[:, None]
    e = np.arange(150)[None, :]
    same = (r // 64) == (e // 64)
    for i, lim in enumerate(n_rows.tolist()):
        want = np.where(same, iou[i].T, iou[i]) > np.float32(thr)
        want &= (e < r) & (r < lim)
        np.testing.assert_array_equal(bits[i], want)
    assert bits.any() and not bits[1, 128:].any()


def test_cpu_nms_launches_nothing_and_launchers_refuse_cpu_tensors():
    from ryolo_tpu_torch.ops import cuda_nms
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    boxes, scores, valid, *_ = _case("k_not_multiple_of_64")
    before = dict(cuda_nms.LAUNCHES)
    nms_rotated_masked(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.3)
    n_rows = torch.tensor([150, 150], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_nms.nms_mask(torch.from_numpy(boxes), n_rows, 0.3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_nms.nms_scan(torch.zeros(2, 150, 3, dtype=torch.int64),
                          torch.from_numpy(valid), n_rows, 1500)
    assert cuda_nms.LAUNCHES == before


def test_bound_counts():
    """The counts chip_smoke.py bounds the kernels with, on a hand case."""
    from chip_smoke import pair_counts, scan_words

    boxes = torch.zeros(1, 130, 5)
    boxes[0, :, 0] = 100.0 * torch.arange(130)  # 100 px apart: all far
    boxes[0, :, 2:4] = 10.0
    boxes[0, 1, :2] = boxes[0, 0, :2] + 5.0     # one near pair
    valid = torch.ones(1, 130, dtype=torch.bool)
    valid[0, 129] = False
    n_rows = torch.tensor([130], dtype=torch.int32)
    assert pair_counts(boxes, valid, n_rows) == (129 * 128 // 2, 1)
    keep = torch.ones(1, 130, dtype=torch.bool)
    # chunks 0, 1, 2 hold 64, 64, 2 rows and read 1, 2, 3 words a row
    assert scan_words(keep, n_rows, 1500) == 64 + 128 + 6
    assert scan_words(keep, n_rows, 64) == 64          # full after chunk 0
    assert scan_words(keep, n_rows, 100) == 64 + 128
