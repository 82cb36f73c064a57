"""The frozen roofline counters on cases worked by hand."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import peaks, roofline  # noqa: E402


def test_decided_rows():
    valid = torch.zeros(4, 130, dtype=torch.bool)
    for b, n in enumerate((0, 1, 64, 65)):
        valid[b, :n] = True
    assert roofline.decided_rows(valid).tolist() == [0, 64, 64, 128]


@pytest.mark.parametrize("apart,near", [(500.0, 0), (3.0, 1)])
def test_mask_bound_two_boxes(apart, near):
    # two 10 x 4 boxes: circles of radius ~5.39 meet at 3 px, not at 500
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 4.0, 0.0],
                           [apart, 0.0, 10.0, 4.0, 30.0]]])
    valid = torch.ones(1, 2, dtype=torch.bool)
    t, counts = roofline.mask_bound(boxes, valid)
    assert counts == {"pairs": 1, "near": near, "words": 2}
    ops = 12 + near * 214 + 2 * (10 + 74)
    nbytes = 2 * 20 + 2 * 8 + 4
    assert t == max(ops / peaks.FLOPS["float32"], nbytes / peaks.BYTES_PER_S)


def test_scan_words():
    keep = torch.zeros(1, 130, dtype=torch.bool)
    n_rows = torch.tensor([128])
    # chunk 0 reads 1 word a row, chunk 1 two, 64 rows each
    assert roofline.scan_words(keep, n_rows, 1500) == 64 * 1 + 64 * 2
    keep[0, 0] = True  # the cap reached in chunk 0: chunk 1 not visited
    assert roofline.scan_words(keep, n_rows, 1) == 64
    valid = torch.zeros(1, 130, dtype=torch.bool)
    valid[0, :100] = True
    nbytes = 64 * 8 + 128 + 130 + 4
    assert roofline.scan_bound(keep, valid, 1) == nbytes / peaks.BYTES_PER_S


def test_render_bound_identity():
    # one 4 x 4 spec, one slot over the whole canvas, identity affine, no
    # gains: taps owned 16 + 12 + 12 + 9 (the +1 taps leave the region on
    # the last column or row), 16 distinct words
    spec = {"region": np.array([[[0, 0, 4, 4]]], np.float32),
            "offset": np.zeros((1, 1, 2), np.float32),
            "hsv": np.ones((1, 1, 3), np.float32),
            "minv": np.array([[[1, 0, 0], [0, 1, 0]]], np.float32),
            "mix_idx": np.array([-1], np.int32)}
    t = roofline.render_bound(4, np.zeros((1, 1), np.int64), spec, 1, "cpu")
    ops = 44 * 16 + 6 * 49 + 3 * 16
    nbytes = 16 * 4 + (10 + 10) * 4 + 3 * 16 * 4
    assert t == max(ops / peaks.FLOPS["float32"], nbytes / peaks.BYTES_PER_S)
