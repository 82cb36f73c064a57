"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports nothing of JAX, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bounds: tests/test_pallas_iou.py's (fewer than 5e-4 of pairs off by more
than 1e-3, median difference below 1e-6).
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
