"""Port rotated IoU: the plain PyTorch version against the JAX kernel.

The plain version (``ryolo_tpu_torch.ops.rotated_iou``) is pinned to the
Pallas tile kernel run in interpret mode, as tests/test_pallas_iou.py runs
it here, and to the float64 oracle, with that file's bounds; the probes
also hold against the JAX package's XLA form.  The CUDA kernel is pinned
to the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ryolo_tpu.ops.pallas_iou import pairwise_rotated_iou_pallas
from ryolo_tpu.ops.rotated_iou import pairwise_rotated_iou
from tests.oracles import pairwise_iou_oracle
from tests.torch_parity import limit_threads


@pytest.fixture(autouse=True)
def _threads():
    limit_threads()


def rand_boxes(n, seed, spread=60.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(2, 40, n), rng.uniform(2, 40, n),
        rng.uniform(-180, 180, n),
    ], -1).astype(np.float32)


def plain(b1, b2):
    from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain

    return pairwise_rotated_iou_plain(torch.from_numpy(b1)[None],
                                      torch.from_numpy(b2)[None])[0].numpy()


def test_plain_vs_oracle():
    b1, b2 = rand_boxes(40, 0, 30.0), rand_boxes(50, 1, 30.0)
    want = pairwise_iou_oracle(b1, b2)
    assert (want > 0).mean() > 0.1
    np.testing.assert_allclose(plain(b1, b2), want, atol=2e-4)


def test_plain_vs_pallas_interpret():
    b1, b2 = rand_boxes(130, 2), rand_boxes(257, 3)
    want = np.asarray(pairwise_rotated_iou_pallas(
        jnp.asarray(b1), jnp.asarray(b2), tm=16, tn=128, interpret=True))
    diff = np.abs(plain(b1, b2) - want)
    # knife-edge pairs (a vertex within +-eps of a clip line) may resolve
    # differently between two implementations; bound their frequency
    assert np.mean(diff > 1e-3) < 5e-4, np.sort(diff.ravel())[-5:]
    assert np.median(diff) < 1e-6


def test_identical_boxes_diag():
    b = rand_boxes(16, 4)
    np.testing.assert_allclose(np.diag(plain(b, b)), 1.0, atol=1e-5)


def test_theta_vs_theta_plus_180():
    b = rand_boxes(16, 5)
    b180 = b.copy()
    b180[:, 4] += 180.0
    np.testing.assert_allclose(np.diag(plain(b, b180)), 1.0, atol=1e-4)


def test_zero_size_boxes_give_zero():
    """Zero-size (padding) row boxes give 0, as in the JAX kernel.  A
    zero-size COLUMN box against a real row box is ill-defined there too
    (its edges have no normal, so nothing is clipped and the union is
    rounding noise); the NMS only meets it on padded rows it never keeps."""
    b = rand_boxes(8, 6, 20.0)
    z = b.copy()
    z[:, 2:4] = 0.0
    assert np.all(plain(z, b) == 0.0)
    assert np.all(plain(z, z) == 0.0)
    j = np.asarray(pairwise_rotated_iou(jnp.asarray(z), jnp.asarray(b)))
    assert np.all(j == 0.0)


def test_class_offset_centres():
    """Centres moved by class * 4096 (up to 15 * 4096 at nc = 16): the
    re-centring on box2 keeps the IoU right."""
    b1, b2 = rand_boxes(24, 7, 30.0), rand_boxes(24, 8, 30.0)
    shift = np.float32(15 * 4096)
    s1, s2 = b1.copy(), b2.copy()
    s1[:, :2] += shift
    s2[:, :2] += shift
    # the oracle in float64: in float32 it loses these coordinates itself
    want = pairwise_iou_oracle(s1.astype(np.float64), s2.astype(np.float64))
    assert (want > 0).mean() > 0.1
    np.testing.assert_allclose(plain(s1, s2), want, atol=2e-4)
    j = np.asarray(pairwise_rotated_iou(jnp.asarray(s1), jnp.asarray(s2)))
    np.testing.assert_allclose(plain(s1, s2), j, atol=2e-4)


def test_wrapper_on_cpu_takes_plain_version_without_launch():
    from ryolo_tpu_torch.ops.cuda_iou import LAUNCHES, pairwise_rotated_iou

    before = LAUNCHES["rotated_iou"]
    b1 = np.stack([rand_boxes(20, 9), rand_boxes(20, 10)])
    b2 = np.stack([rand_boxes(33, 11), rand_boxes(33, 12)])
    got = pairwise_rotated_iou(torch.from_numpy(b1), torch.from_numpy(b2))
    assert got.shape == (2, 20, 33) and got.dtype == torch.float32
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), plain(b1[i], b2[i]))
        np.testing.assert_array_equal(
            pairwise_rotated_iou(torch.from_numpy(b1[i]),
                                 torch.from_numpy(b2[i])).numpy(),
            got[i].numpy())
    assert LAUNCHES["rotated_iou"] == before


@pytest.mark.parametrize("n,m", [(0, 5), (5, 0), (0, 0)])
def test_empty_inputs(n, m):
    from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou

    got = pairwise_rotated_iou(torch.zeros(2, n, 5), torch.zeros(2, m, 5))
    assert got.shape == (2, n, m)


def test_wrapper_rejects_bad_inputs():
    from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou

    b = torch.zeros(1, 4, 5)
    with pytest.raises(TypeError):
        pairwise_rotated_iou(b.double(), b.double())
    with pytest.raises(ValueError):
        pairwise_rotated_iou(b, torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        pairwise_rotated_iou(b, torch.zeros(1, 4, 4))
    with pytest.raises(ValueError):
        pairwise_rotated_iou(torch.zeros(1, 5, 4).transpose(1, 2), b)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises (the wrapper never falls back)."""
    from ryolo_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rotated_iou"])
    assert _build._target("rotated_iou").name.startswith("librotated_iou-")


def test_kernel_build_hash_covers_headers(monkeypatch, tmp_path):
    """An edit to a shared header rebuilds every library; an edit to one
    source rebuilds only that one."""
    import shutil

    from ryolo_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("rotated_iou", "rotated_nms", "warp")
    before = {n: _build._target(n).name for n in names}
    header = csrc / "rotated_iou_pair.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = {n: _build._target(n).name for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "warp.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target("warp").name != after["warp"]
    assert _build._target("rotated_nms").name == after["rotated_nms"]
