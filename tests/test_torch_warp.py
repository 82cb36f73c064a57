"""Plain version of the port's canvas warp (the CUDA kernel's twin) against
the JAX package's ``device_augment._warp_block`` and the Pallas kernel
``pallas_warp.warp_canvas_batch`` (interpret mode on the CPU), on the
tests/test_pallas_warp.py cases at s = 64.

Bound: tests/test_pallas_warp.py:32-36 (max |diff| <= 1, at most 1e-3 of
pixels differ).  The port and ``_warp_block`` run the same float32
expressions with nothing fused, so exact agreement is expected; the count
of differing pixels is printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_warp import _rand_affine

S = 64
C = 2 * S + 2


def _cases():
    rng = np.random.default_rng(0)
    d = 3.03 / 2.0 * 0.999  # |row|_1 at the TPU kernel's span bound
    return np.stack([
        _rand_affine(rng, S), _rand_affine(rng, S),
        np.array([[1, 0, 0], [0, 1, 0]], np.float32),          # identity
        np.array([[1, 0, 9000], [0, 1, -9000]], np.float32),   # off canvas
        # taps straddling the canvas edge (test_kernel_window_edges)
        np.array([[1, 0, -31.5], [0, 1, C - 32.5]], np.float32),
        np.array([[0.5, 0.5, -1.0], [-0.5, 0.5, C - 33.0]], np.float32),
        np.array([[d, d, 20.2], [-d, d, 40.7]], np.float32),
        # far above the TPU kernel's bound: the port has none
        np.array([[2.9, -2.7, 60.0], [2.6, 3.1, -40.0]], np.float32),
    ])


def _assert_close_int(want, got, tag):
    diff = np.abs(want.astype(np.float64) - got.astype(np.float64))
    n_diff = int((diff > 0).sum())
    print(f"{tag}: {n_diff} of {diff.size} values differ, max {diff.max()}")
    assert diff.max() <= 1.0, f"{tag}: max diff {diff.max()}"
    assert n_diff <= 1e-3 * diff.size, f"{tag}: {n_diff} values differ"


@pytest.fixture(scope="module")
def warp_case():
    minv = _cases()
    canv = np.random.default_rng(1).integers(0, 256, (len(minv), C, C, 3),
                                             dtype=np.uint8)
    planar = np.ascontiguousarray(canv.transpose(0, 3, 2, 1))  # (B, 3, X, Y)
    return canv, planar, minv


def _port(planar, minv, active=None):
    from ryolo_tpu_torch.ops.cuda_warp import warp_canvas

    act = None if active is None else torch.from_numpy(active)
    out = warp_canvas(torch.from_numpy(planar), torch.from_numpy(minv), S,
                      act)
    return out.numpy().transpose(0, 2, 3, 1)  # NHWC, as the JAX outputs


def test_plain_warp_matches_warp_block(warp_case):
    from ryolo_tpu.data.device_augment import _warp_block

    _, planar, minv = warp_case
    want = np.stack([np.asarray(_warp_block(jnp.asarray(planar[k]),
                                            jnp.asarray(minv[k]), S))
                     for k in range(len(minv))])
    got = _port(planar, minv)
    _assert_close_int(want, got, "port vs _warp_block")
    assert (got[3] == 114.0).all()  # far off-canvas: all PAD


def test_plain_warp_matches_pallas_kernel(warp_case):
    from ryolo_tpu.ops.pallas_warp import warp_canvas_batch

    canv, planar, minv = warp_case
    fits = np.abs(minv[:, :, :2]).sum(-1).max(-1) <= 3.03  # the TPU bound
    want = np.asarray(warp_canvas_batch(jnp.asarray(canv[fits]),
                                        jnp.asarray(minv[fits]), S))
    _assert_close_int(want, _port(planar[fits], minv[fits]),
                      "port vs Pallas kernel")


def test_inactive_specs_are_pad(warp_case):
    _, planar, minv = warp_case
    active = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.int32)
    got = _port(planar, minv, active)
    full = _port(planar, minv)
    assert (got[active == 0] == 114.0).all()
    np.testing.assert_array_equal(got[active == 1], full[active == 1])


def test_wrapper_checks_inputs(warp_case):
    from ryolo_tpu_torch.ops.cuda_warp import warp_canvas

    _, planar, minv = warp_case
    c, m = torch.from_numpy(planar), torch.from_numpy(minv)
    with pytest.raises(TypeError):
        warp_canvas(c.float(), m, S)
    with pytest.raises(ValueError):
        warp_canvas(c, m[:2], S)
    with pytest.raises(ValueError):
        warp_canvas(c[:, :2], m, S)
