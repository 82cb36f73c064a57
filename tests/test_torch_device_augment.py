"""Port device-side augmentation against the JAX package's readable
reference renderer (``render_specs(..., method="taps")``) on real loader
specs: mosaic-4/9, letterbox, mixup partners, flips, banked and pixel
batches, and unreferenced partner slots.  Both port routes run on the CPU:
``method="taps"`` (the tap renderer's plain version) and
``method="canvas"`` (paste, HSV, the warp's plain version, mixup, flips).

Bound: the warp bound of tests/test_pallas_warp.py:32-36 (max |diff| <= 1
unit of 1/255, at most 1e-3 of values differ); the port's canvas path and
JAX's taps renderer compute the same tap values and float32 lerp, so
exact agreement is expected and the count is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_device_augment import HYP, _rng
from tests.test_torch_data import S, _loaders, _pair, synth  # noqa: F401


def _assert_close_img(want, got, tag):
    """``want`` (n, s, s, 3) JAX, ``got`` (n, 3, s, s) port, both in [0, 1]."""
    got = got.numpy().transpose(0, 2, 3, 1)
    diff = np.abs(np.round(want.astype(np.float64) * 255.0)
                  - np.round(got.astype(np.float64) * 255.0))
    n_diff = int((diff > 0).sum())
    print(f"{tag}: {n_diff} of {diff.size} values differ, max {diff.max()}")
    assert diff.max() <= 1.0, f"{tag}: max diff {diff.max()}"
    assert n_diff <= 1e-3 * diff.size, f"{tag}: {n_diff} values differ"


def _jax_taps(batch, n_out, bank=None):
    from ryolo_tpu.data.device_augment import render_batch

    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "paths"}
    if "spec_tiles" in arrays:
        arrays["spec_tiles"] = arrays["spec_tiles"].astype(jnp.uint32)
    return np.asarray(render_batch(arrays, n_out=n_out, method="taps",
                                   bank=bank))


@pytest.mark.parametrize("method", ["taps", "canvas"])
@pytest.mark.parametrize("seed", [21, 33])
@pytest.mark.parametrize("device_cache", [False, True])
def test_render_batch_matches_jax_taps(synth, seed, device_cache,  # noqa: F811
                                       method):
    from ryolo_tpu_torch.data.device_augment import render_batch

    hyp = dict(HYP, mixup=0.5)  # several partners per batch
    jds, tds = _pair(synth, hyp=hyp)
    jbank = tbank = None
    if device_cache:
        jbank = jnp.asarray(jds.build_tile_bank().astype(np.uint32))
        tbank = torch.from_numpy(tds.build_tile_bank())
    _, tl = _loaders(jds, tds, seed=seed, device_cache=device_cache)
    n_mix = 0
    for batch in tl:
        n = len(batch["paths"])
        got = render_batch(batch, n, bank=tbank, device="cpu", method=method)
        assert got.shape == (n, 3, S, S) and got.dtype == torch.float32
        banked = "spec_tile_idx" in batch
        _assert_close_img(_jax_taps(batch, n, jbank if banked else None),
                          got, f"{method} seed={seed} cache={device_cache}")
        n_mix += int((batch["spec_mix_idx"] >= 0).sum())
    assert n_mix > 0


def test_letterbox_specs_match_jax_taps(synth):  # noqa: F811
    from ryolo_tpu_torch.data.device_augment import render_batch

    jds, tds = _pair(synth, hyp=dict(HYP, mosaic=0.0))
    _, tl = _loaders(jds, tds, seed=4)
    batch = next(iter(tl))
    _assert_close_img(_jax_taps(batch, 4),
                      render_batch(batch, 4, device="cpu"), "letterbox")


def _spec_batch(spec):
    batch = {f"spec_{k}": v[None] for k, v in spec.items()}
    batch.update(spec_flip=np.zeros((1, 2), bool),
                 spec_mix_idx=np.full((1,), -1, np.int32),
                 spec_mix_r=np.zeros((1,), np.float32))
    return batch


def test_zero_area_mid_prefix_slot_is_pasted(synth):  # noqa: F811
    """A mosaic-9 spec whose slot 3 is clipped to zero area: the port
    pastes every live slot up to the highest, so it equals the taps
    renderer; the JAX canvas path's live count (8) drops slot 8."""
    from ryolo_tpu.data.device_augment import render_specs as jax_render
    from ryolo_tpu_torch.data.device_augment import render_batch

    jds, tds = _pair(synth)
    spec = None
    for seed in range(1, 60):
        _, specs, _, _, _ = tds.get_render_spec(0, _rng(seed, 0))
        reg = specs[0]["region"]
        if ((reg[:, 2] > reg[:, 0]) & (reg[:, 3] > reg[:, 1])).sum() == 9:
            spec = {k: v.copy() for k, v in specs[0].items()}
            break
    assert spec is not None
    spec["region"][3, 2] = spec["region"][3, 0]  # zero width, mid-prefix
    spec["minv"] = np.array([[2.0, 0, 0], [0, 2.0, 0]], np.float32)  # whole canvas
    batch = _spec_batch(spec)
    got = render_batch(batch, 1, device="cpu")
    taps = _jax_taps(batch, 1)
    _assert_close_img(taps, got, "zero-area slot vs taps")
    jarr = [jnp.asarray(batch[f"spec_{k}"]) for k in
            ("region", "offset", "hsv", "minv", "flip", "mix_idx", "mix_r")]
    canvas = np.asarray(jax_render(
        jnp.asarray(batch["spec_tiles"].astype(np.uint32)), *jarr, n_out=1,
        method="canvas"))
    assert np.abs(canvas - taps).max() > 0  # the reference finding


def test_identity_spec_renders_the_host_sample(synth):  # noqa: F811
    from ryolo_tpu_torch.data.device_augment import render_batch

    _, tds = _pair(synth)
    from ryolo_tpu_torch.data.loader import DataLoader

    loader = DataLoader(tds, batch_size=2, csl=True, device_augment=True,
                        max_targets=32, seed=5)
    _, spec, _ = loader._identity_spec(0)
    _, img_h, _ = tds.get_sample(0, loader._rng(0))
    got = render_batch(_spec_batch(spec), 1, device="cpu")[0]
    got = got.numpy().transpose(1, 2, 0)
    np.testing.assert_allclose(got, img_h, atol=1e-6)


def test_hsv_jitter_matches_jax():
    """The HSV round trip alone, on every RGB corner case of a seeded set."""
    from ryolo_tpu.data.device_augment import hsv_jitter as jax_hsv
    from ryolo_tpu_torch.data.device_augment import hsv_jitter

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (4096, 3)).astype(np.float32)
    rgb[:64] = rgb[:64, :1]  # grey pixels: zero saturation
    rgb[64:72] = 0.0
    gains = (1.0 + rng.uniform(-1, 1, (4096, 3))
             * np.array([0.015, 0.7, 0.4])).astype(np.float32)
    # jitted, as the renderer runs it (XLA folds the divisions by constants
    # into reciprocal multiplies, and so does the port; XLA may also fuse a
    # multiply-add, hence the warp bound rather than equality)
    want = np.asarray(jax.jit(jax_hsv)(jnp.asarray(rgb), jnp.asarray(gains)))
    got = hsv_jitter(torch.from_numpy(rgb), torch.from_numpy(gains))
    _assert_close_img(want[None, None] / 255.0, got.T[None, :, None] / 255.0,
                      "hsv_jitter")
