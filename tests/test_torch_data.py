"""Port host data path against the JAX package: render specs, collated
spec batches, host samples and labels are byte-identical for the same seed.

Both packages run the same numpy/cv2 code in the same rng order; the only
difference allowed is the carrier of packed tile words (uint32 in the JAX
package, int32 in the port), compared as values.  Synthetic set: the
tests/test_device_augment.py fixture (10 images, 96 px, custom format).
"""

import os

import numpy as np
import pytest

from tests.test_device_augment import HYP, _rng

S = 96


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from tests.make_synth_data import main

    root = str(tmp_path_factory.mktemp("synth_torch_data"))
    main(root, n_images=10, img_size=S, seed=0)
    return root


def _pair(root, hyp=None, **kw):
    from ryolo_tpu.data.datasets import CustomDataset as JaxCustom
    from ryolo_tpu_torch.data.datasets import CustomDataset

    args = (os.path.join(root, "train"), ["a", "b"], hyp or HYP)
    kw = dict(img_size=S, augment=True, csl=True, **kw)
    return JaxCustom(*args, **kw), CustomDataset(*args, **kw)


def assert_same_array(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.uint32:
        # packed tile words: port int32, JAX uint32, same values
        assert got.dtype == np.int32, what
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)
    else:
        assert got.dtype == want.dtype, what
        assert got.tobytes() == want.tobytes(), what


def assert_same_spec_sample(got, want):
    (gp, gspecs, gr, gf, gl), (wp, wspecs, wr, wf, wl) = got, want
    assert gp == wp and gr == wr and gf == wf
    assert len(gspecs) == len(wspecs)
    for gs, ws in zip(gspecs, wspecs):
        assert gs.keys() == ws.keys()
        for k in ws:
            assert_same_array(gs[k], ws[k], k)
    assert_same_array(gl, wl, "labels")


@pytest.mark.parametrize("banked", [False, True])
def test_render_spec_byte_identical(synth, banked):
    jds, tds = _pair(synth)
    if banked:
        assert_same_array(tds.build_tile_bank(), jds.build_tile_bank(),
                          "bank")
    n = 0
    for seed in (1, 2, 3, 4):
        for index in range(len(tds)):
            assert_same_spec_sample(
                tds.get_render_spec(index, _rng(seed, index), banked=banked),
                jds.get_render_spec(index, _rng(seed, index), banked=banked))
            n += 1
    assert n == 40


@pytest.mark.parametrize("mosaic", [1.0, 0.0])
def test_host_sample_byte_identical(synth, mosaic):
    jds, tds = _pair(synth, hyp=dict(HYP, mosaic=mosaic))
    for index in (0, 3, 7):
        gp, gimg, gl = tds.get_sample(index, _rng(5, index))
        wp, wimg, wl = jds.get_sample(index, _rng(5, index))
        assert gp == wp
        assert_same_array(gimg, wimg, "image")
        assert_same_array(gl, wl, "labels")


def _loaders(jds, tds, **kw):
    from ryolo_tpu.data.loader import DataLoader as JaxLoader
    from ryolo_tpu_torch.data.loader import DataLoader

    kw = dict(batch_size=4, csl=True, device_augment=True, max_targets=32,
              shuffle=True, **kw)
    return JaxLoader(jds, **kw), DataLoader(tds, **kw)


def assert_same_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "paths":
            assert got[k] == want[k]
        else:
            assert_same_array(got[k], want[k], k)


@pytest.mark.parametrize("device_cache", [False, True])
def test_collate_specs_byte_identical(synth, device_cache):
    jds, tds = _pair(synth)
    if device_cache:
        jds.build_tile_bank()
        tds.build_tile_bank()
    jl, tl = _loaders(jds, tds, seed=3, device_cache=device_cache)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        batches = list(zip(tl, jl))
        assert len(batches) == 3
        for got, want in batches:
            assert_same_batch(got, want)
            key = "spec_tile_idx" if device_cache else "spec_tiles"
            assert key in got


def test_overflow_falls_back_byte_identical(synth):
    """mixup 1.0: every sample draws a partner, B > E, so the banked batch
    falls back to pixel specs and the overflow samples to identity specs."""
    jds, tds = _pair(synth, hyp=dict(HYP, mixup=1.0))
    jds.build_tile_bank()
    tds.build_tile_bank()
    jl, tl = _loaders(jds, tds, seed=13, device_cache=True)
    got, want = next(iter(tl)), next(iter(jl))
    assert "spec_tiles" in got and "spec_tile_idx" not in got
    assert (got["spec_mix_idx"] < 0).any()  # identity-spec overflow slots
    assert_same_batch(got, want)


def test_identity_spec_byte_identical(synth):
    jds, tds = _pair(synth)
    jl, tl = _loaders(jds, tds, seed=5)
    (gp, gspec, gl) = tl._identity_spec(2)
    (wp, wspec, wl) = jl._identity_spec(2)
    assert gp == wp
    for k in wspec:
        assert_same_array(gspec[k], wspec[k], k)
    assert_same_array(gl, wl, "labels")


def test_dota_split_through_load_data(tmp_path):
    """DOTA parsing (names with spaces, difficulty column) through
    load_data with the host collate."""
    import cv2

    from ryolo_tpu.data.loader import load_data as jax_load
    from ryolo_tpu_torch.data.loader import load_data

    names = ["plane", "storage tank"]
    rng = np.random.default_rng(0)
    for d in ("images", "annfiles"):
        os.makedirs(tmp_path / d)
    for i in range(3):
        cv2.imwrite(str(tmp_path / "images" / f"p{i}.png"),
                    rng.integers(0, 255, (80, 120, 3), dtype=np.uint8))
        rows = [" ".join(f"{v:.1f}" for v in
                         rng.uniform(10, 70, 8)) + " storage-tank 0",
                "20 20 60 20 60 40 20 40 plane 1"]
        (tmp_path / "annfiles" / f"p{i}.txt").write_text("\n".join(rows))
    kw = dict(img_size=64, batch_size=2, augment=True, seed=1)
    _, jl = jax_load(str(tmp_path), names, "DOTA", HYP, True, **kw)
    _, tl = load_data(str(tmp_path), names, "DOTA", HYP, True, **kw)
    n = 0
    for got, want in zip(tl, jl):
        assert_same_batch(got, want)
        n += int(got["tgt_mask"].sum())
    assert n > 0


@pytest.mark.parametrize("fmt", ["DOTA", "UCAS_AOD"])
def test_label_parsers_match_jax(tmp_path, fmt):
    from ryolo_tpu.data.loader import DATASETS as JAX_DATASETS
    from ryolo_tpu_torch.data.loader import DATASETS

    names = ["plane", "storage tank"]
    rows = ["10 20 60 20 60 40 10 40 {} 0", "1.5 2 30.25 4 31 50 2 48 {} 1",
            "short row"]
    labels = ["plane", "storage-tank", ""]
    if fmt == "DOTA":
        text = "\n".join(r.format(n) for r, n in zip(rows, labels))
    else:
        text = "\n".join("\t".join([n] + r.split()[:8])
                         for r, n in zip(rows, labels))
    path = tmp_path / "p0.txt"
    path.write_text(text)
    args = (str(tmp_path), names, HYP)
    kw = dict(img_size=S, augment=False, csl=True)
    got = DATASETS[fmt](*args, **kw).load_files(str(path))
    want = JAX_DATASETS[fmt](*args, **kw).load_files(str(path))
    for g, w in zip(got, want):
        assert_same_array(g, w, fmt)
    assert len(got[1]) == 2
