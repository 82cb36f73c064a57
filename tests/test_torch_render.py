"""The tap renderer's plain version (``ryolo_tpu_torch/ops/render.py``,
the CPU route of ``render_taps``) against the JAX package's readable
reference renderer, ``render_specs``/``render_specs_banked(method="taps")``,
on hand-built specs at 64 px, 4 specs (3 outputs and a partner), both
layouts: pixel tiles and a shared tile bank.

Every case carries mixup (``1-r`` taken in float32, one base blending a
partner slot and one another base) and both flips; the cases then make one
feature bite: loader-like mosaics, region seams on whole and half cells,
the unowned canvas border, a mosaic-9 zero-area region mid-prefix, offsets
that make the source clip bite, identity and partly-identity gains,
affines that send every tap far off the canvas, and singular affines.

Bound: the warp bound of tests/test_pallas_warp.py:32-36 (max |diff| <= 1
unit of 1/255, at most 1e-3 of values differ): XLA's CPU backend may fuse
a multiply-add that the port rounds twice (ROADMAP §C); the count is
printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import render_case

S, B, N_OUT, T, N_BANK = 64, 4, 3, 9, 12
CASES = ["mosaic", "seams", "unowned_border", "zero_area_mid_prefix", "clip",
         "gains", "far_affine", "singular_affine"]


def render_rows(rng, n, s):
    """``(n, s, s)`` int32 packed RGB words, random, with one word in
    sixteen grey (zero saturation) and one in sixty-four black."""
    words = rng.integers(0, 1 << 24, (n, s, s), dtype=np.int32)
    u = rng.integers(0, 64, (n, s, s), dtype=np.int8)
    grey = words & 0xFF
    words = np.where(u < 4, grey | (grey << 8) | (grey << 16), words)
    return torch.from_numpy(np.where(u == 0, 0, words).astype(np.int32))


def _case(name):
    rng = np.random.default_rng(CASES.index(name) + 11)
    spec = render_case(rng, B, S, N_OUT)
    spec.update(flip=np.array([[1, 0], [0, 1], [1, 1]], bool),
                mix_idx=np.array([3, -1, 1], np.int32),
                mix_r=np.array([0.4375, 0.0, 0.53], np.float32))
    reg, off, hsv, minv = (spec[k] for k in ("region", "offset", "hsv",
                                             "minv"))
    # a close-up across the canvas: blends straddle every seam
    close = np.array([[1.9713, 0.1287, 0.3061], [-0.1129, 2.0347, 0.4519]],
                     np.float32)
    if name == "seams":
        reg[:] = 0.0
        edges = [(-1, -1, 64, 64.5), (63.5, -1, 129, 65), (-1, 64, 65, 129),
                 (64, 64.5, 129, 129), (60, 60, 70.5, 70)]  # last overlaps
        for k, e in enumerate(edges):
            reg[:, k] = e
            off[:, k] = np.floor(e[:2])
        minv[:] = close
    elif name == "unowned_border":
        reg[:] = 0.0
        reg[:, 0] = [10, 12, 60, 50]
        reg[:, 1] = [55.5, 40, 100, 100]
        off[:, :2] = [[10, 12], [55, 40]]
        minv[:] = [[2.2131, 0.0, -8.6173], [0.1093, 2.2057, -9.1249]]
    elif name == "zero_area_mid_prefix":
        for i in range(B):  # mosaic-9 on thirds, slot 3 of no width
            for k in range(9):
                x, y = (k % 3) * 43.0, (k // 3) * 43.0
                reg[i, k] = [x, y, x + 43.0, y + 43.0]
                off[i, k] = [x, y]
            reg[i, 3, 2] = reg[i, 3, 0]
        minv[:] = close
    elif name == "clip":
        off += np.where(np.arange(2) == 0, -9.0, 7.0)  # both ends bite
        reg[..., 2:] = np.maximum(reg[..., 2:], reg[..., :2] + 1.3 * S)
    elif name == "gains":
        hsv[0] = 1.0                   # identity: no HSV round trip
        hsv[1, :, 1] = 1.0             # one gain of three at 1: jittered
        hsv[2, :, 0] = 1.0
        hsv[3] = (1 + 0.9 * np.sign(np.arange(27).reshape(9, 3) % 3 - 1)
                  ).astype(np.float32)
    elif name == "far_affine":
        minv[0] = [[1.0, 0.0, 9e6], [0.0, 1.0, -3e7]]
        minv[1] = [[1e30, 0.0, 1e30], [0.0, 1e30, 1e30]]
        minv[3] = [[1.0, 0.0, -1e4], [0.0, 1.0, 60.0]]
    elif name == "singular_affine":
        minv[0] = [[0.7071, 0.7071, 5.013], [0.7071, 0.7071, 9.087]]  # rank 1
        minv[1] = [[0.0, 0.0, 40.5], [0.0, 0.0, 60.25]]   # one point
        minv[3] = [[0.0, 1.5, 3.0], [-2.0, 0.0, 120.0]]   # axes swapped
    _clear_of_whole_numbers(minv)
    return spec


def _clear_of_whole_numbers(minv):
    """Shift each affine by 1/1024 cell until no pixel's coordinate lies
    within two float32 spacings of a whole number without being one.  At
    such a pixel
    XLA's jitted reference takes the floor and the fraction of the
    coordinate from two differently contracted copies of the same
    expression (a multiply-add fused in one, not in the other), so its
    taps jump by a cell: a reference artifact that random tiles would turn
    into a difference of tens of units."""
    o = np.arange(S, dtype=np.float64)
    for m in minv:
        for _ in range(64):
            m64 = m.astype(np.float64)
            c = (m64[:, 0, None, None] * o[None, None, :]
                 + m64[:, 1, None, None] * o[None, :, None]
                 + m64[:, 2, None, None])
            d = np.abs(c - np.round(c))
            near = d < 2 * np.spacing(np.abs(c).astype(np.float32))
            if not ((d > 0) & near).any():
                break
            m[:, 2] += np.float32(1 / 1024)
        else:
            raise AssertionError(f"no shift clears affine {m.tolist()}")


def _inputs(name, layout):
    spec = _case(name)
    rng = np.random.default_rng(CASES.index(name) + 101)
    if layout == "pixel":
        rows = render_rows(rng, B * T, S)
        slot_rows = np.arange(B * T).reshape(B, T)
    else:
        rows = render_rows(rng, N_BANK, S)
        slot_rows = rng.integers(0, N_BANK, (B, T))
        slot_rows[1, :4] = slot_rows[0, :4]  # rows shared between specs
    return rows, slot_rows, spec


def _assert_close_img(want, got, tag):
    """``want`` (n, s, s, 3) JAX, ``got`` (n, 3, s, s) port, both in [0, 1]."""
    got = got.numpy().transpose(0, 2, 3, 1)
    diff = np.abs(np.round(want.astype(np.float64) * 255.0)
                  - np.round(got.astype(np.float64) * 255.0))
    n_diff = int((diff > 0).sum())
    print(f"{tag}: {n_diff} of {diff.size} values differ, max {diff.max()}")
    assert diff.max() <= 1.0, f"{tag}: max diff {diff.max()}"
    assert n_diff <= 1e-3 * diff.size, f"{tag}: {n_diff} values differ"


def _jax_taps(rows, slot_rows, spec, layout):
    from ryolo_tpu.data.device_augment import render_specs, render_specs_banked

    words = jnp.asarray(rows.numpy().astype(np.uint32))
    common = [jnp.asarray(spec[k]) for k in ("region", "offset", "hsv",
                                             "minv")]
    # JAX reads flip, mix_idx and mix_r over every spec slot
    flip = np.zeros((B, 2), bool)
    flip[:N_OUT] = spec["flip"]
    mix_idx = np.full(B, -1, np.int32)
    mix_idx[:N_OUT] = spec["mix_idx"]
    mix_r = np.zeros(B, np.float32)
    mix_r[:N_OUT] = spec["mix_r"]
    tail = [jnp.asarray(flip), jnp.asarray(mix_idx), jnp.asarray(mix_r)]
    if layout == "pixel":
        out = render_specs(words.reshape(B, T, S, S), *common, *tail,
                           n_out=N_OUT, method="taps")
    else:
        out = render_specs_banked(words, jnp.asarray(slot_rows, jnp.int32),
                                  *common, *tail, n_out=N_OUT, method="taps")
    return np.asarray(out)


@pytest.mark.parametrize("layout", ["pixel", "bank"])
@pytest.mark.parametrize("name", CASES)
def test_render_taps_plain_matches_jax(name, layout):
    from ryolo_tpu_torch.ops.cuda_render import LAUNCHES, render_taps

    rows, slot_rows, spec = _inputs(name, layout)
    before = LAUNCHES["render"]
    got = render_taps(rows, slot_rows, spec["region"], spec["offset"],
                      spec["hsv"], spec["minv"], spec["flip"],
                      spec["mix_idx"], spec["mix_r"], N_OUT)
    assert LAUNCHES["render"] == before  # the CPU runs the plain version
    assert got.shape == (N_OUT, 3, S, S) and got.dtype == torch.float32
    want = _jax_taps(rows, slot_rows, spec, layout)
    _assert_close_img(want, got, f"{name} {layout}")
    if name == "far_affine":  # spec 1 blends nothing: all PAD
        assert (torch.round(got[1] * 255) == 114).all()


def test_plain_features_bite():
    """The cases reach what they are named for: unowned taps, a dead
    mid-prefix slot next to live ones, the source clip, and identity and
    jittered slots side by side."""
    from ryolo_tpu_torch.ops.render import tap_sources

    def owners(name):
        _, slot_rows, spec = _inputs(name, "pixel")
        _, taps = tap_sources(S, slot_rows, spec["region"], spec["offset"],
                              spec["minv"], "cpu")
        return spec, torch.stack([o for o, _ in taps])

    _, own = owners("unowned_border")
    assert (own == -1).any() and (own >= 0).any()
    spec, own = owners("zero_area_mid_prefix")
    assert not (own == 3).any() and (own == 8).any()
    spec, own = owners("clip")
    reg, off = spec["region"], spec["offset"]
    live = reg[..., 3] > reg[..., 1]
    assert ((reg[..., 1] - off[..., 1] < 0) & live).any()
    assert (reg[..., 2] - off[..., 0] > S).any()
    spec, own = owners("far_affine")
    assert (own[:, 0] == -1).all() and (own[:, 1] == -1).all()


def test_render_taps_rejects_bad_specs():
    from ryolo_tpu_torch.ops.cuda_render import render_taps

    rows, slot_rows, spec = _inputs("mosaic", "bank")
    args = [spec[k] for k in ("region", "offset", "hsv", "minv", "flip",
                              "mix_idx", "mix_r")]
    with pytest.raises(TypeError):
        render_taps(rows.float(), slot_rows, *args, N_OUT)
    bad = slot_rows.copy()
    bad[0, 0] = N_BANK  # past the bank, in a live slot
    with pytest.raises(ValueError, match="slot rows"):
        render_taps(rows, bad, *args, N_OUT)
    mix = spec["mix_idx"].copy()
    mix[0] = B
    with pytest.raises(ValueError, match="partners"):
        render_taps(rows, slot_rows, *args[:5], mix, args[6], N_OUT)
    with pytest.raises(ValueError, match="offset"):
        render_taps(rows, slot_rows, args[0], args[1][:, :4], *args[2:],
                    N_OUT)
