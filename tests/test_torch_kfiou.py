"""The port's KFIoU head against the JAX package on the CPU: geometry,
rotated anchors, the decodes (full, scores only, deferred box), the
deferred post-process, the angle-gated assignment, ``kf_loss`` and
``kfiou_loss``.

Head maps are made with numpy, NHWC for JAX and NCHW for the port.
Bounds: decoded rows within rtol 1e-6, atol 1e-4 (the bound
tests/test_torch_model.py holds the CSL decode to; tests/test_checkpoint.py
allows 2e-3 after a whole forward), scores within rtol 1e-6; the deferred
decode and post-process equal to the port's own full decode to the bit;
the loss and items within rtol 1e-5 and the head-map gradient within rtol
1e-4 (atol 1e-6 of its largest entry), the bounds of
tests/test_torch_losses.py.  Targets are drawn clear of the angle gate's
edge: ``cos(30 deg) = 0.8660254`` passes ``> 0.866``, and a target within
~1e-6 rad of an anchor's +-30 deg could fall either side in the two
frameworks' float32 ``cos``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_losses import HYP
from tests.torch_parity import MODEL_CFG, limit_threads, nhwc_to_nchw

NC = 3
NA = 18
GRIDS = (8, 4, 2)  # a 64 px input
STRIDES = (8, 16, 32)
ANGLES = [a * math.pi / 180 for a in MODEL_CFG["angles"]]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_threads()


def _anchors():
    from ryolo_tpu.nn.yolo import make_rotated_anchors

    return make_rotated_anchors(STRIDES, MODEL_CFG["anchors"], ANGLES)


def _maps(seed, B=2, nc=NC, scale=2.0, grids=GRIDS):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((B, g, g, NA * (6 + nc)))).astype(
        np.float32) for g in grids]


def _jax(maps):
    return [jnp.asarray(m) for m in maps]


def _torch(maps):
    return [nhwc_to_nchw(m) for m in maps]


def kfiou_targets(seed, B=2, T=12, n=(9, 12), nc=2):
    """Loader-layout targets ``(tgt, mask)``, each angle at least 1e-4 off
    the gate's edge for every anchor angle."""
    rng = np.random.default_rng(seed)
    tgt = np.zeros((B, T, 6), np.float32)
    mask = np.zeros((B, T), bool)
    for b in range(B):
        k = n[b]
        tgt[b, :k, 0] = rng.integers(0, nc, k)
        tgt[b, :k, 1:3] = rng.uniform(0.05, 0.95, (k, 2))
        tgt[b, :k, 3:5] = rng.uniform(0.03, 0.4, (k, 2))
        for t in range(k):
            while True:
                th = np.float32(rng.uniform(-np.pi / 2, np.pi / 2))
                d = np.abs(np.cos(np.float64(th) - np.array(ANGLES)))
                if np.abs(d - 0.866).min() > 1e-4:
                    break
            tgt[b, t, 5] = th
        mask[b, :k] = True
    return tgt, mask


# geometry ------------------------------------------------------------------

def _boxes(seed, n=256):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 800, n), rng.uniform(0, 800, n),
                     rng.uniform(2, 60, n), rng.uniform(61, 200, n),
                     rng.uniform(-np.pi / 2, np.pi / 2, n)], -1).astype(
        np.float32)


def test_angle_wraps_match_jax():
    from ryolo_tpu.geometry import norm_angle as j_norm
    from ryolo_tpu.geometry import wrap_angle as j_wrap
    from ryolo_tpu_torch.geometry import norm_angle, wrap_angle

    rng = np.random.default_rng(0)
    one = rng.uniform(-1.5 * np.pi, 1.5 * np.pi, 4096).astype(np.float32)
    edges = np.float32([-np.pi / 2, np.pi / 2, -1.5 * np.pi, 0.0])
    one = np.concatenate([one, edges])
    got = norm_angle(torch.from_numpy(one)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_norm(jnp.asarray(one))))
    assert (got >= -np.pi / 2).all() and (got < np.pi / 2).all()
    anyr = rng.uniform(-20, 20, 4096).astype(np.float32)
    got = wrap_angle(torch.from_numpy(anyr)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_wrap(jnp.asarray(anyr))),
                               rtol=0, atol=2e-6)
    assert (got >= -np.pi / 2).all() and (got < np.pi / 2 + 1e-6).all()


def test_box_polygon_conversions_match_jax():
    from ryolo_tpu.geometry import xywha2xyxyxyxy as j_poly
    from ryolo_tpu.geometry import xyxyxyxy2xywha as j_box
    from ryolo_tpu_torch.geometry import xywha2xyxyxyxy, xyxyxyxy2xywha

    boxes = _boxes(1)
    poly = xywha2xyxyxyxy(torch.from_numpy(boxes))
    want = np.asarray(j_poly(jnp.asarray(boxes)))
    assert poly.shape == (256, 4, 2)
    np.testing.assert_allclose(poly.numpy(), want, rtol=1e-6, atol=1e-4)
    flat = want.reshape(-1, 8).copy()
    got = xyxyxyxy2xywha(torch.from_numpy(flat)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_box(jnp.asarray(flat))),
                               rtol=1e-6, atol=1e-4)
    # the round trip gives the boxes back (long side h, theta in range)
    np.testing.assert_allclose(got, boxes, rtol=1e-5, atol=2e-3)


def test_gaussian_of_box_matches_jax():
    from ryolo_tpu.geometry import xywhr2xywhrsigma as j_sigma
    from ryolo_tpu_torch.geometry import xywhr2xywhrsigma

    boxes = _boxes(2)
    boxes[:3, 2:4] = [[0.0, 5.0], [1e5, 3.0], [1e-6, 1e-6]]  # the clips
    got = xywhr2xywhrsigma(torch.from_numpy(boxes))
    want = j_sigma(jnp.asarray(boxes))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert got[3].shape == (256, 2, 2)


# anchors and decode ----------------------------------------------------------

def test_rotated_anchors_match_jax():
    from ryolo_tpu_torch.nn import Yolo, make_rotated_anchors

    want = _anchors()
    got = make_rotated_anchors(STRIDES, MODEL_CFG["anchors"], ANGLES)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (NA, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    model = Yolo(NC, MODEL_CFG, mode="kfiou", ver="yolov5")
    assert (model.na, model.nf) == (NA, 6 + NC)
    for g, w in zip(model.anchors, want):
        np.testing.assert_array_equal(g, w)
    # each anchor size at the six angles, angles fastest
    np.testing.assert_allclose(got[0][:6, 2], ANGLES, rtol=1e-6)
    np.testing.assert_allclose(got[0][6, :2], [19 / 8, 36 / 8])


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_kfiou_matches_jax(seed):
    from ryolo_tpu.nn.heads import decode_kfiou as j_decode
    from ryolo_tpu_torch.nn.heads import decode_kfiou

    maps = _maps(seed)
    want = np.asarray(j_decode(_jax(maps), _anchors(), STRIDES, NC))
    got = decode_kfiou(_torch(maps), _anchors(), STRIDES, NC).numpy()
    assert got.shape == want.shape == (2, NA * (64 + 16 + 4), NC + 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-6)


def _class_products(rows):
    return rows[..., 6:] * rows[..., 5:6]


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_kfiou_scores_matches_jax(seed):
    from ryolo_tpu.nn.heads import decode_kfiou as j_decode
    from ryolo_tpu.nn.heads import decode_kfiou_scores as j_scores
    from ryolo_tpu_torch.eval.postprocess import _class_max
    from ryolo_tpu_torch.nn.heads import decode_kfiou, decode_kfiou_scores

    maps = _maps(seed)
    conf, cls_id = decode_kfiou_scores(_torch(maps), NA, NC)
    w_conf, w_id = (np.asarray(a) for a in j_scores(_jax(maps), NA, NC))
    assert conf.dtype == torch.float32 and cls_id.dtype == torch.int32
    np.testing.assert_allclose(conf.numpy(), w_conf, rtol=1e-6, atol=0)
    # the class wherever JAX's two best products differ
    prods = np.sort(_class_products(np.asarray(
        j_decode(_jax(maps), _anchors(), STRIDES, NC))), -1)
    clear = prods[..., -1] > prods[..., -2]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(cls_id.numpy()[clear], w_id[clear])
    # bit-equal to the port's own full decode and class max
    f_conf, f_id = _class_max(decode_kfiou(_torch(maps), _anchors(),
                                           STRIDES, NC))
    assert torch.equal(conf, f_conf) and torch.equal(cls_id.float(), f_id)


def test_decode_kfiou_scores_ties_keep_the_first_class():
    """Built ties: equal class logits give equal products, and the first
    class of the tie wins, as in JAX's chain."""
    from ryolo_tpu.nn.heads import decode_kfiou_scores as j_scores
    from ryolo_tpu_torch.nn.heads import decode_kfiou_scores

    maps = _maps(5)
    for m in maps:
        v = m.reshape(*m.shape[:3], NA, 6 + NC)
        v[:, 0::3, :, :, 6:9] = 1.5          # all three tie
        v[:, 1::3, :, :, 7] = v[:, 1::3, :, :, 8] = 4.0  # 1 and 2 tie
        v[:, 1::3, :, :, 6] = -4.0
    conf, cls_id = decode_kfiou_scores(_torch(maps), NA, NC)
    w_conf, w_id = (np.asarray(a) for a in j_scores(_jax(maps), NA, NC))
    np.testing.assert_array_equal(cls_id.numpy(), w_id)
    np.testing.assert_allclose(conf.numpy(), w_conf, rtol=1e-6)
    ids = cls_id.numpy()[:, :NA * 64].reshape(2, NA, 8, 8)
    assert (ids[:, :, 0::3] == 0).all() and (ids[:, :, 1::3] == 1).all()


def _indices(seed, b=2, k=300):
    """Candidate indices over the three levels, each level's first and
    last included."""
    n = [NA * g * g for g in GRIDS]
    edges = np.cumsum([0] + n)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, edges[-1], (b, k))
    idx[:, :6] = [edges[0], edges[1] - 1, edges[1], edges[2] - 1, edges[2],
                  edges[3] - 1]
    return idx


def test_deferred_kfiou_box_equals_full_decode():
    from ryolo_tpu.nn.heads import deferred_kfiou_box as j_box
    from ryolo_tpu_torch.nn.heads import decode_kfiou, deferred_kfiou_box

    maps = _maps(2)
    idx = _indices(3)
    got = deferred_kfiou_box(_torch(maps), torch.from_numpy(idx), NA,
                             _anchors(), STRIDES)
    rows = decode_kfiou(_torch(maps), _anchors(), STRIDES, NC)
    full = rows.gather(1, torch.from_numpy(idx)[..., None].expand(-1, -1, NC
                                                                  + 6))
    assert torch.equal(got, full[..., :5])
    want = np.asarray(j_box(_jax(maps), jnp.asarray(idx, jnp.int32), NA,
                            _anchors(), STRIDES))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_theta_widths_of_decode_and_loss():
    """The inference decode takes 0.5236 and does not wrap; the loss takes
    1.1 and wraps (tests/test_kfiou_asymmetry.py pins JAX's)."""
    from ryolo_tpu.geometry import norm_angle as j_norm
    from ryolo_tpu_torch.losses.kfiou import loss_theta
    from ryolo_tpu_torch.nn.heads import decode_kfiou

    out = np.zeros((1, 1, 1, 1, NC + 6), np.float32)
    out[..., 4] = 20.0  # sigmoid -> 1
    for anc_th in (0.3, np.pi / 2 * 0.99, -np.pi / 2):
        anc = [np.array([[2.0, 2.0, anc_th]], np.float32)]
        dec = decode_kfiou([torch.from_numpy(out.reshape(1, -1, 1, 1))], anc,
                           [8], NC).numpy()
        np.testing.assert_allclose(dec[0, 0, 4], 0.5 * 0.5236 + anc_th,
                                   rtol=0, atol=1e-6)
    assert dec[0, 0, 4] < np.pi / 2  # -pi/2 + 0.26: inside, not wrapped
    assert 0.5 * 0.5236 + np.pi / 2 * 0.99 >= np.pi / 2
    t = torch.tensor([20.0, -20.0, 0.3])
    for anc_th in (np.pi / 2 * 0.99, -np.pi / 2, 0.2):
        a = torch.full((3,), anc_th, dtype=torch.float32)
        got = loss_theta(t, a).numpy()
        want = np.asarray(j_norm((jax.nn.sigmoid(jnp.asarray(t.numpy()))
                                  - 0.5) * 1.1 + anc_th))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got >= -np.pi / 2).all() and (got < np.pi / 2).all()
    wrapped = loss_theta(torch.tensor([20.0]), torch.tensor([np.pi / 2 *
                                                             0.99]))
    np.testing.assert_allclose(wrapped.item() + np.pi,
                               0.5 * 1.1 + np.pi / 2 * 0.99, atol=1e-6)


# post-processing -----------------------------------------------------------

@pytest.mark.parametrize("conf", [0.05, 0.5])
def test_post_process_kfiou_defer(conf):
    """Equal to the port's full decode + ``post_process_fixed`` to the bit,
    and to JAX's deferred post-process of the same maps: the same keep
    sets, classes and scores, boxes to the decode's rounding.  On 6, 3 and
    2 cell grids (882 candidates an image): at conf 0.05 more than SMALL_K
    of them pass (the full-width branch), at 0.5 fewer."""
    from ryolo_tpu.eval.postprocess import post_process_kfiou_defer as j_pp
    from ryolo_tpu_torch.eval.postprocess import (SMALL_K, post_process_fixed,
                                                  post_process_kfiou_defer)
    from ryolo_tpu_torch.nn.heads import decode_kfiou, decode_kfiou_scores

    maps = _maps(4, scale=1.5, grids=(6, 3, 2))
    tmaps = _torch(maps)
    scores = decode_kfiou_scores(tmaps, NA, NC)
    n_pass = int((scores[0] > conf).sum(1).max())
    assert (n_pass > SMALL_K) == (conf == 0.05), n_pass
    dets, valid = post_process_kfiou_defer(scores, tmaps, NA, _anchors(),
                                           STRIDES, conf, 0.4)
    f_dets, f_valid = post_process_fixed(
        decode_kfiou(tmaps, _anchors(), STRIDES, NC), conf, 0.4)
    assert torch.equal(valid, f_valid) and torch.equal(dets, f_dets)
    assert int(valid.sum()) > 10

    j_scores = tuple(jnp.asarray(s.numpy()) for s in scores)
    w_dets, w_valid = (np.asarray(a) for a in j_pp(
        j_scores, _jax(maps), NA, _anchors(), STRIDES, conf, 0.4))
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    d = dets.numpy()
    np.testing.assert_array_equal(d[..., 5:], w_dets[..., 5:])
    np.testing.assert_allclose(d[..., :5], w_dets[..., :5], rtol=1e-6,
                               atol=1e-4)


# assignment and losses -----------------------------------------------------

def test_angle_gated_candidates_match_jax():
    from ryolo_tpu.losses.assign import build_candidates as j_build
    from ryolo_tpu_torch.losses.assign import build_candidates

    tgt, mask = kfiou_targets(3)
    n_gated = n_ungated = 0
    for anc, g in zip(_anchors(), GRIDS):
        j = j_build(jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(anc),
                    g, g, angle_gate=True)
        t = build_candidates(torch.from_numpy(tgt), torch.from_numpy(mask),
                             torch.from_numpy(anc), g, g, angle_gate=True)
        assert t.tcsl is None and t.valid.shape == (2, 12 * NA * 5)
        for name in j._fields:
            if name != "tcsl":
                np.testing.assert_array_equal(
                    getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                    err_msg=name)
        ungated = build_candidates(torch.from_numpy(tgt),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(anc), g, g)
        n_gated += int(t.valid.sum())
        n_ungated += int(ungated.valid.sum())
    # each target keeps the anchors within 30 degrees: 2 of the 6 angles
    assert 0 < n_gated < n_ungated / 2, (n_gated, n_ungated)


def test_kf_loss_matches_jax():
    from ryolo_tpu.losses.common import kf_loss as j_kf
    from ryolo_tpu_torch.losses.common import kf_loss

    rng = np.random.default_rng(7)
    n = 512
    pred = np.stack([rng.uniform(0, 4, n), rng.uniform(0, 4, n),
                     rng.uniform(0.1, 6, n), rng.uniform(0.1, 6, n),
                     rng.uniform(-np.pi / 2, np.pi / 2, n)], -1)
    tgt = np.stack([rng.uniform(0, 4, n), rng.uniform(0, 4, n),
                    rng.uniform(0.1, 6, n), rng.uniform(0.1, 6, n),
                    rng.uniform(-np.pi / 2, np.pi / 2, n)], -1)
    # sizes at and past the clips: ratios up to 1e16 of squared sizes
    pred[:4, 2:4] = [[1e-6, 1e-6], [1e5, 2.0], [1e-4, 1e4], [0.0, 3.0]]
    tgt[:4, 2:4] = [[1e4, 1e4], [1e-5, 1e-5], [1e4, 1e-4], [3.0, 3.0]]
    pred, tgt = pred.astype(np.float32), tgt.astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    for fun in ("exp", "ln", "plain"):
        for m in (None, mask):
            wl, wk = j_kf(jnp.asarray(pred), jnp.asarray(tgt), fun=fun,
                          mask=None if m is None else jnp.asarray(m))
            gl, gk = kf_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                             fun=fun,
                             mask=None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(gk.numpy(), np.asarray(wk),
                                       rtol=1e-5, atol=1e-30)
            np.testing.assert_allclose(gl.item(), float(wl), rtol=1e-5)
    assert np.isfinite(gk.numpy()).all() and gk.numpy()[:4].max() < 1e-3


@pytest.mark.parametrize("seed,fl_gamma", [(0, 0.0), (1, 0.0), (2, 1.5)])
def test_kfiou_loss_and_grad_match_jax(seed, fl_gamma):
    from ryolo_tpu.losses import kfiou_loss as j_loss
    from ryolo_tpu_torch.losses import kfiou_loss

    hyp = dict(HYP, fl_gamma=fl_gamma)
    anchors = _anchors()
    tgt, mask = kfiou_targets(seed)
    heads = _maps(seed, nc=2)

    def jloss(outs):
        return j_loss(outs, jnp.asarray(tgt), jnp.asarray(mask), anchors, 2,
                      hyp)

    (jl, jitems), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _jax(heads))
    touts = [h.requires_grad_(True) for h in _torch(heads)]
    tl, titems = kfiou_loss(touts, torch.from_numpy(tgt),
                            torch.from_numpy(mask),
                            [torch.from_numpy(a) for a in anchors], 2, hyp)
    tl.backward()
    assert titems.keys() == jitems.keys()
    for k, v in jitems.items():
        np.testing.assert_allclose(titems[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    assert titems["reg_loss"].item() > 0 and titems["cls_loss"].item() > 0
    for t, j in zip(touts, jgrad):
        j = np.asarray(j).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-4,
                                   atol=1e-6 * np.abs(j).max())
