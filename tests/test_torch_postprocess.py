"""Port post-processing and rotated NMS against the JAX package.

The same numpy inputs go through ``ryolo_tpu`` and ``ryolo_tpu_torch``;
keep sets and detections must be equal (the cases of
tests/test_postprocess.py:58-215).  On the CPU the JAX NMS runs its XLA
IoU (``rotated_nms.py:34-39``) and the port its plain PyTorch IoU.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracles import nms_oracle
from tests.torch_parity import MODEL_CFG, NC, limit_threads, nhwc_to_nchw

LEVELS = (16, 8, 4)  # a 128 px input: N = 3 * (256 + 64 + 16) = 1008


@pytest.fixture(autouse=True)
def _threads():
    limit_threads()


def _head_maps(seed):
    """Random NHWC head logits for the three levels."""
    rng = np.random.default_rng(seed)
    nf = NC + 185
    maps = []
    for s in LEVELS:
        m = rng.normal(0, 1, (2, s, s, 3, nf)).astype(np.float32)
        m[..., 2:4] *= 0.5          # box sizes near the anchors
        m[..., 4:5 + NC] *= 2.5     # a wide spread of scores
        maps.append(m.reshape(2, s, s, 3 * nf))
    return maps


def _decoded(maps, defer=True):
    from ryolo_tpu.nn.heads import decode_csl, decode_csl_defer
    from ryolo_tpu.nn.yolo import STRIDES, make_anchors

    fn = decode_csl_defer if defer else decode_csl
    return np.array(fn([jnp.asarray(m) for m in maps],
                       make_anchors(STRIDES, MODEL_CFG["anchors"]),
                       STRIDES, NC))


def _jax_pp(dec, maps, conf, iou, **kw):
    from ryolo_tpu.eval.postprocess import post_process_defer

    d, v = post_process_defer(jnp.asarray(dec),
                              tuple(jnp.asarray(m) for m in maps), 3, NC,
                              conf, iou, **kw)
    return np.asarray(d), np.asarray(v)


def _port_pp(dec, maps, conf, iou, **kw):
    from ryolo_tpu_torch.eval.postprocess import post_process_defer

    d, v = post_process_defer(torch.from_numpy(dec),
                              [nhwc_to_nchw(m) for m in maps], 3, NC, conf,
                              iou, **kw)
    return d.numpy(), v.numpy()


def _assert_same_detections(got, want):
    (gd, gv), (wd, wv) = got, want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gd[..., [0, 1, 2, 3, 5, 6]],
                                  wd[..., [0, 1, 2, 3, 5, 6]])
    # theta: the same bin; (bin - 90) / 180 * pi may round differently by
    # one ulp between the two graphs (tests/test_postprocess.py:208-212)
    np.testing.assert_allclose(gd[..., 4], wd[..., 4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("conf,iou,seed", [(0.5, 0.4, 0), (0.25, 0.65, 1),
                                           (0.05, 0.2, 2)])
def test_post_process_defer_matches_jax(conf, iou, seed):
    maps = _head_maps(seed)
    dec = _decoded(maps)
    got = _port_pp(dec, maps, conf, iou)
    want = _jax_pp(dec, maps, conf, iou)
    assert want[1].sum() > 0
    _assert_same_detections(got, want)


def test_all_rows_below_threshold():
    maps = _head_maps(3)
    dec = _decoded(maps)
    got = _port_pp(dec, maps, 0.999999, 0.4)
    assert got[1].sum() == 0 and np.all(got[0] == 0.0)
    _assert_same_detections(got, _jax_pp(dec, maps, 0.999999, 0.4))


def test_max_det_cap():
    maps = _head_maps(4)
    dec = _decoded(maps)
    got = _port_pp(dec, maps, 0.1, 0.4, max_det=10)
    assert got[0].shape == (2, 10, 7) and np.all(got[1].sum(1) == 10)
    assert np.all(np.diff(got[0][..., 5], axis=1) <= 0)  # score order
    _assert_same_detections(got, _jax_pp(dec, maps, 0.1, 0.4, max_det=10))


@pytest.mark.parametrize("conf", [0.6, 0.05])
def test_small_k_branches(monkeypatch, conf):
    """Both branches of the SMALL_K width: fast where every image has at
    most SMALL_K rows above threshold, full otherwise; the fast branch
    must equal the full width."""
    import ryolo_tpu_torch.eval.postprocess as pp

    maps = _head_maps(5)
    dec = _decoded(maps)
    conf_max = np.max(dec[..., 6:] * dec[..., 5:6], -1)
    fast = bool(((conf_max > conf).sum(1) <= pp.SMALL_K).all())
    assert fast == (conf == 0.6)
    got = _port_pp(dec, maps, conf, 0.4)
    _assert_same_detections(got, _jax_pp(dec, maps, conf, 0.4))
    monkeypatch.setattr(pp, "SMALL_K", 0)  # force the full width
    full = _port_pp(dec, maps, conf, 0.4)
    np.testing.assert_array_equal(got[1], full[1])
    np.testing.assert_array_equal(got[0], full[0])


def test_deferred_theta_matches_full_decode():
    from ryolo_tpu_torch.eval.postprocess import post_process_fixed

    maps = _head_maps(6)
    full = _decoded(maps, defer=False)
    for conf in (0.5, 0.1):
        got = _port_pp(_decoded(maps), maps, conf, 0.4)
        d, v = post_process_fixed(torch.from_numpy(full), conf, 0.4)
        np.testing.assert_array_equal(got[1], v.numpy())
        np.testing.assert_array_equal(got[0], d.numpy())


@pytest.mark.parametrize("conf,iou,seed,k", [(0.5, 0.4, 0, 512),
                                             (0.25, 0.65, 1, 1008),
                                             (0.05, 0.2, 2, 1008)])
def test_segments_equal_post_process_defer(conf, iou, seed, k):
    """Detect's decode and post-process as the segments that a card
    replays as CUDA graphs (``detect._DecodePost``), run eagerly in order,
    equal ``decode_csl_defer`` + ``post_process_defer`` to the bit, at
    both widths of the top-k selection."""
    from ryolo_tpu_torch.detect import _DecodePost
    from ryolo_tpu_torch.eval.postprocess import post_process_defer
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_csl_defer
    from ryolo_tpu_torch.nn.yolo import make_anchors

    heads = [nhwc_to_nchw(m) for m in _head_maps(seed)]
    anchors = make_anchors(STRIDES, MODEL_CFG["anchors"])
    chain = _DecodePost(SimpleNamespace(mode="csl", na=3, anchors=anchors),
                        NC, conf, iou)
    dets, valid = chain.post_process(chain.decode(heads))
    assert list(chain.tails) == [k]
    w_dets, w_valid = post_process_defer(
        decode_csl_defer(heads, anchors, STRIDES, NC), heads, 3, NC, conf,
        iou)
    assert valid.sum() > 0
    assert torch.equal(valid, w_valid) and torch.equal(dets, w_dets)


@pytest.mark.parametrize("ulps", [-0.25, 0.0, 0.25])
def test_threshold_at_a_candidates_float32_score(ulps):
    """A threshold that rounds to a candidate's float32 score ``s`` (``s``
    plus ``ulps`` of its ulp): scores compare with it in float32, as JAX's
    weakly typed threshold, so ``s`` itself does not pass (score strictly
    above), where a float64 comparison would pass it at -1/4 ulp.  Keep
    sets and detections equal JAX's."""
    from ryolo_tpu_torch.eval.postprocess import select_rows

    maps = _head_maps(0)
    dec = _decoded(maps)
    conf = np.max(dec[..., 6:] * dec[..., 5:6], -1)  # float32 products
    s = np.sort(conf[0])[::-1][100]
    thres = float(s) + ulps * float(np.spacing(s))
    assert np.float32(thres) == s
    sel = select_rows(torch.from_numpy(dec), thres)[1]
    assert int((sel > 0).sum()) == int((conf > s).sum())
    assert ((conf.astype(np.float64) > thres).sum() > (conf > s).sum()) \
        == (ulps < 0)
    got = _port_pp(dec, maps, thres, 0.4)
    want = _jax_pp(dec, maps, thres, 0.4)
    assert want[1].sum() > 0
    _assert_same_detections(got, want)


def _nms_case(seed, k):
    """Clustered boxes (long suppression chains) in descending score."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 300, (6, 2))
    boxes = np.zeros((k, 5), np.float32)
    boxes[:, :2] = centres[rng.integers(0, 6, k)] + rng.normal(0, 12, (k, 2))
    boxes[:, 2:4] = rng.uniform(10, 50, (k, 2))
    boxes[:, 4] = rng.uniform(-90, 90, k)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    valid = scores > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("seed,k,max_keep,presorted", [
    (0, 150, 1500, False),   # K not a multiple of the 64 chunk
    (1, 64, 1500, True),
    (2, 300, 25, False),     # kept-buffer capacity
    (3, 257, 1500, True),
])
def test_nms_matches_jax(seed, k, max_keep, presorted):
    from ryolo_tpu.ops.rotated_nms import nms_rotated_masked as jax_nms
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    boxes, scores, valid = _nms_case(seed, k)
    if presorted:  # descending score, padding last
        o = np.argsort(-np.where(valid, scores, -1.0), kind="stable")
        boxes, scores, valid = boxes[o], scores[o], valid[o]
    jo, jk = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                     jnp.asarray(valid), jnp.float32(0.3), max_keep=max_keep,
                     presorted=presorted, pallas=False)
    to, tk = nms_rotated_masked(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(valid), 0.3,
                                max_keep=max_keep, presorted=presorted)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() <= max_keep
    if max_keep >= k:
        kept = to.numpy()[tk.numpy()]
        v = np.flatnonzero(valid)
        np.testing.assert_array_equal(
            kept, v[nms_oracle(boxes[v], scores[v], 0.3)])


def test_nms_batched_equals_per_image():
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    cases = [_nms_case(s, 200) for s in (7, 8, 9)]
    b, s, v = (torch.from_numpy(np.stack(x)) for x in zip(*cases))
    o, k = nms_rotated_masked(b, s, v, 0.3, max_keep=60)
    for i in range(3):
        oi, ki = nms_rotated_masked(b[i], s[i], v[i], 0.3, max_keep=60)
        assert torch.equal(o[i], oi) and torch.equal(k[i], ki)


def test_nms_empty():
    from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked

    o, k = nms_rotated_masked(torch.zeros(0, 5), torch.zeros(0),
                              torch.zeros(0, dtype=torch.bool), 0.5)
    assert o.shape == k.shape == (0,)
