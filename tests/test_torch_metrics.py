"""The port's mAP stack against the JAX package's (``ryolo_tpu/eval/
metrics.py``), exactly: the C++ matcher and its numpy plain version give
the TP matrices of the JAX matcher on random scenes, contested targets,
class mismatches and DOTA-density scenes; AP, PR and the aggregated
statistics are equal to the last bit."""

import numpy as np
import pytest

from ryolo_tpu.eval import metrics as jm
from ryolo_tpu_torch.eval import metrics as pm

IOUV = np.linspace(0.5, 0.95, 10)


def _random_scene(rng, n_pred, n_tar, nc):
    """Random boxes with every second prediction planted on a target
    (jittered), so argmax targets are contested (as
    tests/test_metrics.py:55 builds them)."""
    def boxes(n):
        out = np.zeros((n, 5), np.float32)
        out[:, 0:2] = rng.uniform(20, 200, (n, 2))
        out[:, 2:4] = rng.uniform(8, 60, (n, 2))
        out[:, 4] = rng.uniform(-np.pi / 2, np.pi / 2, n)
        return out

    pred = np.zeros((n_pred, 7), np.float32)
    pred[:, :5] = boxes(n_pred)
    pred[:, 5] = np.sort(rng.uniform(0.01, 1, n_pred))[::-1]
    pred[:, 6] = rng.integers(0, nc, n_pred)
    tar = np.zeros((n_tar, 6), np.float32)
    tar[:, 0] = rng.integers(0, nc, n_tar)
    tar[:, 1:6] = boxes(n_tar)
    for j in range(0, n_pred, 2):
        if n_tar:
            t = tar[rng.integers(0, n_tar)]
            pred[j, :5] = t[1:6] + rng.normal(0, 2, 5) * [1, 1, 1, 1, 0.02]
            pred[j, 6] = t[0]
    return pred, tar


def _dense_scene(rng, n_pred, n_tar, nc, img=800):
    """A DOTA-density scene as tests/test_metrics.py:175 builds it (half
    the predictions planted on targets, correct class boosted, unique
    confidences), returned as post-NMS detections ``(n, 7)`` in confidence
    order and pixel targets ``(m, 6)``."""
    tar = np.zeros((n_tar, 6), np.float32)
    tar[:, 0] = rng.integers(0, nc, n_tar)
    tar[:, 1:3] = rng.uniform(60, img - 60, (n_tar, 2))
    tar[:, 3:5] = rng.uniform(10, 90, (n_tar, 2))
    tar[:, 5] = rng.uniform(-np.pi / 2, np.pi / 2, n_tar)

    pred = np.zeros((n_pred, 6 + nc), np.float32)
    pred[:, 0:2] = rng.uniform(10, img - 10, (n_pred, 2))
    pred[:, 2:4] = rng.uniform(8, 100, (n_pred, 2))
    pred[:, 4] = rng.uniform(-np.pi / 2, np.pi / 2, n_pred)
    pred[:, 5] = rng.uniform(0.002, 0.95, n_pred)
    pred[:, 6:] = rng.uniform(0.01, 1.0, (n_pred, nc))
    for j in range(0, n_pred, 2):
        t = tar[rng.integers(0, n_tar)]
        pred[j, 0:2] = t[1:3] + rng.normal(0, 3, 2)
        pred[j, 2:4] = t[3:5] * rng.uniform(0.85, 1.15, 2)
        pred[j, 4] = t[5] + rng.normal(0, 0.05)
        pred[j, 6 + int(t[0])] = rng.uniform(0.7, 1.0)
    while True:  # unique confidences: one valid order
        conf = (pred[:, 6:] * pred[:, 5:6]).max(1).astype(np.float32)
        u, inv, counts = np.unique(conf, return_inverse=True,
                                   return_counts=True)
        if (counts == 1).all():
            break
        rows = np.isin(inv, np.flatnonzero(counts > 1))
        pred[rows, 5] = rng.uniform(0.002, 0.95, int(rows.sum()))
    dets = np.zeros((n_pred, 7), np.float32)
    dets[:, :5] = pred[:, :5]
    dets[:, 5] = conf
    dets[:, 6] = (pred[:, 6:] * pred[:, 5:6]).argmax(1)
    return dets[np.argsort(-conf, kind="stable")], tar


def _all_matchers_equal(pred, tar):
    want = jm.match_image_detections(pred, tar, IOUV)
    got = pm.match_image_detections(pred, tar, IOUV)
    plain = pm.match_image_detections_plain(pred, tar, IOUV)
    assert got.dtype == plain.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    return want


@pytest.mark.parametrize("seed", range(6))
def test_matcher_random_scenes(seed):
    rng = np.random.default_rng(seed)
    pred, tar = _random_scene(rng, int(rng.integers(0, 40)),
                              int(rng.integers(0, 12)), nc=3)
    _all_matchers_equal(pred, tar)


def test_matcher_contested_target():
    tar = np.array([[0, 100, 100, 40, 20, 0.3]], np.float32)
    pred = np.array([[100, 100, 40, 20, 0.3, 0.9, 0],
                     [101, 100, 40, 20, 0.3, 0.8, 0]], np.float32)
    tp = _all_matchers_equal(pred, tar)
    assert tp[0, 0] and not tp[1].any()


def test_matcher_class_mismatch():
    tar = np.array([[1, 100, 100, 40, 20, 0.0]], np.float32)
    pred = np.array([[100, 100, 40, 20, 0.0, 0.9, 0]], np.float32)
    assert not _all_matchers_equal(pred, tar).any()


@pytest.mark.parametrize("seed", [4, 5])
def test_matcher_dota_density(seed):
    """2048 detections over 112 targets of 15 classes per image."""
    rng = np.random.default_rng(seed)
    pred, tar = _dense_scene(rng, 2048, 112, 15)
    tp = _all_matchers_equal(pred, tar)
    assert tp[:, 0].sum() > 50 and tp[:, 4].sum() > 0


def test_pairwise_iou_host_matches_jax():
    rng = np.random.default_rng(1)
    pred, tar = _random_scene(rng, 30, 10, nc=1)
    deg = np.array([1, 1, 1, 1, 180 / np.pi], np.float32)
    a, b = pred[:, :5] * deg, tar[:, 1:6] * deg
    got = pm.pairwise_rotated_iou_host(a, b)
    assert got.dtype == np.float32 and (got > 0.5).any()
    np.testing.assert_array_equal(got, np.asarray(
        jm.pairwise_rotated_iou_host(a, b)))


def _batch(rng, n_img, nc, dense=False):
    outputs, targets = [], []
    for img in range(n_img):
        if dense:
            pred, tar = _dense_scene(rng, 600, 40, nc)
        else:
            pred, tar = _random_scene(rng, int(rng.integers(0, 12)),
                                      int(rng.integers(0, 6)), nc)
        outputs.append(pred)
        rows = np.zeros((len(tar), 7), np.float32)
        rows[:, 0] = img
        rows[:, 1:] = tar
        targets.append(rows)
    return outputs, np.concatenate(targets, 0)


def _assert_stats_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_eval_equal(got, want):
    # (nt, p, r, ap50, ap, f1, ap_class, mp, mr, map50, map)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dense", [False, True])
def test_batch_statistics_and_eval_stats(dense):
    rng = np.random.default_rng(5)
    outputs, targets = _batch(rng, 6, 3, dense)
    got = pm.get_batch_statistics(outputs, targets, IOUV, len(IOUV))
    want = jm.get_batch_statistics(outputs, targets, IOUV, len(IOUV))
    _assert_stats_equal(got, want)
    cat = [np.concatenate(x, 0) for x in zip(*got)]
    _assert_eval_equal(pm.calculate_eval_stats(cat, 3),
                       jm.calculate_eval_stats(cat, 3))


def test_images_without_predictions_or_labels():
    empty = np.zeros((0, 7), np.float32)
    pred, tar = _random_scene(np.random.default_rng(2), 5, 3, nc=2)
    rows = np.concatenate([np.zeros((3, 1), np.float32), tar], 1)
    rows[:, 0] = 1  # labels on image 1 only; image 2 has neither
    outputs = [pred, empty, empty]
    got = pm.get_batch_statistics(outputs, rows, IOUV, len(IOUV))
    _assert_stats_equal(got, jm.get_batch_statistics(outputs, rows, IOUV,
                                                     len(IOUV)))
    assert len(got) == 2 and got[1][0].shape == (0, 10)
    _assert_eval_equal(pm.calculate_eval_stats([], 2),
                       jm.calculate_eval_stats([], 2))


def test_compute_ap_and_ap_per_class():
    rng = np.random.default_rng(11)
    n = 200
    tp = rng.uniform(0, 1, (n, 10)) < np.linspace(0.6, 0.1, 10)
    tp = np.sort(tp, 1)[:, ::-1]
    conf = rng.uniform(0, 1, n)
    pred_cls = rng.integers(0, 4, n).astype(np.float64)
    target_cls = np.concatenate([rng.integers(0, 4, 60), [4]]).astype(
        np.float64)
    for g, w in zip(pm.ap_per_class(tp, conf, pred_cls, target_cls),
                    jm.ap_per_class(tp, conf, pred_cls, target_cls)):
        np.testing.assert_array_equal(g, w)
    rec = np.sort(rng.uniform(0, 0.9, 50))
    prec = np.clip(1 - rec + rng.normal(0, 0.05, 50), 0, 1)
    np.testing.assert_array_equal(pm.compute_ap(rec, prec),
                                  jm.compute_ap(rec, prec))
    cols = np.stack([rec, rec * 0.5], 1), np.stack([prec, prec[::-1]], 1)
    np.testing.assert_array_equal(pm.compute_ap(*cols), jm.compute_ap(*cols))


def test_padded_targets_to_rows_matches_jax():
    from ryolo_tpu.eval.evaluator import padded_targets_to_rows as jrows
    from ryolo_tpu_torch.eval.evaluator import padded_targets_to_rows

    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, 1, (3, 5, 6)).astype(np.float32)
    mask = rng.uniform(0, 1, (3, 5)) < 0.5
    mask[1] = False
    for m in (mask, np.zeros_like(mask)):
        got = padded_targets_to_rows(tgt, m, 96)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jrows(tgt, m, 96))


def test_jittered_ground_truth_scores_well():
    """Detections that are the targets jittered, plus clutter: mAP@.5 well
    above 0, and the same four numbers as the JAX stack."""
    rng = np.random.default_rng(8)
    outputs, rows = [], []
    for img in range(4):
        _, tar = _dense_scene(rng, 2, 30, 4, img=400)
        n = len(tar)
        det = np.zeros((n + 20, 7), np.float32)
        det[:n, :2] = tar[:, 1:3] + rng.normal(0, 1.5, (n, 2))
        det[:n, 2:4] = tar[:, 3:5] * rng.uniform(0.9, 1.1, (n, 2))
        det[:n, 4] = tar[:, 5] + rng.normal(0, 0.03, n)
        det[:n, 6] = tar[:, 0]
        det[n:, :5] = _random_scene(rng, 20, 0, 1)[0][:, :5]
        det[n:, 6] = rng.integers(0, 4, 20)
        det[:, 5] = rng.uniform(0.05, 1.0, n + 20)
        outputs.append(det[np.argsort(-det[:, 5], kind="stable")])
        r = np.zeros((n, 7), np.float32)
        r[:, 0] = img
        r[:, 1:] = tar
        rows.append(r)
    rows = np.concatenate(rows)
    res = []
    for mod in (pm, jm):
        stats = mod.get_batch_statistics(outputs, rows, IOUV, len(IOUV))
        cat = [np.concatenate(x, 0) for x in zip(*stats)]
        res.append(mod.calculate_eval_stats(cat, 4))
    assert res[0][9] > 0.5, res[0][7:]
    _assert_eval_equal(res[0], res[1])


def test_native_build_raises_without_gxx(tmp_path, monkeypatch):
    """No g++: the matcher raises, and nothing falls back to numpy."""
    from ryolo_tpu_torch.ops import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    pred = np.array([[100, 100, 40, 20, 0.3, 0.9, 0]], np.float32)
    tar = np.array([[0, 100, 100, 40, 20, 0.3]], np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pm.match_image_detections(pred, tar, IOUV)
    assert not (tmp_path / "native").exists()


def test_native_build_failure_carries_gxx_output(tmp_path, monkeypatch):
    from ryolo_tpu_torch.ops import native

    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.pairwise_rotated_iou_native(np.ones((1, 5)), np.ones((1, 5)))
