"""The port trained end to end and held on its trained weights
(counterparts of tests/test_e2e.py and tests/test_trained_parity.py).

* ``test_overfit_two_images`` (tier-1): the port's YOLOv5-CSL ``Trainer``
  overfits tests/test_e2e.py's two 64 px images with its criterion; the
  trained model goes out through the port's ``save_pth``, the JAX package
  reads it (``load_pth`` + ``import_state_dict``), and JAX's eval-mode
  forward lies within the raw-head bound of tests/test_checkpoint.py:
  132-135 of the port's; after ``fuse_for_inference`` on both sides the
  port's keep sets equal JAX's post-process of the port's own fused maps,
  and pair with JAX's whole run row by row (``_assert_same_keep_set``).
* ``test_optimizer_matches_optax``: the port's ``make_optimizer`` against
  JAX's (optax under ``inject_hyperparams``), the same gradients for five
  steps of changing learning rate.
* ``test_synth_writer_matches_jax``: the synthetic writer that
  ``chip_smoke.py`` carries (it imports nothing of the JAX package) writes
  the files of tests/make_synth_data.py.
* ``slow``: the trained-checkpoint mAP (tests/test_trained_parity.py:
  124-272's recipe) for each head, and the matching at DOTA density
  (:275-356).  Their other stack is JAX's ``evaluate`` on the port's
  ``.pth``: the two stacks are compared on one file, never two trainings
  (the KFIoU endpoint is chaotic across numerics, :247-256).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_evaluator import _assert_same_keep_set
from tests.test_torch_model import _deploy_tol
from tests.torch_parity import MODEL_CFG, NC, limit_threads, nhwc_to_nchw

HYP = {"box": 0.05, "obj": 1.0, "cls": 0.5, "obj_pw": 1.0, "cls_pw": 1.0,
       "fl_gamma": 0.0, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
       "rotate": 45, "translate": 0.1, "scale": 0.5, "flipud": 0.5,
       "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.15}
NAMES = ["a", "b"]
IMG = 96
# the eval protocol of tests/test_trained_parity.py:215-218
EVAL = dict(conf_thres=0.001, iou_thres=0.65, max_targets=32,
            progress=False)
# mAP bounds of tests/test_trained_parity.py: the two stacks (:257-258),
# the floors (:260), int8 against f32 (:271-272)
MAP_BOUND = 5e-3
FLOORS = {"csl": 0.5, "kfiou": 0.02}
INT8_BOUNDS = (5e-3, 1e-2)


def _overfit_batch():
    """tests/test_e2e.py:31-46: two images with one bright rotated
    rectangle each, one target each."""
    from ryolo_tpu_torch.geometry import csl_gaussian_labels_np

    B, T, img = 2, 4, 64
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 0.2, (B, img, img, 3)).astype(np.float32)
    images[0, 16:30, 10:50] = 0.9  # wide box
    images[1, 30:60, 24:38] = 0.9  # tall box
    tgt = np.zeros((B, T, 6), np.float32)
    mask = np.zeros((B, T), bool)
    tgt[0, 0] = [0, 30 / 64, 23 / 64, 14 / 64, 40 / 64, 0.0]
    tgt[1, 0] = [1, 31 / 64, 45 / 64, 14 / 64, 30 / 64, np.pi / 2 - 1e-3]
    mask[0, 0] = mask[1, 0] = True
    bins = csl_gaussian_labels_np(tgt[..., 5] * 180 / np.pi + 90).reshape(
        B, T, 180)
    return images, {"images": nhwc_to_nchw(images),
                    "tgt": torch.from_numpy(tgt),
                    "tgt_csl": torch.from_numpy(bins),
                    "tgt_mask": torch.from_numpy(mask)}


def _port_trainer(mode, optimizer, lr):
    """The port's YOLOv5 with the ``mode`` head from
    ``weights_init_normal``, and its ``Trainer`` on the CPU."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer, weights_init_normal

    model = Yolo(NC, MODEL_CFG, mode=mode, ver="yolov5")
    weights_init_normal(model, torch.Generator().manual_seed(1))
    loss_fn = LOSS_FNS[mode](model.anchors, NC, HYP, "cpu")
    return Trainer(model, loss_fn, optimizer, lr)


def _jax_from_pth(path, mode):
    """JAX's YOLOv5 with the ``mode`` head and the weights of the ``.pth``
    at ``path`` (``load_pth`` + ``import_state_dict`` into the tree of
    ``Yolo(...).init``, its shapes from ``jax.eval_shape``)."""
    from ryolo_tpu.nn import Yolo
    from ryolo_tpu.utils.checkpoint import import_state_dict, load_pth

    model = Yolo(n_classes=NC, model_config=MODEL_CFG, mode=mode,
                 ver="yolov5")
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = load_pth(str(path))
    variables, loaded = import_state_dict(sd, template)
    # every tensor but the BatchNorms' num_batches_tracked, which JAX lacks
    n = sum(not k.endswith("num_batches_tracked") for k in sd)
    assert loaded == n == len(jax.tree_util.tree_leaves(template))
    return model, variables


def _reestimate_bn(model, images, passes=40):
    """The running statistics of the weights as they are: ``passes``
    training-mode forwards without gradient (momentum 0.1: 0.9 ** 40, 1.5%
    of the old statistics, remains).  Returns the model in eval mode."""
    model.train()
    with torch.no_grad():
        for _ in range(passes):
            model(images)
    return model.eval()


def _heads_gap(got, want, what):
    """Each level's head maps within the deploy bound of
    tests/test_torch_model.py (rtol 1e-3, atol 1e-4 of the level's largest
    entry + 1e-4: float32 summation order through ~100 convs rides the
    logit magnitude); returns the largest gap."""
    gaps = []
    for t, j in zip(got, want):
        t, j = t.float().numpy(), np.asarray(j)
        tol = _deploy_tol(j)
        gaps.append(float(np.abs(t - j).max()))
        used = np.abs(t - j) / (tol["atol"] + tol["rtol"] * np.abs(j))
        print(f"{what}: level {t.shape}, largest entry "
              f"{np.abs(j).max():.4g}, gap {gaps[-1]:.3g}, "
              f"{used.max():.2f} of the bound")
        np.testing.assert_allclose(t, j, **tol)
    return max(gaps)


def test_overfit_two_images(tmp_path):
    """tests/test_e2e.py's overfit through the port's ``Trainer`` (SGD,
    the same warm-up, 120 steps, the same criterion), then the trained
    ``.pth`` read by JAX.

    The bridge re-estimates the BatchNorm running statistics first
    (``_reestimate_bn``): after the overfit they lag its last steps, and
    the eval-mode heads reach -172 to -57,697 on the objectness (2.7 in
    training mode at the targets; tests/test_e2e.py asserts only that they
    are finite), so nothing passes conf 0.001.  On these weights the
    float32 forward of either framework lies up to 3e-4 of the largest
    entry from the port's float64 forward, so JAX's raw heads are held to
    the port's by the deploy bound that rides the logit magnitude
    (``_heads_gap``), not tests/test_checkpoint.py:132-135's atol 2e-4,
    which was set on heads of magnitude ~1; the whole run's scores then
    differ by at most half the largest fused-map gap (the sigmoid's slope
    is at most 1/4, and a score is two sigmoids' product)."""
    import ryolo_tpu.eval.postprocess as jpp
    from ryolo_tpu.nn import fuse_for_inference as jax_fuse
    from ryolo_tpu_torch.eval.postprocess import post_process_defer
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.utils.checkpoint import save_pth

    limit_threads()
    images, batch = _overfit_batch()
    trainer = _port_trainer("csl", "SGD", 0.01)
    losses = []
    for step in range(120):
        # linear warm-up, as tests/test_e2e.py:70
        lr = 0.005 * min(1.0, (step + 1) / 40)
        loss, items = trainer.train_step(batch, lr, 1)
        losses.append(float(loss))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print("loss first 5", first, "last 5", last)
    assert np.isfinite(losses).all(), "training produced non-finite loss"
    assert last < 0.6 * first, (first, last)
    for k, v in items.items():
        assert np.isfinite(float(v)), k
    model = trainer.model.eval()
    with torch.no_grad():
        outs = model(batch["images"])
    assert all(torch.isfinite(o).all() for o in outs)

    # the bridge: the port's .pth, read by JAX
    model = _reestimate_bn(model, batch["images"])
    pth = tmp_path / "trained.pth"
    save_pth(model, str(pth))
    jmodel, jvars = _jax_from_pth(pth, "csl")
    with torch.no_grad():
        outs, _ = model(batch["images"], decode=True)
    j_outs, _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, decode=True))(jvars, jnp.asarray(images))
    _heads_gap(outs, j_outs, "raw heads, port / JAX on the port's .pth")

    # both fused: the maps; the port's keep sets against JAX's
    # post-process of the port's own fused maps (exactly) and against
    # JAX's whole run (row by row)
    fused = fuse_for_inference(model, device="cpu")
    dep_model, dep_vars = jax_fuse(jmodel, jvars)
    with torch.no_grad():
        f_outs, _ = fused(batch["images"], decode=True)
        _, (dec, neck) = fused(batch["images"], decode="defer")
        dets, valid = post_process_defer(dec, neck, fused.na, NC, 0.001,
                                         0.65)
    jf_outs, _ = jax.jit(lambda v, x: dep_model.apply(
        v, x, train=False, decode=True))(dep_vars, jnp.asarray(images))
    fused_gap = _heads_gap(f_outs, jf_outs, "fused heads, port / JAX")
    j_neck = tuple(jnp.asarray(m.permute(0, 2, 3, 1).numpy()) for m in neck)
    w_dets, w_valid = jpp.post_process_defer(jnp.asarray(dec.numpy()),
                                             j_neck, 3, NC, 0.001, 0.65)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(w_valid))
    exact = [0, 1, 2, 3, 5, 6]
    np.testing.assert_array_equal(dets.numpy()[..., exact],
                                  np.asarray(w_dets)[..., exact])
    np.testing.assert_allclose(dets.numpy()[..., 4],
                               np.asarray(w_dets)[..., 4], atol=1e-6)

    @jax.jit
    def jax_run(v, x):
        _, (d, n) = dep_model.apply(v, x, train=False, decode="defer")
        return jpp.post_process_defer(d, n, 3, NC, 0.001, 0.65)

    j_dets, j_valid = (np.asarray(a) for a in jax_run(dep_vars,
                                                      jnp.asarray(images)))
    kept = valid.sum(1).tolist()
    print("kept per image", kept, "JAX", j_valid.sum(1).tolist())
    assert min(kept) >= 50  # the weights detect: a real keep set
    for b in range(len(images)):
        g, w = dets[b][valid[b]].numpy(), j_dets[b][j_valid[b]]
        moved = _assert_same_keep_set(g, w, fused_gap / 2)
        print(f"image {b}: scores within {np.abs(g[:, 5] - w[:, 5]).max():.3g}"
              f" in order, {moved} rows trade places")


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_matches_optax(name):
    """The port's ``make_optimizer`` (torch.optim) against JAX's
    (``optax.inject_hyperparams``): the same numpy parameters and, each
    step, the same gradients and learning rate, for 5 steps; the
    parameters within 1e-6 relative.  One tensor's gradients are ~1e-8,
    where Adam's ``eps`` (1e-8 in both) decides the update."""
    import optax

    from ryolo_tpu.train.trainer import make_optimizer as jax_make
    from ryolo_tpu_torch.train import make_optimizer

    rng = np.random.default_rng(0)
    shapes = [(8, 3, 3, 3), (8,), (5, 4)]
    scales = [1.0, 0.1, 1e-8]  # gradient scale of each tensor
    init = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    lrs = [1e-3, 5e-3, 2e-3, 8e-3, 3e-4]
    grads = [[(sc * rng.normal(0, 1, s)).astype(np.float32)
              for s, sc in zip(shapes, scales)] for _ in lrs]

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = make_optimizer(name, params)
    tx = jax_make(name)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    for lr, g in zip(lrs, grads):
        for group in opt.param_groups:
            group["lr"] = lr
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        updates, state = tx.update([jnp.asarray(gi) for gi in g], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, j, p0, sc in zip(params, jparams, init, scales):
        got, want = p.detach().numpy(), np.asarray(j)
        if name == "Adam" or sc > 1e-8:  # SGD's steps of ~1e-10 round off
            assert np.abs(want - p0).max() > 1e-4  # the steps moved it
        # relative L2 over the tensor: each side lies ~5e-8 from a float64
        # Adam, a few ulps apart by operation order (element by element up
        # to 5e-6 where an entry is small); Adam's eps at 1e-6 gives 3e-3
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        print(name, p.shape, f"relative L2 {rel:.2e}")
        assert rel <= 1e-6, (name, tuple(p.shape), rel)


# tests/test_trained_parity.py's two writes: the trained set (:207-208)
# and the dense split (:316-319)
WRITES = {
    "synth": dict(n_images=8, img_size=IMG, seed=11, w_range=(0.18, 0.28),
                  ratio=(1.2, 1.6)),
    "dense": dict(n_images=4, img_size=2 * IMG, seed=23,
                  w_range=(0.09, 0.14), ratio=(1.2, 1.6), min_obj=60,
                  max_obj=81),
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.mark.parametrize("which", sorted(WRITES))
def test_synth_writer_matches_jax(tmp_path, which):
    """``chip_smoke.py``'s ``write_custom_set`` / ``write_custom_split``
    against tests/make_synth_data.py's ``main`` / ``make_split`` on the
    same arguments: the splits it writes (main's train and val, not its
    test split and data.yaml) hold the same files, ``.txt`` labels equal,
    PNGs equal byte for byte."""
    import chip_smoke
    from tests import make_synth_data

    kw = dict(WRITES[which])
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    if which == "synth":
        make_synth_data.main(jax_root, **kw)
        chip_smoke.write_custom_set(port_root, **kw)
    else:
        seed = kw.pop("seed")
        make_synth_data.make_split(jax_root, rng=np.random.default_rng(seed),
                                   **kw)
        chip_smoke.write_custom_split(port_root,
                                      rng=np.random.default_rng(seed), **kw)
    files = _files(port_root)
    assert files == [f for f in _files(jax_root) if which == "dense"
                     or f.split(os.sep)[0] in ("train", "val")]
    assert sum(f.endswith(".png") for f in files) == (
        8 + 4 if which == "synth" else 4)
    n_rows = []
    for f in files:
        with open(os.path.join(jax_root, f), "rb") as a, \
                open(os.path.join(port_root, f), "rb") as b:
            want, have = a.read(), b.read()
        assert have == want, f
        if f.endswith(".txt"):
            n_rows.append(len(want.decode().splitlines()))
    if which == "dense":  # the density tests/test_trained_parity.py needs
        assert min(n_rows) >= 60, n_rows


# ---------------------------------------------------------------------------
# slow: trained checkpoints (tests/test_trained_parity.py's recipe)
# ---------------------------------------------------------------------------


def train_port(root, mode, steps=None):
    """tests/test_trained_parity.py:124-186 through the port: YOLOv5 with
    the ``mode`` head from ``weights_init_normal``, Adam at 2e-3 with a
    50-step warm-up (KFIoU: x 0.1 after step 400), the custom loader at
    96 px, batch 4, no augmentation, 520 steps (CSL) or 900 (KFIoU); the
    last 10 losses below half the first 10.  Returns ``(model, losses)``,
    the model in eval mode."""
    from ryolo_tpu_torch.data.loader import load_data

    trainer = _port_trainer(mode, "Adam", 2e-3)
    _, loader = load_data(os.path.join(root, "train"), NAMES, "custom", HYP,
                          csl=mode == "csl", img_size=IMG, batch_size=4,
                          augment=False, shuffle=True, max_targets=16)
    steps = steps or (520 if mode == "csl" else 900)
    losses = []
    while len(losses) < steps:
        for batch in loader:
            if len(losses) >= steps:
                break
            step = len(losses)
            base = 2e-3 if (mode == "csl" or step < 400) else 2e-4
            lr = base * min(1.0, (step + 1) / 50)
            arrays = {k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items() if k != "paths"}
            arrays["images"] = arrays["images"].permute(0, 3, 1, 2)
            loss, _ = trainer.train_step(arrays, lr, 1)
            losses.append(float(loss))
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"{mode}: loss first 10 {first:.5f}, last 10 {last:.5f}")
    assert last < 0.5 * first, (first, last)
    return trainer.model.eval(), losses


def port_eval(model, data, mode, img, batch, quantize=False, **kw):
    """The port's ``fuse_for_inference`` (``quantize``: the float32 graph
    with the wide convs int8, as tests/test_trained_parity.py:264 fuses)
    + ``evaluate`` on the CPU: ``(mp, mr, map50, map5095)``."""
    from ryolo_tpu_torch.eval.evaluator import evaluate
    from ryolo_tpu_torch.nn import fuse_for_inference

    fused = fuse_for_inference(model, device="cpu", quantize=quantize)
    return evaluate(fused, None, data, HYP, mode == "csl", img, batch,
                    device="cpu", **dict(EVAL, **kw))[:4]


def jax_eval(pth, data, mode, img, batch, quantize=False, **kw):
    """JAX's ``fuse_for_inference`` (``quantize`` as :func:`port_eval`) +
    ``evaluate`` on the port's ``.pth``: ``(mp, mr, map50, map5095)``."""
    from ryolo_tpu.eval.evaluator import evaluate
    from ryolo_tpu.nn import fuse_for_inference

    model, variables = _jax_from_pth(pth, mode)
    dep_model, dep_vars = fuse_for_inference(model, variables,
                                             quantize=quantize)
    return evaluate(dep_model, dep_vars, None, data, HYP, mode == "csl",
                    img, batch, **dict(EVAL, **kw))[:4]


def _check_maps(got, want, what, bounds=(MAP_BOUND, MAP_BOUND)):
    print(f"{what}: mAP@.5 {got[2]:.6f} / {want[2]:.6f} "
          f"(gap {abs(got[2] - want[2]):.2e}), mAP@.5:.95 {got[3]:.6f} / "
          f"{want[3]:.6f} (gap {abs(got[3] - want[3]):.2e})")
    assert abs(got[2] - want[2]) <= bounds[0], (what, got, want)
    assert abs(got[3] - want[3]) <= bounds[1], (what, got, want)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The trained set of tests/test_trained_parity.py:207-208."""
    from tests import make_synth_data

    root = str(tmp_path_factory.mktemp("synth"))
    make_synth_data.main(root, **WRITES["synth"])
    return root


@pytest.fixture(scope="module")
def trained_csl(synth, tmp_path_factory):
    """The port's CSL model trained on ``synth``, and its ``.pth``."""
    from ryolo_tpu_torch.utils.checkpoint import save_pth

    limit_threads()
    model, _ = train_port(synth, "csl")
    pth = tmp_path_factory.mktemp("csl") / "trained.pth"
    save_pth(model, str(pth))
    return model, pth


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["csl", "kfiou"])
def test_trained_checkpoint_map_parity(synth, request, tmp_path, mode):
    """The port trains (``train_port``) and writes ``save_pth``; JAX's
    ``evaluate`` on that file against the port's, on the val split: both
    mAPs within 5e-3, the port above JAX's floor; for CSL the port's int8
    within 5e-3 of JAX's int8 on the same file, and within 5e-3 / 1e-2 of
    its f32 (``_check_int8_cost``)."""
    from ryolo_tpu_torch.utils.checkpoint import save_pth

    limit_threads()
    if mode == "csl":
        model, pth = request.getfixturevalue("trained_csl")
    else:
        model, _ = train_port(synth, mode)
        pth = tmp_path / "trained.pth"
        save_pth(model, str(pth))
    data = {"val": os.path.join(synth, "val"), "names": NAMES,
            "type": "custom"}
    got = port_eval(model, data, mode, IMG, 4)
    want = jax_eval(pth, data, mode, IMG, 4)
    _check_maps(got, want, f"{mode} f32, port / JAX")
    assert got[2] > FLOORS[mode], f"model failed to learn ({got[2]})"
    # the 8 training images' 24 targets: a finer statistic than the val
    # split's 9, which the overfit must score (chip_smoke.py phase 19)
    train = dict(data, val=os.path.join(synth, "train"))
    got_t = port_eval(model, train, mode, IMG, 4)
    _check_maps(got_t, jax_eval(pth, train, mode, IMG, 4),
                f"{mode} f32 on the training images, port / JAX")
    assert got_t[2] > FLOORS[mode], f"training images: {got_t[2]}"
    if mode == "csl":
        q = port_eval(model, data, mode, IMG, 4, quantize=True)
        jq = jax_eval(pth, data, mode, IMG, 4, quantize=True)
        _check_maps(q, jq, "csl int8, port / JAX")
        _check_int8_cost(q, got, jq, want)


def _check_int8_cost(q, f, jq, jf):
    """int8's cost on one checkpoint: the port's int8 ``q`` within
    ``INT8_BOUNDS`` of its float32 ``f`` (tests/test_trained_parity.py:
    271-272), unless JAX's int8 ``jq`` lies as far from JAX's float32
    ``jf`` on the same ``.pth`` (within 5e-3).  The val split holds 9
    targets, so one detection's rank moves mAP@.5 by ~0.1: on the port's
    CPU endpoint both frameworks' int8 score mAP@.5 1.09e-2 above their
    float32, and on JAX's own endpoint JAX's int8 scores 3.67e-2 above its
    float32 (ROADMAP §C): a cost of the checkpoint, not of either
    implementation."""
    gaps = [abs(q[i] - f[i]) for i in (2, 3)]
    jgaps = [abs(jq[i] - jf[i]) for i in (2, 3)]
    print(f"int8 cost (mAP@.5, mAP@.5:.95): port {gaps}, JAX {jgaps}")
    if gaps[0] > INT8_BOUNDS[0] or gaps[1] > INT8_BOUNDS[1]:
        assert all(abs(g - j) <= MAP_BOUND for g, j in zip(gaps, jgaps)), (
            gaps, jgaps)


@pytest.fixture(scope="module")
def jax_trained_csl(synth, tmp_path_factory):
    """JAX's own CSL endpoint of the recipe
    (tests/test_trained_parity.py::_train_overfit), as a ``.pth``."""
    from ryolo_tpu.utils.checkpoint import save_pth
    from tests.test_trained_parity import _train_overfit

    _, variables = _train_overfit(synth, mode="csl")
    pth = tmp_path_factory.mktemp("jax_csl") / "trained.pth"
    save_pth(variables, "yolov5", str(pth))
    return pth


@pytest.mark.slow
def test_trained_parity_dota_density(synth, trained_csl, jax_trained_csl,
                                     tmp_path, monkeypatch):
    """tests/test_trained_parity.py:310-356's dense 192 px split (seed 23,
    4 images, at least 60 targets each): JAX's ``evaluate`` against the
    port's at batch 2, both mAPs within 5e-3, on the port's trained CSL
    ``.pth`` and on JAX's own endpoint of the recipe; at least 100
    detections through the port's matcher.  JAX's endpoint is also held
    on the val split, f32 and int8 (``_check_int8_cost``).

    The scenes are out of the training distribution (60-80 overlapping
    rectangles cover the image), and what an endpoint of the recipe fires
    there is chaotic across float32 rounding: the port's CPU endpoint here
    fires nothing at conf 0.001, four endpoints on the card 0 to 7
    detections (scripts/torch_trained_spread.py), JAX's CPU endpoint 206.
    So JAX's endpoint gives the matcher its work, and the port's is held
    to JAX on what it fires."""
    import ryolo_tpu_torch.eval.evaluator as pev
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import load_pth
    from tests import make_synth_data

    limit_threads()
    kw = dict(WRITES["dense"])
    dense = str(tmp_path / "dense_val")
    make_synth_data.make_split(dense, rng=np.random.default_rng(
        kw.pop("seed")), **kw)
    data = {"val": dense, "names": NAMES, "type": "custom"}
    n_det, stats = [0], pev.get_batch_statistics

    def count(outputs, *a):
        n_det[0] += sum(len(o) for o in outputs)
        return stats(outputs, *a)

    monkeypatch.setattr(pev, "get_batch_statistics", count)
    jax_model = Yolo(NC, MODEL_CFG, mode="csl", ver="yolov5")
    jax_model.load_state_dict(load_pth(str(jax_trained_csl)))
    dets = {}
    for name, (model, pth) in {"port": trained_csl,
                               "JAX": (jax_model.eval(), jax_trained_csl)
                               }.items():
        n_det[0] = 0
        got = port_eval(model, data, "csl", 2 * IMG, 2, max_targets=96)
        dets[name] = n_det[0]
        want = jax_eval(pth, data, "csl", 2 * IMG, 2, max_targets=96)
        _check_maps(got, want, f"dense csl f32 on {name}'s endpoint, "
                    "port / JAX")
    print("detections through the port's matcher", dets)
    assert dets["JAX"] >= 100, dets

    val = {"val": os.path.join(synth, "val"), "names": NAMES,
           "type": "custom"}
    f, q = (port_eval(jax_model, val, "csl", IMG, 4, quantize=i)
            for i in (False, True))
    jf, jq = (jax_eval(jax_trained_csl, val, "csl", IMG, 4, quantize=i)
              for i in (False, True))
    _check_maps(f, jf, "csl f32 on JAX's endpoint, port / JAX")
    _check_maps(q, jq, "csl int8 on JAX's endpoint, port / JAX")
    _check_int8_cost(q, f, jq, jf)
