"""Port model parity: YOLOv7, v5 and v4 with the CSL head, and YOLOv7 and
v5 with the KFIoU head (18 rotated anchors, 6 + nc features each): forward,
deploy fusion and decode.

Same jittered weights and the same numpy images through the JAX model and
the port (NHWC/HWIO there, NCHW/OIHW here; head maps compare after
``reshape_head``).  Bounds: eval forward within the
tests/test_checkpoint.py:132-135 bounds (raw heads 2e-4, decoded rows
2e-3); deploy forward within tests/test_deploy.py:72-79.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (MODEL_CFG, NC, jax_ver, limit_threads,
                                nhwc_to_nchw, torch_model, ver_mode)

# "ver" alone is the CSL head
MODELS = ["yolov7", "yolov5", "yolov4", "yolov7-kfiou", "yolov5-kfiou"]


@pytest.fixture(scope="module", params=MODELS)
def models(request):
    limit_threads()
    ver, mode = ver_mode(request.param)
    jmodel, variables = jax_ver(ver, seed=0, mode=mode)
    return jmodel, variables, torch_model(variables, ver, mode)


def _images(img, seed=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (2, img, img, 3)).astype(np.float32)


def _deploy_tol(r):
    # the folds are exact linear algebra; the residual is f32 summation
    # order through ~100 convs, so atol rides the logit magnitude
    return dict(rtol=1e-3, atol=1e-4 * np.abs(r).max() + 1e-4)


@pytest.mark.parametrize("img", [64, 96])
def test_eval_forward_matches_jax(models, img):
    jmodel, variables, tmodel = models
    x = _images(img)
    j_outs, j_dec = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, decode=True))(variables, jnp.asarray(x))
    with torch.no_grad():
        t_outs, t_dec = tmodel(nhwc_to_nchw(x), decode=True)
    for j, t in zip(j_outs, t_outs):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=2e-3)


def test_deploy_forward_matches_jax_fused(models):
    from ryolo_tpu.nn import fuse_for_inference as jax_fuse
    from ryolo_tpu_torch.nn import fuse_for_inference

    jmodel, variables, tmodel = models
    x = _images(64, seed=2)
    dep_model, dep_vars = jax_fuse(jmodel, variables)
    j_outs, j_dec = jax.jit(lambda v, x: dep_model.apply(
        v, x, train=False, decode=True))(dep_vars, jnp.asarray(x))
    fused = fuse_for_inference(tmodel)
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in fused.modules())
    with torch.no_grad():
        t_outs, t_dec = fused(nhwc_to_nchw(x), decode=True)
    for j, t in zip(j_outs, t_outs):
        r = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), r, **_deploy_tol(r))
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), rtol=1e-3,
                               atol=2e-2)


def test_deploy_forward_matches_unfused_port(models):
    from ryolo_tpu_torch.nn import fuse_for_inference

    _, _, tmodel = models
    x = nhwc_to_nchw(_images(96, seed=3))
    with torch.no_grad():
        r_outs, r_dec = tmodel(x, decode=True)
        f_outs, f_dec = fuse_for_inference(tmodel)(x, decode=True)
    for r, o in zip(r_outs, f_outs):
        r = r.numpy()
        np.testing.assert_allclose(o.numpy(), r, **_deploy_tol(r))
    np.testing.assert_allclose(f_dec.numpy(), r_dec.numpy(), rtol=1e-3,
                               atol=2e-2)


def test_fused_weights_equal_jax_folds(models):
    """Every fused conv that the JAX deploy tree keeps unmerged (it also
    packs cv1/cv2 pairs and rewrites the stem, TPU layout tricks the port
    leaves out) equals the port's fold bit for bit."""
    import re

    from ryolo_tpu.nn.deploy import fuse_variables
    from ryolo_tpu_torch.nn.deploy import fuse_state_dict

    jmodel, variables, tmodel = models
    jfused = fuse_variables(variables, ver=tmodel.ver)["params"]
    compared = 0
    for name, t in fuse_state_dict(tmodel).items():
        name = re.sub(r"\.m\.(\d+)\.", r".m_\1.", name)
        parts = name.replace(".conv.0.", ".conv.").split(".")
        leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
        node = jfused
        for p in parts[:-1]:
            node = node.get(p, {}) if isinstance(node, dict) else {}
        if leaf not in node:
            continue
        want = np.asarray(node[leaf])
        if leaf == "kernel":
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
        compared += 1
    # BN folds (and for v7 the RepConv merges and implicit heads) outside
    # the merged cv1/cv2 pairs and the stem
    assert compared > {"yolov7": 100, "yolov5": 80, "yolov4": 100}[
        tmodel.ver], compared


def test_defer_forward_matches_decode(models):
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_csl_defer, decode_kfiou_scores

    tmodel = models[2]
    x = nhwc_to_nchw(_images(64, seed=5))
    with torch.no_grad():
        heads, (dec, heads2) = tmodel(x, decode="defer")
        raw = tmodel(x)
    assert heads is heads2
    for h, r in zip(heads, raw):
        assert torch.equal(h, r)
    if tmodel.mode == "csl":
        assert torch.equal(dec, decode_csl_defer(raw, tmodel.anchors,
                                                 STRIDES, NC))
    else:
        conf, cls_id = decode_kfiou_scores(raw, tmodel.na, NC)
        assert torch.equal(dec[0], conf) and torch.equal(dec[1], cls_id)
        assert conf.shape == (2, 18 * (8 * 8 + 4 * 4 + 2 * 2))


def test_repconv_identity_branch_fuses():
    """RepConv with c1 == c2 carries the identity BN (no v7 neck RepConv
    does); its fused 3x3 conv must equal the three branches."""
    from ryolo_tpu_torch.nn.blocks import RepConv
    from ryolo_tpu_torch.nn.deploy import _fuse_repconv

    torch.manual_seed(0)
    rep = RepConv(8, 8).eval()
    with torch.no_grad():
        for bn in (rep.rbr_identity, rep.rbr_dense[1], rep.rbr_1x1[1]):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0, 0.2)
            bn.running_mean.normal_(0, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    w, b = _fuse_repconv(rep.state_dict(), "", rep)
    fused = RepConv(8, 8, deploy=True).eval()
    fused.fused.weight.data = torch.from_numpy(w)
    fused.fused.bias.data = torch.from_numpy(b)
    x = torch.randn(2, 8, 9, 9)
    with torch.no_grad():
        np.testing.assert_allclose(fused(x).numpy(), rep(x).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_fused_model_is_conv_bias_act_only(models):
    from ryolo_tpu_torch.nn import fuse_for_inference

    fused = fuse_for_inference(models[2])
    names = set(fused.state_dict())
    assert not any("implicit" in n or "running" in n or "rbr_" in n
                   for n in names)
    assert all(n.endswith((".weight", ".bias")) for n in names)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_csl_defer_matches_jax(seed):
    """decode_csl_defer and decode_csl on identical head maps: the JAX
    decode reads NHWC maps, the port the same maps as NCHW."""
    from ryolo_tpu.nn.heads import decode_csl as j_full
    from ryolo_tpu.nn.heads import decode_csl_defer as j_defer
    from ryolo_tpu.nn.yolo import STRIDES, make_anchors
    from ryolo_tpu_torch.nn.heads import decode_csl, decode_csl_defer

    rng = np.random.default_rng(seed)
    anchors = make_anchors(STRIDES, MODEL_CFG["anchors"])
    nf = NC + 185
    maps = [rng.normal(0, 2, (2, s, s, 3 * nf)).astype(np.float32)
            for s in (12, 6, 3)]
    want = np.asarray(j_defer([jnp.asarray(m) for m in maps], anchors,
                              STRIDES, NC))
    got = decode_csl_defer([nhwc_to_nchw(m) for m in maps], anchors,
                           STRIDES, NC).numpy()
    assert got.shape == want.shape == (2, 3 * (144 + 36 + 9), NC + 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert np.all(got[..., 4] == 0.0)
    want = np.asarray(j_full([jnp.asarray(m) for m in maps], anchors,
                             STRIDES, NC))
    got = decode_csl([nhwc_to_nchw(m) for m in maps], anchors, STRIDES,
                     NC).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # theta: the same argmax bin on the same logits
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-6)


def test_reshape_head_matches_jax():
    from ryolo_tpu.nn.heads import reshape_head as j_reshape
    from ryolo_tpu_torch.nn.heads import reshape_head

    x = np.random.default_rng(4).normal(size=(2, 5, 7, 3 * 9)).astype(
        np.float32)
    np.testing.assert_array_equal(
        reshape_head(nhwc_to_nchw(x), 3, 9).numpy(),
        np.asarray(j_reshape(jnp.asarray(x), 3, 9)))
