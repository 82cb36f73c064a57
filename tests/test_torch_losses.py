"""Port CSL loss against the JAX package on the same head maps and targets.

Head maps are made with numpy, NHWC for the JAX loss and NCHW for the
port's.  Bounds: the loss and each item within rtol 1e-5 (float32, the same
expressions, summed in another order), the gradient with respect to the
head maps within rtol 1e-4 (atol 1e-6 of its largest entry), the candidate
lattice and the duplicate-cell resolution of ``scatter_conf`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import MODEL_CFG

NC = 2
HYP = {"box": 0.05, "obj": 1.0, "cls": 0.5, "obj_pw": 1.0, "cls_pw": 1.0,
       "fl_gamma": 0.0}
GRIDS = (8, 4, 2)  # a 64 px input


def _anchors():
    from ryolo_tpu_torch.nn import STRIDES, make_anchors

    return make_anchors(STRIDES, MODEL_CFG["anchors"])


def _targets(seed, B=2, T=12, n=(9, 12)):
    """Loader-layout targets; with a dozen boxes on 2..8-cell grids many
    candidates share a cell."""
    from ryolo_tpu_torch.geometry import csl_gaussian_labels_np

    rng = np.random.default_rng(seed)
    tgt = np.zeros((B, T, 6), np.float32)
    mask = np.zeros((B, T), bool)
    for b in range(B):
        k = n[b]
        tgt[b, :k, 0] = rng.integers(0, NC, k)
        tgt[b, :k, 1:3] = rng.uniform(0.05, 0.95, (k, 2))
        tgt[b, :k, 3:5] = rng.uniform(0.03, 0.4, (k, 2))
        tgt[b, :k, 5] = rng.uniform(-np.pi / 2, np.pi / 2, k)
        mask[b, :k] = True
    csl = csl_gaussian_labels_np(tgt[..., 5] * 180 / np.pi + 90)
    return tgt, csl * mask[..., None], mask


def _heads(seed, B=2, scale=2.0):
    rng = np.random.default_rng(seed)
    nf = 185 + NC
    return [(scale * rng.standard_normal((B, g, g, 3 * nf))).astype(
        np.float32) for g in GRIDS]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed,fl_gamma", [(0, 0.0), (1, 0.0), (2, 1.5)])
def test_csl_loss_and_grad_match_jax(seed, fl_gamma):
    from ryolo_tpu.losses import csl_loss as jax_csl
    from ryolo_tpu_torch.losses import csl_loss

    hyp = dict(HYP, fl_gamma=fl_gamma)
    anchors = _anchors()
    tgt, csl, mask = _targets(seed)
    heads = _heads(seed)

    def jloss(outs):
        return jax_csl(outs, jnp.asarray(tgt), jnp.asarray(csl),
                       jnp.asarray(mask), anchors, NC, hyp)

    (jl, jitems), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(h) for h in heads])
    touts = [_nchw(h).requires_grad_(True) for h in heads]
    tl, titems = csl_loss(touts, torch.from_numpy(tgt), torch.from_numpy(csl),
                          torch.from_numpy(mask),
                          [torch.from_numpy(a) for a in anchors], NC, hyp)
    tl.backward()
    for k, v in jitems.items():
        np.testing.assert_allclose(titems[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    assert float(jl) > 0 and titems["reg_loss"].item() > 0
    for t, j in zip(touts, jgrad):
        j = np.asarray(j).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-4,
                                   atol=1e-6 * np.abs(j).max())


def test_candidates_match_jax():
    from ryolo_tpu.losses.assign import build_candidates as jax_build
    from ryolo_tpu_torch.losses.assign import build_candidates

    tgt, csl, mask = _targets(3)
    for anc, g in zip(_anchors(), GRIDS):
        j = jax_build(jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(anc),
                      g, g, tgt_csl=jnp.asarray(csl))
        t = build_candidates(torch.from_numpy(tgt), torch.from_numpy(mask),
                             torch.from_numpy(anc), g, g,
                             tgt_csl=torch.from_numpy(csl))
        for name in j._fields:
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                err_msg=name)


def test_scatter_conf_duplicates_resolve_as_jax():
    from ryolo_tpu.losses.assign import build_candidates as jax_build
    from ryolo_tpu.losses.assign import scatter_conf as jax_scatter
    from ryolo_tpu_torch.losses.assign import build_candidates, scatter_conf

    tgt, _, mask = _targets(4, T=24, n=(24, 20))
    anc, g = _anchors()[0], GRIDS[0]
    j = jax_build(jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(anc), g, g)
    t = build_candidates(torch.from_numpy(tgt), torch.from_numpy(mask),
                         torch.from_numpy(anc), g, g)
    cells = t.cell[t.valid]
    assert len(cells) > len(torch.unique(cells))  # duplicates present
    scores = np.random.default_rng(5).uniform(
        0.1, 1, t.cell.shape).astype(np.float32)
    want = np.asarray(jax_scatter((2, g, g, 3), j, jnp.asarray(scores)))
    got = scatter_conf((2, 3, g, g), t, torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_bbox_ciou_matches_jax():
    from ryolo_tpu.losses.common import bbox_ciou as jax_ciou
    from ryolo_tpu_torch.losses.common import bbox_ciou

    rng = np.random.default_rng(6)
    a = rng.uniform(0.1, 3, (512, 4)).astype(np.float32)
    b = rng.uniform(0.1, 3, (512, 4)).astype(np.float32)
    np.testing.assert_allclose(
        bbox_ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_ciou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)
