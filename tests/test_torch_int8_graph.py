"""The port's whole int8 deploy graph against the JAX package's, on the
CPU: v7-CSL and v5-KFIoU at 64 px, batch 2, in float32 compute as
tests/test_deploy.py:83-135 runs JAX's (each layer is held bit for bit in
tests/test_torch_int8.py).

The two graphs' float32 layers round apart (the JAX graph's S2D stem, sums
in other orders: 1e-4 px in the float32 graphs), and a one-ulp difference
that moves an activation across a rounding boundary of its int8 value
avalanches through ~20 quantized convs (tests/test_deploy.py:118-127).  So
the graphs are held to JAX's int8-vs-float32 envelope: decoded confidences
within 0.05, box coordinates within 1.5 px, of JAX's int8 graph and of the
port's own float32 graph, in dynamic mode and in static mode (the port's
static graph against JAX's dynamic one: on the calibration batch the
scales are the dynamic ones).

A box coordinate larger than 300 px (random weights decode boxes far
larger than the 64 px image) is held to 0.5% of its size instead of
1.5 px, because at these weights JAX's own int8 graph does not keep the
flat 1.5 px either.  Over 3 weight seeds x 3 input seeds per model
(``envelope_sweep``: ``python -m tests.test_torch_int8_graph``), JAX's
int8 graph lies up to 1.66 px from its float32 graph (above 1.5 px in 3
of 18 runs, each at a coordinate of 383-415 px), the port's up to 1.81 px
(2 runs, at 355 and 387 px), and the port's int8 graph up to 1.57 px from
JAX's (2 runs, at 431 and 482 px); against this bound the largest gaps are
0.93 (JAX's own), 0.93 (the port's own) and 0.81 (port against JAX) of it.
At this test's seeds: against JAX's int8 graph, confidences 0.0009, boxes
0.61 of the bound (v7-CSL) and 0.34 (v5-KFIoU); against the port's float32
graph one 355 px box height on v7-CSL lies 1.65 px off (0.93 of the bound;
JAX's own graph 1.12 px there).  The calibrated scales are within rtol 0.05
of JAX's (measured 0.0078 on v5-KFIoU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_int8 import _int8_convs, jax_quantized
from tests.torch_parity import (jax_ver, limit_threads, nhwc_to_nchw,
                                torch_model, ver_mode)

ENVELOPE = {"conf": 0.05, "box": 1.5}


def _dec_gap(a, b):
    """The largest confidence gap and the largest box gap, each box
    coordinate's as a multiple of its bound (1.5 px, or 0.5% above
    300 px)."""
    a, b = np.asarray(a), np.asarray(b)
    box = np.abs(a[..., :4] - b[..., :4]) / np.maximum(
        ENVELOPE["box"], 0.005 * np.abs(b[..., :4]))
    return np.abs(a[..., 5:] - b[..., 5:]).max(), box.max()


@pytest.mark.parametrize("model", ["yolov7", "yolov5-kfiou"])
def test_graph_within_envelope_of_jax(model):
    from ryolo_tpu.nn import fuse_for_inference as jax_fuse
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.nn.deploy import calibrate_static_scales

    limit_threads()
    ver, mode = ver_mode(model)
    jmodel, variables = jax_ver(ver, seed=0, mode=mode)
    tmodel = torch_model(variables, ver, mode)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    xt = nhwc_to_nchw(x)

    qm, qv = jax_fuse(jmodel, variables, quantize=True)
    # one dynamic forward: the decoded rows and each conv's scale, as
    # calibrate_static_scales observes them
    (_, jdec), inter = jax.jit(lambda v, x: qm.apply(
        v, x, train=False, decode=True, mutable=["intermediates"]))(
        qv, jnp.asarray(x))
    jdec = np.asarray(jdec)

    fused = fuse_for_inference(tmodel)
    dyn = fuse_for_inference(tmodel, quantize=True)
    static = calibrate_static_scales(dyn, [xt])
    with torch.no_grad():
        f_dec = fused(xt, decode=True)[1].numpy()
        got = {"dynamic": dyn(xt, decode=True)[1].numpy(),
               "static": static(xt, decode=True)[1].numpy()}
    for key in got:
        for ref, name in ((jdec, "JAX int8"), (f_dec, "port f32")):
            conf, box = _dec_gap(got[key], ref)
            print(f"{model} {key}: against {name}: confidences {conf:.4f}, "
                  f"boxes {box:.4f} of their bound")
            assert conf < ENVELOPE["conf"] and box <= 1.0
    # the port's int8 graph is not its float32 graph
    assert _dec_gap(got["dynamic"], f_dec)[0] > 1e-4

    # calibrated scales: JAX sows each conv's as intermediates/amax
    jscale = {}
    for name, (node, _, _) in jax_quantized(
            _as_params(inter["intermediates"], qv["params"]), ver).items():
        jscale[name] = float(node["ascale"])
    tscale = {n: c.ascale.item() for n, c in _int8_convs(static).items()}
    assert sorted(tscale) == sorted(jscale) and len(tscale) > 5
    rel = max(abs(tscale[n] / jscale[n] - 1) for n in tscale)
    print(f"{model}: calibrated scales within rtol {rel:.4f} of JAX's")
    assert rel <= 0.05
    assert all(c.ascale is None for c in _int8_convs(dyn).values())


def _as_params(inter, params):
    """The sown ``amax`` of each quantized conv as an ``ascale`` leaf beside
    its int8 kernel (the tree ``calibrate_static_scales`` builds)."""
    out = {}
    for name, node in params.items():
        if not isinstance(node, dict):
            continue
        sub = inter.get(name, {})
        if "amax" in sub:
            v = sub["amax"]
            v = v[0] if isinstance(v, (tuple, list)) else v
            out[name] = dict(node, ascale=np.float32(np.maximum(v, 1e-12)))
        else:
            out[name] = _as_params(sub, node)
    return out


def envelope_sweep(model, wseeds=(0, 1, 2), xseeds=(5, 6, 7)):
    """The int8-vs-float32 gaps of JAX's graph and of the port's over
    weight and input seeds (dynamic scales, 64 px, batch 2): per run, each
    graph's largest box gap in px with its coordinate, its largest gap as a
    multiple of the bound (1.5 px, or 0.5% above 300 px), and the port's
    int8 graph against JAX's."""
    from ryolo_tpu.nn import fuse_for_inference as jax_fuse
    from ryolo_tpu_torch.nn import fuse_for_inference

    ver, mode = ver_mode(model)
    for wseed in wseeds:
        jmodel, variables = jax_ver(ver, seed=wseed, mode=mode)
        tmodel = torch_model(variables, ver, mode)
        graphs = [jax_fuse(jmodel, variables),
                  jax_fuse(jmodel, variables, quantize=True)]
        jf, jq = (jax.jit(lambda v, x, m=m: m.apply(
            v, x, train=False, decode=True)[1]) for m, _ in graphs)
        fused = fuse_for_inference(tmodel)
        dyn = fuse_for_inference(tmodel, quantize=True)
        for xseed in xseeds:
            x = np.random.default_rng(xseed).uniform(
                0, 1, (2, 64, 64, 3)).astype(np.float32)
            j32 = np.asarray(jf(graphs[0][1], jnp.asarray(x)))
            j8 = np.asarray(jq(graphs[1][1], jnp.asarray(x)))
            with torch.no_grad():
                t32 = fused(nhwc_to_nchw(x), decode=True)[1].numpy()
                t8 = dyn(nhwc_to_nchw(x), decode=True)[1].numpy()
            row = []
            for name, a, b in (("JAX", j8, j32), ("port", t8, t32),
                               ("port vs JAX", t8, j8)):
                gap = np.abs(a[..., :4] - b[..., :4])
                i = np.unravel_index(gap.argmax(), gap.shape)
                row.append(f"{name} {gap[i]:.3f} px at {abs(b[i]):.0f} px, "
                           f"{_dec_gap(a, b)[1]:.3f} of the bound")
            print(f"{model} weights {wseed} input {xseed}: "
                  + "; ".join(row), flush=True)


if __name__ == "__main__":
    # python -m tests.test_torch_int8_graph: the seed sweep behind the
    # module docstring's box bound
    import sys

    limit_threads()
    for model in sys.argv[1:] or ("yolov7", "yolov5-kfiou"):
        envelope_sweep(model)
