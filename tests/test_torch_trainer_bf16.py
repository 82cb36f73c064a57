"""bf16 training of the port against the JAX package's (``Yolo(dtype=
jnp.bfloat16)``, ``train.py:96-103``): convs, BatchNorm outputs and
activations in bf16; parameters, gradients, the optimizer, the BatchNorm
running statistics and the loss in float32.

Blocks in training mode (``test_block_step_matches_jax``): the same jittered
weights and 16 px input through the JAX block at ``dtype=bfloat16`` and the
port's block under ``torch.autocast(bfloat16)``, a fixed random
projection of the output as the loss.  The two sides round to bf16 at
other places (XLA after each elementwise op of an activation, PyTorch once
per activation; the conv sums in other orders), so the bounds are measured
on the CPU: the output within 1 bf16 ulp at its magnitude in the mean
(measured 0.45 at worst, SPPF); the gradients, as the L2 error over the L2
norm of JAX's bf16 gradient, within 0.2 in each tensor (measured 0.134,
C5) and within 1.5 times the distance of JAX's bf16 gradients from its own
float32 ones (measured 1.24 times, C3; that distance is 0.0055-0.157); the
running statistics, float32, within 2e-3 of the tensor's largest entry
(measured 1.25e-3).

The whole model (``test_model_step_matches_jax``, and the YOLOv5-KFIoU case
in tests/test_torch_trainer_bf16_v5.py): one SGD step of YOLOv7-CSL at
128 px, batch 2, through JAX's bf16 ``Trainer.train_step`` and the port's
``Trainer(dtype=torch.bfloat16)``, with ``check_train_step``'s checks that
every parameter, gradient and statistic stays float32.  At these random
weights a rounding of the forward is amplified about 5e4 times into the
update (float32's 6e-8 become the float32 step's 5e-3 gap,
tests/test_torch_trainer.py), so bf16's 4e-3 decides most of the update:
JAX's own bf16 step lies 1.27 (L2 over all parameters) from its float32
one, and the port's bf16 step 1.19 from JAX's bf16 one.  An L2 bound over
all parameters above 1 would pass a step that leaves the parameters
unchanged (1.0) and the float32 step (1.27), so the update is held where
rounding does not decide it (``check_bf16_update``):

* each parameter whose update the bf16 rounding moves by less than 0.3
  (the port's float32 step against JAX's bf16 one; the float32 step is
  JAX's within tests/test_torch_trainer.py's bounds) lies within 1.5
  times that distance of JAX's bf16 update: 20 parameters of the neck and
  head, measured 1.31 times at worst, 0.225 in the worst tensor (an
  unchanged parameter reads 1.0, over 3.3 times);
* the port's bf16 step lies from its own float32 step 0.5-2 times JAX's
  own bf16-to-float32 distance (measured 0.895; the float32 step reads 0).

The loss items within rtol 0.03 (measured 0.022) and the BN statistics
within 0.08 of the tensor's largest entry (measured 0.057) hold the
forward; the block test holds the arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_blocks import _load_from_flax
from tests.test_torch_trainer import check_train_step
from tests.torch_parity import (jax_ver, limit_threads, nhwc_to_nchw,
                                random_variables)


def _twins(name):
    """``(jax block, port block, input channels)`` at bf16 on the JAX
    side."""
    from ryolo_tpu.nn import blocks as jb
    from ryolo_tpu_torch.nn import blocks as tb

    bf = dict(dtype=jnp.bfloat16)
    return {
        "csp_mish": (jb.CSP(16, 16, 2, **bf), tb.CSP(16, 16, 2), 16),
        "c3_swish": (jb.C3(16, 16, 2, **bf), tb.C3(16, 16, 2), 16),
        "c5_leaky": (jb.C5(16, 8, **bf), tb.C5(16, 8), 16),
        "sppf": (jb.SPPF(16, 16, **bf), tb.SPPF(16, 16), 16),
        "repconv": (jb.RepConv(8, 16, **bf), tb.RepConv(8, 16), 8),
    }[name]


BLOCK_BOUNDS = {"out_ulps": 1.0, "grad": 0.2, "stats": 2e-3,
                "envelope": 1.5}


def _flax_leaf(tree, path, transform):
    for p in path:
        tree = tree[p]
    w = np.asarray(tree, np.float64)
    return w.transpose(3, 2, 0, 1) if transform == "conv" else w


@pytest.mark.parametrize("name", ["csp_mish", "c3_swish", "c5_leaky",
                                  "sppf", "repconv"])
def test_block_step_matches_jax(name):
    from ryolo_tpu_torch.utils.checkpoint import torch_name_to_flax

    limit_threads()
    jblock, tblock, c1 = _twins(name)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 16, c1)).astype(np.float32)
    variables = random_variables(jblock, x, seed=1)
    tblock = _load_from_flax(tblock, variables).train()
    out_shape = jax.eval_shape(lambda v, x: jblock.apply(v, x, train=False),
                               variables, jnp.asarray(x)).shape
    r = rng.normal(0, 1, out_shape).astype(np.float32)

    def jstep(block):
        def loss(params):
            out, mut = block.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
            return (out.astype(jnp.float32) * r).sum(), (out, mut)

        (_, aux), grads = jax.value_and_grad(loss, has_aux=True)(
            variables["params"])
        return aux, grads

    (jout, mut), jgrads = jstep(jblock)
    _, jgrads32 = jstep(jblock.clone(dtype=jnp.float32))
    assert jout.dtype == jnp.bfloat16

    with torch.autocast("cpu", dtype=torch.bfloat16):
        tout = tblock(nhwc_to_nchw(x))
    assert tout.dtype == torch.bfloat16
    (tout.float() * torch.from_numpy(r.transpose(0, 3, 1, 2))).sum().backward()

    jo = np.asarray(jout.astype(jnp.float32)).transpose(0, 3, 1, 2)
    ulp = np.abs(jo).max() * 2.0 ** -8
    out_err = np.abs(tout.detach().float().numpy() - jo).mean() / ulp

    grad_errs, envelope, stat_errs = [], [], []
    for pname, t in tblock.state_dict().items():
        coll, path, transform = torch_name_to_flax(pname)
        if coll == "batch_stats":
            w = _flax_leaf(mut["batch_stats"], path, transform)
            assert t.dtype == torch.float32
            stat_errs.append(np.abs(t.numpy() - w).max() / np.abs(w).max())
        elif coll == "params":
            w = _flax_leaf(jgrads, path, transform)
            w32 = _flax_leaf(jgrads32, path, transform)
            param = tblock.get_parameter(pname)
            assert param.dtype == param.grad.dtype == torch.float32
            g = param.grad.double().numpy()
            grad_errs.append(np.linalg.norm(g - w) / np.linalg.norm(w))
            envelope.append(np.linalg.norm(w32 - w) / np.linalg.norm(w))
    print(f"{name}: output {out_err:.3f} ulps in the mean; gradients "
          f"{max(grad_errs):.4f} from JAX's bf16 ones, which lie "
          f"{max(envelope):.4f} from JAX's float32 ones; statistics "
          f"{max(stat_errs):.2e}")
    assert out_err <= BLOCK_BOUNDS["out_ulps"], out_err
    assert max(grad_errs) <= BLOCK_BOUNDS["grad"], max(grad_errs)
    assert max(grad_errs) <= BLOCK_BOUNDS["envelope"] * max(envelope)
    assert max(stat_errs) <= BLOCK_BOUNDS["stats"], max(stat_errs)
    assert len(grad_errs) >= 4 and len(stat_errs) >= 4


def test_model_step_matches_jax():
    limit_threads()
    jmodel, variables = jax_ver("yolov7", seed=3)
    check_train_step(jmodel, variables, "yolov7", bf16=True,
                     bounds={"items": 0.03, "stats": 0.08, "held_below": 0.3,
                             "held": 15, "envelope": 1.5, "own": (0.5, 2.0)})
