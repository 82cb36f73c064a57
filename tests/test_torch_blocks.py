"""The port's YOLOv4/v5 blocks against their JAX twins
(``ryolo_tpu/nn/blocks.py``) on the CPU: the same jittered weights (the
JAX tree carried over by the port's ``torch_name_to_flax``) and the same
16 px numpy input, at 8-16 channels, eval mode, within 1e-5.  The
activations are held to the same bound on their own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import limit_threads, nhwc_to_nchw, random_variables

BOUND = 1e-5


def _twins(name):
    """``(jax block, port block, input channels)``."""
    from ryolo_tpu.nn import blocks as jb
    from ryolo_tpu_torch.nn import blocks as tb

    return {
        "bottleneck_residual": (jb.Bottleneck(8, True, 1.0, act="mish"),
                                tb.Bottleneck(8, 8, True, "mish"), 8),
        "bottleneck_widening": (jb.Bottleneck(16, True, 1.0, act="swish"),
                                tb.Bottleneck(8, 16, True, "swish"), 8),
        "bottleneck_no_shortcut": (jb.Bottleneck(8, False, 1.0,
                                                 act="leaky"),
                                   tb.Bottleneck(8, 8, False, "leaky"), 8),
        "csp": (jb.CSP(16, 16, 2), tb.CSP(16, 16, 2), 16),
        "csp_narrowing": (jb.CSP(16, 8, 1), tb.CSP(16, 8, 1), 16),
        "c3": (jb.C3(16, 16, 2), tb.C3(16, 16, 2), 16),
        "c3_no_shortcut": (jb.C3(16, 8, 1, shortcut=False),
                           tb.C3(16, 8, 1, shortcut=False), 16),
        "c5": (jb.C5(16, 8), tb.C5(16, 8), 16),
        "spp": (jb.SPP(16, 8), tb.SPP(16, 8), 16),
        "sppf": (jb.SPPF(16, 16), tb.SPPF(16, 16), 16),
    }[name]


def _load_from_flax(block, variables):
    """Each entry of ``block``'s state_dict from the JAX tree, named and
    transposed as ``state_dict_from_flax`` does for a whole model."""
    from ryolo_tpu_torch.utils.checkpoint import torch_name_to_flax

    sd = {}
    for name, t in block.state_dict().items():
        coll, path, transform = torch_name_to_flax(name)
        if coll is None:
            sd[name] = t
            continue
        arr = variables[coll]
        for p in path:
            arr = arr[p]
        arr = np.asarray(arr)
        if transform == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    block.load_state_dict(sd, strict=True)
    return block.eval()


@pytest.mark.parametrize("name", [
    "bottleneck_residual", "bottleneck_widening", "bottleneck_no_shortcut",
    "csp", "csp_narrowing", "c3", "c3_no_shortcut", "c5", "spp", "sppf"])
def test_block_matches_jax(name):
    limit_threads()
    jblock, tblock, c1 = _twins(name)
    x = np.random.default_rng(0).normal(0, 1, (2, 16, 16, c1)).astype(
        np.float32)
    variables = random_variables(jblock, x, seed=1)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _load_from_flax(tblock, variables)(nhwc_to_nchw(x))
    want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BOUND)
    # the block is not trivially linear or constant
    assert np.abs(want).max() > 0.1


def test_bottleneck_residual_only_at_equal_widths():
    from ryolo_tpu_torch.nn.blocks import Bottleneck

    assert Bottleneck(8, 8, True, "swish").add
    assert not Bottleneck(8, 16, True, "swish").add
    assert not Bottleneck(8, 8, False, "swish").add


@pytest.mark.parametrize("act", ["mish", "leaky", "swish", "linear"])
def test_activations_match_jax(act):
    from ryolo_tpu.nn.blocks import ACTIVATIONS as JACTS
    from ryolo_tpu_torch.nn.blocks import ACTIVATIONS

    # across softplus's switch to x at 20 and far into both tails
    x = np.concatenate([np.linspace(-40, 40, 8001), [19.999, 20.0, 20.001],
                        np.random.default_rng(2).normal(0, 3, 4000)]
                       ).astype(np.float32)
    want = np.asarray(JACTS[act](jnp.asarray(x)))
    got = ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=BOUND, atol=BOUND)
