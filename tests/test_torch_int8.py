"""The port's int8 deploy path against the JAX package's
(``fuse_for_inference(quantize=True)``, ``ryolo_tpu/nn/deploy.py:150-193``,
``blocks.py:330-365`` and ``:651-683``), on the CPU.

* The quantized set: the convs the port quantizes are those that JAX's
  ``fuse_variables(quantize=True)`` gives int8 kernels, for v4, v5 and v7,
  the halves of a merged cv1/cv2 pair included (JAX decides on the merged
  width: two 128-wide halves over a 256-wide input are int8).
* The weights: ``kernel_q``, ``wscale`` and ``bias`` equal JAX's bit for
  bit for every quantized conv (the folds are bit-equal,
  tests/test_torch_model.py, and the quantization runs the same float64
  steps; no ±1 flip was found, so none is allowed).
* A quantized ``ConvBlock`` and a ``RepConv``, each with a dynamic and
  with a static scale, bf16 in and out: the activation scale, the int8
  activation ``q`` and the int32 accumulator equal JAX's bit for bit; the
  output is within 1 bf16 ulp (measured: equal).  The JAX side's ``q``
  and accumulator are recomputed with the module's own expressions and
  checked against the module's output, bit for bit.

The whole graph is held to JAX's in tests/test_torch_int8_graph.py.
"""

import re
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_ver, limit_threads, nhwc_to_nchw,
                                torch_model)


def jax_quantized(params, ver):
    """Port module name -> ``(JAX node, output-channel slice, kernel key)``
    for every int8 conv of JAX's deploy tree; a merged ``cv12`` gives its
    two halves, in ``_CV12_MERGE_PATHS``' order."""
    from ryolo_tpu.nn.deploy import _CV12_MERGE_PATHS

    swap = {(p, n): s for p, n, s in _CV12_MERGE_PATHS[ver]}
    out = {}

    def walk(node, path):
        key = next((k for k in ("kernel_q", "fused_q") if k in node), None)
        if key is None:
            for k, v in node.items():
                if isinstance(v, Mapping):
                    walk(v, path + (k,))
            return
        name = re.sub(r"m_(\d+)", r"m.\1", ".".join(path))
        if path[-1] != "cv12":
            out[name] = (node, slice(None), key)
            return
        o = node[key].shape[-1] // 2  # the halves are equal in every pair
        first, second = (("cv2", "cv1") if swap[tuple(path[:2])]
                         else ("cv1", "cv2"))
        base = name[:-len("cv12")]
        out[base + first] = (node, slice(0, o), key)
        out[base + second] = (node, slice(o, 2 * o), key)

    walk(params, ())
    return out


def _int8_convs(model):
    """Port module name -> its :class:`Int8Conv`."""
    from ryolo_tpu_torch.nn.blocks import ConvBlock, Int8Conv, RepConv

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, RepConv) and isinstance(mod.fused, Int8Conv):
            out[name] = mod.fused
        elif isinstance(mod, ConvBlock) and isinstance(mod.conv, Int8Conv):
            out[name] = mod.conv
    return out


@pytest.mark.parametrize("ver", ["yolov7", "yolov5", "yolov4"])
def test_quantized_set_and_weights_match_jax(ver):
    from ryolo_tpu.nn.deploy import fuse_variables
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.nn.deploy import quantized_names

    limit_threads()
    _, variables = jax_ver(ver, seed=0)
    tmodel = torch_model(variables, ver)
    jq = jax_quantized(fuse_variables(variables, ver=ver,
                                      quantize=True)["params"], ver)
    qmodel = fuse_for_inference(tmodel, quantize=True)
    convs = _int8_convs(qmodel)
    assert sorted(convs) == sorted(jq)
    assert sorted(quantized_names(fuse_for_inference(tmodel))) == sorted(jq)
    # merged-width pairs: halves narrower than 256 that JAX quantizes
    narrow = [n for n, c in convs.items() if c.kernel_q.shape[0] < 256]
    assert narrow and all(n.endswith((".cv1", ".cv2")) for n in narrow)
    assert {"yolov7": 40, "yolov5": 60, "yolov4": 50}[ver] < len(convs)
    for name, conv in convs.items():
        node, sl, key = jq[name]
        want_k = np.asarray(node[key])[..., sl].transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(conv.kernel_q.numpy(), want_k,
                                      err_msg=name)
        np.testing.assert_array_equal(conv.wscale.numpy(),
                                      np.asarray(node["wscale"])[sl])
        np.testing.assert_array_equal(conv.bias.numpy(),
                                      np.asarray(node["bias"])[sl])
        assert conv.kernel_q.dtype == torch.int8
        assert conv.wscale.dtype == conv.bias.dtype == torch.float32


def _jax_layer(kind, act, kernel_q, wscale, bias, x, stride, ascale):
    """JAX's quantized ConvBlock or RepConv on ``x`` (NHWC bf16): its
    output and, recomputed with its expressions (blocks.py:349-365), the
    scale, ``q`` and the int32 accumulator."""
    from ryolo_tpu.nn.blocks import ACTIVATIONS, ConvBlock, RepConv

    quant = "static" if ascale is not None else True
    cout, k = kernel_q.shape[-1], kernel_q.shape[0]
    params = {"wscale": wscale, "bias": bias}
    if ascale is not None:
        params["ascale"] = ascale
    if kind == "convblock":
        mod = ConvBlock(cout, k, stride, act, dtype=jnp.bfloat16, deploy=True,
                        quant=quant)
        params["kernel_q"] = kernel_q
    else:
        mod = RepConv(x.shape[-1], cout, s=stride, dtype=jnp.bfloat16,
                      deploy=True, quant=quant)
        params["fused_q"] = kernel_q
        act = "swish"
    out = mod.apply({"params": params}, x)

    x32 = x.astype(jnp.float32)
    s = (ascale if ascale is not None
         else jnp.maximum(jnp.max(jnp.abs(x32)), 1e-12))
    q = jnp.clip(jnp.round(x32 * (127.0 / s)), -127.0, 127.0).astype(jnp.int8)
    pad = (k - 1) // 2
    acc = jax.lax.conv_general_dilated(
        q, kernel_q, (stride, stride), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (wscale * (s / 127.0)) + bias
    again = ACTIVATIONS[act](y).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(again, np.float32),
                                  np.asarray(out, np.float32))
    return out, s, q, acc


@pytest.mark.parametrize("kind,act,k,stride,static", [
    ("convblock", "mish", 3, 2, False), ("convblock", "leaky", 1, 1, True),
    ("repconv", None, 3, 1, True), ("repconv", None, 3, 2, False)])
def test_layer_matches_jax_bit_for_bit(kind, act, k, stride, static):
    from ryolo_tpu.nn.deploy import _quantize_node
    from ryolo_tpu_torch.nn.deploy import quantize_kernel
    from ryolo_tpu_torch.ops.int8_conv import (activation_scale,
                                               int8_conv2d, quantize_act)

    limit_threads()
    rng = np.random.default_rng(4)
    cin, cout = 256, 264
    kernel = rng.normal(0, (k * k * cin) ** -0.5,
                        (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    jq = _quantize_node({"kernel": kernel, "bias": bias})
    kq, wscale = quantize_kernel(torch.from_numpy(
        kernel.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(kq, jq["kernel_q"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(wscale, jq["wscale"])

    x = jnp.asarray(rng.normal(0, 1.5, (2, 10, 10, cin)), jnp.bfloat16)
    ascale = (np.float32(0.8 * np.abs(np.asarray(x, np.float32)).max())
              if static else None)
    jout, js, jqact, jacc = _jax_layer(kind, act, jq["kernel_q"],
                                       jq["wscale"], jq["bias"], x, stride,
                                       ascale)

    xt = nhwc_to_nchw(np.asarray(x.astype(jnp.float32))).bfloat16()
    s = (activation_scale(xt.float()) if not static
         else torch.tensor(ascale))
    q = quantize_act(xt, s)
    acc = int8_conv2d(q, torch.from_numpy(kq), stride, (k - 1) // 2)
    assert s.item() == float(js)
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jqact).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(jacc).transpose(0, 3, 1, 2))
    assert acc.dtype == torch.int32 and np.abs(acc.numpy()).max() > 2 ** 14
    if static:
        assert (q.abs() == 127).any()  # the calibrated scale clips

    # the module itself, as fuse_for_inference builds it
    from ryolo_tpu_torch.nn.blocks import ConvBlock, Int8Conv, RepConv

    if kind == "convblock":
        mod = ConvBlock(cin, cout, k, stride, act, deploy=True)
    else:
        mod = RepConv(cin, cout, stride, deploy=True)
    conv = Int8Conv(torch.from_numpy(kq), torch.from_numpy(wscale),
                    torch.from_numpy(bias), stride, (k - 1) // 2)
    if static:
        conv.set_ascale(torch.tensor(ascale))
    setattr(mod, "conv" if kind == "convblock" else "fused", conv)
    with torch.no_grad():
        out = mod(xt)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32).transpose(0, 3, 1, 2)
    got = out.float().numpy()
    ulp = np.abs(want) * 2.0 ** -8 + 1e-30
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("k,stride,hw,channels_last", [
    (1, 1, 7, False), (1, 1, 7, True), (3, 1, 7, False), (3, 2, 8, True),
    (3, 2, 7, False), (6, 2, 12, False)])
def test_im2col_product_equals_plain_version(k, stride, hw, channels_last):
    """The card route's arithmetic on the CPU: the int8 im2col times the
    weight matrix (in int64 here; ``torch._int_mm`` on the card) equals the
    plain version, at odd and even sizes, both strides and both memory
    layouts of the input."""
    from ryolo_tpu_torch.ops.int8_conv import (im2col_int8,
                                               int8_conv2d_plain,
                                               weight_matrix)

    rng = np.random.default_rng(k * 10 + stride)
    q = torch.from_numpy(rng.integers(-127, 128, (2, 16, hw, hw + 1),
                                      dtype=np.int8))
    if channels_last:
        q = q.contiguous(memory_format=torch.channels_last)
    kq = torch.from_numpy(rng.integers(-127, 128, (24, 16, k, k),
                                       dtype=np.int8))
    pad = (k - 1) // 2
    want = int8_conv2d_plain(q, kq, stride, pad)
    cols = im2col_int8(q, k, k, stride, pad)
    got = (cols.long() @ weight_matrix(kq).long().t()).view(
        want.shape[0], want.shape[2], want.shape[3], -1).permute(0, 3, 1, 2)
    assert cols.dtype == torch.int8
    assert torch.equal(got.to(torch.int32), want)


def test_int8_conv2d_takes_int8_only():
    from ryolo_tpu_torch.ops.int8_conv import int8_conv2d

    q = torch.zeros(1, 8, 4, 4, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        int8_conv2d(q.float(), torch.zeros(8, 8, 1, 1, dtype=torch.int8),
                    1, 0)
    assert int8_conv2d(q, torch.ones(8, 8, 1, 1, dtype=torch.int8), 1,
                       0).dtype == torch.int32
