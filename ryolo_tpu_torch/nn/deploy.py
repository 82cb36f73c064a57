"""Deploy-time fusion: BN folding, RepConv merge, Implicit absorb, and
the int8 deploy path.

Counterpart of ``ryolo_tpu/nn/deploy.py`` (``_fold_conv_bn`` :35,
``_bn_only`` :45, ``_fuse_repconv`` :52, ``_absorb_implicit`` :69,
``_quantizable`` :153, ``_quantize_node`` :159,
``calibrate_static_scales`` :347, ``fuse_for_inference`` :407).  The folds
run in float64 on the same numbers as the JAX package and are stored as
float32, so the fused weights equal the JAX fused weights.  The result is
a ``Yolo(deploy=True)`` whose graph is ``conv(+bias) -> act`` only; with
``quantize=True`` its wide BN-backed convs and RepConvs are
:class:`ryolo_tpu_torch.nn.blocks.Int8Conv`.  Not ported: the cv1/cv2
merge and the S2D stem (TPU layout tricks); the int8 choice still follows
the merged width (:func:`quantized_names`).
"""

from __future__ import annotations

import copy
from typing import Iterable, List, Mapping, Optional

import numpy as np
import torch

from ryolo_tpu_torch.nn.blocks import (BN_EPS, C3, CSP, ELAN1, ELAN2,
                                       SPPCSPC, ConvBlock, Int8Conv, RepConv)
from ryolo_tpu_torch.nn.yolo import Yolo
from ryolo_tpu_torch.ops.int8_conv import activation_scale


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _bn_only(bn: Mapping):
    """BN (inference form) as per-channel ``(scale, bias)`` in float64."""
    scale = _np64(bn["weight"]) / np.sqrt(_np64(bn["running_var"]) + BN_EPS)
    bias = _np64(bn["bias"]) - _np64(bn["running_mean"]) * scale
    return scale, bias


def _fold_conv_bn(weight, bn: Mapping, conv_bias=None):
    """Fold BN into the preceding OIHW conv -> float32 ``(weight, bias)``."""
    scale, bias = _bn_only(bn)
    kernel = _np64(weight) * scale[:, None, None, None]
    if conv_bias is not None:
        bias = bias + _np64(conv_bias) * scale
    return np.float32(kernel), np.float32(bias)


def _fuse_repconv(sd: Mapping, prefix: str):
    """RepVGG merge: 3x3-BN + centre-padded 1x1-BN (+ identity BN)."""
    def sub(name):
        return {k[len(name):]: v for k, v in sd.items() if k.startswith(name)}

    dk, db = _fold_conv_bn(sd[prefix + "rbr_dense.0.weight"],
                           sub(prefix + "rbr_dense.1."))
    pk, pb = _fold_conv_bn(sd[prefix + "rbr_1x1.0.weight"],
                           sub(prefix + "rbr_1x1.1."))
    kernel = _np64(dk)
    ch, cw = kernel.shape[2] // 2, kernel.shape[3] // 2
    kernel[:, :, ch, cw] += _np64(pk)[:, :, 0, 0]
    bias = _np64(db) + _np64(pb)
    ident = sub(prefix + "rbr_identity.")
    if ident:
        scale, ibias = _bn_only(ident)
        kernel[:, :, ch, cw] += np.eye(kernel.shape[1]) * scale[:, None]
        bias = bias + ibias
    return np.float32(kernel), np.float32(bias)


def _absorb_implicit(weight, bias, ia, im):
    """``(W(x+a)+b)*m = (W*m)x + (b + Wa)*m`` around a 1x1 head conv."""
    kernel = _np64(weight)  # (O, I, 1, 1)
    assert kernel.shape[2:] == (1, 1), "Implicit priors wrap 1x1 head convs"
    a = _np64(ia).reshape(-1)
    m = _np64(im).reshape(-1)
    new_bias = (_np64(bias) + a @ kernel[:, :, 0, 0].T) * m
    return np.float32(kernel * m[:, None, None, None]), np.float32(new_bias)


# YOLOv7 head triples ImplicitA -> 1x1 conv -> ImplicitM
# (v4/v5 have a ``neck.conv7`` too, a BN-backed conv: looked up for
# yolov7 only)
_V7_HEADS = {f"neck.conv{i + 4}": (f"neck.ia{i}", f"neck.im{i}")
             for i in (1, 2, 3)}


def fuse_state_dict(model: Yolo) -> dict:
    """The deploy-structure state_dict of ``model`` (train structure)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    heads = _V7_HEADS if model.ver == "yolov7" else {}
    out = {}
    for name, mod in model.named_modules():
        p = name + "."
        if isinstance(mod, RepConv):
            w, b = _fuse_repconv(sd, p)
            out[p + "fused.weight"], out[p + "fused.bias"] = w, b
        elif isinstance(mod, ConvBlock):
            w = sd[p + "conv.0.weight"]
            if len(mod.conv) == 2:  # BN-backed
                bn = {k[len(p) + 7:]: v for k, v in sd.items()
                      if k.startswith(p + "conv.1.")}
                w, b = _fold_conv_bn(w, bn, sd.get(p + "conv.0.bias"))
            else:  # biased head conv
                b = sd[p + "conv.0.bias"]
                if name in heads:
                    ia, im = heads[name]
                    w, b = _absorb_implicit(w, b, sd[ia + ".implicit"],
                                            sd[im + ".implicit"])
            out[p + "conv.0.weight"], out[p + "conv.0.bias"] = w, b
    return {k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}


# int8 only for convs at least this wide on input and output
# (ryolo_tpu/nn/blocks.py:325, deploy.py:150)
QUANT_MIN_CH = 256
# blocks whose cv1 and cv2 are two 1x1 convs over the same input: the JAX
# deploy graph merges each pair into one conv ``cv12`` and decides int8 on
# the merged width (deploy.py:121-147), for every instance of these blocks
_PAIRED = (CSP, C3, ELAN1, ELAN2, SPPCSPC)


def quantized_names(model: Yolo) -> List[str]:
    """The modules of the deploy-structure ``model`` that the int8 path
    quantizes: each RepConv and each BN-backed ``ConvBlock`` (head convs
    never) with at least :data:`QUANT_MIN_CH` input and output channels,
    the output of a cv1/cv2 pair of :data:`_PAIRED` counted as the pair's
    sum, as the JAX package merges them.  Both halves of a pair read one
    input, so they share one activation scale in either mode."""
    def wide(conv, width=None):
        return (conv.in_channels >= QUANT_MIN_CH
                and (width or conv.out_channels) >= QUANT_MIN_CH)

    mods = dict(model.named_modules())
    names = []
    for name, mod in mods.items():
        if isinstance(mod, RepConv):
            if wide(mod.fused):
                names.append(name)
        elif isinstance(mod, ConvBlock) and mod.bn:
            parent, _, child = name.rpartition(".")
            owner = mods[parent]
            width = None
            if isinstance(owner, _PAIRED) and child in ("cv1", "cv2"):
                width = sum(c.conv[0].out_channels
                            for c in (owner.cv1, owner.cv2))
            if wide(mod.conv[0], width):
                names.append(name)
    return names


def quantize_kernel(kernel):
    """float32 OIHW kernel -> ``(int8 kernel, float32 wscale)``: per
    output channel symmetric, ``wscale = max|k|/127`` and
    ``round(k/wscale)`` clipped to ±127, in float64 (``_quantize_node``
    :159)."""
    k = _np64(kernel)
    wscale = np.maximum(np.abs(k).max(axis=(1, 2, 3)), 1e-12) / 127.0
    kq = np.clip(np.round(k / wscale[:, None, None, None]), -127, 127)
    return kq.astype(np.int8), np.float32(wscale)


def fuse_for_inference(model: Yolo, dtype: Optional[torch.dtype] = None,
                       device=None, quantize: bool = False) -> Yolo:
    """The fused, eval-mode inference model for ``model`` (train
    structure), in ``dtype`` (default float32) on ``device`` (default the
    model's).  Decode stays float32 whatever ``dtype`` is.

    ``quantize=True``: the modules of :func:`quantized_names` run int8 x
    int8 -> int32 with dynamic per-tensor activation scales
    (:func:`calibrate_static_scales` makes them static); their scales and
    bias stay float32 whatever ``dtype`` is, and their outputs are cast to
    ``dtype``."""
    if device is None:
        device = next(model.parameters()).device
    fused = Yolo(model.n_classes, model.model_config, mode=model.mode,
                 ver=model.ver, deploy=True)
    sd = fuse_state_dict(model)
    fused.load_state_dict(sd, strict=True)
    fused = fused.to(device=device, dtype=dtype or torch.float32).eval()
    if quantize:
        # after the cast, which would cast the float32 scales too
        for name in quantized_names(fused):
            mod = fused.get_submodule(name)
            attr = "fused" if isinstance(mod, RepConv) else "conv"
            key = name + (".fused" if attr == "fused" else ".conv.0")
            conv = fused.get_submodule(key)
            kq, wscale = quantize_kernel(sd[key + ".weight"])
            setattr(mod, attr, Int8Conv(
                torch.from_numpy(kq), torch.from_numpy(wscale),
                sd[key + ".bias"].float(), conv.stride[0],
                conv.padding[0]).to(device))
    return fused


def calibrate_static_scales(model: Yolo,
                            batches: Iterable[torch.Tensor]) -> Yolo:
    """A static-scale copy of the int8 ``model`` (from
    ``fuse_for_inference(quantize=True)``): runs ``model`` over
    ``batches`` (NCHW float images on its device, cast to its compute
    dtype here), records each quantized conv's activation scale
    ``max(max|x|, 1e-12)`` of each batch, and gives every
    :class:`Int8Conv` of the copy the largest as its ``ascale``
    (``calibrate_static_scales`` :347).  The scales equal the dynamic
    ones on the calibration batches; the outputs need not be bit-equal
    (tests/test_deploy.py:118-127)."""
    amax, hooks = {}, []
    dtype = next(model.parameters()).dtype
    for name, mod in model.named_modules():
        if isinstance(mod, Int8Conv):
            def record(_mod, args, name=name):
                s = activation_scale(args[0].float())
                amax[name] = s if name not in amax else torch.maximum(
                    amax[name], s)
            hooks.append(mod.register_forward_pre_hook(record))
    try:
        with torch.no_grad():
            for images in batches:
                model(images.to(dtype))
    finally:
        for h in hooks:
            h.remove()
    if not amax:
        raise ValueError("calibration needs at least one batch and an int8 "
                         "model")
    static = copy.deepcopy(model)
    for name, mod in static.named_modules():
        if isinstance(mod, Int8Conv):
            mod.set_ascale(amax[name])
    return static
