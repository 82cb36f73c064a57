"""Deploy-time fusion: BN folding, RepConv merge, Implicit absorb.

Counterpart of ``ryolo_tpu/nn/deploy.py`` (``_fold_conv_bn`` :35,
``_bn_only`` :45, ``_fuse_repconv`` :52, ``_absorb_implicit`` :69,
``fuse_for_inference`` :407).  The folds run in float64 on the same
numbers as the JAX package and are stored as float32, so the fused
weights equal the JAX fused weights.  The result is a ``Yolo(deploy=
True)`` whose graph is ``conv(+bias) -> act`` only.  Not ported: the
cv1/cv2 merge and the S2D stem (TPU layout tricks) and int8 (ROADMAP
§A14).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ryolo_tpu_torch.nn.blocks import BN_EPS, ConvBlock, RepConv
from ryolo_tpu_torch.nn.yolo import Yolo


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


def fuse_for_inference(model: Yolo, dtype: Optional[torch.dtype] = None,
                       device=None) -> Yolo:
    """The fused, eval-mode inference model for ``model`` (train
    structure), in ``dtype`` (default float32) on ``device`` (default the
    model's).  Decode stays float32 whatever ``dtype`` is."""
    if device is None:
        device = next(model.parameters()).device
    fused = Yolo(model.n_classes, model.model_config, mode=model.mode,
                 ver=model.ver, deploy=True)
    fused.load_state_dict(fuse_state_dict(model), strict=True)
    return fused.to(device=device, dtype=dtype or torch.float32).eval()
