"""The int8 deploy convolution: int8 x int8 -> int32, then a float32
epilogue (counterparts of the quantized branches of ``ConvBlock`` and
``RepConv``, ``ryolo_tpu/nn/blocks.py:330-365`` and ``:651-683``).

The JAX package leaves the integer product to XLA
(``jax.lax.conv_general_dilated(..., preferred_element_type=jnp.int32)``);
no Pallas kernel computes it.  Here, on a card, it is an int8 im2col built
from shifted slices of the padded channels-last input and one
``torch._int_mm`` (cuBLASLt's int8 tensor-core product) into an int32
accumulator: exact, as the JAX accumulator is.  Its plain version, which
the CPU takes, is ``F.conv2d`` in float64 over the int8 values, exact too
(every partial sum is an integer below 2^53).  No path computes the
product in float32, which is inexact once a sum passes 2^24 (a 3x3 conv
over 256 channels reaches 9·256·127² ≈ 3.7e7), and no path falls back to a
float conv over dequantized values.

Scales: per output channel for the weights (``wscale``, from
:func:`ryolo_tpu_torch.nn.deploy.quantize_kernel`), per tensor for the
activation: ``max|x|`` over the whole batch (dynamic) or a calibrated
constant ``ascale`` (static).  Every float32 division is a division of two
tensors: ``127.0 / s`` written with a Python float would be taken as a
reciprocal times 127 (two roundings), and a card divides by a host scalar
the same way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ryolo_tpu_torch.utils import trace

# Launches of the card's product (``torch._int_mm``); only a launch adds
# to it.  The ``launch`` counters of :mod:`ryolo_tpu_torch.utils.trace`.
LAUNCHES = trace.group("launch", {"int8_conv2d": 0})


def activation_scale(x32: torch.Tensor) -> torch.Tensor:
    """The dynamic per-tensor scale: ``max(max|x|, 1e-12)`` over the whole
    batch, a 0-dim float32 tensor on ``x32``'s device (no host sync)."""
    return torch.clamp_min(x32.abs().amax(), 1e-12)


def quantize_act(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(x·(127/s)), -127, 127)`` as int8, with ``127/s`` one
    float32 division; rounding half to even, as ``jnp.round``."""
    x32 = x.float()
    inv = torch.full_like(s, 127.0) / s
    return torch.clamp(torch.round(x32 * inv), -127.0, 127.0).to(torch.int8)


def _out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def im2col_int8(q: torch.Tensor, kh: int, kw: int, stride: int,
                pad: int) -> torch.Tensor:
    """``(B, C, H, W)`` int8 -> ``(B·Ho·Wo, kh·kw·C)`` int8 patches, the
    columns ordered (tap row, tap column, channel): shifted strided slices
    of the zero-padded channels-last input, stacked (``F.unfold`` has no
    int8 kernel).  A 1x1 stride-1 conv over a channels-last input is a
    view."""
    B, C, H, W = q.shape
    ho, wo = _out_size(H, kh, stride, pad), _out_size(W, kw, stride, pad)
    x = q.permute(0, 2, 3, 1)  # (B, H, W, C)
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    if kh == kw == 1:
        x = x[:, ::stride, ::stride]
        return x.reshape(B * ho * wo, C)
    taps = [x[:, i:i + stride * (ho - 1) + 1:stride,
              j:j + stride * (wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, 3).reshape(B * ho * wo, kh * kw * C)


def weight_matrix(kernel_q: torch.Tensor) -> torch.Tensor:
    """``(O, I, kh, kw)`` int8 -> ``(O, kh·kw·I)``, columns in
    :func:`im2col_int8`'s order."""
    return kernel_q.permute(0, 2, 3, 1).reshape(kernel_q.shape[0], -1)


def int8_conv2d_plain(q: torch.Tensor, kernel_q: torch.Tensor, stride: int,
                      pad: int) -> torch.Tensor:
    """The plain version: ``F.conv2d`` in float64 over the int8 values,
    exact, as int32 ``(B, O, Ho, Wo)``."""
    return F.conv2d(q.double(), kernel_q.double(), stride=stride,
                    padding=pad).to(torch.int32)


def int8_conv2d(q: torch.Tensor, kernel_q: torch.Tensor, stride: int,
                pad: int) -> torch.Tensor:
    """``q`` ``(B, C, H, W)`` int8 conv ``kernel_q`` ``(O, C, kh, kw)``
    int8, zero padding ``pad`` -> the int32 accumulator ``(B, O, Ho, Wo)``
    (channels-last in memory on a card).

    CPU tensors take :func:`int8_conv2d_plain`.  CUDA tensors take the
    im2col and one ``torch._int_mm``, whose shape rules (M > 16, K and N
    multiples of 8) are checked here: a shape outside them raises, it is
    not sent down another path."""
    if q.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {q.dtype} and "
                        f"{kernel_q.dtype}")
    if q.device != kernel_q.device:
        raise ValueError(f"q on {q.device}, kernel on {kernel_q.device}")
    if q.device.type == "cpu":
        return int8_conv2d_plain(q, kernel_q, stride, pad)
    if q.device.type != "cuda":
        raise ValueError(f"int8_conv2d: no int8 product on {q.device}")
    B, _, H, W = q.shape
    O, _, kh, kw = kernel_q.shape
    ho, wo = _out_size(H, kh, stride, pad), _out_size(W, kw, stride, pad)
    a = im2col_int8(q, kh, kw, stride, pad)
    if not a.is_contiguous():
        a = a.contiguous()
    M, K = a.shape
    if M <= 16 or K % 8 or O % 8:
        raise ValueError(f"int8_conv2d: torch._int_mm needs M > 16 and K, N "
                         f"multiples of 8; got M={M}, K={K}, N={O}")
    acc = torch._int_mm(a, weight_matrix(kernel_q).t())  # (M, O) int32
    LAUNCHES["int8_conv2d"] += 1
    return acc.view(B, ho, wo, O).permute(0, 3, 1, 2)


def int8_conv_epilogue(acc: torch.Tensor, s: torch.Tensor,
                       wscale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """``acc·(wscale·(s/127)) + bias`` in float32, in that order
    (``blocks.py:364``, ``:683``)."""
    scale = wscale * (s / torch.full_like(s, 127.0))
    return acc.float() * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def int8_conv(x: torch.Tensor, kernel_q: torch.Tensor, wscale: torch.Tensor,
              bias: torch.Tensor, stride: int, pad: int,
              ascale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole quantized conv before its activation: the activation scale
    (``ascale``, or the batch's :func:`activation_scale`), the int8
    activation, the int32 product and the float32 epilogue."""
    x32 = x.float()
    s = activation_scale(x32) if ascale is None else ascale
    acc = int8_conv2d(quantize_act(x32, s), kernel_q, stride, pad)
    return int8_conv_epilogue(acc, s, wscale, bias)
