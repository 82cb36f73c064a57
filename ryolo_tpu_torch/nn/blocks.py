"""YOLOv4/v5/v7 building blocks in PyTorch (NCHW activations, OIHW kernels).

Counterparts of ``ryolo_tpu/nn/blocks.py``: ``mish`` :43, the activations
:47, ``ConvBlock`` :288, ``Bottleneck`` :418, ``CSP`` :441, ``C5`` :471,
``C3`` :492, ``ELAN1`` :517, ``ELAN2`` :546, ``MaxConv`` :575,
``ImplicitA/M`` :596/:613, ``RepConv`` :630, ``SPP`` :708, ``SPPF`` :733,
``SPPCSPC`` :755, ``max_pool_same`` :55, ``upsample2x`` :79.  Attribute
names follow the reference ``.pth`` layout
(``ryolo_tpu_torch/utils/checkpoint.py``), registered in its order, which
is not always the order of the forward (``CSP`` and ``C3`` register their
convs before the bottleneck list ``m``).

``deploy=True`` builds the fused inference form that
:func:`ryolo_tpu_torch.nn.deploy.fuse_for_inference` fills: each
BN-backed conv is one biased conv and each RepConv one biased 3x3 conv
(``fused``), so the graph is ``conv(+bias) -> act`` only.  With
``quantize=True`` the wide ones become :class:`Int8Conv` (the int8 deploy
path, ``ConvBlock`` :330-365, ``RepConv`` :651-683).  The JAX package's TPU
layout tricks (S2D stem, the cv1/cv2 merge of ``parallel_cv12`` :387,
chain barriers) are not part of the port: ``cv1`` and ``cv2`` stay two
convs, and the 9- and 13-pools are single ``F.max_pool2d`` windows (the
JAX 5-pool cascade gives the same values).

Under ``torch.autocast(dtype=torch.bfloat16)`` (bf16 training) the convs
run in bf16 on float32 weights; :class:`BatchNorm2d` takes the bf16
activation with its float32 weights and statistics, reduces in float32 and
returns bf16, as ``ryolo_tpu/nn/fused_bn.py:64-76`` does, and the implicit
priors are cast to the activation's dtype, as the JAX blocks cast them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ryolo_tpu_torch.ops.int8_conv import int8_conv

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # flax momentum 0.9 (blocks.py:379)


def _identity(x):
    return x


def _leaky(x):
    return F.leaky_relu(x, 0.1)


# mish: x·tanh(softplus(x)); F.mish's softplus switches to x above 20,
# where JAX's logaddexp(x, 0) rounds to x in float32 as well
ACTIVATIONS = {"mish": F.mish, "leaky": _leaky, "swish": F.silu,
               "linear": _identity}


def _spatial():
    # imported at the call: ryolo_tpu_torch.parallel imports this module
    from ryolo_tpu_torch.parallel import spatial

    return spatial


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max pool, same-size output, -inf padding (inside
    ``train --sp``'s split, with its halo:
    :func:`ryolo_tpu_torch.parallel.spatial.max_pool2d`)."""
    return _spatial().max_pool2d(x, k, 1, k // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (inside ``train --sp``'s split, a
    rank's rows, checked to double into its rows of the finer level)."""
    return _spatial().upsample2x(x)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's running statistics
    (``ryolo_tpu/nn/fused_bn.py:69-71,142-146``).

    In training a batch is normalised by its biased variance, as in
    ``nn.BatchNorm2d``, and the running variance moves toward that biased
    variance, ``0.9·running + 0.1·batch``; ``nn.BatchNorm2d`` moves it toward
    the unbiased one, n/(n-1) larger (14% at n = 8).  Buffer names are
    ``nn.BatchNorm2d``'s, so the ``.pth`` layout is unchanged; the backward
    is autograd's.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        decayed = (1.0 - self.momentum) * self.running_var
        # batch_norm's own update lands in a scratch copy (autograd may keep
        # the variance tensor it was given, so that one is not written
        # again): decayed + m·var·n/(n-1)
        scratch = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, scratch, self.weight,
                         self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            # rescale the new part per channel, with no further pass over
            # the activation
            self.running_var.copy_(
                decayed + (scratch - decayed) * ((n - 1) / n))
        return y


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class Int8Conv(nn.Module):
    """The int8 deploy form of a BN-backed conv or a RepConv: int8 kernel
    ``kernel_q`` (O, I, kh, kw) with per-output-channel float32 scales
    ``wscale`` and bias ``bias``, and in static mode the calibrated float32
    activation scale ``ascale`` (dynamic mode: ``max|x|`` of each batch).
    Returns the float32 pre-activation
    (:func:`ryolo_tpu_torch.ops.int8_conv.int8_conv`).  Built by
    :func:`ryolo_tpu_torch.nn.deploy.fuse_for_inference`, after the model's
    cast to its compute dtype, which would cast these float32 buffers too.
    """

    def __init__(self, kernel_q: torch.Tensor, wscale: torch.Tensor,
                 bias: torch.Tensor, stride: int, pad: int):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("wscale", wscale)
        self.register_buffer("bias", bias)
        self.register_buffer("ascale", None)  # dynamic mode

    def set_ascale(self, ascale: torch.Tensor):
        """Static mode: the calibrated activation scale, 0-dim float32."""
        self.ascale = ascale.float().reshape(())

    def forward(self, x):
        return int8_conv(x, self.kernel_q, self.wscale, self.bias,
                         self.stride, self.pad, self.ascale)


def _act_to(act, conv, x):
    """``act(conv(x))``; an :class:`Int8Conv`'s float32 output is cast to
    ``x``'s (compute) dtype after the activation.  Other convs keep their
    output dtype: under autocast a float32 image's first conv returns
    bf16."""
    out = act(conv(x))
    return out.to(x.dtype) if isinstance(conv, Int8Conv) else out


class ConvBlock(nn.Module):
    """Conv2d (pad (k-1)/2) -> BN -> activation, as ``conv.0``/``conv.1``.

    ``bn=False, bias=True`` is a detection-head conv (``conv.0`` with
    bias).  In deploy form the BN is folded into a biased ``conv.0``; in
    the int8 deploy form ``conv`` is an :class:`Int8Conv`, whose float32
    output the activation takes before the cast to the input's (compute)
    dtype.
    """

    def __init__(self, c1: int, c2: int, k: int, s: int, act: str,
                 bn: bool = True, bias: bool = False, deploy: bool = False):
        super().__init__()
        layers = [nn.Conv2d(c1, c2, k, s, (k - 1) // 2,
                            bias=bias or (bn and deploy))]
        if bias and not deploy:
            nn.init.zeros_(layers[0].bias)  # a head conv: flax's zero init
        if bn and not deploy:
            layers.append(_bn(c2))
        self.conv = nn.Sequential(*layers)
        self.act = ACTIVATIONS[act]
        self.bn = bn

    def forward(self, x):
        return _act_to(self.act, self.conv, x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 at width c2 (the JAX blocks' ``e=1.0``, the only width
    ``CSP`` and ``C3`` build), with the residual iff ``shortcut`` and
    c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool, act: str,
                 deploy: bool = False):
        super().__init__()
        self.cv1 = ConvBlock(c1, c2, 1, 1, act, deploy=deploy)
        self.cv2 = ConvBlock(c2, c2, 3, 1, act, deploy=deploy)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CSP(nn.Module):
    """YOLOv4 cross-stage-partial block, mish, residual bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int, deploy: bool = False):
        super().__init__()
        c_ = c1 // 2
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, c_, 1, 1, "mish", **kw)
        self.cv2 = ConvBlock(c1, c_, 1, 1, "mish", **kw)
        self.cv3 = ConvBlock(c_, c_, 1, 1, "mish", **kw)
        self.cv4 = ConvBlock(2 * c_, c2, 1, 1, "mish", **kw)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, True, "mish", **kw)
                                 for _ in range(n)))

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        return self.cv4(torch.cat([y1, self.cv2(x)], 1))


class C5(nn.Module):
    """Five leaky convs, 1-3-1-3-1 (the YOLOv4 neck)."""

    def __init__(self, c1: int, c2: int, deploy: bool = False):
        super().__init__()
        c_ = c1 // 2
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, c_, 1, 1, "leaky", **kw)
        self.cv2 = ConvBlock(c_, c1, 3, 1, "leaky", **kw)
        self.cv3 = ConvBlock(c1, c_, 1, 1, "leaky", **kw)
        self.cv4 = ConvBlock(c_, c1, 3, 1, "leaky", **kw)
        self.cv5 = ConvBlock(c1, c2, 1, 1, "leaky", **kw)

    def forward(self, x):
        return self.cv5(self.cv4(self.cv3(self.cv2(self.cv1(x)))))


class C3(nn.Module):
    """CSP bottleneck with three convs, swish (YOLOv5)."""

    def __init__(self, c1: int, c2: int, n: int, shortcut: bool = True,
                 deploy: bool = False):
        super().__init__()
        c_ = c1 // 2
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, c_, 1, 1, "swish", **kw)
        self.cv2 = ConvBlock(c1, c_, 1, 1, "swish", **kw)
        self.cv3 = ConvBlock(2 * c_, c2, 1, 1, "swish", **kw)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, "swish", **kw)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class ELAN1(nn.Module):
    """v7 backbone aggregation block (4 branches)."""

    def __init__(self, c1: int, c2: int, e1: float = 0.5, e2: float = 0.5,
                 deploy: bool = False):
        super().__init__()
        h1, h2 = int(c1 * e1), int(c1 * e2)
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, h1, 1, 1, "swish", **kw)
        self.cv2 = ConvBlock(c1, h1, 1, 1, "swish", **kw)
        self.cv3 = ConvBlock(h1, h2, 3, 1, "swish", **kw)
        self.cv4 = ConvBlock(h2, h2, 3, 1, "swish", **kw)
        self.cv5 = ConvBlock(h2, h2, 3, 1, "swish", **kw)
        self.cv6 = ConvBlock(h2, h2, 3, 1, "swish", **kw)
        self.cv7 = ConvBlock(2 * h1 + 2 * h2, c2, 1, 1, "swish", **kw)

    def forward(self, x):
        x1, x2 = self.cv1(x), self.cv2(x)
        x3 = self.cv4(self.cv3(x2))
        x4 = self.cv6(self.cv5(x3))
        return self.cv7(torch.cat([x1, x2, x3, x4], 1))


class ELAN2(nn.Module):
    """v7 neck aggregation block (6 branches)."""

    def __init__(self, c1: int, c2: int, e1: float = 0.5, e2: float = 0.25,
                 deploy: bool = False):
        super().__init__()
        h1, h2 = int(c1 * e1), int(c1 * e2)
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, h1, 1, 1, "swish", **kw)
        self.cv2 = ConvBlock(c1, h1, 1, 1, "swish", **kw)
        self.cv3 = ConvBlock(h1, h2, 3, 1, "swish", **kw)
        self.cv4 = ConvBlock(h2, h2, 3, 1, "swish", **kw)
        self.cv5 = ConvBlock(h2, h2, 3, 1, "swish", **kw)
        self.cv6 = ConvBlock(h2, h2, 3, 1, "swish", **kw)
        self.cv7 = ConvBlock(2 * h1 + 4 * h2, c2, 1, 1, "swish", **kw)

    def forward(self, x):
        x1, x2 = self.cv1(x), self.cv2(x)
        x3 = self.cv3(x2)
        x4 = self.cv4(x3)
        x5 = self.cv5(x4)
        x6 = self.cv6(x5)
        return self.cv7(torch.cat([x1, x2, x3, x4, x5, x6], 1))


class MaxConv(nn.Module):
    """Parallel 2x2 max-pool / strided-conv downsample.

    The 2x2 pool floors odd sizes, as flax's VALID pool does."""

    def __init__(self, c1: int, e: float = 0.5, deploy: bool = False):
        super().__init__()
        c_ = int(c1 * e)
        self.cv1 = ConvBlock(c1, c_, 1, 1, "swish", deploy=deploy)
        self.cv2 = ConvBlock(c1, c_, 1, 1, "swish", deploy=deploy)
        self.cv3 = ConvBlock(c_, c_, 3, 2, "swish", deploy=deploy)

    def forward(self, x):
        x1 = self.cv1(_spatial().max_pool2d(x, 2, 2, 0))
        x2 = self.cv3(self.cv2(x))
        return torch.cat([x1, x2], 1)


class ImplicitA(nn.Module):
    """YOLOR additive prior, ``implicit`` of shape (1, C, 1, 1)."""

    def __init__(self, channels: int, mean: float = 0.0, std: float = 0.02):
        super().__init__()
        self.implicit = nn.Parameter(torch.empty(1, channels, 1, 1))
        nn.init.normal_(self.implicit, mean, std)

    def forward(self, x):
        return x + self.implicit.to(x.dtype)


class ImplicitM(nn.Module):
    """YOLOR multiplicative prior, ``implicit`` of shape (1, C, 1, 1)."""

    def __init__(self, channels: int, mean: float = 1.0, std: float = 0.02):
        super().__init__()
        self.implicit = nn.Parameter(torch.empty(1, channels, 1, 1))
        nn.init.normal_(self.implicit, mean, std)

    def forward(self, x):
        return x * self.implicit.to(x.dtype)


class RepConv(nn.Module):
    """RepVGG block: 3x3-BN + 1x1-BN (+ identity BN), SiLU.

    Deploy form: the branches merged into one biased 3x3 conv ``fused``
    (an :class:`Int8Conv` in the int8 deploy form, its SiLU in float32).
    """

    def __init__(self, c1: int, c2: int, s: int = 1, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = nn.Conv2d(c1, c2, 3, s, 1, bias=True)
            return
        self.rbr_identity = _bn(c1) if c1 == c2 and s == 1 else None
        self.rbr_dense = nn.Sequential(nn.Conv2d(c1, c2, 3, s, 1, bias=False),
                                       _bn(c2))
        self.rbr_1x1 = nn.Sequential(nn.Conv2d(c1, c2, 1, s, 0, bias=False),
                                     _bn(c2))

    def forward(self, x):
        if self.deploy:
            return _act_to(F.silu, self.fused, x)
        out = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return F.silu(out)


class SPP(nn.Module):
    """YOLOv4 spatial pyramid pooling (13/9/5), leaky."""

    def __init__(self, c1: int, c2: int, deploy: bool = False):
        super().__init__()
        c_ = c1 // 2
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, c_, 1, 1, "leaky", **kw)
        self.cv2 = ConvBlock(c_, c1, 3, 1, "leaky", **kw)
        self.cv3 = ConvBlock(c1, c_, 1, 1, "leaky", **kw)
        self.cv4 = ConvBlock(4 * c_, c_, 1, 1, "leaky", **kw)
        self.cv5 = ConvBlock(c_, c1, 3, 1, "leaky", **kw)
        self.cv6 = ConvBlock(c1, c2, 1, 1, "leaky", **kw)

    def forward(self, x):
        x = self.cv3(self.cv2(self.cv1(x)))
        y = torch.cat([max_pool_same(x, 13), max_pool_same(x, 9),
                       max_pool_same(x, 5), x], 1)
        return self.cv6(self.cv5(self.cv4(y)))


class SPPF(nn.Module):
    """YOLOv5 fast SPP: three chained 5 x 5 pools, swish."""

    def __init__(self, c1: int, c2: int, deploy: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBlock(c1, c_, 1, 1, "swish", deploy=deploy)
        self.cv2 = ConvBlock(4 * c_, c2, 1, 1, "swish", deploy=deploy)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, 5)
        y2 = max_pool_same(y1, 5)
        return self.cv2(torch.cat([x, y1, y2, max_pool_same(y2, 5)], 1))


class SPPCSPC(nn.Module):
    """YOLOv7 CSP-wrapped spatial pyramid pooling (5/9/13)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5,
                 pools=(5, 9, 13), deploy: bool = False):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.pools = tuple(pools)
        kw = dict(deploy=deploy)
        self.cv1 = ConvBlock(c1, c_, 1, 1, "swish", **kw)
        self.cv2 = ConvBlock(c1, c_, 1, 1, "swish", **kw)
        self.cv3 = ConvBlock(c_, c_, 3, 1, "swish", **kw)
        self.cv4 = ConvBlock(c_, c_, 1, 1, "swish", **kw)
        self.cv5 = ConvBlock((1 + len(self.pools)) * c_, c_, 1, 1, "swish",
                             **kw)
        self.cv6 = ConvBlock(c_, c_, 3, 1, "swish", **kw)
        self.cv7 = ConvBlock(2 * c_, c2, 1, 1, "swish", **kw)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = torch.cat([x1] + [max_pool_same(x1, k) for k in self.pools], 1)
        y1 = self.cv6(self.cv5(y1))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))
