"""YOLOv4/v5/v7 building blocks in plain PyTorch, the benchmark's frozen
reference (copied from ``ryolo_tpu_torch/nn/blocks.py`` at commit d329eff,
then cut to the float32 training and eval forms).

Departures from the copy: no deploy or int8 forms, no spatial split; the
stride-1 pools are ``F.max_pool2d`` with its implicit -inf padding, the 2x
upsample is nearest-neighbour ``F.interpolate``, and BatchNorm is
``nn.BatchNorm2d`` (its running variance moves toward the unbiased batch
variance, which no comparison of the benchmark reads: in training the
forward normalises by the batch's biased variance either way).  Attribute
names and registration order are the ``.pth`` layout's, so a state dict of
the port's model loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _identity(x):
    return x


def _leaky(x):
    return F.leaky_relu(x, 0.1)


ACTIVATIONS = {"mish": F.mish, "leaky": _leaky, "swish": F.silu,
               "linear": _identity}


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max pool, same-size output, -inf padding."""
    return F.max_pool2d(x, k, 1, k // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBlock(nn.Module):
    """Conv2d (pad (k-1)/2) -> BN -> activation, as ``conv.0``/``conv.1``;
    ``bn=False, bias=True`` is a detection-head conv."""

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
        return self.act(self.conv(x))


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
        x1 = self.cv1(F.max_pool2d(x, 2, 2, 0))
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

    Deploy form: the branches merged into one biased 3x3 conv ``fused``.
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
            return F.silu(self.fused(x))
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
