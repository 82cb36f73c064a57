"""Backbones: YOLOv4 CSPDarknet-53, YOLOv5, YOLOv7 ELAN (counterparts of
``ryolo_tpu/nn/backbones.py``: ``Backbonev4`` :29, ``Backbonev5`` :61,
``Backbonev7`` :87).

Each returns ``(d3, d4, d5)`` at strides 8/16/32, its SPP variant applied
to d5.  The JAX graphs' space-to-depth stems (``S2DStem``,
``train_s2d_stem``, ``blocks.py:86``) are TPU layout tricks and are not
ported: the port keeps the plain ``cbm0``/``cbm1`` and ``cbs0``/``cbs1``.
"""

from __future__ import annotations

from torch import nn

from ryolo_tpu_torch.nn.blocks import (C3, CSP, ELAN1, SPP, SPPCSPC, SPPF,
                                       ConvBlock, MaxConv)


class Backbonev4(nn.Module):
    """CSPDarknet-53 with mish, SPP on d5 (512 channels out)."""

    def __init__(self, deploy: bool = False):
        super().__init__()
        kw = dict(deploy=deploy)
        self.cbm0 = ConvBlock(3, 32, 3, 1, "mish", **kw)
        self.cbm1 = ConvBlock(32, 64, 3, 2, "mish", **kw)
        self.csp1 = CSP(64, 64, 1, **kw)
        self.cbm2 = ConvBlock(64, 128, 3, 2, "mish", **kw)
        self.csp2 = CSP(128, 128, 2, **kw)
        self.cbm3 = ConvBlock(128, 256, 3, 2, "mish", **kw)
        self.csp3 = CSP(256, 256, 8, **kw)
        self.cbm4 = ConvBlock(256, 512, 3, 2, "mish", **kw)
        self.csp4 = CSP(512, 512, 8, **kw)
        self.cbm5 = ConvBlock(512, 1024, 3, 2, "mish", **kw)
        self.csp5 = CSP(1024, 1024, 4, **kw)
        self.spp = SPP(1024, 512, **kw)

    def forward(self, x):
        x = self.csp1(self.cbm1(self.cbm0(x)))
        x = self.csp2(self.cbm2(x))
        d3 = self.csp3(self.cbm3(x))
        d4 = self.csp4(self.cbm4(d3))
        d5 = self.spp(self.csp5(self.cbm5(d4)))
        return d3, d4, d5


class Backbonev5(nn.Module):
    """6x6 stride-2 stem (pad 2), C3 depths 3/6/9/3, SPPF on d5 (1024
    channels out)."""

    def __init__(self, deploy: bool = False):
        super().__init__()
        kw = dict(deploy=deploy)
        self.cbs0 = ConvBlock(3, 64, 6, 2, "swish", **kw)
        self.cbs1 = ConvBlock(64, 128, 3, 2, "swish", **kw)
        self.csp1 = C3(128, 128, 3, **kw)
        self.cbs2 = ConvBlock(128, 256, 3, 2, "swish", **kw)
        self.csp2 = C3(256, 256, 6, **kw)
        self.cbs3 = ConvBlock(256, 512, 3, 2, "swish", **kw)
        self.csp3 = C3(512, 512, 9, **kw)
        self.cbs4 = ConvBlock(512, 1024, 3, 2, "swish", **kw)
        self.csp4 = C3(1024, 1024, 3, **kw)
        self.spp = SPPF(1024, 1024, **kw)

    def forward(self, x):
        x = self.csp1(self.cbs1(self.cbs0(x)))
        d3 = self.csp2(self.cbs2(x))
        d4 = self.csp3(self.cbs3(d3))
        d5 = self.spp(self.csp4(self.cbs4(d4)))
        return d3, d4, d5


class Backbonev7(nn.Module):
    def __init__(self, deploy: bool = False):
        super().__init__()
        kw = dict(deploy=deploy)
        self.cbs0 = ConvBlock(3, 32, 3, 1, "swish", **kw)
        self.cbs1 = ConvBlock(32, 64, 3, 2, "swish", **kw)
        self.cbs2 = ConvBlock(64, 64, 3, 1, "swish", **kw)
        self.cbs3 = ConvBlock(64, 128, 3, 2, "swish", **kw)
        self.elan1 = ELAN1(128, 256, **kw)
        self.mc1 = MaxConv(256, **kw)
        self.elan2 = ELAN1(256, 512, **kw)
        self.mc2 = MaxConv(512, **kw)
        self.elan3 = ELAN1(512, 1024, **kw)
        self.mc3 = MaxConv(1024, **kw)
        self.elan4 = ELAN1(1024, 1024, e1=0.25, e2=0.25, **kw)
        self.spp = SPPCSPC(1024, 512, **kw)

    def forward(self, x):
        x = self.cbs3(self.cbs2(self.cbs1(self.cbs0(x))))
        x = self.mc1(self.elan1(x))
        d3 = self.elan2(x)
        d4 = self.elan3(self.mc2(d3))
        d5 = self.spp(self.elan4(self.mc3(d4)))
        return d3, d4, d5


BACKBONES = {"yolov4": Backbonev4, "yolov5": Backbonev5,
             "yolov7": Backbonev7}
