"""YOLOv7 ELAN backbone (counterpart of ``ryolo_tpu/nn/backbones.py:87``).

Returns ``(d3, d4, d5)`` at strides 8/16/32, SPPCSPC applied to d5.  The
JAX deploy graph's space-to-depth stem (``blocks.py:86``) is a TPU layout
trick and is not ported: the port keeps the plain ``cbs0``/``cbs1``.
"""

from __future__ import annotations

from torch import nn

from ryolo_tpu_torch.nn.blocks import ELAN1, SPPCSPC, ConvBlock, MaxConv


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


BACKBONES = {"yolov7": Backbonev7}
