"""PAN necks for YOLOv4/v5/v7 (counterparts of ``ryolo_tpu/nn/necks.py``:
``Neckv4`` :28, ``Neckv5`` :72, ``Neckv7`` :110).

Input ``(d5, d4, d3)``; output the head maps ``(x6, x5, x4)`` at strides
``(8, 16, 32)``, NCHW ``(B, na*nf, gh, gw)``.  Modules are registered in
the reference ``.pth`` order, which is not the order of the forward.  The
PAN concatenations differ by version: v4 puts the downsampled map first,
v5 second.  In the v7 deploy form the ImplicitA/M priors are absorbed into
``conv5``/``conv6``/``conv7`` (``nn/deploy.py``) and are not modules of
the graph.  YOLO11's neck (Ultralytics' ``yolo11-obb.yaml`` layers 11-22)
returns the three features its separate head (:class:`~ryolo_tpu_torch.nn.
heads.OBBHead`) takes.
"""

from __future__ import annotations

import torch
from torch import nn

from ryolo_tpu_torch.nn.blocks import (C3, C5, ELAN2, C3k2, ConvBlock,
                                       ImplicitA, ImplicitM, MaxConv, RepConv,
                                       conv11, upsample2x)


def _head_conv(c1: int, out_ch: int, deploy: bool) -> ConvBlock:
    """The biased 1x1 detection conv, no BN, linear."""
    return ConvBlock(c1, out_ch, 1, 1, "linear", bn=False, bias=True,
                     deploy=deploy)


class Neckv4(nn.Module):
    """YOLOv4 FPN + PAN with C5 blocks, leaky; d5 arrives at 512
    channels (after SPP)."""

    def __init__(self, out_ch: int, deploy: bool = False):
        super().__init__()
        kw = dict(deploy=deploy)
        self.conv7 = ConvBlock(512, 256, 1, 1, "leaky", **kw)
        self.conv8 = ConvBlock(512, 256, 1, 1, "leaky", **kw)
        self.conv9 = C5(512, 256, **kw)
        self.conv14 = ConvBlock(256, 128, 1, 1, "leaky", **kw)
        self.conv15 = ConvBlock(256, 128, 1, 1, "leaky", **kw)
        self.conv16 = C5(256, 128, **kw)
        self.conv21 = ConvBlock(128, 256, 3, 1, "leaky", **kw)
        self.conv22 = _head_conv(256, out_ch, deploy)
        self.conv23 = ConvBlock(128, 256, 3, 2, "leaky", **kw)
        self.conv24 = C5(512, 256, **kw)
        self.conv29 = ConvBlock(256, 512, 3, 1, "leaky", **kw)
        self.conv30 = _head_conv(512, out_ch, deploy)
        self.conv31 = ConvBlock(256, 512, 3, 2, "leaky", **kw)
        self.conv32 = C5(1024, 512, **kw)
        self.conv37 = ConvBlock(512, 1024, 3, 1, "leaky", **kw)
        self.conv38 = _head_conv(1024, out_ch, deploy)

    def forward(self, x1, x2, x3):
        up1 = upsample2x(self.conv7(x1))
        x2 = self.conv9(torch.cat([self.conv8(x2), up1], 1))
        up2 = upsample2x(self.conv14(x2))
        x3 = self.conv16(torch.cat([self.conv15(x3), up2], 1))
        x6 = self.conv22(self.conv21(x3))
        x2 = self.conv24(torch.cat([self.conv23(x3), x2], 1))
        x5 = self.conv30(self.conv29(x2))
        x1 = self.conv32(torch.cat([self.conv31(x2), x1], 1))
        x4 = self.conv38(self.conv37(x1))
        return x6, x5, x4


class Neckv5(nn.Module):
    """YOLOv5 FPN + PAN with C3 blocks (no shortcut), swish; d5 arrives at
    1024 channels (after SPPF)."""

    def __init__(self, out_ch: int, deploy: bool = False):
        super().__init__()
        kw = dict(deploy=deploy)
        self.conv7 = ConvBlock(1024, 512, 1, 1, "swish", **kw)
        self.csp1 = C3(1024, 512, 3, shortcut=False, **kw)
        self.conv14 = ConvBlock(512, 256, 1, 1, "swish", **kw)
        self.csp2 = C3(512, 256, 3, shortcut=False, **kw)
        self.conv15 = _head_conv(256, out_ch, deploy)
        self.conv16 = ConvBlock(256, 256, 3, 2, "swish", **kw)
        self.csp3 = C3(512, 512, 3, shortcut=False, **kw)
        self.conv17 = _head_conv(512, out_ch, deploy)
        self.conv18 = ConvBlock(512, 512, 3, 2, "swish", **kw)
        self.csp4 = C3(1024, 1024, 3, shortcut=False, **kw)
        self.conv19 = _head_conv(1024, out_ch, deploy)

    def forward(self, x1, x2, x3):
        x1 = self.conv7(x1)
        x2 = self.conv14(self.csp1(torch.cat([x2, upsample2x(x1)], 1)))
        x3 = self.csp2(torch.cat([x3, upsample2x(x2)], 1))
        x6 = self.conv15(x3)
        x2 = self.csp3(torch.cat([x2, self.conv16(x3)], 1))
        x5 = self.conv17(x2)
        x1 = self.csp4(torch.cat([x1, self.conv18(x2)], 1))
        return x6, x5, self.conv19(x1)


class Neckv7(nn.Module):
    def __init__(self, out_ch: int, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        kw = dict(deploy=deploy)
        # registration order = reference .pth order
        self.conv1 = ConvBlock(512, 256, 1, 1, "swish", **kw)
        self.elan1 = ELAN2(512, 256, **kw)
        self.conv2 = ConvBlock(256, 128, 1, 1, "swish", **kw)
        self.elan2 = ELAN2(256, 128, **kw)
        self.conv3 = ConvBlock(1024, 256, 1, 1, "swish", **kw)
        self.conv4 = ConvBlock(512, 128, 1, 1, "swish", **kw)
        self.mc1 = MaxConv(128, e=1.0, **kw)
        self.elan3 = ELAN2(512, 256, **kw)
        self.mc2 = MaxConv(256, e=1.0, **kw)
        self.elan4 = ELAN2(1024, 512, **kw)
        for i, (c_in, c_rep) in enumerate(((128, 256), (256, 512),
                                           (512, 1024)), start=1):
            setattr(self, f"repVgg{i}", RepConv(c_in, c_rep, **kw))
            if not deploy:
                setattr(self, f"ia{i}", ImplicitA(c_rep))
            setattr(self, f"conv{i + 4}", _head_conv(c_rep, out_ch, deploy))
            if not deploy:
                setattr(self, f"im{i}", ImplicitM(out_ch))

    def _head(self, i: int, x):
        x = getattr(self, f"repVgg{i}")(x)
        if not self.deploy:
            x = getattr(self, f"ia{i}")(x)
        x = getattr(self, f"conv{i + 4}")(x)
        if not self.deploy:
            x = getattr(self, f"im{i}")(x)
        return x

    def forward(self, x1, x2, x3):
        x4 = upsample2x(self.conv1(x1))
        x2 = self.elan1(torch.cat([self.conv3(x2), x4], 1))
        x5 = upsample2x(self.conv2(x2))
        x3 = self.elan2(torch.cat([self.conv4(x3), x5], 1))
        x6 = self._head(1, x3)
        x2 = self.elan3(torch.cat([x2, self.mc1(x3)], 1))
        h5 = self._head(2, x2)
        x1 = self.elan4(torch.cat([x1, self.mc2(x2)], 1))
        h4 = self._head(3, x1)
        return x6, h5, h4


class Neck11(nn.Module):
    """YOLO11's FPN + PAN at scale l, each concat with the upsampled or
    strided map first; returns ``(P3, P4, P5)`` at 256, 512 and 512
    channels, strides 8, 16 and 32."""

    def __init__(self, deploy: bool = False):
        super().__init__()
        kw = dict(deploy=deploy)
        self.n13 = C3k2(1024, 512, **kw)
        self.n16 = C3k2(1024, 256, **kw)
        self.n17 = conv11(256, 256, 3, 2, **kw)
        self.n19 = C3k2(768, 512, **kw)
        self.n20 = conv11(512, 512, 3, 2, **kw)
        self.n22 = C3k2(1024, 512, **kw)

    def forward(self, x1, x2, x3):
        x13 = self.n13(torch.cat([upsample2x(x1), x2], 1))
        p3 = self.n16(torch.cat([upsample2x(x13), x3], 1))
        p4 = self.n19(torch.cat([self.n17(p3), x13], 1))
        p5 = self.n22(torch.cat([self.n20(p4), x1], 1))
        return p3, p4, p5


NECKS = {"yolov4": Neckv4, "yolov5": Neckv5, "yolov7": Neckv7,
         "yolo11": Neck11}
