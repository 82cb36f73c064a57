"""YOLOv7 PAN neck (counterpart of ``ryolo_tpu/nn/necks.py:110``).

Input ``(d5, d4, d3)``; output the head maps ``(x6, x5, x4)`` at strides
``(8, 16, 32)``, NCHW ``(B, na*nf, gh, gw)``.  In deploy form the
ImplicitA/M priors are absorbed into ``conv5``/``conv6``/``conv7``
(``nn/deploy.py``) and are not modules of the graph.
"""

from __future__ import annotations

import torch
from torch import nn

from ryolo_tpu_torch.nn.blocks import (ELAN2, ConvBlock, ImplicitA, ImplicitM,
                                       MaxConv, RepConv, upsample2x)


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
            setattr(self, f"conv{i + 4}",
                    ConvBlock(c_rep, out_ch, 1, 1, "linear", bn=False,
                              bias=True, **kw))
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


NECKS = {"yolov7": Neckv7}
