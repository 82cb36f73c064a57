"""YOLO11l-OBB in plain PyTorch: the reference that the port's YOLO11 and
its OBB head are held to.

Ultralytics' YOLO11-OBB at scale l (``cfg/models/11/yolo11-obb.yaml``:
depth 1.0, width 1.0, at most 512 channels, every repeat 2; modules of
``ultralytics/nn/modules/{conv,block,head}.py``; scaling by
``nn/tasks.py`` ``parse_model``, which sets ``c3k`` on every C3k2 at
scales m, l and x), written out unfused in float32: each Conv is a bias-
free Conv2d, a BatchNorm (eps 1e-3) and SiLU; the attention is two plain
matmuls and a softmax.  Run it with :func:`float32_math` (no TF32 in
matmuls or cuDNN convolutions).

The module and parameter names are those of the port (``ryolo_tpu_torch.
nn``: a Conv's ``conv.0`` and ``conv.1``, the backbone's ``b0``-``b10``,
the neck's ``n13``-``n22``, the head's ``cv2``/``cv3``/``cv4``), so one
state_dict loads into both.

:func:`decode` is Ultralytics' OBB decode (DFL expectation over 16 bins,
``dist2rbox``, ``theta = (sigmoid(a) - 0.25) pi``) giving its ``xywhr``
boxes; :func:`candidates` forms the NMS's input as the port's post-process
forms it: boxes in the port's convention (``[x, y, h_u, w_u, -theta_u]``,
the side along the local x axis first), descending score with ties by
index, at most 5,000.

Departures from Ultralytics: the NMS is the port's greedy NMS on polygon
IoU with its caps (5,000 candidates in, 1,500 kept), where Ultralytics
takes ProbIoU and 30,000 / 300; no ``regularize_rboxes``, which leaves
every IoU unchanged.

This file imports torch alone (no JAX, nothing of the port);
``h100_bench/reference/yolo11_obb.py`` is a byte-identical copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

STRIDES = (8, 16, 32)
REG_MAX = 16
EPS = 1e-3  # Ultralytics' BatchNorm eps
MAX_NMS = 5000
MAX_WH = 4096.0  # the port's class offset in the NMS


def float32_math():
    """float32 matmuls and cuDNN convolutions, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Conv(nn.Module):
    """``Conv(c1, c2, k, s, g, act)``: Conv2d (pad k//2, groups g, no
    bias), BatchNorm, SiLU or none."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False),
            nn.BatchNorm2d(c2, eps=EPS))
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """3x3 to ``int(c2 e)``, 3x3 to c2, plus ``x`` when c1 == c2."""

    def __init__(self, c1, c2, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 3)
        self.cv2 = Conv(c_, c2, 3)
        self.add = c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """``cv3(cat(m(cv1(x)), cv2(x)))``, m two 3x3-3x3 bottlenecks."""

    def __init__(self, c1, c2, n=2, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, 1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    """``cv1`` to 2c, halves, each block on the last piece, ``cv2`` over
    all; blocks C3k when ``c3k``, else bottlenecks at e 0.5."""

    def __init__(self, c1, c2, n=2, c3k=True, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((2 + n) * c, c2)
        self.m = nn.ModuleList(C3k(c, c, 2) if c3k else Bottleneck(c, c)
                               for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """``cv1`` to c1/2, three chained 5x5 stride-1 max pools, ``cv2``."""

    def __init__(self, c1, c2):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(4 * c_, c2)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """Heads ``dim // 64``, head size ``hd = dim / heads``, key size ``kd
    = hd / 2``: ``out = proj(v softmax_keys(q^T k kd^-0.5)^T + pe(v))``."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = self.head_dim // 2
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, act=False)
        self.proj = Conv(dim, dim, act=False)
        self.pe = Conv(dim, dim, 3, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        n, kd = h * w, self.key_dim
        qkv = self.qkv(x).view(b, self.num_heads, 2 * kd + self.head_dim, n)
        q, k, v = qkv[:, :, :kd], qkv[:, :, kd:2 * kd], qkv[:, :, 2 * kd:]
        logits = torch.matmul(q.transpose(2, 3), k) * kd ** -0.5  # (b,h,n,n)
        attn = torch.softmax(logits, dim=3)
        out = torch.matmul(v, attn.transpose(2, 3)).reshape(b, c, h, w)
        return self.proj(out + self.pe(v.reshape(b, c, h, w)))


class PSABlock(nn.Module):
    """``x + attn(x)``, then plus ``ffn``: 1x1 to 2c (SiLU), 1x1 back."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(Conv(c, 2 * c), Conv(2 * c, c, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """``cv1`` to 2c (c = c1/2), ``b`` through n PSABlocks, ``cv2(cat(a,
    b))``."""

    def __init__(self, c1, n=2):
        super().__init__()
        self.c = c = c1 // 2
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv(2 * c, c1)
        self.m = nn.Sequential(*(PSABlock(c, c // 64) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class Backbone(nn.Module):
    """Layers 0-10; returns layers 4, 6 and 10."""

    def __init__(self):
        super().__init__()
        self.b0 = Conv(3, 64, 3, 2)
        self.b1 = Conv(64, 128, 3, 2)
        self.b2 = C3k2(128, 256, e=0.25)
        self.b3 = Conv(256, 256, 3, 2)
        self.b4 = C3k2(256, 512, e=0.25)
        self.b5 = Conv(512, 512, 3, 2)
        self.b6 = C3k2(512, 512)
        self.b7 = Conv(512, 512, 3, 2)
        self.b8 = C3k2(512, 512)
        self.b9 = SPPF(512, 512)
        self.b10 = C2PSA(512)

    def forward(self, x):
        x4 = self.b4(self.b3(self.b2(self.b1(self.b0(x)))))
        x6 = self.b6(self.b5(x4))
        x10 = self.b10(self.b9(self.b8(self.b7(x6))))
        return x4, x6, x10


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Neck(nn.Module):
    """Layers 11-22 over (layer 10, layer 6, layer 4); concats put the
    upsampled or strided map first; returns P3 (256 channels), P4 (512),
    P5 (512)."""

    def __init__(self):
        super().__init__()
        self.n13 = C3k2(1024, 512)
        self.n16 = C3k2(1024, 256)
        self.n17 = Conv(256, 256, 3, 2)
        self.n19 = C3k2(768, 512)
        self.n20 = Conv(512, 512, 3, 2)
        self.n22 = C3k2(1024, 512)

    def forward(self, x10, x6, x4):
        x13 = self.n13(torch.cat([_up(x10), x6], 1))
        p3 = self.n16(torch.cat([_up(x13), x4], 1))
        p4 = self.n19(torch.cat([self.n17(p3), x13], 1))
        p5 = self.n22(torch.cat([self.n20(p4), x10], 1))
        return p3, p4, p5


class OBBHead(nn.Module):
    """Per level: box ``cv2`` (3x3, 3x3, 1x1 to 64), class ``cv3``
    (depthwise 3x3 + 1x1, twice, 1x1 to nc), angle ``cv4`` (3x3, 3x3, 1x1
    to 1); maps ``cat([box, cls, angle])``."""

    def __init__(self, nc, ch=(256, 512, 512)):
        super().__init__()
        c2 = max(16, ch[0] // 4, 4 * REG_MAX)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, 1)
        self.cv2 = nn.ModuleList(nn.Sequential(
            Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3)),
            nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3)),
            nn.Conv2d(c3, nc, 1)) for x in ch)
        self.cv4 = nn.ModuleList(nn.Sequential(
            Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, 1, 1))
            for x in ch)

    def forward(self, feats):
        return [torch.cat([self.cv2[i](x), self.cv3[i](x), self.cv4[i](x)],
                          1) for i, x in enumerate(feats)]


class Yolo11OBB(nn.Module):
    """The whole model: ``forward(images)`` gives the three head maps
    ``(B, 64 + nc + 1, H/s, W/s)``; :meth:`features` the neck's three
    outputs, which the head takes."""

    def __init__(self, nc):
        super().__init__()
        self.n_classes = nc
        self.backbone = Backbone()
        self.neck = Neck()
        self.head = OBBHead(nc)

    def features(self, images):
        x4, x6, x10 = self.backbone(images)
        return self.neck(x10, x6, x4)

    def forward(self, images):
        return self.head(self.features(images))


def decode(maps, nc, strides=STRIDES):
    """Ultralytics' decode of the head maps: ``(boxes, scores)``, boxes
    ``(B, N, 5)`` ``xywhr`` ``[x, y, w_u, h_u, theta_u]`` in pixels and
    radians, scores ``(B, N, nc)`` the class sigmoids; one candidate a
    position, levels concatenated, row-major."""
    boxes, scores = [], []
    for x, s in zip(maps, strides):
        b, c, h, w = x.shape
        x = x.float().reshape(b, c, h * w)
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
        prob = torch.softmax(x[:, :4 * REG_MAX].reshape(b, 4, REG_MAX, h * w),
                             dim=2)
        dist = (prob * bins[:, None]).sum(2)                   # (b, 4, hw)
        theta = (torch.sigmoid(x[:, 4 * REG_MAX + nc]) - 0.25) * math.pi
        gy, gx = torch.meshgrid(torch.arange(h, device=x.device),
                                torch.arange(w, device=x.device),
                                indexing="ij")
        ax, ay = gx.reshape(-1) + 0.5, gy.reshape(-1) + 0.5
        l, t, r, bt = dist.unbind(1)
        xf, yf = (r - l) / 2, (bt - t) / 2
        cos, sin = torch.cos(theta), torch.sin(theta)
        cx = (xf * cos - yf * sin + ax) * s
        cy = (xf * sin + yf * cos + ay) * s
        boxes.append(torch.stack([cx, cy, (l + r) * s, (t + bt) * s, theta],
                                 -1))
        scores.append(torch.sigmoid(x[:, 4 * REG_MAX:4 * REG_MAX + nc])
                      .transpose(1, 2))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def xywhr2xyxyxyxy(boxes):
    """Ultralytics' corners of ``xywhr`` boxes, ``(..., 4, 2)``: the
    centre plus and minus ``w/2 (cos, sin)`` and ``h/2 (-sin, cos)``."""
    ctr, w, h, theta = boxes[..., :2], boxes[..., 2:3], boxes[..., 3:4], \
        boxes[..., 4:5]
    cos, sin = torch.cos(theta), torch.sin(theta)
    v1 = torch.cat([w / 2 * cos, w / 2 * sin], -1)
    v2 = torch.cat([-h / 2 * sin, h / 2 * cos], -1)
    return torch.stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2,
                        ctr - v1 + v2], -2)


@torch.no_grad()
def candidates(maps, nc, conf_thres, max_nms=MAX_NMS):
    """The NMS's input from head maps, as the port's post-process forms
    it: rows ``(B, k, 7)`` ``[x, y, w, h, theta(rad), score, cls]`` in the
    port's convention (``w = h_u``, ``h = w_u``, ``theta = -theta_u``), by
    descending score (the class maximum, the first maximum winning),
    ties by index, ``k = min(max_nms, N)``; their valid flags (score above
    ``conf_thres``); and the boxes as the NMS sees them (centres offset by
    ``cls * 4096``, degrees)."""
    boxes, scores = decode(maps, nc)
    conf = scores[..., 0]
    cls = torch.zeros_like(conf)
    for c in range(1, nc):
        hit = scores[..., c] > conf
        conf = torch.where(hit, scores[..., c], conf)
        cls = torch.where(hit, float(c), cls)
    sel = torch.where(conf > conf_thres, conf, -1.0)
    k = min(max_nms, sel.shape[1])
    idx = torch.sort(-sel, dim=1, stable=True).indices[:, :k]
    top = sel.gather(1, idx)
    x, y, wu, hu, tu = (boxes[..., i].gather(1, idx) for i in range(5))
    tcls = cls.gather(1, idx)
    rows = torch.stack([x, y, hu, wu, -tu, top, tcls], -1)
    nms_boxes = torch.stack([x + tcls * MAX_WH, y + tcls * MAX_WH, hu, wu,
                             -tu * (180.0 / math.pi)], -1)
    return rows, top > 0.0, nms_boxes

