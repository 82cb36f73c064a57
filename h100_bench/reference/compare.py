"""The reference's runs and the numbers that decide ``correct``.

* Training: :func:`train_steps` runs the reference's first steps from the
  seeded initial state on the loader's spec batches (the timed call's
  inputs), rendering them from its own tile bank; :func:`leaf_gap` reads a
  gap of per-leaf norms by the worst leaf.
* Detect: :func:`forward_heads` is the unfused float32 model's forward on
  the uint8 batch, with the neck features that the head convolutions
  take; :func:`channel_gaps` their relative L2 gaps channel by channel,
  :func:`rel_gap` the worst image's gap over all; :func:`head_maps` the
  head convolutions' own maps of given features; :func:`candidates`
  re-derives, from the port's own head maps,
  the score-sorted candidates that its NMS takes; :func:`nms_faults` holds
  the port's ``(dets, valid)`` to greedy NMS over them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from .csl import csl_loss
from .heads import decode_csl_defer
from .postprocess import MAX_NMS, MAX_WH, _payload_and_sel, deferred_theta
from .render import render_taps_plain
from .rotated_iou import rotated_iou_pairs
from .yolo import STRIDES, Yolo

SGD_MOMENTUM = 0.937  # Nesterov, the port's make_optimizer("SGD")
# NMS decisions are held with this slack in IoU: the kernel and the plain
# IoU part by rounding at pairs whose IoU lies on the threshold
IOU_SLACK = 1e-5


def float32_math(tf32: bool = False):
    """float32 convolutions and matmuls without TF32 (``tf32=True`` is the
    precision control)."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def build_model(cfg: dict, device, train: bool) -> Yolo:
    """The configuration's model on ``device``, its storage uninitialised
    (every caller loads or draws all of it)."""
    with torch.device("meta"):
        model = Yolo(cfg["nc"], cfg["model"], mode=cfg["mode"],
                     ver=cfg["ver"])
    return model.to_empty(device=device).train(train)


def render(batch: dict, bank: torch.Tensor, n_out: int) -> torch.Tensor:
    """The batch's images, rendered by the plain tap renderer from
    ``bank`` (banked specs) or the batch's own pixel tiles."""
    common = [batch[k] for k in ("spec_region", "spec_offset", "spec_hsv",
                                 "spec_minv", "spec_flip", "spec_mix_idx",
                                 "spec_mix_r")]
    if "spec_tile_idx" in batch:
        return render_taps_plain(bank, batch["spec_tile_idx"], *common, n_out)
    tiles = torch.from_numpy(batch["spec_tiles"]).to(bank.device)
    b, t, s = tiles.shape[:3]
    rows = np.arange(b * t, dtype=np.int64).reshape(b, t)
    return render_taps_plain(tiles.view(b * t, s, s), rows, *common, n_out)


def train_steps(cfg: dict, state0: Dict[str, torch.Tensor],
                batches: Sequence[dict], bank: torch.Tensor, lr: float,
                n_out: int, device) -> dict:
    """Reference SGD steps (Nesterov, momentum 0.937, no weight decay) from
    ``state0`` over ``batches``: each step's loss, the first step's
    gradient and the parameters after the last step (CPU float32)."""
    model = build_model(cfg, device, train=True)
    model.load_state_dict(state0)
    anchors = [torch.as_tensor(a, device=device) for a in model.anchors]
    params = dict(model.named_parameters())
    bufs: Dict[str, torch.Tensor] = {}
    losses, grad1 = [], None
    for i, batch in enumerate(batches):
        images = render(batch, bank, n_out)
        tgt = {k: torch.from_numpy(batch[k]).to(device)
               for k in ("tgt", "tgt_csl", "tgt_mask")}
        model.zero_grad(set_to_none=True)
        loss, items = csl_loss(model(images), tgt["tgt"], tgt["tgt_csl"],
                               tgt["tgt_mask"], anchors, cfg["nc"],
                               cfg["hyp"])
        loss.backward()
        with torch.no_grad():
            for name, p in params.items():
                g = p.grad
                buf = bufs.get(name)
                if buf is None:
                    buf = bufs[name] = g.clone()
                else:
                    buf.mul_(SGD_MOMENTUM).add_(g)
                p.sub_(lr * (g + SGD_MOMENTUM * buf))
        if i == 0:
            grad1 = {k: p.grad.to("cpu", copy=True) for k, p in params.items()}
        losses.append(float(items["total_loss"].detach()))
    after = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    return dict(losses=losses, grad1=grad1, params=after)


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             names: Sequence[str] | None = None):
    """``(worst gap, its leaf)``: ``|got - want| / max(want, median want)``
    over ``names`` (all leaves by default)."""
    names = list(want) if names is None else list(names)
    med = float(np.median([want[k] for k in names]))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def head_convs(model) -> List[torch.nn.Conv2d]:
    """The three detection-head convolutions (``na * nf`` outputs), in
    level order; the same in the unfused and the deploy-fused model."""
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)
             and m.out_channels == model.na * model.nf]
    if len(convs) != 3:
        raise RuntimeError(f"{len(convs)} head convolutions found")
    return convs


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float]):
    """The median over leaves of ``|got - want| / max(want, median want)``."""
    med = float(np.median(list(want.values())))
    return float(np.median([abs(got[k] - want[k]) / max(want[k], med, 1e-30)
                            for k in want]))


@torch.no_grad()
def forward_heads(model: Yolo, images: np.ndarray, device):
    """The float32 head maps of a uint8 ``(B, S, S, 3)`` RGB batch, and the
    neck's features that the head convolutions take."""
    feats = []
    hooks = [c.register_forward_pre_hook(
        lambda _m, inp: feats.append(inp[0].float())) for c in
        head_convs(model)]
    try:
        x = torch.from_numpy(images).to(device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        heads = [h.float() for h in model(x)]
    finally:
        for h in hooks:
            h.remove()
    return heads, feats


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def head_maps(model: Yolo, feats: Sequence[torch.Tensor], fp8: bool = False):
    """The head maps that ``model``'s head convolutions (1x1, biased,
    linear) make of ``feats``, in float32; ``fp8``: inputs and kernels
    rounded to float8 e4m3 first (the precision control)."""
    q = _fp8 if fp8 else (lambda x: x)
    return [torch.nn.functional.conv2d(q(f.float()), q(c.weight.float()),
                                       c.bias.float())
            for c, f in zip(head_convs(model), feats)]


# a channel is off when its relative L2 gap from the reference passes this:
# 8x bf16's median channel, under int8's (CPU, 256 px: 0.004 and 0.013)
CHANNEL_OFF = 0.03


def channel_gaps(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]):
    """``(B, C)``: each image's and channel's ``||got - want|| / ||want||``
    over its positions, the levels' channels side by side."""
    return torch.cat([((g.float() - w).double().pow(2).sum((2, 3))
                       / w.double().pow(2).sum((2, 3)).clamp_min(1e-30))
                      .sqrt() for g, w in zip(got, want)], 1)


def head_gaps(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]):
    """``(B, C)``: each image's and channel's ``||got - want||`` over its
    positions, against the larger of the channel's ``||want||`` and the
    median channel's of its level (a channel near nought reads the
    rounding of its inputs, not its own)."""
    out = []
    for g, w in zip(got, want):
        num = (g.float() - w).double().pow(2).sum((2, 3)).sqrt()
        den = w.double().pow(2).sum((2, 3)).sqrt()
        den = torch.maximum(den, den.median(1, keepdim=True).values)
        out.append(num / den.clamp_min(1e-30))
    return torch.cat(out, 1)


def rel_gap(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]):
    """Worst image's ``||got - want|| / ||want||`` over all the maps."""
    b = want[0].shape[0]
    num = sum((g.float() - w).reshape(b, -1).double().pow(2).sum(1)
              for g, w in zip(got, want))
    den = sum(w.reshape(b, -1).double().pow(2).sum(1) for w in want)
    return float((num / den).sqrt().max())


@torch.no_grad()
def candidates(heads: Sequence[torch.Tensor], anchors, na: int, nc: int,
               conf_thres: float, max_nms: int = MAX_NMS):
    """The NMS's input, from head maps as the port's post-process takes
    them: rows ``(B, k, 7)`` ``[x, y, w, h, theta(rad), score, cls]`` in
    descending score (ties by index), their valid flags, and the boxes as
    the NMS sees them (class-offset centres, degrees)."""
    dec = decode_csl_defer(heads, anchors, STRIDES, nc)
    payload, sel = _payload_and_sel(dec, conf_thres)
    k = min(max_nms, sel.shape[1])
    idx = torch.sort(-sel, dim=1, stable=True).indices[:, :k]
    top = sel.gather(1, idx)
    bx, by, bw, bh, _, tcls = (p.gather(1, idx) for p in payload)
    bt = deferred_theta(heads, idx, na, nc)
    rows = torch.stack([bx, by, bw, bh, bt, top, tcls], -1)
    nms_boxes = torch.stack([bx + tcls * MAX_WH, by + tcls * MAX_WH, bw, bh,
                             bt * (180.0 / math.pi)], -1)
    return rows, top > 0.0, nms_boxes


# a kept row is a candidate when it has its class and lies within these of
# its x, y, w, h (px), theta (rad) and score
MATCH_TOL = (1e-3, 1e-3, 1e-3, 1e-3, 1e-4, 1e-5, 0.0)


def _match(got: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor):
    """Index of the candidate each kept row is, -1 where none."""
    out = torch.full((len(got),), -1, dtype=torch.long, device=got.device)
    cand = torch.nonzero(valid).flatten()
    if len(cand) == 0:
        return out
    c = rows[cand]
    tol = torch.tensor(MATCH_TOL, device=got.device)
    for lo in range(0, len(got), 256):
        ok = ((got[lo:lo + 256, None, :] - c[None]).abs() <= tol).all(-1)
        out[lo:lo + 256] = torch.where(ok.any(1), cand[ok.float().argmax(1)],
                                       -1)
    return out


def _near_iou(boxes: torch.Tensor, r: torch.Tensor, e: torch.Tensor):
    """IoU of pairs ``(r, e)`` (rows as box1), 0 where the circumscribed
    circles cannot meet."""
    br, be = boxes[r].double(), boxes[e].double()
    dist = (br[:, :2] - be[:, :2]).norm(dim=1)
    reach = 0.5 * (br[:, 2:4].norm(dim=1) + be[:, 2:4].norm(dim=1)) + 1.0
    near = torch.nonzero(dist <= reach).flatten()
    iou = torch.zeros(len(r), dtype=torch.float32, device=boxes.device)
    for lo in range(0, len(near), 1 << 20):
        sel = near[lo:lo + (1 << 20)]
        iou[sel] = rotated_iou_pairs(boxes[r[sel]], boxes[e[sel]]).reshape(-1)
    return iou


def nms_faults(dets: np.ndarray, valid: np.ndarray, rows: torch.Tensor,
               cvalid: torch.Tensor, nms_boxes: torch.Tensor, iou_thres: float,
               max_det: int) -> Dict[str, int]:
    """The port's ``(dets, valid)`` held to greedy rotated NMS over the
    re-derived candidates, image by image.  Counts: ``rows_off``, kept rows
    that are no candidate (or out of score order, or twice); ``overlap``,
    kept pairs with IoU above the threshold; ``missed``, valid candidates
    neither kept nor suppressed by an earlier kept one (below the
    ``max_det`` cap); ``slots``, valid output slots beyond the kept
    prefix."""
    dev = rows.device
    out = dict(rows_off=0, overlap=0, missed=0, slots=0)
    for b in range(len(dets)):
        v = np.asarray(valid[b], bool)
        n = int(v.sum())
        out["slots"] += int((~v[:n]).sum()) if n else 0
        got = torch.as_tensor(dets[b][v], dtype=torch.float32, device=dev)
        idx = _match(got, rows[b], cvalid[b])
        bad = idx < 0
        ordered = torch.ones_like(bad)
        if len(idx) > 1:
            ordered[1:] = idx[1:] > idx[:-1]
        out["rows_off"] += int((bad | ~ordered).sum())
        kept = torch.unique(idx[idx >= 0])
        boxes = nms_boxes[b]
        if len(kept) > 1:  # kept pairs that overlap
            r, e = torch.triu_indices(len(kept), len(kept), 1, device=dev)
            iou = _near_iou(boxes, kept[e], kept[r])
            out["overlap"] += int((iou > iou_thres + IOU_SLACK).sum())
        # every valid candidate not kept, while the cap is not reached, is
        # suppressed by an earlier kept one
        is_kept = torch.zeros(len(boxes), dtype=torch.bool, device=dev)
        is_kept[kept] = True
        n_before = torch.cumsum(is_kept.long(), 0) - is_kept.long()
        rest = torch.nonzero(cvalid[b] & ~is_kept
                             & (n_before < max_det)).flatten()
        if len(rest) == 0:
            continue
        if len(kept) == 0:
            out["missed"] += len(rest)
            continue
        rr = rest.repeat_interleave(len(kept))
        ee = kept.repeat(len(rest))
        early = ee < rr
        rr, ee = rr[early], ee[early]
        iou = _near_iou(boxes, rr, ee)
        hit = torch.zeros(len(boxes), dtype=torch.bool, device=dev)
        hit[rr[iou > iou_thres - IOU_SLACK]] = True
        out["missed"] += int((~hit[rest]).sum())
    return out
