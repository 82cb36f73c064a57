"""The full evaluation loop (counterpart of ``ryolo_tpu/eval/evaluator.py``:
``padded_targets_to_rows`` :57, ``_norm_images`` :78, ``_eval_step_fn``
:96-140, ``_pad_batch`` :149, ``evaluate`` :167).

Per batch, on the model's device: the uint8 images go up through pinned
memory and are divided by 255 there, the deploy-fused model runs its
forward with the deferred decode of its head (CSL: rows without theta;
KFIoU and OBB: scores alone), :func:`post_process_defer`,
:func:`post_process_kfiou_defer` or :func:`post_process_obb_defer` selects
and suppresses (on a card one
``nms_mask`` and one ``nms_scan`` launch), and ``loss_fn`` gives the
val-loss items from the fused head maps.  The detections come back
through pinned host buffers without blocking the issuing thread; three
matcher threads each wait for their batch's copy and match it image by
image (the C++ matcher drops the GIL), with at most three batches in
flight.  The loss items stay on the device and are read
once, after the loop.

With a ``mesh`` (data parallelism, JAX ``evaluate(mesh=...)`` :182-223)
each group of the mesh runs its rows of every padded batch, so the batch
size must divide by the number of groups (JAX's ``mesh.shape["dp"]``);
the height is not split (JAX's ``batch_sharding(spatial=False)``
:216-221): the ``sp`` ranks of a group compute the same rows.  The val
loss is the global batch's (the loss function's reducer, over the
groups), the per-image statistics of one rank of each group are gathered
to rank 0 in image order, and rank 0 computes the metrics once and
broadcasts them, so that every rank takes the same ``best.pth`` decision.

The JAX package's jit step cache (``_STEP_CACHE``, ``clear_step_cache``)
has no counterpart: nothing is traced here, so nothing is kept between
calls.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ryolo_tpu_torch.data.loader import load_data
from ryolo_tpu_torch.eval.metrics import (IOU_THRESHOLDS,
                                          calculate_eval_stats,
                                          get_batch_statistics)
from ryolo_tpu_torch.eval.postprocess import (MAX_DET, MAX_NMS,
                                              post_process_defer,
                                              post_process_kfiou_defer,
                                              post_process_obb_defer)
from ryolo_tpu_torch.nn.yolo import STRIDES
from ryolo_tpu_torch.ops.render import to_device
from ryolo_tpu_torch.parallel.mesh import shard_batch
from ryolo_tpu_torch.utils.logger import logger

PIPELINE = 3  # batches in flight, and matcher threads
# uint8 -> float32 / 255 by lookup: the host's IEEE division, exact by
# construction (a card divides by a host scalar as a multiplication by its
# reciprocal, which can land one ulp off)
_DIV255 = np.arange(256, dtype=np.float32) / np.float32(255)


def padded_targets_to_rows(tgt, mask, img_size: int) -> np.ndarray:
    """(B, T, 6) padded targets -> rows ``[idx, cls, x, y, w, h, θ]`` with
    xywh scaled to pixels."""
    tgt = np.asarray(tgt)
    mask = np.asarray(mask)
    rows = []
    for b in range(tgt.shape[0]):
        sel = tgt[b][mask[b]]
        if not len(sel):
            continue
        out = np.zeros((len(sel), 7), np.float32)
        out[:, 0] = b
        out[:, 1] = sel[:, 0]
        out[:, 2:6] = sel[:, 1:5] * img_size
        out[:, 6] = sel[:, 5]
        rows.append(out)
    if not rows:
        return np.zeros((0, 7), np.float32)
    return np.concatenate(rows, 0)


def _pad_batch(arrays: Dict, full: int) -> Dict:
    """Zero-pad a short final batch to ``full`` rows (padded rows have
    all-False target masks and contribute no stats, but the val loss is
    taken over all ``full`` rows, as in the JAX package).  Host arrays and
    device tensors may mix."""
    short = arrays["images"].shape[0]
    if short == full:
        return arrays
    out = {}
    for k, v in arrays.items():
        pad_shape = (full - short,) + tuple(v.shape[1:])
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v.new_zeros(pad_shape)], 0)
        else:
            out[k] = np.concatenate([v, np.zeros(pad_shape, v.dtype)], 0)
    return out


def _norm_images(images: torch.Tensor, div255: torch.Tensor):
    """``(B, S, S, 3)`` RGB on the device -> ``(B, 3, S, S)`` float32; a
    uint8 batch is divided by 255 exactly as the host loader divides."""
    images = images.permute(0, 3, 1, 2).contiguous()
    if images.dtype == torch.uint8:
        return div255[images.long()]
    return images.float()


def upload(arrays: Dict, device: torch.device,
           div255: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A (padded) batch -> device tensors, the images normalized NCHW."""
    out = {k: (v.to(device, non_blocking=True)
               if isinstance(v, torch.Tensor) else to_device(v, device))
           for k, v in arrays.items()}
    out["images"] = _norm_images(out["images"], div255)
    return out


@torch.no_grad()
def eval_step(model, arrays: Dict[str, torch.Tensor],
              loss_fn: Optional[Callable], conf_thres: float,
              iou_thres: float, max_nms: int, max_det: int):
    """One batch on the device: ``(dets (B, max_det, 7), valid (B,
    max_det), loss items)``, nothing read back."""
    dtype = next(model.parameters()).dtype
    outputs, (dec, neck) = model(arrays["images"].to(dtype), decode="defer")
    if model.mode == "csl":
        dets, valid = post_process_defer(
            dec, neck, model.na, model.n_classes, float(conf_thres),
            float(iou_thres), max_nms=max_nms, max_det=max_det)
    elif model.mode == "obb":  # dec: the OBB (conf, cls_id)
        dets, valid = post_process_obb_defer(
            dec, neck, model.n_classes, STRIDES, float(conf_thres),
            float(iou_thres), max_nms=max_nms, max_det=max_det)
    else:  # dec: the KFIoU (conf, cls_id)
        dets, valid = post_process_kfiou_defer(
            dec, neck, model.na, model.anchors, STRIDES, float(conf_thres),
            float(iou_thres), max_nms=max_nms, max_det=max_det)
    items = loss_fn(outputs, arrays)[1] if loss_fn is not None else {}
    return dets, valid, items


def _to_host(dets: torch.Tensor, valid: torch.Tensor):
    """Start the copy of a batch's detections to the host: pinned buffers
    and an event on a card, so the issuing thread does not wait."""
    if dets.device.type == "cpu":
        return dets, valid, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in (dets, valid)]
    for h, t in zip(host, (dets, valid)):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host[0], host[1], event


def _fetch(pending) -> Tuple[np.ndarray, np.ndarray]:
    """Wait for a copy started by :func:`_to_host` (in a matcher thread)."""
    dets, valid, event = pending
    if event is not None:
        event.synchronize()
    return dets.numpy(), valid.numpy()


def evaluate(
    model,
    loss_fn: Optional[Callable],
    data: Dict,
    hyp: Dict,
    csl: bool,
    img_size: int,
    batch_size: int,
    conf_thres: float,
    iou_thres: float,
    max_targets: int = 300,
    max_nms: int = MAX_NMS,
    max_det: int = MAX_DET,
    progress: bool = True,
    mesh=None,
    batches=None,
    device=None,
) -> Tuple[float, float, float, float, Dict[str, float]]:
    """Run the mAP protocol on ``data['val']`` with ``model`` (deploy-fused,
    either head; its weights take the place of the JAX ``variables``
    argument) on ``device`` (default: the model's).  ``batches`` (a list of
    the loader's batch dicts, host arrays or tensors) skips the loader.
    ``mesh`` (a :class:`~ryolo_tpu_torch.parallel.mesh.Mesh`, every rank
    calling): this rank's share of each batch on the mesh's device (module
    docstring).  Returns ``(mp, mr, map50, map50_95, mean loss items)``."""
    if mesh is not None:
        if batch_size % mesh.groups:
            raise ValueError(f"eval batch_size {batch_size} not divisible "
                             f"by mesh size {mesh.groups}")
        device = mesh.device
    main = mesh is None or mesh.is_main
    device = torch.device(device if device is not None
                          else next(model.parameters()).device)
    model = model.to(device)
    if batches is None:
        _, loader = load_data(
            data["val"], data["names"], data["type"], hyp, csl,
            img_size=img_size, batch_size=batch_size, augment=False,
            shuffle=False, max_targets=max_targets, image_uint8=True)
    else:
        loader = batches

    logger.info("Compute mAP...")
    div255 = torch.from_numpy(_DIV255).to(device)
    iouv = IOU_THRESHOLDS
    niou = len(iouv)
    seen = n_batches = 0
    loss_acc = []

    iterator = loader
    if progress and main:
        try:
            import tqdm

            iterator = tqdm.tqdm(loader, total=len(loader))
        except ImportError:
            pass

    def fetch_and_match(pending, tgt, mask, real_b):
        dets, valid = _fetch(pending)
        outputs_list = [dets[b][valid[b]] for b in range(real_b)]
        target_rows = padded_targets_to_rows(tgt, mask, img_size)
        return get_batch_statistics(outputs_list, target_rows, iouv, niou)

    futures = []
    with cf.ThreadPoolExecutor(max_workers=PIPELINE) as matcher:
        for batch in iterator:
            real_b = batch["images"].shape[0]
            seen += real_b
            n_batches += 1
            arrays = _pad_batch({k: v for k, v in batch.items()
                                 if k != "paths"}, batch_size)
            if mesh is not None:  # this group's rows, and its real images
                arrays = shard_batch(arrays, mesh)
                b = batch_size // mesh.groups
                real_b = min(max(real_b - mesh.group * b, 0), b)
            dets, valid, items = eval_step(
                model, upload(arrays, device, div255), loss_fn, conf_thres,
                iou_thres, max_nms, max_det)
            pending = _to_host(dets, valid)
            loss_acc.append(items)
            # targets for the matcher: host arrays, or device ones pulled
            # after the batch is issued
            tgt, mask = (v[:real_b] for v in (arrays["tgt"],
                                              arrays["tgt_mask"]))
            if isinstance(tgt, torch.Tensor):
                tgt, mask = tgt.cpu().numpy(), mask.cpu().numpy()
            futures.append(matcher.submit(fetch_and_match, pending, tgt,
                                          mask, real_b))
            if len(futures) > PIPELINE:  # bound the batches in flight
                futures[-PIPELINE - 1].result()
        per_batch = [f.result() for f in futures]
    if mesh is not None:
        # every rank's statistics to rank 0, batch by batch in rank order:
        # the images' order, one rank of each group
        ranks = [None] * mesh.dp if main else None
        dist.gather_object(per_batch, ranks, dst=0)
        if main:
            ranks = ranks[::mesh.sp]
            per_batch = [[s for r in ranks for s in r[i]]
                         for i in range(n_batches)]
    stats = [s for batch_stats in per_batch for s in batch_stats]

    total_loss_items: Dict[str, float] = {}
    if loss_acc and loss_acc[0]:
        keys = list(loss_acc[0])
        vals = torch.stack([torch.stack([it[k].float() for k in keys])
                            for it in loss_acc]).cpu().tolist()
        for i, k in enumerate(keys):
            total_loss_items[k] = sum(v[i] for v in vals) / n_batches

    metrics = [None]
    if main:
        metrics = [_metrics(stats, data["names"], seen)]
    if mesh is not None:
        dist.broadcast_object_list(metrics, src=0)
    return (*metrics[0], total_loss_items)


def _metrics(stats, names, seen):
    """``(mp, mr, map50, map5095)`` of the per-image statistics, and their
    table in the log."""
    stats_cat = [np.concatenate(x, 0) for x in zip(*stats)] if stats else []
    nt, p, r, ap50, ap, f1, ap_class, mp, mr, map50, map5095 = (
        calculate_eval_stats(stats_cat, len(names)))

    logger.info(("%20s" + "%12s" * 6) % ("Class", "Images", "Labels",
                                         "Precision", "Recall", "mAP@.5",
                                         "mAP@.5:.95"))
    pf = "%20s" + "%12i" * 2 + "%12.3g" * 4
    logger.info(pf % ("all", seen, nt.sum(), mp, mr, map50, map5095))
    for i, c in enumerate(ap_class):
        logger.info(pf % (names[c], seen, nt[c], p[i], r[i], ap50[i], ap[i]))
    return mp, mr, map50, map5095
