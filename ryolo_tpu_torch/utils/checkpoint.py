"""Reference ``.pth`` layout and the JAX-tree -> state_dict bridge.

Port of ``ryolo_tpu/utils/checkpoint.py`` (``state_dict_layout`` :166,
``torch_name_to_flax`` :186, ``import_state_dict`` :260,
``export_state_dict`` :302, ``save_pth`` :330, ``load_pth`` :337,
``save_train_state`` :350, ``load_train_state`` :365).  The port's module
attribute names ARE the reference ``.pth`` names, so a reference
checkpoint, or the JAX weights turned into a state_dict by
:func:`state_dict_from_flax`, load with ``model.load_state_dict(sd,
strict=True)`` and no converter.

The train state (``last.state``, for ``--resume``) has the port's own
format: the JAX package's framing (8-byte little-endian length, JSON meta)
followed by a ``torch.save`` payload instead of flax bytes.
"""

from __future__ import annotations

import collections
import io
import json
from typing import List, Mapping, Tuple

import numpy as np
import torch

# (child, spec) tables in torch registration order; spec 'C' = ConvBlock
# with BN, 'Cb' = biased head conv, 'B' = bare BN, 'W' = bare conv weight,
# 'I' = implicit prior (``ryolo_tpu/utils/checkpoint.py:33-136``).


def _csp(n):
    return [("cv1", "C"), ("cv2", "C"), ("cv3", "C"), ("cv4", "C")] + [
        (f"m.{i}", [("cv1", "C"), ("cv2", "C")]) for i in range(n)]


def _c3(n):
    return [("cv1", "C"), ("cv2", "C"), ("cv3", "C")] + [
        (f"m.{i}", [("cv1", "C"), ("cv2", "C")]) for i in range(n)]


def _convs(n):
    """``cv1`` .. ``cvN``: SPPF (2), C5 (5), SPP (6), SPPCSPC (7)."""
    return [(f"cv{i}", "C") for i in range(1, n + 1)]


def _elan():
    return _convs(7)


def _maxconv():
    return [("cv1", "C"), ("cv2", "C"), ("cv3", "C")]


def _repconv():
    # the v7 neck RepConvs all change width, so no rbr_identity branch
    return [("rbr_dense.0", "W"), ("rbr_dense.1", "B"),
            ("rbr_1x1.0", "W"), ("rbr_1x1.1", "B")]


_BACKBONES = {
    "yolov4": [
        ("cbm0", "C"), ("cbm1", "C"), ("csp1", _csp(1)),
        ("cbm2", "C"), ("csp2", _csp(2)), ("cbm3", "C"), ("csp3", _csp(8)),
        ("cbm4", "C"), ("csp4", _csp(8)), ("cbm5", "C"), ("csp5", _csp(4)),
        ("spp", _convs(6)),
    ],
    "yolov5": [
        ("cbs0", "C"), ("cbs1", "C"), ("csp1", _c3(3)),
        ("cbs2", "C"), ("csp2", _c3(6)), ("cbs3", "C"), ("csp3", _c3(9)),
        ("cbs4", "C"), ("csp4", _c3(3)), ("spp", _convs(2)),
    ],
    "yolov7": [
        ("cbs0", "C"), ("cbs1", "C"), ("cbs2", "C"), ("cbs3", "C"),
        ("elan1", _elan()), ("mc1", _maxconv()), ("elan2", _elan()),
        ("mc2", _maxconv()), ("elan3", _elan()), ("mc3", _maxconv()),
        ("elan4", _elan()), ("spp", _convs(7)),
    ],
}

_NECKS = {
    "yolov4": [
        ("conv7", "C"), ("conv8", "C"), ("conv9", _convs(5)),
        ("conv14", "C"), ("conv15", "C"), ("conv16", _convs(5)),
        ("conv21", "C"), ("conv22", "Cb"), ("conv23", "C"),
        ("conv24", _convs(5)), ("conv29", "C"), ("conv30", "Cb"),
        ("conv31", "C"), ("conv32", _convs(5)), ("conv37", "C"),
        ("conv38", "Cb"),
    ],
    "yolov5": [
        ("conv7", "C"), ("csp1", _c3(3)), ("conv14", "C"), ("csp2", _c3(3)),
        ("conv15", "Cb"), ("conv16", "C"), ("csp3", _c3(3)),
        ("conv17", "Cb"), ("conv18", "C"), ("csp4", _c3(3)),
        ("conv19", "Cb"),
    ],
    "yolov7": [
        ("conv1", "C"), ("elan1", _elan()), ("conv2", "C"), ("elan2", _elan()),
        ("conv3", "C"), ("conv4", "C"),
        ("mc1", _maxconv()), ("elan3", _elan()),
        ("mc2", _maxconv()), ("elan4", _elan()),
        ("repVgg1", _repconv()), ("ia1", "I"), ("conv5", "Cb"), ("im1", "I"),
        ("repVgg2", _repconv()), ("ia2", "I"), ("conv6", "Cb"), ("im2", "I"),
        ("repVgg3", _repconv()), ("ia3", "I"), ("conv7", "Cb"), ("im3", "I"),
    ],
}


def _expand(prefix: str, spec, out: List[Tuple[str, str]]):
    if spec == "C":
        out += [(f"{prefix}.conv.0.weight", "conv_w"),
                (f"{prefix}.conv.1.weight", "bn_w"),
                (f"{prefix}.conv.1.bias", "bn_b"),
                (f"{prefix}.conv.1.running_mean", "bn_m"),
                (f"{prefix}.conv.1.running_var", "bn_v"),
                (f"{prefix}.conv.1.num_batches_tracked", "bn_n")]
    elif spec == "Cb":
        out += [(f"{prefix}.conv.0.weight", "conv_w"),
                (f"{prefix}.conv.0.bias", "conv_b")]
    elif spec == "B":
        out += [(f"{prefix}.weight", "bn_w"), (f"{prefix}.bias", "bn_b"),
                (f"{prefix}.running_mean", "bn_m"),
                (f"{prefix}.running_var", "bn_v"),
                (f"{prefix}.num_batches_tracked", "bn_n")]
    elif spec == "W":
        out.append((f"{prefix}.weight", "conv_w"))
    elif spec == "I":
        out.append((f"{prefix}.implicit", "implicit"))
    else:
        for child, sub in spec:
            _expand(f"{prefix}.{child}", sub, out)


def state_dict_layout(ver: str) -> List[Tuple[str, str]]:
    """Ordered reference state_dict entries ``(name, kind)`` for ``ver``."""
    out: List[Tuple[str, str]] = []
    for name, spec in _BACKBONES[ver]:
        _expand(f"backbone.{name}", spec, out)
    for name, spec in _NECKS[ver]:
        _expand(f"neck.{name}", spec, out)
    return out


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def torch_name_to_flax(name: str):
    """Map a state_dict name to ``(collection, path, transform)`` of the
    JAX tree; ``collection`` None means no JAX counterpart
    (``num_batches_tracked``), ``transform`` is 'conv', 'implicit' or None.
    The bottleneck lists' ``m.K`` are the JAX tree's ``m_K``.
    """
    parts = []
    for p in name.split("."):
        if p.isdigit() and parts and parts[-1] == "m":
            parts[-1] = f"m_{p}"
        else:
            parts.append(p)
    tail = parts[-1]
    if tail == "num_batches_tracked":
        return None, (), None
    if tail == "implicit":
        return "params", tuple(parts[:-1]) + ("implicit",), "implicit"
    if len(parts) >= 3 and parts[-3] in ("rbr_dense", "rbr_1x1"):
        base = tuple(parts[:-3])
        branch = "dense" if parts[-3] == "rbr_dense" else "px"
        if parts[-2] == "0":
            return "params", base + (f"{branch}_conv", "kernel"), "conv"
        coll, leaf = _BN_LEAVES[tail]
        return coll, base + (f"{branch}_bn", leaf), None
    if len(parts) >= 3 and parts[-3] == "conv" and parts[-2] in ("0", "1"):
        base = tuple(parts[:-3])
        if parts[-2] == "0":
            if tail == "weight":
                return "params", base + ("conv", "kernel"), "conv"
            return "params", base + ("conv", "bias"), None
        coll, leaf = _BN_LEAVES[tail]
        return coll, base + ("bn", leaf), None
    raise KeyError(f"Unrecognized reference state_dict entry: {name}")


def _tree_get(tree: Mapping, path):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_flax(variables: Mapping, ver: str):
    """JAX variables (nested dicts of numpy arrays) -> reference-ordered
    state_dict: HWIO kernels become OIHW, ``(1,1,1,C)`` implicit priors
    become ``(1,C,1,1)``, and ``num_batches_tracked`` is zero."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = collections.OrderedDict()
    for name, kind in state_dict_layout(ver):
        if kind == "bn_n":
            out[name] = torch.zeros((), dtype=torch.long)
            continue
        coll, path, transform = torch_name_to_flax(name)
        arr = np.asarray(_tree_get(params if coll == "params" else stats,
                                   path))
        if transform == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        elif transform == "implicit":
            arr = arr.transpose(0, 3, 1, 2)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_pth(path: str):
    """A reference-format state_dict, on the CPU (tensors only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_pth(model: torch.nn.Module, path: str):
    """Write ``model``'s weights as a reference-format ``.pth``: the
    state_dict in :func:`state_dict_layout` order, CPU tensors."""
    sd = model.state_dict()
    torch.save(collections.OrderedDict(
        (name, sd[name].detach().cpu())
        for name, _ in state_dict_layout(model.ver)), path)


def import_state_dict(model: torch.nn.Module, state_dict: Mapping,
                      max_entries: int = -1) -> int:
    """Copy the first ``max_entries`` entries of a reference-ordered
    state_dict into ``model`` (-1: all), as ``--weights_path`` does with
    552 (the backbone+neck fine-tune filter, ``train.py:112-117``).  Raises
    on a name the model lacks or a shape mismatch; ``num_batches_tracked``
    entries are skipped and not counted, as the JAX package has none.
    Returns the number of tensors loaded."""
    own = model.state_dict()
    loaded = 0
    with torch.no_grad():
        for i, (name, tensor) in enumerate(state_dict.items()):
            if 0 <= max_entries <= i:
                break
            if name.endswith("num_batches_tracked"):
                continue
            if name not in own:
                raise KeyError(f"{name} not found in the model")
            cur = own[name]
            if tuple(cur.shape) != tuple(tensor.shape):
                raise ValueError(f"shape mismatch for {name}: ckpt "
                                 f"{tuple(tensor.shape)} vs model "
                                 f"{tuple(cur.shape)}")
            cur.copy_(tensor)
            loaded += 1
    return loaded


def save_train_state(trainer, meta: dict, path: str):
    """The whole training state of ``trainer``
    (:class:`ryolo_tpu_torch.train.Trainer`): model state_dict, optimizer
    state (momentum buffers), the accumulation count and the gradients it
    has summed so far, after the JSON ``meta`` (epoch, best_fitness)."""
    grads = {name: p.grad.detach().cpu()
             for name, p in trainer.model.named_parameters()
             if p.grad is not None}
    blob = io.BytesIO()
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "accum_count": trainer.accum_count, "grads": grads}, blob)
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob.getvalue())


def load_train_state(trainer, path: str) -> dict:
    """Restore what :func:`save_train_state` wrote into ``trainer`` (built
    as at a cold start); returns the meta dict."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    dev = next(trainer.model.parameters()).device
    state = torch.load(io.BytesIO(blob), map_location=dev, weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.accum_count = state["accum_count"]
    for name, p in trainer.model.named_parameters():
        p.grad = state["grads"].get(name)
    return meta
