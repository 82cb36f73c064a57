"""Where a two-rank ``--dp`` gradient parts from a one-rank one, on the card.

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_dp_grad_probe.py

``chip_smoke.py`` phase 17 holds the first update of two gloo ranks sharing
``cuda:0`` against one rank's on the same global batch (v7-CSL, 800 px,
batch 8, ``weights_init_normal`` weights from a fixed seed).  This script
takes that batch apart: the phase-17 loaders' global batch in the
unsharded order and as the two ranks' halves put end to end (the same
images, checked bit for bit, in another order), and each parameter's
gradient after the all-reduce and before SGD in

* ``plain``: the plain model (native BatchNorm), one process;
* ``plain again``: the same, run a second time (the card's run-to-run
  spread, ``cudnn.benchmark`` on as in phase 17);
* ``plain, rank order``: the plain model on the batch in the ranks' order;
* ``world 1``: one rank of a world-1 NCCL group (synced BatchNorm, global
  loss counts, the gradient all-reduce), unsharded order and rank order;
* ``2 ranks``: two gloo ranks on ``cuda:0``, each on its half.

For each pair it prints the relative L2 distance over all gradients, the
worst tensor's, and the first parameters in backward order (the order in
which autograd wrote them) whose gradient parts by more than 1e-6, 1e-4
and 1e-2.  What the first update's distance tells apart: a fault of the
two-rank path shows as a distance between ``world 1, rank order`` and
``2 ranks`` that the summation order alone (``plain`` against ``plain,
rank order``) does not give.
"""

import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for p in (REPO, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import chip_smoke as cs  # noqa: E402

THRESHOLDS = (1e-6, 1e-4, 1e-2)


def loaders(split, names, cfg, dev):
    """The global batch of phase 17: the unsharded loader's first batch of
    8 and the two ranks' first batches of 4, rendered on ``dev`` (the
    tile bank built once), as dicts of device tensors with ``paths``."""
    from ryolo_tpu_torch.data.device_augment import render_batch, to_device
    from ryolo_tpu_torch.data.loader import load_data

    out, bank, first = [], None, None
    for shard, b in (((0, 1), cs.BATCH), ((0, 2), cs.BATCH // 2),
                     ((1, 2), cs.BATCH // 2)):
        dataset, loader = load_data(
            split, names, "DOTA", cfg["hyp"], True, img_size=cs.IMG,
            batch_size=b, augment=True, shuffle=True, drop_last=True,
            seed=cs.SEED, workers=4, shard=shard, device_augment=True,
            cache_images=True, device_cache=True)
        if first is None:
            first = dataset
            bank = torch.from_numpy(dataset.build_tile_bank()).to(dev)
        else:  # the same split: its bank's sizes, no second decode
            dataset._bank_sizes = first._bank_sizes
        spec = next(iter(loader))
        batch = {"images": render_batch(spec, b, bank=bank, device=dev),
                 "paths": list(spec["paths"])}
        for k in ("tgt", "tgt_csl", "tgt_mask"):
            batch[k] = to_device(spec[k], dev)
        out.append(batch)
    return out


def rank_order(a, halves):
    """The two halves end to end, each image checked bit-equal to the
    unsharded batch's image of the same path."""
    cat = {k: (sum((h[k] for h in halves), []) if k == "paths"
               else torch.cat([h[k] for h in halves]))
           for k in a}
    idx = [a["paths"].index(p) for p in cat["paths"]]
    same = all(torch.equal(cat[k], a[k][idx])
               for k in ("images", "tgt", "tgt_csl", "tgt_mask"))
    return cat, idx, same


def grads(model, loss_fn, batch, mesh=None, order=None):
    """Each parameter's gradient of one forward and backward in train
    mode (summed over the ranks under ``mesh``), on the host; ``order``
    (a list) receives the parameters' names in the order autograd wrote
    them."""
    from ryolo_tpu_torch.parallel import all_reduce_grads

    model.train()
    model.zero_grad(set_to_none=True)
    hooks = []
    if order is not None:
        for n, p in model.named_parameters():
            hooks.append(p.register_post_accumulate_grad_hook(
                lambda _p, n=n: order.append(n)))
    loss, _ = loss_fn(model(batch["images"]), batch)
    loss.backward()
    for h in hooks:
        h.remove()
    if mesh is not None:
        all_reduce_grads(model.parameters(), mesh)
    return {n: p.grad.detach().double().cpu().clone()
            for n, p in model.named_parameters()}


def compare(name, got, want, order):
    """One line: the relative L2 distance over all gradients, the worst
    tensor's, and the first parameter in backward order past each of
    ``THRESHOLDS``."""
    rel = {k: ((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
           for k, w in want.items()}
    total = (torch.cat([(got[k] - want[k]).reshape(-1) for k in order]).norm()
             / torch.cat([want[k].reshape(-1) for k in order]).norm()).item()
    worst = max(rel, key=rel.get)
    firsts = []
    for t in THRESHOLDS:
        i = next((i for i, k in enumerate(order) if rel[k] > t), None)
        name = "none" if i is None else f"#{i} {order[i]}"
        firsts.append(f"> {t:g}: {name}"
                      + ("" if i is None else f" ({rel[order[i]]:.2e})"))
    deciles = [rel[order[min(len(order) - 1, int(q * len(order)))]]
               for q in np.linspace(0, 1, 11)]
    return (f"{name}: all {total:.3e}, worst {rel[worst]:.3e} ({worst}); "
            f"first in backward order {'; '.join(firsts)}; at backward-order "
            "deciles " + " ".join(f"{d:.1e}" for d in deciles))


def rank_body(out, split, names, cfg):
    """One of the two gloo ranks: its half's gradient summed over both."""
    from ryolo_tpu_torch.parallel import (convert_sync_bn, current_mesh,
                                          replicate)
    from ryolo_tpu_torch.train import LOSS_FNS
    from ryolo_tpu_torch.utils.device import set_float32_math

    mesh = current_mesh()
    set_float32_math(mesh.device)
    torch.backends.cudnn.benchmark = True
    half = loaders(split, names, cfg, mesh.device)[1 + mesh.rank]
    model = replicate(convert_sync_bn(cs.seeded_model(cfg, mesh.device)),
                      mesh)
    loss_fn = LOSS_FNS["csl"](model.anchors, cs.NC, cfg["hyp"], mesh.device,
                              reducer=mesh)
    g = grads(model, loss_fn, half, mesh)
    if mesh.rank == 0:
        torch.save(g, os.path.join(out, "ranks.pt"))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from ryolo_tpu_torch.parallel import (close_mesh, convert_sync_bn, launch,
                                          make_mesh, replicate)
    from ryolo_tpu_torch.parallel.mesh import free_port
    from ryolo_tpu_torch.train import LOSS_FNS
    from ryolo_tpu_torch.utils.config import load_yaml
    from ryolo_tpu_torch.utils.device import set_float32_math

    dev = torch.device("cuda:0")
    set_float32_math(dev)
    torch.backends.cudnn.benchmark = True
    cfg = load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))
    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    with tempfile.TemporaryDirectory() as tmp:
        split = os.path.join(tmp, "dota_train")
        cs.write_dota_split(split, names, np.random.default_rng(cs.SEED + 2))
        a, h0, h1 = loaders(split, names, cfg, dev)
        cat, idx, same = rank_order(a, [h0, h1])
        print(f"rank order as unsharded indices {idx}; images and targets "
            f"bit-equal by path: {same}")
        runs, order = {}, []

        def plain(batch, key, **kw):
            model = cs.seeded_model(cfg, dev)
            loss_fn = LOSS_FNS["csl"](model.anchors, cs.NC, cfg["hyp"], dev)
            runs[key] = grads(model, loss_fn, batch, **kw)

        plain(a, "plain", order=order)
        plain(a, "plain again")
        plain(cat, "plain, rank order")
        mesh = make_mesh(1, device="cuda:0", backend="nccl",
                         init_method=f"tcp://localhost:{free_port()}", rank=0)
        try:
            for batch, key in ((a, "world 1"), (cat, "world 1, rank order")):
                model = replicate(convert_sync_bn(cs.seeded_model(cfg, dev)),
                                  mesh)
                loss_fn = LOSS_FNS["csl"](model.anchors, cs.NC, cfg["hyp"],
                                          dev, reducer=mesh)
                runs[key] = grads(model, loss_fn, batch, mesh)
        finally:
            close_mesh()
        del a, h0, h1, cat
        torch.cuda.empty_cache()
        launch("torch_dp_grad_probe:rank_body", 2, (tmp, split, names, cfg),
               device="cuda:0", backend="gloo")
        runs["2 ranks"] = torch.load(os.path.join(tmp, "ranks.pt"))
    for got, want in (("plain again", "plain"), ("plain, rank order", "plain"),
                      ("world 1", "plain"), ("world 1, rank order", "world 1"),
                      ("2 ranks", "world 1"),
                      ("2 ranks", "world 1, rank order"),
                      ("world 1, rank order", "plain, rank order")):
        print(compare(f"{got} against {want}", runs[got], runs[want], order))
    return 0


if __name__ == "__main__":
    sys.exit(main())
