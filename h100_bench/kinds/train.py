"""Training: the port's ``Trainer.train_step_rendered`` in a closed loop
fed by its spec loader with the tile bank on the card.

Set-up writes the synthetic split, builds the model from the seed, the
loader, the bank and the trainer, and drives that trainer through its
first ``check_steps`` steps on the loader's batches (cuDNN's search runs in
the first); the window then goes on with the same objects.  The reference
follows those first steps from the same initial weights, spec batches and
image files (its own bank and render), and the run compares the steps'
losses, the first gradient (the optimizer's momentum after step 1) and the
change of the parameters after the last check step, leaf by leaf
(:func:`_checks`).  The spec batches' targets, which both sides take, are
held by themselves to the annotation files that the batches' own geometry
places (``targets_off``, exact).
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
import time

import numpy as np

from h100_bench import harness, peaks, roofline, synth
from h100_bench.reference import compare, labels
from h100_bench.reference.bank import tile_bank

def _copy_batch(batch) -> dict:
    return {k: np.array(v) for k, v in batch.items() if k != "paths"}


def _batches(loader, epochs):
    """The loader's batches, epoch after epoch (a new shuffle each);
    ``epochs[0]`` counts the epochs begun."""
    while True:
        loader.set_epoch(epochs[0])
        epochs[0] += 1
        yield from loader


def _plant(trainer, fault, batch_size):
    """Break the timed step for a fault run: ``unchanged`` (the update is
    skipped), ``half_batch`` (the loss is the mean over the first half of
    the batch)."""
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        step = trainer.train_step
        half = batch_size // 2

        def half_step(batch, lr, accumulate):
            return step({k: v[:half] for k, v in batch.items()}, lr,
                        accumulate)
        trainer.train_step = half_step
    elif fault is not None:
        raise ValueError(f"no fault {fault!r} for training")


def run(ctx) -> dict:
    torch = ctx.torch
    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = dev.type == "cuda"
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer
    from ryolo_tpu_torch.utils.device import DTYPES, set_float32_math

    steps = {}
    t = time.perf_counter()
    if cuda:
        from ryolo_tpu_torch.ops import _build
        _build.build(["render"])
    steps["nvcc build (render.cu), or the built library found"] = \
        time.perf_counter() - t

    bs, size, nc = traffic["batch"], cfg["img_size"], cfg["nc"]
    tmp = tempfile.mkdtemp(prefix="h100_bench-")
    try:
        t = time.perf_counter()
        split = os.path.join(tmp, "train")
        synth.write_dota_split(split, cfg["names"],
                               np.random.default_rng([ctx.seed, 0]),
                               cfg["distinct_images"], cfg["source_px"], nc,
                               entries=cfg["train_images"])
        steps["write the synthetic split"] = time.perf_counter() - t

        t = time.perf_counter()
        ref = compare.build_model(cfg, dev, train=True)
        synth.seeded_weights(ref, ctx.seed, cfg["weights"], dev)
        state0 = {k: v.detach().clone() for k, v in ref.state_dict().items()}
        del ref
        with torch.device(dev):
            model = Yolo(nc, cfg["model"], mode=cfg["mode"], ver=cfg["ver"])
        model.load_state_dict(state0, strict=True)
        if cuda:
            set_float32_math(dev)
            torch.backends.cudnn.benchmark = True  # fixed shapes, as the CLI
        if ctx.control:  # the precision below float32: TF32 convs, matmuls
            compare.float32_math(tf32=True)
        steps["weights from the seed, the port's model"] = \
            time.perf_counter() - t

        t = time.perf_counter()
        dataset, loader = load_data(
            split, cfg["names"], "DOTA", cfg["hyp"], cfg["mode"] == "csl",
            img_size=size, batch_size=bs, augment=True, shuffle=True,
            drop_last=True, seed=traffic["loader_seed"],
            workers=traffic["workers"],
            device_augment=True, cache_images=True, device_cache=True)
        bank = torch.from_numpy(dataset.build_tile_bank()).to(dev)
        steps["tile bank: decode, pack and upload"] = time.perf_counter() - t

        trainer = Trainer(model, LOSS_FNS[cfg["mode"]](model.anchors, nc,
                                                       cfg["hyp"], dev),
                          cfg["optimizer"], cfg["lr"], DTYPES[cfg["dtype"]])
        _plant(trainer, ctx.fault, bs)
        lr, method = cfg["lr"], traffic["render"]
        names = [k for k, _ in model.named_parameters()]

        def step(batch):
            return trainer.train_step_rendered(batch, bank, lr, 1, bs,
                                               method=method)

        epochs = [0]
        it = _batches(loader, epochs)
        check_batches, check_losses = [], []
        grad1 = params_after = None
        for i in range(traffic["check_steps"]):
            t = time.perf_counter()
            batch = next(it)
            check_batches.append(_copy_batch(batch))
            loss, _ = step(batch)
            check_losses.append(loss)
            if i == 0:
                opt_state = trainer.optimizer.state
                grad1 = {k: opt_state[p]["momentum_buffer"].to("cpu", copy=True)
                         if "momentum_buffer" in opt_state.get(p, {})
                         else torch.zeros(p.shape)
                         for k, p in model.named_parameters()}
            if cuda:
                torch.cuda.synchronize(dev)
            steps[f"check step {i + 1}"
                  + (" (cuDNN's search)" if i == 0 else "")] = \
                time.perf_counter() - t
        params_after = {k: p.detach().to("cpu", copy=True)
                        for k, p in model.named_parameters()}
        check_losses = [float(v) for v in check_losses]

        for k, v in steps.items():
            harness.log(f"set-up: {k} {v:.3f} s")
        # the window
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_end = time.perf_counter()
        epoch0 = epochs[0]
        waits, spans, losses = [], [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            a = time.perf_counter()
            batch = next(it)
            waits.append(time.perf_counter() - a)
            if cuda:
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
            else:
                s = time.perf_counter()
            loss, _ = step(batch)
            if cuda:
                e.record()
                spans.append((s, e))
            else:
                spans.append(time.perf_counter() - s)
            losses.append(loss)
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        restarts = epochs[0] - epoch0
        n_steps = len(losses)
        step_ms = [s.elapsed_time(e) for s, e in spans] if cuda \
            else [v * 1e3 for v in spans]
        finite = torch.isfinite(torch.stack(losses).float()).cpu()
        failed = int((~finite).sum())
        device = harness.device_entry(torch, dev, 1)

        record = {"kind": "train", "window_s": window_s, "steps": n_steps,
                  "images": n_steps * bs, "loader_wait_s": waits,
                  "step_ms": step_ms,
                  "step_flops": 3.0 * ctx.forward_flops(cfg, bs, size),
                  "peak_flops": peaks.FLOPS[str(DTYPES[cfg["dtype"]])
                                            .replace("torch.", "")]}
        trace = None
        if ctx.trace:
            trace, record["render_bound_s"], record["render_s"] = \
                _traced(ctx, it, step, traffic["trace_steps"], size, bs)
            record["trace"] = trace
        harness.log(f"window: {n_steps} steps in {window_s:.3f} s "
                    f"({len(loader)} steps an epoch, {restarts} epoch "
                    f"restarts in the window), last "
                    f"loss {float(losses[-1]):.6g}, {failed} not finite; "
                    f"peak memory {device['memory_peak_bytes']} B; "
                    f"{harness.smi()}")
        _log_launches()
        it.close()  # ends the loader's prefetch threads
        e2e = {"train_img_s": n_steps * bs / window_s}

        del trainer, model, bank, loader, dataset, it, batch, losses, loss
        if cuda:
            torch.cuda.empty_cache()
        ctx.after_window()

        # the reference's steps, from the same weights, batches and files
        t = time.perf_counter()
        compare.float32_math(tf32=False)
        if cuda:
            torch.backends.cudnn.benchmark = False
        files = sorted(glob.glob(os.path.join(split, "images", "*.png")))
        # the loader's label stage by itself: the check steps' targets
        # against the annotations that their own geometry places
        ann = labels.Annotations(files, cfg["names"], size)
        target_faults = {}
        for b in check_batches:
            if "spec_tile_idx" not in b:
                continue  # a pixel-spec fallback batch: no bank geometry
            for k, v in labels.target_faults(b, ann, size).items():
                target_faults[k] = target_faults.get(k, 0) + v
        # the bank's rows that the check steps read, renumbered in order
        rows = np.unique(np.concatenate([b["spec_tile_idx"].ravel() for b in
                                         check_batches
                                         if "spec_tile_idx" in b] + [[0]]))
        ref_bank = torch.from_numpy(tile_bank(files, size, rows)).to(dev)
        check_batches = [{**b, "spec_tile_idx": np.searchsorted(
            rows, b["spec_tile_idx"]).astype(b["spec_tile_idx"].dtype)}
            if "spec_tile_idx" in b else b for b in check_batches]
        want = compare.train_steps(cfg, state0, check_batches, ref_bank, lr,
                                   bs, dev)
        checks = _checks(cfg, check_losses, grad1, params_after, state0,
                         want, names)
        checks["targets_off"] = {"value": sum(target_faults.values()),
                                 "limit": cfg["limits"]["targets_off"]}
        if ctx.witness:
            # the reference against itself with cuDNN's other algorithms:
            # how far float32 summation order alone moves these numbers
            torch.backends.cudnn.benchmark = True
            again = compare.train_steps(cfg, state0, check_batches, ref_bank,
                                        lr, bs, dev)
            _checks(cfg, again["losses"], again["grad1"], again["params"],
                    state0, want, names, "witness (reference, cuDNN search "
                    "on) against the reference")
        harness.log(f"reference: {time.perf_counter() - t:.3f} s; losses "
                    f"port {check_losses} reference {want['losses']}; "
                    f"targets {target_faults}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"setup_end": setup_end, "e2e": e2e, "record": record,
            "attempted": n_steps, "failed": failed, "checks": checks,
            "trace": trace, "device": device}


def _checks(cfg, losses, grad1, params_after, state0, want, names,
            label="port against the reference"):
    """The compared numbers.  The loss is compared over the first two
    steps and the change by its median leaf: the third step's loss and the
    worst leaf's change swing with float32 summation order alone (the
    reference against itself with cuDNN's other algorithms reads as
    much), so they are printed; the worst leaf's change is compared too,
    against a leaf left unmoved or moved twice (1)."""
    limits = cfg["limits"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
    g_want = compare.leaf_norms({k: want["grad1"][k] for k in names})
    g_got = compare.leaf_norms({k: grad1[k] for k in names})
    grad_gap, grad_leaf = compare.leaf_gap(g_got, g_want)
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone: left out of the change
    med = float(np.median(list(g_want.values())))
    moved = [k for k in names if g_want[k] >= 1e-3 * med]
    start = {k: state0[k].detach().cpu() for k in names}
    c_want = compare.leaf_norms({k: want["params"][k] - start[k]
                                 for k in moved})
    c_got = compare.leaf_norms({k: params_after[k] - start[k]
                                for k in moved})
    change_gap, change_leaf = compare.leaf_gap(c_got, c_want)
    med_change = compare.median_leaf_gap(c_got, c_want)
    harness.log(f"{label}: loss gaps by step {gaps}; worst leaves: "
                f"gradient {grad_leaf} {grad_gap!r}, change {change_leaf} "
                f"{change_gap!r}; median leaf's change gap {med_change!r}; "
                f"{len(names) - len(moved)} leaves left out of the change")

    def check(name, value):
        return {"value": value, "limit": limits[name]}
    return {"loss_gap": check("loss_gap", max(gaps[:2])),
            "grad_gap": check("grad_gap", grad_gap),
            "change_gap": check("change_gap", med_change),
            "change_worst_leaf": check("change_worst_leaf", change_gap)}


def _traced(ctx, it, step, n, size, bs):
    """``n`` more steps under the profiler, after the window: the trace,
    and the render's least time against its kernel time."""
    torch, dev = ctx.torch, ctx.device
    cuda = dev.type == "cuda"
    batches = []
    if cuda:
        torch.cuda.synchronize(dev)
    with harness.Trace(torch, dev) as tr:
        t0 = time.perf_counter()
        for _ in range(n):
            with torch.profiler.record_function("loader.next"):
                batch = next(it)
            batches.append(batch)
            with torch.profiler.record_function("train_step"):
                step(batch)
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    red = tr.reduce(window_s)
    bound = 0.0
    for b in batches:
        if "spec_tile_idx" not in b:
            continue  # a pixel-spec fallback batch: not the bank's kernel
        spec = {k: b["spec_" + k] for k in ("region", "offset", "hsv",
                                            "minv", "mix_idx")}
        bound += roofline.render_bound(size, b["spec_tile_idx"], spec, bs,
                                       dev)
    render_s = sum(tr.kernels("render_kernel"))
    harness.log(f"traced {n} steps in {window_s:.3f} s: busy "
                f"{red['busy_s']:.4f} s; render kernel {render_s:.6f} s over "
                f"{len(tr.kernels('render_kernel'))} launches, least time "
                f"{bound:.6f} s")
    return red, (bound if render_s > 0 else None), render_s


def _log_launches():
    from ryolo_tpu_torch.ops import cuda_render, cuda_warp
    harness.log(f"launches: {dict(cuda_render.LAUNCHES)} "
                f"{dict(cuda_warp.LAUNCHES)}")
