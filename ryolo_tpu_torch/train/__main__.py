"""Training CLI: ``python -m ryolo_tpu_torch.train``.

Port of the JAX ``train.py`` (``Train`` :54-343, ``build_parser`` :346)
with the same arguments plus ``--device`` (default ``cuda``; the CPU only
when asked, and no fallback when no card is found).  Per epoch: the
warm-up of the learning rate and of the accumulation, then the cosine
one-cycle, exactly as :79-342 computes them; steps through
:class:`ryolo_tpu_torch.train.Trainer` (``train_step_rendered`` with
``--device_augment``, one launch of the tap renderer per step on a card);
then the mAP of the deploy-fused model on the val split, and
``best.pth``, ``last.pth`` (reference format) and ``last.state`` (the
port's own format, for ``--resume``) under ``weights/<model_name>/``.

Every ``--ver`` (yolov4, yolov5, yolov7) runs with either head, ``--mode
csl`` or ``kfiou`` (the loss, anchors and loader targets by mode, as the
JAX ``train.py`` picks them, :40-52 and :119-126); ``--ver yolo11 --mode
obb`` is refused: its loss is not ported.  ``--dtype bf16``
trains with a bf16 forward and float32 parameters, gradients, optimizer,
BatchNorm statistics and loss (JAX :96-103; :class:`Trainer`), and its
per-epoch eval fuses in bf16, as the JAX clone of the bf16 model does
(:304); ``.pth``, ``last.state`` and ``--resume`` stay float32.

``--dp N`` trains data-parallel over N ranks at the global batch
``--batch_size`` (which N must divide), computing what one process
computes at that batch (:mod:`ryolo_tpu_torch.parallel`): launched as one
command it spawns the N ranks itself; under ``torchrun --nproc_per_node N``
each rank joins from the environment.  Rank r runs on ``cuda:LOCAL_RANK``
(NCCL), or on the CPU with ``--device cpu`` (gloo); it loads its strided
share of each epoch at B/N a batch, keeps the whole train split's tile
bank, renders its share (one launch a step on a card) and runs its rows
of each padded eval batch.  Rank 0 alone logs, writes TensorBoard,
``.pth`` and ``last.state``; every rank reads ``--resume``.

``--sp S`` (with ``--dp N`` above 1, which ``S`` must divide, as JAX's
``make_mesh`` asserts) splits each image's height over ``S`` of the ``N``
ranks (:mod:`ryolo_tpu_torch.parallel.spatial`): the batch splits over
the ``N / S`` groups, each rank loads its group's share (``shard=(group,
N / S)``; a group's ranks load the same batches), renders the group's
images (one launch a step on a card) and runs its rows, with a halo
exchange before every conv and pool that crosses the split.  The per-epoch
eval splits the batch over the groups and not the height, as JAX's does.
With ``--dp 1`` no mesh is built and ``--sp`` is ignored, as in JAX.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

import numpy as np
import torch

from ryolo_tpu_torch.data.loader import load_data
from ryolo_tpu_torch.eval.evaluator import evaluate
from ryolo_tpu_torch.nn import Yolo, fuse_for_inference
from ryolo_tpu_torch.ops.render import to_device
from ryolo_tpu_torch.parallel import (convert_sync_bn, current_mesh, launch,
                                     make_mesh, replicate)
from ryolo_tpu_torch.train.trainer import (LOSS_FNS, Trainer, fitness,
                                           one_cycle, weights_init_normal)
from ryolo_tpu_torch.utils.checkpoint import (import_state_dict,
                                              load_pth, load_train_state,
                                              save_pth, save_train_state)
from ryolo_tpu_torch.utils.config import load_yaml, save_opts
from ryolo_tpu_torch.utils.device import (DTYPES, resolve_device,
                                          set_float32_math)
from ryolo_tpu_torch.utils.logger import Logger, logger

NBS = 64  # nominal batch size
PRETRAINED_ENTRIES = 552  # --weights_path: the backbone+neck entries


def warmup(global_step: int, nw: int, batch_size: int, lr_epoch: float):
    """``(accumulate, lr)`` of a warm-up step: both ramp linearly over the
    first ``nw`` steps (``train.py:210-219``)."""
    xi = [0, nw]
    acc = max(1, int(np.interp(global_step, xi,
                               [1, NBS / batch_size]).round()))
    return acc, float(np.interp(global_step, xi, [0.0, lr_epoch]))


class Train:
    def __init__(self, args):
        self.args = args
        self.model_path = os.path.join("weights", args.model_name)

    def check_model_path(self):
        """Interactive overwrite prompt, skipped by ``--yes``."""
        if os.path.exists(self.model_path):
            if self.args.yes:
                shutil.rmtree(self.model_path)
            else:
                while True:
                    logger.warning("Model name exists, do you want to "
                                   "override the previous model?")
                    inp = input(">> [Y:N]")
                    if inp and inp.lower()[0] == "y":
                        shutil.rmtree(self.model_path)
                        break
                    if inp and inp.lower()[0] == "n":
                        logger.info("Stop training!")
                        sys.exit(0)
        os.makedirs(self.model_path)
        os.makedirs(os.path.join(self.model_path, "logs"))

    def _check_options(self):
        args = self.args
        if args.mode == "obb" or args.ver == "yolo11":
            raise ValueError(
                f"--ver {args.ver} --mode {args.mode}: training YOLO11's OBB "
                "head is not supported yet (its loss, task-aligned "
                "assignment with ProbIoU and the DFL loss, is not ported); "
                "detect and test run it")
        if args.dp > 1:
            if args.sp < 1 or args.dp % args.sp:
                raise ValueError(f"--dp {args.dp} not divisible by --sp "
                                 f"{args.sp}")
            if torch.device(args.device).index is not None:
                raise ValueError(
                    f"--device {args.device} with --dp {args.dp}: rank r "
                    "runs on cuda:LOCAL_RANK, pass --device cuda")
            if args.batch_size % args.dp:
                logger.error("--dp must divide --batch_size")
                sys.exit(1)

    def _mesh(self):
        """This rank's mesh under ``--dp`` above 1 (joined by the launcher,
        or from ``torchrun``'s environment), else ``None``."""
        args = self.args
        if args.dp == 1:
            return None
        mesh = current_mesh() or make_mesh(args.dp, args.sp,
                                           device=args.device)
        if (mesh.dp, mesh.sp) != (args.dp, args.sp):
            raise ValueError(f"--dp {args.dp} --sp {args.sp} in a group of "
                             f"{mesh.dp} ranks, sp {mesh.sp}")
        return mesh

    def train(self):
        args = self.args
        self._check_options()
        if (args.dp > 1 and current_mesh() is None
                and "RANK" not in os.environ):
            # one command trains as JAX's does: spawn the ranks here
            launch("ryolo_tpu_torch.train.__main__:_train_rank",
                   args.dp, (args,), device=args.device, sp=args.sp)
            return
        mesh = self._mesh()
        main = mesh is None or mesh.is_main
        device = mesh.device if mesh is not None else resolve_device(
            args.device)
        if not main:
            logger.setLevel(logging.WARNING)
        data = load_yaml(args.data)
        config = load_yaml(args.config)
        model_cfg, hyp_cfg = config["model"], config["hyp"]
        nc = len(data["names"])

        if args.resume:
            if not os.path.isdir(self.model_path):
                logger.error(f"--resume: no run directory {self.model_path}")
                sys.exit(1)
        elif main:
            self.check_model_path()
        tb = None
        if main:
            save_opts(self.model_path, args, config)
            tb = Logger(os.path.join(self.model_path, "logs"))
        if mesh is not None:
            mesh.barrier()

        with torch.random.fork_rng():
            # what weights_init_normal leaves (the implicit priors) is drawn
            # from a fixed seed too, as JAX's model.init(PRNGKey(42))
            torch.manual_seed(42)
            model = Yolo(nc, model_cfg, mode=args.mode, ver=args.ver)
        weights_init_normal(model, torch.Generator().manual_seed(0))
        if args.weights_path:
            logger.info(f"Loading pretrained weights from: {args.weights_path}")
            n = import_state_dict(model, load_pth(args.weights_path),
                                  max_entries=PRETRAINED_ENTRIES)
            logger.info(f"Loaded {n} tensors")
        model.to(device)
        if mesh is not None:
            replicate(convert_sync_bn(model), mesh)
        set_float32_math(device)
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # fixed shapes
        loss_fn = LOSS_FNS[args.mode](model.anchors, nc, hyp_cfg, device,
                                      reducer=mesh)
        csl = args.mode == "csl"

        # under --dp each group loads its strided share at B / groups a
        # batch (under --sp a group's ranks the same)
        groups = 1 if mesh is None else mesh.groups
        train_dataset, train_loader = load_data(
            data["train"], data["names"], data["type"], hyp_cfg, csl,
            img_size=args.img_size, batch_size=args.batch_size // groups,
            augment=True, shuffle=True, max_targets=args.max_targets,
            drop_last=True,
            shard=None if mesh is None else (mesh.group, groups),
            device_augment=args.device_augment,
            cache_images=args.cache_images, device_cache=args.device_cache)
        iters_per_epoch = len(train_loader)

        tile_bank = None
        if args.device_cache:
            # the decoded train split on the device once (all of it on each
            # rank: spec rows index the whole split): batches then carry
            # (B, T) bank rows instead of pixels
            bank_np = train_dataset.build_tile_bank()
            logger.info(f"Device tile bank: {bank_np.shape[0]} images, "
                        f"{bank_np.nbytes / 1e9:.2f} GB")
            tile_bank = torch.from_numpy(bank_np).to(device)
            del bank_np

        dtype = DTYPES[args.dtype]
        trainer = Trainer(model, loss_fn, args.optimizer, args.lr, dtype,
                          mesh)

        start_epoch = 0
        best_fitness = -1.0
        resume_path = os.path.join(self.model_path, "last.state")
        if args.resume:
            if not os.path.isfile(resume_path):
                logger.error(f"--resume: {resume_path} not found")
                sys.exit(1)
            meta = load_train_state(trainer, resume_path)
            if not main:  # rank 0's share holds the pending gradient sum
                trainer.drop_pending_grads()
            start_epoch = meta["epoch"] + 1
            best_fitness = meta.get("best_fitness", -1.0)
            logger.info(f"Resumed from {resume_path} at epoch {start_epoch}")

        accumulate = max(round(NBS / args.batch_size), 1)
        nw = max(int(args.epochs * iters_per_epoch * hyp_cfg["warmup_prop"]),
                 1000)
        lf = one_cycle(1, hyp_cfg["lrf"], int(args.epochs))

        logger.info(f"Image sizes {args.img_size}")
        logger.info(f"Starting training for {args.epochs} epochs...")

        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            lr_now, total_train_loss = self._train_epoch(
                trainer, train_loader, tile_bank, epoch, iters_per_epoch, nw,
                accumulate, args.lr * lf(epoch), device, epoch == start_epoch,
                main)

            # per-epoch eval on the deploy-FUSED graph in the training
            # dtype, twice the batch (under --dp each group its rows)
            mp, mr, map50, map5095, total_val_loss = evaluate(
                fuse_for_inference(model, dtype=dtype), loss_fn, data,
                hyp_cfg, csl,
                args.img_size, args.batch_size * 2, conf_thres=0.001,
                iou_thres=0.65, max_targets=args.max_targets, device=device,
                progress=main, mesh=mesh)
            # every rank: the same metrics, so the same best-model decision
            fit = fitness(np.array([mp, mr, map50, map5095]))
            trainer.gather_pending_grads()
            if main:
                best_fitness = self._save_epoch(
                    model, trainer, tb, epoch, fit, best_fitness,
                    total_train_loss, total_val_loss,
                    (mp, mr, map50, map5095), lr_now)
            else:
                best_fitness = max(best_fitness, fit)
            if mesh is not None:
                mesh.barrier()

        if tb is not None:
            tb.close()
        logger.info("Done!")

    def _save_epoch(self, model, trainer, tb, epoch, fit, best_fitness,
                    total_train_loss, total_val_loss, metrics, lr_now):
        """Rank 0's end of an epoch: TensorBoard, ``best.pth`` when the
        fitness improves, ``last.pth`` and ``last.state``; returns the best
        fitness."""
        mp, mr, map50, map5095 = metrics
        tb_log = {f"train/{k}": v for k, v in total_train_loss.items()}
        tb_log.update({f"val/{k}": v for k, v in total_val_loss.items()})
        tb_log.update({
            "metrics/mean recall": mr,
            "metrics/mean precision": mp,
            "metrics/mAP@.5": map50,
            "metrics/mAP@.5:.95": map5095,
            "lr": lr_now,
        })
        tb.list_of_scalars_summary(tb_log, epoch)

        if fit > best_fitness:
            best_fitness = fit
            save_pth(model, os.path.join(self.model_path, "best.pth"))
            logger.info("Current best model is saved!")
        save_pth(model, os.path.join(self.model_path, "last.pth"))
        save_train_state(
            trainer, {"epoch": epoch, "best_fitness": float(best_fitness)},
            os.path.join(self.model_path, "last.state"))
        return best_fitness

    def _train_epoch(self, trainer, loader, tile_bank, epoch, iters_per_epoch,
                     nw, accumulate, lr_epoch, device, first_epoch,
                     main=True):
        """One epoch of steps: ``(the last step's learning rate, the mean
        loss items)``."""
        args = self.args
        totals: dict = {}
        pbar = loader
        try:
            import tqdm

            pbar = tqdm.tqdm(loader, total=iters_per_epoch, disable=not main)
        except ImportError:
            pass

        def read(items, desc_lr):
            # host floats of a step already issued; summed in float64
            vals = {k: float(v) for k, v in items.items()}
            if not totals:
                logger.info(("\n" + "%10s" * 2) % ("Epoch", "lr")
                            + "".join("%12s" % k for k in vals))
            for k, v in vals.items():
                totals[k] = totals.get(k, 0.0) + v
            if hasattr(pbar, "set_description"):
                pbar.set_description(
                    ("%10s" + "%10.4g") % (f"{epoch + 1}/{args.epochs}",
                                           desc_lr)
                    + "".join("%12.4g" % v for v in vals.values()))

        lr_now, prev = lr_epoch, None
        for batch_i, batch in enumerate(pbar):
            global_step = iters_per_epoch * epoch + batch_i + 1
            if global_step <= nw:
                acc_now, lr_now = warmup(global_step, nw, args.batch_size,
                                         lr_epoch)
            else:
                acc_now, lr_now = accumulate, lr_epoch

            def run_step():
                if args.device_augment:  # this group's images
                    return trainer.train_step_rendered(
                        batch, tile_bank, lr_now, acc_now,
                        len(batch["paths"]))
                dev_batch = {k: to_device(v, device)
                             for k, v in batch.items() if k != "paths"}
                dev_batch["images"] = dev_batch["images"].permute(
                    0, 3, 1, 2).contiguous()
                return trainer.train_step(dev_batch, lr_now, acc_now)

            if args.profile and first_epoch and batch_i == 1 and main:
                _, items = self._profiled(run_step, device)
            else:
                _, items = run_step()
            # read the previous step's items once this one is issued, so
            # the host does not wait for the step it just issued
            if prev is not None:
                read(*prev)
            prev = (items, lr_now)
        if prev is not None:
            read(*prev)
        return lr_now, {k: v / iters_per_epoch for k, v in totals.items()}

    def _profiled(self, run_step, device):
        """One step under ``torch.profiler``; the Chrome trace goes to
        ``weights/<model_name>/profile/``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = os.path.join(self.model_path, "profile")
        os.makedirs(out, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            res = run_step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(os.path.join(out, "train_step.json"))
        return res


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=80)
    parser.add_argument("--optimizer", default="SGD", nargs="?",
                        choices=["Adam", "SGD"])
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--img_size", type=int, default=608)
    parser.add_argument("--weights_path", type=str, default="")
    parser.add_argument("--model_name", type=str, default="trash")
    parser.add_argument("--mode", default="csl", nargs="?",
                        choices=["csl", "kfiou", "obb"],
                        help="obb (YOLO11) is refused: detect and test only")
    parser.add_argument("--ver", default="yolov5", nargs="?",
                        choices=["yolov4", "yolov5", "yolov7", "yolo11"])
    parser.add_argument("--data", type=str, default="")
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--max_targets", type=int, default=300,
                        help="static per-image target capacity")
    parser.add_argument("--yes", action="store_true",
                        help="overwrite existing model dir without prompting")
    parser.add_argument("--resume", action="store_true",
                        help="resume from weights/<model_name>/last.state")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the second "
                             "train step")
    parser.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                        help="compute dtype (bf16: the forward in bf16, "
                             "params, grads, optimizer and loss in f32)")
    parser.add_argument("--device_augment", action="store_true",
                        help="render mosaic/warp/HSV/mixup on the device "
                             "(the host decodes and does label math only)")
    parser.add_argument("--cache_images", action="store_true",
                        help="cache decoded resized images in host RAM")
    parser.add_argument("--device_cache", action="store_true",
                        help="with --device_augment: keep the decoded train "
                             "split on the device so batches ship bank "
                             "rows, no pixels")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks (processes; --batch_size "
                             "is the global batch)")
    parser.add_argument("--sp", type=int, default=1,
                        help="spatial sharding factor: of the --dp ranks, "
                             "the ones that split each image's height")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


def _train_rank(args):
    """One rank of a ``--dp`` run spawned by :meth:`Train.train`."""
    Train(args).train()


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    Train(args).train()
