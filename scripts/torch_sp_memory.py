"""The peak memory of the first training steps under ``--sp 2``, with
cuDNN's algorithm search (``torch.backends.cudnn.benchmark``) off and on.

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_sp_memory.py

``chip_smoke.py`` phase 18(a) reports each rank's peak memory in the first
step and in the steps after it: two gloo ranks sharing ``cuda:0`` under
``make_mesh(2, sp=2)``, v7-CSL and v5-CSL at 800 px, global batch 8, with
``cudnn.benchmark`` on, as the train CLI sets it.  This script runs the
same steps in fresh processes (so that no algorithm is cached yet), once
with the search off and once on, both as those two ranks and as one
process without a mesh, and prints each step's peak
(``torch.cuda.max_memory_allocated``, reset before each step).
"""

import os
import subprocess
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

STEPS = 2


def body(out, split, names, cfg, benchmark):
    """One process of a run: ``STEPS`` steps of each of ``SP_VERS`` from
    the seeded weights, each step's peak in GiB written to ``out``."""
    from ryolo_tpu_torch.parallel import current_mesh
    from ryolo_tpu_torch.train import Trainer
    from ryolo_tpu_torch.utils.device import set_float32_math

    mesh = current_mesh()
    dev, b = mesh.device, cs.BATCH // mesh.groups
    set_float32_math(dev)
    torch.backends.cudnn.benchmark = benchmark
    loader, bank = cs.dp_loader(split, names, cfg, (mesh.group, mesh.groups),
                                b, dev)
    it = iter(loader)
    batches = [next(it) for _ in range(STEPS)]
    del it
    peaks = {}
    for ver in cs.SP_VERS:
        if mesh.sp > 1:
            trainer = cs.dp_trainer(cfg, mesh, dev, ver)
        else:  # one process: phase 6's plain Trainer
            model = cs.seeded_model(cfg, dev, ver)
            trainer = Trainer(model, cs.train_loss_fn(cfg, model, dev), "SGD",
                              0.01)
        peaks[ver] = []
        for step in range(1, STEPS + 1):
            acc, lr = cs.warmup_step(step, len(loader), cfg)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            trainer.train_step_rendered(batches[step - 1], bank, lr, acc, b)
            torch.cuda.synchronize(dev)
            peaks[ver].append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del trainer
        torch.cuda.empty_cache()
    torch.save(peaks, os.path.join(out, f"rank{mesh.rank}.pt"))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from ryolo_tpu_torch.parallel import launch
    from ryolo_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))
    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        split = os.path.join(tmp, "dota_train")
        cs.write_dota_split(split, names, np.random.default_rng(cs.SEED + 2))
        for benchmark in (False, True):
            for dp, label in ((1, "one process"), (2, "2 ranks, sp 2")):
                out = os.path.join(tmp, f"{dp}_{benchmark}")
                os.makedirs(out)
                launch("torch_sp_memory:body", dp,
                       (out, split, names, cfg, benchmark), device="cuda:0",
                       backend="gloo", sp=dp)
                for r in range(dp):
                    peaks = torch.load(os.path.join(out, f"rank{r}.pt"))
                    for ver, mem in peaks.items():
                        print(f"cudnn.benchmark {benchmark}, {label}, rank "
                              f"{r}, {ver}: peak GiB by step "
                              + ", ".join(f"{m:.2f}" for m in mem),
                              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
