"""The spread of ``chip_smoke.py`` phase 15's bf16 card-against-CPU step
with cuDNN's algorithm search on, as the train CLI sets it, and the device
kernels behind each reading.

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_bf16_step_spread.py

Phase 15 takes one YOLOv7-CSL SGD step at 256 px, batch 2, with the
forward in bf16, on the card and on the CPU, and holds each distance as a
multiple of the CPU's own bf16-to-float32 distance (``BF16_STEP_BOUNDS``).
With ``torch.backends.cudnn.benchmark`` on, cuDNN picks each
convolution's algorithm by timing the candidates, and PyTorch keeps each
choice in a cache of the thread that made it: the forward's in the calling
thread, the backward's in autograd's device thread, one per process.  This
script computes the CPU's two steps once, then takes the card's step in
child processes: one with the search off (cuDNN's heuristic choice), and
``PROCESSES`` with it on, each in ``THREADS`` new threads (so the forward
is searched anew in each thread, the backward once a process); the last
``HELD`` of them first fill all but 3 GiB of the card's memory, as a long
run leaves the caching allocator.  For each step it prints the distances,
the parameter that sets ``held`` and the time of the first step, and at the
end, for each device kernel that some steps run and others do not (from a
second step under ``torch.profiler``), the ``held`` readings with and
without it.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PROCESSES, THREADS, HELD = 8, 3, 2


def config():
    from ryolo_tpu_torch.utils.config import load_yaml

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))


def worst_held(state, refs):
    """``(parameter, its own bf16-to-float32 distance, the card's distance
    over it)`` of the parameter that sets ``held``."""
    before, s16, s32 = refs["before"], refs["cpu16"][2], refs["cpu32"][2]

    def rel(a, b):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        return ((a - b).norm() / b.norm()).item()

    rows = []
    for k in s16:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        env = rel(s32[k] - before[k], s16[k] - before[k])
        if env < cs.BF16_STEP_BOUNDS["held_below"]:
            rows.append((rel(state[k] - before[k], s16[k] - before[k]) / env,
                         k, env))
    ratio, k, env = max(rows)
    return k, env, ratio


def sample(model, cfg, batch, refs, benchmark, out):
    """The card's bf16 step in this thread: its distances, and the device
    kernels of a second step."""
    torch.backends.cudnn.benchmark = benchmark
    t = time.perf_counter()
    card16 = cs.captured_step(model, cfg, batch, "cuda", "bf16")
    out["first_step_s"] = round(time.perf_counter() - t, 3)
    g = cs.bf16_step_gaps(card16, refs["cpu16"], refs["cpu32"],
                          refs["before"])
    out.update(within=cs.bf16_step_within(g),
               **{k: round(float(v), 4) for k, v in g.items()
                  if not k.startswith("env")})
    out["worst"] = worst_held(card16[2], refs)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        cs.captured_step(model, cfg, batch, "cuda", "bf16")
        torch.cuda.synchronize()
    out["kernels"] = sorted({e.name for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA})


def child(work, benchmark, hold):
    cfg = config()
    refs = torch.load(os.path.join(work, "refs.pt"), weights_only=False)
    model = cs.train_model(cfg, "cpu")
    model.load_state_dict(refs["before"])
    filler = None
    if hold:
        free, _ = torch.cuda.mem_get_info()
        filler = torch.empty(free - 3 * 2**30, dtype=torch.uint8,
                             device="cuda")
    for _ in range(THREADS if benchmark else 1):
        out = {"benchmark": benchmark, "memory_held": hold}
        t = threading.Thread(target=sample, args=(model, cfg, refs["batch"],
                                                  refs, benchmark, out))
        t.start()
        t.join()
        print("sample " + json.dumps(out), flush=True)
    del filler


def main():
    if len(sys.argv) == 4:  # a child: work dir, benchmark, memory held
        child(sys.argv[1], sys.argv[2] == "1", sys.argv[3] == "1")
        return 0
    from ryolo_tpu_torch.utils.config import load_yaml

    cs.phase_device()
    cs.phase_build()
    cfg = config()
    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    samples = []
    with tempfile.TemporaryDirectory() as work:
        split = os.path.join(work, "dota_train")
        cs.write_dota_split(split, names, np.random.default_rng(cs.SEED + 2))
        batch = cs.card_vs_cpu_batch(split, names, cfg, "csl")
        model = cs.train_model(cfg, "cpu")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        torch.save(dict(batch=batch, before=before,
                        cpu16=cs.captured_step(model, cfg, batch, "cpu",
                                               "bf16"),
                        cpu32=cs.captured_step(model, cfg, batch, "cpu",
                                               "f32")),
                   os.path.join(work, "refs.pt"))
        runs = [(False, False)] + [(True, i >= PROCESSES - HELD)
                                   for i in range(PROCESSES)]
        for i, (benchmark, hold) in enumerate(runs):
            res = subprocess.run(
                [sys.executable, __file__, work, str(int(benchmark)),
                 str(int(hold))], capture_output=True, text=True)
            if res.returncode:
                print(res.stderr[-4000:], file=sys.stderr, flush=True)
                return res.returncode
            for line in res.stdout.splitlines():
                if line.startswith("sample "):
                    s = json.loads(line[7:])
                    s["process"] = i
                    samples.append(s)
                    print("bf16 step " + json.dumps(
                        {k: v for k, v in s.items() if k != "kernels"}),
                        flush=True)
    held = [s["held"] for s in samples if s["benchmark"]]
    print(f"search on: held {min(held):.4f}-{max(held):.4f} over "
          f"{len(held)} steps (median {np.median(held):.4f}), "
          f"{sum(h > cs.BF16_STEP_BOUNDS['held'] for h in held)} above "
          f"{cs.BF16_STEP_BOUNDS['held']}", flush=True)
    every = set.union(*(set(s["kernels"]) for s in samples))
    for name in sorted(every):
        with_k = [s["held"] for s in samples if name in s["kernels"]]
        without = [s["held"] for s in samples if name not in s["kernels"]]
        if without:
            print(f"kernel in {len(with_k)} of {len(samples)} steps: held "
                  f"with it {np.median(with_k):.4f} [{min(with_k):.4f}-"
                  f"{max(with_k):.4f}], without {np.median(without):.4f} "
                  f"[{min(without):.4f}-{max(without):.4f}]: {name[:240]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
