#!/usr/bin/env python3
"""Run one cell of the benchmark of ``ryolo_tpu_torch`` once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The run builds everything it needs from the seed, measures for
``--seconds`` after its set-up, checks what the timed path produced against
the plain reference in ``h100_bench/reference`` and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).  It exits non-zero, printing no
result, without enough CUDA devices, or when a module of JAX, flax, optax
or the JAX package ``ryolo_tpu`` is loaded once the window has closed.

``--control`` runs the cell in the precision below the configuration's
(TF32 for float32 training; for bf16 detect the port's int8 path, and
the reference's head convolutions in float8 in the head stage's place) and
``--fault`` breaks the timed path; both are for the limits' readings and
the harness's tests, and a correct run takes neither.  ``--witness``
(training) also runs the reference a second time with cuDNN's algorithm
search on and prints how far that moves the compared numbers.
"""

import time

T_START = time.perf_counter()  # noqa: E402  (set-up is timed from here)

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# CUDA's JIT cache in a fixed directory of the checkout (the port's kernels
# are built by nvcc into build/kernels, a fixed path too)
CACHES = {"CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache"}
FAULTS = ("unchanged", "half_batch", "altered", "stale", "head_bias")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=FAULTS)
    p.add_argument("--witness", action="store_true")
    return p.parse_args(argv)


class Context:
    """What a kind's ``run`` gets: the cell, the run's arguments, torch and
    the device."""

    def __init__(self, cell, args, torch, device):
        self.cell, self.torch, self.device = cell, torch, device
        self.seed, self.seconds = args.seed, args.seconds
        self.trace, self.control, self.fault = bool(args.trace), \
            args.control, args.fault
        self.witness = args.witness
        self._flops = {}

    def forward_flops(self, cfg, batch, size) -> float:
        """Operations of one forward of ``batch`` images at ``size`` px:
        2 x the multiply-adds of every convolution, counted from the
        shapes of the reference model's convolutions on the meta device."""
        key = (cfg["ver"], cfg["mode"], batch, size)
        if key not in self._flops:
            from h100_bench.reference import compare

            torch = self.torch
            model = compare.build_model(cfg, "meta", train=False)
            total = [0]

            def count(mod, _inp, out):
                kh, kw = mod.kernel_size
                total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) \
                    * kh * kw
            for m in model.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.register_forward_hook(count)
            with torch.no_grad():
                model(torch.empty(batch, 3, size, size, device="meta"))
            self._flops[key] = float(total[0])
        return self._flops[key]

    def after_window(self):
        """No JAX in this process once the window has closed."""
        from h100_bench import harness

        found = harness.forbidden_modules()
        if found:
            print("h100_bench: forbidden modules loaded: " + ", ".join(found),
                  file=sys.stderr, flush=True)
            raise SystemExit(3)


def run_cell(args, device_name="cuda", overrides=None):
    """One run; returns the result's fields.  ``overrides`` (tests only)
    updates the configuration and the traffic, to shrink a run for the
    CPU."""
    import torch

    from h100_bench import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.Cell(manifest, args.workload, ROOT)
    for key in ("config", "traffic"):
        getattr(cell, key).update((overrides or {}).get(key, {}))
    device = torch.device(device_name)
    torch.set_num_threads(min(torch.get_num_threads(),
                              int(cell.traffic.get("host_threads", 4))))
    ctx = Context(cell, args, torch, device)
    kind = harness.load_kind(cell.traffic["kind"])
    harness.log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace "
                f"{args.trace}, control {args.control}, fault {args.fault}; "
                f"torch {torch.__version__}, {harness.smi()}")
    out = kind.run(ctx)
    if args.trace:
        metrics = harness.read_metrics(cell.per_layer, out["record"], ROOT)
        breakdown = {k: out["trace"][k] for k in ("device_ops", "idle_gaps")}
        out["device"]["busy_s"] = out["trace"]["busy_s"]
        out["device"]["window_s"] = out["trace"]["window_s"]
    else:
        values = dict(out["e2e"], setup_s=out["setup_end"] - T_START)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
        breakdown = None
    correct = all(c["value"] <= c["limit"] for c in out["checks"].values())
    return dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=out["device"],
                checks=out["checks"], breakdown=breakdown)


def main(argv=None):
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path[0] = str(ROOT)  # the checkout's root, not h100_bench/
    import torch

    from h100_bench import harness

    cell = harness.Cell(harness.load_manifest(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    r = run_cell(args)
    harness.emit(r["correct"], r["attempted"], r["failed"], r["metrics"],
                 r["device"], r["checks"], r["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
