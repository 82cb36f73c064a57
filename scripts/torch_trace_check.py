#!/usr/bin/env python3
"""The port's spans and counters against the benchmark's own readings, on
a card, through one run of a benchmark cell.

    python3 scripts/torch_trace_check.py --workload <cell> --seed <n> \\
        --seconds <s> [--spans] [--sync] [--trace 1] [--out DIR]

Runs the cell as ``h100_bench/run.py --trace 0`` (``--trace 1``) does and
prints one JSON line: the run's end-to-end (per-layer) metrics and
``correct``;

* with ``--spans``, spans on (``trace.enable``) from the start: the spans
  of the window alone (reset at the harness's last set-up line, read when
  it logs the window) beside the harness's own per-batch or per-step
  readings of the same window (``forward_ms``, ``post_ms``, ``step_ms``,
  ``loader_wait_s``);
* with ``--sync``, the sixth call into ``Detect.infer`` or
  ``Trainer.train_step_rendered`` (set-up's, past cuDNN's search) under
  ``torch.cuda.set_sync_debug_mode("warn")``: where each warning about a
  synchronizing operation came from, and the ``sync.*`` counts of the
  same call;
* with ``--trace 1``, the traced part's idle time by the program span that
  names each gap, every gap named.

The line is also written to ``DIR`` (default ``outputs/trace_check``).
"""

import argparse
import json
import os
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the call that ``--sync`` watches
SYNC_CALL = 6


def _window_hooks(harness, trace, got):
    """Reset the spans at each set-up line (the last comes right before
    the window) and read them when the window is logged."""
    log = harness.log

    def hooked(msg):
        if msg.startswith("set-up:"):
            trace.reset()
        elif msg.startswith("window:") and "window" not in got:
            got["window"] = trace.summary()
        log(msg)
    harness.log = hooked


def _idle_hook(harness, got):
    """With ``--trace 1``: the traced part's idle time by the program span
    that names each gap, every gap named (the breakdown names the 4,000
    longest and lists ten)."""
    reduce = harness.Trace.reduce

    def hooked(self, window_s):
        red = reduce(self, window_s)
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in self.device_events())
        merged = []
        for s, e in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps = [(end, start) for (_, end), (start, _) in
                zip(merged, merged[1:]) if start > end]
        by_span = {}
        for name, sec in self._name_gaps(gaps, named=len(gaps)).items():
            key = name.split("/")[0]
            by_span[key] = by_span.get(key, 0.0) + sec
        got["idle"] = {"window_s": window_s, "busy_s": red["busy_s"],
                       "gaps_s": sum(by_span.values()),
                       "by_span_s": dict(sorted(by_span.items(),
                                                key=lambda kv: -kv[1]))}
        return red
    harness.Trace.reduce = hooked


def _sync_hook(trace, cls, method, k, got):
    """The ``k``-th call of ``cls.method`` under the sync debug mode."""
    import torch

    fn = getattr(cls, method)
    calls = [0]

    def hooked(*a, **kw):
        calls[0] += 1
        if calls[0] != k:
            return fn(*a, **kw)
        before = dict(trace.COUNTS)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        sites = {}
        for w in caught:
            key = (f"{os.path.relpath(w.filename, ROOT)}:{w.lineno} "
                   f"{str(w.message).splitlines()[0][:80]}")
            sites[key] = sites.get(key, 0) + 1
        got["sync"] = {"call": k, "warnings": sites,
                       "counted": {n: v - before.get(n, 0)
                                   for n, v in trace.COUNTS.items()
                                   if n.startswith("sync.")
                                   and v != before.get(n, 0)}}
        return out
    setattr(cls, method, hooked)


def _compare(record, spans):
    """The window's spans beside the harness's readings of it."""
    def mean(v):
        return sum(v) / len(v) if v else None

    def per(name, clock, n):
        s = spans.get(name)
        return None if s is None or s[clock] is None \
            else 1e3 * s[clock] / n
    if record["kind"] == "detect":
        n = spans["detect.infer"]["count"]
        names = ("detect.infer", "detect.upload", "detect.convert",
                 "detect.model", "detect.decode", "detect.post_process",
                 "detect.host_read")
        out = {"batches": record["batches"], "infer_spans": n,
               "forward_ms": mean(record["forward_ms"]),
               "convert_plus_model_device_ms":
                   per("detect.convert", "device_s", n)
                   + per("detect.model", "device_s", n),
               "post_ms": mean(record["post_ms"]),
               "decode_plus_post_device_ms":
                   per("detect.decode", "device_s", n)
                   + per("detect.post_process", "device_s", n)}
    else:
        n = spans["train.step"]["count"]
        children = ("train.render", "train.targets", "train.forward",
                    "train.loss", "train.backward", "train.update")
        names = ("train.step",) + children + ("loader.wait",
                                              "loader.collate",
                                              "loader.fallback")
        out = {"steps": record["steps"], "step_spans": n,
               "step_ms": mean(record["step_ms"]),
               "children_device_ms": sum(per(c, "device_s", n) or 0.0
                                         for c in children),
               "loader_wait_ms": 1e3 * mean(record["loader_wait_s"]),
               "wait_plus_collate_host_ms":
                   per("loader.wait", "host_s", n)
                   + per("loader.collate", "host_s", n)}
    out["per_unit_ms"] = {name: {"host": per(name, "host_s", n),
                                 "device": per(name, "device_s", n),
                                 "self": per(name, "self_s", n)}
                          for name in names if name in spans}
    out["counts_per_unit"] = {
        name: {k: v / n for k, v in spans[name]["counts"].items()}
        for name in names if name in spans and spans[name]["counts"]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", action="store_true")
    p.add_argument("--sync", action="store_true")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=str(ROOT / "outputs" / "trace_check"))
    args = p.parse_args(argv)
    from h100_bench import run

    for key, path in run.CACHES.items():
        os.environ[key] = str(path)
    import torch

    from h100_bench import harness
    from ryolo_tpu_torch.detect import Detect
    from ryolo_tpu_torch.train import Trainer
    from ryolo_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("torch_trace_check: needs a CUDA card", file=sys.stderr)
        return 2
    got, captured = {}, {}
    load_kind = harness.load_kind

    def kind_run(kind):
        mod = load_kind(kind)

        class Kind:
            @staticmethod
            def run(ctx):
                captured.update(mod.run(ctx))
                return captured
        return Kind
    harness.load_kind = kind_run
    if args.spans:
        trace.enable(True)
        _window_hooks(harness, trace, got)
    if args.trace:
        _idle_hook(harness, got)
    if args.sync:
        _sync_hook(trace, Detect, "infer", SYNC_CALL, got)
        _sync_hook(trace, Trainer, "train_step_rendered", SYNC_CALL, got)
    t = time.perf_counter()
    r = run.run_cell(run.parse(["--workload", args.workload, "--seed",
                                str(args.seed), "--seconds",
                                str(args.seconds), "--trace",
                                str(args.trace)]))
    line = {"workload": args.workload, "seed": args.seed,
            "spans_on": args.spans, "correct": r["correct"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "device": r["device"]["kind"], "smi": harness.smi(
                "name,power.limit"), "seconds": time.perf_counter() - t}
    if "window" in got:
        line["window"] = _compare(captured["record"],
                                  got["window"]["spans"])
        line["window"]["counters"] = got["window"]["counters"]
    for key in ("sync", "idle"):
        if key in got:
            line[key] = got[key]
    text = json.dumps(line)
    print(text, flush=True)
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.workload}.{args.seed}.{'spans' if args.spans else 'off'}" \
        + (".sync" if args.sync else "") \
        + (".t1" if args.trace else "")
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
