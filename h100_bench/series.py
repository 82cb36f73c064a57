#!/usr/bin/env python3
"""Run one cell several times, each run a process of its own, and print
each run's numbers and, per metric, the median and the quartile spread
(Q3 - Q1 over the median, Python's ``statistics.quantiles``) that the
bounds are set from.

    python3 h100_bench/series.py --workload <cell> --seeds 11,12,13 \\
        --seconds 30 [--trace 1] [--control] [--fault F] [--out FILE]

``--out`` keeps every run's result line and the end of its standard error
as JSON lines.  The runs go one after another, so one process uses the
card at a time.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="30")
    p.add_argument("--trace", default="0")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    p.add_argument("--witness", action="store_true")
    p.add_argument("--out")
    p.add_argument("--timeout", type=float, default=1200)
    a = p.parse_args(argv)
    runs = []
    for seed in a.seeds.split(","):
        cmd = [sys.executable, str(HERE / "run.py"), "--workload",
               a.workload, "--seed", seed, "--seconds", a.seconds,
               "--trace", a.trace]
        cmd += ["--control"] if a.control else []
        cmd += ["--fault", a.fault] if a.fault else []
        cmd += ["--witness"] if a.witness else []
        t = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=a.timeout)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out, err = (x.decode() if isinstance(x, bytes) else x
                        for x in (out, err))
        wall = time.perf_counter() - t
        lines = out.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        run = {"seed": seed, "rc": rc, "wall_s": wall, "result": result,
               "stderr_tail": err[-6000:]}
        runs.append(run)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(run) + "\n")
        if result is None:
            print(f"seed {seed}: rc {rc}, no result; stderr tail:\n"
                  + err[-3000:], flush=True)
            continue
        vals = {k: v["value"] for k, v in result["metrics"].items()}
        checks = {k: v["value"] for k, v in result["checks"].items()}
        print(f"seed {seed}: rc {rc} wall {wall:.1f} s correct "
              f"{result['correct']} attempted {result['attempted']} failed "
              f"{result['failed']} metrics {json.dumps(vals)} checks "
              f"{json.dumps(checks)} peak {result['device'].get('memory_peak_bytes')}"
              + (f" busy {result['device'].get('busy_s')} window "
                 f"{result['device'].get('window_s')}"
                 if 'busy_s' in result['device'] else ""), flush=True)
    done = [r["result"] for r in runs if r["result"]]
    names = sorted({k for r in done for k in r["metrics"]})
    for k in names:
        v = [r["metrics"][k]["value"] for r in done if k in r["metrics"]]
        print(f"{k}: n {len(v)} median {statistics.median(v)!r} min "
              f"{min(v)!r} max {max(v)!r} spread {spread(v)!r}")
    for k in sorted({k for r in done for k in r["checks"]}):
        v = [r["checks"][k]["value"] for r in done if k in r["checks"]]
        print(f"check {k}: n {len(v)} max {max(v)!r} min {min(v)!r} "
              f"median {statistics.median(v)!r}")
    return 0 if len(done) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
