"""The harness's general parts: the manifest and the files it names, the
per-layer readers, the device's description, the profiler's reduction to
busy time, idle gaps and a breakdown, and the result line.

Everything that belongs to one configuration, traffic mix, kind of run or
per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives);
* ``traffic/<traffic>.json``, whose ``kind`` names ``kinds/<kind>.py``;
* ``metrics/<metric>.py``, whose ``read(record)`` returns the number or
  ``None`` where its run has nothing for it to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no run may load (the port's name begins
# with the JAX package's, so a prefix test would be wrong)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ryolo_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Cell:
    """One ``workloads`` entry with its configuration and traffic."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; one of "
                             f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.traffic = load_traffic(self.entry["traffic"], root)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "h100_bench" / "traffic" / f"{name}.json")
                      .read_text())


def load_kind(kind: str):
    """``kinds/<kind>.py``: its ``run(ctx)`` drives one cell of that kind."""
    return importlib.import_module(f"h100_bench.kinds.{kind}")


def load_reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py``'s ``read``; metric names hold dots, so the
    file is loaded by its path."""
    path = root / "h100_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], record: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    """Each metric whose reader finds something, as ``{value, unit}``."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def smi(fields="name,power.limit,power.draw,clocks.sm,clocks.mem,"
        "temperature.gpu") -> str:
    """The card's readings by ``nvidia-smi``, or why there are none."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_entry(torch, device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def log(msg: str):
    print(f"[h100_bench] {msg}", file=sys.stderr, flush=True)


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Trace:
    """``torch.profiler`` over a traced window, reduced to device busy
    seconds, kernel time by name and idle gaps by what the host was doing
    (the innermost harness range and operator at the gap's middle)."""

    def __init__(self, torch, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.events: List[dict] = []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        self.events = [e for e in data.get("traceEvents", [])
                       if e.get("ph") == "X" and "dur" in e]
        return False

    def device_events(self):
        return [e for e in self.events if e.get("cat") in DEVICE_CATS]

    def kernels(self, substring: str) -> List[float]:
        """Seconds of each device kernel whose name holds ``substring``."""
        return [e["dur"] * 1e-6 for e in self.device_events()
                if e.get("cat") == "kernel" and substring in e["name"]]

    def _name_gaps(self, spans, named=4000):
        """Idle seconds by what the host was doing at each gap's middle;
        the ``named`` longest gaps are named, the rest pooled."""
        import bisect

        ops = sorted((e for e in self.events if e.get("cat") == "cpu_op"),
                     key=lambda e: e["ts"])
        starts = [e["ts"] for e in ops]
        notes = [e for e in self.events if e.get("cat") == "user_annotation"]
        spans = sorted(spans, key=lambda g: g[0] - g[1])
        gaps: Dict[str, float] = {}
        for i, (end, start) in enumerate(spans):
            if i >= named:
                name = "(shorter gaps)"
            else:
                mid = 0.5 * (start + end)
                label = [e["name"] for e in notes
                         if e["ts"] <= mid <= e["ts"] + e["dur"]]
                inner = None
                j = bisect.bisect_right(starts, mid) - 1
                for k in range(j, max(j - 2000, -1), -1):
                    if ops[k]["ts"] + ops[k]["dur"] >= mid:
                        inner = ops[k]["name"]
                        break
                name = "/".join(label[-1:] + ([inner] if inner else []))
                name = (name or "host, outside any operator")[:120]
            gaps[name] = gaps.get(name, 0.0) + (start - end) * 1e-6
        return gaps

    def reduce(self, window_s: float) -> dict:
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in self.device_events())
        merged: List[List[float]] = []
        for s, e in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy_s = sum(e - s for s, e in merged) * 1e-6
        by_name: Dict[str, float] = {}
        for e in self.device_events():
            key = e["name"][:120]
            by_name[key] = by_name.get(key, 0.0) + e["dur"] * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = self._name_gaps(
            [(end, start) for (_, end), (start, _) in zip(merged, merged[1:])
             if start > end])
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": window_s,
                "device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: Dict[str, dict], breakdown: Optional[dict]):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, with the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    print(json.dumps(out), flush=True)
