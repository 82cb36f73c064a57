"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module name (``ryolo_tpu_torch`` begins with ``ryolo_tpu``), and
the reference imports nothing of the port."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_forbidden_import_in_the_sources():
    found = [(str(p), m) for p in _sources() for m in _imports(p)
             if m.split(".")[0] in harness.FORBIDDEN]
    assert not found


def test_reference_imports_nothing_of_the_port():
    found = [(str(p), m) for p in (BENCH / "reference").rglob("*.py")
             for m in _imports(p) if m.split(".")[0] == "ryolo_tpu_torch"]
    assert not found


def test_whole_name_comparison(monkeypatch):
    for name in ("ryolo_tpu_torch", "ryolo_tpu_torch.nn", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [n for n in harness.forbidden_modules()
                if n.split(".")[0] not in harness.FORBIDDEN]
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ryolo_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert set(harness.forbidden_modules()) - before == {"ryolo_tpu.ops",
                                                         "jax.numpy"}


def test_a_run_loads_no_forbidden_module():
    """Every module a run imports, the port's included, in a fresh
    process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import h100_bench.run, h100_bench.kinds.train, "
            "h100_bench.kinds.detect, h100_bench.roofline, h100_bench.synth\n"
            "import ryolo_tpu_torch.train, ryolo_tpu_torch.detect, "
            "ryolo_tpu_torch.data.loader, ryolo_tpu_torch.nn\n"
            "from h100_bench import harness\n"
            "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    assert out[-1] == "[]"


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and ``paths``, a run
    fails and prints no result line."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in manifest["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable] + manifest["command"][1:]
        + ["--workload", manifest["workloads"][0]["name"], "--seed", "1",
           "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
