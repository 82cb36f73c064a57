"""``BENCHMARK.json`` against the rules a benchmark file keeps, and the harness
finding a configuration, a traffic mix and a per-layer metric by name."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok", "width")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(ROOT)


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_shape_and_characters(manifest):
    assert set(manifest) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    for key, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
        assert 1 <= len(manifest[key]) <= 24
        for e in manifest[key]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and _line(e["why"])
    for key, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                      "source"}),
                      ("per_layer", {"name", "unit", "better", "source",
                                     "layer", "moves"})):
        for m in manifest[key]:
            assert set(m) - {"workloads"} == keys, m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in manifest[key]]
    assert len(names) == len(set(names))


def test_configs_and_cells(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used, f"{c['name']} has no cell"
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS), key
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert all(w["chips"] in (1, 4) for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert NAME.match(w["traffic"])
        traffic = harness.load_traffic(w["traffic"], ROOT)
        assert (ROOT / "h100_bench" / "kinds" / f"{traffic['kind']}.py"
                ).is_file()


def test_metrics_cover_every_cell(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}

    def cells_of(m):
        return set(m.get("workloads", cells))
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert cells_of(m) <= cells_of(e2e[m["moves"]]), m["name"]
        assert (ROOT / "h100_bench" / "metrics" / f"{m['name']}.py").is_file()
        layers = {x["layer"] for x in manifest["per_layer"]
                  if x["layer"].lower() == m["layer"].lower()}
        assert len(layers) == 1 and _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in e2e.values() if cell in cells_of(m)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in cells_of(m) for m in manifest["per_layer"])


def test_run_seconds_fit_a_full_check(manifest):
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_added_by_files_alone(tmp_path, manifest):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries in a copy are found by name and run, with no
    harness file edited."""
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "h100_bench"
    cfg = json.loads((ROOT / "h100_bench/configs/yolov5l-csl.json")
                     .read_text())
    cfg["name"] = "throwaway"
    (bench / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    traffic = harness.load_traffic("eval_load_b8", ROOT)
    traffic.update(conf_thres=0.3, iou_thres=0.5)
    (bench / "traffic" / "throwaway_mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "detect.throwaway_batches.py").write_text(
        "def read(record):\n    return record.get('batches')\n")
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "throwaway", "source": "https://x.org",
                         "file": "h100_bench/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "throwaway-cell", "config": "throwaway",
                           "traffic": "throwaway_mix", "chips": 1,
                           "why": "a test"})
    for e in m["end_to_end"]:
        if e["name"] == "detect_img_s":
            e["workloads"].append("throwaway-cell")
    m["per_layer"].append({"name": "detect.throwaway_batches", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "detect model", "moves": "detect_img_s",
                           "workloads": ["throwaway-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.Cell(harness.load_manifest(tmp_path), "throwaway-cell",
                        tmp_path)
    assert cell.config["name"] == "throwaway"
    assert cell.traffic["conf_thres"] == 0.3
    assert [x["name"] for x in cell.end_to_end] == ["setup_s", "detect_img_s"]
    got = harness.read_metrics(cell.per_layer, {"kind": "detect",
                                                "batches": 5}, tmp_path)
    assert got["detect.throwaway_batches"] == {"value": 5.0, "unit": "1"}

    # the copy's run.py runs the new cell (tiny, on the CPU)
    import importlib.util
    spec = importlib.util.spec_from_file_location("throwaway_run",
                                                  bench / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    args = run.parse(["--workload", "throwaway-cell", "--seed", "5",
                      "--seconds", "0.5", "--trace", "1"])
    r = run.run_cell(args, "cpu", {"config": {"img_size": 64},
                                   "traffic": SMALL_DETECT})
    assert r["correct"], r["checks"]
    assert r["metrics"]["detect.throwaway_batches"]["value"] >= 1


SMALL_DETECT = {"batch": 2, "distinct_batches": 2, "check_batches": 1,
                "check_from_per_s": 0, "trace_batches": 1}
