"""The harness's tests build every configuration of ``BENCHMARK.json`` by
``reference.compare.build_model``, which holds the anchor heads' reference
(``reference/yolo.py``); a YOLO11 configuration is built here from its own
reference, ``reference/yolo11_obb.py``, with the same names as the port's
model."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench.reference import compare, yolo11_obb  # noqa: E402


@pytest.fixture(autouse=True)
def _yolo11_reference(monkeypatch):
    build = compare.build_model

    def build_model(cfg, device, train):
        if cfg["ver"] != "yolo11":
            return build(cfg, device, train)
        with torch.device("meta"):
            model = yolo11_obb.Yolo11OBB(cfg["nc"])
        return model.to_empty(device=device).train(train)
    monkeypatch.setattr(compare, "build_model", build_model)
