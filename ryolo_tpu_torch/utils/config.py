"""YAML config loading (copy of ``ryolo_tpu/utils/config.py:12``)."""

from __future__ import annotations

from typing import Any, Dict

import yaml


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)
