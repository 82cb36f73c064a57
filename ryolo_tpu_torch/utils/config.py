"""YAML config loading and the run-options dump (copy of
``ryolo_tpu/utils/config.py``: ``load_yaml`` :12, ``save_opts`` :17)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import yaml


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def save_opts(out_dir: str, args_namespace, config: Dict[str, Any]):
    """Dump run options and the config to ``<out_dir>/opt.json``."""
    to_save = dict(vars(args_namespace))
    to_save.update(config)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "opt.json"), "w") as f:
        json.dump(to_save, f, indent=2)
