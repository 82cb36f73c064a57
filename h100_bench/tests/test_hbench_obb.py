"""The YOLO11l-OBB detect cell (``kinds/detect_obb.py``) at a tiny size on
the CPU: a sound run comes out correct, with and without its trace, and
the float8 control and each planted fault come out not correct."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import run  # noqa: E402

CELL = "y11lobb-detect-bf16-dense"
TINY = {"config": {"img_size": 64},
        "traffic": {"batch": 2, "distinct_batches": 2, "check_batches": 2,
                    "check_from_per_s": 0, "trace_batches": 1}}


def _run(trace=0, **flags):
    from ryolo_tpu_torch.utils import trace as port_trace

    # a run's process is its own on the card; here the port's span totals
    # would hold other tests' runs
    port_trace.reset()
    argv = ["--workload", CELL, "--seed", str(2**31 + 29), "--seconds",
            "1.0", "--trace", str(trace)]
    argv += ["--control"] if flags.get("control") else []
    argv += ["--fault", flags["fault"]] if flags.get("fault") else []
    return run.run_cell(run.parse(argv), "cpu", TINY)


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    r = _run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        # 64 px: 84 positions an image, every one decoded (under the cap),
        # and under SMALL_K, so no host read of the count: the upload alone
        assert r["metrics"]["obb.box_decodes"]["value"] == 84
        assert r["metrics"]["detect.syncs"]["value"] == 1
        assert "obb.psa_kernel_ms" not in r["metrics"]  # no card, no kernel
    else:
        assert {"setup_s", "detect_img_s"} <= set(r["metrics"])


@pytest.mark.parametrize("flags", [
    {"control": True}, {"fault": "head_bias"}, {"fault": "half_batch"},
    {"fault": "altered"}, {"fault": "stale"}],
    ids=["control", "head_bias", "half_batch", "altered", "stale"])
def test_control_and_faults_are_not_correct(flags):
    r = _run(**flags)
    assert not r["correct"], r["checks"]
