"""Whole runs of the harness at tiny sizes, the look for a card skipped:
a sound run comes out correct, and each fault that a cell can have, planted
in the timed path, comes out not correct.  The precision controls need the
card (TF32, the int8 product) and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import run  # noqa: E402

TRAIN = "v7csl-train-f32"
DENSE = "v5lcsl-detect-bf16-dense"
SPARSE = "v5lcsl-detect-bf16-sparse"
# at 64 px and batch 2 the CPU's float32 rounding grows several-fold a
# step (2.9e-4 in the loss and 2.5e-3 in the change after 3 steps read
# here): the tiny runs hold the machinery to limits of their own size
TINY = {
    TRAIN: {"config": {"img_size": 64, "train_images": 8, "distinct_images": 4,
                       "source_px": 96,
                       "limits": {"loss_gap": 3e-3, "grad_gap": 3e-2,
                                  "change_gap": 3e-2,
                                  "change_worst_leaf": 0.3,
                                  "targets_off": 0}},
            "traffic": {"batch": 2, "workers": 2, "trace_steps": 1}},
    DENSE: {"config": {"img_size": 64},
            "traffic": {"batch": 2, "distinct_batches": 2,
                        "check_batches": 2, "check_from_per_s": 0,
                        "trace_batches": 1}},
}
TINY[SPARSE] = TINY[DENSE]
# the controls run on a card at the cells' own sizes
CARD = {TRAIN: {}, DENSE: {}}


def _run(cell, device="cpu", sizes=TINY, trace=0, seconds=1.0, **flags):
    argv = ["--workload", cell, "--seed", str(2**31 + 17), "--seconds",
            str(seconds), "--trace", str(trace)]
    argv += ["--control"] if flags.get("control") else []
    argv += ["--fault", flags["fault"]] if flags.get("fault") else []
    return run.run_cell(run.parse(argv), device, sizes[cell])


@pytest.mark.parametrize("cell,trace", [(TRAIN, 0), (TRAIN, 1), (DENSE, 0),
                                        (SPARSE, 1)])
def test_sound_run_is_correct(cell, trace):
    r = _run(cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["device"]["window_s"] > 0
    else:
        assert "setup_s" in r["metrics"]
    assert list(r["checks"]) and all("limit" in c
                                     for c in r["checks"].values())


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, "unchanged"), (TRAIN, "half_batch"), (DENSE, "half_batch"),
    (DENSE, "altered"), (DENSE, "stale"), (DENSE, "head_bias")])
def test_fault_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", [TRAIN, DENSE])
def test_control_is_not_correct(cell):
    """The precision below the configuration's fails a limit: TF32 for the
    float32 training step, the port's int8 path for bf16 detect."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the controls' precisions exist on a CUDA card only")
    r = _run(cell, "cuda", CARD, seconds=2.0, control=True)
    assert not r["correct"], r["checks"]
