"""``python -m ryolo_tpu_torch.train --dp 2 --device cpu`` (2 gloo ranks):
an epoch of 2 steps at the global batch 2 with the sharded per-epoch eval,
then ``--resume`` to a second epoch as one command that spawns its ranks.
Rank 0 alone writes the checkpoints, ``last.pth`` has the reference
layout (no ``module.`` prefix), and the parameters after the epoch equal
the ``--dp 1`` run's.

The bound: this training (``weights_init_normal`` weights on 128 px
synthetic images) amplifies a float32 rounding about 30-fold a step. The
``--dp 1`` run itself, at 5 threads against 2, lies 0.027 apart after its 2
steps (the update's L2 error over all parameters; 3.7e-4 in the BatchNorm
statistics) and 0.81 after 4, so the runs are compared after the first
epoch. Measured there on the CPU: the ``--dp 2`` run lies 0.008 (2 threads a
rank) to 0.025 (default threads) from the ``--dp 1`` run, statistics 4.2e-4
to 8.3e-4; ``BOUNDS`` allow about twice that. A step whose ranks average
per-rank means lies 0.48 from the right one after a single step
(tests/test_torch_parallel_step.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests import torch_dp_ranks
from tests.test_torch_train_cli import _args, _run
from tests.test_torch_trainer import update_gaps
from tests.torch_parity import limit_threads

REPO = Path(__file__).resolve().parents[1]
# --dp 2 against --dp 1 after the epoch (module docstring): the BatchNorm
# statistics (of the tensor's largest entry) and the update's L2 error over
# all parameters
BOUNDS = {"stats": 2e-3, "total": 0.06}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """4 train and 2 val images of 128 px, 2 classes."""
    from tests import make_synth_data

    limit_threads()
    root = tmp_path_factory.mktemp("synth")
    make_synth_data.main(str(root), n_images=4, img_size=128, seed=5)
    return root


def _initial_state(args):
    """The CLI's initial weights (``Train.train``: the model drawn at seed
    42, then ``weights_init_normal`` from generator seed 0)."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import weights_init_normal
    from ryolo_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(args.config)["model"]
    with torch.random.fork_rng():
        torch.manual_seed(42)
        model = Yolo(2, cfg, mode=args.mode, ver=args.ver)
    weights_init_normal(model, torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_dp2_cli_trains_evaluates_saves_and_resumes(synth, tmp_path,
                                                    monkeypatch):
    from ryolo_tpu_torch.utils.checkpoint import load_pth

    kw = dict(batch_size=2, img_size=128, model_name="dp")
    run = tmp_path / "dp2"
    ranks = torch_dp_ranks.run(2, str(run), [
        ("cli", "train_cli", (str(run), _args(synth, epochs=1, dp=2, **kw)))])
    # rank 0 writes best.pth (the first fitness), last.pth, last.state
    assert ranks[0]["cli"]["writes"] == ["save_pth", "save_pth",
                                         "save_train_state"]
    assert ranks[1]["cli"]["writes"] == []
    out = run / "weights" / "dp"
    assert sorted(os.listdir(out)) == ["best.pth", "last.pth", "last.state",
                                       "logs", "opt.json"]
    epoch1 = load_pth(str(out / "last.pth"))
    assert not any(k.startswith("module.") for k in epoch1)

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "ryolo_tpu_torch.train", "--dp", "2",
         "--device", "cpu", "--resume", "--epochs", "2", "--batch_size", "2",
         "--img_size", "128", "--model_name", "dp", "--ver", "yolov7",
         "--data", str(synth / "data.yaml"),
         "--config", str(REPO / "configs/hyp.yaml")],
        cwd=run, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Resumed from weights/dp/last.state at epoch 1" in proc.stderr

    assert "Starting training for 2 epochs" in proc.stderr
    last = load_pth(str(out / "last.pth"))
    assert list(last) == list(epoch1)
    assert not torch.equal(last["backbone.cbs0.conv.0.weight"],
                           epoch1["backbone.cbs0.conv.0.weight"])

    (tmp_path / "dp1").mkdir()
    single = _run(_args(synth, epochs=1, **dict(kw, model_name="dp1")),
                  tmp_path / "dp1", monkeypatch)
    want = {k: v.numpy() for k, v in load_pth(str(single / "last.pth"))
            .items()}
    assert list(want) == list(epoch1)
    got = {k: v.numpy() for k, v in epoch1.items()}
    stats, _, total = update_gaps(got, want, _initial_state(_args(synth)))
    print(f"--dp 2 against --dp 1 after the epoch: stats {max(stats):.2e}, "
          f"update {total:.4f}")
    assert max(stats) <= BOUNDS["stats"], max(stats)
    assert total <= BOUNDS["total"], total
