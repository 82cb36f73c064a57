"""One data-parallel SGD step of the port's v7-KFIoU (2 gloo ranks on the
CPU, one image each, 9 targets and none) against the JAX
``Trainer.train_step`` under ``make_mesh(2)`` and against the port's
single-process step, at tests/test_torch_trainer.py's float32 bounds
(tests/test_torch_parallel_step.py does the same for v7-CSL).  Measured on
the CPU: the update lies 2.7e-3 from JAX's over all parameters and 1.5e-4
from the port's single-process one."""

from tests import torch_dp_ranks
from tests.test_torch_losses import HYP
from tests.test_torch_parallel_step import LR, _case, _check_dp_step, _nchw
from tests.torch_parity import MODEL_CFG, NC, limit_threads


def test_kfiou_step_matches_jax_mesh(tmp_path):
    limit_threads()
    _, _, sd, batch = _case("kfiou")
    cfg = {"nc": NC, "model": MODEL_CFG, "mode": "kfiou", "ver": "yolov7",
           "hyp": HYP}
    ranks = torch_dp_ranks.run(2, str(tmp_path), [
        ("f32", "step", (cfg, sd, _nchw(batch), LR))])
    _check_dp_step("kfiou", [r["f32"] for r in ranks])
